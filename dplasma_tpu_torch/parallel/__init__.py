"""The distribution layer: the block-cyclic index algebra (``layout``),
the P×Q grid (``mesh``) and the block-cyclic factorizations
(``cyclic``)."""
from dplasma_tpu_torch.parallel import layout, mesh

__all__ = ["layout", "mesh"]
