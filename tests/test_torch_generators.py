"""Port parity: ``dplasma_tpu_torch.ops.generators`` against the JAX
generators — bitwise, s and d, ragged sizes, several seeds (c and z:
tests/test_torch_complex.py, and the two complex cases here)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import generators as ref
from dplasma_tpu_torch.ops import generators as port
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = [(jnp.float32, torch.float32, np.uint32),
          (jnp.float64, torch.float64, np.uint64)]


def _bits(x, view):
    return np.ascontiguousarray(np.asarray(x)).view(view)


@pytest.mark.parametrize("dts", DTYPES, ids=["s", "d"])
@pytest.mark.parametrize("N", [37, 96])
@pytest.mark.parametrize("nb", [8, 32])
@pytest.mark.parametrize("seed", [3872, 0, 2**31 + 17])
def test_plrnt_bitwise(dts, N, nb, seed):
    jdt, tdt, view = dts
    M = N - 3   # ragged rows as well as columns
    a = ref.plrnt(M, N, nb, nb, seed=seed, dtype=jdt)
    b = port.plrnt(M, N, nb, nb, seed=seed, dtype=tdt, device="cpu")
    assert dataclasses.asdict(a.desc) == b.desc.to_dict()
    np.testing.assert_array_equal(_bits(a.data, view),
                                  _bits(b.data.numpy(), view))


@pytest.mark.parametrize("dts", DTYPES, ids=["s", "d"])
@pytest.mark.parametrize("N", [37, 96])
@pytest.mark.parametrize("nb", [8, 32])
@pytest.mark.parametrize("seed", [3872, 0, 2**31 + 17])
def test_plghe_bitwise(dts, N, nb, seed):
    jdt, tdt, view = dts
    a = ref.plghe(float(N), N, nb, seed=seed, dtype=jdt)
    b = port.plghe(float(N), N, nb, seed=seed, dtype=tdt, device="cpu")
    assert dataclasses.asdict(a.desc) == b.desc.to_dict()
    np.testing.assert_array_equal(_bits(a.data, view),
                                  _bits(b.data.numpy(), view))


def test_plrnt_diagdom_bitwise():
    a = ref.plrnt(40, 37, 8, 8, seed=5, dtype=jnp.float32, diagdom=True)
    b = port.plrnt(40, 37, 8, 8, seed=5, dtype=torch.float32,
                   diagdom=True, device="cpu")
    np.testing.assert_array_equal(_bits(a.data, np.uint32),
                                  _bits(b.data.numpy(), np.uint32))


def test_generator_chunking_is_invisible(monkeypatch):
    """Hashing in row chunks gives the same bits as one pass."""
    whole = port.plghe(50.0, 50, 16, seed=9, device="cpu").data
    monkeypatch.setattr(port, "_CHUNK_ELEMS", 70)
    chunked = port.plghe(50.0, 50, 16, seed=9, device="cpu").data
    assert torch.equal(whole, chunked)


def test_complex_waits_for_its_slice():
    """c is in: plrnt's complex64 matrix is the reference's, bitwise."""
    a = ref.plrnt(8, 8, 4, 4, dtype=jnp.complex64)
    b = port.plrnt(8, 8, 4, 4, dtype=torch.complex64, device="cpu")
    np.testing.assert_array_equal(_bits(a.data, np.uint32),
                                  _bits(b.data.numpy(), np.uint32))


@pytest.mark.parametrize("dts", DTYPES, ids=["s", "d"])
@pytest.mark.parametrize("N,nb,seed", [(37, 8, 3872), (96, 32, 0),
                                       (50, 16, 2**31 + 17)])
def test_plgsy_bitwise(dts, N, nb, seed):
    jdt, tdt, view = dts
    a = ref.plgsy(float(N) + 0.5, N, nb, seed=seed, dtype=jdt)
    b = port.plgsy(float(N) + 0.5, N, nb, seed=seed, dtype=tdt,
                   device="cpu")
    assert dataclasses.asdict(a.desc) == b.desc.to_dict()
    np.testing.assert_array_equal(_bits(a.data, view),
                                  _bits(b.data.numpy(), view))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c", "z"])
@pytest.mark.parametrize("gen", ["plgsy", "plghe"])
def test_complex_symmetric_generators_name_their_slice(dtype, gen):
    """plgsy (complex-symmetric) and plghe (Hermitian) in c and z: the
    reference's bits."""
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    view = np.uint32 if dtype == torch.complex64 else np.uint64
    a = getattr(ref, gen)(8.0, 8, 4, dtype=jdt)
    b = getattr(port, gen)(8.0, 8, 4, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(_bits(a.data, view),
                                  _bits(b.data.numpy(), view))
