"""Port parity: the block-cyclic index algebra (``dplasma_tpu_torch.
parallel.layout``, a copy of the reference's numpy module) equals
``dplasma_tpu.parallel.layout`` for every (t, P, kp, ip) of a small
sweep, and the mesh's axes and active-grid context match the
reference's."""
import itertools

import numpy as np
import pytest

from dplasma_tpu.parallel import layout as ref
from dplasma_tpu.parallel import mesh as ref_mesh
from dplasma_tpu_torch.parallel import layout, mesh
from torch_threads import one_torch_thread  # noqa: F401

SWEEP = [(P, kp, ip) for P in (1, 2, 3, 4) for kp in (1, 2, 3)
         for ip in range(P)]


@pytest.mark.parametrize("P,kp,ip", SWEEP)
def test_owner_local_global_index(P, kp, ip):
    t = np.arange(40)
    np.testing.assert_array_equal(layout.owner(t, P, kp, ip),
                                  ref.owner(t, P, kp, ip))
    np.testing.assert_array_equal(layout.local_index(t, P, kp),
                                  ref.local_index(t, P, kp))
    for l, p in itertools.product(range(12), range(P)):
        assert layout.global_index(l, p, P, kp, ip) == \
            ref.global_index(l, p, P, kp, ip)
    for t_ in range(40):   # (owner, local) -> global is the identity
        assert layout.global_index(layout.local_index(t_, P, kp),
                                   layout.owner(t_, P, kp, ip),
                                   P, kp, ip) == t_


@pytest.mark.parametrize("P,kp,ip", SWEEP)
def test_counts_and_permutations(P, kp, ip):
    for nt in (0, 1, 5, 13, 24):
        assert layout.max_local_count(nt, P, kp) == \
            ref.max_local_count(nt, P, kp)
        for p in range(P):
            assert layout.local_count(nt, p, P, kp, ip) == \
                ref.local_count(nt, p, P, kp, ip)
        perm = layout.cyclic_permutation(nt, P, kp, ip)
        np.testing.assert_array_equal(perm,
                                      ref.cyclic_permutation(nt, P, kp, ip))
        np.testing.assert_array_equal(layout.inverse_permutation(perm),
                                      ref.inverse_permutation(perm))


@pytest.mark.parametrize("P,Q,kp,kq,ip,jq", [(2, 4, 1, 1, 0, 0),
                                             (2, 4, 2, 3, 1, 2),
                                             (4, 2, 3, 2, 2, 0),
                                             (3, 3, 1, 2, 0, 1)])
def test_rank_of_and_owners_grid(P, Q, kp, kq, ip, jq):
    kw = dict(P=P, Q=Q, kp=kp, kq=kq, ip=ip, jq=jq)
    np.testing.assert_array_equal(layout.owners_grid(9, 7, **kw),
                                  ref.owners_grid(9, 7, **kw))
    for i, j in itertools.product(range(9), range(7)):
        assert layout.rank_of(i, j, **kw) == ref.rank_of(i, j, **kw)


def test_mesh_helpers_match_reference():
    m = mesh.make_mesh(2, 3, "cpu")
    r = ref_mesh.make_mesh(2, 3)
    assert m.shape == dict(r.shape) == {"p": 2, "q": 3}
    assert m.axis_names == tuple(r.axis_names) == ("p", "q")
    assert m.devices.shape == r.devices.shape == (2, 3)
    assert mesh.active() is None
    with mesh.use_grid(m):
        assert mesh.active() is m
        with mesh.use_grid(None):
            assert mesh.active() is None
        assert mesh.active() is m
    assert mesh.active() is None


def test_mesh_over_several_devices_names_the_multi_card_step():
    import torch
    with pytest.raises(NotImplementedError, match="item 11"):
        mesh.make_mesh(1, 2, [torch.device("cuda", 0),
                              torch.device("cuda", 1)])
    assert mesh.make_mesh(1, 2, ["cpu", "cpu"]).device.type == "cpu"
