"""Port parity: ``dplasma_tpu_torch.descriptors`` against the JAX
descriptors, and the state hand-over between the two packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu import descriptors as ref
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu_torch import descriptors as port
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(37, 37, 8, 8), (96, 40, 32, 16), (1, 5, 4, 4), (0, 3, 2, 2),
          (100, 100, 16, 16)]


@pytest.mark.parametrize("M,N,mb,nb", SHAPES)
def test_tiledesc_fields(M, N, mb, nb):
    a = ref.TileDesc(M, N, mb, nb)
    b = port.TileDesc(M, N, mb, nb)
    for f in ("M", "N", "mb", "nb", "MT", "NT", "Mp", "Np", "KT"):
        assert getattr(a, f) == getattr(b, f), f
    assert dataclasses.asdict(a) == b.to_dict()


def test_invalid_descriptors_raise():
    with pytest.raises(ValueError):
        port.TileDesc(4, 4, 0, 4)
    with pytest.raises(ValueError):
        port.Dist(P=0)


@pytest.mark.parametrize("M,N,mb,nb", [(37, 37, 8, 8), (30, 21, 8, 16),
                                       (32, 32, 8, 8)])
def test_pad_diag_and_to_dense(M, N, mb, nb, rng):
    x = rng.standard_normal((M, N))
    a = ref.TileMatrix.from_dense(jnp.asarray(x), mb, nb)
    b = port.TileMatrix.from_dense(torch.from_numpy(x), mb, nb)
    np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
    np.testing.assert_array_equal(np.asarray(a.pad_diag().data),
                                  b.pad_diag().data.numpy())
    np.testing.assert_array_equal(np.asarray(a.pad_diag(2.5).data),
                                  b.pad_diag(2.5).data.numpy())
    np.testing.assert_array_equal(np.asarray(a.to_dense()),
                                  b.to_dense().numpy())
    np.testing.assert_array_equal(np.asarray(a.tile(1, 1)),
                                  b.tile(1, 1).numpy())


def test_zero_pad_clears_garbage_and_leaves_input(rng):
    b = port.TileMatrix.from_dense(torch.ones(5, 6), 4, 4)
    b.data[5:, :] = 7.0
    z = b.zero_pad()
    assert torch.all(z.data[5:, :] == 0) and torch.all(z.data[:, 6:] == 0)
    assert torch.all(b.data[5:, :] == 7.0)


def test_reference_round_trip():
    A = ref_gen.plghe(37.0, 37, 8, seed=11, dtype=jnp.float64)
    data, desc = np.asarray(A.data), dataclasses.asdict(A.desc)
    T = port.TileMatrix.from_reference(data, desc, device="cpu")
    assert T.desc == port.TileDesc(37, 37, 8, 8)
    back, back_desc = T.to_reference()
    np.testing.assert_array_equal(back, data)
    assert back_desc == desc
    with pytest.raises(ValueError):
        port.TileMatrix.from_reference(data[:8], desc, device="cpu")


def test_subtile_view():
    x = torch.arange(64.0).reshape(8, 8)
    b = port.TileMatrix.from_dense(x, 4, 4)
    sub = b.subtile_view(1, 0, 2, 2)
    assert sub.desc == port.TileDesc(4, 4, 2, 2)
    assert torch.equal(sub.to_dense(), x[4:, :4])


def test_zeros_and_device_rule(monkeypatch):
    z = port.TileMatrix.zeros(5, 7, 4, 4, device="cpu")
    assert tuple(z.data.shape) == (8, 8) and z.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TileMatrix.zeros(5, 7, 4, 4)


@pytest.mark.parametrize("M,N,mb,nb", SHAPES)
def test_transposed_and_with_shape_match_reference(M, N, mb, nb):
    dist = dict(P=2, Q=3, kp=1, kq=2, ip=1, jq=0)
    a = ref.TileDesc(M, N, mb, nb, ref.Dist(**dist))
    b = port.TileDesc(M, N, mb, nb, port.Dist(**dist))
    assert dataclasses.asdict(a.transposed()) == b.transposed().to_dict()
    assert b.transposed().transposed() == b
    assert dataclasses.asdict(a.with_shape(N + 1, M)) == \
        b.with_shape(N + 1, M).to_dict()


def _both(seed=3):
    A = ref_gen.plrnt(37, 30, 8, 8, seed=seed, dtype=jnp.float64)
    T = port.TileMatrix.from_reference(np.asarray(A.data),
                                       dataclasses.asdict(A.desc),
                                       device="cpu")
    return A, T


@pytest.mark.parametrize("method,args", [
    ("set_tile", (1, 2, 3.5)),
    ("set_block", (1, 3, 0, 2, -1.25)),
    ("add_block", (0, 2, 1, 4, 0.5)),
    ("astype", (np.float32,)),
])
def test_functional_writers_match_reference(method, args):
    """set_tile / set_block / add_block / astype are bitwise the
    reference's, and the source matrix is unchanged afterwards."""
    A, T = _both()
    before = T.data.clone()
    targs = tuple(torch.float32 if a is np.float32 else a for a in args)
    want = getattr(A, method)(*args)
    got = getattr(T, method)(*targs)
    assert got.desc == T.desc and got.data.data_ptr() != T.data.data_ptr()
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())
    assert torch.equal(T.data, before)
    # a write into the result does not reach the source either
    got.data.fill_(7.0)
    assert torch.equal(T.data, before)


def test_set_block_with_a_tensor_and_block_view():
    A, T = _both()
    val = np.arange(16 * 24, dtype=np.float64).reshape(16, 24)
    want = A.set_block(2, 4, 0, 3, jnp.asarray(val))
    got = T.set_block(2, 4, 0, 3, torch.from_numpy(val))
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())
    np.testing.assert_array_equal(np.asarray(A.block(1, 3, 2, 4)),
                                  T.block(1, 3, 2, 4).numpy())
    assert T.block(0, 1, 0, 1).data_ptr() == T.data.data_ptr()
    np.testing.assert_array_equal(np.asarray(want.tile(3, 2)),
                                  got.tile(3, 2).numpy())


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("conj", [True, False])
def test_sym_mirror_matches_reference(uplo, conj):
    A = ref_gen.plrnt(37, 37, 8, 8, seed=4, dtype=jnp.float64)
    T = port.TileMatrix.from_reference(np.asarray(A.data),
                                       dataclasses.asdict(A.desc),
                                       device="cpu")
    before = T.data.clone()
    want = A.sym_mirror(uplo, conj)
    got = T.sym_mirror(uplo, conj)
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())
    assert torch.equal(got.data, got.data.T)
    assert torch.equal(T.data, before)


def test_sym_mirror_keeps_a_real_diagonal_under_conj():
    x = torch.tensor([[1 + 2j, 0], [3 - 1j, 4 + 5j]], dtype=torch.complex128)
    T = port.TileMatrix.from_dense(x, 2, 2)
    h = T.sym_mirror("L", conj=True).data
    assert torch.equal(h.diagonal(), torch.tensor([1, 4],
                                                  dtype=torch.complex128))
    assert h[0, 1] == 3 + 1j and h[1, 0] == 3 - 1j
    s = T.sym_mirror("L", conj=False).data
    assert torch.equal(s.diagonal(), x.diagonal()) and s[0, 1] == 3 - 1j
    u = T.sym_mirror("U", conj=True).data
    assert torch.equal(u.diagonal(), torch.tensor([1, 4],
                                                  dtype=torch.complex128))
