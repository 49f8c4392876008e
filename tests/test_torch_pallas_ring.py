"""K5's plain versions and gates (``dplasma_tpu_torch.kernels.
pallas_ring``) on the CPU.

The reference's ring kernels run only as interpret-mode shifts, which
fail under this repo's jax (tests/test_pallas_ring.py), so the oracle
is the reference's contract: a broadcast leaves the root's block on
every rank, a shift moves rank r's block to rank r+1, and the ring
all-reduce equals the sum (exactly, for disjoint contributions). The
gate tests are ports of tests/test_pallas_ring.py:154-265. The kernel
itself runs on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import pallas_ring as ref_ring
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.kernels import pallas_ring as pring
from dplasma_tpu_torch.parallel import mesh
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

CASES = [(n, root, chunks) for n in (2, 3, 4) for root in range(n)
         for chunks in (1, 3, 4)]


def _blocks(n, rows=12, cols=5, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((rows, cols))).to(dtype)
            for _ in range(n)]


@pytest.mark.parametrize("n,root,chunks", CASES)
def test_bcast_reference_leaves_the_root_block_everywhere(n, root, chunks):
    xs = _blocks(n, seed=n * 10 + root)
    outs = pring.ring_bcast_reference(xs, root, chunks)
    assert len(outs) == n
    for o in outs:
        assert torch.equal(o, xs[root]) and o.is_contiguous()
    assert all(o.data_ptr() != xs[root].data_ptr() for o in outs)
    before = pring.ROUTED
    got = pring.ring_bcast(xs, root=root, chunks=chunks)
    assert pring.ROUTED == before + 1
    assert all(torch.equal(g, xs[root]) for g in got)


def test_bcast_takes_a_strided_column_slice():
    slab = torch.arange(8 * 20, dtype=torch.float32).reshape(8, 20)
    xs = [slab[:, 4:9], torch.zeros(8, 5), torch.zeros(8, 5)]
    for o in pring.ring_bcast(xs, root=0, chunks=4):
        assert torch.equal(o, slab[:, 4:9])
    with pytest.raises(ValueError, match="disagree"):
        pring.ring_bcast([slab[:, :5], torch.zeros(8, 4)], root=0)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_shift_moves_each_block_one_rank_right(n):
    xs = _blocks(n, dtype=torch.bfloat16, seed=n)
    outs = pring.ring_shift_reference(xs)
    for r in range(n):
        assert torch.equal(outs[(r + 1) % n], xs[r])
    got = xs
    for _ in range(n):       # n hops bring every block home
        got = pring.ring_shift(got)
    assert all(torch.equal(g, x) for g, x in zip(got, xs))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_allreduce_matches_sum(n):
    xs = _blocks(n, rows=6, cols=7, dtype=torch.float64, seed=5 + n)
    want = sum(xs[1:], xs[0].clone())
    for got in pring.ring_allreduce(xs):
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)


def test_allreduce_disjoint_exact():
    """One owner per row (the winner-row exchange): every rank's sum
    equals the rank-order sum bit for bit."""
    n = 4
    full = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 6))).float()
    xs = []
    for r in range(n):
        x = torch.zeros_like(full)
        x[2 * r:2 * r + 2] = full[2 * r:2 * r + 2]
        xs.append(x)
    for got in pring.ring_allreduce(xs):
        assert torch.equal(got, full)


# ---------------------------------------------------------------------
# the ring.enable gate (ports of tests/test_pallas_ring.py:154-265)
# ---------------------------------------------------------------------

def test_ring_gate_modes_on_the_cpu():
    """On a CPU mesh ``auto`` and ``off`` take the psum path; ``on``
    walks the ring route through the plain versions. Without a mesh
    the default device decides (no CUDA here: the CPU's rules)."""
    cpu = mesh.make_mesh(1, 4, "cpu")
    for mode, want in (("off", False), ("auto", False), ("on", True)):
        with cfg.override_scope({"ring.enable": mode}):
            assert pring.ring_active(4, "float32", cpu, "q") is want
            if not torch.cuda.is_available():
                assert pring.ring_active(4, "float32") is want


def _fake_card(monkeypatch, capability):
    """A CUDA mesh on a card of ``capability``, for the gate alone (no
    tensor is made on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    return mesh.Mesh(2, 2, torch.device("cuda", 0))


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("capability", [(8, 0), (8, 9), (10, 0)])
def test_ring_gate_raises_on_a_card_that_is_not_hopper(monkeypatch, mode,
                                                       capability):
    """No device fallback hides K5: on a CUDA mesh ``on`` and ``auto``
    take the kernel, and a card it was not built for raises."""
    card = _fake_card(monkeypatch, capability)
    with cfg.override_scope({"ring.enable": mode}):
        with pytest.raises(RuntimeError, match="sm_90a"):
            pring.ring_active(2, "float32", card, "q")
        # the psum path stays where the reference takes it
        assert pring.ring_active(2, "float64", card, "q") is False
        assert pring.ring_active(1, "float32", card, "q") is False
    with cfg.override_scope({"ring.enable": "off"}):
        assert pring.ring_active(2, "float32", card, "q") is False


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("dtype,want", [("float32", True),
                                        (torch.bfloat16, True),
                                        (torch.float64, False)])
def test_ring_gate_takes_k5_on_a_hopper_card(monkeypatch, mode, dtype,
                                             want):
    card = _fake_card(monkeypatch, (9, 0))
    with cfg.override_scope({"ring.enable": mode}):
        assert pring.ring_active(2, dtype, card, "q") is want
        assert pring.ring_active(2, dtype, card, "p") is want


def test_ring_gate_off_and_size1():
    cpu = mesh.make_mesh(1, 4, "cpu")
    with cfg.override_scope({"ring.enable": "on"}):
        assert pring.ring_active(1, "float32", cpu) is False
    with cfg.override_scope({"ring.enable": "off"}):
        assert pring.ring_active(4, "float32", cpu) is False


def test_ring_gate_dtype():
    """No ring kernel for f64/complex (the reference's rule): the gate
    falls back rather than hand the kernel a payload it does not take."""
    cpu = mesh.make_mesh(1, 4, "cpu")
    with cfg.override_scope({"ring.enable": "on"}):
        for dt in ("float64", "complex64", torch.float64):
            assert pring.ring_active(4, dt, cpu) is False
        assert pring.ring_active(4, torch.bfloat16, cpu) is True
        assert pring.ring_active(4, "float32", cpu) is True


def test_runtime_probe_needs_a_hopper_card():
    assert pring.ring_runtime_ok("cpu") is False
    if not torch.cuda.is_available():
        assert pring.ring_runtime_ok() is False


class _FakeDev:
    def __init__(self, coords):
        self.coords = coords


def _fake_mesh(devgrid, names):
    class _M:
        pass
    m = _M()
    m.axis_names = names
    m.devices = np.asarray(devgrid, dtype=object)
    return m


@pytest.mark.parametrize("devs,ok", [
    ([[_FakeDev((0, i, 0)) for i in range(4)]], True),
    ([[_FakeDev((0, 0, 0)), _FakeDev((1, 1, 0)), _FakeDev((0, 2, 0)),
       _FakeDev((1, 3, 0))]], False),
    ([[_FakeDev((0, 0, 0)), _FakeDev((0, 2, 0)), _FakeDev((0, 4, 0)),
       _FakeDev((0, 6, 0))]], False),
    ([[_FakeDev((0, 0, 0)), _FakeDev((0, 2, 0))]], False),
    ([[_FakeDev((0, 0, 0)), _FakeDev((0, 1, 0))]], True),
    ([[object(), object()]], True),
])
def test_geometry_walk_matches_reference(devs, ok):
    """The coordinate walk is the reference's: a ±1 line or a full
    torus passes, scattered or sparse devices fail, no metadata
    passes."""
    m = _fake_mesh(devs, ("p", "q"))
    assert pring.ring_geometry_ok(m, "q") is ok
    assert ref_ring.ring_geometry_ok(m, "q") is ok


def test_geometry_gate_one_device_mesh():
    assert pring.ring_geometry_ok(mesh.make_mesh(2, 4, "cpu"), "q")
    assert pring.ring_geometry_ok(mesh.make_mesh(2, 4, "cpu"), "p")
    assert not pring.ring_geometry_ok(mesh.make_mesh(2, 1, "cpu"), "q")


@pytest.mark.parametrize("rows,chunks", [(16, 4), (14, 4), (7, 4), (8, None),
                                         (4096, 4), (512, 3), (9, 0)])
def test_resolve_chunks_divisibility(rows, chunks):
    assert pring._resolve_chunks(rows, chunks) == \
        ref_ring._resolve_chunks(rows, chunks)
    c = pring._resolve_chunks(rows, chunks)
    assert c >= 1 and rows % c == 0


def test_mca_knobs_registered():
    assert cfg.mca_get("ring.enable") == "auto"
    assert cfg.mca_get_int("ring.chunks", -1) == 4
    for name in ("ring.enable", "ring.chunks"):
        assert cfg._MCA_REGISTRY[name][0] == \
            ref_cfg._MCA_REGISTRY[name][0]


def test_ring_gate_unknown_mode_resolves_as_auto():
    """A typo'd ring.enable must not act as a forced 'on' that skips the
    geometry gate: unknown modes warn once and resolve as auto (which
    takes the psum path on a CPU mesh)."""
    cpu = mesh.make_mesh(1, 4, "cpu")
    for bad in ("true", "yes", "1"):
        with cfg.override_scope({"ring.enable": bad}):
            assert pring.ring_active(4, "float32", cpu, "q") is False


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError, match="root"):
        pring.ring_bcast(_blocks(2), root=2)
    with pytest.raises(ValueError, match="2-D"):
        pring.ring_shift([torch.zeros(3), torch.zeros(3)])
    one = _blocks(1)
    assert torch.equal(pring.ring_bcast(one, root=0)[0], one[0])
    assert torch.equal(pring.ring_shift(one)[0], one[0])


def _pr5_geometry(kind, n, rows, cols, esz, strides_bytes, ptrs, chunks,
                  room, threads=256):
    """The launch rule K5 has had since it was ported, written out: the
    widest unit dividing the row bytes, every row stride and every
    pointer; units per chunk; blocks per rank."""
    row_bytes = cols * esz
    unit = next(u for u in (16, 4, 2) if row_bytes % u == 0
                and all(s % u == 0 for s in strides_bytes)
                and all(p % u == 0 for p in ptrs))
    units = rows // chunks * (row_bytes // unit)
    blocks = max(1, min(room // n, -(-units // threads)))
    return unit, blocks, units


@pytest.mark.parametrize("room", [792, 1056, 264])
@pytest.mark.parametrize("case", [
    # kind, n, rows, cols, root row stride (elements), chunks: the main
    # paths' transfers on the 2x2 grid and odd ones
    ("bcast", 2, 4096, 512, 4096, 4),      # sgetrf_ptgpanel's broadcast
    ("shift", 2, 512, 4096, 4096, 1),      # its winner-row shift
    ("bcast", 2, 8192, 1024, 8192, 4),     # potrf_cyclic's broadcast
    ("bcast", 3, 1000, 300, 900, 4),
    ("bcast", 4, 1000, 301, 301, 1),
    ("shift", 3, 1000, 300, 300, 1)])
def test_ring_geometry_keeps_the_launch_rule(case, room):
    kind, n, rows, cols, ld, chunks = case
    esz = 4
    ld_in = [ld * esz] * n
    ld_out = [cols * esz] * n
    geo = pring.ring_geometry(kind, n, rows, cols * esz, ld_in + ld_out,
                              chunks, room)
    unit, blocks, units = _pr5_geometry(kind, n, rows, cols, esz,
                                        ld_in + ld_out, [0] * (2 * n),
                                        chunks, room)
    assert (geo.unit, geo.blocks, geo.units) == (unit, blocks, units)
    assert geo.flags == (n * chunks if kind == "bcast" else n)
    # a pointer off the unit narrows it, as the per-call test does
    off = pring.ring_geometry(kind, n, rows, cols * esz,
                              ld_in + ld_out + [4], chunks, room)
    assert off.unit == _pr5_geometry(kind, n, rows, cols, esz,
                                     ld_in + ld_out, [4], chunks, room)[0]


def test_ring_geometry_refuses_more_ranks_than_the_card_holds():
    with pytest.raises(RuntimeError, match="do not fit"):
        pring.ring_geometry("bcast", 4, 100, 64, [64] * 8, 1, 3)
