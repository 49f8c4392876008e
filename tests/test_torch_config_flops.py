"""Port parity: ``dplasma_tpu_torch.utils.config`` (MCA semantics) and
``utils.flops`` (exactly the reference's LAWN-41 counts)."""
import inspect
import itertools

import pytest

import dplasma_tpu.kernels.panels  # noqa: F401  (registers panel.*)
import dplasma_tpu.kernels.quant  # noqa: F401  (registers quant.*)
import dplasma_tpu.ops.refine  # noqa: F401  (registers ir.*)
import dplasma_tpu_torch.kernels.panels  # noqa: F401  (registers panel.*)
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu.utils import flops as ref_flops
from dplasma_tpu_torch.utils import config as cfg
from dplasma_tpu_torch.utils import flops as port_flops
from torch_threads import one_torch_thread  # noqa: F401

SLICE_KNOBS = ["sweep.lookahead", "qr.agg_depth", "trsm_inv", "dd_gemm",
               "quant.updates", "quant.tile", "quant.guard",
               "lu.pallas_panel", "lu.panel_ib", "lu.panel_chunk",
               "lu.agg_depth", "panel.kernel", "panel.tree_leaf",
               "panel.rec_base", "qr_panel", "ir.precision",
               "ir.max_iters", "ir.tol", "gemm.summa_steps"]


@pytest.fixture
def clean_overrides():
    saved = dict(cfg._MCA_OVERRIDES)
    depth = cfg.override_depth()
    try:
        yield
    finally:
        assert cfg.override_depth() == depth
        cfg._MCA_OVERRIDES.clear()
        cfg._MCA_OVERRIDES.update(saved)


@pytest.mark.parametrize("name", SLICE_KNOBS)
def test_registered_defaults_match_reference(name, clean_overrides):
    assert cfg.mca_get(name) == ref_cfg.mca_get(name)


def test_get_set_unset_and_env(monkeypatch, clean_overrides):
    assert cfg.mca_get("sweep.lookahead") == "1"
    monkeypatch.setenv("DPLASMA_MCA_SWEEP_LOOKAHEAD", "3")
    assert cfg.mca_get_int("sweep.lookahead", 0) == 3
    cfg.mca_set("sweep.lookahead", 2)
    assert cfg.mca_get("sweep.lookahead") == "2"     # override > env
    cfg.mca_unset("sweep.lookahead")
    assert cfg.mca_get("sweep.lookahead") == "3"
    assert cfg.mca_get("no.such.knob") is None
    assert cfg.mca_get("no.such.knob", 7) == "7"
    cfg.mca_set("trsm_inv", "x")
    assert cfg.mca_get_int("trsm_inv", 5) == 5
    assert cfg.mca_get_float("trsm_inv", 1.5) == 1.5


def test_override_scope_nests_and_restores(clean_overrides):
    cfg.mca_set("dd_gemm", "never")
    with cfg.override_scope({"dd_gemm": "always", "trsm_inv": "always"}):
        assert cfg.mca_get("dd_gemm") == "always"
        with cfg.override_scope({"dd_gemm": None}):
            assert cfg.mca_get("dd_gemm") == "auto"   # default resumes
        assert cfg.mca_get("dd_gemm") == "always"
    assert cfg.mca_get("dd_gemm") == "never"
    assert "trsm_inv" not in cfg.mca_snapshot()


def test_pop_out_of_order_raises(clean_overrides):
    outer = cfg.push_overrides({"trsm_inv": "always"}, label="outer")
    inner = cfg.push_overrides({"trsm_inv": "never"}, label="inner")
    with pytest.raises(RuntimeError, match="LIFO"):
        cfg.pop_overrides(outer)
    cfg.pop_overrides(inner)
    cfg.pop_overrides(outer)
    assert "trsm_inv" not in cfg.mca_snapshot()


def test_mca_load_takes_reference_snapshot(clean_overrides):
    saved = dict(ref_cfg._MCA_OVERRIDES)
    try:
        ref_cfg.mca_set("sweep.lookahead", 2)
        ref_cfg.mca_set("trsm_inv", "always")
        snap = ref_cfg.mca_snapshot()
    finally:
        ref_cfg._MCA_OVERRIDES.clear()
        ref_cfg._MCA_OVERRIDES.update(saved)
    cfg.mca_set("dd_gemm", "never")   # replaced by the load
    cfg.mca_load(snap)
    assert cfg.mca_snapshot() == snap
    assert cfg.mca_get_int("sweep.lookahead", 0) == 2


def test_info_store():
    info = cfg.Info({"dplasma:gemm:gpu:b": 64})
    assert info.get("DPLASMA:GEMM:GPU:B") == "64"
    assert info.get_int("dplasma:gemm:gpu:b", 0) == 64
    dup = info.dup()
    info.delete("dplasma:gemm:gpu:b")
    assert info.nkeys() == 0 and "dplasma:gemm:gpu:b" in dup


def _public(mod):
    return sorted(n for n, f in vars(mod).items()
                  if inspect.isfunction(f) and not n.startswith("_"))


def test_flops_has_every_formula():
    assert _public(port_flops) == _public(ref_flops)


_VALUES = {"side": ["L", "R"], "complex_": [False, True]}
_SIZES = [1, 7, 96, 1000, 16384]


@pytest.mark.parametrize("name", _public(ref_flops))
def test_flops_exactly_equal(name):
    params = [p for p in inspect.signature(
        getattr(ref_flops, name)).parameters]
    choices = [_VALUES.get(p, _SIZES) for p in params]
    for args in itertools.product(*choices):
        assert getattr(port_flops, name)(*args) == \
            getattr(ref_flops, name)(*args), (name, args)
