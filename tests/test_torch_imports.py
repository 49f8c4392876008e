"""The port stands alone: no module of ``dplasma_tpu_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``dplasma_tpu``.

An AST sweep, not a ``sys.modules`` check: the test process imports
jax anyway (the reference tests do, and so may site customisation).
"""
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "dplasma_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dplasma_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_sweep_finds_the_package():
    assert len(FILES) > 15
    assert all(p.exists() for p in FILES)
    names = {str(p.relative_to(REPO)) for p in FILES}
    for mod in ("kernels/householder.py", "kernels/pallas_qr.py",
                "kernels/panels.py", "ops/qr.py", "ops/checks.py",
                "kernels/pallas_ring.py", "parallel/layout.py",
                "parallel/mesh.py", "parallel/cyclic.py",
                "kernels/quant.py", "ops/refine.py", "ops/aux.py",
                "ops/norms.py", "ops/blas3.py", "ops/potrf.py",
                "analysis/memcheck.py", "ops/gemm.py", "ops/info.py",
                "ops/map.py", "ops/matgen.py", "adtt.py", "dtd.py",
                "kernels/hostlink.py", "native.py", "utils/profiling.py",
                "observability/__init__.py", "observability/metrics.py",
                "observability/phases.py", "observability/comm.py",
                "observability/roofline.py", "observability/report.py",
                "observability/chrome.py", "observability/tracing.py",
                "observability/telemetry.py", "observability/devprof.py",
                "observability/trend.py", "analysis/hlo_names.py",
                "analysis/spmdcheck.py", "tools/perfdiff.py",
                "serving/__init__.py", "serving/admission.py",
                "serving/batched.py", "serving/cache.py",
                "serving/service.py", "tools/servebench.py"):
        assert f"dplasma_tpu_torch/{mod}" in names, mod


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = [(ln, n) for ln, n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_sweep_catches_a_violation(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom dplasma_tpu.ops import potrf\n"
                 "import jax.numpy as jnp\n"
                 "import importlib\nimportlib.import_module('jax')\n")
    assert [n for _, n in _imports(p) if _forbidden(n)] == \
        ["dplasma_tpu.ops", "jax.numpy", "jax"]
    assert not _forbidden("dplasma_tpu_torch.ops")


#: stdlib-only modules of the port: they import no torch either
STDLIB_ONLY = ("observability/trend.py", "tools/perfdiff.py")


@pytest.mark.parametrize("mod", STDLIB_ONLY)
def test_stdlib_only_modules_import_no_torch(mod):
    """At import time: only the module's top-level statements (trend's
    provenance probes torch inside a guard, at call time)."""
    tree = ast.parse((REPO / "dplasma_tpu_torch" / mod).read_text())
    tops = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops and not tops & {"torch", "numpy", "jax", "dplasma_tpu",
                                "dplasma_tpu_torch"}, tops


def test_trend_and_perfdiff_load_by_path_without_torch_or_jax(tmp_path):
    """With torch and jax blocked, the port's trend and perfdiff load by
    file path, ingest a ledger, gate a report against it, and stamp a
    provenance whose torch probe reads null."""
    ledger = tmp_path / "ledger.jsonl"
    docs = [{"family": "bench", "metric": "x_gpu", "ladder": [
        {"metric": "spotrf_gflops", "value": v, "unit": "GFLOP/s"}],
        "peaks": {}} for v in (100.0, 101.0, 99.5, 100.5, 100.2, 80.0)]
    ledger.write_text("".join(json.dumps(d) + "\n" for d in docs))
    code = textwrap.dedent(f"""
        import importlib.util, json, sys
        for name in ("torch", "jax", "jaxlib", "numpy"):
            sys.modules[name] = None
        root = {str(REPO / "dplasma_tpu_torch")!r}
        spec = importlib.util.spec_from_file_location(
            "port_trend", root + "/observability/trend.py")
        trend = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(trend)
        series, notes = trend.ingest_ledger({str(ledger)!r})
        (s,) = series.values()
        pd = trend._perfdiff()
        assert pd.__file__.endswith("dplasma_tpu_torch/tools/perfdiff.py")
        rc = pd.main([{str(ledger)!r}, {str(ledger)!r}])
        prov = trend.collect_provenance(family="bench")
        print(json.dumps({{"key": s["key"], "n": len(s["points"]),
                          "notes": notes, "gate": trend.gate_series(s),
                          "rc": rc, "torch": prov["torch"],
                          "mca": prov["mca"],
                          "loaded": sorted(m for m in ("torch", "jax",
                                           "dplasma_tpu_torch")
                                           if sys.modules.get(m))}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["key"] == "bench/spotrf_gflops@gpu" and out["n"] == 6
    assert out["notes"] == [] and out["rc"] == 0
    assert out["gate"]["regression"]["index"] == 5
    assert out["torch"] is None and out["mca"] is None
    assert out["loaded"] == []
