"""The port stands alone: no module of ``dplasma_tpu_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``dplasma_tpu``.

An AST sweep, not a ``sys.modules`` check: the test process imports
jax anyway (the reference tests do, and so may site customisation).
"""
import ast
import pathlib

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
                "observability/chrome.py"):
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
