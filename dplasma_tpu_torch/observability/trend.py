"""trend: longitudinal perf series over the cross-run ledger
(``dplasma_tpu/observability/trend.py``; stdlib only, like it).

The port's perfdiff core (``dplasma_tpu_torch/tools/perfdiff.py``)
gates newest against previous with fixed relative thresholds; this
module supplies the trajectory those gates lack. Three layers:

**Ingestion & normalization.** Every comparable document — bench
one-line docs, run-reports of any schema vintage (v1-v18) from either
package, ledger entries, the committed
``BENCH_r*/MULTICHIP_r*/SERVEBENCH_r*.json`` artifacts — parses into
uniform metric series keyed by::

    (family, metric, knob signature, platform, placeholder)

The knob signature is the canonical serialization of the doc-level
``"pipeline"`` knob vector plus the per-row tile size, so a knob flip
starts a new series; the platform key (provenance backend, env backend,
or a bench headline's ``_tpu``/``_cpu``/``_gpu`` suffix) keeps CPU runs
out of card series; a ``"placeholder": true`` curve never shares a
series with a hardware curve.

**Noise model + changepoint detection.** :func:`noise_sigma` is the
rolling median-absolute-deviation of the successive relative steps
(window :data:`WINDOW`, scaled by 1.4826), defined from
:data:`MIN_HISTORY` points; :func:`auto_threshold` turns it into the
gate bound ``max(z * sigma, AUTO_FLOOR)``. :func:`changepoints` is a
recursive median-shift detector; :func:`gate_series` turns the newest
changepoint into a regression verdict when its trailing segment moved
in the worse direction.

**Provenance.** :func:`collect_provenance` assembles the run-report's
``"provenance"`` section (schema v18) with the reference's keys, where
``torch`` and ``cuda`` (``torch.version.cuda``) stand for ``jax`` and
``jaxlib``, ``backend`` is ``cuda`` or ``cpu`` (as the report's
``env``), ``device_name`` names the card, and ``mca`` is the port's
override snapshot. Every probe is guarded: on a host without git or
torch the fields are explicit nulls, never an exception. Git is asked
about the checkout itself only: a copy without its own ``.git`` reads
``"git": null``, never the commit of a repository that encloses it.

Section-metric extraction delegates to the port's perfdiff copy (one
extractor, two consumers), loaded by file path so that nothing here
imports torch.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

#: points needed before the successive-step noise model is defined
#: (below it, auto thresholds fall back to the caller's fixed fraction)
MIN_HISTORY = 5
#: points needed before the changepoint detector runs on a series
MIN_POINTS = 3
#: rolling window (in successive relative steps) of the noise model
WINDOW = 12
#: default gate bound in noise-sigma units
Z_SIGMA = 3.0
#: relative noise floor: a series of identical values still needs a
#: real shift (not a rounding echo) to flag
NOISE_FLOOR = 0.005
#: minimum relative median shift a changepoint must clear — sub-5%
#: steps are not actionable on this suite regardless of sigma
MIN_SHIFT = 0.05
#: floor of the adaptive threshold (an ultra-quiet series must not
#: gate on a 0.6% wiggle)
AUTO_FLOOR = 0.02
#: provenance stamp version (independent of the run-report schema)
PROVENANCE_SCHEMA = 1

#: normal-consistency constant: sigma ~= 1.4826 * MAD
_MAD_K = 1.4826

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_PKG_ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the name the by-path load registers the port's perfdiff under
_PERFDIFF_NAME = "dplasma_tpu_torch_perfdiff"


def _perfdiff():
    """dplasma_tpu_torch/tools/perfdiff.py, loaded by file path (both
    modules are stdlib-only; importing the package root would drag in
    torch)."""
    mod = sys.modules.get(_PERFDIFF_NAME)
    if mod is not None and hasattr(mod, "extract_metrics"):
        return mod
    path = _PKG_ROOT / "tools" / "perfdiff.py"
    spec = importlib.util.spec_from_file_location(_PERFDIFF_NAME, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load perfdiff from {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_PERFDIFF_NAME] = mod
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ families

def doc_family(doc) -> Optional[str]:
    """The series family of one ledger document, or ``None`` for an
    envelope-less fragment.

    The envelope contract (every current writer): an explicit
    ``"family"`` key, or a run-report's ``schema`` + ``name`` pair.
    Pre-envelope vintages are recognized by shape so historical
    ledgers still ingest: a bench one-line doc carries
    ``ladder`` + ``peaks``, the old multichip doc announces itself as
    ``multichip_scaling``, racefuzz reports carry a ``racefuzz``
    section, tuner trials the ``"tuning": true`` mark."""
    if not isinstance(doc, dict):
        return None
    fam = doc.get("family")
    if isinstance(fam, str) and fam:
        return fam
    name = doc.get("name")
    if doc.get("schema") is not None and isinstance(name, str) and name:
        return name
    if doc.get("tuning") is True:
        return "tuning"
    if doc.get("metric") == "multichip_scaling":
        return "multichip"
    if doc.get("bench") == "servebench":
        return "servebench"
    if isinstance(doc.get("racefuzz"), dict):
        return "racefuzz"
    if "ladder" in doc and "peaks" in doc:
        return "bench"
    return None


def doc_platform(doc) -> Optional[str]:
    """Backend platform of one document: provenance stamp, env
    section, or the bench headline's ``_tpu``/``_cpu`` suffix."""
    if not isinstance(doc, dict):
        return None
    prov = doc.get("provenance")
    if isinstance(prov, dict) and isinstance(prov.get("backend"), str):
        return prov["backend"]
    env = doc.get("env")
    if isinstance(env, dict) and isinstance(env.get("backend"), str):
        return env["backend"]
    metric = doc.get("metric")
    if isinstance(metric, str):
        tail = metric.rsplit("_", 1)[-1]
        if tail in ("cpu", "tpu", "gpu"):
            return tail
    return None


def knob_signature(doc, row: Optional[dict] = None) -> str:
    """Canonical serialization of the knob vector a measurement ran
    under: the doc-level ``"pipeline"`` resolved-knob dict plus the
    per-row tile size. Two entries with different signatures belong
    to different series — a knob flip starts a new trajectory."""
    parts = {}
    if isinstance(doc, dict) and isinstance(doc.get("pipeline"), dict):
        parts.update(doc["pipeline"])
    if isinstance(row, dict) and row.get("nb") is not None:
        parts["nb"] = row["nb"]
    if not parts:
        return ""
    return json.dumps(parts, sort_keys=True, default=str)


# ----------------------------------------------------------- ingestion

def iter_points(doc) -> List[Tuple[str, dict]]:
    """Every comparable metric of one document as
    ``(metric, {"value", "better", "unit", "placeholder", "knobs"})``
    rows. Ladder/entries rows are walked natively (they carry
    per-row units, tile sizes, and placeholder marks the flat
    extractor drops); every other section goes through perfdiff's
    ``extract_metrics`` so the observatory and the pairwise gate can
    never disagree about what a document measures."""
    if not isinstance(doc, dict):
        return []
    ph_doc = doc.get("placeholder") is True
    out: List[Tuple[str, dict]] = []
    for e in (doc.get("entries") or []) + (doc.get("ladder") or []):
        if not (isinstance(e, dict) and isinstance(e.get("metric"), str)
                and isinstance(e.get("value"), (int, float))):
            continue
        better = e.get("better")
        out.append((e["metric"], {
            "value": float(e["value"]),
            "better": better if better in ("lower", "higher")
            else "higher",
            "unit": e.get("unit"),
            "placeholder": ph_doc or e.get("placeholder") is True,
            "knobs": knob_signature(doc, e)}))
    sections = {k: v for k, v in doc.items()
                if k not in ("entries", "ladder")}
    for name, m in _perfdiff().extract_metrics(sections).items():
        out.append((name, {"value": m["value"], "better": m["better"],
                           "unit": None, "placeholder": ph_doc,
                           "knobs": knob_signature(doc)}))
    return out


def series_key(family: str, metric: str, knobs: str,
               platform: Optional[str], placeholder: bool) -> str:
    """Human-readable unique series identity."""
    key = f"{family}/{metric}"
    if platform:
        key += f"@{platform}"
    if knobs:
        # short stable digest: the full signature lives on the series
        key += f"#{abs(hash_knobs(knobs)):08x}"
    if placeholder:
        key += " [placeholder]"
    return key


def hash_knobs(knobs: str) -> int:
    """Deterministic (process-independent) digest of a knob
    signature — ``hash()`` is salted per process and would scatter
    one config across keys."""
    h = 0
    for ch in knobs:
        h = (h * 131 + ord(ch)) & 0x7FFFFFFF
    return h


def build_series(docs) -> Dict[str, dict]:
    """Fold documents (``(doc, source)`` pairs or bare dicts, oldest
    first) into series. Envelope-less fragments are recorded in the
    returned map's ``"_notes"``-free sibling — callers use
    :func:`ingest_ledger` for note handling; here a classifiable
    family is required and unclassifiable docs are skipped."""
    series: Dict[str, dict] = {}
    for seq, item in enumerate(docs):
        doc, source = item if isinstance(item, tuple) else (item, None)
        fam = doc_family(doc)
        if fam is None:
            continue
        platform = doc_platform(doc)
        t = doc.get("created_unix_ns") if isinstance(doc, dict) else None
        prov = doc.get("provenance") if isinstance(doc, dict) else None
        if t is None and isinstance(prov, dict):
            t = prov.get("captured_unix_ns")
        for metric, row in iter_points(doc):
            key = series_key(fam, metric, row["knobs"], platform,
                             row["placeholder"])
            s = series.setdefault(key, {
                "key": key, "family": fam, "metric": metric,
                "knobs": row["knobs"], "platform": platform,
                "placeholder": row["placeholder"],
                "better": row["better"], "unit": row["unit"],
                "points": []})
            if row["unit"] and not s["unit"]:
                s["unit"] = row["unit"]
            s["points"].append({"value": row["value"], "seq": seq,
                                "t": t, "source": source,
                                "provenance": prov})
    return series


def ingest_ledger(path) -> Tuple[Dict[str, dict], List[str]]:
    """One ``.jsonl`` ledger into series + human notes: unparseable
    lines and envelope-less fragments are NAMED (file:line), never a
    crash and never a silent skip."""
    docs = []
    notes: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
            except ValueError as exc:
                notes.append(f"{path}:{lineno}: unparseable ledger "
                             f"line ({exc})")
                continue
            if doc_family(doc) is None:
                notes.append(f"{path}:{lineno}: envelope-less ledger "
                             f"fragment (no family/schema key); "
                             f"skipped")
                continue
            docs.append((doc, f"{path}:{lineno}"))
    return build_series(docs), notes


def load_artifact(path) -> Tuple[List[dict], List[str]]:
    """Docs inside one committed artifact. Handles the campaign
    wrapper shape (``{"n", "cmd", "rc", "tail", "parsed"}`` around a
    bench one-line doc), plain run-reports / ledger docs, and the
    metric-free multichip smoke bits (``{"n_devices", "ok", ...}``) —
    the latter two-line note instead of a crash."""
    name = pathlib.Path(path).name
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        return [], [f"{name}: not a JSON object; skipped"]
    if "parsed" in raw and "cmd" in raw:
        parsed = raw.get("parsed")
        if not isinstance(parsed, dict):
            return [], [f"{name}: no parsed doc (rc={raw.get('rc')}); "
                        f"skipped"]
        return [parsed], []
    if "n_devices" in raw and "metric" not in raw \
            and "schema" not in raw:
        return [], [f"{name}: smoke bit without metrics; skipped"]
    return [raw], []


# --------------------------------------------------------- noise model

def rel_steps(values: List[float]) -> List[float]:
    """Successive relative steps ``(v[i]-v[i-1]) / v[i-1]``; pairs
    with a nonpositive base are skipped (perf metrics are positive —
    a zero base carries no relative information)."""
    out = []
    for prev, cur in zip(values, values[1:]):
        if prev > 0:
            out.append((cur - prev) / prev)
    return out


def noise_sigma(values: List[float],
                window: int = WINDOW) -> Optional[float]:
    """Robust relative noise of a series: 1.4826 x the median
    absolute deviation of the trailing ``window`` successive relative
    steps, floored at :data:`NOISE_FLOOR`. ``None`` below
    :data:`MIN_HISTORY` points — too little history to calibrate."""
    if len(values) < MIN_HISTORY:
        return None
    steps = rel_steps(values)[-window:]
    if len(steps) < MIN_HISTORY - 1:
        return None
    med = statistics.median(steps)
    mad = statistics.median([abs(s - med) for s in steps])
    return max(_MAD_K * mad, NOISE_FLOOR)


def auto_threshold(values: List[float], fixed: float,
                   z: float = Z_SIGMA
                   ) -> Tuple[float, Optional[float], bool]:
    """Adaptive gate threshold for a series:
    ``(threshold, sigma, used_auto)``. With enough history the bound
    is ``max(z * sigma, AUTO_FLOOR)``; below :data:`MIN_HISTORY` the
    caller's fixed fraction stands and ``used_auto`` is False."""
    sigma = noise_sigma(values)
    if sigma is None:
        return fixed, None, False
    return max(z * sigma, AUTO_FLOOR), sigma, True


# --------------------------------------------------- changepoint model

def changepoints(values: List[float], z: float = Z_SIGMA,
                 min_shift: float = MIN_SHIFT) -> List[dict]:
    """Median-shift changepoints by recursive binary segmentation.

    The split is chosen by L1 cost (the sum of absolute deviations
    from each segment's median — a score-based pick lands off-by-one
    next to a clean step, because the median hides one contaminating
    point); the chosen split is a changepoint when the between-
    segment median shift clears ``z`` pooled within-segment MAD units
    (1.4826-scaled, floored at :data:`NOISE_FLOOR` relative) AND the
    :data:`MIN_SHIFT` relative floor — doubled when either segment is
    a single point, so one outlier draw cannot masquerade as a regime
    while a real fresh step at the series end (one post-step point)
    still names itself. Segmentation recurses into both halves.
    Returns ``[{"index", "before", "after", "shift", "sigma",
    "score"}]`` sorted by index — ``index`` is the first point of the
    new regime, ``shift`` the signed relative median change,
    ``sigma`` the pooled relative noise the score was measured in."""
    found: List[dict] = []

    def seg_cost(seg: List[float]) -> Tuple[float, float]:
        m = statistics.median(seg)
        return sum(abs(v - m) for v in seg), m

    def scan(lo: int, hi: int) -> None:
        if hi - lo < MIN_POINTS:
            return
        best = None
        for i in range(lo + 1, hi):
            cl, ml = seg_cost(values[lo:i])
            cr, mr = seg_cost(values[i:hi])
            if ml <= 0:
                continue
            if best is None or cl + cr < best[0]:
                best = (cl + cr, i, ml, mr)
        if best is None:
            return
        _, i, ml, mr = best
        left, right = values[lo:i], values[i:hi]
        devs = [abs(v - ml) for v in left] \
            + [abs(v - mr) for v in right]
        sigma_abs = max(_MAD_K * statistics.median(devs),
                        NOISE_FLOOR * ml)
        shift = (mr - ml) / ml
        score = abs(mr - ml) / sigma_abs
        floor = min_shift if min(len(left), len(right)) >= 2 \
            else 2.0 * min_shift
        if score < z or abs(shift) < floor:
            return
        found.append({"index": i, "before": ml, "after": mr,
                      "shift": shift, "sigma": sigma_abs / ml,
                      "score": score})
        scan(lo, i)
        scan(i, hi)

    scan(0, len(values))
    return sorted(found, key=lambda c: c["index"])


def gate_series(series: dict, z: float = Z_SIGMA,
                min_shift: float = MIN_SHIFT) -> Optional[dict]:
    """Regression verdict for one series, or ``None`` when the series
    cannot gate (placeholder, or fewer than :data:`MIN_POINTS`
    points). The newest changepoint owns the trailing segment; the
    verdict is a regression when that segment's median moved in the
    worse direction of the series' ``better`` field."""
    if series.get("placeholder"):
        return None
    values = [p["value"] for p in series["points"]]
    if len(values) < MIN_POINTS:
        return None
    cps = changepoints(values, z=z, min_shift=min_shift)
    verdict = {"key": series["key"], "metric": series["metric"],
               "family": series["family"], "points": len(values),
               "changepoints": cps, "regression": None}
    if not cps:
        return verdict
    last = cps[-1]
    worse = last["shift"] < 0 if series["better"] == "higher" \
        else last["shift"] > 0
    if worse:
        verdict["regression"] = {
            "index": last["index"], "shift": last["shift"],
            "sigma": last["sigma"],
            "effect_sigma": abs(last["shift"]) / max(last["sigma"],
                                                     NOISE_FLOOR),
            "before": last["before"], "after": last["after"]}
    return verdict


# ---------------------------------------------------------- provenance

def _git_state(repo_root) -> Optional[dict]:
    """``{"sha", "dirty"}`` of the repo, or None when git (or the
    repo) is unavailable — the stamp must never fail a run. Only a
    ``repo_root`` that is itself a work tree's top is asked: git's
    discovery stops at ``repo_root`` (``GIT_CEILING_DIRECTORIES``), and
    ``git status`` takes no optional lock, so a copy nested in another
    repository neither reads nor refreshes that repository."""
    root = pathlib.Path(repo_root).resolve()
    env = dict(os.environ, GIT_CEILING_DIRECTORIES=str(root.parent),
               GIT_OPTIONAL_LOCKS="0")
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel", "HEAD"], cwd=str(root),
            env=env, capture_output=True, text=True, timeout=10)
        lines = top.stdout.splitlines()
        if top.returncode != 0 or len(lines) != 2 \
                or pathlib.Path(lines[0]).resolve() != root:
            return None
        status = subprocess.run(
            ["git", "status", "--porcelain"], cwd=str(root), env=env,
            capture_output=True, text=True, timeout=10)
        return {"sha": lines[1],
                "dirty": bool(status.stdout.strip())
                if status.returncode == 0 else None}
    except (OSError, subprocess.SubprocessError):
        return None


def collect_provenance(*, family: Optional[str] = None,
                       mesh_shape=None,
                       peaks_source: Optional[str] = None,
                       repo_root=None) -> dict:
    """The schema-v18 ``"provenance"`` stamp: git SHA + dirty flag,
    torch and CUDA versions, backend (``cuda``/``cpu``) + device count
    + the card's name, mesh shape, peaks source
    (``bench``/``default``/``file``), the active MCA override snapshot,
    and the ladder family. Every probe is guarded: on a host without
    git/torch the corresponding fields are explicit nulls/absent, never
    an exception."""
    prov: dict = {"schema": PROVENANCE_SCHEMA}
    if family:
        prov["family"] = family
    prov["git"] = _git_state(repo_root or _REPO_ROOT)
    try:
        import torch
        cuda = torch.cuda.is_available()
        prov["torch"] = torch.__version__
        prov["cuda"] = torch.version.cuda
        prov["backend"] = "cuda" if cuda else "cpu"
        prov["device_count"] = torch.cuda.device_count() if cuda else 1
        prov["device_name"] = (torch.cuda.get_device_name(0) if cuda
                               else None)
    except Exception:   # noqa: BLE001 — any torch import/probe failure
        prov["torch"] = prov["cuda"] = prov["backend"] = None
        prov["device_count"] = prov["device_name"] = None
    if mesh_shape is not None:
        prov["mesh_shape"] = [int(x) for x in mesh_shape]
    if peaks_source is not None:
        prov["peaks_source"] = peaks_source
    try:
        from dplasma_tpu_torch.utils.config import mca_snapshot
        prov["mca"] = mca_snapshot()
    except Exception:   # noqa: BLE001 — stdlib-only hosts: no package
        prov["mca"] = None
    return prov
