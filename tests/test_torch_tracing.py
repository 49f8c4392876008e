"""The port's span layer (``observability/tracing.py``) against the
reference's ``Tracer``: the same span script (nesting, ``add``,
``instant``, a raising body, four threads) through both gives the same
names, parents, request fields, attributes, span ids and
``balanced()``; the ring bound, the summary, the span document and the
Chrome export agree; a disabled tracer records nothing."""
import threading

import pytest

from dplasma_tpu.observability import chrome as ref_chrome
from dplasma_tpu.observability import tracing as ref_tracing
from dplasma_tpu_torch.observability import chrome as port_chrome
from dplasma_tpu_torch.observability import tracing
from torch_threads import one_torch_thread  # noqa: F401

T0 = 1_700_000_000_000_000_000


def _script(tr, worker: int = 0):
    """One thread's span script: nesting, add, instant, a raising body."""
    with tr.span("dispatch", request=worker, batch=3) as attrs:
        attrs["cache"] = "hit"
        with tr.span("gate", request=worker):
            tr.instant("shed", request=worker, reason="queue")
        with tr.span("ladder", requests=[worker, worker + 10]):
            pass
    tr.add("queue_wait", T0 + worker, T0 + worker + 500, request=worker,
           track=7, depth=2)
    with pytest.raises(ZeroDivisionError):
        with tr.span("rung", request=worker, rung="f32"):
            1 / 0
    with tr.span("after"):
        pass


def _run(tr, threads: int, concurrent: bool):
    _script(tr)
    workers = [threading.Thread(target=_script, args=(tr, w + 1))
               for w in range(threads)]
    if concurrent:
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    else:
        for w in workers:
            w.start()
            w.join()
    return tr


def _shape(spans):
    """Spans without clock readings: (sid, parent, name, request, attrs,
    track, rank, fields), in commit order."""
    out = []
    for s in spans:
        assert s["t1_ns"] >= s["t0_ns"]
        out.append((s["sid"], s["parent"], s["name"], s.get("request"),
                    s.get("attrs"), s["track"], s["rank"], sorted(s)))
    return out


def _by_name(spans):
    """Concurrent runs: lane numbers race, so compare (name, parent's
    name, request, attrs) as a multiset."""
    names = {s["sid"]: s["name"] for s in spans}
    return sorted((s["name"], names.get(s["parent"]), s.get("request"),
                   repr(s.get("attrs"))) for s in spans)


def test_sequential_threads_give_the_same_spans():
    ref = _run(ref_tracing.Tracer(rank=3), 4, concurrent=False)
    got = _run(tracing.Tracer(rank=3), 4, concurrent=False)
    assert _shape(got.spans()) == _shape(ref.spans())
    assert got.balanced() and ref.balanced()
    assert got.summary() == ref.summary()


def test_four_concurrent_threads_give_the_same_span_multiset():
    ref = _run(ref_tracing.Tracer(), 4, concurrent=True)
    got = _run(tracing.Tracer(), 4, concurrent=True)
    assert _by_name(got.spans()) == _by_name(ref.spans())
    assert len({s["sid"] for s in got.spans()}) == len(got.spans())
    assert got.balanced() and got.summary() == ref.summary()


def test_parents_follow_the_nesting():
    tr = _run(tracing.Tracer(), 0, concurrent=False)
    spans = {s["name"]: s for s in tr.spans()}
    assert spans["gate"]["parent"] == spans["dispatch"]["sid"]
    assert spans["ladder"]["parent"] == spans["dispatch"]["sid"]
    assert spans["dispatch"]["parent"] == -1
    assert spans["queue_wait"]["track"] == 7
    assert spans["rung"]["attrs"] == {"rung": "f32"}
    assert spans["dispatch"]["attrs"] == {"batch": 3, "cache": "hit"}
    assert spans["shed"]["t0_ns"] == spans["shed"]["t1_ns"]


@pytest.mark.parametrize("cap", [1, 5, 64])
def test_ring_bound_drops_alike(cap):
    ref = _run(ref_tracing.Tracer(capacity=cap), 2, concurrent=False)
    got = _run(tracing.Tracer(capacity=cap), 2, concurrent=False)
    assert got.summary() == ref.summary()
    assert _shape(got.spans()) == _shape(ref.spans())
    got.clear()
    ref.clear()
    assert got.summary() == ref.summary() and got.spans() == []


def test_disabled_tracer_records_nothing():
    for tr in (tracing.Tracer(enabled=False),
               ref_tracing.Tracer(enabled=False)):
        with tr.span("x", a=1) as attrs:
            attrs["b"] = 2
        tr.instant("y")
        tr.add("z", 0, 1)
        assert tr.spans() == [] and tr.balanced()
        assert attrs == {"a": 1, "b": 2}
    assert tracing.Tracer(enabled=False).summary() == \
        ref_tracing.Tracer(enabled=False).summary()


def test_document_save_and_chrome_match_the_reference(tmp_path):
    got = _run(tracing.Tracer(rank=2), 1, concurrent=False)
    doc = got.to_doc()
    assert set(doc) == {"dplasma_serving_spans", "rank", "spans"}
    assert doc["dplasma_serving_spans"] == ref_tracing.SPANS_SCHEMA
    path = got.save(str(tmp_path / "spans.json"))
    import json
    assert json.loads(open(path).read()) == doc
    assert got.to_chrome() == ref_chrome.spans_to_chrome(
        got.spans(), rank=2, name="serving")
    assert got.to_chrome("x") == port_chrome.spans_to_chrome(
        got.spans(), rank=2, name="x")


def test_dead_thread_lanes_are_recycled():
    tr = tracing.Tracer()
    for _ in range(6):
        t = threading.Thread(target=lambda: tr.instant("tick"))
        t.start()
        t.join()
    tracks = {s["track"] for s in tr.spans()}
    assert len(tracks) == 1 and len(tr._states) == 1
    assert len({s["sid"] for s in tr.spans()}) == 6
