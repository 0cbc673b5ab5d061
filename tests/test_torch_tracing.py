"""The port's tracer (kubeflow_tpu_torch/observability/trace.py) held
against the JAX package's (kubeflow_tpu/observability/trace.py) on the
CPU: the same recorded sequence gives the same records in both (names,
trace ids, nesting parents, span-id parent chains, attributes), the
same ring wraparound, the same tail-sampling decisions (sample_prob 0,
0.5 with one sampling seed, and 1; the p99 rule; the bounded ring), the
same traceparent verdicts over a table with malformed headers, the same
Chrome trace schema and the same KFT_TRACE_* knob parsing. Span ids and
timestamps are random or wall-clock, so records are compared after
mapping each span id to its span's name. A disabled tracer records
nothing and costs microseconds."""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu.observability import trace as jtrace  # noqa: E402
from kubeflow_tpu_torch.observability import trace  # noqa: E402

PACKAGES = {"port": trace, "jax": jtrace}


# -- traceparent ---------------------------------------------------------------

TID, SID = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
HEADERS = [
    None, "", "garbage",
    f"00-{TID}-{SID}-01",
    f"  00-{TID.upper()}-{SID.upper()}-01 ",
    f"00-{TID}-{SID}-00",
    f"01-{TID}-{SID}-01",
    f"ff-{TID}-{SID}-01",                 # version ff
    f"00-{'0' * 32}-{SID}-01",            # zero trace id
    f"00-{TID}-{'0' * 16}-01",            # zero span id
    f"00-{'g' * 32}-{SID}-01",            # not hex
    f"00-short-{SID}-01",
    f"00-{TID}-{SID}-01-extra",
    f"00-{TID}-{SID}",
    f"00_{TID}_{SID}_01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_equals_the_jax_packages(header):
    assert trace.parse_traceparent(header) == jtrace.parse_traceparent(header)


def test_format_and_mint_equal_the_jax_packages():
    assert trace.format_traceparent(TID, SID) == \
        jtrace.format_traceparent(TID, SID)
    tid, sid = trace.mint_trace_id(), trace.mint_span_id()
    assert len(tid) == 32 and len(sid) == 16
    assert jtrace.parse_traceparent(trace.format_traceparent(tid, sid)) == \
        (tid, sid)
    assert len({trace.mint_trace_id() for _ in range(64)}) == 64
    assert trace.TRACEPARENT_HEADER == jtrace.TRACEPARENT_HEADER


# -- the same recorded sequence, the same records --------------------------------


def _normalized(records):
    """Records with span ids replaced by their span's name (ids are
    random) and times dropped."""
    names = {r.span_id: r.name for r in records}
    return [
        (r.name, r.trace_id, r.parent, r.phase,
         dict(r.attrs) if r.attrs else {},
         names.get(r.parent_span_id, r.parent_span_id))
        for r in records
    ]


def _scenario(mod):
    """Nesting, a thread's trace context with a remote parent, a
    cross-thread span ended on another thread, instants, an exception in
    a span, and a second thread with its own context."""
    tr = mod.Tracer(capacity=64)
    with tr.span("outer", trace_id="rid-1", bucket=8):
        with tr.span("inner"):
            tr.event("mark", value=1)
    with tr.trace_context("ctx-9", SID):
        with tr.span("root"):
            with tr.span("child", slot=3):
                pass
        sp = tr.start_span("xthread", model="m")
    done = threading.Event()

    def worker():
        sp.end(tokens=3)
        with tr.trace_context("ctx-w"):
            with tr.span("on-worker"):
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    assert done.wait(10)
    t.join(10)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    tr.event("after")
    assert tr.current_trace_id() is None
    return tr


def test_the_same_sequence_records_the_same_spans():
    got, want = _scenario(trace), _scenario(jtrace)
    assert _normalized(got.snapshot()) == _normalized(want.snapshot())
    recs = {r.name: r for r in got.snapshot()}
    assert recs["root"].parent_span_id == SID       # the remote parent
    assert recs["child"].parent_span_id == recs["root"].span_id
    assert recs["xthread"].tid == threading.main_thread().ident
    assert got.stats() == want.stats()


@pytest.mark.parametrize("capacity,events,shrink", [(8, 20, None),
                                                    (16, 10, 4),
                                                    (4, 4, 8)])
def test_ring_wraparound_equals_the_jax_packages(capacity, events, shrink):
    out = {}
    for key, mod in PACKAGES.items():
        tr = mod.Tracer(capacity=capacity)
        for i in range(events):
            tr.event(f"e{i}")
        if shrink is not None:
            tr.configure(capacity=shrink)
        out[key] = ([r.name for r in tr.snapshot()], tr.stats())
    assert out["port"] == out["jax"]
    if (capacity, events) == (8, 20):
        assert out["port"][1]["dropped"] == 12
        assert out["port"][0] == [f"e{i}" for i in range(12, 20)]


def test_thread_local_contexts_never_cross_contaminate():
    tr = trace.Tracer(capacity=1024)
    barrier = threading.Barrier(4)
    errors = []

    def worker(i):
        try:
            with tr.trace_context(f"ctx-{i}", f"{i:016x}"):
                barrier.wait(timeout=10)
                for j in range(20):
                    with tr.span(f"w{i}-s{j}"):
                        assert tr.current_trace_id() == f"ctx-{i}"
            assert tr.current_trace_id() is None
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    for r in tr.snapshot():
        i = int(r.name[1])
        assert r.trace_id == f"ctx-{i}"
        assert r.parent_span_id == f"{i:016x}"


# -- tail sampling -----------------------------------------------------------------


def _sampling(mod, prob, keep=8):
    """One recorded request stream through finish_trace: fast requests,
    errors, a slow tail after the minimum population, multi-row
    children → (reasons, kept ids and reasons, tracez sampling, stats)."""
    tr = mod.Tracer(capacity=256, sample_prob=prob, sample_keep=keep)
    tr.configure(sample_seed=3)
    reasons = []
    with tr.span("row0", trace_id="multi/0"):
        pass
    with tr.span("row1", trace_id="multi/1"):
        pass
    reasons.append(tr.finish_trace("multi", dur_s=0.01))
    reasons.append(tr.finish_trace("first-slow", dur_s=9.0))
    for i in range(30):
        reasons.append(tr.finish_trace(f"f{i}", dur_s=0.01 + 1e-4 * (i % 3)))
        if i % 7 == 0:
            reasons.append(tr.finish_trace(f"err{i}", error=True, dur_s=0.01))
    reasons.append(tr.finish_trace("slow", dur_s=1.0))
    reasons.append(tr.finish_trace("uniform", dur_s=0.01))
    reasons.append(tr.finish_trace(None, dur_s=0.01))
    kept = [(t["trace_id"], t["keep_reason"], t["error"],
             sorted(s["name"] for s in t["spans"]))
            for t in tr.completed_traces()]
    return reasons, kept, tr.tracez()["sampling"], tr.stats()


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_tail_sampling_decisions_equal_the_jax_packages(prob):
    got, want = _sampling(trace, prob), _sampling(jtrace, prob)
    assert got == want
    reasons, kept, sampling, _ = got
    assert reasons[1] != "tail"   # too few samples for a p99 yet
    if prob == 0.0:
        assert "tail" in reasons and set(reasons) == {None, "error", "tail"}
    if prob == 1.0:
        assert None not in reasons[:-1]
    assert len(kept) == sampling["buffered"] <= 8


def test_finish_trace_collects_the_rows_and_moves_the_counters():
    from kubeflow_tpu_torch.utils.metrics import default_registry

    reg = default_registry()
    tr = trace.Tracer(capacity=16, sample_prob=0.0)
    kept0 = reg.get("kft_trace_kept_total")
    base_err = kept0.value(reason="error") if kept0 else 0.0
    dropped0 = reg.get("kft_trace_sampled_out_total")
    base_drop = dropped0.value() if dropped0 else 0.0
    with tr.span("s", trace_id="bad/0"):
        pass
    assert tr.finish_trace("bad", error=True, dur_s=0.1) == "error"
    assert tr.finish_trace("d", dur_s=0.1) is None
    assert reg.get("kft_trace_kept_total").value(reason="error") == base_err + 1
    assert reg.get("kft_trace_sampled_out_total").value() == base_drop + 1
    (t,) = tr.completed_traces()
    assert [s["name"] for s in t["spans"]] == ["s"]


def test_exemplars_keep_the_worst_offenders():
    out = {}
    for key, mod in PACKAGES.items():
        tr = mod.Tracer(capacity=16)
        for i, v in enumerate([0.3, 0.9, 0.1, 0.7, 0.5, 0.8, 0.2]):
            tr.observe_exemplar("ttft", v, f"t{i}")
        out[key] = [(e["trace_id"], e["value"])
                    for e in tr.exemplars(k=3)["ttft"]]
    assert out["port"] == out["jax"] == [("t1", 0.9), ("t5", 0.8),
                                         ("t3", 0.7)]


# -- export and knobs ----------------------------------------------------------------


def _schema(doc):
    """Top-level keys and, per event phase, the event keys and arg keys."""
    events = {}
    for e in doc["traceEvents"]:
        keys, args = events.setdefault(e["ph"], (set(), set()))
        keys.update(e)
        args.update(e.get("args", {}))
    return (sorted(doc), {ph: (sorted(k), sorted(a))
                          for ph, (k, a) in events.items()})


def test_chrome_trace_has_the_jax_packages_schema():
    got, want = _scenario(trace), _scenario(jtrace)
    doc, jdoc = got.chrome_trace(), want.chrome_trace()
    assert _schema(doc) == _schema(jdoc)
    body = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert body == sorted(body, key=lambda e: e["ts"])
    assert [e["name"] for e in body] == [
        e["name"] for e in jdoc["traceEvents"] if e["ph"] != "M"]
    assert doc["displayTimeUnit"] == "ms"
    import json

    assert json.loads(got.chrome_trace_json())["traceEvents"]


def test_disabled_tracer_records_nothing_and_costs_microseconds():
    tr = trace.Tracer(capacity=64, enabled=False)
    with tr.span("s", model="m") as sp:
        assert sp is trace._NOOP
    tr.event("e")
    tr.start_span("x").end()
    assert tr.finish_trace("t", error=True, dur_s=9.0) is None
    tr.observe_exemplar("series", 1.0, "t")
    assert tr.snapshot() == [] and tr.completed_traces() == []
    assert tr.exemplars() == {}
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        tr.finish_trace("t", dur_s=0.01)
        tr.observe_exemplar("series", 0.01, "t")
        with tr.span("s"):
            pass
        tr.event("e")
    per_call = (time.perf_counter() - t0) / (4 * n)
    assert per_call < 2e-6, f"{per_call * 1e6:.2f}µs per disabled call"


KNOB_ENVS = [
    {},
    {"KFT_TRACE_ENABLED": "0"},
    {"KFT_TRACE_ENABLED": "false", "KFT_TRACE_STATUSZ": "off"},
    {"KFT_TRACE_ENABLED": "1", "KFT_TRACE_BUFFER_SPANS": "128",
     "KFT_TRACE_SAMPLE_PROB": "0.25", "KFT_TRACE_SAMPLE_KEEP": "7"},
    {"KFT_TRACE_STATUSZ": " ", "KFT_TRACE_BUFFER_SPANS": ""},
]


@pytest.mark.parametrize("env", KNOB_ENVS)
def test_knobs_from_env_equal_the_jax_packages(env):
    assert trace.knobs_from_env(env) == jtrace.knobs_from_env(env)


def test_configure_from_env_applies_to_the_default_tracer():
    tr = trace.default_tracer()
    before = tr.stats()
    try:
        knobs = trace.configure_from_env({
            "KFT_TRACE_ENABLED": "0", "KFT_TRACE_BUFFER_SPANS": "128",
            "KFT_TRACE_SAMPLE_PROB": "0.5", "KFT_TRACE_SAMPLE_KEEP": "9"})
        st = tr.stats()
        assert knobs["trace_enabled"] is False and st["enabled"] is False
        assert (st["capacity"], st["sample_prob"], st["sample_keep"]) == \
            (128, 0.5, 9)
    finally:
        tr.configure(enabled=before["enabled"], capacity=before["capacity"],
                     sample_prob=before["sample_prob"],
                     sample_keep=before["sample_keep"])
