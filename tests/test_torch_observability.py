"""The port's serving observability on the CPU (gpt_tiny f32, the session
weights bridged from JAX), held against the JAX package's engine and
server on the same weights and requests:

- a request's spans (`request.queue_wait`, `request.prefill`,
  `request.decode`, the `request.retire` event) carry its trace id and
  the reference's parent structure, an inbound traceparent's span being
  the remote parent of each; TTFT decomposes exactly into queue +
  prefill; greedy tokens are bitwise the same traced and untraced;
- over REST: X-Request-Id echoed, a traceparent continued, an id minted
  when neither header comes, `/debug/trace?trace_id=` one request,
  `/tracez` the kept traces, `/statusz`'s models and engines lines equal
  to the JAX server's for the same engine state (time figures aside),
  and with `statusz_enabled=False` only the model surface;
- `ObservabilityConfig`, `ChaosConfig` and the serving config's chaos
  check accept and refuse the same dicts as the JAX package's;
- `greedy_generate` gives the JAX package's tokens.
Token comparisons are exact (f32 logits agree to ~1e-6, far inside the
greedy margins of these prompts)."""

import json
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ChaosConfig,
    ConfigError,
    ObservabilityConfig,
    ServingConfig,
)
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.observability.trace import (  # noqa: E402
    default_tracer,
    format_traceparent,
)
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402
from kubeflow_tpu_torch.serving.generate import greedy_generate  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402

ROWS = ([1, 2, 3], [7, 8, 9, 10, 11], list(range(30, 50)))
TID, SID = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"


@pytest.fixture(autouse=True)
def _restore_tracers():
    """Tests toggle the process tracers: restore both packages'."""
    from kubeflow_tpu.observability.trace import default_tracer as jtracer

    saved = [(tr, tr.stats()) for tr in (default_tracer(), jtracer())]
    yield
    for tr, st in saved:
        tr.configure(enabled=st["enabled"], capacity=st["capacity"])


@pytest.fixture(scope="module")
def tiny(gpt_and_params):
    jmodel, params = gpt_and_params
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _servers(tiny, **kw):
    """(port server, port engine, JAX server, JAX engine), each engine
    named "g" with 2 slots on the same weights."""
    from kubeflow_tpu.serving.engine import DecodeEngine as JDecodeEngine
    from kubeflow_tpu.serving.server import ModelServer as JModelServer

    jmodel, params, tmodel = tiny
    eng = DecodeEngine("g", tmodel, device="cpu", num_slots=2, max_queue=16,
                       **kw)
    server = ModelServer()
    server.add_engine(eng)
    jeng = JDecodeEngine("g", jmodel, params, num_slots=2, max_queue=16, **kw)
    jserver = JModelServer()
    jserver.add_engine(jeng)
    return server, eng, jserver, jeng


def _post(server, row, n, **headers):
    return server.app.handle_full(
        "POST", "/v1/models/g:generate",
        {"prompt_ids": [list(row)], "max_new_tokens": n}, headers=headers)


def _wait_for(tracer, trace_id, name="request.retire"):
    """The retire event lands just after the future resolves."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        recs = [r for r in tracer.snapshot() if r.trace_id == trace_id]
        if any(r.name == name for r in recs):
            return recs
        time.sleep(0.01)
    raise AssertionError(f"no {name} for {trace_id}")


def _structure(records, remote=None):
    """(name, phase, parent) a record, the parent resolved to its span's
    name, "remote" for the inbound traceparent's span, else None."""
    names = {r.span_id: r.name for r in records}
    out = set()
    for r in records:
        parent = (names.get(r.parent_span_id)
                  or ("remote" if remote and r.parent_span_id == remote
                      else r.parent_span_id))
        out.add((r.name, r.phase, parent))
    return out


# -- spans ---------------------------------------------------------------------------


@pytest.mark.parametrize("inbound", ["x-request-id", "traceparent"])
def test_a_request_records_the_jax_engines_spans(tiny, inbound):
    from kubeflow_tpu.observability.trace import default_tracer as jtracer

    server, eng, jserver, jeng = _servers(tiny)
    tr, jtr = default_tracer(), jtracer()
    tr.configure(enabled=True)
    jtr.configure(enabled=True)
    try:
        if inbound == "traceparent":
            headers = {"traceparent": format_traceparent(TID, SID),
                       "X-Request-Id": "ignored"}
            rid = TID
        else:
            headers = {"X-Request-Id": "client-abc"}
            rid = "client-abc"
        got = {}
        for key, srv, tracer in (("port", server, tr), ("jax", jserver, jtr)):
            tracer.clear()
            status, body, hdrs = _post(srv, ROWS[1], 4, **headers)
            assert status == 200, body
            assert dict(hdrs)["X-Request-Id"] == rid
            got[key] = (body, _structure(_wait_for(tracer, f"{rid}/0"),
                                         remote=SID))
    finally:
        eng.close()
        jeng.close()
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    names = {name for name, _, _ in got["port"][1]}
    assert names == {"request.queue_wait", "request.prefill",
                     "request.decode", "request.retire"}
    want_parent = "remote" if inbound == "traceparent" else None
    assert {parent for _, _, parent in got["port"][1]} == {want_parent}


def test_ttft_decomposes_into_queue_plus_prefill(tiny):
    _, _, tmodel = tiny
    eng = DecodeEngine("g", tmodel, device="cpu", num_slots=2)
    try:
        outs = [eng.submit(row, 3) for row in ROWS]
        outs = [f.wait(120) for f in outs]
        state = eng.debug_state()
    finally:
        eng.close()
    recent = state["recent"]
    assert len(recent) == len(ROWS)
    for r in recent:
        assert r["queue_s"] + r["prefill_s"] == pytest.approx(r["ttft_s"],
                                                             abs=1e-9)
        assert r["decode_s"] >= 0.0 and r["tokens"] == 3
    assert sorted(r["ttft_s"] for r in recent) == \
        pytest.approx(sorted(o["ttft_s"] for o in outs), abs=1e-9)


def test_greedy_tokens_are_bitwise_the_same_traced_and_untraced(tiny):
    _, _, tmodel = tiny
    tr = default_tracer()
    out = {}
    for enabled in (True, False):
        tr.configure(enabled=enabled)
        tr.clear()
        eng = DecodeEngine("g", tmodel, device="cpu", num_slots=2,
                           page_size=8, paged_attention="kernel")
        try:
            futures = [eng.submit(row, 6) for row in ROWS]
            out[enabled] = [f.wait(120)["tokens"] for f in futures]
        finally:
            eng.close()
        recorded = tr.snapshot()
        if enabled:
            assert {"engine.step", "request.decode"} <= {
                r.name for r in recorded}
        else:
            assert recorded == []
    assert out[True] == out[False]


def test_a_drafted_engine_records_draft_verify_and_rewind(tiny):
    _, _, tmodel = tiny
    tr = default_tracer()
    tr.configure(enabled=True)
    tr.clear()
    # a rolled head never proposes the target's argmax: every window
    # rewinds
    draft = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    draft.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        head = dict(draft.named_parameters())
        name = next(n for n in head if "wte" in n or "embed" in n)
        head[name].copy_(torch.roll(head[name], 1, 0))
    eng = DecodeEngine("g", tmodel, device="cpu", num_slots=2, page_size=8,
                       draft_model=draft, num_draft_tokens=2)
    try:
        eng.generate_row(ROWS[1], 5, timeout=120)
    finally:
        eng.close()
    names = [r.name for r in tr.snapshot()]
    assert "engine.draft" in names and "engine.verify" in names
    assert "engine.step" not in names
    assert "engine.rewind" in names


# -- REST ------------------------------------------------------------------------------


def test_request_ids_over_rest(tiny):
    _, _, tmodel = tiny
    tr = default_tracer()
    tr.configure(enabled=True)
    tr.clear()
    eng = DecodeEngine("g", tmodel, device="cpu", num_slots=2)
    server = ModelServer()
    server.add_engine(eng)
    try:
        # minted when neither header comes
        status, _, hdrs = _post(server, ROWS[0], 2)
        minted = dict(hdrs)["X-Request-Id"]
        assert status == 200 and minted.startswith("req-")
        # a malformed traceparent degrades to X-Request-Id
        status, _, hdrs = _post(server, ROWS[0], 2,
                                traceparent="00-garbage-01",
                                **{"X-Request-Id": "r1"})
        assert dict(hdrs)["X-Request-Id"] == "r1"
        status, _, _ = _post(server, ROWS[1], 2, **{"X-Request-Id": "r2"})
        assert status == 200
        _wait_for(tr, "r2/0")
        # /debug/trace: one row, or the whole request by the echoed id
        for query, rows in (("r1/0", {"r1/0"}), ("r1", {"r1/0"})):
            status, resp, _ = server.app.handle_full(
                "GET", "/debug/trace", query={"trace_id": query})
            assert status == 200
            doc = json.loads(resp.body)
            body = [e for e in doc["traceEvents"] if e["ph"] != "M"]
            assert body and {e["args"]["trace_id"] for e in body} == rows
            assert any(e["ph"] == "M" for e in doc["traceEvents"])
        # /tracez: every finished request kept (sample_prob 1), one by id
        status, resp, _ = server.app.handle_full("GET", "/tracez")
        kept = {t["trace_id"] for t in json.loads(resp.body)["traces"]}
        assert {minted, "r1", "r2"} <= kept
        status, resp, _ = server.app.handle_full(
            "GET", "/tracez", query={"trace_id": "r2"})
        (one,) = json.loads(resp.body)["traces"]
        assert one["keep_reason"] == "sampled" and one["spans"]
        ex = json.loads(resp.body)["exemplars"][
            "serving_time_to_first_token_seconds"]
        assert {e["trace_id"] for e in ex} >= {"r1", "r2"}
    finally:
        eng.close()


def _sections(text):
    """The [models] and [engines] sections, each figure of a time
    (`queue=   1.0ms`) masked."""
    body = text.split("\n[models]\n", 1)[1]
    return re.sub(r"=\s*[0-9.]+ms", "=<t>ms", body)


def test_statusz_lines_equal_the_jax_servers(tiny):
    server, eng, jserver, jeng = _servers(tiny)
    try:
        for srv, engine in ((server, eng), (jserver, jeng)):
            for i, row in enumerate(ROWS):
                _post(srv, row, 3, **{"X-Request-Id": f"s{i}"})
            # a prefix hit
            engine.generate_row(ROWS[2], 3, timeout=120, trace_id="hit")
        texts = []
        for srv in (server, jserver):
            status, resp, _ = srv.app.handle_full("GET", "/statusz")
            assert status == 200
            texts.append(resp.body.decode())
    finally:
        eng.close()
        jeng.close()
    port_text, jax_text = texts
    assert _sections(port_text) == _sections(jax_text)
    assert "[engines]" in port_text and "kernel: gather" in port_text
    assert "recent requests (newest last):" in port_text
    assert "hit_tokens=0" not in port_text


def test_statusz_shows_the_kv_tiers_line(tiny, tmp_path):
    _, _, tmodel = tiny
    eng = DecodeEngine("g", tmodel, device="cpu", num_slots=2, page_size=8,
                       kv_host_bytes=1 << 20,
                       kv_persist_dir=str(tmp_path / "store"))
    server = ModelServer()
    server.add_engine(eng)
    try:
        status, resp, _ = server.app.handle_full("GET", "/statusz")
    finally:
        eng.close()
    text = resp.body.decode()
    assert status == 200
    assert re.search(r"kv tiers: host=0 entries 0/1048576 B spilled=0 "
                     r"spill_hits=0 \| store=\S+store persisted_chains=0",
                     text), text


def test_statusz_disabled_leaves_the_model_surface_only():
    server = ModelServer(statusz_enabled=False)
    for path in ("/statusz", "/debug/trace", "/tracez"):
        assert server.app.handle_full("GET", path)[0] == 404
    # /metrics is the server's own route, served either way
    assert server.app.handle_full("GET", "/metrics")[0] == 200
    assert server.app.handle_full("GET", "/v1/models")[0] == 200
    server = ModelServer()
    status, resp, _ = server.app.handle_full("GET", "/metrics")
    assert status == 200 and b"kft_instance_info{" in resp.body


def test_build_debug_app_serves_the_jax_packages_routes():
    """The standalone debug app answers the JAX one's routes, /metrics
    with this process's training identity among them."""
    from kubeflow_tpu.observability.http import build_debug_app as jbuild
    from kubeflow_tpu_torch.observability import build_debug_app

    app, japp = build_debug_app("dbg"), jbuild("jdbg", role="training")
    for path in ("/debug/trace", "/statusz", "/tracez", "/metrics"):
        assert app.handle_full("GET", path)[0] == 200, path
        assert japp.handle_full("GET", path)[0] == 200, path
    body = app.handle_full("GET", "/metrics")[1].body
    assert b'kft_instance_info{' in body and b'role="training"' in body
    assert json.loads(app.handle_full("GET", "/debug/trace")[1].body)[
        "traceEvents"] is not None


def test_build_server_reads_the_trace_knobs(monkeypatch):
    from kubeflow_tpu_torch.serving.main import build_server

    monkeypatch.setenv("KFT_TRACE_STATUSZ", "0")
    monkeypatch.setenv("KFT_TRACE_BUFFER_SPANS", "512")
    monkeypatch.setenv("KFT_CHAOS_POINTS", "engine.prefill:once")
    from kubeflow_tpu_torch.chaos import default_chaos

    try:
        ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                          num_slots=0)
        assert ms.app.handle_full("GET", "/statusz")[0] == 404
        assert default_tracer().capacity == 512
        assert default_chaos().armed_points() == ["engine.prefill"]
        ms.close()
        ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                          num_slots=0, statusz_enabled=True,
                          trace_buffer_spans=256)
        assert ms.app.handle_full("GET", "/statusz")[0] == 200
        assert default_tracer().capacity == 256
        ms.close()
    finally:
        default_chaos().disarm()
        default_tracer().configure(capacity=4096)


# -- config -------------------------------------------------------------------------

OBS_DICTS = [
    {},
    {"trace_enabled": False, "trace_buffer_spans": 16},
    {"statusz_enabled": False, "trace_sample_prob": 0.0,
     "trace_sample_keep": 1},
    {"trace_sample_prob": 1.0},
    {"trace_buffer_spans": 0},
    {"trace_sample_prob": 1.5},
    {"trace_sample_prob": -0.1},
    {"trace_sample_keep": 0},
    {"no_such_knob": 1},
]
CHAOS_DICTS = [
    {},
    {"enabled": True, "points": ["engine.step:once"], "seed": 3},
    {"points": ["trainer.device_step:after=3,once,attempt=0",
                "checkpoint.commit:p=0.5"]},
    {"points": ["typo.point"]},
    {"points": ["engine.step:p=2"]},
    {"points": ["engine.step", "engine.step:once"]},
    {"seed": -1},
    {"points": ["engine.step:attempt=0"]},
    {"frequency": 2},
]


def _verdict(build, raw):
    try:
        node = build(raw)
    except (ConfigError, ValueError, TypeError) as e:
        return ("refused", type(e).__name__ == "ConfigError")
    return ("accepted", {k: getattr(node, k) for k in raw})


@pytest.mark.parametrize("raw", OBS_DICTS)
def test_observability_config_accepts_and_refuses_as_the_jax_package(raw):
    from kubeflow_tpu.config.core import from_dict
    from kubeflow_tpu.config.platform import (
        ObservabilityConfig as JObservabilityConfig,
    )

    assert _verdict(ObservabilityConfig.from_dict, raw) == _verdict(
        lambda r: from_dict(JObservabilityConfig, r), raw)


@pytest.mark.parametrize("raw", CHAOS_DICTS)
def test_chaos_config_accepts_and_refuses_as_the_jax_package(raw):
    from kubeflow_tpu.config.core import from_dict
    from kubeflow_tpu.config.platform import ChaosConfig as JChaosConfig
    from kubeflow_tpu.config.platform import ServingConfig as JServingConfig

    assert _verdict(ChaosConfig.from_dict, raw) == _verdict(
        lambda r: from_dict(JChaosConfig, r), raw)
    # the serving config's chaos subtree: attempt= is refused there
    assert _verdict(lambda r: ServingConfig.from_dict({"chaos": r}).chaos,
                    raw) == _verdict(
        lambda r: from_dict(JServingConfig, {"chaos": r}).chaos, raw)


def test_the_fleet_fields_are_refused_naming_the_roadmap():
    """The name dates from when the port refused these fields. It checks
    that the fleet collector's fields load with the JAX checks, that the
    autoscaler and the router load, and that a split fleet is refused
    without its router, as in the JAX package."""
    cfg = ObservabilityConfig.from_dict({
        "slo_rules": ["serving_ttft_p99 < 5s"],
        "fleet_scrape_interval_s": 1.0, "fleet_straggler_zscore": 2.5,
        "fleet_burn_window": 4})
    assert (cfg.slo_rules, cfg.fleet_scrape_interval_s,
            cfg.fleet_straggler_zscore, cfg.fleet_burn_window) == (
        ["serving_ttft_p99 < 5s"], 1.0, 2.5, 4)
    for key in ("fleet_scrape_interval_s", "fleet_straggler_zscore",
                "fleet_burn_window"):
        with pytest.raises(ConfigError, match=key):
            ObservabilityConfig.from_dict({key: 0})
    with pytest.raises(ConfigError, match="without a quantile"):
        ObservabilityConfig.from_dict({"slo_rules": ["serving_ttft < 5s"]})
    # the serving config's autoscaler and router load; a split fleet
    # needs its router, as in the JAX package
    auto = ServingConfig.from_dict(
        {"autoscale": {"enabled": True, "max_replicas": 2}}).autoscale
    assert auto.enabled and auto.max_replicas == 2
    assert ServingConfig.from_dict(
        {"router": {"enabled": True}}).router.enabled
    with pytest.raises(ConfigError, match="needs serving.router.enabled"):
        ServingConfig.from_dict({"autoscale": {"enabled": True},
                                 "disagg": {"enabled": True}})
    split = ServingConfig.from_dict({"autoscale": {"enabled": True},
                                     "disagg": {"enabled": True},
                                     "router": {"enabled": True}})
    assert split.autoscale.enabled and split.disagg.enabled
    assert ServingConfig.from_dict({"num_slots": 4}).num_slots == 4
    with pytest.raises(ConfigError, match="attempt="):
        ServingConfig(chaos=ChaosConfig(points=["engine.step:attempt=0"]))


# -- greedy_generate ------------------------------------------------------------------


def test_greedy_generate_equals_the_jax_packages(tiny):
    from kubeflow_tpu.serving.generate import (
        greedy_generate as jgreedy_generate,
    )

    jmodel, params, tmodel = tiny
    prompts = np.asarray([[5, 9, 13, 2, 7, 1], [40, 3, 3, 8, 11, 60]],
                         np.int32)
    want = np.asarray(jgreedy_generate(jmodel, params,
                                       jnp.asarray(prompts), 7))
    got = greedy_generate(tmodel, prompts, 7).cpu().numpy()
    np.testing.assert_array_equal(got, want)
