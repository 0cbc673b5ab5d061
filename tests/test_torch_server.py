"""The port's REST serving path on the CPU: `build_server(...,
device="cpu")` behind the port's own wsgi Server on a real socket.
`:generate` output must equal the port's `generate()` exactly (same
weights, greedy), through the engine (read path "kernel") and the static
path. Weights are the port's own seeded gpt_tiny init. Model discovery
and /healthz are held against the reference server's bodies (the one
test here that builds it, with JAX on the CPU)."""

import importlib.util
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.api.wsgi import Server  # noqa: E402
from kubeflow_tpu_torch.serving.generate import generate  # noqa: E402
from kubeflow_tpu_torch.serving.main import (  # noqa: E402
    build_server,
    engine_knobs_from_env,
)


def _post(port, body, name="gpt_tiny"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read()


@pytest.fixture(params=[2, 0], ids=["engine", "static"])
def served(request):
    ms = build_server(
        "gpt_tiny", device="cpu", dtype=torch.float32,
        num_slots=request.param, page_size=8,
        paged_attention="kernel" if request.param else "gather",
    )
    httpd = Server(ms.app, port=0)
    httpd.start()
    yield ms, httpd.port, request.param
    httpd.stop()
    ms.close()


def test_generate_over_rest_equals_generate(served):
    ms, port, num_slots = served
    model = ms.lm("gpt_tiny").model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 9).tolist(), rng.integers(0, 512, 9).tolist()]
    status, body, headers = _post(port, {"prompt_ids": prompts,
                                         "max_new_tokens": 6})
    assert status == 200, body
    want = generate(model, prompts, 6).tolist()
    assert body["sequences"] == want
    if num_slots:
        assert "X-TTFT-Ms" in headers
        stats = ms.engine("gpt_tiny").stats()
        assert stats["attention_kernel"] == "kernel"
        assert stats["admitted"] == 2


def test_overlong_request_is_a_400_naming_max_len(served):
    _, port, _ = served
    status, body, _ = _post(port, {"prompt_ids": [[1] * 120],
                                   "max_new_tokens": 9})
    assert status == 400
    assert "max_len 128" in body["log"]
    status, body, _ = _post(port, {"max_new_tokens": 2})
    assert status == 400
    status, _, _ = _post(port, {"prompt_ids": [[1]]}, name="nope")
    assert status == 404


def test_healthz_and_metrics_answer(served):
    _, port, num_slots = served
    _post(port, {"prompt_ids": [[3, 4, 5]], "max_new_tokens": 2})
    status, body = _get(port, "/healthz")
    assert status == 200
    assert json.loads(body) == {"ok": True, "draining": False,
                                "models": ["gpt_tiny"]}
    status, body = _get(port, "/metrics")
    assert status == 200
    assert b"http_requests_total" in body
    if num_slots:
        assert b'serving_paged_attention_calls_total{model="gpt_tiny",' \
               b'variant="kernel"}' in body


@pytest.mark.parametrize("num_slots", [2, 0], ids=["engine", "static"])
def test_discovery_and_healthz_bodies_equal_the_reference_servers(
        gpt_and_params, monkeypatch, num_slots):
    """`GET /v1/models`, `/v1/models/gpt_tiny` and `/healthz` answer the
    reference server's bodies (the kft-router forwards the first two to
    every replica), and `/v1/models/nope` its 404, on gpt_tiny built with
    the same knobs, engine on and off."""
    from kubeflow_tpu.serving.main import build_server as jbuild_server

    for knob in ("NUM_SLOTS", "PAGE_SIZE", "PAGED_ATTENTION", "QUANTIZE"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    knobs = dict(num_slots=num_slots, page_size=8, paged_attention="gather")
    _, params = gpt_and_params
    ref = jbuild_server("gpt_tiny", params=params, batch_window_ms=0, **knobs)
    port = build_server("gpt_tiny", device="cpu", dtype=torch.float32, **knobs)
    try:
        for path in ("/v1/models", "/v1/models/gpt_tiny", "/healthz"):
            want = ref.app.handle_full("GET", path)[:2]
            got = port.app.handle_full("GET", path)[:2]
            assert want[0] == 200 and got == want, path
        assert port.app.handle_full("GET", "/v1/models/nope")[0] == \
            ref.app.handle_full("GET", "/v1/models/nope")[0] == 404
    finally:
        ref.close()
        port.close()
    entry = {"name": "gpt_tiny", "version": "1", "generative": True,
             "continuous_batching": bool(num_slots)}
    assert got == (200, {"ok": True, "draining": False,
                         "models": ["gpt_tiny"]})
    assert port.app.handle_full("GET", "/v1/models")[:2] == (
        200, {"models": [entry]})


def test_engine_knobs_from_env(monkeypatch):
    monkeypatch.setenv("KFT_SERVING_NUM_SLOTS", "3")
    monkeypatch.setenv("KFT_SERVING_PREFILL_BUCKETS", "8, 32")
    monkeypatch.setenv("KFT_SERVING_PAGE_SIZE", "8")
    monkeypatch.setenv("KFT_SERVING_PREFIX_CACHE", "0")
    monkeypatch.setenv("KFT_SERVING_PAGED_ATTENTION", "kernel")
    knobs = engine_knobs_from_env()
    assert knobs == {
        "num_slots": 3, "max_queue": 64, "prefill_buckets": [8, 32],
        "page_size": 8, "num_pages": 0, "prefix_cache": False,
        "paged_attention": "kernel", "quantize": "none",
        "draft_model": "", "num_draft_tokens": 0, "draft_checkpoint_dir": "",
        "kv_host_bytes": 0, "kv_persist_dir": "", "kv_persist_interval_s": 0.0,
        "kv_persist_chains": 64,
        "mesh_tensor": 1, "mesh_fsdp": 1, "mesh_expert": 1,
        "drain_deadline_s": 30.0,
    }
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32)
    try:
        eng = ms.engine("gpt_tiny")
        assert (eng.num_slots, eng.prefill_buckets, eng.page_size) == (
            3, (8, 32), 8
        )
        assert eng.stats()["attention_kernel"] == "kernel"
    finally:
        ms.close()


@pytest.mark.parametrize("knobs", [{"paged_attention": "pallas"},
                                   {"paged_attention": "kernel",
                                    "num_slots": 0}])
def test_bad_read_path_knobs_raise(knobs):
    with pytest.raises(ValueError, match="paged_attention"):
        build_server("gpt_tiny", device="cpu", **knobs)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_bound_counts_only_what_a_call_needs():
    """A parked slot adds only its output row to a call's bytes and no
    operations; a live one its visible K/V, q, output, table entries."""
    smoke = _chip_smoke()
    hd = smoke.H * smoke.D
    live, live_ops = smoke.work_bounds((15,), 2, 1)
    assert live == (2 * 16 + 2) * hd * 2 + 4 * (1 + 1)
    assert live_ops == 4 * 16 * hd
    both, both_ops = smoke.work_bounds((15, smoke.MP * smoke.PS), 2, 1)
    assert both - live == hd * 2 + 4
    assert both_ops == live_ops
    # the window calls phase 3 times are the main path's: the long
    # prompt's, the first 300-token prompt's, then the prefix hit's
    assert smoke.MAIN_WINDOWS == (256, 320, 384, 448, 512, 576, 640, 256, 299)


def test_chip_smoke_serve_phases_rehearse_on_cpu():
    """chip_smoke.py's serve phases, driven on the CPU at gpt_tiny size:
    f32 REST tokens equal generate(); the bf16 run answers every request
    (incl. a chunked prefill and a repeated prompt that hits the prefix
    cache with a copy-on-write) within the logit-gap bound."""
    smoke = _chip_smoke()
    f32_model = smoke.phase_serve_f32(torch, model="gpt_tiny", device="cpu",
                                      prompts=(5, 9), max_new=8)
    launches, stats, steps = smoke.phase_serve_bf16(
        torch, f32_model, model="gpt_tiny", device="cpu",
        short=(3, 5, 9, 17, 30), long_len=90, hit_len=40, max_new=16,
        buckets="8,16,32",
    )
    # CPU tensors take the plain version: no kernel launches here
    assert not any(launches.values())
    assert 0 < steps < stats["decode_steps"]  # the warm-up's are excluded
    assert stats["cow_copies"] == 1
    assert stats["paged_attention_windows"] == {1: "kernel", 64: "kernel"}


def test_quantize_knob_reaches_the_engine(monkeypatch):
    """KFT_SERVING_QUANTIZE=int8 with the engine on: the engine serves
    int8 weights over int8 pages; the ServedLm stays full width."""
    monkeypatch.setenv("KFT_SERVING_QUANTIZE", "int8")
    assert engine_knobs_from_env()["quantize"] == "int8"
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      num_slots=2, page_size=8, paged_attention="kernel")
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        eng = ms.engine("gpt_tiny")
        row = ((np.arange(9) * 3 + 1) % 512).tolist()
        status, body, _ = _post(httpd.port, {"prompt_ids": [row],
                                             "max_new_tokens": 6})
        stats = eng.stats()
    finally:
        httpd.stop()
        ms.close()
    assert status == 200, body
    assert (stats["quantize"], stats["kv_pool_dtype"]) == ("int8", "int8")
    assert eng.model.quantize == "int8"
    assert ms.lm("gpt_tiny").model.quantize == "none"
    assert len(body["sequences"][0]) == 15
    assert stats["admitted"] == 1
    assert stats["paged_attention_windows"] == {1: "kernel"}


def test_static_path_serves_int8(monkeypatch):
    """num_slots=0 + quantize=int8: the ServedLm's resident weights are
    int8, and its tokens equal `generate()` over the dequantized weights
    (the int8 oracle)."""
    from kubeflow_tpu_torch.checkpointing.quantize import (
        dequantize_params,
        quantize_params_int8,
    )
    from kubeflow_tpu_torch.models import get_model

    monkeypatch.delenv("KFT_SERVING_QUANTIZE", raising=False)
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      num_slots=0, quantize="int8")
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        lm = ms.lm("gpt_tiny")
        row = ((np.arange(9) * 3 + 1) % 512).tolist()
        status, body, _ = _post(httpd.port, {"prompt_ids": [row],
                                             "max_new_tokens": 6})
    finally:
        httpd.stop()
        ms.close()
    assert status == 200, body
    assert lm.quantize == "int8" and lm.model.quantize == "int8"
    assert {t.dtype for n, t in lm.model.state_dict().items()
            if n.endswith("kernel")} == {torch.int8}
    full = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    deq = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    deq.load_state_dict(dequantize_params(
        quantize_params_int8(full.state_dict()), torch.float32))
    assert body["sequences"][0][-6:] == generate(deq, [row], 6)[0, 9:].tolist()


@pytest.mark.parametrize("where", ["arg", "env", "served_lm", "engine"])
def test_bad_quantize_values_raise(monkeypatch, where):
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import ServedLm

    with pytest.raises(ValueError, match="quantize"):
        if where == "arg":
            build_server("gpt_tiny", device="cpu", quantize="int4")
        elif where == "env":
            monkeypatch.setenv("KFT_SERVING_QUANTIZE", "fp8")
            build_server("gpt_tiny", device="cpu")
        elif where == "served_lm":
            ServedLm("t", get_model("gpt_tiny", device="cpu"), quantize="int4")
        else:
            DecodeEngine("t", get_model("gpt_tiny", device="cpu"),
                         device="cpu", autostart=False, quantize="fp8")


def test_chip_smoke_int8_serve_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 10 on the CPU at gpt_tiny size: int8 f32
    tokens through the kernel read path equal gather's; the int8 bf16
    run answers phase 5's traffic within the logit-gap bound with the
    capacity ratio's pages in no more bytes; the accuracy gate holds."""
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.models import get_model

    smoke = _chip_smoke()
    eng = DecodeEngine("gpt_tiny", get_model("gpt_tiny", device="cpu",
                                             dtype=torch.bfloat16),
                       device="cpu", num_slots=8, page_size=16,
                       autostart=False)
    bf16_stats = eng.stats()
    eng.close()
    launches, stats, steps = smoke.phase_serve_int8(
        torch, bf16_stats, model="gpt_tiny", device="cpu", f32_prompts=(5, 9),
        f32_max_new=8, accuracy_shape=(2, 32), short=(3, 5, 9, 17, 30),
        long_len=90, hit_len=40, max_new=16, buckets="8,16,32",
    )
    assert not any(launches.values())
    assert 0 < steps < stats["decode_steps"]
    assert stats["kv_pool_dtype"] == "int8" and stats["cow_copies"] == 1
    assert stats["paged_attention_windows"] == {1: "kernel", 64: "kernel"}


# -- draining shutdown -----------------------------------------------------------


def _tiny_model():
    from kubeflow_tpu_torch.models import get_model

    return get_model("gpt_tiny", dtype=torch.float32, device="cpu")


def test_rest_429_with_retry_after_and_healthz_503_while_draining():
    """While an engine drains, :generate answers 429 with Retry-After and
    /healthz 503 with "draining": true; the resident request completes."""
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      num_slots=1, page_size=8, paged_attention="kernel")
    eng = ms.engine("gpt_tiny")
    prompt = (np.arange(5) % 512).tolist()
    resident = eng.submit(prompt, 40)
    # flip the admission gate as drain() does (deterministic 429 window)
    with eng._cv:
        eng._draining = True
    try:
        status, body, headers = ms.app.handle_full(
            "POST", "/v1/models/gpt_tiny:generate",
            body={"prompt_ids": [prompt], "max_new_tokens": 4},
        )
        assert status == 429 and "draining" in body["log"]
        assert int(dict(headers)["Retry-After"]) >= 1
        status, body, _ = ms.app.handle_full("GET", "/healthz")
        assert (status, body) == (503, {"ok": True, "draining": True,
                                        "models": ["gpt_tiny"]})
    finally:
        assert ms.close(drain=True, drain_deadline_s=60) is True
    assert len(resident.wait(5)["tokens"]) == 40


@pytest.mark.parametrize("n_engines", [1, 2])
def test_close_drain_finishes_every_engine(n_engines):
    """close(drain=True): idle engines drain at once; with requests
    resident on several engines, all drain concurrently and every
    accepted request completes. /healthz answers 503 from the start."""
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.server import ModelServer

    model = _tiny_model()
    server = ModelServer()
    engines = [DecodeEngine(f"e{i}", model, device="cpu", num_slots=1,
                            page_size=8) for i in range(n_engines)]
    for eng in engines:
        server.add_engine(eng)
    assert server.close(drain=True, drain_deadline_s=5.0) is True  # idle
    assert server.app.handle_full("GET", "/healthz")[0] == 503
    server = ModelServer()
    engines = [DecodeEngine(f"f{i}", model, device="cpu", num_slots=1,
                            page_size=8) for i in range(n_engines)]
    for eng in engines:
        server.add_engine(eng)
    futures = [eng.submit(np.arange(4) % 512, 10) for eng in engines]
    assert server.close(drain=True, drain_deadline_s=120.0) is True
    for f in futures:
        assert len(f.wait(5)["tokens"]) == 10


def test_drain_exception_still_closes_engine():
    """An engine whose drain() raises is still closed by the server: the
    result is False and the resident request fails fast."""
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer()
    eng = DecodeEngine("boom", _tiny_model(), device="cpu", num_slots=1,
                       page_size=8)
    server.add_engine(eng)
    fut = eng.submit(np.arange(4) % 512, 100)

    def broken_drain(deadline_s):
        raise RuntimeError("drain bug")

    eng.drain = broken_drain
    assert server.close(drain=True, drain_deadline_s=60) is False
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        fut.wait(10)
