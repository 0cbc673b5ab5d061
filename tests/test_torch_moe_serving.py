"""MoE serving in the port (serving/engine.py on an MoE target,
serving/server.py's `moe:` line, utils/metrics.py's serving_moe_*
series, `generate()` and `build_server` of an MoE preset) against the
JAX package on the CPU, with the session gpt_tiny_moe (4 experts, top-1,
capacity factor 1.25: tests/conftest.py `gpt_moe_and_params`) bridged
into the port.

The oracle is the JAX expert-parallel-degree-1 ENGINE at the same
geometry (prefill buckets, page size, chunking, prefix hits), not
`generate()`: capacity routing sees the engine's padded prefill buckets
(pad positions route), so MoE engine tokens depend on that geometry
(tests/test_moe_serving.py). Greedy tokens must be equal in f32 (the
logits agree to ~1e-6, far inside these prompts' greedy margins and
router margins) and, at quantize="int8", equal to the JAX int8
engine's. `stats()["moe"]` (routed positions an expert, drops) must be
the JAX engine's exactly: the routing is the same. `generate()` is held
to the JAX `generate()`, whose geometry it shares (no buckets)."""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.serving.engine import DecodeEngine as JDecodeEngine  # noqa: E402
from kubeflow_tpu.serving.generate import generate as jgenerate  # noqa: E402
from kubeflow_tpu.serving.server import ModelServer as JModelServer  # noqa: E402
from kubeflow_tpu_torch.api.wsgi import Server  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine, _fetch  # noqa: E402
from kubeflow_tpu_torch.serving.generate import generate  # noqa: E402
from kubeflow_tpu_torch.serving.main import build_server  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.utils import metrics  # noqa: E402

NEW = 6
NUM_PAGES = 48


def _rows(*lens):
    return [(np.arange(n) * (3 + 2 * i) + i + 1).astype(np.int32) % 512
            for i, n in enumerate(lens)]


BASE = _rows(20)[0]
DIV = BASE.copy()
DIV[18:] = (DIV[18:] + 101) % 512

# variant → (engine knobs, the rows it serves in order; a tuple of rows
# is submitted at once)
VARIANTS = {
    "page8": (dict(num_slots=2), [tuple(_rows(4, 7))]),
    "page16": (dict(num_slots=2, page_size=16), [tuple(_rows(4, 7))]),
    # a prefix hit, a mid-page copy-on-write divergence, the donor again
    "prefix_cow": (dict(num_slots=1), [BASE, BASE, DIV, BASE]),
    # past the largest bucket: a head prefill, then chunk windows
    "chunked": (dict(num_slots=1, prefill_buckets=[32], prefix_cache=False),
                [_rows(70)[0]]),
    # K = 3 drafted by an MoE draft (the target's own weights)
    "spec": (dict(num_slots=1, prefix_cache=False, num_draft_tokens=3),
             [_rows(7)[0]]),
    "int8": (dict(num_slots=1, quantize="int8"), [_rows(9)[0]]),
}


def _serve(engine, plan):
    """Every row of `plan` through `engine` → (token lists, stats)."""
    out = []
    try:
        for step in plan:
            rows = step if isinstance(step, tuple) else (step,)
            futures = [engine.submit(r, NEW) for r in rows]
            out += [f.wait(180)["tokens"] for f in futures]
        return out, engine.stats()
    finally:
        engine.close()


@pytest.fixture(scope="module")
def jax_refs(gpt_moe_and_params):
    """The JAX ep=1 MoE engine's tokens and stats for every variant."""
    model, params = gpt_moe_and_params
    refs = {}
    for name, (knobs, plan) in VARIANTS.items():
        kw = dict(knobs)
        if kw.get("num_draft_tokens"):
            kw.update(draft_model=model, draft_params=params)
        engine = JDecodeEngine(f"jmoe-{name}", model, params, max_queue=8,
                               page_size=kw.pop("page_size", 8),
                               num_pages=NUM_PAGES, **kw)
        refs[name] = _serve(engine, plan)
    return refs


@pytest.fixture(scope="module")
def port_model(gpt_moe_and_params):
    _, params = gpt_moe_and_params
    m = get_model("gpt_tiny_moe", dtype=torch.float32, device="cpu")
    load_jax_params(m, jax.tree.map(np.asarray, params))
    return m


def _port_engine(m, name, impl, **knobs):
    kw = dict(knobs)
    if kw.get("num_draft_tokens"):
        kw["draft_model"] = m
    return DecodeEngine(name, m, device="cpu", max_queue=8,
                        page_size=kw.pop("page_size", 8),
                        num_pages=NUM_PAGES, paged_attention=impl, **kw)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_engine_tokens_and_router_stats_equal_the_jax_engine(
        jax_refs, port_model, variant, impl):
    knobs, plan = VARIANTS[variant]
    want_tokens, want_stats = jax_refs[variant]
    got_tokens, stats = _serve(
        _port_engine(port_model, f"moe-{variant}-{impl}", impl, **knobs),
        plan)
    assert got_tokens == want_tokens
    assert stats["moe"] == want_stats["moe"]
    assert stats["moe"]["routed_positions"] > 0
    if variant == "prefix_cow":
        assert stats["cow_copies"] >= 1 and stats["prefix_hit_tokens"] > 0
    if variant == "chunked":
        assert 64 in stats["paged_attention_windows"]
    if variant == "spec":
        assert stats["verify_steps"] > 0 and stats["pages_in_use"] == 0


def test_moe_series_and_imbalance_follow_the_stats(port_model, monkeypatch):
    """The serving_moe_* series carry the engine's counts; a dense
    engine carries no MoE state and emits no MoE series."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_default_registry", reg)
    knobs, plan = VARIANTS["chunked"]
    _, stats = _serve(_port_engine(port_model, "moe-series", "kernel",
                                   **knobs), plan)
    moe = stats["moe"]
    routed = sum(reg.get("serving_moe_expert_tokens_total").value(
        model="moe-series", expert=str(e)) for e in range(4))
    assert routed == moe["routed_positions"]
    assert (reg.get("serving_moe_capacity_overflow_total").value(
        model="moe-series") == moe["dropped"] > 0)
    assert (reg.get("serving_moe_load_imbalance").value(model="moe-series")
            == moe["load_imbalance"] >= 1.0)
    dense = DecodeEngine("dense-series", get_model(
        "gpt_tiny", dtype=torch.float32, device="cpu"), device="cpu",
        num_slots=1, num_pages=NUM_PAGES, page_size=8, autostart=False)
    try:
        assert dense.stats()["moe"] is None
        assert dense.debug_state()["mesh"]["expert"] == 1
    finally:
        dense.close()
    assert [ln for ln in reg.render().splitlines()
            if ln.startswith("serving_moe") and "dense-series" in ln] == []


def test_the_statusz_moe_line_is_the_jax_servers(gpt_moe_and_params,
                                                 gpt_and_params,
                                                 port_model):
    """An MoE engine's block gains the reference's `moe:` line (routed,
    dropped, imbalance, occupancy an expert); a dense engine's has none.
    Both servers render it from the same zeroed snapshot."""
    jmodel, jparams = gpt_moe_and_params
    lines = {}
    for side in ("jax", "port"):
        if side == "jax":
            server = JModelServer()
            server.add_engine(JDecodeEngine("moesz", jmodel, jparams,
                                            num_slots=1, autostart=False))
            server.add_engine(JDecodeEngine("densesz", gpt_and_params[0],
                                            gpt_and_params[1], num_slots=1,
                                            autostart=False))
        else:
            server = ModelServer()
            server.add_engine(_port_engine(port_model, "moesz", "kernel",
                                           num_slots=1, autostart=False))
            server.add_engine(DecodeEngine(
                "densesz", get_model("gpt_tiny", dtype=torch.float32,
                                     device="cpu"),
                device="cpu", num_slots=1, num_pages=NUM_PAGES,
                page_size=8, autostart=False))
        try:
            status, resp, _ = server.app.handle_full("GET", "/statusz")
        finally:
            server.close()
        assert status == 200
        text = resp.body.decode()
        engines = text.split("[engines]", 1)[1]
        moe_block, dense_block = engines.split("  densesz:", 1)
        assert "moe:" not in dense_block
        lines[side] = [ln for ln in moe_block.splitlines() if "moe:" in ln]
    assert lines["port"] == lines["jax"]
    assert lines["port"] == [
        "    moe: routed=0 dropped=0 imbalance=0.000 [e0=0 e1=0 e2=0 e3=0]"]


def test_generate_equals_the_jax_generate(gpt_moe_and_params, port_model):
    """`generate()` (one prefill over the prompt batch, then one-token
    steps) routes as the JAX `generate()` does: greedy tokens equal."""
    jmodel, params = gpt_moe_and_params
    rows = np.stack(_rows(12, 12, 12))
    want = np.asarray(jgenerate(jmodel, params, jnp.asarray(rows), NEW))
    got = generate(port_model, rows, NEW).numpy()
    np.testing.assert_array_equal(got, want)


def test_build_server_serves_the_moe_preset_over_rest(port_model):
    """`build_server("gpt_tiny_moe")` (the JAX weights as a state dict)
    serves `:generate` through its engine with the engine's tokens, and
    its /statusz shows the `moe:` line."""
    ms = build_server("gpt_tiny_moe", device="cpu", dtype=torch.float32,
                      params=port_model.state_dict(), num_slots=1,
                      page_size=8, num_pages=NUM_PAGES,
                      paged_attention="kernel")
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        row = _rows(9)[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}/v1/models/gpt_tiny_moe:generate",
            data=json.dumps({"prompt_ids": [row.tolist()],
                             "max_new_tokens": NEW}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.port}/statusz", timeout=60) as resp:
            statusz = resp.read().decode()
    finally:
        httpd.stop()
        ms.close()
    want, _ = _serve(_port_engine(port_model, "moe-rest", "kernel",
                                  num_slots=1), [row])
    assert body["sequences"][0][len(row):] == want[0]
    assert "    moe: routed=" in statusz


def test_fetch_reads_every_part_in_one_copy():
    parts = [torch.tensor(7), torch.arange(4, dtype=torch.int64),
             torch.tensor([1.5, 2.5]), torch.tensor(3.0)]
    host = _fetch(parts)
    assert [h.shape for h in host] == [(), (4,), (2,), ()]
    assert int(host[0]) == 7 and host[1].tolist() == [0, 1, 2, 3]
    assert host[2].tolist() == [1.5, 2.5] and float(host[3]) == 3.0


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_phase_18_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 18 on the CPU at gpt_tiny_moe and
    bert_tiny_moe size (CPU tensors take the kernels' plain versions:
    nothing launches): 18a's kernel tokens equal gather's; 18b's traffic
    (a head prefill and chunk windows, a prefix hit), its solo replays
    with the same tokens, the f32 replay with the engine's routes within
    DELTA, no decode drop and the routed-positions formula; 18c's int8
    serve and accuracy gate; 18d's flash against dense; 18e's and 18f's
    runs with finite losses."""
    for knob in ("NUM_SLOTS", "QUANTIZE", "DRAFT_MODEL", "DRAFT_TOKENS"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    monkeypatch.setattr(metrics, "_default_registry", metrics.MetricsRegistry())
    smoke = _chip_smoke()
    f32 = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32, seed=0)
    small = dict(model="gpt_tiny_moe", device="cpu", buckets="8,16,32")
    assert smoke.phase_moe_serve_f32(torch, f32, prompts=(5, 40), max_new=6,
                                     **small) == {
        "paged_decode": 0, "paged_window": 0, "paged_decode_int8": 0,
        "paged_window_int8": 0}
    dense = {"load_decode_step_ms": 1.0, "load_tokens_per_s": 1.0}
    _, summary = smoke.phase_moe_serve_bf16(
        torch, f32, dense, short=(3, 5, 9), long_len=90, hit_len=41,
        max_new=8, **small)
    assert summary["decode_step_ms"] > 0
    smoke.phase_moe_serve_int8(torch, f32, prompts=(5, 40), max_new=6,
                               accuracy_shape=(2, 32), **small)
    auxes = smoke.phase_train_f32(torch, model="gpt_tiny_moe", seq=32,
                                  device="cpu",
                                  leaves=smoke.MOE_TRAIN_LEAVES)
    assert all(np.isfinite(a["moe_aux_loss"]) for a in auxes.values())
    smoke.phase_moe_train_bf16(torch, overrides=dict(
        model="gpt_tiny_moe", seq_len=64, global_batch_size=4,
        loss_chunk=32, steps=3), device="cpu")
    smoke.phase_bert_train(torch, overrides=dict(
        smoke.MOE_BERT_CFG, model="bert_tiny_moe", seq_len=32,
        global_batch_size=4), device="cpu", tag="moe 18f")
