"""The port's continuous-batching engine (kubeflow_tpu_torch/serving/
engine.py) on the CPU, with the session gpt_tiny weights bridged from
JAX and page_size 8.

Greedy engine tokens must equal JAX `generate()` exactly (f32 logits
agree to ~1e-6, far inside the greedy margins of these prompts) and the
port's own `generate()` through chunked prefill and prefix hits with
copy-on-write, on both read paths ("kernel" walks the page table
through the kernel's plain version on CPU tensors). At quantize="int8"
the tokens must equal the JAX int8 engine's, and the two read paths
must agree with each other."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.serving.generate import generate as jgenerate  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine,
    EngineCapacityError,
    PagePool,
    QueueFullError,
    RadixPrefixIndex,
)
from kubeflow_tpu_torch.serving.generate import generate  # noqa: E402

MAX_NEW = 8
IMPLS = ["kernel", "gather"]


@pytest.fixture(scope="module")
def tiny(gpt_and_params):
    jmodel, params = gpt_and_params
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(7)
    rows = {n: rng.integers(0, 512, n) for n in (4, 7, 40)}
    return jmodel, params, tmodel, rows


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    jmodel, params, _, rows = tiny
    run = jax.jit(functools.partial(jgenerate, jmodel), static_argnums=(2,))
    return {
        n: np.asarray(run(params, jnp.asarray(rows[n][None], jnp.int32),
                          MAX_NEW))[0, n:].tolist()
        for n in (4, 7)
    }


def _engine(tmodel, impl, **kw):
    return DecodeEngine("tiny", tmodel, device="cpu", num_slots=2,
                        page_size=8, paged_attention=impl, **kw)


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_engine_tokens_equal_jax_generate(tiny, jax_tokens, impl):
    _, _, tmodel, rows = tiny
    eng = _engine(tmodel, impl)
    try:
        futures = {n: eng.submit(rows[n], MAX_NEW) for n in (4, 7)}
        for n, fut in futures.items():
            assert fut.wait(60)["tokens"] == jax_tokens[n], n
        stats = eng.stats()
    finally:
        eng.close()
    assert stats["attention_kernel"] == impl
    assert stats["paged_attention_windows"] == {1: impl}
    # decode steps emit all but each row's first (admission) token
    assert stats["tokens"] == 2 * (MAX_NEW - 1)


@pytest.mark.parametrize("impl", IMPLS)
def test_chunked_prefill_and_prefix_cow_equal_generate(tiny, impl):
    """A 40-token prompt past the capped bucket set (8, 16) takes a head
    prefill plus chunk windows; sent again, it maps the committed pages
    and copies the partially matched boundary page."""
    _, _, tmodel, rows = tiny
    row = rows[40]
    want = generate(tmodel, row[None], MAX_NEW)[0, 40:].tolist()
    eng = _engine(tmodel, impl, prefill_buckets=(8, 16))
    try:
        assert eng.generate_row(row, MAX_NEW)["tokens"] == want
        first = eng.stats()
        assert eng.generate_row(row, MAX_NEW)["tokens"] == want
        second = eng.stats()
    finally:
        eng.close()
    assert first["paged_attention_windows"] == {1: impl, 64: impl}
    assert first["prefill_compute_tokens"] == 40
    assert second["cow_copies"] == 1
    # 5 committed pages of 8; the prompt's last token always recomputes
    assert second["prefix_hit_tokens"] == 39
    assert second["prefill_compute_tokens"] == 41


def test_engine_rejects_what_the_model_cannot_hold(tiny):
    tmodel = tiny[2]
    eng = _engine(tmodel, "kernel", autostart=False, max_queue=1)
    try:
        with pytest.raises(EngineCapacityError, match="max_len 128"):
            eng.submit(np.arange(100), 29)
        with pytest.raises(ValueError, match="prompt ids"):
            eng.submit([600], 1)
        eng.submit([1, 2, 3], 2)
        with pytest.raises(QueueFullError):
            eng.submit([1, 2, 3], 2)
    finally:
        eng.close()
    with pytest.raises(ValueError, match="paged_attention"):
        _engine(tmodel, "pallas")
    with pytest.raises(ValueError, match="page_size"):
        DecodeEngine("t", tmodel, device="cpu", page_size=6)


def test_radix_index_matches_commits_and_evicts():
    pool = PagePool(8)
    radix = RadixPrefixIndex(4, pool)
    pages = pool.alloc(3)
    tokens = list(range(12))
    radix.insert(tokens, pages)
    assert [pool.refcount(p) for p in pages] == [2, 2, 2]
    pool.release(pages)  # the slot retires; the tree keeps the pages
    assert pool.tree_evictable == 3
    chain, matched, partial = radix.match(tokens[:10])
    assert chain == pages[:2] and matched == 8 and partial == (pages[2], 2)
    assert radix.evict(2) == 2
    assert pool.free_count == 5 + 2
    assert radix.match(tokens)[1] == 4


# -- int8 serving (quantize="int8") ----------------------------------------------


@pytest.fixture(scope="module")
def jax_int8_tokens(tiny):
    """The JAX engine at quantize="int8" over the int8 gather read path:
    one slot, the 7-token prompt, MAX_NEW greedy tokens."""
    from kubeflow_tpu.serving.engine import DecodeEngine as JDecodeEngine

    jmodel, params, _, rows = tiny
    eng = JDecodeEngine("jq", jmodel, params, num_slots=1, max_queue=4,
                        quantize="int8", paged_attention="gather")
    try:
        assert eng.stats()["kv_pool_dtype"] == "int8"
        return eng.generate_row(rows[7], MAX_NEW, timeout=300)["tokens"]
    finally:
        eng.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_int8_engine_tokens_equal_the_jax_int8_engine(tiny, jax_int8_tokens,
                                                      impl):
    """int8 weights quantized once at construction, int8 KV pages: greedy
    tokens equal the JAX int8 engine's, on both read paths. The model
    handed in stays full width."""
    _, _, tmodel, rows = tiny
    eng = DecodeEngine("tiny", tmodel, device="cpu", num_slots=1,
                       paged_attention=impl, quantize="int8")
    try:
        assert eng.generate_row(rows[7], MAX_NEW)["tokens"] == jax_int8_tokens
        stats = eng.stats()
    finally:
        eng.close()
    assert (stats["quantize"], stats["kv_pool_dtype"]) == ("int8", "int8")
    assert eng.model.quantize == "int8" and tmodel.quantize == "none"
    assert stats["paged_attention_windows"] == {1: impl}


def test_int8_chunked_prefill_and_prefix_cow_gather_equals_kernel(tiny):
    """The 40-token prompt through head prefill, chunk windows, and then a
    prefix hit with copy-on-write of the int8 values and scales: the
    kernel read path gives the gather path's tokens."""
    _, _, tmodel, rows = tiny
    got = {}
    for impl in IMPLS:
        eng = _engine(tmodel, impl, prefill_buckets=(8, 16), quantize="int8")
        try:
            got[impl] = [eng.generate_row(rows[40], MAX_NEW)["tokens"]
                         for _ in range(2)]
            stats = eng.stats()
        finally:
            eng.close()
        assert got[impl][0] == got[impl][1]
        assert stats["cow_copies"] == 1 and stats["prefix_hit_tokens"] == 39
        assert stats["paged_attention_windows"] == {1: impl, 64: impl}
    assert got["kernel"] == got["gather"]


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["gpt_tiny", "gpt_small"])
def test_pool_sizing_agrees_with_jax(model, dtype, quantize):
    from kubeflow_tpu.models import get_model as jget_model
    from kubeflow_tpu.serving import engine as jengine

    from kubeflow_tpu_torch.serving import engine as tengine

    jcfg = jget_model(model, dtype=getattr(jnp, dtype)).cfg
    tcfg = get_model(model, dtype=getattr(torch, dtype), device="meta").cfg
    for num_pages, slots, ps in ((None, 8, 16), (0, 3, 8), (50, 2, 16)):
        assert tengine.resolve_num_pages(num_pages, slots, tcfg, ps,
                                         quantize) == \
            jengine.resolve_num_pages(num_pages, slots, jcfg, ps, quantize)
    for d, itemsize in ((64, 2), (16, 4), (128, 2)):
        assert tengine.int8_page_capacity_ratio(d, itemsize) == \
            jengine.int8_page_capacity_ratio(d, itemsize)


def test_int8_pool_holds_more_pages_in_no_more_bytes(tiny):
    from kubeflow_tpu_torch.serving.engine import resolve_num_pages

    tmodel = tiny[2]
    stats = {}
    for q in ("none", "int8"):
        eng = DecodeEngine("t", tmodel, device="cpu", num_slots=4,
                           autostart=False, quantize=q)
        stats[q] = eng.stats()
        eng.close()
    assert stats["int8"]["pages_total"] > stats["none"]["pages_total"]
    assert stats["int8"]["kv_pool_bytes"] <= stats["none"]["kv_pool_bytes"]
    # telemetry sizes the auto pool now (serving/kv_tiers.py): no signal
    # in it means full pressure, the static 3/4
    assert resolve_num_pages(0, 4, tmodel.cfg, 16, telemetry={"x": 1}) == \
        resolve_num_pages(0, 4, tmodel.cfg, 16)
    with pytest.raises(ValueError, match="A13"):
        resolve_num_pages(0, 4, tmodel.cfg, 16, mesh_tensor=2)
    with pytest.raises(ValueError, match="quantize"):
        _engine(tmodel, "kernel", quantize="int4")


# -- draining shutdown -----------------------------------------------------------


def _drain_rows():
    return [(np.arange(n) * (3 + 2 * i) + i + 1) % 512
            for i, n in enumerate((4, 5, 6))]


@pytest.mark.parametrize("k", [0, 3], ids=["k0", "drafted"])
def test_drain_completes_in_flight_and_queued_and_rejects_new(tiny, k):
    """Three requests through two slots (one still queued when drain
    starts): new submits get EngineDrainingError at once, every accepted
    request completes with generate()'s tokens, drafted ones too, and the
    drain's duration lands in serving_drain_seconds."""
    import threading
    import time

    from kubeflow_tpu_torch.serving.engine import EngineDrainingError
    from kubeflow_tpu_torch.utils.metrics import default_registry

    tmodel = tiny[2]
    name = f"dr-{k}"
    eng = DecodeEngine(name, tmodel, device="cpu", num_slots=2, page_size=8,
                       paged_attention="kernel", max_queue=8,
                       draft_model=tmodel, num_draft_tokens=k)
    rows, n_new = _drain_rows(), [8, 9, 7]
    futures = [eng.submit(r, n) for r, n in zip(rows, n_new)]
    drained = []
    t = threading.Thread(target=lambda: drained.append(eng.drain(60)))
    t.start()
    try:
        deadline = time.monotonic() + 10
        while not eng.draining:
            assert time.monotonic() < deadline
        with pytest.raises(EngineDrainingError) as err:
            eng.submit(rows[0], 2)
        assert err.value.retry_after_s >= 1.0
    finally:
        t.join(timeout=120)
    assert drained == [True]
    for r, n, f in zip(rows, n_new, futures):
        want = generate(tmodel, r[None], n)[0, len(r):].tolist()
        assert f.wait(5)["tokens"] == want
    assert (f'serving_drain_seconds_count{{model="{name}"}} 1'
            in default_registry().render())
    if k:
        assert eng.stats()["verify_steps"] > 0


def test_drained_closed_engine_still_answers_draining(tiny):
    """drain() ends in close(); a drained engine keeps refusing with
    EngineDrainingError (429 + Retry-After), not a bare error."""
    from kubeflow_tpu_torch.serving.engine import EngineDrainingError

    eng = DecodeEngine("drc", tiny[2], device="cpu", num_slots=1)
    assert eng.drain(deadline_s=5) is True  # idle: drains, then closes
    assert eng.draining
    with pytest.raises(EngineDrainingError):
        eng.submit([1, 2, 3], 2)


def test_drain_deadline_fails_stragglers_fast(tiny):
    """deadline 0: the drain cannot wait, so close() fails the resident
    request at once (failed fast, never hung)."""
    eng = DecodeEngine("dr0", tiny[2], device="cpu", num_slots=1)
    fut = eng.submit(np.arange(4), 100)
    assert eng.drain(deadline_s=0.0) is False
    with pytest.raises(RuntimeError, match="closed|failed"):
        fut.wait(10)
