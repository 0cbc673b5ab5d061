"""The port's GPT (kubeflow_tpu_torch/models/gpt.py) against the JAX
model on the same weights: the session gpt_tiny (f32, PRNGKey(0))
bridged through `params_from_jax`, inputs seeded with numpy.

Tolerances: logits atol = rtol = 1e-4 (f32 summation order through two
blocks and the vocab head); written K/V pool rows atol = rtol = 1e-5."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.gpt import (  # noqa: E402
    PagedState as JPagedState,
    stack_layer_params,
)
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    load_jax_params,
    params_from_jax,
)
from kubeflow_tpu_torch.models.gpt import KVPool, PagedState  # noqa: E402

ATOL = RTOL = 1e-4
POOL_ATOL = POOL_RTOL = 1e-5


@pytest.fixture(scope="module")
def pair(gpt_and_params):
    jmodel, params = gpt_and_params
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _japply(jmodel, **static):
    """jitted JAX apply (one compile instead of one per eager op)."""
    return jax.jit(functools.partial(jmodel.apply, **static))


def _ids(rng, b, s, vocab=512):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def test_params_from_jax_reads_both_layouts(gpt_and_params):
    jmodel, params = gpt_and_params
    named = params_from_jax(jax.tree.map(np.asarray, params))
    stacked = params_from_jax(jax.tree.map(
        np.asarray, stack_layer_params(params, jmodel.cfg.num_layers)
    ))
    assert named.keys() == stacked.keys()
    for k in named:
        torch.testing.assert_close(named[k], stacked[k], atol=0, rtol=0)
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    assert set(named) == set(tmodel.state_dict())
    assert named["layers.1.attention.query.kernel"].shape == (64, 4, 16)
    assert named["layers.0.attention.out.kernel"].shape == (4, 16, 64)


def test_full_forward_logits_match_jax(pair):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(0)
    ids = _ids(rng, 2, 12)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    want = np.asarray(_japply(jmodel)(
        {"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)
    )["logits"])
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_prefill_and_slot_cache_decode_match_jax(pair):
    """A ragged prefill, then three single-token decode steps over the
    slot-row cache (the path `generate()` runs)."""
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(1)
    ids = _ids(rng, 2, 10)
    mask = np.ones((2, 10), bool)
    mask[0, 7:] = False
    out, mutated = _japply(jmodel, prefill=True, mutable=["cache"])(
        {"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
    )
    cache = mutated["cache"]
    with torch.inference_mode():
        logits, tcache = tmodel.prefill(
            torch.from_numpy(ids).long(), torch.from_numpy(mask)
        )
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(out["logits"]), atol=ATOL, rtol=RTOL
        )
        decode = _japply(jmodel, decode=True, mutable=["cache"])
        for step in range(3):
            tok = _ids(rng, 2, 1)
            out, mutated = decode(
                {"params": params, "cache": cache}, jnp.asarray(tok)
            )
            cache = mutated["cache"]
            got = tmodel.decode(torch.from_numpy(tok).long(), tcache)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(out["logits"]), atol=ATOL, rtol=RTOL,
                err_msg=f"decode step {step}",
            )
    assert tcache.index == 13


def _pools(rng, cfg, num_pages, ps):
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, num_pages, ps, h, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


WINDOWS = {
    # one paged decode step over three slots, one parked at max_len
    "decode_step": (np.array([5, 17, 128], np.int32), 1),
    # a 16-token chunk-prefill window
    "chunk16": (np.array([20], np.int32), 16),
}


@pytest.fixture(scope="module")
def paged_case(pair):
    """Per window: the seeded inputs and the JAX paged branch's logits and
    written pools, computed once for both of the port's read paths."""
    jmodel, params, _ = pair
    cfg = jmodel.cfg
    ps, num_pages = 8, 40
    mp = cfg.max_len // ps
    memo = {}

    def get(window):
        if window in memo:
            return memo[window]
        rng = np.random.default_rng(2)
        k_np, v_np = _pools(rng, cfg, num_pages, ps)
        cursors, s = WINDOWS[window]
        b = cursors.size
        table = np.stack(
            [rng.permutation(num_pages)[:mp] for _ in range(b)]
        ).astype(np.int32)
        ids = _ids(rng, b, s)
        jcache = {
            f"layer_{i}": {"attention": {
                "cached_key": jnp.asarray(k_np[i]),
                "cached_value": jnp.asarray(v_np[i]),
            }}
            for i in range(cfg.num_layers)
        }
        jpaged = JPagedState(
            jnp.asarray(table), jnp.asarray(cursors), ps, num_pages,
            attn_impl="gather",
        )
        out, mutated = _japply(jmodel, decode=True, mutable=["cache"])(
            {"params": params, "cache": jcache}, jnp.asarray(ids),
            paged=jpaged,
        )
        jk = np.stack([np.asarray(mutated["cache"][f"layer_{i}"]["attention"]
                                  ["cached_key"]) for i in range(cfg.num_layers)])
        jv = np.stack([np.asarray(mutated["cache"][f"layer_{i}"]["attention"]
                                  ["cached_value"]) for i in range(cfg.num_layers)])
        memo[window] = (ids, k_np, v_np, table, cursors,
                        np.asarray(out["logits"]), jk, jv)
        return memo[window]

    return get


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_paged_forward_matches_jax(pair, paged_case, impl, window):
    """A paged decode step and a 16-token chunk window: logits and the
    written pools against the JAX paged branch, on both of the port's
    read paths."""
    tmodel = pair[2]
    ids, k_np, v_np, table, cursors, want, jk, jv = paged_case(window)
    pool = KVPool(torch.from_numpy(k_np.copy()), torch.from_numpy(v_np.copy()))
    with torch.inference_mode():
        got = tmodel.paged_forward(
            torch.from_numpy(ids).long(), pool,
            PagedState(torch.from_numpy(table), torch.from_numpy(cursors),
                       attn_impl=impl),
        )
    live = cursors < tmodel.cfg.max_len
    np.testing.assert_allclose(
        got.numpy()[live], want[live], atol=ATOL, rtol=RTOL
    )
    np.testing.assert_allclose(pool.k.numpy(), jk, atol=POOL_ATOL,
                               rtol=POOL_RTOL)
    np.testing.assert_allclose(pool.v.numpy(), jv, atol=POOL_ATOL,
                               rtol=POOL_RTOL)


# -- int8 pools (kv_quant="int8") ----------------------------------------------


def _jcache_int8(pools):
    k, v, ks, vs = pools
    return {
        f"layer_{i}": {"attention": {
            "cached_key": jnp.asarray(k[i]),
            "cached_value": jnp.asarray(v[i]),
            "cached_key_scale": jnp.asarray(ks[i]).astype(jnp.bfloat16),
            "cached_value_scale": jnp.asarray(vs[i]).astype(jnp.bfloat16),
        }}
        for i in range(k.shape[0])
    }


def _jpools_int8(cache, n):
    names = ("cached_key", "cached_value", "cached_key_scale",
             "cached_value_scale")
    return [np.stack([np.asarray(cache[f"layer_{i}"]["attention"][name]
                                 ).astype(np.int8 if j < 2 else np.float32)
                      for i in range(n)]) for j, name in enumerate(names)]


@pytest.fixture(scope="module")
def int8_case(pair):
    """A 3-slot 8-token window (cursors 5, 17 and a parked 128), then one
    decode step at the advanced cursors, through the JAX paged branch
    with kv_quant="int8" (gather), on int8 pools quantized from seeded
    f32 pools. Returns the inputs, the JAX logits of both calls and the
    JAX pools after each."""
    from kubeflow_tpu_torch.ops.attention import quantize_kv

    jmodel, params, _ = pair
    cfg = jmodel.cfg
    ps, num_pages = 8, 40
    rng = np.random.default_rng(3)
    (qk, sk), (qv, sv) = (quantize_kv(torch.from_numpy(p))
                          for p in _pools(rng, cfg, num_pages, ps))
    pools = [qk.numpy(), qv.numpy(), sk.float().numpy(), sv.float().numpy()]
    cursors = np.array([5, 17, cfg.max_len], np.int32)
    table = np.stack([rng.permutation(num_pages)[: cfg.max_len // ps]
                      for _ in range(3)]).astype(np.int32)
    calls = [(_ids(rng, 3, 8), cursors),
             (_ids(rng, 3, 1), np.minimum(cursors + 8, cfg.max_len))]
    apply = _japply(jmodel, decode=True, mutable=["cache"])
    jpools, logits, after = pools, [], []
    for ids, cur in calls:
        out, mutated = apply(
            {"params": params, "cache": _jcache_int8(jpools)},
            jnp.asarray(ids),
            paged=JPagedState(jnp.asarray(table), jnp.asarray(cur), ps,
                              num_pages, attn_impl="gather", kv_quant="int8"),
        )
        jpools = _jpools_int8(mutated["cache"], cfg.num_layers)
        logits.append(np.asarray(out["logits"]))
        after.append(jpools)
    return pools, table, calls, logits, after


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_int8_paged_forward_matches_jax(pair, int8_case, impl):
    """A window, then a decode step, over an int8 pool: logits against the
    JAX paged branch at kv_quant="int8", and the written int8 values and
    bf16 scales bitwise, on both of the port's read paths."""
    tmodel = pair[2]
    pools, table, calls, want_logits, want_pools = int8_case
    k, v, ks, vs = (torch.from_numpy(p.copy()) for p in pools)
    pool = KVPool(k, v, ks.bfloat16(), vs.bfloat16())
    assert pool.quantized
    for (ids, cur), want, jpool in zip(calls, want_logits, want_pools):
        with torch.inference_mode():
            got = tmodel.paged_forward(
                torch.from_numpy(ids).long(), pool,
                PagedState(torch.from_numpy(table), torch.from_numpy(cur),
                           attn_impl=impl),
            )
        live = cur < tmodel.cfg.max_len
        np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL,
                                   rtol=RTOL)
        for name, t, w in zip(("k", "v", "k_scale", "v_scale"),
                              pool.tensors(), jpool):
            np.testing.assert_array_equal(t.float().numpy(), w.astype(
                np.float32), err_msg=name)


# the preset's widths and depth, as the reference registers them
PRESET_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
                 "mlp_dim", "max_len", "dropout_rate")


@pytest.mark.parametrize("name", ["gpt_medium", "gpt_small", "gpt_tiny"])
def test_presets_match_the_reference_configs(name):
    """Each preset of the port's registry has the reference's config,
    field by field (gpt_medium: 1024/24/16/4096, head dim 64)."""
    from kubeflow_tpu.models.registry import get_model as jget_model

    want = jget_model(name).cfg
    got = get_model(name, device="meta").cfg
    for field in PRESET_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.hidden_size // want.num_heads
    if name == "gpt_medium":
        assert (got.hidden_size, got.num_layers, got.num_heads, got.mlp_dim,
                got.head_dim) == (1024, 24, 16, 4096, 64)


def test_gpt_medium_logits_match_jax():
    """gpt_medium at its widths (1024 hidden, 16 heads of 64, MLP 4096),
    cut to 2 layers and a 512-token vocabulary: the JAX model's f32
    weights through `load_jax_params`, the same ids, logits within
    ATOL/RTOL."""
    from kubeflow_tpu.models.registry import get_model as jget_model

    over = dict(num_layers=2, vocab_size=512)
    jmodel = jget_model("gpt_medium", dtype=jnp.float32, **over)
    ids = _ids(np.random.default_rng(5), 2, 12)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.asarray(ids), deterministic=True)["params"])(
            jax.random.PRNGKey(0))
    want = np.asarray(_japply(jmodel)({"params": params},
                                      jnp.asarray(ids))["logits"])
    tmodel = get_model("gpt_medium", dtype=torch.float32, device="cpu", **over)
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.shape == (2, 12, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
