"""The port's tiered KV (kubeflow_tpu_torch/serving/kv_tiers.py and the
engine's hooks) on the CPU, at tests/test_kv_tiers.py's geometry: the
session gpt_tiny f32 weights bridged from JAX, page 8, 24 pages, prefill
buckets (8, 32), read path "kernel" (its plain version on CPU tensors).

The port's counterparts of the JAX tier tests: the host tier is a
bounded LRU that rejects an entry larger than its budget; evict → spill
→ re-admit and persist → restart → preload give greedy tokens equal to
the always-resident engine's and to JAX `generate()`'s (f32), and at
int8 the pages come back with their bf16 scales (tokens equal the
always-resident int8 engine's and the first serve's); a corrupt
manifest or a missing entry file is a cold start; persists prune old
generations. Across the packages: a JAX engine's prefix store preloads
into a port engine and a port engine's store into a JAX engine, in both
leaf layouts, with a prefix hit, JAX `generate()`'s tokens, and the
pages bit for bit. Tolerance: tokens identical, pages equal bit for bit,
sizes and counters exact."""

import functools
import os
from collections.abc import Mapping

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.gpt import stack_layer_params  # noqa: E402
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.serving import engine as jengine  # noqa: E402
from kubeflow_tpu.serving.generate import generate as jgenerate  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.models.gpt import (  # noqa: E402
    gather_pool_page,
    make_paged_pool,
    scatter_pool_page,
)
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine,
    resolve_num_pages,
)
from kubeflow_tpu_torch.serving.kv_tiers import (  # noqa: E402
    HostKVTier,
    PageEntry,
    PersistentPrefixStore,
    pool_sizing_telemetry,
    tree_from_flat,
)
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry  # noqa: E402

PS = 8


@pytest.fixture(scope="module")
def tiny(gpt_and_params):
    jmodel, params = gpt_and_params
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    run = jax.jit(functools.partial(jgenerate, jmodel), static_argnums=(2,))

    def ref(row, n):
        out = run(params, jnp.asarray(row, jnp.int32)[None], n)
        return np.asarray(out)[0, len(row):].tolist()

    return jmodel, params, tmodel, ref


def _engine(tmodel, name, **kw):
    """The JAX tier tests' geometry: a 24-page pool at page 8 that a few
    committed chains push into radix eviction (the spill trigger)."""
    return DecodeEngine(name, tmodel, device="cpu", num_slots=2,
                        page_size=PS, num_pages=24, prefill_buckets=(8, 32),
                        paged_attention="kernel", **kw)


def _jengine(model, params, name, **kw):
    return jengine.DecodeEngine(name, model, params, num_slots=2,
                                page_size=PS, num_pages=24,
                                prefill_buckets=(8, 32), **kw)


def _entry(nbytes, fill=0):
    """A PageEntry holding exactly `nbytes` of target payload."""
    return PageEntry({"k": torch.full((nbytes,), fill, dtype=torch.uint8)},
                     None, hits=1)


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8).tobytes()


# -- the host tier -------------------------------------------------------------


def test_host_tier_lru_bound_enforced():
    """The tier never holds more than its budget: a put past it evicts
    from the LRU end, and get() refreshes recency."""
    tier = HostKVTier(budget_bytes=3 * 100)
    for i in range(3):
        assert tier.put((i,), _entry(100, i))
    assert tier.bytes_in_use == 300
    tier.get((0,))  # (1,) is now the LRU entry
    assert tier.put((3,), _entry(100, 3))
    assert tier.bytes_in_use <= 300
    assert (1,) not in tier
    assert (0,) in tier and (2,) in tier and (3,) in tier
    st = tier.stats()
    assert st["evicted_pages_total"] == 1 and st["entries"] == 3


def test_host_tier_rejects_an_oversize_entry():
    tier = HostKVTier(budget_bytes=64)
    assert not tier.put((1,), _entry(65))
    assert len(tier) == 0
    assert tier.stats()["rejected_pages_total"] == 1
    with pytest.raises(ValueError, match="budget_bytes"):
        HostKVTier(-1)


def test_host_tier_take_removes_and_counts_a_hit():
    tier = HostKVTier(budget_bytes=1024)
    tier.put((1, 2), _entry(64))
    assert tier.take((1, 2)) is not None
    assert (1, 2) not in tier and tier.take((1, 2)) is None
    assert tier.stats()["hit_pages_total"] == 1 and tier.bytes_in_use == 0


# -- pool sizing from telemetry ------------------------------------------------


class _Cfg:
    max_len = 256
    hidden_size = 64
    num_heads = 4
    dtype = torch.float32


class _JCfg(_Cfg):
    dtype = "float32"


def test_resolve_num_pages_from_telemetry_agrees_with_jax():
    """Low observed pressure shrinks an auto pool toward 1/2 of the
    slot-row footprint, high pressure restores the static 3/4 and never
    more; explicit num_pages wins. The JAX rule gives the same pages for
    the same telemetry."""
    static = resolve_num_pages(0, 8, _Cfg, 16)
    assert static == 96  # 3/4 of 8 slots x 16 pages a slot
    reg = MetricsRegistry()
    total = reg.gauge("serving_kv_pages_total", "", ["model"])
    in_use = reg.gauge("serving_kv_pages_in_use", "", ["model"])
    total.set(96, model="m")
    in_use.set(10, model="m")  # ~10 % utilization, no prefix reuse
    low = pool_sizing_telemetry(reg)
    assert resolve_num_pages(0, 8, _Cfg, 16, telemetry=low) == 64
    in_use.set(90, model="m")
    high = pool_sizing_telemetry(reg)
    assert resolve_num_pages(0, 8, _Cfg, 16, telemetry=high) == static
    assert resolve_num_pages(40, 8, _Cfg, 16, telemetry=low) == 40
    hits = reg.counter("serving_prefix_cache_hit_tokens_total", "", ["model"])
    lookups = reg.counter("serving_prefix_cache_lookups_total", "", ["model"])
    in_use.set(10, model="m")
    hits.inc(96, model="m")
    lookups.inc(3, model="m")
    warm = pool_sizing_telemetry(reg)
    assert warm["prefix_hit_rate"] == 0.5
    for tele in (low, high, warm):
        for quantize in ("none", "int8"):
            assert resolve_num_pages(0, 8, _Cfg, 16, quantize,
                                     telemetry=tele) == \
                jengine.resolve_num_pages(0, 8, _JCfg, 16, quantize,
                                          telemetry=tele)


def test_telemetry_is_none_without_metrics():
    assert pool_sizing_telemetry(MetricsRegistry()) is None


# -- gather / scatter ----------------------------------------------------------


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_gather_scatter_pool_page_round_trip(tiny, quantize):
    """A gathered page (values, and an int8 pool's bf16 scales) written
    onto another page reads back bit for bit and leaves every other page
    as it was; a page of another shape raises before writing."""
    cfg = tiny[2].cfg
    pool = make_paged_pool(cfg, 6, PS, "cpu", kv_quant=quantize)
    g = torch.Generator().manual_seed(0)
    for t in pool.tensors():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-128, 128, t.shape, generator=g))
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    before = {n: t.clone() for n, t in pool.fields().items()}
    page = gather_pool_page(pool, 2)
    assert sorted(page) == sorted(pool.fields())
    assert page["k"].shape == (cfg.num_layers, PS, cfg.num_heads, cfg.head_dim)
    scatter_pool_page(pool, page, 5)
    for name, t in pool.fields().items():
        assert _bits(t[:, 5]) == _bits(before[name][:, 2])
        assert _bits(t[:, :5]) == _bits(before[name][:, :5])
    bad = dict(page, k=page["k"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        scatter_pool_page(pool, bad, 0)
    assert _bits(pool.k[:, 0]) == _bits(before["k"][:, 0])


# -- evict -> spill -> re-admit ------------------------------------------------


# the engine variants the tiers run under: f32, int8 pages with their
# scales, and a drafted engine (K = 2, the target as its own draft) whose
# draft pool spills, persists and uploads beside the target's
CASES = {"f32": {}, "int8": {"quantize": "int8"},
         "drafted": {"num_draft_tokens": 2}}


def _case_kw(case, tmodel):
    kw = dict(CASES[case])
    if case == "drafted":
        kw["draft_model"] = tmodel
    return kw


@pytest.mark.parametrize("case", list(CASES))
def test_evict_spill_readmit_bitwise(tiny, case):
    """Pool pressure evicts a committed chain into the host tier; the
    prefix with a new tail uploads the spilled pages and the first
    prompt again re-admits its tail page as the boundary copy. Tokens
    equal the always-resident engine's (and, in f32, JAX generate()'s;
    at int8, the first serve's), and the counters show the tier ran."""
    _, _, tmodel, ref = tiny
    quantize = CASES[case].get("quantize", "none")
    rng = np.random.default_rng(0 if quantize == "none" else 2)
    vocab = tmodel.cfg.vocab_size
    shared = rng.integers(0, vocab, 24)
    row_a = np.concatenate([shared, rng.integers(0, vocab, 8)])
    row_b = np.concatenate([shared, rng.integers(0, vocab, 8)])
    fills = [rng.integers(0, vocab, 32) for _ in range(6)]
    traffic = [(row_a, 6), *((f, 4) for f in fills), (row_b, 6), (row_a, 6)]
    kw = _case_kw(case, tmodel)
    got = {}
    for kind in ("resident", "tiered"):
        if kind == "tiered":
            eng = _engine(tmodel, "kvt-tiered", kv_host_bytes=64 << 20, **kw)
        else:  # a pool that never evicts
            eng = DecodeEngine("kvt-resident", tmodel, device="cpu",
                               num_slots=2, page_size=PS, num_pages=128,
                               prefill_buckets=(8, 32),
                               paged_attention="kernel", **kw)
        try:
            got[kind] = [eng.generate_row(r, n, timeout=120)["tokens"]
                         for r, n in traffic]
            st = eng.stats()
        finally:
            eng.close()
        if kind == "resident":
            assert st["kv_spill_pages"] == 0 and st["kv_host_tier"] is None
    assert got["tiered"] == got["resident"]
    if quantize == "none":
        assert got["tiered"][-2] == ref(row_b, 6)
        assert got["tiered"][0] == ref(row_a, 6)
    assert got["tiered"][-1] == got["tiered"][0]
    assert st["kv_spill_pages"] > 0
    # row_b's three shared pages, then row_a's tail page as the boundary
    assert st["kv_spill_hits"] == 4
    assert st["kv_host_tier"]["spilled_pages_total"] == st["kv_spill_pages"]
    assert st["kv_host_tier"]["bytes_in_use"] > 0
    if case == "drafted":
        assert st["draft_accepted"] == st["draft_proposed"] > 0


def test_a_full_host_tier_reuses_its_slots_without_losing_a_page(tiny):
    """A host tier of two pages: re-admitting a two-page chain takes one
    page and peeks the boundary page, and the allocs that follow evict
    and spill pool pages into the tier, which must drop the peeked page
    and hand its arena slot to a victim. The boundary upload still
    carries the chain's bits: tokens equal the always-resident engine's,
    and the tier's slots all come back."""
    _, _, tmodel, ref = tiny
    rng = np.random.default_rng(5)
    p = rng.integers(0, 512, 2 * PS)
    traffic = [(p, 1), (rng.integers(0, 512, 96), 1),
               (rng.integers(0, 512, 96), 1), (p, 4)]
    page_bytes = 2 * tmodel.cfg.num_layers * PS * tmodel.cfg.hidden_size * 4
    got = {}
    for kind, kw in (("resident", {}),
                     ("tiered", {"kv_host_bytes": 2 * page_bytes})):
        eng = _engine(tmodel, f"kvt-{kind}", **kw)
        try:
            got[kind] = [eng.generate_row(r, n, timeout=120)["tokens"]
                         for r, n in traffic]
            st = eng.stats()
            if kind == "tiered":
                # two pages of budget, and one request's (16 pages) for
                # the pages an admission takes out while it uploads them
                arena = eng._host_arena
                assert arena.slots == 2 + 16
                assert arena.free_count + st["kv_host_tier"]["entries"] == 18
        finally:
            eng.close()
    assert got["tiered"] == got["resident"]
    assert got["tiered"][-1] == ref(p, 4)
    assert st["kv_spill_hits"] == 2  # the taken page and the boundary
    assert st["prefix_hit_tokens"] == 2 * PS - 1
    assert st["kv_host_tier"]["evicted_pages_total"] == 3


def test_host_tier_drops_through_its_hook():
    """Every entry the tier evicts, replaces, discards or clears goes to
    `on_drop` (the engine's arena slot release); `take` hands its entry
    out instead, and `make_room` evicts what a put would."""
    dropped = []
    tier = HostKVTier(budget_bytes=300, on_drop=lambda e: dropped.append(e))
    entries = [_entry(100, i) for i in range(5)]
    for i in range(3):
        tier.put((i,), entries[i])
    tier.put((3,), entries[3])          # evicts (0,)
    tier.put((1,), entries[4])          # replaces (1,)
    assert dropped == [entries[0], entries[1]]
    assert tier.take((2,)) is entries[2] and len(dropped) == 2
    tier.make_room(200)                 # (3,) is the LRU entry now
    assert dropped[-1] is entries[3] and tier.bytes_in_use == 100
    tier.discard((1,))
    assert dropped[-1] is entries[4] and len(tier) == 0
    tier.put((7,), entries[0])
    tier.clear()
    assert dropped[-1] is entries[0]
    assert tier.stats()["hit_pages_total"] == 1


def test_a_host_tier_smaller_than_a_page_is_refused(tiny):
    with pytest.raises(ValueError, match="holds no page"):
        _engine(tiny[2], "kvt-tiny", kv_host_bytes=1024, autostart=False)


# -- persist -> restart -> preload ---------------------------------------------


def _warm_and_row(vocab, seed=1):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 24)
    return (np.concatenate([shared, rng.integers(0, vocab, 4)]),
            np.concatenate([shared, rng.integers(0, vocab, 8)]))


@pytest.mark.parametrize("case", list(CASES))
def test_persist_restart_preload_bitwise(tiny, tmp_path, case):
    """Engine 1 commits a shared prefix and persists its hot chains as it
    closes; engine 2 on the same store preloads them before its first
    request, which is a prefix hit with the always-resident engine's
    tokens (JAX generate()'s in f32)."""
    _, _, tmodel, ref = tiny
    warm, row = _warm_and_row(tmodel.cfg.vocab_size)
    store = str(tmp_path / "kvstore")
    kw = _case_kw(case, tmodel)
    e1 = _engine(tmodel, "kvt-seed", kv_persist_dir=store, **kw)
    try:
        e1.generate_row(warm, 4, timeout=120)
    finally:
        e1.close()  # the final persist commits a generation
    assert e1.stats()["kv_persisted_chains"] == 3
    e2 = _engine(tmodel, "kvt-warm", kv_persist_dir=store, **kw)
    try:
        preloaded = e2.stats()
        out = e2.generate_row(row, 6, timeout=120)["tokens"]
        st = e2.stats()
    finally:
        e2.close()
    resident = _engine(tmodel, "kvt-resident", **kw)
    try:
        resident.generate_row(warm, 4, timeout=120)
        want = resident.generate_row(row, 6, timeout=120)["tokens"]
    finally:
        resident.close()
    assert preloaded["kv_persisted_chains"] == 3
    assert preloaded["prefix_index_pages"] == 3
    assert st["prefix_hit_tokens"] == 24  # the preload fed the radix index
    assert out == want
    if case != "int8":
        assert out == ref(row, 6)


@pytest.mark.parametrize("defect", ["corrupt_manifest", "missing_entry"])
def test_defective_store_is_a_cold_start(tiny, tmp_path, defect):
    """A corrupt manifest or a manifest naming a missing entry file is
    unusable: load() returns None, the engine preloads nothing and
    serves the right tokens."""
    _, _, tmodel, ref = tiny
    rng = np.random.default_rng(1)
    row = np.concatenate([rng.integers(0, 512, 24), rng.integers(0, 512, 8)])
    store = str(tmp_path / "kvstore")
    e1 = _engine(tmodel, "kvt-seed", kv_persist_dir=store)
    try:
        e1.generate_row(row, 4, timeout=120)
    finally:
        e1.close()
    gen_dir = os.path.join(store, sorted(os.listdir(store))[-1])
    if defect == "corrupt_manifest":
        with open(os.path.join(gen_dir, "manifest.json"), "w") as f:
            f.write("{not json")
    else:
        for name in os.listdir(gen_dir):
            if name.endswith(".npz"):
                os.unlink(os.path.join(gen_dir, name))
    assert PersistentPrefixStore(store).load(PS, "none") is None
    e2 = _engine(tmodel, "kvt-cold", kv_persist_dir=store)
    try:
        assert e2.stats()["kv_persisted_chains"] == 0
        assert e2.stats()["pages_in_use"] == 0
        out = e2.generate_row(row, 6, timeout=120)["tokens"]
    finally:
        e2.close()
    assert out == ref(row, 6)


def test_int8_npz_round_trip_with_scales(tmp_path):
    """int8 values and their bf16 scales come back bit for bit through
    the store (npz keeps bf16 as 2-byte void words; tree_from_flat views
    them back against the template), and a store of another page size
    or quantize mode is refused."""
    g = torch.Generator().manual_seed(7)
    values = torch.randint(-128, 128, (2, 8, 4, 16), generator=g,
                           dtype=torch.int8)
    scales = torch.randn((2, 8, 4, 1), generator=g).to(torch.bfloat16)
    target = {"layer/k": values, "layer/k_scale": scales}
    store = PersistentPrefixStore(str(tmp_path / "s"))
    store.persist([(tuple(range(8)), target, None, 3)], page_size=8,
                  quantize="int8")
    loaded = store.load(8, "int8")
    assert loaded is not None and len(loaded) == 1
    assert loaded[0]["target"]["layer/k_scale"].dtype.kind == "V"
    got = tree_from_flat(target, loaded[0]["target"])
    assert got["layer/k"].dtype == torch.int8
    assert torch.equal(got["layer/k"], values)
    assert got["layer/k_scale"].dtype == torch.bfloat16
    assert _bits(got["layer/k_scale"]) == _bits(scales)
    assert loaded[0]["hits"] == 3
    assert store.load(16, "int8") is None
    assert store.load(8, "none") is None
    with pytest.raises(ValueError, match="does not match"):
        tree_from_flat({"layer/k": values[:1], "layer/k_scale": scales},
                       loaded[0]["target"])


def test_persist_prunes_old_generations(tmp_path):
    """Each persist commits a new generation and prunes the old ones and
    any torn directory, so the store never grows past one."""
    store = PersistentPrefixStore(str(tmp_path / "s"))
    os.makedirs(str(tmp_path / "s" / "step_00000007"))  # torn, in flight
    entry = ((1, 2, 3, 4), {"k": np.zeros(4, np.int8)}, None, 1)
    gens = [store.persist([entry], page_size=4, quantize="none")
            for _ in range(3)]
    assert gens == [1, 2, 3]
    assert os.listdir(str(tmp_path / "s")) == ["step_00000003"]
    assert store.load(4, "none") is not None


# -- the store across the packages ---------------------------------------------


@pytest.fixture(scope="module")
def jax_layouts(tiny):
    """The JAX model and params in each leaf layout ("named" is the
    session model, "scan" its scan_layers twin with stacked params)."""
    jmodel, params = tiny[:2]
    scan = jget_model("gpt_tiny", dtype=jnp.float32, scan_layers=True)
    return {"named": (jmodel, params),
            "scan": (scan, stack_layer_params(params, jmodel.cfg.num_layers))}


@pytest.mark.parametrize("kv_layout", ["named", "scan"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_prefix_store_crosses_packages(tiny, jax_layouts, tmp_path, direction,
                                       kv_layout):
    """One package's engine persists a shared prefix; the other's preloads
    it, its first request is a prefix hit with JAX generate()'s tokens,
    and the reader's pages are the writer's bit for bit."""
    _, _, tmodel, ref = tiny
    jmodel, jparams = jax_layouts[kv_layout]
    warm, row = _warm_and_row(tmodel.cfg.vocab_size, seed=3)
    store = str(tmp_path / "kvstore")

    def port(name):
        return _engine(tmodel, name, kv_persist_dir=store, kv_layout=kv_layout)

    def jax_engine(name):
        return _jengine(jmodel, jparams, name, kv_persist_dir=store)

    writer, reader = ((jax_engine, port) if direction == "jax_to_port"
                      else (port, jax_engine))
    w = writer("kvx-writer")
    try:
        w.submit(warm, 4).wait(120)
        written = w.export_prefix_entries(warm)
    finally:
        w.close()
    r = reader("kvx-reader")
    try:
        preloaded = r.stats()["kv_persisted_chains"]
        landed = r.export_prefix_entries(warm)
        out = r.submit(row, 6).wait(120)["tokens"]
        hits = r.stats()["prefix_hit_tokens"]
    finally:
        r.close()
    assert preloaded == 3
    assert hits == 24
    assert out == ref(row, 6)
    assert [tuple(e[0]) for e in landed] == [tuple(e[0]) for e in written]
    for (_, a, _, _), (_, b, _, _) in zip(written, landed):
        a_leaves, b_leaves = _flat_leaves(a), _flat_leaves(b)
        assert sorted(a_leaves) == sorted(b_leaves)
        for key in a_leaves:
            assert _bits(a_leaves[key]) == _bits(b_leaves[key]), key


def _flat_leaves(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested page tree (a JAX engine's
    export) or of a flat one (the port's)."""
    out = {}
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            out.update(_flat_leaves(sub, path + "/"))
        else:
            out[path] = sub
    return out
