"""Speculative decoding in the port's engine (kubeflow_tpu_torch/serving/
engine.py draft-and-verify; serving/sampling.py `speculative_accept`) on
the CPU, with the session gpt_tiny weights bridged from JAX.

Greedy contract: a drafted engine emits the target's argmax at every
position, whatever the draft proposes, so its tokens equal JAX
`generate()`, the port's `generate()` and the port's K = 0 engine, for
an identical draft (accepts everything) and for a draft whose head is
rolled one vocab row (its argmax is never the target's: accepts
nothing). Sampled decoding cannot match JAX's threefry bits (parity
rule (d)): it is held by the rejection-sampling lemma on a histogram, by
its own determinism, and by independence from slot placement and
neighbours. `speculative_accept` itself is held against the JAX function
on the same inputs: `accept` equal, `residual` within 1e-6 (one division
per element)."""

import functools
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.serving.generate import generate as jgenerate  # noqa: E402
from kubeflow_tpu.serving.sampling import (  # noqa: E402
    speculative_accept as jspeculative_accept,
)
from kubeflow_tpu_torch.api.wsgi import Server  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402
from kubeflow_tpu_torch.serving.generate import generate  # noqa: E402
from kubeflow_tpu_torch.serving.main import (  # noqa: E402
    build_server,
    engine_knobs_from_env,
)
from kubeflow_tpu_torch.serving.sampling import (  # noqa: E402
    speculative_accept,
)
from kubeflow_tpu_torch.utils.metrics import default_registry  # noqa: E402

ORACLE_NEW = 9  # JAX generate() tokens per row; shorter requests take a prefix
LENS = (4, 6, 7, 3, 5)


def _rows(*lens):
    """The reference suite's ragged rows."""
    return [
        (np.arange(n) * (3 + 2 * i) + i + 1).astype(np.int64) % 512
        for i, n in enumerate(lens)
    ]


@pytest.fixture(scope="module")
def spec(gpt_and_params):
    """(target, rolled-head draft, rows, JAX oracle tokens per row)."""
    jmodel, params = gpt_and_params
    target = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(target, jax.tree.map(np.asarray, params))
    rolled = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    rolled.load_state_dict(target.state_dict())
    with torch.no_grad():
        # every logit row shifts one vocab position: the draft's argmax is
        # always target_argmax + 1 mod V, so greedy acceptance is 0
        rolled.head.kernel.copy_(torch.roll(target.head.kernel, 1, dims=-1))
    rows = _rows(*LENS)
    run = jax.jit(functools.partial(jgenerate, jmodel), static_argnums=(2,))
    oracle = [
        np.asarray(run(params, jnp.asarray(r[None], jnp.int32),
                       ORACLE_NEW))[0, len(r):].tolist()
        for r in rows
    ]
    return target, rolled, rows, oracle


def _drafts(spec):
    target, rolled = spec[0], spec[1]
    return {"identical": target, "rolled": rolled}


def _engine(target, draft, k=3, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("paged_attention", "kernel")
    return DecodeEngine("spec", target, device="cpu", draft_model=draft,
                        num_draft_tokens=k, **kw)


def _serve(eng, rows, n_new, **kw):
    try:
        futures = [eng.submit(r, n, **kw) for r, n in zip(rows, n_new)]
        return [f.wait(120)["tokens"] for f in futures], eng.stats()
    finally:
        eng.close()


# -- the acceptance rule ----------------------------------------------------------


def _accept_case(kind, seed=0, s=3, k=4, v=11):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(v), (s, k)).astype(np.float32)
    q = rng.dirichlet(np.ones(v), (s, k)).astype(np.float32)
    if kind == "equal_rows":
        q[1] = p[1]  # residual all zero: falls back to p
        q[2, 0] = p[2, 0]
    elif kind == "disjoint":
        # q puts its mass where p has none: every proposal is rejected
        p[..., : v // 2] = 0.0
        q[..., v // 2:] = 0.0
        p /= p.sum(-1, keepdims=True)
        q /= q.sum(-1, keepdims=True)
    drafted = np.stack([[rng.choice(v, p=q[i, j] / q[i, j].sum())
                         for j in range(k)] for i in range(s)])
    uniforms = rng.random((s, k)).astype(np.float32)
    return p, q, drafted, uniforms


@pytest.mark.parametrize("kind", ["random", "equal_rows", "disjoint"])
def test_speculative_accept_matches_jax(kind):
    p, q, drafted, uniforms = _accept_case(kind)
    want_acc, want_res = jspeculative_accept(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(drafted, jnp.int32),
        jnp.asarray(uniforms),
    )
    got_acc, got_res = speculative_accept(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(drafted),
        torch.from_numpy(uniforms),
    )
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res),
                               atol=1e-6, rtol=0)
    if kind == "equal_rows":
        np.testing.assert_array_equal(got_res[1].numpy(), p[1])
        assert got_acc[1].all()  # p == q accepts always (u < 1)
    if kind == "disjoint":
        assert not got_acc.any()


def test_rejection_sampling_recovers_target_distribution():
    """The speculative-sampling lemma on the reference's discriminating
    toy: proposals from q far from p (L1(p, q) = 1.04), accepted by
    `speculative_accept` or resampled from its residual, are distributed
    as p. 20,000 trials: L1 distance to p under 0.03 (a rule that always
    accepts emits q; one that corrects from p instead of the residual
    lands near 0.5)."""
    p = torch.tensor([[0.50, 0.05, 0.25, 0.05, 0.15]])
    q = torch.tensor([[0.02, 0.58, 0.05, 0.30, 0.05]])
    n = 20000
    gen = torch.Generator().manual_seed(7)
    drafted = torch.multinomial(q[0], n, replacement=True, generator=gen)
    uniforms = torch.rand(n, generator=gen)
    accept, residual = speculative_accept(
        p.expand(n, 5)[:, None], q.expand(n, 5)[:, None], drafted[:, None],
        uniforms[:, None],
    )
    corr = torch.multinomial(residual[:, 0], 1, generator=gen)[:, 0]
    toks = torch.where(accept[:, 0], drafted, corr)
    hist = torch.bincount(toks, minlength=5).double() / n
    l1 = (hist - p[0].double()).abs().sum().item()
    assert l1 < 0.03, (hist, l1)


# -- greedy parity ------------------------------------------------------------------


@pytest.fixture(scope="module")
def k0_tokens(spec):
    """The port's K = 0 engine on the ragged staggered traffic."""
    target, _, rows, _ = spec
    eng = DecodeEngine("k0", target, device="cpu", num_slots=2, page_size=8,
                       paged_attention="kernel")
    return _serve(eng, rows[:4], [6, 7, 5, 8])[0]


@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("draft", ["identical", "rolled"])
def test_greedy_drafted_engine_equals_generate(spec, k0_tokens, draft, impl):
    """4 ragged requests through 2 slots (staggered admission): tokens
    equal JAX generate(), the port's generate() and the K = 0 engine, on
    both read paths; the identical draft accepts every proposal, the
    rolled one none."""
    target, _, rows, oracle = spec
    n_new = [6, 7, 5, 8]
    got, stats = _serve(_engine(target, _drafts(spec)[draft],
                                paged_attention=impl), rows[:4], n_new)
    for r, n, toks, want, k0 in zip(rows, n_new, got, oracle, k0_tokens):
        assert toks == want[:n] == k0
        assert toks == generate(target, r[None], n)[0, len(r):].tolist()
    assert stats["accept_rate"] == (1.0 if draft == "identical" else 0.0)
    assert stats["paged_attention_windows"] == {1: impl, 4: impl}
    assert stats["tokens"] == sum(n - 1 for n in n_new)


@pytest.mark.parametrize("draft", ["identical", "rolled"])
def test_slot_finishing_and_eos_mid_window(spec, draft):
    """K = 4 with max_new 2 beside a neighbour of 9: the short slot keeps
    exactly its prefix. Then EOS landing inside an accepted window: the
    engine stops at the first EOS."""
    target, _, rows, oracle = spec
    d = _drafts(spec)[draft]
    got, _ = _serve(_engine(target, d, k=4), rows[:2], [2, 9])
    assert got == [oracle[0][:2], oracle[1][:9]]
    eos = oracle[0][2]  # mid-window for K = 4
    got, _ = _serve(_engine(target, d, k=4, num_slots=1), rows[:1], [8],
                    eos_id=eos)
    out = got[0]
    assert out[-1] == eos and len(out) < 8
    assert out == oracle[0][: len(out)]


@pytest.mark.parametrize("draft,n_new,verify_steps", [
    ("identical", 9, 2),  # 8 tokens after the admission one, 4 a window
    ("rolled", 6, 5),     # one (correction) token a window
])
def test_acceptance_bookkeeping(spec, draft, n_new, verify_steps):
    target, _, rows, oracle = spec
    name = f"spec-{draft}"
    eng = DecodeEngine(name, target, device="cpu", num_slots=1, page_size=8,
                       paged_attention="kernel", num_draft_tokens=3,
                       draft_model=_drafts(spec)[draft])
    got, st = _serve(eng, rows[4:5], [n_new])
    assert got[0] == oracle[4][:n_new]
    assert st["verify_steps"] == st["decode_steps"] == verify_steps
    assert st["draft_proposed"] == 3 * verify_steps
    if draft == "identical":
        assert st["draft_accepted"] == st["draft_proposed"]
        assert st["accept_rate"] == 1.0
    else:
        assert st["draft_accepted"] == 0 and st["accept_rate"] == 0.0
    text = default_registry().render()
    label = f'{{model="{name}"}}'
    assert f"serving_verify_steps_total{label} {verify_steps}" in text
    assert (f"serving_draft_proposed_total{label} {3 * verify_steps}"
            in text)
    assert (f"serving_draft_accepted_total{label} "
            f"{st['draft_accepted']}" in text)
    assert f"serving_accept_rate_count{label} {verify_steps}" in text


@pytest.mark.parametrize("draft", ["identical", "rolled"])
def test_page_size_4_chunked_prompt_and_prefix_cow(spec, draft):
    """Page size 4, where rejected tails cross pages: a 40-token prompt
    past the largest bucket (head prefill + chunk windows on both
    models), then the same prompt again (a prefix hit whose boundary
    page is copied in both pools). The identical draft still accepts
    everything, which needs the draft's chunk windows and its COW in
    lockstep with the target's; the rewind gives pages back, and when
    the engine is idle only the prefix index holds pages."""
    target = spec[0]
    row = np.random.default_rng(7).integers(0, 512, 40)
    want = generate(target, row[None], 8)[0, 40:].tolist()
    eng = _engine(target, _drafts(spec)[draft], page_size=4,
                  prefill_buckets=(8, 16))
    try:
        first = eng.generate_row(row, 8)["tokens"]
        second = eng.generate_row(row, 8)["tokens"]
        st = eng.stats()
    finally:
        eng.close()
    assert first == second == want
    assert st["cow_copies"] == 1 and st["prefix_hit_tokens"] == 39
    assert st["paged_attention_windows"] == {1: "kernel", 4: "kernel",
                                             64: "kernel"}
    assert st["rewind_pages_returned"] > 0
    assert st["pages_in_use"] == st["prefix_index_pages"] > 0
    if draft == "identical":
        assert st["accept_rate"] == 1.0


def test_rewind_never_frees_a_shared_page(spec):
    """`_free_tail_pages` keeps max(pages the cursor reaches, shared
    prefix pages): a slot at cursor 1 that maps two prefix pages keeps
    both and frees only its own tail page."""
    target = spec[0]
    eng = _engine(target, target, page_size=4, autostart=False)
    try:
        pool = eng._pagepool
        shared = pool.alloc(2)  # slot 0 maps them ...
        eng._radix.insert(list(range(8)), shared)  # ... and the index
        own = pool.alloc(2)
        eng._slot_pages[0] = shared + own
        eng._slot_shared[0] = 2
        eng._cur_np[0] = 1
        assert eng._free_tail_pages(0) == 2
        assert eng._slot_pages[0] == shared
        assert [pool.refcount(p) for p in shared] == [2, 2]
        eng._cur_np[0] = 13  # past the shared pages: keeps the 4 it reaches
        eng._slot_pages[0] = shared + pool.alloc(2)
        assert eng._free_tail_pages(0) == 0 and len(eng._slot_pages[0]) == 4
    finally:
        eng.close()


@pytest.mark.parametrize("k", [0, 3])
def test_reservation_covers_the_k_overhang(spec, k):
    """The gate reserves prompt + max_new + K (capped at max_len), so a
    pool of exactly one full-length request serves two requests one
    after the other without running out mid-decode."""
    target, _, rows, oracle = spec
    eng = DecodeEngine("res", target, device="cpu", num_slots=2,
                       page_size=4, num_pages=32, paged_attention="kernel",
                       draft_model=target if k else None,
                       num_draft_tokens=k, prefix_cache=False)
    try:
        assert eng._reserve_pages(30, 70) == -(-(100 + k) // 4)
        assert eng._reserve_pages(100, 28) == 32  # the logical window
        long_row = np.arange(60) % 512
        want = generate(target, long_row[None], 60)[0, 60:].tolist()
        futures = [eng.submit(long_row, 60), eng.submit(rows[0], 9)]
        got = [f.wait(120)["tokens"] for f in futures]
        st = eng.stats()
    finally:
        eng.close()
    assert got == [want, oracle[0]]
    assert st["pages_in_use"] == 0


def test_verify_failure_fails_residents_and_the_next_request_is_right(spec):
    target, _, rows, oracle = spec
    eng = _engine(target, target, k=2, num_slots=1, autostart=False)
    orig = eng.programs.verify

    def broken_verify(*a, **kw):
        raise RuntimeError("injected verify failure")

    eng.programs.verify = broken_verify
    eng._thread.start()
    try:
        fut = eng.submit(rows[0], 4)
        with pytest.raises(RuntimeError, match="decode step failed"):
            fut.wait(60)
        assert eng._thread.is_alive()
        st = eng.stats()
        assert st["pages_in_use"] == st["prefix_index_pages"] == 0
        eng.programs.verify = orig
        out = eng.generate_row(rows[1], 5, timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    assert out["tokens"] == oracle[1][:5]
    assert st["draft_accepted"] > 0 and st["accept_rate"] == 1.0


# -- sampled decoding ---------------------------------------------------------------


@pytest.mark.parametrize("draft", ["identical", "rolled"])
def test_sampled_spec_deterministic_and_placement_independent(spec, draft):
    """One seed gives the same sampled tokens alone in slot 0, beside a
    crowd, and in slot 1 behind a neighbour: each slot draws from
    generators keyed by its request's (seed, position, salt) only. A
    greedy row beside sampled ones keeps the oracle's tokens."""
    target, _, rows, oracle = spec
    kw = dict(temperature=0.9, top_k=12, seed=42)
    eng = _engine(target, _drafts(spec)[draft], k=2, max_queue=16)
    try:
        alone = eng.generate_row([5, 6, 7], 6, **kw)["tokens"]
        crowd = [eng.submit(r, 5, temperature=1.0, top_p=0.9, seed=100 + i)
                 for i, r in enumerate(rows[:3])]
        greedy = eng.submit(rows[3], 8)
        for f in crowd:
            f.wait(120)
        assert greedy.wait(120)["tokens"] == oracle[3][:8]
        # slot 0 busy with a long greedy request: the repeat lands in slot 1
        blocker = eng.submit(rows[4], 9)
        beside = eng.generate_row([5, 6, 7], 6, **kw)["tokens"]
        blocker.wait(120)
    finally:
        eng.close()
    assert alone == beside
    assert all(0 <= t < 512 for t in alone)
    assert len(alone) == 6


# -- the verify window against the one-token steps, bit for bit -------------------


@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("slots", [1, 2])
def test_verify_window_is_bitwise_the_one_token_steps(spec, slots, impl):
    """At gpt_tiny f32 on the CPU, a K+1-row paged forward (the verify)
    gives the logits and writes the pool K/V that K+1 one-token steps
    from the same state give and write, bit for bit (tolerance 0). Every
    product on the path is a fixed-shape block (ops/attention.py
    `row_stable_matmul`): MKL rounds a one-row product (its GEMV path)
    differently from the same row of a taller one."""
    from kubeflow_tpu_torch.models.gpt import KVPool, PagedState, make_paged_pool

    target, k, ps = spec[0], 4, 8
    mp = target.cfg.max_len // ps
    pool = make_paged_pool(target.cfg, slots * mp + 1, ps, "cpu")
    table = torch.tensor([[1 + b * mp + i for i in range(mp)]
                          for b in range(slots)], dtype=torch.int32)
    rng = np.random.default_rng(5)
    prompt_len = (7, 12)[:slots]
    with torch.inference_mode():
        for b, n in enumerate(prompt_len):
            target.paged_forward(
                torch.from_numpy(rng.integers(0, 512, (1, n))), pool,
                PagedState(table[b:b + 1], torch.zeros(1, dtype=torch.int32),
                           impl))
        cursors = torch.tensor(prompt_len, dtype=torch.int32)
        window = torch.from_numpy(rng.integers(0, 512, (slots, k + 1)))
        verify_pool = KVPool(pool.k.clone(), pool.v.clone())
        steps = torch.stack([
            target.paged_forward(window[:, j:j + 1], pool,
                                 PagedState(table, cursors + j, impl))[:, 0]
            for j in range(k + 1)
        ], dim=1)
        verify = target.paged_forward(window, verify_pool,
                                      PagedState(table, cursors, impl))
    assert verify.shape == steps.shape == (slots, k + 1, 512)
    assert torch.equal(verify, steps)
    assert torch.equal(verify_pool.k, pool.k)
    assert torch.equal(verify_pool.v, pool.v)


# -- configuration and wiring -------------------------------------------------------


@pytest.mark.parametrize("case", ["no_draft", "negative_k", "vocab",
                                  "max_len"])
def test_draft_config_validation(spec, case):
    target = spec[0]
    draft, k, match = target, 2, "draft_model"
    if case == "no_draft":
        draft = None
    elif case == "negative_k":
        k, match = -1, "num_draft_tokens"
    elif case == "vocab":
        draft = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                          vocab_size=256)
        match = "vocab"
    else:
        draft = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                          max_len=64)
        match = "max_len"
    with pytest.raises(ValueError, match=match):
        DecodeEngine("v", target, device="cpu", autostart=False,
                     draft_model=draft, num_draft_tokens=k)


def test_k0_engine_builds_no_draft_machinery(spec):
    target = spec[0]
    eng = DecodeEngine("k0", target, device="cpu", num_slots=1,
                       autostart=False, draft_model=target)
    try:
        assert eng.num_draft_tokens == 0
        assert eng._draft_pool is None and eng.draft_model is None
        assert eng.stats()["verify_steps"] == 0
    finally:
        eng.close()


def test_draft_env_knobs(monkeypatch):
    monkeypatch.setenv("KFT_SERVING_DRAFT_MODEL", "gpt_tiny")
    monkeypatch.setenv("KFT_SERVING_DRAFT_TOKENS", "3")
    knobs = engine_knobs_from_env()
    assert (knobs["draft_model"], knobs["num_draft_tokens"]) == ("gpt_tiny", 3)
    assert knobs["draft_checkpoint_dir"] == ""
    monkeypatch.setenv("KFT_SERVING_DRAFT_MODEL", "")
    monkeypatch.setenv("KFT_SERVING_DRAFT_TOKENS", "")
    knobs = engine_knobs_from_env()
    assert (knobs["draft_model"], knobs["num_draft_tokens"]) == ("", 0)


@pytest.mark.parametrize("knobs,match", [
    ({"num_draft_tokens": 2}, "draft model"),
    ({"num_draft_tokens": 2, "draft_model": "gpt_tiny", "num_slots": 0},
     "num_slots"),
    # K > 0 without draft params: the draft's params are the checkpoint's
    ({"num_draft_tokens": 2, "draft_model": "gpt_tiny",
      "draft_checkpoint_dir": "ckpt"}, None),
    # the directory is read only at K > 0 without draft params, as the
    # reference reads it: a K = 0 server, or one given draft params, starts
    # without it
    ({"num_draft_tokens": 0, "draft_checkpoint_dir": "/ckpt/draft"}, None),
    ({"num_draft_tokens": 2, "draft_model": "gpt_tiny", "draft_params": "seed0",
      "draft_checkpoint_dir": "/ckpt/draft"}, None),
])
def test_build_server_draft_validation(monkeypatch, tmp_path, knobs, match):
    for knob in ("DRAFT_MODEL", "DRAFT_TOKENS", "DRAFT_CHECKPOINT_DIR"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    if match is not None:
        with pytest.raises(ValueError, match=match):
            build_server("gpt_tiny", device="cpu", dtype=torch.float32, **knobs)
        return
    trained = None
    if knobs.get("draft_checkpoint_dir") == "ckpt":
        # a draft checkpoint whose params are not the seed-0 init's
        from kubeflow_tpu_torch.checkpointing import CheckpointManager
        from kubeflow_tpu_torch.models.convert import params_to_jax

        trained = get_model("gpt_tiny", device="cpu", dtype=torch.float32,
                            seed=11).state_dict()
        flat = params_to_jax(trained)
        with CheckpointManager(str(tmp_path), async_save=False) as mgr:
            mgr.save(1, {"params": {p: torch.from_numpy(a)
                                    for p, a in flat.items()}})
        knobs = dict(knobs, draft_checkpoint_dir=str(tmp_path))
    if knobs.get("draft_params") == "seed0":
        knobs = dict(knobs, draft_params=get_model(
            "gpt_tiny", device="cpu", dtype=torch.float32).state_dict())
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      num_slots=2, page_size=8, **knobs)
    try:
        eng = ms.engine("gpt_tiny")
        assert eng.num_draft_tokens == knobs["num_draft_tokens"]
        if trained is not None:
            got = eng.draft_model.state_dict()
            assert all(torch.equal(got[n], v) for n, v in trained.items())
    finally:
        ms.close()


def test_rest_roundtrip_through_a_drafted_engine(monkeypatch, capsys):
    """build_server with a draft model and no draft params: the draft is
    the registry's seed-0 init (the target's, so it accepts everything),
    a note says so, and :generate over a socket equals generate()."""
    monkeypatch.delenv("KFT_SERVING_DRAFT_CHECKPOINT_DIR", raising=False)
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      num_slots=2, page_size=8, paged_attention="kernel",
                      draft_model="gpt_tiny", num_draft_tokens=3)
    assert "initialized from seed 0" in capsys.readouterr().out
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        prompt = [[1, 2, 3, 4], [9, 8, 7, 6]]
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}/v1/models/gpt_tiny:generate",
            data=json.dumps({"prompt_ids": prompt,
                             "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, body = resp.status, json.loads(resp.read())
            ttft = float(resp.headers["X-TTFT-Ms"])
        stats = ms.engine("gpt_tiny").stats()
    finally:
        httpd.stop()
        ms.close()
    assert status == 200
    assert body["sequences"] == generate(ms.lm("gpt_tiny").model, prompt,
                                         5).tolist()
    assert ttft > 0
    assert stats["accept_rate"] == 1.0 and stats["verify_steps"] > 0


def test_int8_drafted_engine_equals_the_k0_int8_engine(spec):
    """quantize="int8": the draft becomes int8 too, with its own int8
    pool; tokens equal the K = 0 int8 engine's (chunk windows and a
    prefix hit included), and the identical draft accepts everything."""
    target, rolled, rows, _ = spec
    long_row = np.random.default_rng(7).integers(0, 512, 40)
    traffic = [rows[0], long_row, long_row]
    got = {}
    for k, draft in ((0, None), (3, target), (3, rolled)):
        eng = DecodeEngine("q8", target, device="cpu", num_slots=2,
                           page_size=8, paged_attention="kernel",
                           prefill_buckets=(8, 16), quantize="int8",
                           draft_model=draft, num_draft_tokens=k)
        try:
            got[(k, draft is rolled)] = [
                eng.generate_row(r, 8, timeout=120)["tokens"] for r in traffic
            ]
            st = eng.stats()
            if k:
                assert eng._draft_pool.k.dtype == torch.int8
                assert eng.draft_model.quantize == "int8"
        finally:
            eng.close()
        if k and draft is target:
            assert st["accept_rate"] == 1.0
    assert got[(3, False)] == got[(0, False)] == got[(3, True)]


def test_chip_smoke_spec_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phase 11 on the CPU at gpt_tiny size: 11a's f32
    drafted tokens equal generate() for both drafts and the int8 drafted
    tokens the K = 0 int8 engine's; 11b's drafted REST serve and 11c's
    small draft answer phase 5's traffic within the logit-gap bound with
    no page leaked (CPU tensors take the plain versions: no launches)."""
    import importlib.util
    import os

    for knob in ("DRAFT_MODEL", "DRAFT_TOKENS", "DRAFT_CHECKPOINT_DIR",
                 "QUANTIZE", "NUM_SLOTS"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    mod = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(smoke)
    f32_model = smoke.phase_spec_f32(torch, model="gpt_tiny", device="cpu",
                                     prompts=(5, 9), max_new=8)
    traffic = dict(short=(3, 5, 9, 17, 30), long_len=90, hit_len=40,
                   max_new=16, buckets="8,16,32")
    k0 = {"load_tokens_per_s": 1.0, "load_decode_step_ms": 1.0}
    launches, run = smoke.phase_spec_serve(torch, f32_model, k0,
                                           model="gpt_tiny", device="cpu",
                                           **traffic)
    assert not any(launches.values()) and run["accept_rate"] == 1.0
    launches = smoke.phase_spec_small_draft(torch, f32_model, model="gpt_tiny",
                                            device="cpu", **traffic)
    assert not any(launches.values())
    assert smoke.main_windows(90, 40, 32, 64) == (32, 32, 39)
