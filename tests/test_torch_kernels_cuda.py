"""Card-only tests of the port's hand-written CUDA kernels (marked `cuda`;
each skips where there is no CUDA device). No JAX here: on the card run

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Each kernel is held against its plain PyTorch version on the same inputs:
atol 1e-5 in f32 (summation order), 2e-2 in bf16 (one bf16 ulp of a
rounded score, probability or output element); the int8 variants the
same, over int8 pools from `quantize_kv` (the dequant is the same f32
multiply and rounding on both sides). End to end, the engine's greedy
f32 tokens through the kernels equal `generate()` exactly, and at
quantize="int8" they equal the int8 engine's tokens through gather.

The flash-attention kernels (forward, dQ, dK/dV) are held against
`flash_attention_reference` / `flash_attention_bwd_reference` by
chip_smoke.py's phase-6 check (`flash_err`, FLASH_ATOL, FLASH_REL): f32
o and lse atol 1e-5, gradients 1e-4 (summation order over up to 1024
keys); bf16 lse 1e-3 (f32 from exact bf16 products: summation order
only), and bf16 o, dq, dk and dv each row by row (one head's D values at
one position): within 2e-2 of the larger of the row's own largest
|value| and the tensor's median |value| — two bf16 ulps of the row's
largest element, with margin (o and p rounded to bf16, p at the running
rather than the final row max; dS and P rounded before their products)
— or within the f32 tolerance. A row's scale is its own, so a late
causal row with small values is held as tightly as an early one."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from kubeflow_tpu_torch.ops import paged_attention as tpa  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MAX_LEN, PS, NUM_PAGES = 256, 16, 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(dev, s, h, d, dtype, seed=0):
    """Cursors 0, a page boundary (15, 16), max_len - 1, a parked row
    (max_len) and one mid-window row; distinct pages per slot up to its
    last live page, out-of-range garbage past it."""
    g = torch.Generator().manual_seed(seed)
    cursors = torch.tensor([0, PS - 1, PS, MAX_LEN - 1, MAX_LEN, 77],
                           dtype=torch.int32)
    b, mp = cursors.numel(), MAX_LEN // PS
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    pk = torch.randn((NUM_PAGES, PS, h, d), generator=g).to(dtype)
    pv = torch.randn((NUM_PAGES, PS, h, d), generator=g).to(dtype)
    table = torch.full((b, mp), 10**6, dtype=torch.int32)
    perm = torch.randperm(NUM_PAGES, generator=g).tolist()
    for i, cur in enumerate(cursors.tolist()):
        live = min((cur + s - 1) // PS, mp - 1) + 1
        table[i, :live] = torch.tensor(perm[:live], dtype=torch.int32)
        perm = perm[live:] or torch.randperm(NUM_PAGES, generator=g).tolist()
    return [t.to(dev) for t in (q, pk, pv, table, cursors)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 5, 16, 64])
def test_kernel_matches_plain_version(cuda, s, d, dtype):
    q, pk, pv, table, cursors = _case(cuda, s, 4, d, dtype)
    tpa.reset_launch_counts()
    got = tpa.paged_attention(q, pk, pv, table, cursors, dtype=dtype)
    want = tpa.paged_attention_reference(q, pk, pv, table, cursors,
                                         dtype=dtype)
    torch.cuda.synchronize()
    assert tpa.launch_counts[tpa.kernel_name(s)] == 1
    # parked rows included: both versions write zeros there
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[dtype], rtol=0)
    assert not got[cursors >= MAX_LEN].any()


def _int8_case(dev, s, h, d, dtype, seed=0):
    """`_case` with its pools quantized by `quantize_kv` (values int8,
    one bf16 scale per vector), one pool vector all zeros (scale 0)."""
    from kubeflow_tpu_torch.ops.attention import quantize_kv

    q, pk, pv, table, cursors = _case(dev, s, h, d, dtype, seed)
    pk, pv = pk.clone(), pv.clone()
    pk[int(table[1, 0]), 3] = 0
    pv[int(table[1, 0]), 3] = 0
    (qk, sk), (qv, sv) = quantize_kv(pk), quantize_kv(pv)
    return q, qk, qv, table, cursors, sk, sv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 5, 16, 64])
def test_int8_kernel_matches_plain_version(cuda, s, d, dtype):
    """The int8 variants against the plain version (gather, `dequant_kv`,
    dense core) on the same int8 pools, ragged and parked cursors."""
    q, pk, pv, table, cursors, sk, sv = _int8_case(cuda, s, 4, d, dtype)
    tpa.reset_launch_counts()
    got = tpa.paged_attention(q, pk, pv, table, cursors, dtype=dtype,
                              k_scale=sk, v_scale=sv)
    want = tpa.paged_attention_reference(q, pk, pv, table, cursors,
                                         dtype=dtype, k_scale=sk, v_scale=sv)
    torch.cuda.synchronize()
    name = tpa.kernel_name(s, quantized=True)
    assert tpa.launch_counts == {**{k: 0 for k in tpa.launch_counts},
                                 name: 1}
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[dtype], rtol=0)
    assert not got[cursors >= MAX_LEN].any()


# the decode kernel splits a row into runs of 128 keys (128 / page_size
# pages): cursors on those edges, one long row, and the view's last key
SPLIT_CURSORS = (0, 127, 128, 129, 1023)
DECODE_MAX_LEN = 1024
DECODE_KINDS = ["f32", "bf16", "int8-bf16", "int8-f32"]


def _decode_case(dev, kind, cursors, ps, h=4, d=64, seed=0, s=1,
                 max_len=DECODE_MAX_LEN):
    """One decode call's inputs (or an s-row window's) at max_len 1024:
    distinct pages up to each slot's last live page, out-of-range garbage
    past it (never read); int8 kinds quantize the pools with
    `quantize_kv`. Returns (args, kwargs) for `paged_attention` and its
    plain version."""
    from kubeflow_tpu_torch.ops.attention import quantize_kv

    dtype = torch.float32 if kind.endswith("f32") else torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    mp = max_len // ps
    live = [min((c + s - 1) // ps, mp - 1) + 1 if c < max_len else 0
            for c in cursors]
    num_pages = sum(live) + 8
    b = len(cursors)
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    pk = torch.randn((num_pages, ps, h, d), generator=g).to(dtype)
    pv = torch.randn((num_pages, ps, h, d), generator=g).to(dtype)
    table = torch.full((b, mp), 10**6, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=g).tolist()
    for i, n in enumerate(live):
        table[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    cur = torch.tensor(cursors, dtype=torch.int32)
    kw = {"dtype": dtype}
    if kind.startswith("int8"):
        (pk, sk), (pv, sv) = quantize_kv(pk), quantize_kv(pv)
        kw.update(k_scale=sk.to(dev), v_scale=sv.to(dev))
    return [t.to(dev) for t in (q, pk, pv, table, cur)], kw


def _check_decode(args, kw):
    """One call (decode, or a window when q has s > 1 rows) against the
    plain version; exactly one launch of the kernel that serves it."""
    tpa.reset_launch_counts()
    got = tpa.paged_attention(*args, **kw)
    want = tpa.paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    name = tpa.kernel_name(args[0].shape[1], quantized="k_scale" in kw)
    assert tpa.launch_counts == {**{k: 0 for k in tpa.launch_counts}, name: 1}
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[kw["dtype"]], rtol=0)
    return got


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kernel_at_split_edges(cuda, kind, ps):
    """Cursors on the split edges, the view's last key (1023) and a
    parked row, at page sizes 8, 16 and 32 (16, 8 and 4 pages a split);
    table entries past each live page are out of range and never read."""
    args, kw = _decode_case(cuda, kind, SPLIT_CURSORS + (DECODE_MAX_LEN,), ps)
    got = _check_decode(args, kw)
    assert not got[-1].any()


@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kernel_one_long_row(cuda, kind):
    """B = 1 at cursor 1023: eight splits of one row folded by its last."""
    _check_decode(*_decode_case(cuda, kind, (DECODE_MAX_LEN - 1,), 16))


@pytest.mark.parametrize("kind", ["bf16", "int8-bf16"])
def test_decode_kernel_all_slots_parked(cuda, kind):
    """Every slot parked: zeros, no page read (the table is all garbage)."""
    args, kw = _decode_case(cuda, kind, (DECODE_MAX_LEN,) * 3, 16)
    assert not _check_decode(args, kw).any()


def test_decode_kernel_is_deterministic(cuda):
    """The splits are folded in split order by whichever finishes last:
    repeated calls give bitwise the same output, and the workspace's
    tickets are back at 0 after each."""
    b, h, ps = len(SPLIT_CURSORS) * 4, 12, 16
    args, kw = _decode_case(cuda, "bf16", SPLIT_CURSORS * 4, ps, h=h)
    first = tpa.paged_attention(*args, **kw)
    for _ in range(20):
        again = tpa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again, first)
    nbytes = tpa._library().kft_paged_attention_workspace(
        1, b, h, 64, ps, DECODE_MAX_LEN // ps)
    tickets = tpa.paged_workspace(args[0].device,
                                  torch.cuda.current_stream().cuda_stream,
                                  nbytes)[: 4 * b * h]
    assert not tickets.any()


@pytest.mark.parametrize("s", [1, 5, 64], ids=["decode", "verify", "chunk"])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_a_ranks_heads_give_the_whole_pools_bits(cuda, kind, s):
    """The serving mesh's head shard (parallel/serving_mesh.py): each
    half of the heads of q and of the pool (values and int8 scales),
    walked by the kernel on its own, gives exactly those heads of the
    whole-pool call, bit for bit, at gpt_small's H = 12 (6 a rank). The
    grid's head coordinate and the splits, which follow only the page
    size and the table's width, do not move a head's bits."""
    args, kw = _decode_case(cuda, kind, _window_cursors(s), 16, h=12, s=s)
    whole = tpa.paged_attention(*args, **kw)
    q, pk, pv, table, cur = args
    for first in (0, 6):
        heads = slice(first, first + 6)
        part = {n: (t[:, :, heads].contiguous() if n.endswith("scale") else t)
                for n, t in kw.items()}
        got = tpa.paged_attention(q[:, :, heads].contiguous(),
                                  pk[:, :, heads].contiguous(),
                                  pv[:, :, heads].contiguous(), table, cur,
                                  **part)
        torch.cuda.synchronize()
        assert torch.equal(got, whole[:, :, heads])


# the window kernel: tiles of 64 query rows against splits of 128 keys
# (128 / page_size pages) folded by the tile's last live split
WINDOW_S = (5, 64, 65, 130)


def _window_cursors(s, view_len=DECODE_MAX_LEN):
    """Cursor 0, cursors whose first or last row sits on the split edges
    127, 128 and 129, one mid-view, one whose last row is the view's last
    position, and a parked slot."""
    edges = {c for e in (127, 128, 129) for c in (e, max(e - s + 1, 0))}
    return tuple(sorted(edges | {0, 700, view_len - s})) + (view_len,)


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("s", WINDOW_S)
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_window_kernel_at_split_edges(cuda, kind, s, ps):
    """s = 5 (the K+1 verify window), 64 (a chunk), 65 and 130 (two and
    three query tiles) at page sizes 8, 16 and 32, rows on the split
    edges; table entries past each live page are out of range and never
    read; the parked slot is zeros."""
    args, kw = _decode_case(cuda, kind, _window_cursors(s), ps, s=s)
    got = _check_decode(args, kw)
    assert not got[-1].any()


@pytest.mark.parametrize("ps", [1, 4, 256])
@pytest.mark.parametrize("kind", ["bf16", "int8-bf16", "f32"])
def test_window_kernel_at_other_page_sizes(cuda, kind, ps):
    """Pages under the 8-row swizzle atom (1, 4: full-width bf16 pages are
    then read by the block's threads, not by TMA) and over a split (256:
    cut into parts of 128 keys)."""
    args, kw = _decode_case(cuda, kind, _window_cursors(64), ps, s=64)
    assert not _check_decode(args, kw)[-1].any()


def test_window_kernel_refuses_a_page_it_cannot_cut(cuda):
    """A page over 128 keys that is not whole 128-key parts raises before
    any launch."""
    args, kw = _decode_case(cuda, "bf16", (0, 100), 192, s=8, max_len=768)
    tpa.reset_launch_counts()
    with pytest.raises(ValueError, match="page size"):
        tpa.paged_attention(*args, **kw)
    assert not any(tpa.launch_counts.values())


@pytest.mark.parametrize("s", [5, 64])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_window_kernel_over_a_long_view(cuda, kind, s):
    """A view of 8,192 positions (512 pages of 16 a slot, past the old
    kernel's ~7,000-position cap): up to 64 splits a tile, folded in
    order; 12 heads."""
    args, kw = _decode_case(cuda, kind, (8192 - s, 4000, 128, 8192), 16, h=12,
                            s=s, max_len=8192)
    assert not _check_decode(args, kw)[-1].any()


@pytest.mark.parametrize("kind", ["bf16", "int8-bf16", "f32"])
def test_window_kernel_is_deterministic(cuda, kind):
    """Each tile's splits are folded in split order by whichever finishes
    last: repeated calls give bitwise the same output, and the tiles'
    tickets are back at 0 after each."""
    s, h, ps = 130, 12, 16
    cursors = _window_cursors(s) * 2
    args, kw = _decode_case(cuda, kind, cursors, ps, h=h, s=s)
    first = tpa.paged_attention(*args, **kw)
    for _ in range(20):
        again = tpa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again, first)
    b, tiles = len(cursors), -(-s // 64)
    nbytes = tpa._library().kft_paged_attention_workspace(
        s, b, h, 64, ps, DECODE_MAX_LEN // ps)
    tickets = tpa.paged_workspace(args[0].device,
                                  torch.cuda.current_stream().cuda_stream,
                                  nbytes)[: 4 * b * h * tiles]
    assert not tickets.any()


@pytest.mark.parametrize("s", [1, 64])
def test_two_streams_keep_their_own_workspaces(cuda, s):
    """Two engines' calls of one shape on two streams at once: each stream
    has its own workspace, so one stream's splits never take the other's
    tickets; every output equals the plain version's."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cases = [_decode_case(cuda, "bf16", SPLIT_CURSORS * 4, 16, h=12, s=s,
                          seed=i) for i in range(2)]
    want = [tpa.paged_attention_reference(*a, **kw) for a, kw in cases]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(10):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(tpa.paged_attention(*cases[i][0], **cases[i][1]))
    torch.cuda.synchronize()
    for outs, w in zip(got, want):
        for out in outs:
            torch.testing.assert_close(out.float(), w.float(),
                                       atol=ATOL[torch.bfloat16], rtol=0)
    b = len(SPLIT_CURSORS) * 4
    nbytes = tpa._library().kft_paged_attention_workspace(
        s, b, 12, 64, 16, DECODE_MAX_LEN // 16)
    buffers = {tpa.paged_workspace(cuda, st.cuda_stream, nbytes).data_ptr()
               for st in streams}
    assert len(buffers) == 2


@pytest.mark.parametrize("bad", ["scale_dtype", "scale_shape", "no_scales",
                                 "scales_without_int8", "one_scale"])
def test_int8_kernel_raises_on_mismatched_scales(cuda, bad):
    """An int8 pool on the card reaches its kernel or raises; nothing
    falls back to the plain version."""
    q, pk, pv, table, cursors, sk, sv = _int8_case(cuda, 1, 4, 64,
                                                   torch.bfloat16)
    kw = {"k_scale": sk, "v_scale": sv}
    if bad == "scale_dtype":
        kw = {"k_scale": sk.float(), "v_scale": sv.float()}
    elif bad == "scale_shape":
        kw = {"k_scale": sk[:, :, :2].contiguous(),
              "v_scale": sv[:, :, :2].contiguous()}
    elif bad == "no_scales":
        kw = {}
    elif bad == "scales_without_int8":
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    elif bad == "one_scale":
        kw = {"k_scale": sk}
    tpa.reset_launch_counts()
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pk, pv, table, cursors, dtype=torch.bfloat16,
                            **kw)
    assert not any(tpa.launch_counts.values())


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, pk, pv, table, cursors = _case(cuda, 1, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        tpa.paged_attention(q[..., :48].contiguous(), pk[..., :48].contiguous(),
                            pv[..., :48].contiguous(), table, cursors,
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, pk, pv, table.long(), cursors,
                            dtype=torch.float32)


def test_engine_through_the_kernels_equals_generate(cuda):
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model("gpt_tiny", dtype=torch.float32, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 512, n) for n in (4, 7, 40)]
    tpa.reset_launch_counts()
    eng = DecodeEngine("tiny", model, device=cuda, num_slots=2, page_size=8,
                       paged_attention="kernel", prefill_buckets=(8, 16))
    try:
        got = [f.wait(120)["tokens"]
               for f in [eng.submit(r, 8) for r in rows]]
        stats = eng.stats()
    finally:
        eng.close()
    for r, toks in zip(rows, got):
        assert toks == generate(model, r[None], 8)[0, len(r):].tolist()
    assert stats["attention_kernel"] == "kernel"
    assert tpa.launch_counts["paged_decode"] == 2 * stats["decode_steps"]
    assert tpa.launch_counts["paged_window"] > 0


def test_int8_engine_through_the_kernels_equals_gather(cuda):
    """quantize="int8": greedy f32 tokens through the int8 kernels equal
    those through gather + dequant_kv (chunk windows and a prefix hit
    with copy-on-write included), and only the int8 kernels launch."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model("gpt_tiny", dtype=torch.float32, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    long_row = rng.integers(0, 512, 40)
    # the 40-token prompt twice: the second maps its committed pages
    rows = [rng.integers(0, 512, 4), long_row, long_row]
    got, launches = {}, {}
    for impl in ("kernel", "gather"):
        tpa.reset_launch_counts()
        eng = DecodeEngine("tiny", model, device=cuda, num_slots=2,
                           page_size=8, paged_attention=impl,
                           prefill_buckets=(8, 16), quantize="int8")
        try:
            got[impl] = [eng.generate_row(r, 8, timeout=120)["tokens"]
                         for r in rows]
            stats = eng.stats()
        finally:
            eng.close()
        launches[impl] = dict(tpa.launch_counts)
        assert stats["kv_pool_dtype"] == "int8" and stats["cow_copies"] == 1
    assert got["kernel"] == got["gather"]
    assert launches["kernel"]["paged_decode_int8"] > 0
    assert launches["kernel"]["paged_window_int8"] > 0
    assert launches["kernel"]["paged_decode"] == 0
    assert not any(launches["gather"].values())


# speculation's reads: the verify window (s = K+1) over 8 slots at
# gpt_small's geometry (12 heads x 64, page 16, max_len 1024): cursor 0,
# windows that cross a page (14, 15, 1019), one at max_len - 2 whose last
# rows lie past the window, a parked slot, mid-view rows
VERIFY_CURSORS = (0, 14, 15, 300, 1019, DECODE_MAX_LEN - 2, DECODE_MAX_LEN, 517)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_window_kernel_at_the_verify_windows(cuda, kind, k):
    """Every row against the plain version: rows past max_len see the
    whole view in both (their outputs are never emitted), the parked
    slot is zeros."""
    args, kw = _decode_case(cuda, kind, VERIFY_CURSORS, 16, h=12, s=k + 1)
    got = _check_decode(args, kw)
    assert not got[VERIFY_CURSORS.index(DECODE_MAX_LEN)].any()
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kernel_on_a_small_drafts_pool(cuda, kind):
    """The draft steps of a gpt_tiny-wide draft (4 heads x 16) at 8 slots,
    ragged cursors and a parked slot."""
    args, kw = _decode_case(cuda, kind, VERIFY_CURSORS, 16, h=4, d=16)
    got = _check_decode(args, kw)
    assert not got[VERIFY_CURSORS.index(DECODE_MAX_LEN)].any()


@pytest.mark.parametrize("draft", ["identical", "rolled"])
def test_drafted_engine_through_the_kernels_equals_generate(cuda, draft):
    """K = 3 through the kernels, f32: tokens equal `generate()` for a
    draft with the target's weights (accepts everything) and one with a
    rolled head (accepts nothing); every one-token read is a draft step
    and every window read a verify or a chunk window of either model."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model("gpt_tiny", dtype=torch.float32, device=cuda, seed=1)
    d = model if draft == "identical" else smoke.rolled_draft(torch, model)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 512, n) for n in (4, 7, 40)]
    tpa.reset_launch_counts()
    eng = DecodeEngine("tiny", model, device=cuda, num_slots=2, page_size=8,
                       paged_attention="kernel", prefill_buckets=(8, 16),
                       draft_model=d, num_draft_tokens=3)
    try:
        got = [f.wait(120)["tokens"]
               for f in [eng.submit(r, 8) for r in rows]]
        stats = eng.stats()
    finally:
        eng.close()
    for r, toks in zip(rows, got):
        assert toks == generate(model, r[None], 8)[0, len(r):].tolist()
    assert stats["accept_rate"] == (1.0 if draft == "identical" else 0.0)
    layers = model.cfg.num_layers
    # the 40-token prompt: one chunk window of 64 on each model
    assert tpa.launch_counts["paged_decode"] == stats["verify_steps"] * 4 * layers
    assert tpa.launch_counts["paged_window"] == (stats["verify_steps"] + 2) * layers
    assert stats["pages_in_use"] == stats["prefix_index_pages"]


DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _assert_rows_close(got, want, dtype, key, name=""):
    """chip_smoke's phase-6 check (at s = 1, where dQ is 0 up to summation
    order, the f32 tolerance floors each row's limit)."""
    err, worst, _ = smoke.flash_err(torch, got, want, DTYPE_NAME[dtype], key)
    assert worst <= 1.0, (f"{name}: a row's error is {worst:.3f} x its limit "
                          f"(max abs err {err:.3e})")


def _flash_case(dev, s, d, dtype, with_mask, seed=0):
    """q/k/v/dO [2, s, 3, d] and, with a mask, row 0 valid up to ~2/3
    of s and row 1 fully masked (zeros out, lse about -1e30). The bf16
    forward's and dQ's q tiles are 128 rows, dQ's key tiles and the dK/dV
    kernel's q tiles 64: the tests' S values sit on and beside those
    edges."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((2, s, 3, d), generator=g).to(dtype).to(dev)
                   for _ in range(4))
    mask = None
    if with_mask:
        mask = torch.zeros((2, s), dtype=torch.int32)
        mask[0, : max(1, (2 * s) // 3)] = 1
        mask = mask.to(dev)
    return q, k, v, do, mask


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 128, 129, 191, 255, 257, 1024,
                               4096])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_match_plain_versions(cuda, dtype, d, s, causal,
                                            with_mask):
    q, k, v, do, mask = _flash_case(cuda, s, d, dtype, with_mask)
    tol = smoke.FLASH_ATOL[DTYPE_NAME[dtype]]
    scale = tfa.default_scale(d)
    tfa.reset_launch_counts()
    o, lse = tfa.flash_fwd(q, k, v, mask, causal, scale)
    torch.cuda.synchronize()
    ro, rlse = tfa.flash_attention_reference(q, k, v, mask, causal, scale)
    _assert_rows_close(o, ro, dtype, "o", "o")
    torch.testing.assert_close(lse, rlse, atol=tol["lse"], rtol=0)
    # the backward from the reference's (o, lse): both sides then see the
    # same inputs
    got = tfa.flash_bwd(q, k, v, mask, ro, rlse, do, None, causal, scale)
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_reference(q, k, v, mask, ro, rlse, do,
                                             None, causal, scale)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        _assert_rows_close(g_, w_, dtype, "grad", name)
    assert tfa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                 "flash_bwd_dkv": 1}
    if with_mask:
        assert not o[1].any()
        assert (lse[1] < -1e29).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_autograd_with_lse_cotangent_matches_plain(cuda, dtype):
    """flash_attention(return_lse=True) end to end: the lse cotangent
    folds into delta on the kernels' side as in the plain formulas."""
    q, k, v, do, mask = _flash_case(cuda, 200, 64, dtype, True, seed=3)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = tfa.flash_attention(qs, ks, vs, mask=mask, causal=True,
                                 return_lse=True)
    dlse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(4)
                       ).to(cuda)
    torch.autograd.backward((o, lse), (do, dlse))
    torch.cuda.synchronize()
    ro, rlse = tfa.flash_attention_reference(q, k, v, mask, True)
    want = tfa.flash_attention_bwd_reference(q, k, v, mask, ro, rlse, do,
                                             dlse, True)
    for name, g_, w_ in zip(("dq", "dk", "dv"), (qs.grad, ks.grad, vs.grad),
                            want):
        _assert_rows_close(g_, w_, dtype, "grad", name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ring_rank_through_the_kernels_matches_plain(cuda, dtype):
    """A causal ring rank's block loop (parallel/ring_attention.py
    `ring_pass`, rank 2 of 4: its diagonal, two full blocks and an
    invisible one) through the kernels against the same loop on the
    plain versions (CPU tensors): the output and the q and K/V block
    gradients row by row. Each visible block's lse feeds the merge, so
    its cotangent is live in the kernels' backward; block 1's keys are
    all masked in row 1 (its lse about -1e30 merged beside visible
    blocks); the invisible block launches nothing and gets a zero
    cotangent."""
    from kubeflow_tpu_torch.parallel import ring_attention as rp

    n, idx, sb = 4, 2, 128
    g = torch.Generator().manual_seed(7)
    q, do = (torch.randn((2, sb, 3, 64), generator=g) for _ in range(2))
    kv = [torch.randn((2, 2, sb, 3, 64), generator=g) for _ in range(n)]
    masks = [torch.ones((2, sb), dtype=torch.int32) for _ in range(n)]
    masks[1][1] = 0

    def run(dev):
        qd = q.to(dtype).to(dev).requires_grad_()
        kvd = [t.to(dtype).to(dev).requires_grad_() for t in kv]
        md = [m.to(dev) for m in masks]

        def rotate(t, _kv, _m):
            src = (idx - t - 1) % n
            return kvd[src], md[src]

        o = rp.ring_pass(qd, kvd[idx], md[idx], idx, n, rotate, dtype=dtype,
                         causal=True, impl="flash")
        return o, torch.autograd.grad(o, [qd] + kvd, do.to(dtype).to(dev))

    tfa.reset_launch_counts()
    o, grads = run(cuda)
    torch.cuda.synchronize()
    launches = dict(tfa.launch_counts)
    want_o, want_grads = run("cpu")
    assert launches == {"flash_fwd": 3, "flash_bwd_dq": 3,
                        "flash_bwd_dkv": 3}
    _assert_rows_close(o.cpu(), want_o, dtype, "o", "o")
    names = ["dq"] + [f"dkv{j}" for j in range(n)]
    for name, g_, w_ in zip(names, grads, want_grads):
        _assert_rows_close(g_.cpu(), w_, dtype, "grad", name)
    assert not grads[1 + 3].any()


def test_flash_forward_refuses_unaligned_tensors(cuda):
    """TMA reads the bf16 tiles, and it needs 16-byte aligned addresses: a
    contiguous q that starts 2 bytes into its buffer raises before any
    launch."""
    q, k, v, _, _ = _flash_case(cuda, 64, 64, torch.bfloat16, False)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    unaligned = buf[1:].view(q.shape)
    unaligned.copy_(q)
    assert unaligned.is_contiguous() and unaligned.data_ptr() % 16
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(unaligned, k, v, None, True, tfa.default_scale(64))
    torch.cuda.synchronize()
    assert not any(tfa.launch_counts.values())


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, do, mask = _flash_case(cuda, 64, 64, torch.float32, True)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                      v[..., :48].contiguous(), None, True, 0.1)
    with pytest.raises(ValueError, match="int32"):
        tfa.flash_fwd(q, k, v, mask.long(), True, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_fwd(q.half(), k.half(), v.half(), None, True, 0.1)


# -- checkpoints on the card ----------------------------------------------------


def test_int8_quantizers_give_the_cpu_bits_on_the_card(cuda):
    """The weight and KV quantizers on CUDA tensors equal their CPU
    results bit for bit (the scale is an IEEE division on both)."""
    from kubeflow_tpu_torch.checkpointing.quantize import quantize_leaf_int8
    from kubeflow_tpu_torch.ops.attention import quantize_kv

    g = torch.Generator().manual_seed(9)
    w = torch.randn((768, 12, 64), generator=g) * 0.02
    for fn in (quantize_leaf_int8, quantize_kv):
        want = fn(w)
        got = fn(w.to(cuda))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def _ckpt_cfg(directory, **over):
    from kubeflow_tpu_torch.config.platform import TrainingConfig

    cfg = dict(model="gpt_tiny", seq_len=128, global_batch_size=2, steps=4,
               learning_rate=3e-4, warmup_steps=2, weight_decay=0.1,
               dtype="bfloat16", attention_impl="flash")
    cfg.update(over)
    return TrainingConfig(**cfg, checkpoint=dict(directory=str(directory),
                                                 interval_steps=2))


def test_gpt_small_save_restore_round_trip_on_the_card(cuda, tmp_path):
    """A gpt_small bf16 train state after one flash step: an async save,
    then a step at once (it updates the state in place on the card); the
    committed checkpoint restores onto the card as the pre-step state,
    bit for bit, params, AdamW moments and counts."""
    from kubeflow_tpu_torch.checkpointing import CheckpointManager
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = _ckpt_cfg(tmp_path, model="gpt_small", seq_len=256)
    tr = Trainer(cfg, device=cuda)
    state = tr.init_state()
    data = tr.task.synthetic_data()
    state, _ = tr.train_step(state, data.batch_at(0))
    before = {k: v.clone() for k, v in _flat(state.checkpoint_tree())}
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.save(state.step, state)
        state, _ = tr.train_step(state, data.batch_at(1))
        mgr.wait()
    fresh = Trainer(cfg, device=cuda).init_state()
    restored = CheckpointManager(str(tmp_path)).restore(fresh)
    assert restored.step == 1
    got = dict(_flat(restored.checkpoint_tree()))
    assert got.keys() == before.keys() and len(got) == 594
    for k, v in before.items():
        assert got[k].device == v.device and torch.equal(got[k], v), k


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v


def test_preempted_run_resumes_bitwise_on_the_card(cuda, tmp_path):
    """run_training through the flash kernels (bf16) preempted during
    step 2 and resumed equals an uninterrupted run bit for bit: losses,
    and every saved file of step 4."""
    from kubeflow_tpu_torch.runtime.train_run import run_training

    whole = run_training(_ckpt_cfg(tmp_path / "whole"), device=cuda)
    cut = run_training(_ckpt_cfg(tmp_path / "cut"), device=cuda,
                       stop_event=smoke.StopAfter(1))
    resumed = run_training(_ckpt_cfg(tmp_path / "cut"), restore=True,
                           device=cuda)
    assert cut["preempted"] and cut["final_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert smoke.same_step_files(str(tmp_path / "whole"),
                                 str(tmp_path / "cut"), 4) == 114


# -- KV tiers on the card (serving/kv_tiers.py) ----------------------------------


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_spilled_page_round_trips_bitwise_on_the_card(cuda, quantize):
    """A page gathered off a CUDA pool into host memory (bf16 values, or
    int8 with bf16 scales) and written onto another page reads back bit
    for bit, and the host copy is complete when the gather returns."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.models.gpt import (
        gather_pool_page,
        make_paged_pool,
        scatter_pool_page,
    )

    cfg = get_model("gpt_tiny", dtype=torch.bfloat16, device="meta").cfg
    pool = make_paged_pool(cfg, 8, 16, cuda, kv_quant=quantize)
    g = torch.Generator(device=cuda).manual_seed(0)
    for t in pool.tensors():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                  device=cuda))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    page = gather_pool_page(pool, 3, device="cpu")
    for t in pool.tensors():
        t[:, 3].zero_()  # the page's next writer: the host copy holds
    scatter_pool_page(pool, page, 6)
    for name, t in pool.fields().items():
        assert page[name].device.type == "cpu"
        assert torch.equal(t[:, 6].cpu(), page[name])


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_spill_readmit_through_the_kernels_equals_resident(cuda, quantize):
    """A CUDA engine whose 24-page pool spills into a host tier gives the
    always-resident engine's greedy f32 tokens through the kernels, with
    pages re-admitted from the tier; then its store preloads into a new
    engine whose first request is a prefix hit with the same tokens."""
    import tempfile

    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model("gpt_tiny", dtype=torch.float32, device=cuda, seed=1)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 24)
    row_a = np.concatenate([shared, rng.integers(0, 512, 8)])
    row_b = np.concatenate([shared, rng.integers(0, 512, 8)])
    traffic = [row_a, *(rng.integers(0, 512, 32) for _ in range(6)), row_b,
               row_a]

    def engine(num_pages, **kw):
        return DecodeEngine("tiny", model, device=cuda, num_slots=2,
                            page_size=8, num_pages=num_pages,
                            prefill_buckets=(8, 32), paged_attention="kernel",
                            quantize=quantize, **kw)

    got = {}
    with tempfile.TemporaryDirectory() as store:
        for kind, eng in (("resident", engine(128)),
                          ("tiered", engine(24, kv_host_bytes=64 << 20,
                                            kv_persist_dir=store))):
            tpa.reset_launch_counts()
            try:
                got[kind] = [eng.generate_row(r, 6, timeout=120)["tokens"]
                             for r in traffic]
                stats = eng.stats()
            finally:
                eng.close()
        launches = dict(tpa.launch_counts)
        warm = engine(24, kv_persist_dir=store)
        try:
            again = warm.generate_row(row_b, 6, timeout=120)["tokens"]
            warm_stats = warm.stats()
        finally:
            warm.close()
    assert got["tiered"] == got["resident"]
    assert stats["kv_spill_pages"] > 0 and stats["kv_spill_hits"] == 4
    suffix = "_int8" if quantize == "int8" else ""
    assert launches["paged_decode" + suffix] > 0
    assert launches["paged_window" + suffix] > 0
    assert warm_stats["kv_persisted_chains"] > 0
    assert warm_stats["prefix_hit_tokens"] > 0
    assert again == got["resident"][-2]
