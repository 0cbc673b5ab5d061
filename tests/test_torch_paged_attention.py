"""The port's paged attention (kubeflow_tpu_torch/ops/paged_attention.py).

On CPU tensors `paged_attention` runs its plain version; it is held
against the JAX Pallas kernel (interpret mode off-TPU, as the JAX
package's own tests run it) and against the JAX gather read path, in
f32: atol = rtol = 1e-5 (summation order only). Rows parked at max_len
are excluded (their output is never read). The int8 read (int8 pools
from `quantize_kv`, bf16 scales) is held the same way against the JAX
kernel's quantized branch and the JAX int8 gather path (gather,
`dequant_kv`, dense attention), at the same tolerance. The CUDA kernels
themselves are compared with the plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops.attention import (  # noqa: E402
    dense_attention as jdense,
    dequant_kv as jdequant,
    paged_kv_view as jview,
)
from kubeflow_tpu.ops.paged_attention import (  # noqa: E402
    paged_attention as jpaged,
)
from kubeflow_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from kubeflow_tpu_torch.ops.attention import (  # noqa: E402
    paged_kv_view,
    quantize_kv,
    scale_for,
)

ATOL = RTOL = 1e-5
H, D, NUM_PAGES, MAX_LEN = 3, 16, 40, 64


def _case(s, ps, seed=0):
    """Ragged cursors: 0, a page boundary (ps - 1, ps), max_len - 1 and one
    parked row (max_len); each slot's table is a shuffled page set."""
    rng = np.random.default_rng(seed + 10 * s + ps)
    mp = MAX_LEN // ps
    cursors = np.array([0, ps - 1, ps, MAX_LEN - 1, MAX_LEN, 21], np.int32)
    b = cursors.size
    q = rng.standard_normal((b, s, H, D)).astype(np.float32)
    pk = rng.standard_normal((NUM_PAGES, ps, H, D)).astype(np.float32)
    pv = rng.standard_normal((NUM_PAGES, ps, H, D)).astype(np.float32)
    table = np.stack([rng.permutation(NUM_PAGES)[:mp] for _ in range(b)])
    return q, pk, pv, table.astype(np.int32), cursors


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port(case):
    q, pk, pv, table, cursors = _torch(*case)
    return tpa.paged_attention(q, pk, pv, table, cursors, dtype=torch.float32)


def _live(out, cursors):
    return out[cursors < MAX_LEN]


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 4, 16])
def test_plain_path_matches_jax_pallas_kernel(s, ps):
    case = _case(s, ps)
    want = np.asarray(jpaged(*(jnp.asarray(a) for a in case), dtype=jnp.float32))
    got = _port(case).numpy()
    cursors = case[-1]
    np.testing.assert_allclose(
        _live(got, cursors), _live(want, cursors), atol=ATOL, rtol=RTOL
    )


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 4, 16])
def test_plain_path_matches_jax_gather_path(s, ps):
    """The JAX model's gather read: view through the table, then dense
    attention with the per-query visibility mask (models/gpt.py)."""
    q, pk, pv, table, cursors = case = _case(s, ps, seed=1)
    view_len = table.shape[1] * ps
    q_pos = cursors[:, None] + np.arange(s)[None, :]
    visible = np.arange(view_len)[None, None, :] <= q_pos[:, :, None]
    want = np.asarray(jdense(
        jnp.asarray(q), jview(jnp.asarray(pk), jnp.asarray(table)),
        jview(jnp.asarray(pv), jnp.asarray(table)),
        mask=jnp.asarray(visible), dtype=jnp.float32, causal=False,
    ))
    got = _port(case).numpy()
    np.testing.assert_allclose(
        _live(got, cursors), _live(want, cursors), atol=ATOL, rtol=RTOL
    )


@pytest.mark.parametrize("s", [1, 4])
def test_stale_table_entries_past_the_live_page_are_never_read(s):
    """Entries past a slot's last live page may be stale, even out of
    range: the plain version, like the kernels, never dereferences them."""
    q, pk, pv, table, cursors = case = _case(s, 8, seed=2)
    live = np.minimum((cursors + s - 1) // 8, table.shape[1] - 1)
    stale = table.copy()
    for b, last in enumerate(live):
        stale[b, last + 1 :] = 10**6
    want = _port(case)
    got = _port((q, pk, pv, stale, cursors))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 4])
def test_parked_rows_are_zeros_and_read_nothing(s):
    """A parked slot (cursor max_len, past the window) reads no page: its
    rows are zeros whatever its table holds, and the live rows are
    unchanged by it."""
    q, pk, pv, table, cursors = case = _case(s, 8, seed=3)
    parked = cursors >= MAX_LEN
    want = _port(case)
    stale = table.copy()
    stale[parked] = 10**6
    got = _port((q, pk, pv, stale, cursors))
    assert parked.any()
    assert not got[torch.from_numpy(parked)].any()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_path_counts_no_launches():
    tpa.reset_launch_counts()
    _port(_case(1, 8))
    _port(_case(4, 8))
    _port_int8(_int8_case(1, 8))
    assert tpa.launch_counts == {"paged_decode": 0, "paged_window": 0,
                                 "paged_decode_int8": 0,
                                 "paged_window_int8": 0}
    assert tpa.kernel_name(1) == "paged_decode"
    assert tpa.kernel_name(64) == "paged_window"
    assert tpa.kernel_name(1, quantized=True) == "paged_decode_int8"
    assert tpa.kernel_name(8, quantized=True) == "paged_window_int8"


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "table_dtype",
                                 "pool_shape", "cursor_shape"])
def test_kernel_input_checks_raise(bad):
    """What the CUDA wrapper refuses before any launch."""
    q, pk, pv, table, cursors = _torch(*_case(1, 8))
    dtype = torch.float32
    if bad == "head_dim":
        q, pk, pv = q[..., :12], pk[..., :12], pv[..., :12]
    elif bad == "dtype":
        dtype = torch.float16
        q, pk, pv = q.half(), pk.half(), pv.half()
    elif bad == "table_dtype":
        table = table.long()
    elif bad == "pool_shape":
        pv = pv[:, :, :2]
    elif bad == "cursor_shape":
        cursors = cursors[:3]
    with pytest.raises(ValueError):
        tpa._check_cuda_inputs(q.contiguous(), pk.contiguous(),
                               pv.contiguous(), table, cursors, dtype)


# -- int8 pools ----------------------------------------------------------------


def _quantize_case(case):
    """A case with both pools quantized by the port's `quantize_kv`
    (bitwise the JAX package's: tests/test_torch_quantize.py): q, int8
    pools, table, cursors, and the bf16 scales as float32 numpy (exact)."""
    q, pk, pv, table, cursors = case
    (qk, sk), (qv, sv) = (quantize_kv(torch.from_numpy(p)) for p in (pk, pv))
    return (q, qk.numpy(), qv.numpy(), table, cursors,
            sk.float().numpy(), sv.float().numpy())


def _int8_case(s, ps, seed=0):
    """`_case` with both pools quantized (`_quantize_case`)."""
    return _quantize_case(_case(s, ps, seed))


def _port_int8(case):
    q, pk, pv, table, cursors, sk, sv = _torch(*case)
    return tpa.paged_attention(q, pk, pv, table, cursors, dtype=torch.float32,
                               k_scale=sk.bfloat16(), v_scale=sv.bfloat16())


def _jax_int8(case):
    q, pk, pv, table, cursors, sk, sv = (jnp.asarray(a) for a in case)
    return q, pk, pv, table, cursors, sk.astype(jnp.bfloat16), sv.astype(
        jnp.bfloat16)


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 8])
def test_int8_plain_path_matches_jax_pallas_kernel(s, ps):
    """The JAX kernel's quantized branch (dequant fused on the page walk),
    interpret mode."""
    case = _int8_case(s, ps, seed=4)
    q, pk, pv, table, cursors, sk, sv = _jax_int8(case)
    want = np.asarray(jpaged(q, pk, pv, table, cursors, dtype=jnp.float32,
                             k_scale=sk, v_scale=sv))
    got = _port_int8(case).numpy()
    np.testing.assert_allclose(_live(got, case[4]), _live(want, case[4]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 8])
def test_int8_plain_path_matches_jax_gather_path(s, ps):
    """The JAX model's int8 gather read: values and scales viewed through
    the table, `dequant_kv`, then dense attention with the per-query
    mask (kubeflow_tpu/models/gpt.py)."""
    case = _int8_case(s, ps, seed=5)
    q, pk, pv, table, cursors, sk, sv = _jax_int8(case)
    view_len = table.shape[1] * ps
    q_pos = case[4][:, None] + np.arange(s)[None, :]
    visible = np.arange(view_len)[None, None, :] <= q_pos[:, :, None]
    want = np.asarray(jdense(
        q, jdequant(jview(pk, table), jview(sk, table), jnp.float32),
        jdequant(jview(pv, table), jview(sv, table), jnp.float32),
        mask=jnp.asarray(visible), dtype=jnp.float32, causal=False,
    ))
    got = _port_int8(case).numpy()
    np.testing.assert_allclose(_live(got, case[4]), _live(want, case[4]),
                               atol=ATOL, rtol=RTOL)


def test_int8_parked_and_stale_entries_are_never_read():
    """As at full width: parked rows are zeros, and table entries past a
    slot's last live page (or a parked slot's whole row) never matter."""
    case = _int8_case(4, 8, seed=6)
    table, cursors = case[3], case[4]
    want = _port_int8(case)
    stale = table.copy()
    live = np.minimum((cursors + 3) // 8, table.shape[1] - 1)
    for b, last in enumerate(live):
        stale[b, last + 1:] = 10**6
    stale[cursors >= MAX_LEN] = 10**6
    got = _port_int8(case[:3] + (stale,) + case[4:])
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not got[torch.from_numpy(cursors >= MAX_LEN)].any()


@pytest.mark.parametrize("bad", ["scale_dtype", "scale_shape", "no_scales",
                                 "scales_without_int8", "one_scale"])
def test_int8_kernel_input_checks_raise(bad):
    """What the CUDA wrapper refuses before an int8 launch: an int8 pool
    always reaches the int8 kernel with matching bf16 scales, or raises."""
    q, pk, pv, table, cursors, sk, sv = _torch(*_int8_case(1, 8))
    sk, sv = sk.bfloat16(), sv.bfloat16()
    dtype = torch.float32
    if bad == "scale_dtype":
        sk, sv = sk.float(), sv.float()
    elif bad == "scale_shape":
        sk, sv = sk[:, :, :2].contiguous(), sv[:, :, :2].contiguous()
    elif bad == "no_scales":
        sk = sv = None
    elif bad == "scales_without_int8":
        pk, pv = pk.float(), pv.float()
    elif bad == "one_scale":
        sv = None
    with pytest.raises(ValueError):
        tpa._check_cuda_inputs(q, pk, pv, table, cursors, dtype, sk, sv)
    # the same inputs with matching scales pass
    q, pk, pv, table, cursors, sk, sv = _torch(*_int8_case(1, 8))
    tpa._check_cuda_inputs(q, pk, pv, table, cursors, dtype, sk.bfloat16(),
                           sv.bfloat16())


# -- the decode kernel's split over pages ---------------------------------------
# The CUDA decode kernel cuts each slot's visible keys into splits of 128
# keys (128 / page_size whole pages) and folds the splits' softmax partials
# (ops/csrc/paged_attention.cu). Its yardstick, the plain version, is held
# against the JAX kernel at cursors on those edges; the split arithmetic
# itself is rebuilt here and held against the plain version.

SPLIT_MAX_LEN, SPLIT_KEYS = 256, 128
# the split edges at page 16 and the view's last key
SPLIT_CURSORS = (127, 128, 129, SPLIT_MAX_LEN - 1)


def _split_case(cursors, ps, seed=0, s=1):
    """Decode inputs (or an s-row window's) at max_len 256: the given
    cursors and a parked row (256); each slot's table a shuffled page
    set."""
    rng = np.random.default_rng(seed + ps + sum(cursors))
    cursors = np.array(tuple(cursors) + (SPLIT_MAX_LEN,), np.int32)
    b, mp = cursors.size, SPLIT_MAX_LEN // ps
    q = rng.standard_normal((b, s, H, D)).astype(np.float32)
    pk = rng.standard_normal((NUM_PAGES, ps, H, D)).astype(np.float32)
    pv = rng.standard_normal((NUM_PAGES, ps, H, D)).astype(np.float32)
    table = np.stack([rng.permutation(NUM_PAGES)[:mp] for _ in range(b)])
    return q, pk, pv, table.astype(np.int32), cursors


@pytest.mark.parametrize("cursor", SPLIT_CURSORS)
def test_plain_decode_matches_jax_pallas_kernel_at_split_edges(cursor):
    """`test_plain_path_matches_jax_pallas_kernel` at s = 1, page 16, at
    cursors on the decode kernel's split edges and the view's last key."""
    case = _split_case((cursor,), 16)
    want = np.asarray(jpaged(*(jnp.asarray(a) for a in case), dtype=jnp.float32))
    got = _port(case).numpy()
    live = case[-1] < SPLIT_MAX_LEN
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cursor", SPLIT_CURSORS)
def test_int8_plain_decode_matches_jax_pallas_kernel_at_split_edges(cursor):
    """`test_int8_plain_path_matches_jax_pallas_kernel` at s = 1, page 16,
    at the split edges."""
    case = _quantize_case(_split_case((cursor,), 16, seed=1))
    q, pk, pv, table, cursors, sk, sv = _jax_int8(case)
    want = np.asarray(jpaged(q, pk, pv, table, cursors, dtype=jnp.float32,
                             k_scale=sk, v_scale=sv))
    got = _port_int8(case).numpy()
    live = case[4] < SPLIT_MAX_LEN
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)


def _split_decode(q, pk, pv, table, cursors, ps):
    """The decode kernel's split arithmetic in plain f32 torch: each live
    slot's visible keys cut into splits of 128 // ps pages; per split
    m_i = max s, l_i = Σ exp(s − m_i), o_i = Σ exp(s − m_i)·v; then the
    splits folded in split order with a running max: m' = max(m, m_i),
    l' = l·exp(m − m') + l_i·exp(m_i − m'), o' likewise; out = o / l.
    Parked slots are zeros."""
    b, _, h, d = q.shape
    kps = max(1, SPLIT_KEYS // ps) * ps
    k_view, v_view = paged_kv_view(pk, table), paged_kv_view(pv, table)
    view_len = k_view.shape[1]
    out = torch.zeros_like(q)
    for i in range(b):
        n = int(cursors[i]) + 1
        if n > view_len:
            continue
        s = torch.einsum("hd,khd->hk", q[i, 0], k_view[i, :n]) / scale_for(
            d, torch.float32)
        parts = []
        for k0 in range(0, n, kps):
            k1 = min(k0 + kps, n)
            m_i = s[:, k0:k1].amax(-1)
            e = torch.exp(s[:, k0:k1] - m_i[:, None])
            parts.append((m_i, e.sum(-1),
                          torch.einsum("hk,khd->hd", e, v_view[i, k0:k1])))
        m = torch.full((h,), float("-inf"))
        l, o = torch.zeros(h), torch.zeros((h, d))
        for m_i, l_i, o_i in parts:
            m_new = torch.maximum(m, m_i)
            a, f = torch.exp(m - m_new), torch.exp(m_i - m_new)
            l = l * a + l_i * f
            o = o * a[:, None] + o_i * f[:, None]
            m = m_new
        out[i, 0] = o / l[:, None]
    return out


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_split_decode_arithmetic_matches_plain_version(ps):
    """The splits' partials folded in split order give the plain
    version's output in f32 within 1e-6 (summation order only), at the
    split edges, the view's last key, a one-key row and a parked row."""
    case = _split_case((0,) + SPLIT_CURSORS, ps, seed=2)
    q, pk, pv, table, cursors = _torch(*case)
    got = _split_decode(q, pk, pv, table, cursors, ps)
    want = tpa.paged_attention_reference(q, pk, pv, table, cursors,
                                         dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_decode_workspace_is_made_once_per_device_and_size():
    """The kernels' workspace: zeroed at a shape's first call, the same
    buffer at every later one on that stream (a decode step allocates
    nothing new), another buffer for another size."""
    dev = torch.device("cpu")
    first = tpa.paged_workspace(dev, 0, 1040)
    assert first.dtype == torch.uint8 and first.numel() == 1040
    assert not first.any()
    assert tpa.paged_workspace(dev, 0, 1040) is first
    other = tpa.paged_workspace(dev, 0, 2080)
    assert other is not first and other.numel() == 2080


@pytest.mark.parametrize("nbytes", [1040, 4096])
def test_workspace_is_keyed_by_stream(nbytes):
    """Two streams (two engines, or a graph replayed on a side stream)
    get two buffers of one size, whose tickets then never count each
    other's splits; the same stream gets the same buffer back, and so does
    each stream after the other's calls."""
    dev = torch.device("cpu")
    a = tpa.paged_workspace(dev, 101, nbytes)
    b = tpa.paged_workspace(dev, 202, nbytes)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert a.numel() == b.numel() == nbytes and not a.any() and not b.any()
    assert tpa.paged_workspace(dev, 101, nbytes) is a
    assert tpa.paged_workspace(dev, 202, nbytes) is b
    assert tpa.paged_workspace(torch.device("meta"), 101, nbytes) is not a


# -- the window kernel's split over pages ---------------------------------------
# The CUDA window kernel takes 64 query rows a block and cuts the keys the
# tile sees (up to its last row's position) into the same splits of 128
# keys, folded in split order by the tile's last live split
# (ops/csrc/paged_attention.cu). The plain version is held against the JAX
# `_mq_kernel` where rows land on the split edges; the split arithmetic is
# rebuilt here and held against the plain version.

WINDOW_ROWS = 64
# per window size: cursors whose first or last row sits on 127, 128, 129
WINDOW_EDGE_CURSORS = {5: (123, 124, 125, 127, 128, 129),
                       64: (64, 65, 66, 127, 128, 129),
                       130: (0, 127, 128, 129)}


@pytest.mark.parametrize("s", [5, 64])
def test_plain_window_matches_jax_pallas_kernel_at_split_edges(s):
    """`test_plain_path_matches_jax_pallas_kernel` at page 16 for the
    verify window (s = 5) and a chunk window (s = 64), rows on the window
    kernel's split edges, a parked row."""
    case = _split_case(WINDOW_EDGE_CURSORS[s], 16, s=s)
    want = np.asarray(jpaged(*(jnp.asarray(a) for a in case), dtype=jnp.float32))
    got = _port(case).numpy()
    live = case[-1] < SPLIT_MAX_LEN
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [5, 64])
def test_int8_plain_window_matches_jax_pallas_kernel_at_split_edges(s):
    """The same over int8 pools, against the JAX kernel's quantized
    branch."""
    case = _quantize_case(_split_case(WINDOW_EDGE_CURSORS[s], 16, seed=1, s=s))
    q, pk, pv, table, cursors, sk, sv = _jax_int8(case)
    want = np.asarray(jpaged(q, pk, pv, table, cursors, dtype=jnp.float32,
                             k_scale=sk, v_scale=sv))
    got = _port_int8(case).numpy()
    live = case[4] < SPLIT_MAX_LEN
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)


def _split_window(q, pk, pv, table, cursors, ps, dtype):
    """The window kernel's arithmetic in plain torch: tiles of 64 query
    rows; each tile's visible keys (up to its last row's position, inside
    the view) cut into splits of 128 // ps pages; per split and row
    m_i = max s, p = exp(s − m_i) in f32, l_i = Σ p, o_i = Σ round(p)·v (p
    rounded to `dtype` for the product, sums in f32); a row that sees no
    key of a split gives (−1e30, 0, 0); the tile's live splits folded in
    split order with a running max; out = o / l rounded to `dtype`. A tile
    that one split covers rounds the normalised p / l_i instead, as the
    JAX kernel does, and its o_i is the output. Scores as the kernels take
    them: the f32 dot rounded to `dtype`, divided by sqrt(D) in `dtype`.
    Parked slots are zeros."""
    b, s, h, d = q.shape
    kps = max(1, SPLIT_KEYS // ps) * ps
    k_view = paged_kv_view(pk, table).float()
    v_view = paged_kv_view(pv, table).float()
    view_len = k_view.shape[1]
    scale = scale_for(d, dtype)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for i in range(b):
        cur = int(cursors[i])
        if cur >= view_len:
            continue
        for j0 in range(0, s, WINDOW_ROWS):
            rows = min(WINDOW_ROWS, s - j0)
            last = min(cur + j0 + rows - 1, view_len - 1)
            seen = (cur + j0 + torch.arange(rows)).clamp_max(view_len - 1)
            qq = q[i, j0:j0 + rows].float()
            m = torch.full((rows, h), float("-inf"))
            l, o = torch.zeros((rows, h)), torch.zeros((rows, h, d))
            single = last < kps
            for k0 in range(0, last // kps * kps + 1, kps):
                k1 = min(k0 + kps, view_len)
                sc = torch.einsum("rhd,khd->rhk", qq, k_view[i, k0:k1])
                sc = ((sc.to(dtype) / scale).to(dtype)).float()
                hidden = torch.arange(k0, k1)[None, :] > seen[:, None]
                sc = sc.masked_fill(hidden[:, None, :], float("-inf"))
                m_i = sc.amax(-1).clamp_min(-1e30)
                p = torch.exp(sc - m_i[..., None])
                weights = p / p.sum(-1, keepdim=True) if single else p
                o_i = torch.einsum("rhk,khd->rhd", weights.to(dtype).float(),
                                   v_view[i, k0:k1])
                if single:
                    out[i, j0:j0 + rows] = o_i
                    break
                m_new = torch.maximum(m, m_i)
                a, f = torch.exp(m - m_new), torch.exp(m_i - m_new)
                l = l * a + p.sum(-1) * f
                o = o * a[..., None] + o_i * f[..., None]
                m = m_new
            else:
                out[i, j0:j0 + rows] = o / l[..., None]
    return out.to(dtype)


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("s", [5, 64, 130])
def test_split_window_arithmetic_matches_plain_version(s, ps):
    """In f32 the tiles' splits folded in split order give the plain
    version's output within 1e-6 (summation order only): one tile (s = 5,
    64) and three (s = 130), rows on the split edges, a parked row."""
    case = _split_case(WINDOW_EDGE_CURSORS[s], ps, seed=3, s=s)
    q, pk, pv, table, cursors = _torch(*case)
    got = _split_window(q, pk, pv, table, cursors, ps, torch.float32)
    want = tpa.paged_attention_reference(q, pk, pv, table, cursors,
                                         dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("s", [5, 64])
def test_split_window_bf16_probabilities_stay_within_tolerance(s):
    """In bf16 the kernel rounds the un-normalised p of each split to bf16
    for its tensor-core product, where the JAX kernel rounds the
    normalised probabilities (parity contract (c)): the rebuilt arithmetic
    stays within the card tests' bf16 tolerance (2e-2) of the plain
    version in bf16, on the same bf16 inputs."""
    case = _split_case(WINDOW_EDGE_CURSORS[s], 16, seed=4, s=s)
    q, pk, pv, table, cursors = _torch(*case)
    q, pk, pv = (t.bfloat16() for t in (q, pk, pv))
    got = _split_window(q, pk, pv, table, cursors, 16, torch.bfloat16)
    want = tpa.paged_attention_reference(q, pk, pv, table, cursors,
                                         dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
