"""The port's paged attention (kubeflow_tpu_torch/ops/paged_attention.py).

On CPU tensors `paged_attention` runs its plain version; it is held
against the JAX Pallas kernel (interpret mode off-TPU, as the JAX
package's own tests run it) and against the JAX gather read path, in
f32: atol = rtol = 1e-5 (summation order only). Rows parked at max_len
are excluded (their output is never read). The CUDA kernels themselves
are compared with the plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops.attention import (  # noqa: E402
    dense_attention as jdense,
    paged_kv_view as jview,
)
from kubeflow_tpu.ops.paged_attention import (  # noqa: E402
    paged_attention as jpaged,
)
from kubeflow_tpu_torch.ops import paged_attention as tpa  # noqa: E402

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
    assert tpa.launch_counts == {"paged_decode": 0, "paged_window": 0}
    assert tpa.kernel_name(1) == "paged_decode"
    assert tpa.kernel_name(64) == "paged_window"


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
