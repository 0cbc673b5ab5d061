"""The port's dense attention and paged-KV helpers
(kubeflow_tpu_torch/ops/attention.py) against the JAX package's, on the
same seeded numpy inputs, in f32 on the CPU. Tolerance: atol = rtol =
1e-5 (f32 summation order only); the paged helpers move bits and must
match exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import attention as jattn  # noqa: E402
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402

ATOL = RTOL = 1e-5


def _qkv(rng, b=2, s=9, h=3, d=8):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("kind", ["none", "padding_2d", "visible_3d", "causal",
                                  "causal_padding"])
def test_dense_attention_matches_jax(kind):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    b, s = q.shape[:2]
    mask, causal = None, False
    if kind in ("padding_2d", "causal_padding"):
        mask = np.ones((b, s), bool)
        mask[1, 6:] = False
    if kind == "visible_3d":
        mask = rng.random((b, s, s)) < 0.6
        mask[:, :, 0] = True  # every row sees key 0, as in the model
    if kind.startswith("causal"):
        causal = True
    want = np.asarray(jattn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask),
        dtype=jnp.float32, causal=causal,
    ))
    got = tattn.dense_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask),
        dtype=torch.float32, causal=causal,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_bf16_mask_value_rounds_to_neg_inf_harmlessly():
    """f32-min in a bf16 score tensor is -inf; with key 0 visible every
    softmax row stays finite."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng))
    mask = torch.zeros((2, 9), dtype=torch.bool)
    mask[:, 0] = True
    out = tattn.dense_attention(q, k, v, mask=mask, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    # one visible key: the output is that key's value row, exactly
    torch.testing.assert_close(out, v[:, :1].expand_as(out), atol=0, rtol=0)


def test_paged_kv_view_matches_jax():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((10, 4, 3, 8)).astype(np.float32)
    table = np.stack([rng.permutation(10)[:5] for _ in range(3)]).astype(
        np.int32
    )
    want = np.asarray(jattn.paged_kv_view(jnp.asarray(pool), jnp.asarray(table)))
    got = tattn.paged_kv_view(torch.from_numpy(pool), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (3, 20, 3, 8)


@pytest.mark.parametrize("s", [1, 3, 6])
def test_paged_kv_update_matches_jax_with_parked_rows(s):
    """Rows parked at max_len (and a window running past the view) write
    nothing; several parked rows share the JAX drop sentinel, and the
    port must not assume unique indices. Updates happen in place."""
    rng = np.random.default_rng(3 + s)
    num_pages, ps, h, d, mp = 12, 4, 2, 8, 4
    view_len = mp * ps
    pk = rng.standard_normal((num_pages, ps, h, d)).astype(np.float32)
    pv = rng.standard_normal((num_pages, ps, h, d)).astype(np.float32)
    perm = rng.permutation(num_pages)
    table = np.zeros((4, mp), np.int32)
    table[0] = perm[:mp]
    table[1] = perm[mp : 2 * mp]
    # rows 2 and 3 are parked: their stale table rows alias live pages
    table[2] = perm[:mp]
    table[3] = perm[:mp]
    cursors = np.array([3, view_len - 2, view_len, view_len], np.int32)
    kn = rng.standard_normal((4, s, h, d)).astype(np.float32)
    vn = rng.standard_normal((4, s, h, d)).astype(np.float32)
    jk, jv = jattn.paged_kv_update(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(table), jnp.asarray(cursors),
    )
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out_k, out_v = tattn.paged_kv_update(
        tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(table), torch.from_numpy(cursors),
    )
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
