"""The port's flash attention (kubeflow_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels, run as their own tests run them
on the CPU (interpret mode), on the same numpy inputs. On CPU tensors the
port runs its plain versions, the arithmetic its CUDA kernels implement.

Tolerances (f32): o and lse atol 2e-5 (one-pass softmax here, blockwise
online softmax over 128-key blocks there: summation order only);
gradients atol 1e-4 (the same, through three more products). S = 127 and
129 sit one row either side of a 128-row tile edge (the Pallas blocks and
the card's bf16 forward tiles), S = 200 a partly filled second tile."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash,
)
from kubeflow_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ATOL = 2e-5
GRAD_ATOL = 1e-4
B, H, D = 3, 2, 16

VARIANTS = {  # (causal, with a key mask)
    "full": (False, False),
    "keymask": (False, True),
    "causal": (True, False),
    "causal_keymask": (True, True),
}


def _inputs(s, seed=0):
    """q, k, v and a key mask: row 0 unpadded, row 1 valid up to s/2,
    row 2 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, H, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, s), np.int32)
    mask[1, s // 2:] = 0
    mask[2] = 0
    return q, k, v, mask


def _jax_side(q, k, v, mask, causal, with_lse_loss):
    """JAX o, lse and the grads of sum(o²) (+ sum(lse)) — 128-key blocks,
    so S=200 runs as two padded blocks."""
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o, lse = jax_flash(q, k, v, mask=jmask, causal=causal, block_q=128,
                           block_k=128, return_lse=True)
        total = jnp.sum(o ** 2) + (jnp.sum(lse) if with_lse_loss else 0.0)
        return total, (o, lse)

    grads, (o, lse) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port_side(q, k, v, mask, causal, with_lse_loss):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = tfa.flash_attention(tq, tk, tv, mask=tmask, causal=causal,
                                 return_lse=True)
    total = (o ** 2).sum() + (lse.sum() if with_lse_loss else 0.0)
    total.backward()
    return (o.detach().numpy(), lse.detach().numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("s", [64, 127, 129, 200])
def test_forward_and_grads_match_pallas(s, variant):
    causal, with_mask = VARIANTS[variant]
    q, k, v, mask = _inputs(s)
    mask = mask if with_mask else None
    want_o, want_lse, want_g = _jax_side(q, k, v, mask, causal, False)
    tfa.reset_launch_counts()
    got_o, got_lse, got_g = _port_side(q, k, v, mask, causal, False)
    np.testing.assert_allclose(got_o, want_o, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0, err_msg=name)
    # CPU tensors run the plain versions: no kernel was launched
    assert not any(tfa.launch_counts.values())
    if with_mask:
        # a fully masked row: zeros out, JAX's lse (m + log(1e-30) ≈ -1e30)
        assert not got_o[2].any()
        np.testing.assert_array_equal(got_lse[2], want_lse[2])
        assert (got_lse[2] < -1e29).all()


@pytest.mark.parametrize("s", [64, 127, 129, 200])
def test_lse_cotangent_folds_into_delta_like_pallas(s):
    """Gradients of sum(o²) + sum(lse), causal + key mask: the lse
    cotangent reaches q and k through delta."""
    q, k, v, mask = _inputs(s, seed=1)
    want_o, want_lse, want_g = _jax_side(q, k, v, mask, True, True)
    got_o, got_lse, got_g = _port_side(q, k, v, mask, True, True)
    np.testing.assert_allclose(got_o, want_o, atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
def test_bwd_reference_equals_autograd_of_the_forward_reference(with_dlse):
    """The explicit backward formulas equal torch.autograd through the
    plain forward (f32, atol 1e-5: the same products in another order)."""
    q, k, v, mask = _inputs(96, seed=2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, tmask, causal=True)
    g = torch.Generator().manual_seed(0)
    do = torch.randn(o.shape, generator=g)
    dlse = torch.randn(lse.shape, generator=g) if with_dlse else None
    # a fully masked row's lse (≈ -1e30) has no gradient path: p = 0
    outs, grads = (o, lse), (do, dlse if with_dlse else torch.zeros_like(lse))
    want = torch.autograd.grad(outs, (tq, tk, tv), grads)
    got = tfa.flash_attention_bwd_reference(
        q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
        mask=tmask, o=o.detach(), lse=lse.detach(), do=do, dlse=dlse,
        causal=True,
    )
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt, w, atol=1e-5, rtol=0)


def test_return_lse_false_returns_o_only_and_default_scale():
    q, k, v, _ = _inputs(64, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    o2, _ = tfa.flash_attention(tq, tk, tv, causal=True, scale=1 / 4.0,
                                return_lse=True)
    assert isinstance(o, torch.Tensor) and o.shape == tq.shape
    torch.testing.assert_close(o, o2, atol=0, rtol=0)
    assert tfa.default_scale(16) == 0.25
