"""Ring attention: sequence parallelism by K/V rotation (port of
kubeflow_tpu/parallel/ring_attention.py).

Q, K and V are sharded along the sequence: ring rank i of n holds
positions [i·s, (i + 1)·s). Each rank attends its query block to one K/V
block at a time while the K/V blocks rotate around the ring (`ppermute`,
parallel/distributed.py, one `batch_isend_irecv` a rotation; its
backward sends the K/V cotangents back to their owners). Each step's
normalized block output merges into the running result by the
log-sum-exp recurrence in f32, in the reference's order of operations,
so the result is exact.

A step's block is the flash kernels' (`ops/flash_attention.py`,
`return_lse=True`: the lse cotangent folds into the backward's delta)
or, with `impl="dense"`, `block_attn`, the reference's einsum block.
Under `causal=True` the visibility is block arithmetic in global
positions: at step t rank i holds the block of rank src = (i − t) mod n;
src == i is the diagonal (the kernels' causal grid), src < i a full
block (the bidirectional grid), src > i invisible: the flash path
launches nothing and leaves the running result as it is, which is
exactly the reference's merge of zeros at lse −inf, and hands the block
a zero cotangent: every rank then runs every rotation's backward, which
the peers' sends and receives need (JAX transposes the unused branch's
ppermute all the same). The dense path computes every block under its
position mask, as the reference does.

`ring_step` is one step (a block and its merge) and `ring_pass` the loop
over the n steps with a caller's rotation, so a single rank's block loop
can be timed on blocks it already holds (chip_smoke phase 19c) through
the code training runs. Without a sequence axis `ring_attention` is
`dense_attention`, as the reference falls back.

Layout [batch, seq, heads, head_dim], as everywhere in the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.flash_attention import BIG_NEG, flash_attention
from kubeflow_tpu_torch.parallel.distributed import ppermute
from kubeflow_tpu_torch.parallel.mesh import SequenceShard, active_sequence

RING_IMPLS = ("flash", "dense")
DIAGONAL, FULL, INVISIBLE = "diagonal", "full", "invisible"


def block_kind(idx: int, src: int, causal: bool) -> str:
    """How query block `idx` sees key block `src`."""
    if not causal or src < idx:
        return FULL
    return DIAGONAL if src == idx else INVISIBLE


def block_attn(q, k, v, mask: Optional[torch.Tensor], dtype,
               pos_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (query block, key block) tile, the reference's dense path:
    (normalized output [B, q, H, D] f32, row lse [B, H, q] f32). `mask`
    [B, k] marks visible keys; `pos_mask` [q, k] the causal visibility of
    this block pair. A fully masked row has scores −1e30, so its lse is
    ~−1e30 and its merge weight underflows to 0 beside any visible
    block."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / float(torch.tensor(float(depth)).sqrt())
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] != 0, scores, BIG_NEG)
    if pos_mask is not None:
        scores = torch.where(pos_mask[None, None], scores, BIG_NEG)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)  # noqa: E741
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype), v).float()
    o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return o, m + torch.log(l.clamp_min(1e-30))


def merge(o_acc, lse_acc, bo, blse) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a block's (output, lse) into the running ones, in f32, in the
    reference's order. The running lse starts at −inf: logaddexp(−inf, x)
    is x and its gradients are 0 and 1, so the first merge is exact; a
    block's lse is never −inf (a fully masked row gives ~−1e30)."""
    lse_new = torch.logaddexp(lse_acc, blse)
    alpha = torch.exp(lse_acc - lse_new)
    beta = torch.exp(blse - lse_new)
    o_new = (o_acc * alpha.transpose(1, 2)[..., None]
             + bo * beta.transpose(1, 2)[..., None])
    return o_new, lse_new


class _ZeroCotangent(torch.autograd.Function):
    """`o` unchanged; k and v get a zero cotangent (an invisible block's,
    so the rotation that brought it runs its backward)."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.kv = (k.shape, k.dtype, k.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.kv
        zero = torch.zeros(shape, dtype=dtype, device=device)
        return grad, zero, zero


def ring_step(q, k, v, mask, o_acc, lse_acc, kind: str, impl: str = "flash",
              dtype=torch.bfloat16, pos_mask=None):
    """One ring step: query block `q` against key block (k, v, mask) of
    `kind`, merged into (o_acc, lse_acc) → (o, lse). The flash path runs
    the diagonal on the causal kernels and a full block on the
    bidirectional ones, each returning its lse, and launches nothing for
    an invisible block (whose k and v get a zero cotangent); the dense
    path runs `block_attn` under `pos_mask`."""
    if impl == "flash":
        if kind == INVISIBLE:
            if k.requires_grad or v.requires_grad:
                o_acc = _ZeroCotangent.apply(o_acc, k, v)
            return o_acc, lse_acc
        bo, blse = flash_attention(q, k, v, mask=mask, causal=kind == DIAGONAL,
                                   return_lse=True)
        bo = bo.float()
    else:
        bo, blse = block_attn(q, k, v, mask, dtype, pos_mask)
    return merge(o_acc, lse_acc, bo, blse)


Rotate = Callable[[int, torch.Tensor, Optional[torch.Tensor]],
                  Tuple[torch.Tensor, Optional[torch.Tensor]]]


def ring_pass(q, kv, mask, idx: int, n: int, rotate: Rotate, *,
              dtype=torch.bfloat16, causal: bool = False,
              impl: str = "flash") -> torch.Tensor:
    """Ring rank `idx` of `n`'s block loop: `kv` [2, B, s, H, D] is the
    K/V block it holds at step 0 (with its key mask), and `rotate(t, kv,
    mask)` gives the block of step t + 1 (a `ppermute` in training). The
    last step's block is not rotated on. → the output [B, s, H, D] in
    `dtype`."""
    if impl not in RING_IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}; known: {RING_IMPLS}")
    b, qs, h, d = q.shape
    ks = kv.shape[2]
    o = torch.zeros((b, qs, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, qs), float("-inf"), dtype=torch.float32,
                     device=q.device)
    q_pos = idx * qs + torch.arange(qs, device=q.device)
    # the query block's gradient sums the n blocks' dQ: each step reads
    # q through an f32 copy, so they add in f32 and round to q's dtype
    # once (the values each step reads are q's, bit for bit)
    q32 = (q.float() if q.requires_grad and q.dtype != torch.float32
           else None)
    for t in range(n):
        src = (idx - t) % n
        pos_mask = None
        if causal and impl == "dense":
            k_pos = src * ks + torch.arange(ks, device=q.device)
            pos_mask = q_pos[:, None] >= k_pos[None, :]
        q_t = q if q32 is None else q32.to(q.dtype)
        o, lse = ring_step(q_t, kv[0], kv[1], mask, o, lse,
                           block_kind(idx, src, causal), impl, dtype, pos_mask)
        if t + 1 < n:
            kv, mask = rotate(t, kv, mask)
    return o.to(dtype)


def ring_attention_inner(q, k, v, mask: Optional[torch.Tensor],
                         shard: SequenceShard, *, dtype=torch.bfloat16,
                         causal: bool = False, impl: str = "flash"):
    """Exact ring attention on this rank's shards: q/k/v [B, s, H, D],
    `mask` [B, s] (this shard's keys; nonzero = attend) or None. K and V
    rotate as one [2, B, s, H, D] buffer, the mask beside it (int32)."""
    group = shard.group

    def rotate(_t, kv, m):
        return (ppermute(kv, group),
                None if m is None else ppermute(m, group))

    kv = torch.stack([k, v])
    mask = None if mask is None else mask.to(torch.int32).contiguous()
    return ring_pass(q, kv, mask, shard.rank, shard.size, rotate,
                     dtype=dtype, causal=causal, impl=impl)


def ring_attention(q, k, v, mask: Optional[torch.Tensor] = None, *,
                   dtype=torch.bfloat16, causal: bool = False,
                   impl: str = "flash",
                   shard: Optional[SequenceShard] = None):
    """The models' entry point. With a sequence axis (`shard`, default
    the step's `active_sequence()`) exact ring attention over this
    rank's shards, each block on the flash kernels (`impl="dense"`: the
    einsum blocks); without one, `dense_attention`, the same numbers."""
    shard = active_sequence() if shard is None else shard
    if shard is None or shard.size == 1:
        return dense_attention(q, k, v, mask=None if mask is None
                               else mask.bool(), dtype=dtype, causal=causal)
    return ring_attention_inner(q, k, v, mask, shard, dtype=dtype,
                                causal=causal, impl=impl)
