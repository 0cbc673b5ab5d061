"""Dense attention and the paged-KV primitives (port of
kubeflow_tpu/ops/attention.py: `dense_attention`, `paged_kv_view`,
`paged_kv_update`, `quantize_kv`, `dequant_kv`).

Layouts follow the JAX package: activations [B, S, H, D]; the engine's
block pool [num_pages, page_size, H, D] per layer; a per-slot page table
[B, max_pages] int32 maps slot b's logical position t onto pool page
page_table[b, t // page_size], offset t % page_size.
"""

from __future__ import annotations

from typing import Optional

import torch

# the JAX package masks with jnp.finfo(jnp.float32).min in every dtype
_F32_MIN = torch.finfo(torch.float32).min


def mask_value(dtype: torch.dtype) -> float:
    """f32-min as the score dtype holds it: in bf16 (and f16) it rounds
    to -inf (0xFF7FFFFF rounds up to 0xFF80). Returned as the rounded
    Python float, since torch refuses to cast an overflowing scalar."""
    return _F32_MIN if torch.finfo(dtype).min <= _F32_MIN else float("-inf")


def scale_for(depth: int, dtype: torch.dtype) -> float:
    """sqrt(depth) computed in f32 and rounded to the compute dtype, the
    divisor `jnp.sqrt(depth).astype(dtype)` of the JAX package. A Python
    float holding that exact value: dividing a tensor by it divides in
    the tensor's dtype, with no device copy."""
    return float(torch.tensor(float(depth)).sqrt().to(dtype))


# -- int8 KV page quantization (serving quantize=int8) ------------------------
# Per-(token, head) symmetric int8 over the head_dim axis: one bf16 scale
# per written K/V vector, stored beside the pool as [..., H, 1], so a
# cached token-head costs D + 2 bytes instead of 2D in bf16.


def quantize_kv(x: torch.Tensor) -> tuple:
    """x [..., H, D] float → (int8 values [..., H, D], bf16 scales
    [..., H, 1]). The scale amax/127 (f32) is rounded to bf16 FIRST and
    the values are quantized against the rounded scale, so dequant
    multiplies by exactly the stored scale. torch.round rounds half to
    even, as jnp.round does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0).to(torch.bfloat16)
    s = scale.float()
    q = torch.round(x32 / torch.where(s > 0.0, s, torch.ones_like(s)))
    return q.clamp(-127.0, 127.0).to(torch.int8), scale


def dequant_kv(values: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `quantize_kv` (values [..., H, D] int8 x scales
    [..., H, 1]): an f32 multiply, rounded once into the compute dtype.
    The one definition point: the gather read path, the kernels' plain
    version and the CUDA kernels' dequant all compute exactly this."""
    return (values.float() * scales.float()).to(dtype)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.bfloat16,
    causal: bool = False,
) -> torch.Tensor:
    """Plain attention over [B, S, H, D]. `mask` is a [B, S_k] key-padding
    mask (True = attend) or a [B, S_q, S_k] per-query visibility mask;
    `causal` adds the autoregressive triangle.

    The order of operations is the JAX package's: QK^T in the compute
    dtype, `/ sqrt(D)` in the compute dtype, the mask, an f32 softmax
    cast back to the compute dtype, then PV."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale_for(
        q.shape[-1], dtype
    )
    # f32-min written into a bf16 tensor rounds to -inf (the JAX package
    # rounds the same way). That is harmless: key position 0 is visible
    # to every query row, so no softmax row is all -inf.
    big_neg = mask_value(scores.dtype)
    if mask is not None:
        bmask = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(bmask, scores, big_neg)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(tri, scores, big_neg)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def paged_kv_view(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Gather a per-slot contiguous K/V view through the page table:
    pool [P, page_size, H, D] + page_table [B, max_pages] →
    [B, max_pages * page_size, H, D]. Row b position t of the view is
    pool[page_table[b, t // page_size], t % page_size]."""
    b, mp = page_table.shape
    ps = pool.shape[1]
    pages = pool.index_select(0, page_table.reshape(-1).long())
    return pages.reshape((b, mp * ps) + tuple(pool.shape[2:]))


def paged_write_index(
    page_table: torch.Tensor, cursors: torch.Tensor, s: int, page_size: int
) -> tuple:
    """Where a window of s new vectors per row lands in the flattened pool
    [P * page_size, ...]: (pool row index, window row index), one entry
    per kept write. Row b's vector j goes to logical position
    cursors[b] + j through the page table; positions at or past the view
    length are dropped (retired slots park their cursor at max_len).

    The JAX scatter routes dropped writes to one shared out-of-range
    index; here they are filtered out. One host sync per call, so the
    model computes it once per forward and reuses it in every layer."""
    mp = page_table.shape[1]
    pos = cursors.long()[:, None] + torch.arange(s, device=cursors.device)[None, :]
    page = torch.gather(page_table.long(), 1, (pos // page_size).clamp(0, mp - 1))
    flat = (page * page_size + pos % page_size).reshape(-1)
    kept = (pos < mp * page_size).reshape(-1).nonzero()[:, 0]
    return flat[kept], kept


def paged_write(pool: torch.Tensor, new: torch.Tensor, index: tuple) -> None:
    """Store `new` [B, s, ...] into `pool` [P, page_size, ...] IN PLACE at
    `index` (from `paged_write_index`). In-window indices are distinct
    (the page allocator keeps them so); nothing else is assumed."""
    dst, src = index
    row_shape = tuple(pool.shape[2:])
    flat = pool.view((-1,) + row_shape)
    flat[dst] = new.reshape((-1,) + row_shape).index_select(0, src).to(pool.dtype)


def paged_kv_update(
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    cursors: torch.Tensor,
) -> tuple:
    """Write row b's s new K/V vectors ([B, s, H, D]) into the pool at
    logical positions cursors[b] + j, routed through the page table.

    The JAX package returns new pools (its programs donate the old
    buffers); here the pools are updated IN PLACE and returned for
    symmetry. Positions at or past the view length are dropped: retired
    slots park their cursor at max_len and idle safely. Several parked
    rows share the JAX drop index; nothing here assumes unique indices."""
    index = paged_write_index(page_table, cursors, k_new.shape[1], pool_k.shape[1])
    paged_write(pool_k, k_new, index)
    paged_write(pool_v, v_new, index)
    return pool_k, pool_v
