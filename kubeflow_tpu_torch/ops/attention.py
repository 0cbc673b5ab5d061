"""Dense attention, the "auto" attention policy and the paged-KV
primitives (port of kubeflow_tpu/ops/attention.py: `dense_attention`,
`auto_attention_impl`, `paged_kv_view`,
`paged_kv_update`, `quantize_kv`, `dequant_kv`).

Layouts follow the JAX package: activations [B, S, H, D]; the engine's
block pool [num_pages, page_size, H, D] per layer; a per-slot page table
[B, max_pages] int32 maps slot b's logical position t onto pool page
page_table[b, t // page_size], offset t % page_size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the JAX package masks with jnp.finfo(jnp.float32).min in every dtype
_F32_MIN = torch.finfo(torch.float32).min
# rows of one fixed-shape block of `row_stable_matmul` on the CPU
ROW_BLOCK = 16


def row_stable_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] (b's leading dims broadcast) whose
    every row has the same bits whatever M is. On a CPU tensor the rows
    are zero-padded to whole blocks of ROW_BLOCK and each block is its
    own fixed-shape product: MKL rounds a row differently at M = 1 (its
    GEMV path) than at M >= 2, so without the blocks a one-token decode
    step and the same row of a K+1-row verify window would differ in the
    last bits. On any other device this is `a @ b`."""
    if a.device.type != "cpu":
        return a @ b
    m, k = a.shape[-2:]
    pad = -m % ROW_BLOCK
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
    nb = (m + pad) // ROW_BLOCK
    if nb == 1:  # one block: the product itself
        return (a @ b)[..., :m, :]
    out = a.reshape(a.shape[:-2] + (nb, ROW_BLOCK, k)) @ b.unsqueeze(-3)
    return out.reshape(out.shape[:-3] + (nb * ROW_BLOCK, -1))[..., :m, :]


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
    # a tensor divisor: the IEEE quotient on every device (on CUDA torch
    # multiplies by the reciprocal of a Python-scalar divisor)
    scale = (amax / amax.new_full((), 127.0)).to(torch.bfloat16)
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
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain attention over [B, S, H, D]. `mask` is a [B, S_k] key-padding
    mask (True = attend) or a [B, S_q, S_k] per-query visibility mask;
    `causal` adds the autoregressive triangle. `q_offset` is the key
    position of query row 0 (a sequence shard's queries against the
    whole sequence's keys: query i sees keys <= q_offset + i); 0 is the
    JAX function.

    The order of operations is the JAX package's: QK^T in the compute
    dtype, `/ sqrt(D)` in the compute dtype, the mask, an f32 softmax
    cast back to the compute dtype, then PV. On CPU tensors both
    products are `row_stable_matmul`'s, so a query row's output does not
    depend on how many rows share the call."""
    cpu = q.device.type == "cpu"
    if cpu:
        scores = row_stable_matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores / scale_for(q.shape[-1], dtype)
    # f32-min written into a bf16 tensor rounds to -inf (the JAX package
    # rounds the same way). That is harmless: key position 0 is visible
    # to every query row, so no softmax row is all -inf.
    big_neg = mask_value(scores.dtype)
    if mask is not None:
        bmask = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(bmask, scores, big_neg)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((s_q, s_k), dtype=torch.bool,
                         device=q.device).tril(q_offset)
        scores = torch.where(tri, scores, big_neg)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if cpu:
        return row_stable_matmul(probs, v.transpose(1, 2)).transpose(1, 2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# the "auto" policy's thresholds, from scripts/torch_attention_sweep.py on
# an NVIDIA H100 80GB HBM3 at 700 W (fwd+bwd, bf16, [1, S, 12, 64]; the
# hand-written flash kernels against `dense_attention`): bidirectional
# flash/dense = 1.51x @512, 2.31x @1k, 3.62x @2k, 5.72x @4k, 10.6x @8k,
# 11.2x @16k, dense out of memory @32k; causal 1.81x @512 up to 25.7x
# @16k; at BERT-base's call [32, 512, 12, 64] 4.03x (causal 5.43x).
# Flash wins at every measured length, so both thresholds sit at the
# shortest one; below it the choice is unmeasured and stays dense unless
# the scores outgrow the memory gate.
_FLASH_MIN_SEQ = 512
_CAUSAL_FLASH_MIN_SEQ = 512
# dense's [B, H, S, S] scores (forward + the backward's copy) past this
# many bytes: flash, as the only memory-feasible choice
_SCORE_BYTES_LIMIT = 2 << 30


def auto_attention_impl(batch: int, seq_len: int, num_heads: int, dtype,
                        causal: bool = False, device="cuda") -> str:
    """The "auto" attention policy (the JAX package's, re-measured on the
    H100; thresholds above): "flash" or "dense" for a call of `batch` x
    `seq_len` x `num_heads` in `dtype`. Off a CUDA device "dense", as the
    JAX policy picks dense off its accelerator (the flash kernels exist
    only on the card)."""
    if torch.device(device).type != "cuda":
        return "dense"
    if seq_len >= (_CAUSAL_FLASH_MIN_SEQ if causal else _FLASH_MIN_SEQ):
        return "flash"
    itemsize = max(2, torch.finfo(dtype).bits // 8)
    score_bytes = 2 * batch * num_heads * seq_len * seq_len * itemsize
    return "flash" if score_bytes > _SCORE_BYTES_LIMIT else "dense"


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
