"""Decoder-only causal LM (port of kubeflow_tpu/models/gpt.py).

Pre-LN residual blocks, token + position embeddings, f32 layernorms and
f32 logits, compute in `cfg.dtype` with f32 weights at rest, cast at use
(bit-identical to the JAX package's `DenseGeneral(dtype=...)`). Parameter
names and shapes are the flax tree's (`layers.<i>` for `layer_<i>`), so
`models/convert.py` moves JAX weights across by name.

Three forward paths, mirroring the JAX module's three branches:

- `forward`: the full causal pass, the training path. Its attention is
  `cfg.attention_impl`: "dense" (`ops/attention.py::dense_attention`) or
  "flash" (`ops/flash_attention.py`, the CUDA forward/backward kernels on
  the card). `cfg.remat` recomputes each block in the backward
  (`torch.utils.checkpoint`, the JAX `nn.remat`), and `return_hidden`
  hands the post-LN hidden states to a chunked loss.
- `prefill` / `decode`: the slot-row KV cache (`SlotCache`) that
  `serving/generate.py` runs — a causal prefill seeds the cache, then
  each decode step writes at the shared cursor and attends over the real
  (non-pad) positions written so far.
- `paged_forward`: the continuous-batching engine's block-paged pool
  (`KVPool` + `PagedState`). Writes scatter through the page table, the
  read either gathers a per-slot view (`attn_impl="gather"`) or walks the
  table in place through the CUDA kernel (`attn_impl="kernel"`). An int8
  pool (`make_paged_pool(..., kv_quant="int8")`) stores int8 values plus
  one bf16 scale per written vector: writes quantize (`quantize_kv`),
  reads dequantize (`dequant_kv` on the gathered view, or fused into the
  kernels' page walk).

Caches are updated IN PLACE (the JAX programs donate and replace them).

`int8_model` builds the int8 serving model (`serving.quantize=int8`):
every quantized leaf is held as an int8 buffer plus an f32 per-channel
scale buffer and dequantized at its point of use with
`dequantize_params`' arithmetic. The JAX engine dequantizes the whole
tree at program entry; dequantizing each leaf where it is used gives
the same bits and keeps the resident weights int8.

A model is built frozen, for serving (`requires_grad_(False)`, eval
mode). `trainable()` turns the f32 master weights trainable: every module
casts them to the compute dtype at use, so gradients land in f32, as in
the JAX package's mixed precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.checkpointing.quantize import (
    dequantize_leaf,
    quantize_params_int8,
)
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.ops.attention import (
    dense_attention,
    dequant_kv,
    paged_kv_view,
    paged_write,
    paged_write_index,
    quantize_kv,
)
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.paged_attention import paged_attention
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

PAGED_ATTENTION_IMPLS = ("gather", "kernel")
QUANTIZE_CHOICES = ("none", "int8")
GPT_ATTENTION_IMPLS = ("dense", "flash")
# the JAX package's other full-causal impls, and what they wait for
_UNPORTED_IMPLS = {
    "auto": "ROADMAP A1: re-measure the dense/flash thresholds on the H100",
    "ring": "ROADMAP A13 item 5 (sequence parallelism)",
    "ulysses": "ROADMAP A13 item 5 (sequence parallelism)",
}


@dataclasses.dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 1024
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # "dense" | "flash" (full causal pass only; serving's cached paths
    # read through their own kernels)
    attention_impl: str = "dense"
    remat: bool = False

    def __post_init__(self):
        if self.attention_impl in _UNPORTED_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} is not ported yet "
                f"({_UNPORTED_IMPLS[self.attention_impl]})"
            )
        if self.attention_impl not in GPT_ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; known: "
                f"{GPT_ATTENTION_IMPLS}"
            )
        if self.dropout_rate > 0:
            # every GPT preset trains at 0, and the JAX dropout stream
            # (threefry) cannot be reproduced here
            raise ValueError(
                "dropout_rate > 0 is not ported (ROADMAP A11: dropout)"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# -- caches ------------------------------------------------------------------


@dataclasses.dataclass
class SlotCache:
    """The slot-row KV cache `generate()` decodes over (the JAX module's
    `cache` collection on its prefill/decode path).

    k/v [L, B, max_len, H, D] in the compute dtype; `valid_mask`
    [B, max_len] marks REAL token positions (a ragged batch's pad slots
    stay False and are never attended); `position` [B] counts each row's
    real tokens (position embeddings index real-token order); `index` is
    the shared write cursor (every row the same age)."""

    k: torch.Tensor
    v: torch.Tensor
    valid_mask: torch.Tensor
    position: torch.Tensor
    index: int = 0


@dataclasses.dataclass
class KVPool:
    """The engine's block-paged K/V pool: k/v [L, num_pages, page_size,
    H, D] in the compute dtype (the JAX scan-layers pool layout), or int8
    with bf16 scales k_scale/v_scale [L, num_pages, page_size, H, 1] (the
    JAX `cached_*_scale` leaves)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def tensors(self):
        """Every pool tensor: values, then scales when int8."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale)
                if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


@dataclasses.dataclass
class PagedState:
    """Per-call view of the paged cache (the JAX `PagedState`): the page
    table [B, max_pages] int32 and cursors [B] int32 are host-owned by
    the engine scheduler and passed per dispatch. The paged layout has no
    pad holes, so cursor masking alone gives visibility.

    `attn_impl`: "gather" materializes a per-slot view through the page
    table and runs `dense_attention`; "kernel" walks the table in place
    (`ops/paged_attention.py` — the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors), the counterpart of the JAX "pallas"."""

    page_table: torch.Tensor
    cache_index: torch.Tensor
    attn_impl: str = "gather"


# -- per-call attention contexts: what each layer does with its q/k/v --------


class _Causal:
    def __init__(self, mask: Optional[torch.Tensor], dtype,
                 impl: str = "dense"):
        self.mask, self.dtype, self.impl = mask, dtype, impl

    def attend(self, layer, q, k, v):
        if self.impl == "flash":
            return flash_attention(
                q, k, v, mask=self.mask, causal=True
            ).to(self.dtype)
        return dense_attention(
            q, k, v, mask=self.mask, dtype=self.dtype, causal=True
        )


class _SlotPrefill(_Causal):
    """One causal pass over the prompt that also seeds the slot cache."""

    def __init__(self, cache: SlotCache, mask, dtype, impl: str):
        super().__init__(mask, dtype, impl)
        self.cache = cache

    def attend(self, layer, q, k, v):
        s = q.shape[1]
        self.cache.k[layer, :, :s] = k
        self.cache.v[layer, :, :s] = v
        return super().attend(layer, q, k, v)


class _SlotDecode:
    """Decode step(s) at the shared cursor: write the s new K/V vectors at
    index..index+s-1, attend over real positions <= each query's own."""

    def __init__(self, cache: SlotCache, s: int, dtype):
        self.cache, self.dtype = cache, dtype
        max_len = cache.k.shape[2]
        if cache.index + s > max_len:
            raise ValueError(
                f"decode window {cache.index}+{s} exceeds max_len {max_len}"
            )
        dev = cache.k.device
        ar = torch.arange(max_len, device=dev)
        if s == 1:
            self.visible = (ar[None, :] <= cache.index) & cache.valid_mask
        else:
            q_pos = cache.index + torch.arange(s, device=dev)
            self.visible = (
                ar[None, None, :] <= q_pos[None, :, None]
            ) & cache.valid_mask[:, None, :]

    def attend(self, layer, q, k, v):
        i, s = self.cache.index, q.shape[1]
        self.cache.k[layer, :, i : i + s] = k
        self.cache.v[layer, :, i : i + s] = v
        return dense_attention(
            q, self.cache.k[layer], self.cache.v[layer], mask=self.visible,
            dtype=self.dtype, causal=False,
        )


class _Paged:
    """Block-paged read/write (the JAX module's paged branch)."""

    def __init__(self, pool: KVPool, paged: PagedState, s: int, dtype):
        if paged.attn_impl not in PAGED_ATTENTION_IMPLS:
            raise ValueError(
                f"attn_impl {paged.attn_impl!r} not in {PAGED_ATTENTION_IMPLS}"
            )
        self.pool, self.paged, self.dtype = pool, paged, dtype
        # every layer writes the same positions: route them once
        self.write_index = paged_write_index(
            paged.page_table, paged.cache_index, s, pool.page_size
        )
        self.visible = None
        if paged.attn_impl == "gather":
            view_len = paged.page_table.shape[1] * pool.page_size
            dev = pool.k.device
            idx = paged.cache_index.long()
            ar = torch.arange(view_len, device=dev)
            if s == 1:
                # no pad holes in the paged layout: cursor masking IS the
                # visibility rule
                self.visible = ar[None, :] <= idx[:, None]
            else:
                # query j (at logical position idx+j) sees <= idx+j
                q_pos = idx[:, None] + torch.arange(s, device=dev)[None, :]
                self.visible = ar[None, None, :] <= q_pos[:, :, None]

    def attend(self, layer, q, k, v):
        pool = self.pool
        pk, pv = pool.k[layer], pool.v[layer]
        pt, idx = self.paged.page_table, self.paged.cache_index
        ks = vs = None
        if pool.quantized:
            # quantize the s new vectors at write; values and scales go
            # through the same page-table routing
            ks, vs = pool.k_scale[layer], pool.v_scale[layer]
            (k, k_sc), (v, v_sc) = quantize_kv(k), quantize_kv(v)
            paged_write(ks, k_sc, self.write_index)
            paged_write(vs, v_sc, self.write_index)
        paged_write(pk, k, self.write_index)
        paged_write(pv, v, self.write_index)
        if self.visible is None:
            return paged_attention(q, pk, pv, pt, idx, dtype=self.dtype,
                                   k_scale=ks, v_scale=vs)
        k_view, v_view = paged_kv_view(pk, pt), paged_kv_view(pv, pt)
        if pool.quantized:
            k_view = dequant_kv(k_view, paged_kv_view(ks, pt), self.dtype)
            v_view = dequant_kv(v_view, paged_kv_view(vs, pt), self.dtype)
        return dense_attention(
            q, k_view, v_view, mask=self.visible, dtype=self.dtype,
            causal=False,
        )


# -- modules -------------------------------------------------------------------

# suffix of the f32 per-channel scale buffer beside an int8 leaf
_QSCALE = "_qscale"


def _at_use(module: nn.Module, name: str, dtype) -> torch.Tensor:
    """Leaf `name` of `module` as its point of use reads it: the stored
    tensor (f32 at rest; the caller casts as before), or on an int8 model
    the int8 leaf dequantized into the compute dtype with
    `dequantize_params`' arithmetic."""
    leaf = getattr(module, name)
    scale = module._buffers.get(name + _QSCALE)
    return leaf if scale is None else dequantize_leaf(leaf, scale, dtype)



class _Dense(nn.Module):
    """flax Dense/DenseGeneral: `kernel` [*in, *out] (f32 at rest), an
    optional `bias` [*out]; x @ kernel then + bias, each in the compute
    dtype (two roundings, as the flax module does)."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype, use_bias: bool = True):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = (
            nn.Parameter(torch.empty(self.out_shape)) if use_bias else None
        )

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        w = _at_use(self, "kernel", self.dtype).to(self.dtype).reshape(
            math.prod(self.in_shape), math.prod(self.out_shape)
        )
        y = (x.reshape(lead + (-1,)) @ w).reshape(lead + self.out_shape)
        if self.bias is not None:
            y = y + _at_use(self, "bias", self.dtype).to(self.dtype)
        return y


class _LayerNorm(nn.Module):
    """flax LayerNorm(dtype=float32): epsilon 1e-6, statistics in f32 by
    the fast variance (E[x^2] - E[x]^2, floored at 0), f32 output. Its
    leaves are quantized only when an int8 envelope from the JAX
    package's scan-stacked layout brings them (there they are [L, D]);
    dequantized into `dtype`, they enter the f32 math exactly."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        scale = _at_use(self, "scale", self.dtype).float()
        bias = _at_use(self, "bias", self.dtype).float()
        return (x - mean) * (torch.rsqrt(var + 1e-6) * scale) + bias


class _Embed(nn.Module):
    def __init__(self, num: int, dim: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids):
        scale = self._buffers.get("embedding" + _QSCALE)
        if scale is not None:
            # gather the int8 rows, then dequantize: the scale is per
            # column, so this is the dequantized table's gather, bit for bit
            return dequantize_leaf(self.embedding[ids], scale, self.dtype)
        # gather then cast == flax's cast-table-then-gather, bit for bit
        return F.embedding(ids, self.embedding).to(self.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GptConfig):
        super().__init__()
        d, h, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.query = _Dense((d,), (h, hd), cfg.dtype)
        self.key = _Dense((d,), (h, hd), cfg.dtype)
        self.value = _Dense((d,), (h, hd), cfg.dtype)
        self.out = _Dense((h, hd), (d,), cfg.dtype)

    def forward(self, x, ctx, layer: int):
        q, k, v = self.query(x), self.key(x), self.value(x)
        return self.out(ctx.attend(layer, q, k, v))


class DecoderBlock(nn.Module):
    """Pre-LN residual block."""

    def __init__(self, cfg: GptConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln_att = _LayerNorm(cfg.hidden_size, cfg.dtype)
        self.attention = CausalSelfAttention(cfg)
        self.ln_mlp = _LayerNorm(cfg.hidden_size, cfg.dtype)
        self.mlp_wi = _Dense((cfg.hidden_size,), (cfg.mlp_dim,), cfg.dtype)
        self.mlp_wo = _Dense((cfg.mlp_dim,), (cfg.hidden_size,), cfg.dtype)

    def forward(self, x, ctx, layer: int):
        h = self.ln_att(x)
        x = x + self.attention(h.to(self.dtype), ctx, layer)
        h = self.mlp_wi(self.ln_mlp(x).to(self.dtype))
        h = self.mlp_wo(F.gelu(h, approximate="tanh"))
        return x + h


def init_params(model: nn.Module, seed: int) -> None:
    """Seeded init from an explicit CPU torch.Generator (the same weights
    on every device): layernorm scales 1, biases 0, every kernel and
    embedding N(0, 0.02)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


class Gpt(nn.Module):
    """Decoder-only LM: token+position embeddings → N blocks → LM head."""

    def __init__(self, cfg: GptConfig, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_emb = _Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype)
        self.pos_emb = _Embed(cfg.max_len, cfg.hidden_size, cfg.dtype)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg) for _ in range(cfg.num_layers)
        )
        self.ln_final = _LayerNorm(cfg.hidden_size, cfg.dtype)
        self.head = _Dense(
            (cfg.hidden_size,), (cfg.vocab_size,), cfg.dtype, use_bias=False
        )
        # "int8" once `int8_model` has loaded an envelope
        self.quantize = "none"
        if dev.type != "meta":  # a meta model has shapes only
            init_params(self, seed)
        self.to(dev)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def weight_bytes(self) -> int:
        """Bytes of the resident weights (parameters and int8 buffers)."""
        return sum(t.numel() * t.element_size()
                   for t in self.state_dict().values())

    def trainable(self) -> "Gpt":
        """Make the f32 master weights trainable (train mode); returns
        self. Serving keeps the frozen model the constructor builds."""
        self.requires_grad_(True)
        self.train()
        return self

    def _hidden(self, input_ids, positions, ctx, remat: bool = False):
        """Embeddings → blocks → ln_final: f32 hidden states [B, S, D]."""
        x = (self.tok_emb(input_ids) + self.pos_emb(positions)).to(
            self.cfg.dtype
        )
        for i, block in enumerate(self.layers):
            if remat:
                x = checkpoint(block, x, ctx, i, use_reentrant=False)
            else:
                x = block(x, ctx, i)
        return self.ln_final(x)

    def _run(self, input_ids, positions, ctx):
        x = self._hidden(input_ids, positions, ctx)
        return self.head(x.to(self.cfg.dtype)).float()

    def forward(self, input_ids, attention_mask=None, return_hidden=False):
        """Full causal pass → f32 logits [B, S, V]. `attention_mask`
        [B, S] marks real tokens (None = no padding, so the flash kernel
        runs unmasked). `return_hidden=True` returns the post-LN f32
        hidden states [B, S, D] instead (the chunked loss streams the
        head itself). Under `cfg.remat` and grad mode every block is
        recomputed in the backward."""
        s = input_ids.shape[1]
        mask = None if attention_mask is None else attention_mask.bool()
        positions = torch.arange(s, device=input_ids.device)[None, :]
        ctx = _Causal(mask, self.cfg.dtype, self.cfg.attention_impl)
        remat = self.cfg.remat and torch.is_grad_enabled()
        x = self._hidden(input_ids, positions, ctx, remat=remat)
        if return_hidden:
            return x
        return self.head(x.to(self.cfg.dtype)).float()

    def new_slot_cache(self, batch: int) -> SlotCache:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.max_len, cfg.num_heads,
                 cfg.head_dim)
        dev = self.device
        return SlotCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            valid_mask=torch.ones((batch, cfg.max_len), dtype=torch.bool,
                                  device=dev),
            position=torch.zeros((batch,), dtype=torch.long, device=dev),
        )

    def prefill(self, input_ids, attention_mask=None):
        """One causal pass over the prompt that also seeds a fresh slot
        cache → (f32 logits [B, S, V], SlotCache). Padded prompt
        positions stay invisible to later decode steps, and each row's
        position embeddings count only its real tokens."""
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.bool)
        mask = attention_mask.bool()
        cache = self.new_slot_cache(b)
        cache.valid_mask[:, :s] = mask
        m = mask.long()
        positions = (m.cumsum(1) - 1).clamp_min(0)
        cache.position = m.sum(1)
        cache.index = s
        logits = self._run(
            input_ids, positions,
            _SlotPrefill(cache, mask, self.cfg.dtype, self.cfg.attention_impl),
        )
        return logits, cache

    def decode(self, input_ids, cache: SlotCache):
        """Decode step(s) over the slot cache (updated in place) → f32
        logits [B, s, V]."""
        s = input_ids.shape[1]
        ctx = _SlotDecode(cache, s, self.cfg.dtype)
        positions = cache.position[:, None] + torch.arange(
            s, device=input_ids.device
        )[None, :]
        logits = self._run(input_ids, positions, ctx)
        cache.index += s
        cache.position = cache.position + s
        return logits

    def paged_forward(self, input_ids, pool: KVPool, paged: PagedState):
        """A window of s tokens per slot over the block-paged pool
        (updated in place) → f32 logits [B, s, V]. Positions come off the
        cursor, clamped to max_len - 1 (an overrun window tail's writes
        are dropped and its outputs are never read)."""
        s = input_ids.shape[1]
        positions = (
            paged.cache_index.long()[:, None]
            + torch.arange(s, device=input_ids.device)[None, :]
        ).clamp_max(self.cfg.max_len - 1)
        return self._run(
            input_ids, positions, _Paged(pool, paged, s, self.cfg.dtype)
        )


# -- block-paged pool helpers (serving/engine.py's device state) ---------------


def make_paged_pool(cfg: GptConfig, num_pages: int, page_size: int,
                    device, kv_quant: str = "none") -> KVPool:
    """Zeroed K/V pool [L, num_pages, page_size, H, D] per side, in the
    compute dtype; `kv_quant="int8"` stores int8 values plus zeroed bf16
    scales [L, num_pages, page_size, H, 1] per side."""
    if kv_quant not in QUANTIZE_CHOICES:
        raise ValueError(f"kv_quant {kv_quant!r} not in {QUANTIZE_CHOICES}")
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_heads,
             cfg.head_dim)
    if kv_quant == "none":
        return KVPool(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        )
    scale_shape = shape[:-1] + (1,)
    return KVPool(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.zeros(scale_shape, dtype=torch.bfloat16, device=device),
        v_scale=torch.zeros(scale_shape, dtype=torch.bfloat16, device=device),
    )


def insert_pages(pool: KVPool, cache_one: SlotCache, page_ids, real_len: int):
    """Copy a batch-1 prefill cache's K/V rows [0, real_len) into the
    pool pages `page_ids` (in place): cache rows [c*ps, (c+1)*ps) land
    on page page_ids[c] for every chunk holding at least one real row.
    Pad rows inside the last chunk land past the cursor, stay invisible,
    and are overwritten by decode. An int8 pool gets the copied rows
    quantized (JAX `quantize_kv_cache`; quantization is per vector, so
    quantizing only these rows gives the bits of quantizing all)."""
    ps = pool.page_size
    n = -(-int(real_len) // ps)
    ids = torch.as_tensor(
        [int(p) for p in page_ids[:n]], dtype=torch.long,
        device=pool.k.device,
    )
    lead = pool.k.shape[0]
    rows = [cache_one.k[:, 0, : n * ps], cache_one.v[:, 0, : n * ps]]
    if pool.quantized:
        (qk, sk), (qv, sv) = quantize_kv(rows[0]), quantize_kv(rows[1])
        rows = [qk, qv, sk, sv]
    for dst, src in zip(pool.tensors(), rows):
        dst[:, ids] = src.reshape((lead, n, ps) + tuple(dst.shape[3:]))
    return pool


def copy_pool_page(pool: KVPool, src: int, dst: int) -> KVPool:
    """Copy page `src` onto page `dst` in every layer (in place), the
    scales of an int8 pool with its values — the prefix cache's
    copy-on-write."""
    for t in pool.tensors():
        t[:, dst] = t[:, src]
    return pool


def int8_model(model: Gpt, envelope: Optional[dict] = None) -> Gpt:
    """The int8 serving model of `model` (`serving.quantize=int8`): a new
    Gpt on `model`'s device whose quantized leaves are int8 buffers with
    f32 per-channel scale buffers beside them, dequantized at each use.
    The weights come from `envelope` (checkpointing/quantize.py, e.g.
    `models/convert.py quantized_params_from_jax`) or, without one, from
    quantizing `model`'s own state dict once. `model` is not changed;
    an int8 `model` is returned as it is."""
    if model.quantize == "int8":
        return model
    if envelope is None:
        envelope = quantize_params_int8(model.state_dict())
    values, scales = envelope["qvalues"], envelope["qscales"]
    names = set(model.state_dict())
    if set(values) != names or not set(scales) <= names:
        raise ValueError(
            "int8 envelope does not match the model: missing "
            f"{sorted(names - set(values))[:4]}, unexpected "
            f"{sorted((set(values) | set(scales)) - names)[:4]}"
        )
    dev = model.device
    out = Gpt(model.cfg, device="meta")
    for name, value in values.items():
        owner, _, leaf = name.rpartition(".")
        module = out.get_submodule(owner)
        del module._parameters[leaf]
        if name in scales:
            if value.dtype != torch.int8:
                raise ValueError(f"int8 envelope: {name} is {value.dtype}")
            module.register_buffer(leaf, value.to(dev, copy=True))
            module.register_buffer(
                leaf + _QSCALE, scales[name].to(dev, torch.float32, copy=True)
            )
        else:
            module.register_parameter(leaf, nn.Parameter(
                value.to(dev, torch.float32, copy=True), requires_grad=False
            ))
    out.quantize = "int8"
    return out


# -- registry ------------------------------------------------------------------


def _build(defaults: dict, kwargs: dict) -> Gpt:
    device = kwargs.pop("device", None)
    seed = kwargs.pop("seed", 0)
    cfg = GptConfig(**{**defaults, **kwargs})
    return Gpt(cfg, device=device, seed=seed)


@register_model("gpt_small")
def gpt_small(**kwargs) -> Gpt:
    """GPT-2-small-shaped decoder (~124M params)."""
    return _build({}, kwargs)


@register_model("gpt_medium")
def gpt_medium(**kwargs) -> Gpt:
    """GPT-2-medium-shaped decoder (~350M params; head dim 64)."""
    return _build(
        dict(hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096),
        kwargs,
    )


@register_model("gpt_tiny")
def gpt_tiny(**kwargs) -> Gpt:
    """Test-scale config."""
    return _build(
        dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_len=128),
        kwargs,
    )
