"""Decoder-only causal LM (port of kubeflow_tpu/models/gpt.py).

Pre-LN residual blocks, token + position embeddings, f32 layernorms and
f32 logits, compute in `cfg.dtype` with f32 weights at rest, cast at use
(bit-identical to the JAX package's `DenseGeneral(dtype=...)`). Parameter
names and shapes are the flax tree's (`layers.<i>` for `layer_<i>`), so
`models/convert.py` moves JAX weights across by name.

Three forward paths, mirroring the JAX module's three branches:

- `forward`: the full causal pass, the training path. Its attention is
  `cfg.attention_impl`: "dense" (`ops/attention.py::dense_attention`),
  "flash" (`ops/flash_attention.py`, the CUDA forward/backward kernels on
  the card), "auto" (`ops/attention.py::auto_attention_impl` at the
  call's shape), or the sequence-parallel "ring"
  (`parallel/ring_attention.py`: K/V rotation with global-position
  causal masking) and "ulysses" (`parallel/ulysses.py`: the heads'
  all-to-all). Under a sequence axis (`parallel/mesh.py
  active_sequence()`, set by the training step) `input_ids` is this
  rank's shard of the sequence and its positions start at
  rank × shard length; the shard is kept in the call's context, so a
  remat recompute in the backward runs the same ring. Without one, ring
  and ulysses are dense attention, as in the JAX package. `cfg.remat` recomputes each block in the backward
  (`models/layers.py remat`, the JAX `nn.remat`), `return_hidden` hands
  the post-LN hidden states to a chunked loss, and in train mode
  `cfg.dropout_rate` drops attention and MLP outputs (`models/layers.py
  dropout`, masks from the caller's `dropout_generator`).
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

The serving paths (`prefill`, `decode`, `paged_forward`) run no sequence
axis, as the JAX engine takes none: under one they raise.

Caches are updated IN PLACE (the JAX programs donate and replace them).

`int8_model` builds the int8 serving model (`serving.quantize=int8`):
every quantized leaf is held as an int8 buffer plus an f32 per-channel
scale buffer and dequantized at its point of use with
`dequantize_params`' arithmetic. The JAX engine dequantizes the whole
tree at program entry; dequantizing each leaf where it is used gives
the same bits and keeps the resident weights int8.

With `cfg.num_experts > 0` every block's MLP is the routed `moe`
(`models/layers.py MoeMlp`; the `gpt_small_moe` and `gpt_tiny_moe`
presets) on every path; each forward takes an optional `moe` collector
that its layers report to (routed slots an expert, drops, the
load-balance loss): the LM task and the engine pass one. Built with
`expert=` (an `ExpertShard` of the expert mesh axis), a routed layer
holds this rank's block of the experts, drawn as world 1 draws the
whole stack (models/layers.py `MoeMlp`, `draw_value`).

Built with `fsdp=` (an `FsdpShard` of the fsdp mesh axis) the model
holds each leaf whose spec names `fsdp` as this rank's block along that
dim: every kernel on its embed dim, `pos_emb` and a `tok_emb` whose rows
the axis divides on their rows (gpt_small's 50,257 stay whole, as in the
JAX package), the head's kernel on its embed dim. Each block is gathered
at its use (models/layers.py `at_use`, `shard_fsdp`); the seeded init
draws every whole leaf as world 1 does and keeps the block.

Built with `tensor=` (a `TensorShard` of the tensor mesh axis) the model
holds each leaf whose spec names `tensor` as this rank's block, never
gathered (models/layers.py `shard_tensor`): `query`, `key` and `value`
are column-parallel over the heads, so a rank's attention (flash, dense,
or "auto", decided at the whole head count as world 1 decides it) runs
on its H/t heads, `out` and `mlp_wo` are row-parallel (their partial
products summed over the tensor group, the bias added once), `mlp_wi`
is column-parallel, an MoE block's stacks hold their mlp block, the
tables and the head are vocab-split where the axis divides their rows
(gpt_tiny's 512; gpt_small's 50,257 stay whole, by the JAX degradation
rule), the head's logits this rank's columns for a vocab-parallel loss
(training/tasks.py). Every dropout site sits after a row-parallel sum,
on the replicated stream, so every tensor rank draws world 1's masks.

With `cfg.pipeline_stages > 1` (the JAX `PipelinedDecoder`) the blocks
form stages of L/S consecutive layers. Built without `pipeline` the model
holds them all and `forward` runs the microbatches through the stages in
turn on one process (the JAX schedule's math; each stage's output
crosses in the compute dtype, and dropout draws each microbatch's rows
of the masks the unpipelined forward draws). Built with `pipeline` (a
`PipelineShard` of the pipeline mesh axis) it holds only its stage's
layers, keeping their flat `layers.<i>` names so that the seeded init
draws every layer as world 1 does, plus the embeddings on stage 0 and
`ln_final` and `head` on the last stage; the training step drives it a
stage at a time (`embed`, `stage`, `finish`; parallel/pipeline.py).
The serving paths raise on a pipelined model, as the JAX module does.

A model is built frozen, for serving (`requires_grad_(False)`, eval
mode). `trainable()` turns the f32 master weights trainable: every module
casts them to the compute dtype at use, so gradients land in f32, as in
the JAX package's mixed precision.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.checkpointing.quantize import (
    pack_quantized_params,
    quantize_params_int8,
)
from kubeflow_tpu_torch.models.layers import (
    QSCALE,
    Dense,
    Embed,
    LayerNorm,
    LayerStack,
    MoeCollector,
    MoeMlp,
    draw_value,
    dropout,
    gathered,
    held_layers,
    microbatch_rows,
    model_device,
    remat as remat_fn,
    shard_fsdp,
    shard_tensor,
    tensor_copy,
    whole_model,
)
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.ops.attention import (
    auto_attention_impl,
    dense_attention,
    dequant_kv,
    paged_kv_view,
    paged_write,
    paged_write_index,
    quantize_kv,
)
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.paged_attention import paged_attention
from kubeflow_tpu_torch.parallel.mesh import (
    SequenceShard,
    active_sequence,
    all_gather_bits,
    forward_sequence,
)
from kubeflow_tpu_torch.parallel.pipeline import (
    check_schedule,
    clamp_microbatches,
    pipeline_stage_slices,
)
from kubeflow_tpu_torch.parallel.ring_attention import ring_attention
from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

PAGED_ATTENTION_IMPLS = ("gather", "kernel")
QUANTIZE_CHOICES = ("none", "int8")
# "ring" (SP: KV rotation with global-position causal masking) and
# "ulysses" (SP: head all_to_all) complete the causal family's menu
GPT_ATTENTION_IMPLS = ("dense", "flash", "auto", "ring", "ulysses")
SEQUENCE_IMPLS = ("ring", "ulysses")


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
    # "dense" | "flash" | "auto" (`ops/attention.py auto_attention_impl`
    # at each forward's shape) | "ring" | "ulysses" (sequence parallel);
    # full causal pass only: serving's cached paths read through their
    # own kernels
    attention_impl: str = "dense"
    remat: bool = False
    # > 0 makes every MLP a routed MoE of this many experts
    # (models/layers.py MoeMlp)
    num_experts: int = 0
    moe_top_k: int = 1
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # pipeline parallelism (the JAX fields): > 1 cuts the blocks into
    # stages of num_layers / pipeline_stages layers, run over
    # num_microbatches microbatches (0: one a stage) by the schedule
    # (parallel/pipeline.py: "gpipe" | "1f1b")
    pipeline_stages: int = 1
    num_microbatches: int = 0
    pipeline_schedule: str = "gpipe"

    def __post_init__(self):
        if self.attention_impl not in GPT_ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; known: "
                f"{GPT_ATTENTION_IMPLS}"
            )
        check_schedule(self.pipeline_schedule)
        pipeline_stage_slices(self.num_layers, self.pipeline_stages)

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

    def fields(self) -> dict:
        """{field name: tensor} of every pool tensor: "k", "v", then
        "k_scale", "v_scale" when int8."""
        return {name: t for name, t in (
            ("k", self.k), ("v", self.v), ("k_scale", self.k_scale),
            ("v_scale", self.v_scale)) if t is not None}

    def tensors(self):
        """Every pool tensor: values, then scales when int8."""
        return list(self.fields().values())

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
    plain version on CPU tensors), the counterpart of the JAX "pallas".

    `heads` (a serving mesh's `HeadShard`, parallel/serving_mesh.py; the
    JAX `PagedState.mesh`): the pool holds this rank's heads, so q, k and
    v are cut to them before the writes and the read, and the attention
    output is gathered on heads before the out projection."""

    page_table: torch.Tensor
    cache_index: torch.Tensor
    attn_impl: str = "gather"
    heads: Optional[object] = None


# -- per-call attention contexts: what each layer does with its q/k/v --------


class _Causal:
    """The full causal pass. `train`: dropout draws its masks from
    `dropout_gen`; the serving contexts below never train."""

    train = False
    dropout_gen: Optional[torch.Generator] = None
    # the forward's MoE reports (models/layers.py MoeCollector), or None
    moe: Optional[MoeCollector] = None
    # the sequence axis this forward's tokens are sharded over, or None
    seq: Optional[SequenceShard] = None

    def __init__(self, mask: Optional[torch.Tensor], dtype,
                 impl: str = "dense"):
        self.mask, self.dtype, self.impl = mask, dtype, impl

    def attend(self, layer, q, k, v):
        if self.impl == "flash":
            return flash_attention(
                q, k, v, mask=self.mask, causal=True
            ).to(self.dtype)
        if self.impl == "ring":
            return ring_attention(q, k, v, mask=self.mask, dtype=self.dtype,
                                  causal=True, shard=self.seq)
        if self.impl == "ulysses":
            return ulysses_attention(q, k, v, mask=self.mask,
                                     dtype=self.dtype, causal=True,
                                     shard=self.seq)
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

    train = False
    dropout_gen = None
    moe: Optional[MoeCollector] = None
    # the serving paths run no sequence axis
    seq = None

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

    train = False
    dropout_gen = None
    moe: Optional[MoeCollector] = None
    # the serving paths run no sequence axis
    seq = None

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
        heads = self.paged.heads
        if heads is not None:
            # the new K/V vectors enter the pool's layout before the
            # writes, so each rank writes and reads its own heads (a
            # slice: bits unchanged)
            q, k, v = heads.local(q), heads.local(k), heads.local(v)
        out = self._attend_local(layer, q, k, v)
        if heads is not None:
            # every head before the out projection, whose contraction is
            # the heads dim: split, it would sum in another order
            out = heads.gather(out)
        return out

    def _attend_local(self, layer, q, k, v):
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

class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GptConfig):
        super().__init__()
        d, h, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.query = Dense((d,), (h, hd), cfg.dtype)
        self.key = Dense((d,), (h, hd), cfg.dtype)
        self.value = Dense((d,), (h, hd), cfg.dtype)
        self.out = Dense((h, hd), (d,), cfg.dtype)

    def forward(self, x, ctx, layer: int):
        # on a tensor axis q, k and v are this rank's heads (column
        # blocks) and `out` sums the heads' partial products (a row block)
        x = tensor_copy(self.query, x)
        q, k, v = self.query(x), self.key(x), self.value(x)
        return self.out(ctx.attend(layer, q, k, v))


class DecoderBlock(nn.Module):
    """Pre-LN residual block; with `cfg.num_experts > 0` its MLP is the
    routed `moe` (MoeMlp) on every path, reporting to the call's
    collector (`ctx.moe`); `expert` (an `ExpertShard`) makes it this
    rank's block of the experts."""

    # dropout masks a training forward draws (attention out, MLP out)
    DROPOUT_DRAWS = 2

    def __init__(self, cfg: GptConfig, expert=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.dropout_rate = cfg.dropout_rate
        self.ln_att = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.attention = CausalSelfAttention(cfg)
        self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.routed = cfg.num_experts > 0
        if self.routed:
            self.moe = MoeMlp(
                cfg.hidden_size, cfg.mlp_dim, cfg.num_experts, cfg.dtype,
                top_k=cfg.moe_top_k,
                capacity_factor=cfg.expert_capacity_factor,
                aux_weight=cfg.moe_aux_weight, dropout_rate=cfg.dropout_rate,
                expert=expert,
            )
        else:
            self.mlp_wi = Dense((cfg.hidden_size,), (cfg.mlp_dim,), cfg.dtype)
            self.mlp_wo = Dense((cfg.mlp_dim,), (cfg.hidden_size,), cfg.dtype)

    def forward(self, x, ctx, layer: int):
        # on a serving mesh the block's leaves are gathered here, at once
        with gathered(self):
            return self._forward(x, ctx, layer)

    def _forward(self, x, ctx, layer: int):
        h = self.ln_att(x)
        h = self.attention(h.to(self.dtype), ctx, layer)
        x = x + dropout(h, self.dropout_rate, ctx.dropout_gen, not ctx.train)
        h = self.ln_mlp(x).to(self.dtype)
        if self.routed:
            return x + self.moe(h, ctx.moe, ctx.dropout_gen, ctx.train,
                                ctx.seq)
        h = tensor_copy(self.mlp_wi, h)
        h = self.mlp_wo(F.gelu(self.mlp_wi(h), approximate="tanh"))
        return x + dropout(h, self.dropout_rate, ctx.dropout_gen, not ctx.train)


def _no_sequence_axis(path: str) -> None:
    seq = active_sequence()
    if seq is not None:
        raise ValueError(f"the {path} paths run no sequence axis (shard "
                         f"{seq.rank} of {seq.size} is active)")


def init_params(model: nn.Module, seed: int) -> None:
    """Seeded init from an explicit CPU torch.Generator (the same weights
    on every device): layernorm scales 1, biases 0, every kernel and
    embedding N(0, 0.02). A sharded expert stack draws its whole value
    and keeps its block (`layers.draw_value`), so does an fsdp block,
    and a pipeline stage draws every stage's leaves and keeps its own:
    world 1's weights."""
    gen = torch.Generator().manual_seed(int(seed))
    whole = whole_model(model)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in whole.named_parameters():
            owner, _, leaf = name.rpartition(".")
            mine = own.get(name)
            if leaf in ("scale", "bias"):
                if mine is not None:
                    mine.fill_(1.0 if leaf == "scale" else 0.0)
                continue
            value = draw_value(whole.get_submodule(owner), leaf,
                               lambda shape: (
                                   torch.randn(shape, generator=gen) * 0.02))
            if mine is not None:
                mine.copy_(value)


class Gpt(nn.Module):
    """Decoder-only LM: token+position embeddings → N blocks → LM head.
    `expert` (an `ExpertShard` of the expert mesh axis) builds an MoE
    model's routed layers for this rank's block of the experts;
    `pipeline` (a `PipelineShard` of the pipeline mesh axis) builds this
    rank's stage of a pipelined model, `fsdp` (an `FsdpShard`) this
    rank's blocks of the fsdp leaves (module docstring)."""

    # the JAX pipelined tree's stacked module, and the model-level
    # leaves the first and the last stage hold
    STAGE_PREFIX = "decoder"
    FIRST_STAGE = ("tok_emb", "pos_emb")
    LAST_STAGE = ("ln_final", "head")

    def __init__(self, cfg: GptConfig, *, device: DeviceLike = None,
                 seed: int = 0, expert=None, pipeline=None, fsdp=None,
                 tensor=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.expert, self.pipeline = expert, pipeline
        self.fsdp = self.tensor = None
        first = pipeline is None or pipeline.first
        last = pipeline is None or pipeline.last
        if first:
            self.tok_emb = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype)
            self.pos_emb = Embed(cfg.max_len, cfg.hidden_size, cfg.dtype)
        self.layers = LayerStack({
            i: DecoderBlock(cfg, expert) for i in held_layers(
                cfg.num_layers, cfg.pipeline_stages, pipeline)})
        if last:
            self.ln_final = LayerNorm(cfg.hidden_size, cfg.dtype)
            self.head = Dense(
                (cfg.hidden_size,), (cfg.vocab_size,), cfg.dtype,
                use_bias=False
            )
        # "int8" once `int8_model` has loaded an envelope
        self.quantize = "none"
        shard_fsdp(self, fsdp)
        shard_tensor(self, tensor)
        if dev.type != "meta":  # a meta model has shapes only
            init_params(self, seed)
        self.to(dev)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def weight_bytes(self) -> int:
        """Bytes of the resident weights (parameters and int8 buffers)."""
        return sum(t.numel() * t.element_size()
                   for t in self.state_dict().values())

    def init_params(self, seed: int) -> None:
        """The seeded init, in place (`init_params` above)."""
        init_params(self, seed)

    def trainable(self) -> "Gpt":
        """Make the f32 master weights trainable (train mode); returns
        self. Serving keeps the frozen model the constructor builds."""
        self.requires_grad_(True)
        self.train()
        return self

    def _blocks(self, x, ctx, remat: bool = False, first: int = 0,
                count: Optional[int] = None):
        """x through the held blocks [first, first + count) of this
        model's run (all of them by default)."""
        blocks = self.layers.items()
        for i, block in blocks[first:None if count is None
                               else first + count]:
            if remat:
                x = remat_fn(block, ctx.dropout_gen, x, ctx, i)
            else:
                x = block(x, ctx, i)
        return x

    def _embed(self, input_ids, positions):
        return (self.tok_emb(input_ids) + self.pos_emb(positions)).to(
            self.cfg.dtype)

    def _hidden(self, input_ids, positions, ctx, remat: bool = False):
        """Embeddings → blocks → ln_final: f32 hidden states [B, S, D]."""
        x = self._embed(input_ids, positions)
        if self.cfg.pipeline_stages > 1:
            x = self._pipelined(x, ctx, remat)
        else:
            x = self._blocks(x, ctx, remat)
        return self.ln_final(x)

    def _pipelined(self, x, ctx, remat: bool):
        """The stages in turn on one process, microbatch by microbatch
        (the JAX `PipelinedDecoder`'s math): each stage's output crosses
        in the compute dtype, and each microbatch's dropout masks are its
        rows of the unpipelined forward's (the generator replayed from
        its state at the first layer)."""
        if self.pipeline is not None:
            raise ValueError(
                f"this model holds pipeline stage {self.pipeline.rank} of "
                f"{self.pipeline.size}: the training step's schedule drives "
                f"it (embed, stage, finish)")
        cfg = self.cfg
        per, stages = pipeline_stage_slices(cfg.num_layers,
                                            cfg.pipeline_stages)
        b = x.shape[0]
        m = clamp_microbatches(cfg.num_microbatches, stages, b)
        rows = b // m
        gen = ctx.dropout_gen
        state = None if gen is None else gen.get_state()
        outs = []
        for j in range(m):
            if gen is not None:
                gen.set_state(state)
            sub = _Causal(None if ctx.mask is None
                          else ctx.mask[j * rows:(j + 1) * rows],
                          ctx.dtype, ctx.impl)
            sub.train, sub.dropout_gen = ctx.train, gen
            sub.moe, sub.seq = ctx.moe, ctx.seq
            h = x[j * rows:(j + 1) * rows]
            with microbatch_rows(j * rows, b):
                for s in range(stages):
                    h = self._blocks(h, sub, remat, s * per, per)
                    if s < stages - 1:
                        h = h.to(cfg.dtype)
            outs.append(h)
        return torch.cat(outs)

    def _attention_impl(self, b: int, s: int, device) -> str:
        """The config's attention, "auto" resolved at this call's shape
        (`auto_attention_impl`, causal)."""
        impl = self.cfg.attention_impl
        if impl != "auto":
            return impl
        return auto_attention_impl(b, s, self.cfg.num_heads, self.cfg.dtype,
                                   causal=True, device=device)

    def _run(self, input_ids, positions, ctx, moe=None):
        _no_sequence_axis("serving")
        if self.cfg.pipeline_stages > 1:
            raise ValueError(
                "pipelined decoding is not supported: serve with "
                "pipeline_stages=1 (the KV-cache decode path has no "
                "microbatch schedule)")
        ctx.moe = moe
        x = self._hidden(input_ids, positions, ctx)
        return self._logits(x)

    def _logits(self, x):
        """f32 logits of f32 hidden states: the head in the compute dtype
        (this rank's vocab columns when the head is vocab-split)."""
        return self.head(tensor_copy(self.head, x.to(self.cfg.dtype))
                         ).float()

    def _causal(self, mask, b: int, s: int, device, dropout_generator,
                moe) -> _Causal:
        """The full causal pass's per-call context."""
        ctx = _Causal(None if mask is None else mask.bool(), self.cfg.dtype,
                      self._attention_impl(b, s, device))
        ctx.seq = forward_sequence(ctx.impl, SEQUENCE_IMPLS)
        ctx.train, ctx.dropout_gen = self.training, dropout_generator
        ctx.moe = moe
        return ctx

    def forward(self, input_ids, attention_mask=None, return_hidden=False,
                dropout_generator: Optional[torch.Generator] = None,
                moe: Optional[MoeCollector] = None):
        """Full causal pass → f32 logits [B, S, V]. `attention_mask`
        [B, S] marks real tokens (None = no padding, so the flash kernel
        runs unmasked). `return_hidden=True` returns the post-LN f32
        hidden states [B, S, D] instead (the chunked loss streams the
        head itself). Under `cfg.remat` and grad mode every block is
        recomputed in the backward. In train mode with
        `cfg.dropout_rate > 0` dropout draws its masks from
        `dropout_generator` (on the model's device). An MoE model's
        layers report to `moe` (every forward path takes one)."""
        b, s = input_ids.shape
        ctx = self._causal(attention_mask, b, s, input_ids.device,
                           dropout_generator, moe)
        first = 0 if ctx.seq is None else ctx.seq.offset(s)
        positions = torch.arange(first, first + s,
                                 device=input_ids.device)[None, :]
        remat = self.cfg.remat and torch.is_grad_enabled()
        x = self._hidden(input_ids, positions, ctx, remat=remat)
        if return_hidden:
            return x
        return self._logits(x)

    # -- a pipeline stage's parts (training/trainer.py runs them) ------------

    def embed(self, input_ids, token_type_ids=None):
        """Stage 0: token + position embeddings → [B, S, D] in the
        compute dtype (`token_type_ids` is BERT's; ignored)."""
        s = input_ids.shape[1]
        return self._embed(input_ids, torch.arange(
            s, device=input_ids.device)[None, :])

    def stage(self, x, attention_mask=None,
              dropout_generator: Optional[torch.Generator] = None,
              moe: Optional[MoeCollector] = None):
        """x through this model's blocks (a stage's run), remat and
        dropout as in `forward` → [B, S, D] in the compute dtype."""
        b, s = x.shape[:2]
        ctx = self._causal(attention_mask, b, s, x.device,
                           dropout_generator, moe)
        return self._blocks(x, ctx, self.cfg.remat and
                            torch.is_grad_enabled())

    def finish(self, x, return_hidden: bool = False):
        """The last stage: ln_final → f32 hidden states, or with the head
        f32 logits."""
        x = self.ln_final(x)
        if return_hidden:
            return x
        return self._logits(x)

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

    def prefill(self, input_ids, attention_mask=None,
                moe: Optional[MoeCollector] = None):
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
            _SlotPrefill(cache, mask, self.cfg.dtype,
                         self._attention_impl(b, s, input_ids.device)), moe,
        )
        return logits, cache

    def decode(self, input_ids, cache: SlotCache,
               moe: Optional[MoeCollector] = None):
        """Decode step(s) over the slot cache (updated in place) → f32
        logits [B, s, V]."""
        s = input_ids.shape[1]
        ctx = _SlotDecode(cache, s, self.cfg.dtype)
        positions = cache.position[:, None] + torch.arange(
            s, device=input_ids.device
        )[None, :]
        logits = self._run(input_ids, positions, ctx, moe)
        cache.index += s
        cache.position = cache.position + s
        return logits

    def paged_forward(self, input_ids, pool: KVPool, paged: PagedState,
                      moe: Optional[MoeCollector] = None):
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
            input_ids, positions, _Paged(pool, paged, s, self.cfg.dtype), moe
        )


# -- block-paged pool helpers (serving/engine.py's device state) ---------------


def make_paged_pool(cfg: GptConfig, num_pages: int, page_size: int,
                    device, kv_quant: str = "none", heads=None) -> KVPool:
    """Zeroed K/V pool [L, num_pages, page_size, H, D] per side, in the
    compute dtype; `kv_quant="int8"` stores int8 values plus zeroed bf16
    scales [L, num_pages, page_size, H, 1] per side. With `heads` (a
    serving mesh's `HeadShard`) H is this rank's share of the heads."""
    if kv_quant not in QUANTIZE_CHOICES:
        raise ValueError(f"kv_quant {kv_quant!r} not in {QUANTIZE_CHOICES}")
    num_heads = cfg.num_heads if heads is None \
        else heads.heads(cfg.num_heads)[1]
    shape = (cfg.num_layers, num_pages, page_size, num_heads, cfg.head_dim)
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


def insert_pages(pool: KVPool, cache_one: SlotCache, page_ids, real_len: int,
                 heads=None):
    """Copy a batch-1 prefill cache's K/V rows [0, real_len) into the
    pool pages `page_ids` (in place): cache rows [c*ps, (c+1)*ps) land
    on page page_ids[c] for every chunk holding at least one real row.
    Pad rows inside the last chunk land past the cursor, stay invisible,
    and are overwritten by decode. An int8 pool gets the copied rows
    quantized (JAX `quantize_kv_cache`; quantization is per vector, so
    quantizing only these rows gives the bits of quantizing all). With
    `heads` (a serving mesh's `HeadShard`) the whole cache's rows are cut
    to this rank's heads, the pool's."""
    ps = pool.page_size
    n = -(-int(real_len) // ps)
    ids = torch.as_tensor(
        [int(p) for p in page_ids[:n]], dtype=torch.long,
        device=pool.k.device,
    )
    lead = pool.k.shape[0]
    rows = [cache_one.k[:, 0, : n * ps], cache_one.v[:, 0, : n * ps]]
    if heads is not None:
        rows = [heads.local(r) for r in rows]
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


def gather_pool_pages(pool: KVPool, pages: Sequence[int], device=None,
                      out: Optional[Sequence[dict]] = None,
                      heads=None) -> List[dict]:
    """Pages `pages` of every pool tensor as page-axis-free copies, one
    dict a page ({field: [L, page_size, H, D]}, and an int8 pool's [L,
    page_size, H, 1] bf16 scales): the spill tier's, the store's and the
    handoff's device→host read. One gather per pool tensor; without
    `out`, one copy moves all the pages to `device` (default: the
    pool's; to the CPU through a pinned staging buffer) and the pages
    are views of it; with `out` (page trees of preallocated host
    tensors, e.g. the host tier's arena slots), each page is copied into
    its tree. A copy to the CPU is complete when this returns, so the
    engine may overwrite the pages right after. Pure data movement: the
    gathered bits are the pool's. With `heads` (a serving mesh's
    `HeadShard`; a collective of the tensor group) each rank's heads
    are gathered first: the pages come out whole."""
    dev = torch.device(device) if device is not None else pool.k.device
    idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                          device=pool.k.device)
    result = list(out) if out is not None else [{} for _ in pages]
    for name, t in pool.fields().items():
        block = t.index_select(1, idx).transpose(0, 1)  # [n, L, ps, H, D]
        if heads is not None:
            block = all_gather_bits(block, heads.axis.group, block.dim() - 2)
        if out is not None:
            for page, part in zip(result, block.contiguous().unbind(0)):
                page[name].copy_(part)
            continue
        if block.device != dev:
            staged = torch.empty(block.shape, dtype=block.dtype,
                                 pin_memory=block.is_cuda and dev.type == "cpu")
            staged.copy_(block)
            block = staged
        for page, part in zip(result, block.unbind(0)):
            page[name] = part
    return result


def gather_pool_page(pool: KVPool, page: int, device=None) -> dict:
    """One page of `gather_pool_pages`."""
    return gather_pool_pages(pool, [page], device)[0]


def scatter_pool_pages(pool: KVPool, page_trees: Sequence[dict],
                       dsts: Sequence[int], heads=None) -> KVPool:
    """Write gathered pages (`gather_pool_pages`' shape, any device)
    onto pool pages `dsts`, in place: the host tier's upload and the
    prefix store's preload. Each page is copied into one block on the
    pool's device (asynchronously from pinned host pages, such as the
    host tier's arena slots: the stream orders the copies before any
    later write of their slots) and one indexed copy a pool tensor
    places them all. The inverse of `gather_pool_pages`, so uploaded
    bits equal the gathered ones. A page whose fields or shapes differ
    from the pool's raises ValueError before anything is written. With
    `heads` (a serving mesh's `HeadShard`) the pages are whole and each
    rank writes its own heads of them."""
    fields = pool.fields()
    for page in page_trees:
        if sorted(page) != sorted(fields):
            raise ValueError(f"page fields {sorted(page)} do not match the "
                             f"pool's {sorted(fields)}")
        for name, t in fields.items():
            want = pool_page_shape(t, heads)
            if tuple(page[name].shape) != tuple(want):
                raise ValueError(f"page field {name!r} has shape "
                                 f"{tuple(page[name].shape)}, the pool's "
                                 f"page is {tuple(want)}")
    if len(page_trees) != len(dsts):
        raise ValueError(f"{len(page_trees)} pages for {len(dsts)} "
                         "destinations")
    if not page_trees:
        return pool
    idx = torch.as_tensor([int(d) for d in dsts], dtype=torch.long,
                          device=pool.k.device)
    for name, t in fields.items():
        block = t.new_empty((len(page_trees),) + t.shape[:1] + t.shape[2:])
        for part, page in zip(block.unbind(0), page_trees):
            part.copy_(page[name] if heads is None else
                       page[name].narrow(-2, *heads.heads(
                           page[name].shape[-2])), non_blocking=True)
        t.index_copy_(1, idx, block.transpose(0, 1))
    return pool


def pool_page_shape(t: torch.Tensor, heads=None) -> tuple:
    """The shape of one page of pool tensor `t` ([L, P, ps, H, D] → [L,
    ps, H, D]), whole over a serving mesh's `heads` when given (the
    pages that leave and enter the engine are whole)."""
    shape = list(t.shape[:1] + t.shape[2:])
    if heads is not None:
        shape[-2] *= heads.size
    return tuple(shape)


def scatter_pool_page(pool: KVPool, page_tree: dict, dst: int) -> KVPool:
    """One page of `scatter_pool_pages`."""
    return scatter_pool_pages(pool, [page_tree], [dst])


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
    if getattr(model, "serving_mesh", None) is not None:
        raise ValueError("int8_model quantizes whole weights: build it "
                         "before the serving mesh cuts the model's leaves")
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
    for name, value in pack_quantized_params(envelope).items():
        owner, _, leaf = name.rpartition(".")
        module = out.get_submodule(owner)
        del module._parameters[leaf]
        if isinstance(value, dict):
            if value["qvalue"].dtype != torch.int8:
                raise ValueError(
                    f"int8 envelope: {name} is {value['qvalue'].dtype}")
            module.register_buffer(leaf, value["qvalue"].to(dev, copy=True))
            module.register_buffer(leaf + QSCALE, value["qscale"].to(
                dev, torch.float32, copy=True))
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
    expert = kwargs.pop("expert", None)
    pipeline = kwargs.pop("pipeline", None)
    fsdp = kwargs.pop("fsdp", None)
    tensor = kwargs.pop("tensor", None)
    cfg = GptConfig(**{**defaults, **kwargs})
    return Gpt(cfg, device=device, seed=seed, expert=expert,
               pipeline=pipeline, fsdp=fsdp, tensor=tensor)


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


@register_model("gpt_small_moe")
def gpt_small_moe(**kwargs) -> Gpt:
    """GPT-2-small with every MLP a Switch MoE (8 experts by default;
    ~559M params)."""
    return _build(dict(num_experts=8), kwargs)


@register_model("gpt_tiny")
def gpt_tiny(**kwargs) -> Gpt:
    """Test-scale config."""
    return _build(
        dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_len=128),
        kwargs,
    )


@register_model("gpt_tiny_moe")
def gpt_tiny_moe(**kwargs) -> Gpt:
    """Test-scale MoE config (4 experts)."""
    return _build(
        dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_len=128, num_experts=4),
        kwargs,
    )
