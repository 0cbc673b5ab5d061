"""BERT encoder with MLM and next-sentence heads (port of
kubeflow_tpu/models/bert.py): the source system's BERT-base pretrain
vehicle.

Parameter names and shapes are the flax tree's (`layers.<i>` for
`layer_<i>`), so `models/convert.py` moves JAX weights across by name:
`tok_emb`, `pos_emb`, `seg_emb`, `ln_emb`, per layer
`attention/{query,key,value,out}` (q/k/v kernels [D, H, Dh] with [H, Dh]
biases, `out` [H, Dh, D]), `ln_att`, `mlp/{wi,wo}`, `ln_mlp`, then
`mlm_transform`, `mlm_ln`, `mlm_out`, `pooler` and `nsp_out`.

The dtype flow is the JAX module's. The three embedding lookups sum in
the compute dtype; `ln_emb` normalizes in f32 and its output is cast to
the compute dtype before layer 0. Every later LayerNorm returns f32, so
`x + y` promotes and the residual stream between layers is f32; each
layer's projections cast it back down. The MLM head runs in the compute
dtype and casts its logits to f32; `nsp_out` is an f32 Dense on the
pooled CLS row (returned as `pooled`, in the compute dtype).

Attention is `cfg.attention_impl`: "dense" (`ops/attention.py
dense_attention`), "flash" (`ops/flash_attention.py`, bidirectional: the
CUDA forward and backward kernels on the card, their plain versions on
the CPU), "auto" (`ops/attention.py auto_attention_impl` at the call's
shape), or the sequence-parallel "ring" (`parallel/ring_attention.py`)
and "ulysses" (`parallel/ulysses.py`). Under a sequence axis
(`parallel/mesh.py active_sequence()`, set by the training step)
`input_ids` is this rank's shard of the sequence, its positions start
at rank × shard length, and `pooled` / `nsp_logits` are the [CLS] row's
on sequence rank 0 only (another rank's row 0 is not [CLS]: the MLM task
counts next-sentence prediction on rank 0 alone). Without a sequence
axis ring and ulysses are dense attention, as in the JAX package. `attention_mask=None` stays None down to the kernel, which then
runs unmasked; a given mask is cast to bool (the kernel takes it as
int32). Flash and dense differ only on a row with no visible key (flash
gives 0, dense a uniform mix). `cfg.remat` recomputes each layer in the
backward, and in train mode `cfg.dropout_rate` drops the attention and
MLP outputs (`models/layers.py`), drawing masks from the caller's
`dropout_generator`.

The seeded init follows flax's initializers' distributions from an
explicit CPU `torch.Generator` (the same weights on every device):
Dense kernels lecun-normal (a normal truncated at two standard
deviations, variance 1 / fan-in), `nn.Embed` tables normal with variance
1 / width, zero biases, LayerNorm scale 1 and bias 0. Like the GPT
family a model is built frozen in eval mode; `trainable()` turns the f32
master weights trainable.

With `num_experts > 0` every layer's MLP is the routed `moe`
(`models/layers.py MoeMlp`, param tree `moe/{router,wi,wo}`; the
`bert_base_moe` and `bert_tiny_moe` presets), fed the f32 residual
stream as the JAX layer feeds it, so its expert products run in f32;
its reports go to the forward's `moe` collector. Its init: the router
normal(0.02), the expert stacks variance-scaled truncated normals over
their fan-in (flax's initializers). Built with `expert=` (an
`ExpertShard`), a routed layer holds this rank's block of the experts,
drawn as world 1 draws the whole stack.

With `pipeline_stages > 1` (the JAX `PipelinedEncoder`) the layers form
stages of L/S consecutive layers, as in models/gpt.py: built without
`pipeline` the model runs the microbatches through every stage in turn
on one process (each stage's output crossing in the compute dtype, the
JAX schedule's roll), and built with `pipeline` (a `PipelineShard`) it
holds only its stage's layers under their flat names, the embeddings
(`tok_emb`, `pos_emb`, `seg_emb`, `ln_emb`) on stage 0 and the MLM and
next-sentence heads on the last stage, for the training step's schedule
(`embed`, `stage`, `heads`).

Built with `tensor=` (a `TensorShard` of the tensor mesh axis) the model
holds each leaf whose spec names `tensor` as this rank's block, never
gathered (models/layers.py `shard_tensor`), as models/gpt.py does: the
attention column-parallel over heads with `out` row-parallel, `mlp/wi`
column- and `mlp/wo` row-parallel, `mlm_out` vocab-split (its logits
this rank's columns, for training/tasks.py's vocab-parallel loss), and
the `tok_emb`, `pos_emb` and `seg_emb` tables split on their rows and
looked up by mask (bert_base's 2-row `seg_emb` a row a rank at tensor
2). Both dropout sites follow a row-parallel sum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.layers import (
    EXPERT_STACKS,
    Dense,
    Embed,
    LayerNorm,
    LayerStack,
    MoeCollector,
    MoeMlp,
    draw_value,
    dropout,
    held_layers,
    microbatch_rows,
    model_device,
    remat as remat_fn,
    shard_fsdp,
    shard_tensor,
    tensor_copy,
    whole_leaf_shape,
    whole_model,
)
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.ops.attention import (
    auto_attention_impl,
    dense_attention,
)
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel.mesh import SequenceShard, forward_sequence
from kubeflow_tpu_torch.parallel.pipeline import (
    check_schedule,
    clamp_microbatches,
    pipeline_stage_slices,
)
from kubeflow_tpu_torch.parallel.ring_attention import ring_attention
from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

ATTENTION_IMPLS = ("dense", "ring", "ulysses", "flash", "auto")
SEQUENCE_IMPLS = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # "dense" | "ring" (SP: KV rotation) | "ulysses" (SP: head
    # all_to_all) | "flash" | "auto"
    attention_impl: str = "dense"
    remat: bool = False
    # pipeline parallelism (the JAX fields; models/gpt.py GptConfig)
    pipeline_stages: int = 1
    num_microbatches: int = 0
    pipeline_schedule: str = "gpipe"
    # > 0 makes every MLP a routed MoE of this many experts
    num_experts: int = 0
    moe_top_k: int = 1
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; known: "
                f"{ATTENTION_IMPLS}"
            )
        check_schedule(self.pipeline_schedule)
        pipeline_stage_slices(self.num_layers, self.pipeline_stages)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass
class _Call:
    """What every layer of one forward shares: the bool key mask (or
    None), the resolved attention, dropout's generator and mode, and the
    MoE layers' collector."""

    mask: Optional[torch.Tensor]
    impl: str
    generator: Optional[torch.Generator]
    train: bool
    moe: Optional[MoeCollector] = None
    # the sequence axis this forward's tokens are sharded over, or None
    seq: Optional[SequenceShard] = None


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, h, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.cfg = cfg
        self.query = Dense((d,), (h, hd), cfg.dtype)
        self.key = Dense((d,), (h, hd), cfg.dtype)
        self.value = Dense((d,), (h, hd), cfg.dtype)
        self.out = Dense((h, hd), (d,), cfg.dtype)

    def forward(self, x, call: _Call):
        dtype = self.cfg.dtype
        # on a tensor axis q, k and v are this rank's heads and `out` sums
        # their partial products (before the dropout: a replicated site)
        x = tensor_copy(self.query, x)
        q, k, v = self.query(x), self.key(x), self.value(x)
        if call.impl == "flash":
            out = flash_attention(q, k, v, mask=call.mask).to(dtype)
        elif call.impl == "ring":
            out = ring_attention(q, k, v, mask=call.mask, dtype=dtype,
                                 shard=call.seq)
        elif call.impl == "ulysses":
            out = ulysses_attention(q, k, v, mask=call.mask, dtype=dtype,
                                    shard=call.seq)
        else:
            out = dense_attention(q, k, v, mask=call.mask, dtype=dtype)
        return dropout(self.out(out), self.cfg.dropout_rate, call.generator,
                       not call.train)


class Mlp(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.wi = Dense((cfg.hidden_size,), (cfg.mlp_dim,), cfg.dtype)
        self.wo = Dense((cfg.mlp_dim,), (cfg.hidden_size,), cfg.dtype)

    def forward(self, x, call: _Call):
        x = tensor_copy(self.wi, x)
        h = self.wo(F.gelu(self.wi(x), approximate="tanh"))
        return dropout(h, self.cfg.dropout_rate, call.generator,
                       not call.train)


class EncoderLayer(nn.Module):
    """Post-LN residual layer: f32 LayerNorms over x + y (layer 0's x is
    in the compute dtype, every later one's f32); `expert` (an
    `ExpertShard`) makes a routed layer this rank's block of the
    experts."""

    # dropout masks a training forward draws (attention out, MLP out)
    DROPOUT_DRAWS = 2

    def __init__(self, cfg: BertConfig, expert=None):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.ln_att = LayerNorm(cfg.hidden_size, cfg.dtype)
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
            self.mlp = Mlp(cfg)
        self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.dtype)

    def forward(self, x, call: _Call):
        x = self.ln_att(x + self.attention(x, call))
        if self.routed:
            return self.ln_mlp(x + self.moe(x, call.moe, call.generator,
                                            call.train, call.seq))
        return self.ln_mlp(x + self.mlp(x, call))


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (jax.random.truncated_normal's
    inverse-CDF construction)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=gen)
    return math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)


def init_params(model: nn.Module, seed: int) -> None:
    """flax's initializers' distributions (module docstring), from an
    explicit CPU torch.Generator. A pipeline stage draws every stage's
    leaves and keeps its own, and an fsdp block draws its whole leaf and
    keeps the block: world 1's weights."""
    gen = torch.Generator().manual_seed(int(seed))
    own = dict(model.named_modules())
    with torch.no_grad():
        for name, module in whole_model(model).named_modules():
            mine = own.get(name)
            if isinstance(module, Dense):
                # lecun_normal: variance_scaling(1, fan_in, truncated_normal)
                std = math.sqrt(1.0 / module.fan_in) / 0.87962566103423978
                value = draw_value(module, "kernel", lambda shape: (
                    _truncated_normal(shape, gen) * std))
                if mine is not None:
                    mine.kernel.copy_(value)
                    if mine.bias is not None:
                        mine.bias.zero_()
            elif isinstance(module, Embed):
                # nn.Embed: variance_scaling(1, fan_in, normal, out_axis=0)
                dim = whole_leaf_shape(module, "embedding")[1]
                value = draw_value(module, "embedding", lambda shape: (
                    torch.randn(shape, generator=gen) / math.sqrt(dim)))
                if mine is not None:
                    mine.embedding.copy_(value)
            elif isinstance(module, LayerNorm):
                if mine is not None:
                    mine.scale.fill_(1.0)
                    mine.bias.zero_()
            elif isinstance(module, MoeMlp):
                value = draw_value(module, "router", lambda shape: (
                    torch.randn(shape, generator=gen) * 0.02))
                if mine is not None:
                    mine.router.copy_(value)
                for leaf in EXPERT_STACKS:
                    # variance_scaling(1, fan_in, truncated_normal) over
                    # [E, in, out]: the fan-in is the in axis; a sharded
                    # stack draws the whole [E, ...] and keeps its block
                    std = math.sqrt(
                        1.0 / whole_leaf_shape(module, leaf)[-2]
                    ) / 0.87962566103423978
                    value = draw_value(module, leaf, lambda shape: (
                        _truncated_normal(shape, gen) * std))
                    if mine is not None:
                        getattr(mine, leaf).copy_(value)


class Bert(nn.Module):
    """BERT encoder: embeddings → N post-LN layers → MLM and NSP heads.
    `expert` (an `ExpertShard` of the expert mesh axis) builds an MoE
    model's routed layers for this rank's block of the experts;
    `pipeline` (a `PipelineShard`) builds this rank's pipeline stage,
    `fsdp` (an `FsdpShard`) its blocks of the fsdp leaves (each gathered
    at its use: models/layers.py `shard_fsdp`)."""

    # the JAX pipelined tree's stacked module, and the model-level
    # leaves the first and the last stage hold
    STAGE_PREFIX = "encoder"
    FIRST_STAGE = ("tok_emb", "pos_emb", "seg_emb", "ln_emb")
    LAST_STAGE = ("mlm_transform", "mlm_ln", "mlm_out", "pooler", "nsp_out")

    def __init__(self, cfg: BertConfig, *, device: DeviceLike = None,
                 seed: int = 0, expert=None, pipeline=None, fsdp=None,
                 tensor=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.expert, self.pipeline = expert, pipeline
        self.fsdp = self.tensor = None
        d = cfg.hidden_size
        if pipeline is None or pipeline.first:
            self.tok_emb = Embed(cfg.vocab_size, d, cfg.dtype)
            self.pos_emb = Embed(cfg.max_len, d, cfg.dtype)
            self.seg_emb = Embed(cfg.type_vocab_size, d, cfg.dtype)
            self.ln_emb = LayerNorm(d, cfg.dtype)
        self.layers = LayerStack({
            i: EncoderLayer(cfg, expert) for i in held_layers(
                cfg.num_layers, cfg.pipeline_stages, pipeline)})
        if pipeline is None or pipeline.last:
            self.mlm_transform = Dense((d,), (d,), cfg.dtype)
            self.mlm_ln = LayerNorm(d, cfg.dtype)
            self.mlm_out = Dense((d,), (cfg.vocab_size,), cfg.dtype)
            self.pooler = Dense((d,), (d,), cfg.dtype)
            self.nsp_out = Dense((d,), (2,), torch.float32)
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

    def init_params(self, seed: int) -> None:
        """The seeded init, in place (`init_params` above)."""
        init_params(self, seed)

    def trainable(self) -> "Bert":
        """Make the f32 master weights trainable (train mode); returns
        self."""
        self.requires_grad_(True)
        self.train()
        return self

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                dropout_generator: Optional[torch.Generator] = None,
                moe: Optional[MoeCollector] = None
                ) -> Dict[str, torch.Tensor]:
        """input_ids [B, S] → {"mlm_logits" f32 [B, S, V], "nsp_logits"
        f32 [B, 2], "pooled" [B, D] in the compute dtype}.
        `attention_mask` [B, S] marks the keys to attend (None: all);
        `token_type_ids` [B, S] default to segment 0. In train mode with
        `cfg.dropout_rate > 0` dropout draws its masks from
        `dropout_generator` (on the model's device); under `cfg.remat`
        and grad mode every layer is recomputed in the backward. An MoE
        model's layers report to `moe`."""
        b, s = input_ids.shape
        call = self._call(attention_mask, b, s, input_ids.device,
                          dropout_generator, moe)
        first = 0 if call.seq is None else call.seq.offset(s)
        x = self.embed(input_ids, token_type_ids, first)
        remat = self.cfg.remat and torch.is_grad_enabled()
        if self.cfg.pipeline_stages > 1:
            x = self._pipelined(x, call, remat)
        else:
            x = self._layers(x, call, remat)
        return self.heads(x)

    def _call(self, attention_mask, b: int, s: int, device,
              dropout_generator, moe) -> _Call:
        impl = self.cfg.attention_impl
        if impl == "auto":
            impl = auto_attention_impl(b, s, self.cfg.num_heads,
                                       self.cfg.dtype, device=device)
        mask = None if attention_mask is None else attention_mask.bool()
        return _Call(mask, impl, dropout_generator, self.training, moe,
                     forward_sequence(impl, SEQUENCE_IMPLS))

    def embed(self, input_ids, token_type_ids=None, first: int = 0):
        """The embeddings and `ln_emb` (stage 0 of a pipeline) → [B, S, D]
        in the compute dtype; positions start at `first`."""
        s = input_ids.shape[1]
        positions = torch.arange(first, first + s,
                                 device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.tok_emb(input_ids) + self.pos_emb(positions)
        return self.ln_emb(x + self.seg_emb(token_type_ids)).to(
            self.cfg.dtype)

    def _layers(self, x, call: _Call, remat: bool, first: int = 0,
                count: Optional[int] = None):
        """x through the held layers [first, first + count) of this
        model's run (all of them by default)."""
        layers = list(self.layers)
        for layer in layers[first:None if count is None else first + count]:
            if remat:
                x = remat_fn(layer, call.generator, x, call)
            else:
                x = layer(x, call)
        return x

    def _pipelined(self, x, call: _Call, remat: bool):
        """The stages in turn on one process, microbatch by microbatch
        (the JAX `PipelinedEncoder`'s math; models/gpt.py `_pipelined`)."""
        if self.pipeline is not None:
            raise ValueError(
                f"this model holds pipeline stage {self.pipeline.rank} of "
                f"{self.pipeline.size}: the training step's schedule drives "
                f"it (embed, stage, heads)")
        cfg = self.cfg
        per, stages = pipeline_stage_slices(cfg.num_layers,
                                            cfg.pipeline_stages)
        b = x.shape[0]
        m = clamp_microbatches(cfg.num_microbatches, stages, b)
        rows = b // m
        gen = call.generator
        state = None if gen is None else gen.get_state()
        outs = []
        for j in range(m):
            if gen is not None:
                gen.set_state(state)
            sub = dataclasses.replace(call, mask=None if call.mask is None
                                      else call.mask[j * rows:(j + 1) * rows])
            h = x[j * rows:(j + 1) * rows]
            with microbatch_rows(j * rows, b):
                for s in range(stages):
                    h = self._layers(h, sub, remat, s * per, per)
                    if s < stages - 1:
                        h = h.to(cfg.dtype)
            outs.append(h)
        return torch.cat(outs)

    # -- a pipeline stage's parts (training/trainer.py runs them) ------------

    def stage(self, x, attention_mask=None,
              dropout_generator: Optional[torch.Generator] = None,
              moe: Optional[MoeCollector] = None):
        """x through this model's layers (a stage's run), remat and
        dropout as in `forward` (f32 out of every layer)."""
        b, s = x.shape[:2]
        call = self._call(attention_mask, b, s, x.device, dropout_generator,
                          moe)
        return self._layers(x, call, self.cfg.remat and
                            torch.is_grad_enabled())

    def heads(self, x) -> Dict[str, torch.Tensor]:
        """The last stage: the MLM and next-sentence heads on the final
        hidden states (`forward`'s dict)."""
        h = F.gelu(self.mlm_transform(x), approximate="tanh")
        logits = self.mlm_out(tensor_copy(self.mlm_out,
                                          self.mlm_ln(h))).float()
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return {"mlm_logits": logits, "nsp_logits": self.nsp_out(pooled),
                "pooled": pooled}


# -- registry ------------------------------------------------------------------


def _build(defaults: dict, kwargs: dict) -> Bert:
    device = kwargs.pop("device", None)
    seed = kwargs.pop("seed", 0)
    expert = kwargs.pop("expert", None)
    pipeline = kwargs.pop("pipeline", None)
    fsdp = kwargs.pop("fsdp", None)
    tensor = kwargs.pop("tensor", None)
    cfg = BertConfig(**{**defaults, **kwargs})
    return Bert(cfg, device=device, seed=seed, expert=expert,
                pipeline=pipeline, fsdp=fsdp, tensor=tensor)


@register_model("bert_base")
def bert_base(**kwargs) -> Bert:
    return _build({}, kwargs)


@register_model("bert_large")
def bert_large(**kwargs) -> Bert:
    return _build(dict(hidden_size=1024, num_layers=24, num_heads=16,
                       mlp_dim=4096), kwargs)


@register_model("bert_base_moe")
def bert_base_moe(**kwargs) -> Bert:
    """BERT-base with every MLP a Switch MoE (8 experts by default)."""
    return _build(dict(num_experts=8), kwargs)


@register_model("bert_tiny")
def bert_tiny(**kwargs) -> Bert:
    """Test-scale config."""
    return _build(dict(vocab_size=512, hidden_size=64, num_layers=2,
                       num_heads=4, mlp_dim=128, max_len=128,
                       dropout_rate=0.0), kwargs)


@register_model("bert_tiny_moe")
def bert_tiny_moe(**kwargs) -> Bert:
    """Test-scale MoE config (4 experts)."""
    return _build(dict(vocab_size=512, hidden_size=64, num_layers=2,
                       num_heads=4, mlp_dim=128, max_len=128,
                       dropout_rate=0.0, num_experts=4), kwargs)
