"""Layers both transformer families share (the port's counterpart of
kubeflow_tpu/models/layers.py, which holds the JAX package's shared
layer code): flax's `Dense`/`DenseGeneral`, `LayerNorm` and `Embed` with
their parameter names, shapes and mixed-precision arithmetic, flax's
`Dropout`, and the routed expert MLP `MoeMlp` (the JAX `MoeMlp`, whole
or sharded over the expert mesh axis) with `MoeCollector`, which
carries one forward's MoE reports (the JAX `moe_stats` and `losses`
sows).

Weights are f32 at rest and cast to the compute dtype at use, as flax's
`dtype=` does. A GPT serving model may hold a leaf as int8 with an f32
per-channel scale buffer beside it (`QSCALE`; models/gpt.py
`int8_model`): `at_use` dequantizes it where it is read.

On an fsdp mesh axis (`shard_fsdp`, with this rank's `FsdpShard`) a
module holds each leaf whose spec names `fsdp` as its block along that
dim (the JAX `state_shardings`' layout; `_fsdp_dims` maps the leaf to
the dim), and `at_use` gathers the f32 block over the axis just before
the use: the whole leaf lives only in that use's graph (a remat
recompute gathers again), the cast to the compute dtype comes after the
gather, and the gather's backward reduce-scatters the f32 gradient back
to the block. A module without blocks reads its leaves as before.

On a tensor axis (`shard_tensor`, with this rank's `TensorShard`) a
module holds each leaf whose spec names `tensor` as its block along
that dim (`_tensor_dims`), and never gathers it: `Dense` runs column-
or row-parallel by the dim its kernel is split on, `Embed` looks up a
vocab-split table's rows by mask, `MoeMlp` runs its stacks' mlp block.
The replicated activation enters the column blocks through
`tensor_copy` (once for all the products that read it), and a row
block's partial output is summed over the tensor group before its bias.

`dropout` keeps flax's semantics, keep with probability 1 - rate and
`where(keep, x / (1 - rate), 0)`, and draws its keep mask from an
explicit `torch.Generator` on x's device (`F.dropout` takes none), so a
training run is a pure function of (seed, step). JAX's threefry stream
is not reproduced: the masks are held by distribution and by the port's
own determinism.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.checkpointing.quantize import dequantize_leaf
from kubeflow_tpu_torch.ops.attention import row_stable_matmul
from kubeflow_tpu_torch.parallel.distributed import (
    all_gather,
    copy_to_group,
    reduce_from_group,
)
from kubeflow_tpu_torch.parallel.moe import expert_capacity, topk_route

# suffix of the f32 per-channel scale buffer beside an int8 leaf
QSCALE = "_qscale"


# (first row, global rows, first column, global columns) of the batch a
# dropout draws for: set by a data- or sequence-parallel step, so a
# rank's masks are its block of the global batch's
_DROPOUT_ROWS: contextvars.ContextVar[
    Optional[Tuple[int, int, int, Optional[int]]]] = \
    contextvars.ContextVar("dropout_rows", default=None)


@contextlib.contextmanager
def dropout_rows(first: int, total: int, first_col: int = 0,
                 total_cols: Optional[int] = None):
    """Inside, every `dropout` draws its mask for a batch of `total` rows
    and keeps rows [first, first + its own rows): a data-parallel rank's
    share of the global batch draws the masks a world-1 run draws for
    those rows. With `total_cols` the mask is drawn for sequences of
    that many positions and the columns [first_col, first_col + its
    own) are kept: a sequence shard's (x's dim 1 is the sequence)."""
    token = _DROPOUT_ROWS.set((first, total, first_col, total_cols))
    try:
        yield
    finally:
        _DROPOUT_ROWS.reset(token)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool = False) -> torch.Tensor:
    """flax `nn.Dropout(rate)(x, deterministic=...)`: the identity when
    `deterministic` (eval) or `rate == 0`; else each element is kept
    with probability 1 - rate, scaled by 1 / (1 - rate), and zeroed
    otherwise. The mask is drawn from `generator` (on x's device), which
    a training forward must pass; inside `dropout_rows` it is the rows of
    the global batch's mask that x holds (x's leading dim is the batch)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(
            "dropout needs a torch.Generator in training: pass the "
            "model's dropout_generator (a run is a function of its seed)")
    rows = _DROPOUT_ROWS.get()
    if rows is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        first, total, col, cols = rows
        inner = tuple(x.shape[1:]) if cols is None else (
            (cols,) + tuple(x.shape[2:]))
        u = torch.rand((total,) + inner, generator=generator,
                       device=x.device)[first:first + x.shape[0]]
        if cols is not None:
            u = u[:, col:col + x.shape[1]]
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def advance_dropout(generator: Optional[torch.Generator], draws: int,
                    shape: Sequence[int]) -> None:
    """Draw and drop `draws` dropout masks of `shape` (the whole batch's
    activations, as `dropout` draws them): a pipeline stage's generator
    then stands where a world-1 forward's stands at the stage's first
    layer (each block draws its class's DROPOUT_DRAWS masks)."""
    if generator is None:
        return
    for _ in range(draws):
        torch.rand(tuple(shape), generator=generator,
                   device=generator.device)


# the whole leaves of the serving-mesh unit whose forward is running
# (`gathered`), by (id(module), leaf)
_GATHERED: contextvars.ContextVar[Optional[Dict[Tuple[int, str],
                                                torch.Tensor]]] = \
    contextvars.ContextVar("mesh_gathered", default=None)


def _on_wire(module: nn.Module, name: str) -> torch.Tensor:
    """Leaf `name` of `module` as a serving mesh gathers it: in its use's
    compute dtype when the use casts it there first (`_mesh_wire`; the
    cast is elementwise, so gathering then casting gives the same
    bits), else as stored."""
    leaf = getattr(module, name)
    wire = module.__dict__.get("_mesh_wire", {}).get(name)
    return leaf if wire is None else leaf.to(wire)


def held_whole(module: nn.Module, name: str) -> torch.Tensor:
    """Leaf `name` of `module` whole: a serving mesh's block
    (parallel/serving_mesh.py, the spec in `_mesh_specs`) taken from its
    unit's batched gather (`gathered`) or gathered alone over the mesh's
    fsdp and tensor axes, in its wire dtype (`_on_wire`); any other leaf
    as it is stored (f32, or int8 on an int8 model)."""
    specs = module.__dict__.get("_mesh_specs")
    if specs is None or name not in specs:
        return getattr(module, name)
    whole = (_GATHERED.get() or {}).get((id(module), name))
    if whole is not None:
        return whole
    return module.mesh_shard.gather(_on_wire(module, name), specs[name])


@contextlib.contextmanager
def gathered(unit: nn.Module) -> Iterator[None]:
    """Inside, every leaf a serving mesh holds as a block in `unit` (a
    transformer block: `_mesh_unit`, set by parallel/serving_mesh.py
    `shard_model`) is whole, from one batched gather an axis
    (`MeshShard.gather_many`): the unit gathers only its own layer's
    weights, as the JAX serving mesh does. A no-op for any other
    module."""
    leaves = unit.__dict__.get("_mesh_unit")
    if not leaves:
        yield
        return
    wholes = leaves[0][0].mesh_shard.gather_many(
        [(_on_wire(m, a), m._mesh_specs[a]) for m, a in leaves])
    token = _GATHERED.set({**(_GATHERED.get() or {}), **{
        (id(m), a): w for (m, a), w in zip(leaves, wholes)}})
    try:
        yield
    finally:
        _GATHERED.reset(token)


def at_use(module: nn.Module, name: str, dtype) -> torch.Tensor:
    """Leaf `name` of `module` as its point of use reads it: the stored
    tensor (f32 at rest; the caller casts as before), an fsdp block
    gathered into the whole f32 leaf (the caller casts after the
    gather), a serving mesh's block gathered whole (`held_whole`; in the
    compute dtype where the caller casts to it), or on an int8 model the
    int8 leaf (gathered as int8 on a serving mesh) dequantized into the
    compute dtype with `dequantize_params`' arithmetic."""
    leaf = held_whole(module, name)
    scale = module._buffers.get(name + QSCALE)
    if scale is not None:
        return dequantize_leaf(leaf, scale, dtype)
    dims = module.__dict__.get("_fsdp_dims")
    if dims is None or name not in dims:
        return leaf
    return module.fsdp.gather(leaf, dims[name])


class Dense(nn.Module):
    """flax Dense/DenseGeneral: `kernel` [*in, *out] (f32 at rest), an
    optional `bias` [*out]; the input cast to the compute dtype (flax's
    `promote_dtype`), x @ kernel then + bias, each in the compute dtype
    (two roundings, as the flax module does). The product is
    `row_stable_matmul`: on the CPU a row's bits do not depend on how
    many rows the call folds together (a decode step's row equals the
    same row of a verify window).

    On a tensor axis (`shard_tensor`) the kernel is this rank's block:
    split on an output dim it is column-parallel (the bias is split
    alike; x, replicated, entered through `tensor_copy` upstream, and
    the output is this rank's columns), split on an input dim it is
    row-parallel (x is this rank's block of those dims; the partial
    product is summed over the tensor group, then the replicated bias is
    added once, in the compute dtype)."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype, use_bias: bool = True):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = (
            nn.Parameter(torch.empty(self.out_shape)) if use_bias else None
        )

    @property
    def fan_in(self) -> int:
        return math.prod(self.in_shape)

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        w = at_use(self, "kernel", self.dtype).to(self.dtype)
        out_shape = tuple(w.shape[n_in:])
        w = w.reshape(math.prod(w.shape[:n_in]), math.prod(out_shape))
        y = row_stable_matmul(x.to(self.dtype).reshape(lead + (-1,)),
                              w).reshape(lead + out_shape)
        dim = self.__dict__.get("_tensor_dims", {}).get("kernel")
        if dim is not None and dim < n_in:
            # row-parallel: the partial products summed over the group
            y = self.tensor.reduce(y)
        if self.bias is not None:
            y = y + at_use(self, "bias", self.dtype).to(self.dtype)
        return y


class LayerNorm(nn.Module):
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
        scale = at_use(self, "scale", self.dtype).float()
        bias = at_use(self, "bias", self.dtype).float()
        return (x - mean) * (torch.rsqrt(var + 1e-6) * scale) + bias


# a table of at most this many rows takes `_SmallTableLookup`'s gradient
SMALL_TABLE_ROWS = 16


class _SmallTableLookup(torch.autograd.Function):
    """`F.embedding` whose weight gradient sums each row's positions by
    a masked reduction, one pass a row. CUDA's embedding backward is not
    bit for bit reproducible when one row is looked up thousands of
    times (measured on the H100: BERT's segment table, whose 16,384
    positions a step all read row 0, gave other bits in 20 of 20
    repeats), and a resumed run must replay an uninterrupted one bit for
    bit."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.num = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat, rows = ids.reshape(-1, 1), grad.reshape(-1, grad.shape[-1])
        return None, torch.stack([
            torch.where(flat == r, rows, torch.zeros_like(rows)).sum(0)
            for r in range(ctx.num)])


class Embed(nn.Module):
    """flax Embed(dtype=...): `embedding` [num, dim] (f32 at rest); a
    lookup returns the rows in the compute dtype. A table of at most
    SMALL_TABLE_ROWS rows takes a reproducible gradient
    (`_SmallTableLookup`; its rows are the rank's block's on a tensor
    axis). A table split over a tensor axis on its rows (`shard_tensor`)
    looks up the ids in this rank's block, zeroes the rows of every other
    id and sums the lookups over the tensor group (one row and zeros: the
    whole table's lookup, bit for bit)."""

    def __init__(self, num: int, dim: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids):
        scale = self._buffers.get("embedding" + QSCALE)
        if scale is not None:
            # gather the int8 rows, then dequantize: the scale is per
            # column, so this is the dequantized table's gather, bit for bit
            return dequantize_leaf(held_whole(self, "embedding")[ids], scale,
                                   self.dtype)
        # an fsdp block of rows is gathered into the whole table first
        table = at_use(self, "embedding", self.dtype)
        mine = None
        if "embedding" in self.__dict__.get("_tensor_dims", {}):
            first, n = self.tensor.block(table.shape[0] * self.tensor.size)
            ids = ids - first
            mine = (ids >= 0) & (ids < n)
            ids = torch.where(mine, ids, torch.zeros_like(ids))
        # gather then cast == flax's cast-table-then-gather, bit for bit
        if table.shape[0] <= SMALL_TABLE_ROWS:
            rows = _SmallTableLookup.apply(ids, table)
        else:
            rows = F.embedding(ids, table)
        if mine is None:
            return rows.to(self.dtype)
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return self.tensor.reduce(rows.to(self.dtype))


@dataclasses.dataclass
class MoeLayerStats:
    """What one `MoeMlp` call reports: `expert_tokens` [E] (routed
    slots an expert filled, summed over the call's tokens and choices),
    `dropped` (choices dropped at capacity), the load-balance loss's
    sums (`first_choice`, `prob_sum` [E]) over `tokens`, and
    `aux` = aux_weight · the call's load-balance loss."""

    expert_tokens: torch.Tensor
    dropped: torch.Tensor
    first_choice: torch.Tensor
    prob_sum: torch.Tensor
    tokens: int
    aux_weight: float
    aux: torch.Tensor


class MoeCollector:
    """The MoE reports of one forward (the JAX package's sown
    `moe_stats` and `losses` collections), passed down that forward
    only: a model shared by an engine thread and a trainer keeps no
    per-call state. Layers append in call order. Reading seals it: a
    remat recompute in the backward runs the layers again, and their
    second reports are ignored."""

    def __init__(self):
        self.layers: List[MoeLayerStats] = []
        self._sealed = False

    def add(self, stats: MoeLayerStats) -> None:
        if not self._sealed:
            self.layers.append(stats)

    def _read(self) -> List[MoeLayerStats]:
        self._sealed = True
        return self.layers

    def serving_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(expert_tokens [E] f32, dropped f32 scalar) summed over the
        layers, on the device: the engine's router evidence."""
        layers = self._read()
        tokens = torch.stack([s.expert_tokens for s in layers]).sum(0)
        dropped = torch.stack([s.dropped for s in layers]).sum()
        return tokens.detach(), dropped.detach()

    def aux_loss(self, group=None) -> Optional[torch.Tensor]:
        """The summed weighted load-balance loss of every layer (None
        without MoE layers). With a data-parallel `group`, each layer's
        first-choice counts, probability sums and token count are summed
        over the group first (the probabilities through the
        differentiable `all_reduce_sum`), so every rank gets the global
        batch's loss, as the JAX package's GSPMD program computes it."""
        layers = self._read()
        if not layers:
            return None
        if group is None:
            return torch.stack([s.aux for s in layers]).sum()
        from kubeflow_tpu_torch.parallel.distributed import all_reduce_sum
        from kubeflow_tpu_torch.parallel.moe import load_balance_loss

        first = torch.stack([s.first_choice for s in layers]).detach()
        tokens = first.new_tensor([[float(s.tokens)] for s in layers])
        counts = torch.cat([first, tokens], dim=1)
        torch.distributed.all_reduce(counts, group=group)
        prob_sum = all_reduce_sum(
            torch.stack([s.prob_sum for s in layers]), group)
        weights = first.new_tensor([s.aux_weight for s in layers])
        per_layer = load_balance_loss(counts[:, :-1], prob_sum,
                                      counts[:, -1:], first.shape[-1])
        return (weights * per_layer).sum()


# the expert stacks of a routed layer: [E, ...] leaves an expert axis splits
EXPERT_STACKS = ("wi", "wo")


class MoeMlp(nn.Module):
    """Routed expert MLP (the JAX `MoeMlp`; `parallel/moe.py` routes).
    Parameters `router` [D, E] (f32, applied to x in f32: a route flipped
    by rounding would change the output discontinuously), `wi` [E, D, F]
    and `wo` [E, F, D] (f32 at rest, cast to the compute dtype at use;
    int8 on an int8 model, dequantized there).

    Capacity is `expert_capacity(S · top_k, E, capacity_factor)` a batch
    row (the row is the routing group, S its length). The dispatch and
    combine tensors are cast to the compute dtype, then the one-hot
    contractions `bsec,bsd->ebcd`, `ebcd,edf->ebcf`, tanh-GELU,
    `ebcf,efd->ebcd`, `bsec,ebcd->bsd` run in the type the JAX einsums
    promote to: the compute dtype, or f32 when x is f32 (BERT's f32
    residual stream). A dropped choice contributes nothing. Each call
    reports to the forward's `MoeCollector`, when one is passed.

    Expert-sharded (`expert`, an `ExpertShard` of the expert mesh axis;
    the JAX `_expert_parallel`'s form): `wi`/`wo` hold only this rank's
    block of E/ep experts, the router stays whole, and every rank routes
    alike. x and the whole combine tensor enter through `copy_to_group`
    (so the gradients of x, of the router and of everything upstream are
    whole and equal on every rank of the group), dispatch and combine are
    cut to the block's experts, the four einsums run on the block, and
    one `reduce_from_group` over the expert group sums the partial
    outputs. Under top-1 each output element has at most one nonzero
    term, so the sum is world 1's up to the batching of the expert GEMMs.

    Under a sequence axis (`seq`, the forward's `SequenceShard`, which
    the model keeps in its call's context: a remat recompute may run on
    autograd's device thread, outside the step's `sequence_parallel`) a
    rank holds S/n positions of each row, but the routing group is still
    the whole row: the f32 router logits are gathered over the sequence
    group (`all_gather`, whose backward is a reduce-scatter), every
    sequence rank routes the whole row (capacity from the global S, queue
    slots in global token order), keeps its own columns of dispatch and
    combine and runs the experts on its own tokens. The whole row's load-balance
    sums are then equal on every sequence rank: sequence rank 0 alone
    reports them (as it alone counts BERT's next-sentence rows).

    On a tensor axis (`shard_tensor`) the stacks hold this rank's block
    of their `mlp` dim ([E, D, F/t], [E, F/t, D]); every rank routes
    alike, x enters the blocks through `copy_to_group` and the experts'
    partial outputs [E, B, C, D] are summed over the tensor group before
    the combine, so the combine's gradient is whole on every rank."""

    def __init__(self, dim: int, mlp_dim: int, num_experts: int, dtype,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 aux_weight: float = 0.01, dropout_rate: float = 0.0,
                 expert=None):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.aux_weight = capacity_factor, aux_weight
        self.dtype, self.dropout_rate = dtype, dropout_rate
        # this rank's ExpertShard (parallel/mesh.py), or None: every expert
        self.expert = expert
        self.first, local = (0, num_experts) if expert is None else \
            expert.block(num_experts)
        self.router = nn.Parameter(torch.empty(dim, num_experts))
        self.wi = nn.Parameter(torch.empty(local, dim, mlp_dim))
        self.wo = nn.Parameter(torch.empty(local, mlp_dim, dim))

    def stack_shape(self, leaf: str) -> Tuple[int, ...]:
        """The whole [E, ...] shape of leaf `leaf` (its own shape when it
        is not an expert stack)."""
        shape = tuple(getattr(self, leaf).shape)
        return (self.num_experts,) + shape[1:] if leaf in EXPERT_STACKS \
            else shape

    def block_of(self, leaf: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole [E, ...] value of leaf `leaf` (the
        value itself when the leaf is not a stack or nothing is sharded)."""
        if leaf not in EXPERT_STACKS or self.expert is None:
            return whole
        return whole[self.first:self.first + self.wi.shape[0]]

    def forward(self, x, collector: Optional[MoeCollector] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, seq=None):
        b, s, _ = x.shape
        e = self.num_experts
        # the routing group is the whole row: S positions over the ring
        s_row = s if seq is None else s * seq.size
        # top-2 tokens take two slots each: capacity scales with k
        c = expert_capacity(s_row * self.top_k, e, self.capacity_factor)
        router = at_use(self, "router", self.dtype).float()
        logits = torch.einsum("bsd,de->bse", x.float(), router)
        if seq is not None:
            logits = all_gather(logits, seq.group, dim=1)
        route = topk_route(logits, c, k=self.top_k)
        cd = torch.promote_types(self.dtype, x.dtype)

        def cast(t):
            return t.to(self.dtype).to(cd)

        dispatch, combine = route.dispatch, route.combine
        if seq is not None:
            cols = slice(seq.offset(s), seq.offset(s) + s)
            dispatch, combine = dispatch[:, cols], combine[:, cols]
        dispatch, combine = cast(dispatch), cast(combine)
        group = None if self.expert is None else self.expert.group
        xe = x.to(cd)
        if self.expert is not None:
            xe, combine = copy_to_group(xe, group), copy_to_group(combine,
                                                                  group)
            block = slice(self.first, self.first + self.wi.shape[0])
            dispatch, combine = dispatch[:, :, block], combine[:, :, block]
        split = "wi" in self.__dict__.get("_tensor_dims", {})
        if split:
            xe = self.tensor.copy(xe)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, xe)
        h = torch.einsum("ebcd,edf->ebcf", expert_in,
                         cast(at_use(self, "wi", self.dtype)))
        h = F.gelu(h, approximate="tanh")
        out_e = torch.einsum("ebcf,efd->ebcd", h,
                             cast(at_use(self, "wo", self.dtype)))
        if split:
            out_e = self.tensor.reduce(out_e)
        y = torch.einsum("bsec,ebcd->bsd", combine, out_e)
        if self.expert is not None:
            y = reduce_from_group(y, group)
        if collector is not None:
            # counts are over POSITIONS fed to the router (idle decode
            # slots and prefill pad tails route too): a load-balance
            # signal, not token billing; a sequence rank counts its own
            local_dispatch = route.dispatch if seq is None else \
                route.dispatch[:, seq.offset(s):seq.offset(s) + s]
            expert_tokens = local_dispatch.detach().sum(dim=(0, 1, 3))
            first_choice, prob_sum, tokens = (route.first_choice,
                                              route.prob_sum, b * s_row)
            if seq is not None and seq.rank != 0:
                # the whole row's sums: counted once, on sequence rank 0
                # (a zero product keeps the graph, so every rank runs the
                # aux loss's collective backward)
                first_choice = torch.zeros_like(first_choice)
                prob_sum, tokens = prob_sum * 0.0, 0
            collector.add(MoeLayerStats(
                expert_tokens=expert_tokens,
                dropped=float(b * s * self.top_k) - expert_tokens.sum(),
                first_choice=first_choice, prob_sum=prob_sum,
                tokens=tokens, aux_weight=self.aux_weight,
                aux=self.aux_weight * route.aux_loss,
            ))
        return dropout(y, self.dropout_rate, generator, not train)


# the axes a module may hold a leaf's block on, by its attributes: the
# {leaf: dim} map and the shard (models hold at most one of them a leaf)
_BLOCK_AXES = (("_fsdp_dims", "fsdp"), ("_tensor_dims", "tensor"))


def _block_dims(module: nn.Module, leaf: str):
    """[(dim, shard)] of the axes `module` holds leaf `leaf`'s block on."""
    return [(dims[leaf], getattr(module, shard))
            for attr, shard in _BLOCK_AXES
            if leaf in (dims := module.__dict__.get(attr, {}))]


def whole_leaf_shape(module: nn.Module, leaf: str) -> Tuple[int, ...]:
    """The whole shape of parameter `leaf` of `module`: its own, an
    expert stack's [E, ...], an fsdp or a tensor block's whole leaf's."""
    shape = list(module.stack_shape(leaf) if isinstance(module, MoeMlp)
                 else getattr(module, leaf).shape)
    for dim, shard in _block_dims(module, leaf):
        shape[dim] *= shard.size
    return tuple(shape)


def held_block(module: nn.Module, leaf: str,
               whole: torch.Tensor) -> torch.Tensor:
    """The block of a whole value of parameter `leaf` that `module` holds:
    its expert block of a stack, its fsdp or tensor block along the
    leaf's dim, or the value itself."""
    if isinstance(module, MoeMlp):
        whole = module.block_of(leaf, whole)
    for dim, shard in _block_dims(module, leaf):
        first, n = shard.block(whole.shape[dim])
        whole = whole.narrow(dim, first, n)
    return whole


def draw_value(module: nn.Module, leaf: str, draw) -> torch.Tensor:
    """`draw(shape)` for parameter `leaf` of `module`: a sharded leaf (an
    expert stack of a sharded `MoeMlp`, an fsdp or a tensor block) draws
    its whole value and keeps this rank's block, so a seeded init gives
    world 1's weights whatever the expert, fsdp and tensor axes."""
    return held_block(module, leaf, draw(whole_leaf_shape(module, leaf)))


def sharded_stacks(model: nn.Module) -> Dict[str, Tuple[MoeMlp, str]]:
    """{parameter name: (its MoeMlp, leaf)} of the expert stacks `model`
    holds a block of (empty off an expert axis and for a dense model)."""
    return {f"{name}.{leaf}": (module, leaf)
            for name, module in model.named_modules()
            if isinstance(module, MoeMlp) and module.expert is not None
            for leaf in EXPERT_STACKS}


def _held_leaves(model: nn.Module, attr: str
                 ) -> Dict[str, Tuple[nn.Module, str, int]]:
    """{parameter name: (its module, leaf, dim)} of the blocks `model`
    holds on one axis (`attr`: its modules' {leaf: dim} map)."""
    out = {}
    for name, module in model.named_modules():
        for leaf, dim in module.__dict__.get(attr, {}).items():
            out[f"{name}.{leaf}" if name else leaf] = (module, leaf, dim)
    return out


def fsdp_leaves(model: nn.Module) -> Dict[str, Tuple[nn.Module, str, int]]:
    """{parameter name: (its module, leaf, dim)} of the fsdp blocks
    `model` holds (empty off an fsdp axis)."""
    return _held_leaves(model, "_fsdp_dims")


def tensor_leaves(model: nn.Module) -> Dict[str, Tuple[nn.Module, str, int]]:
    """{parameter name: (its module, leaf, dim)} of the tensor blocks
    `model` holds (empty off a tensor axis)."""
    return _held_leaves(model, "_tensor_dims")


def held_leaves(model: nn.Module) -> Dict[str, Tuple[nn.Module, str, int]]:
    """The fsdp and the tensor blocks `model` holds (`fsdp_leaves`,
    `tensor_leaves`)."""
    return {**fsdp_leaves(model), **tensor_leaves(model)}


def _axis_leaf_dims(model: nn.Module, axis: str, size: int,
                    fsdp_size: int = 1) -> Dict[str, int]:
    from kubeflow_tpu_torch.parallel.sharding import axis_dim, param_specs
    from kubeflow_tpu_torch.training.annotations import logical_axes_for

    sizes = {axis: size}
    specs = param_specs(logical_axes_for(model, fsdp_size=fsdp_size,
                                         mesh_axis_sizes=sizes), mesh=sizes)
    return {name: dim for name, spec in specs.items()
            if (dim := axis_dim(spec, axis)) is not None}


def fsdp_leaf_dims(model: nn.Module, size: int) -> Dict[str, int]:
    """{parameter name: the dim its spec splits over an fsdp axis of
    `size`} for the model's leaves whose spec names `fsdp` (the JAX
    trainer's `state_shardings`: `logical_to_spec(logical_axes_for(
    params, fsdp_size, mesh sizes))`, the fallback's largest divisible
    dim included; a dim the axis does not divide stays whole)."""
    return _axis_leaf_dims(model, "fsdp", size, fsdp_size=size)


def tensor_leaf_dims(model: nn.Module, size: int) -> Dict[str, int]:
    """{parameter name: the dim its spec splits over a tensor axis of
    `size`} for the model's leaves whose spec names `tensor` (the rules'
    heads, mlp, vocab and vocab_table dims; a dim the axis does not
    divide stays whole: gpt_small's 50,257-row `tok_emb` and head)."""
    return _axis_leaf_dims(model, "tensor", size)


def _shard_leaves(model: nn.Module, shard, dims: Dict[str, int],
                  attr: str, name: str) -> None:
    """Hold each leaf of `dims` as `shard`'s block along its dim, noting
    it in its module's `attr` map and the shard as the module's `name`."""
    setattr(model, name, shard)
    for key, dim in dims.items():
        owner, _, leaf = key.rpartition(".")
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        first, n = shard.block(p.shape[dim])
        setattr(module, leaf, nn.Parameter(
            p.detach().narrow(dim, first, n).clone(),
            requires_grad=p.requires_grad))
        module.__dict__.setdefault(attr, {})[leaf] = dim
        setattr(module, name, shard)


def shard_fsdp(model: nn.Module, fsdp) -> None:
    """Hold every leaf of `model` whose spec names `fsdp` as this rank's
    block along its dim (`fsdp`: an `FsdpShard` of the fsdp mesh axis;
    None leaves the model as it is, bit for bit). Run on a model whose
    leaves are whole, before its init: `draw_value` then draws each whole
    leaf and keeps the block."""
    if fsdp is not None:
        _shard_leaves(model, fsdp, fsdp_leaf_dims(model, fsdp.size),
                      "_fsdp_dims", "fsdp")


def shard_tensor(model: nn.Module, tensor) -> None:
    """Hold every leaf of `model` whose spec names `tensor` as this rank's
    block along its dim (`tensor`: a `TensorShard` of the tensor mesh
    axis; None leaves the model as it is, bit for bit), never gathered:
    its `Dense` products turn column- or row-parallel, its `Embed` tables
    vocab-split, its `MoeMlp` stacks split on their mlp dim. Run on a
    model whose leaves are whole, before its init (`draw_value` draws
    each whole leaf and keeps the block)."""
    if tensor is not None:
        _shard_leaves(model, tensor, tensor_leaf_dims(model, tensor.size),
                      "_tensor_dims", "tensor")


def tensor_copy(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x (replicated) as it enters `module`'s column-parallel products:
    `copy_to_group` over the tensor group (its cotangent is each rank's
    share of the products' and is summed there), once for every product
    that reads it; x itself when the module's kernel is not split on an
    output dim (a whole head's cotangent is already whole)."""
    dims = module.__dict__.get("_tensor_dims", {})
    if "kernel" not in dims or dims["kernel"] < len(module.in_shape):
        return x
    return module.tensor.copy(x)


def vocab_shard(module: Optional[nn.Module]
                ) -> Optional[Tuple[object, int]]:
    """(the TensorShard, this rank's first column) of a head `module`
    (a `Dense` [D, V]) whose vocabulary is split over a tensor axis, or
    None when its logits are whole (or there is no such module)."""
    if module is None or "kernel" not in module.__dict__.get(
            "_tensor_dims", {}):
        return None
    shard = module.tensor
    return shard, shard.rank * module.kernel.shape[-1]


def held_blocks(model: nn.Module, state_dict):
    """A whole-model state dict (every [E, ...] stack, fsdp and tensor
    leaf whole, as world 1 and the JAX package hold them) cut to the
    blocks `model` holds."""
    out = dict(state_dict)
    owners = {key: (module, leaf)
              for key, (module, leaf) in sharded_stacks(model).items()}
    owners.update({key: (module, leaf) for key, (module, leaf, _)
                   in held_leaves(model).items()})
    for key, (module, leaf) in owners.items():
        if key in out:
            out[key] = held_block(module, leaf, out[key])
    return out


def join_blocks(model: nn.Module, blocks: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's state dict of `model`'s
    layout along its one blocked axis (`blocks`, in fsdp or tensor
    order): each held leaf's blocks joined along its dim, every other
    entry rank 0's."""
    dims = {key: dim for key, (_, _, dim) in held_leaves(model).items()}
    return {key: (torch.cat([b[key] for b in blocks], dims[key])
                  if key in dims else value)
            for key, value in blocks[0].items()}


def gather_held_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: whole parameter} of `model`, each fsdp block gathered over
    its axis and each tensor block's bits joined over its group (a
    collective: every rank of the axis calls it, in the same order);
    detached copies, the whole leaves as they are."""
    from kubeflow_tpu_torch.parallel.mesh import all_gather_bits

    with torch.no_grad():
        out = {}
        for name, p in model.named_parameters():
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            fsdp = module.__dict__.get("_fsdp_dims", {}).get(leaf)
            tensor = module.__dict__.get("_tensor_dims", {}).get(leaf)
            if fsdp is not None:
                out[name] = module.fsdp.gather(p.detach(), fsdp)
            elif tensor is not None:
                out[name] = all_gather_bits(p.detach(), module.tensor.group,
                                            tensor)
            else:
                out[name] = p.detach().clone()
        return out


def remat(fn, generator: Optional[torch.Generator], *args):
    """`torch.utils.checkpoint` of fn(*args) (the JAX `nn.remat`): fn
    runs again in the backward, drawing the same dropout masks. The
    checkpoint's own RNG preservation covers only the default
    generators, so the explicit `generator`'s state at this call is
    restored before each run of fn, and so are the `dropout_rows` in
    force at the call: a CUDA backward recomputes on autograd's device
    thread, outside the caller's context. A block holding tensor blocks
    recomputes its whole forward (no early stop), so the recompute issues
    every all-reduce its forward issued, on every rank: torch's early
    stop would end it once the backward's saved tensors are made again,
    before or after a row-parallel sum depending on what follows it."""
    full = isinstance(fn, nn.Module) and any(
        "_tensor_dims" in m.__dict__ for m in fn.modules())
    kwargs = {"early_stop": False} if full else {}
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    state, rows = generator.get_state(), _DROPOUT_ROWS.get()

    def replay(*a):
        generator.set_state(state)
        token = _DROPOUT_ROWS.set(rows)
        try:
            return fn(*a)
        finally:
            _DROPOUT_ROWS.reset(token)

    return checkpoint(replay, *args, use_reentrant=False, **kwargs)


@contextlib.contextmanager
def microbatch_rows(first: int, total: int):
    """Inside, dropout draws for a batch of `total` rows of which x holds
    rows [first, first + its own): a pipeline microbatch's rows of the
    batch a world-1 forward draws its masks for, composed with any
    `dropout_rows` already in force (a data-parallel rank's share)."""
    outer = _DROPOUT_ROWS.get()
    rows = ((first, total, 0, None) if outer is None
            else (outer[0] + first,) + tuple(outer[1:]))
    token = _DROPOUT_ROWS.set(rows)
    try:
        yield
    finally:
        _DROPOUT_ROWS.reset(token)


class LayerStack(nn.Module):
    """A model's blocks under their global indices (`layers.<i>`, the
    flax `layer_<i>`): every block, or a pipeline stage's run of them.
    Indexed by global index, iterated and sized as an `nn.ModuleList`;
    `items()` gives (index, block) in order."""

    def __init__(self, blocks: Dict[int, nn.Module]):
        super().__init__()
        for i, block in blocks.items():
            self.add_module(str(i), block)

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(int(i))]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def items(self) -> List[Tuple[int, nn.Module]]:
        return [(int(k), m) for k, m in self._modules.items()]


def held_layers(num_layers: int, stages: int, pipeline) -> range:
    """The layer indices a model holds: all of them, or with `pipeline`
    (a `PipelineShard` of the pipeline mesh axis) its stage's run
    [s·L/S, (s+1)·L/S)."""
    from kubeflow_tpu_torch.parallel.pipeline import pipeline_stage_slices

    per, stages = pipeline_stage_slices(num_layers, stages)
    if pipeline is None:
        return range(num_layers)
    if pipeline.size != stages or not 0 <= pipeline.rank < stages:
        raise ValueError(f"pipeline stage {pipeline.rank} of "
                         f"{pipeline.size} does not fit the model's "
                         f"{stages} stages")
    return range(pipeline.rank * per, (pipeline.rank + 1) * per)


def model_device(model: nn.Module) -> torch.device:
    """The device of a model's first parameter or buffer (whichever
    leaves its stage holds)."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    raise ValueError("the model holds no tensors")


def whole_model(model: nn.Module) -> nn.Module:
    """`model` itself, or for a model holding one pipeline stage its
    whole twin on the meta device (every stage's layers and every
    owned leaf, in the model family's order; the same expert blocks)."""
    if getattr(model, "pipeline", None) is None:
        return model
    return type(model)(model.cfg, device="meta", expert=model.expert)


def stage_layout(model: nn.Module):
    """The JAX pipelined param layout of `model` (models/convert.py
    `StageLayout`), or None when it runs no pipeline stages."""
    from kubeflow_tpu_torch.models.convert import StageLayout

    cfg = getattr(model, "cfg", None)
    stages = getattr(cfg, "pipeline_stages", 1)
    if stages <= 1:
        return None
    return StageLayout(model.STAGE_PREFIX, stages,
                       cfg.num_layers // stages)


def leaf_owner(model: nn.Module, name: str) -> Optional[int]:
    """The pipeline stage that holds a model-level leaf (0 for the
    embeddings, the last for the final LayerNorm and the heads; the
    model's FIRST_STAGE and LAST_STAGE), or None for a layer's leaf."""
    top = name.split(".", 1)[0]
    if top == "layers":
        return None
    if top in model.FIRST_STAGE:
        return 0
    return model.cfg.pipeline_stages - 1
