"""The train-step engine (port of kubeflow_tpu/training/trainer.py): one
card, or one card of each rank of a data-parallel gang.

`Trainer` builds the model (f32 master weights, trainable, compute in
`cfg.dtype`), its task (causal LM for the GPT family, masked LM for
BERT, image classification for ResNet and the mlp) and the recipe's
optimizer (AdamW, or SGD-momentum for convnets). `train_step` is the JAX
`step_fn`: the model in train mode, the task's augmentation of the
batch (a pure function of (seed, step), so a resumed run replays the
crops), forward and backward (gradient accumulation over `accum_steps`
microbatches as a Python loop, each weighted by the task's item count:
the causal LM's valid next-token pairs, so the result is the full-batch
token-mean gradient; refused for a model with batch statistics, as in
the JAX package), optax's global-norm clip (AdamW only), the schedule's
lr for this update, one optimizer step. A model with dropout draws its
masks from one `torch.Generator` on the device a step, or a microbatch,
seeded by (seed, step, microbatch) (`dropout_seed`; the JAX `fold_in`s
of the step and the microbatch), so a resumed run replays the same
masks. A BatchNorm model's running averages move in the training
forward (the JAX `var_updates`). `evaluate` is a pass over
`eval_batches` in eval mode → top1, loss, count. `fit` is `_fit_loop`: the first-step fence (`compile_s`: in
eager PyTorch it fences first-use kernel builds and library warm-up out
of the throughput windows), the non-finite-loss stop, eval every
`data.eval_every_steps` and at the end with the early stop at
`data.target_accuracy` (eval time kept out of the step timing), items/s,
MFU and goodput per log window, the interval checkpoint saves, and the
`stop_event` preemption exit. The task's global aux values
(`STEP_AUX`: an MoE model's `moe_aux_loss`, averaged over the
microbatches) ride each step's metrics, and a log window reports its
last step's, as the JAX trainer logs them. The loop records the
kft-trace spans
`train.host_wait`, `train.device_step`, `train.eval` and
`train.checkpoint_block` and the `train.compile_fence` event, and calls
the kft-chaos point `trainer.device_step` before each step (a host
losing its card mid-run; disarmed, one bool check).

Unlike the JAX package's functional state, a `TrainState` here is
updated IN PLACE: the model's parameters and buffers and the optimizer's
state are the state, and `train_step` returns the same object one step on.

Data comes from `datasets.build_data` (synthetic, blobs, npz). Synthetic
batches of every task are made on the card (`SyntheticData.
device_batch_fn`); every other stream is read by step (`batch_at`) and
copied host→device from pinned memory, with `data.prefetch_depth` > 0 by
a `DevicePrefetcher` thread on a side stream that makes and copies the
batches ahead of the step that needs them (training/prefetch.py; 0 reads
each batch in the loop). MFU is the LM's or the encoder's analytic
FLOPs, or for other models the FLOPs `FlopCounterMode` counts once over
one forward and backward of the model's shapes on the meta device.

Data parallelism (`cfg.mesh.data` ranks in a `torch.distributed` group,
parallel/distributed.py; one process a rank). The step is the JAX
package's GSPMD step written out: every rank holds the whole state, the
same from the same seed, and feeds its rows of the global batch
(training/data.py `local_rows`: every stream makes the global batch and
the rank keeps its rows, so the data, the crops and the dropout masks
are a world-1 run's whatever the gang's size). Before the backward the
step's item counts (`task.item_counts`) are summed over the data group,
each rank's loss is its sum over those global counts, and after the
last microbatch the gradients are summed over the group: one flat
bucket a dtype (the f32 master grads, with the loss), one all-reduce a
step, counted in `grad_allreduces`. Clip, schedule and update then run
on identical gradients, so the ranks' states stay identical. BatchNorm
reduces its statistics over the group (models/resnet.py
`sync_batch_stats`). `evaluate` splits each eval batch (padded to a
multiple of the ranks, `eval_mask` marking the real rows) and sums its
three statistics over the group. Log windows count global items; MFU is
a rank's FLOPs (the global step's over the ranks) over the card's peak.
A gang of one (a group of size 1) takes the same path, all-reduces
included; without a group the step is the single-card one above.

Sequence parallelism (`cfg.mesh.sequence` ranks a ring, inner to the
data axis: the JAX package's sequence mesh axis). A rank keeps its
rows, then its columns of every sequence, with one lookahead column for
the causal LM's pair across the shard boundary (training/data.py
`shard_columns`); dropout draws the global microbatch's masks and keeps
the rank's block of them. The step runs inside `sequence_parallel`
(parallel/mesh.py), where the model offsets its positions and attends
by ring or Ulysses attention over the ring's process group, and the
MLM task counts next-sentence rows on sequence rank 0. Item counts,
the loss and the gradients are summed over data × sequence
(`reduce_group`): parameters are replicated over both. Without an
explicit model a sequence axis turns the default attention ("dense")
into "ring", as the JAX trainer defaults it. An MoE model routes each
whole row: its router logits are gathered over the ring (models/
layers.py `MoeMlp`). MFU is a rank's share of the global step's FLOPs,
attention counted at the global length (observability/mfu.py
`rank_train_flops`).

Expert parallelism (`cfg.mesh.expert` ranks, between the data and the
sequence axes: the JAX package's `expert` mesh axis and its rules
table). An MoE model is built for this rank's `ExpertShard`: each routed
layer holds E/ep experts of every stack, and so do the AdamW moments;
the router and every other leaf stay whole. The expert ranks of one
data shard take the same rows (the data world is world / (sequence ×
expert)), draw the same dropout masks and route alike; each runs its
experts and one all-reduce over the expert axis sums the partial
outputs. The counts, the loss and the gradient bucket are still summed
over `reduce_group` (data × sequence at this expert coordinate), never
the world: replicated leaves' gradients are already equal within the
expert group, and a stack's block is summed over the ranks that hold
it. The clip's global norm sums the blocks' squares over the expert
group and counts every replicated leaf once, so every rank clips alike.
Checkpoints write each block from one rank (training/checkpoint.py). A
dense model on an expert axis trains as replicas.

Pipeline parallelism (`cfg.mesh.pipeline` ranks, between fsdp and
expert: the JAX package's `pipeline` mesh axis). The LM is built with
`pipeline_stages` = the axis and the config's `pipeline_schedule` (the
JAX trainer's factory kwargs; a model without stages raises TypeError),
and for this rank's `PipelineShard`: it holds its stage's L/S layers,
stage 0 the embeddings, the last stage the final LayerNorm and the heads
(models/gpt.py, models/bert.py). Each accumulation microbatch is cut
into M pipeline microbatches (`num_microbatches`, clamped as the JAX
model clamps it against the global rows); a data shard holds its block
of every microbatch's global rows, as the reference's unsharded
microbatch dim lays them out (`local_rows` over accum × M blocks). The
step runs the schedule (parallel/pipeline.py `run_schedule`: GPipe or
1F1B, activations sent point to point in the compute dtype): stage 0
embeds, every stage runs its layers, the last computes the loss of its
microbatch over the global item counts (all-reduced before any
backward), and each backward is `torch.autograd.backward(stage_out,
grad_from_next)`. An MoE stage adds its own layers' load-balance loss to
its backward: the router's gradient reaches earlier stages through the
activation gradient, and the reported `moe_aux_loss` is the sum over the
real (microbatch, stage) calls. Dropout draws each microbatch's rows of
the masks world 1 draws for its batch, from the generator a world-1 run
holds at the stage's first layer (`advance_dropout`). Gradients are
summed over `reduce_group` (the ranks of this stage), the loss and aux
are then summed over the pipeline group (so every rank's `losses`
agree, the last stage's value), and the clip's norm sums every stage's
leaves once. `evaluate` is a forward-only pass through the stages;
`stage_live` keeps the live-activation counter of the last step.

FSDP (`cfg.mesh.fsdp` ranks, between data and pipeline: the JAX
package's `fsdp` mesh axis and its rules table). The model is built for
this rank's `FsdpShard`: every leaf whose spec (`logical_to_spec(
logical_axes_for(params, fsdp, mesh sizes))`, the JAX trainer's
`state_shardings`) names `fsdp` on dim d is held as this rank's 1/fsdp
block along d, drawn from the same seeded whole init, and so are its
two AdamW moments; every other leaf (the 1-D ones, a dim the axis does
not divide: gpt_small's 50,257-row `tok_emb`) is whole on every rank.
A block is gathered in f32 over the fsdp group at its use, and the
gather's backward reduce-scatters its gradient over the fsdp group
(models/layers.py `at_use`). The batch rows split over data × fsdp
(rank d·F + f feeds block d·F + f, its dropout masks that block's rows
of the global masks), and the item counts, the loss, BatchNorm's
statistics and the whole leaves' gradients are summed over data × fsdp
(`batch_group`); a block's gradient, already summed over fsdp, is summed
over data (`reduce_group`, at this rank's fsdp coordinate) in a bucket
of its own. `grad_allreduces` counts the buckets' all-reduces: one a
step, two when the fsdp blocks meet a data axis above 1; the fsdp
shard's `counts` the gathers (one a use, a remat recompute's included)
and the reduce-scatters (one a gathered use in the backward's graph).
The clip sums the blocks' squares over the fsdp group and counts every
whole leaf once. Checkpoints write each block from the rank at data
coordinate 0 (training/checkpoint.py). MFU is a rank's share of the
global step's FLOPs over data × fsdp.

Tensor parallelism (`cfg.mesh.tensor` ranks, innermost: the JAX
package's `tensor` axis and its rules' heads, mlp, vocab and
vocab_table entries). A GPT or BERT model (and their MoE variants) is
built for this rank's `TensorShard`: each leaf whose spec names `tensor`
is held as its 1/t block along that dim, drawn from the same seeded
whole init, and so are its AdamW moments; blocks are never gathered.
q/k/v and the MLP's first product are column-parallel, `out` and the
MLP's second row-parallel (their partial sums all-reduced over the
tensor group, the bias added once), the tables and the head vocab-split
where the axis divides their rows, with a vocab-parallel loss
(models/layers.py `shard_tensor`, training/tasks.py). The tensor ranks
of a data shard feed the same rows and draw the same dropout masks
(every site follows a row-parallel sum), so the data world is world /
tensor, and the counts, the loss and one gradient bucket (the blocks'
and the replicated leaves') are summed over `batch_group`, the data
axis at this tensor coordinate: a replicated leaf's gradient is already
equal across the tensor ranks (`copy_to_group` sums its input's
cotangent) and is never all-reduced over tensor. The clip sums the
blocks' squares over the tensor group and counts every replicated leaf
once; `TensorShard.counts` tallies the tensor group's all-reduces.
Checkpoints write each block from the rank at data coordinate 0 of its
tensor coordinate. MFU is a rank's share of the global step's FLOPs over
data × tensor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.chaos import default_chaos
from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.models.convert import is_batch_stat
from kubeflow_tpu_torch.models.layers import (
    fsdp_leaves,
    sharded_stacks,
    tensor_leaves,
)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.observability.mfu import (
    encoder_train_flops,
    goodput as goodput_fraction,
    lm_train_flops,
    mfu as mfu_fraction,
    peak_flops_per_chip,
    rank_train_flops,
)
from kubeflow_tpu_torch.observability.trace import default_tracer
from kubeflow_tpu_torch.parallel import distributed as gang
from kubeflow_tpu_torch.parallel.mesh import (
    batch_group,
    expert_shard,
    fsdp_shard,
    mesh_coordinate,
    mesh_from_config,
    pipeline_shard,
    reduce_group,
    sequence_parallel,
    sequence_shard,
    tensor_shard,
)
from kubeflow_tpu_torch.parallel.pipeline import (
    clamp_microbatches,
    run_forward,
    run_schedule,
)
from kubeflow_tpu_torch.training.data import (
    local_rows,
    row_indices,
    shard_batch,
    shard_columns,
    to_device,
)
from kubeflow_tpu_torch.training.prefetch import DevicePrefetcher
from kubeflow_tpu_torch.training.tasks import (
    _moe_collector,
    clip_by_global_norm,
    make_optimizer,
    make_schedule,
    moe_aux_share,
    task_for_model,
    uses_sgd,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    host_wait_histogram,
    training_eval_top1_gauge,
    training_goodput_gauge,
    training_items_gauge,
    training_mfu_gauge,
    training_step_histogram,
)

log = get_logger(__name__)

MAX_GRAD_NORM = 1.0
# tags the dropout stream's seeds apart from the data streams'
_DROPOUT_STREAM = 0x64726F70
# task aux values a step returns and the log window reports, as the JAX
# step's metrics carry them: each is the global batch's on every rank
STEP_AUX = ("moe_aux_loss",)


def dropout_seed(seed: int, step: int, micro: int = 0) -> int:
    """The 64-bit seed of update `step`'s dropout generator (microbatch
    `micro` under accumulation): a pure function of (seed, step, micro)."""
    ss = np.random.SeedSequence([_DROPOUT_STREAM, seed, step, micro])
    return int(ss.generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class TrainState:
    """Updates done so far, the model (its parameters are the f32 master
    weights) and the optimizer (its moments). Mutated in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def checkpoint_tree(self) -> Dict[str, Any]:
        """The JAX package's manifest tree of this state (live tensors;
        training/checkpoint.py)."""
        from kubeflow_tpu_torch.training.checkpoint import train_state_tree

        return train_state_tree(self)

    def restore_tree(self, entries: Dict[str, Any]) -> Dict[str, Any]:
        """The tree to restore into, in the layout of the checkpoint whose
        manifest entries are `entries` (training/checkpoint.py)."""
        from kubeflow_tpu_torch.training.checkpoint import restore_tree

        return restore_tree(self, entries)

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        """Load a restored manifest tree in place."""
        from kubeflow_tpu_torch.training.checkpoint import (
            load_train_state_tree,
        )

        load_train_state_tree(self, tree)


@dataclasses.dataclass
class StepMetrics:
    step: int
    loss: float
    items_per_sec: float
    step_time_s: float
    aux: Dict[str, float]


class Trainer:
    """Builds the model, task and optimizer for one (model, config) on
    one device. `device` defaults to "cuda" and raises without CUDA
    unless "cpu" is asked for. In a `torch.distributed` group the trainer
    is this rank's: `self.mesh` is the DeviceMesh of `cfg.mesh` over the
    group's ranks; it names the data × fsdp × sequence group the step
    sums over, `self.seq`, this rank's place on the sequence axis,
    `self.expert`, its place on the expert axis, `self.pipe`, its stage
    of the pipeline axis, `self.fsdp`, its place on the fsdp axis, and
    `self.tensor`, on the tensor axis (each None at 1). `model_kwargs`
    reach the
    registry factory of a model the trainer builds (the JAX trainer's
    argument, e.g. `{"moe_top_k": 2}`)."""

    def __init__(self, cfg: TrainingConfig, model=None, task=None,
                 device: DeviceLike = None,
                 model_kwargs: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the gang: a group (of any size, one included) takes the
        # data-parallel step; without one the mesh must be one device
        self.distributed = torch.distributed.is_initialized()
        self.world, self.rank = gang.world_size(), gang.rank()
        self.mesh = None
        # the batch's group (counts, loss, BatchNorm, whole leaves' grads)
        # and the fsdp blocks' (data × sequence at this fsdp coordinate)
        self._group = self._block_group = None
        self.seq = None
        self.expert = None
        self.pipe = None
        self.fsdp = None
        self.tensor = None
        if self.distributed:
            backend = torch.distributed.get_backend()
            self.mesh = mesh_from_config(
                cfg.mesh, device_type="cuda" if backend == "nccl" else "cpu")
            self._block_group = reduce_group(self.mesh)
            self._group = batch_group(self.mesh)
            self.seq = sequence_shard(self.mesh)
            self.expert = expert_shard(self.mesh)
            self.pipe = pipeline_shard(self.mesh)
            self.fsdp = fsdp_shard(self.mesh)
            self.tensor = tensor_shard(self.mesh)
        elif cfg.mesh.num_devices != 1:
            raise ValueError(
                f"mesh spec needs {cfg.mesh.num_devices} devices "
                f"({cfg.mesh.axis_sizes()}), got 1: start the gang's "
                f"processes (runtime/launcher.py) with its rendered env")
        # this rank's place on the batch's data × fsdp split (the same for
        # every expert and tensor rank and pipeline stage of the shard)
        self.data_world = self.world // (cfg.mesh.sequence * cfg.mesh.expert
                                         * cfg.mesh.pipeline
                                         * cfg.mesh.tensor)
        self.data_rank = (mesh_coordinate(self.mesh, "data") * cfg.mesh.fsdp
                          + mesh_coordinate(self.mesh, "fsdp"))
        # gradient buckets' all-reduces issued (one a data-parallel step,
        # two when fsdp blocks are summed over a data axis too)
        self.grad_allreduces = 0
        # the last pipelined step's live-activation counter
        self.stage_live = None
        if model is None:
            # the config's context window, remat and attention reach an
            # LM's factory (JAX trainer.py:97-124)
            kwargs: Dict[str, Any] = dict(model_kwargs or {})
            if cfg.remat:
                kwargs["remat"] = True
            if cfg.model.startswith(("gpt", "bert")):
                impl = cfg.attention_impl
                if cfg.mesh.sequence > 1 and impl == "dense":
                    # a sequence mesh axis means sequence parallelism:
                    # ring attention, as the JAX trainer defaults it
                    impl = "ring"
                kwargs["attention_impl"] = impl
                if self.expert is not None:
                    # an MoE model's routed layers: this rank's experts
                    kwargs["expert"] = self.expert
            if cfg.mesh.pipeline > 1:
                # the JAX trainer's pipeline kwargs, for any model: a
                # factory without stages raises TypeError on them, as the
                # JAX factories do; this rank's stage
                kwargs.setdefault("pipeline_stages", cfg.mesh.pipeline)
                kwargs.setdefault("pipeline_schedule", cfg.pipeline_schedule)
                if self.pipe is not None:
                    kwargs["pipeline"] = self.pipe
            if self.fsdp is not None:
                # this rank's blocks of the fsdp leaves, any model family
                kwargs["fsdp"] = self.fsdp
            if self.tensor is not None:
                # this rank's blocks of the tensor leaves (the config
                # refuses the families that take none)
                kwargs["tensor"] = self.tensor
            if cfg.seq_len > 0:
                kwargs["max_len"] = cfg.seq_len
            dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
            model = get_model(cfg.model, dtype=dtype, device=self.device,
                              seed=cfg.seed, **kwargs)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the trainer on "
                             f"{self.device}")
        self.model = model.trainable()
        # the parameters held as fsdp blocks (their gradients are summed
        # over the fsdp axis by their gathers' backward)
        self._fsdp_blocks = {id(self.model.get_parameter(n))
                             for n in fsdp_leaves(self.model)}
        # and as tensor blocks (summed with the whole leaves: over data)
        self._tensor_blocks = {id(self.model.get_parameter(n))
                               for n in tensor_leaves(self.model)}
        # the pipeline's microbatches a step's accumulation microbatch
        # (the JAX model's clamp against its global rows)
        self.pipeline_microbatches = 1
        if self.pipe is not None:
            self.pipeline_microbatches = clamp_microbatches(
                self.model.cfg.num_microbatches, self.pipe.size,
                cfg.global_batch_size // cfg.accum_steps)
        # this rank's rows of each global batch: a block of every
        # (accumulation, pipeline) microbatch, and their indices
        self._rows = (local_rows(cfg.global_batch_size, self.data_rank,
                                 self.data_world,
                                 cfg.accum_steps * self.pipeline_microbatches)
                      if self.distributed else None)
        self._row_index = (row_indices(self._rows) if self.data_world > 1
                           else None)
        if self.distributed:
            self._check_layout()
        if self.world > 1:
            from kubeflow_tpu_torch.models.resnet import sync_batch_stats

            sync_batch_stats(self.model, self._group)
        self.task = task if task is not None else task_for_model(cfg.model, cfg)
        mcfg = self.model.cfg
        if task is None and hasattr(self.task, "vocab_size"):
            # clamp the task's data dims to the model's tables
            self.task.vocab_size = min(self.task.vocab_size, mcfg.vocab_size)
            if cfg.seq_len > 0:
                if cfg.seq_len > mcfg.max_len:
                    # an explicit request is never clamped silently
                    raise ValueError(
                        f"cfg.seq_len {cfg.seq_len} exceeds the model's "
                        f"max_len {mcfg.max_len}; build the model with a "
                        f"matching context window"
                    )
                self.task.seq_len = cfg.seq_len
            self.task.seq_len = min(self.task.seq_len, mcfg.max_len)
        self.schedule = make_schedule(cfg)
        self._clip = not uses_sgd(cfg.model)
        self._final_state: Optional[TrainState] = None
        self._stop_reason = ""
        # every step's loss fit ran, read on the host: (step, loss)
        self.losses: List[Tuple[int, float]] = []
        # FLOPs of one step (non-LM models), counted once
        self._step_flops: Optional[float] = None
        # where the last step's input came from: "device" (made on the
        # card) or "host" (batch_at, copied over); the device type the
        # last augmented batch lived on (None when nothing was augmented)
        self.input_path = ""
        self.augment_device: Optional[str] = None
        # kft-chaos: the trainer.device_step injection point
        self._chaos = default_chaos()
        # dropout draws from a generator made for each step
        self._dropout = getattr(self.model.cfg, "dropout_rate", 0.0) > 0

    def _check_layout(self) -> None:
        """Every parameter's spec on the mesh (training/annotations.py over
        parallel/sharding.py) must be one the step runs: replicated, split
        on dim 0 over the expert axis alone (an expert stack) or on one
        dim over the fsdp or the tensor axis alone (held as that dim's
        block), and then the model must hold exactly this rank's block of
        it. On a
        pipeline axis a layer's leaf is split on its stage dim over the
        axis (then as above), and the model holds exactly its stage's
        layers and the leaves its stage owns."""
        from kubeflow_tpu_torch.models.layers import (
            held_layers,
            leaf_owner,
            whole_model,
        )
        from kubeflow_tpu_torch.parallel.mesh import mesh_shape
        from kubeflow_tpu_torch.parallel.sharding import (
            axis_dim,
            is_replicated,
            param_specs,
        )
        from kubeflow_tpu_torch.training.annotations import (
            logical_axes_for,
            whole_shapes,
        )

        sizes = mesh_shape(self.mesh)
        specs = param_specs(logical_axes_for(
            self.model, fsdp_size=sizes.get("fsdp", 1),
            mesh_axis_sizes=sizes), mesh=sizes)
        mcfg = self.model.cfg
        experts = getattr(mcfg, "num_experts", 0)
        if experts and experts % sizes["expert"]:
            raise ValueError(
                f"the model's {experts} experts do not divide over the "
                f"expert mesh axis {sizes['expert']}")
        whole = whole_shapes(self.model)
        params = dict(self.model.named_parameters())
        held = {n: dim for n, (_, _, dim) in fsdp_leaves(self.model).items()}
        split = {n: dim for n, (_, _, dim)
                 in tensor_leaves(self.model).items()}
        stages = getattr(mcfg, "pipeline_stages", 1)
        bad = []
        if sizes["pipeline"] > 1:
            if self.pipe is None or stages != sizes["pipeline"] or \
                    getattr(self.model, "pipeline", None) != self.pipe:
                raise ValueError(
                    f"mesh {sizes} needs the model built for this rank's "
                    f"stage of {sizes['pipeline']} (`pipeline=`), got "
                    f"{stages} stages")
            layers = set(held_layers(mcfg.num_layers, stages, self.pipe))
            want = {n for n in whole_shapes(whole_model(self.model))
                    if (int(n.split(".")[1]) in layers
                        if n.startswith("layers.")
                        else leaf_owner(self.model, n) == self.pipe.rank)}
            bad += sorted(want ^ set(params))
        for name, spec in specs.items():
            shape, full = tuple(params[name].shape), whole[name]
            if stages > 1 and name.startswith("layers."):
                # a stage stack's leaf: this rank holds one stage of it
                # (the model holding every stage holds each whole)
                if sizes["pipeline"] > 1 and spec[:1] != ("pipeline",):
                    bad.append(name)
                    continue
                spec, full = spec[1:], full[1:]
            blocked = name in held or name in split
            if is_replicated(spec):
                ok = shape == full and not blocked
            elif spec[0] == "expert":
                ok = (is_replicated(spec[1:]) and not blocked
                      and shape[0] * sizes["expert"] == full[0]
                      and shape[1:] == full[1:])
            else:
                # one dim split over the fsdp or the tensor axis alone:
                # the model's block of it along that dim
                axis = "fsdp" if axis_dim(spec, "fsdp") is not None \
                    else "tensor"
                dim = axis_dim(spec, axis)
                ok = (dim is not None and spec[dim] == axis
                      and is_replicated(spec[:dim] + spec[dim + 1:])
                      and (held if axis == "fsdp" else split).get(name) == dim
                      and shape == full[:dim] + (full[dim] // sizes[axis],)
                      + full[dim + 1:])
            if not ok:
                bad.append(name)
        if bad:
            raise ValueError(
                f"mesh {sizes} lays out {sorted(bad)[:3]}... in a way the "
                f"port's step does not run (it keeps leaves whole, an "
                f"expert stack's block of E/ep experts a rank, an fsdp "
                f"or a tensor leaf's block along its spec's dim, or a "
                f"pipeline stage's layers: build the model with this "
                f"rank's `expert`, `fsdp`, `tensor` and `pipeline` "
                f"shards)")

    # ---- state -----------------------------------------------------------

    def init_state(self) -> TrainState:
        """Fresh state: the model's seeded init (cfg.seed; running
        averages reset) and a fresh optimizer. Every call gives the same
        initial weights."""
        self.model.init_params(self.cfg.seed)
        opt = make_optimizer(self.cfg, self.cfg.model, self.model.parameters())
        return TrainState(step=0, model=self.model, optimizer=opt)

    # ---- the step --------------------------------------------------------

    def _microbatches(self, batch):
        a = self.cfg.accum_steps
        rows = next(iter(batch.values())).shape[0] // a
        return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                for i in range(a)]

    def _loss_kwargs(self, step: int, micro: int = 0) -> Dict[str, Any]:
        """The task loss's dropout generator for (step, micro), on the
        device; nothing for a model without dropout."""
        if not self._dropout:
            return {}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(dropout_seed(self.cfg.seed, step, micro))
        return {"dropout_generator": gen}

    def local_batch(self, batch):
        """This rank's rows of a global batch, and under a sequence axis
        its columns and lookahead column (the batch itself without a
        gang)."""
        if self._rows is None:
            return batch
        batch = shard_batch(batch, self._rows)
        if self.seq is not None:
            batch = shard_columns(batch, self.seq.rank, self.seq.size)
        return batch

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One update, in place → (state, {"loss": device scalar}). `batch`
        is the task's (numpy or device tensors): [B, S]
        input_ids/attention_mask, or image [B, H, W, 3] and label [B]; in
        a gang, this rank's rows (`local_batch`). No host sync."""
        model, opt = state.model, state.optimizer
        if self.cfg.accum_steps > 1 and any(
                is_batch_stat(n) for n, _ in model.named_buffers()):
            # keyed on the model's variables, not the task class
            raise ValueError(
                "accum_steps > 1 is unsupported for models with batch "
                "statistics (BatchNorm): per-microbatch stats != "
                "full-batch stats"
            )
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = to_device(batch, self.device)
        augment = getattr(self.task, "augment_batch", None)
        if augment is not None and self.cfg.data.augment != "none":
            # every stream is a pure function of (seed, step): a resumed
            # run replays the same crops; a rank crops its rows as a
            # world-1 run would
            batch = augment(batch, state.step, rows=self._row_index)
            self.augment_device = batch["image"].device.type
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        opt.zero_grad(set_to_none=True)
        a = self.cfg.accum_steps
        micro = self._microbatches(batch) if a > 1 else [batch]
        if self.pipe is not None:
            loss_sum, w_sum, step_aux = self._pipeline_forward_backward(
                state, model, micro)
        else:
            with sequence_parallel(self.seq):
                loss_sum, w_sum, step_aux = self._forward_backward(
                    state, model, micro)
        if self.distributed:
            loss_sum = self._all_reduce_grads(params, loss_sum)
        if self.pipe is not None:
            # the stages' partial losses and aux values (the last stage's
            # loss; each stage's layers' aux), summed: every rank's
            loss_sum, step_aux = self._pipeline_sum(loss_sum, step_aux)
        if a > 1:
            w_sum = w_sum.clamp_min(1e-9)
            for p in params:
                p.grad.div_(w_sum)
            loss = loss_sum / w_sum
        else:
            loss = loss_sum
        if self._clip:
            # the blocks of leaves split over one axis (expert, fsdp or
            # tensor; the config refuses any two together)
            blocks = (self._fsdp_blocks | self._tensor_blocks
                      | {id(model.get_parameter(n))
                         for n in sharded_stacks(model)})
            shard = self.expert or self.fsdp or self.tensor
            if self.tensor is not None and self._tensor_blocks:
                # the blocks' squared norms, summed over the tensor group
                self.tensor.counts["all_reduce"] += 1
            clip_by_global_norm(
                [p.grad for p in params if id(p) not in blocks],
                MAX_GRAD_NORM,
                sharded=[p.grad for p in params if id(p) in blocks],
                group=None if shard is None else shard.group,
                stage_group=None if self.pipe is None else self.pipe.group)
        # optax evaluates the schedule at the update count BEFORE this
        # update: the first update runs at schedule(0)
        lr = self.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        # averaged over the microbatches, as the JAX step averages aux
        return state, {"loss": loss, **{
            key: torch.stack(vals).mean() for key, vals in step_aux.items()}}

    def _forward_backward(self, state: TrainState, model, micro):
        """Every microbatch's loss and backward → (loss sum, weight sum
        (None without accumulation), aux values)."""
        a = len(micro)
        counts = None
        if self.distributed:
            # the global batch's denominators, before any backward
            counts = torch.stack([self.task.item_counts(sub) for sub in micro])
            torch.distributed.all_reduce(counts, group=self._group)
        loss_sum = w_sum = None
        if a > 1:
            loss_sum = torch.zeros((), device=self.device)
            w_sum = torch.zeros((), device=self.device)
        # the task's global aux values (STEP_AUX), one a microbatch
        step_aux: Dict[str, List[torch.Tensor]] = {}
        for i, sub in enumerate(micro):
            kwargs = self._loss_kwargs(state.step, i)
            if counts is not None:
                kwargs["counts"] = counts[i]
                kwargs["group"] = self._group
            with self._dropout_rows(sub):
                loss_i, out_i = self.task.loss(model, sub, **kwargs)
                for key in STEP_AUX:
                    if key in out_i["aux"]:
                        step_aux.setdefault(key, []).append(out_i["aux"][key])
                if a == 1:
                    loss_i.backward()
                    loss_sum = loss_i.detach()
                    continue
                # Σ w_i·g_i / Σ w_i with w_i the microbatch's valid pairs:
                # the full-batch token-mean gradient even under ragged
                # masks (tasks without an item count weight equally)
                w_i = out_i.get("loss_items",
                                torch.ones((), device=self.device))
                (loss_i * w_i).backward()
            loss_sum = loss_sum + loss_i.detach() * w_i
            w_sum = w_sum + w_i
        return loss_sum, w_sum, step_aux

    def _dropout_rows(self, sub):
        """In a gang of several ranks, dropout draws the global
        microbatch's masks and keeps this rank's rows (and under a
        sequence axis its columns): the expert ranks of a data shard
        draw the same masks."""
        if self.world == 1 or not self._dropout:
            return contextlib.nullcontext()
        from kubeflow_tpu_torch.models.layers import dropout_rows

        rows = next(iter(sub.values())).shape[0]
        cols = ()
        if self.seq is not None:
            s = sub["input_ids"].shape[1]
            cols = (self.seq.rank * s, self.seq.size * s)
        return dropout_rows(self.data_rank * rows, self.data_world * rows,
                            *cols)

    def _pipeline_forward_backward(self, state: TrainState, model, micro):
        """This stage's part of every accumulation microbatch's pipelined
        forward and backward (parallel/pipeline.py `run_schedule`) →
        (this stage's partial loss sum, weight sum (None without
        accumulation), this stage's aux values)."""
        pipe, group = self.pipe, self._group
        a, m = len(micro), self.pipeline_microbatches
        # the global batch's denominators, before any backward
        counts = torch.stack([self.task.item_counts(sub) for sub in micro])
        torch.distributed.all_reduce(counts, group=group)
        loss_sum = torch.zeros((), device=self.device)
        w_sum = torch.zeros((), device=self.device) if a > 1 else None
        step_aux: Dict[str, List[torch.Tensor]] = {}
        routed = _moe_collector(model) is not None
        dtype = model.cfg.dtype
        for i, sub in enumerate(micro):
            w = self.task.loss_weight(counts[i]) if a > 1 else None
            rows = next(iter(sub.values())).shape[0] // m
            parts = [{k: v[j * rows:(j + 1) * rows] for k, v in sub.items()}
                     for j in range(m)]
            gen_state = self._stage_dropout_state(state.step, i, sub)
            saved: Dict[int, Tuple] = {}
            partial = torch.zeros((), device=self.device)
            aux = torch.zeros((), device=self.device)

            def forward(j, x, i=i, w=w, parts=parts, gen_state=gen_state,
                        saved=saved):
                nonlocal partial, aux
                part = parts[j]
                gen = None
                if gen_state is not None:
                    gen = torch.Generator(device=self.device)
                    gen.set_state(gen_state)
                with self._microbatch_rows(j, rows):
                    if pipe.first:
                        x = model.embed(part["input_ids"],
                                        part.get("token_type_ids"))
                    else:
                        x.requires_grad_()
                    moe = _moe_collector(model) if routed else None
                    y = model.stage(x, attention_mask=self.task.model_mask(
                        part), dropout_generator=gen, moe=moe)
                objective = None
                share = moe_aux_share(moe, group)
                if share is not None:
                    objective = share[0]
                    aux = aux + share[1]
                if pipe.last:
                    head, _ = self.task.head_loss(model, y, part,
                                                  counts=counts[i])
                    objective = head if objective is None else \
                        head + objective
                    y = None
                else:
                    y = y.to(dtype)
                if objective is not None:
                    partial = partial + objective.detach()
                    if w is not None:
                        objective = objective * w
                saved[j] = (x, y, objective)
                return y

            def backward(j, g, saved=saved):
                x, y, objective = saved.pop(j)
                if y is None:
                    torch.autograd.backward(objective)
                elif objective is None:
                    torch.autograd.backward(y, g)
                else:
                    torch.autograd.backward(
                        [y, objective], [g, torch.ones_like(objective)])
                return None if pipe.first else x.grad

            like = torch.empty(
                (rows, sub["input_ids"].shape[1], model.cfg.hidden_size),
                dtype=dtype, device=self.device)
            self.stage_live = run_schedule(pipe, model.cfg.pipeline_schedule,
                                           m, forward, backward, like)
            if w is None:
                loss_sum = partial
            else:
                loss_sum = loss_sum + partial * w
                w_sum = w_sum + w
            if routed:
                step_aux.setdefault("moe_aux_loss", []).append(aux)
        return loss_sum, w_sum, step_aux

    def _pipeline_sum(self, loss: torch.Tensor,
                      step_aux: Dict[str, List[torch.Tensor]]):
        """Sum the stages' partial loss and aux values over the pipeline
        group (one all-reduce): every rank gets the step's."""
        keys = sorted(step_aux)
        flat = torch.stack([loss.float()] + [v.float() for k in keys
                                             for v in step_aux[k]])
        torch.distributed.all_reduce(flat, group=self.pipe.group)
        out: Dict[str, List[torch.Tensor]] = {}
        off = 1
        for k in keys:
            n = len(step_aux[k])
            out[k] = list(flat[off:off + n].clone().unbind(0))
            off += n
        return flat[0].clone(), out

    def _stage_dropout_state(self, step: int, micro: int, sub):
        """The state this stage's dropout generator starts each pipeline
        microbatch from (None without dropout): accumulation microbatch
        `micro`'s world-1 generator after the earlier stages' layers have
        drawn their masks for the whole (global) microbatch."""
        kwargs = self._loss_kwargs(step, micro)
        gen = kwargs.get("dropout_generator")
        if gen is None:
            return None
        from kubeflow_tpu_torch.models.layers import advance_dropout

        rows, seq = sub["input_ids"].shape
        layers = self.pipe.rank * (self.model.cfg.num_layers
                                   // self.pipe.size)
        draws = layers * type(next(iter(self.model.layers))).DROPOUT_DRAWS
        advance_dropout(gen, draws, (rows * self.data_world, seq,
                                     self.model.cfg.hidden_size))
        return gen.get_state()

    def _microbatch_rows(self, j: int, rows: int):
        """Pipeline microbatch j's rows (`rows` on this rank) of the
        global accumulation microbatch a world-1 dropout draws for: its
        data shard's block of global microbatch j."""
        if not self._dropout:
            return contextlib.nullcontext()
        from kubeflow_tpu_torch.models.layers import dropout_rows

        shard = rows * self.data_world
        return dropout_rows(j * shard + self.data_rank * rows,
                            shard * self.pipeline_microbatches)

    def _all_reduce_grads(self, params, loss_part: torch.Tensor
                          ) -> torch.Tensor:
        """Sum every gradient (and the loss's partial sum) in place: the
        whole leaves' and the loss over the batch's group (data × fsdp ×
        sequence) in one flat bucket a dtype; the fsdp blocks' (summed
        over fsdp by their gathers' backward) over data × sequence, when
        that group holds more than this rank. Returns the summed loss."""
        for p in params:
            if p.grad is None:  # a leaf this step did not reach
                p.grad = torch.zeros_like(p)
        blocks = self._fsdp_blocks
        loss = self._all_reduce_bucket(
            [p.grad for p in params if id(p) not in blocks], self._group,
            loss_part)
        grads = [p.grad for p in params if id(p) in blocks]
        if grads and torch.distributed.get_world_size(self._block_group) > 1:
            self._all_reduce_bucket(grads, self._block_group)
        return loss

    def _all_reduce_bucket(self, grads: List[torch.Tensor], group,
                           loss_part: Optional[torch.Tensor] = None
                           ) -> Optional[torch.Tensor]:
        """SUM `grads` over `group` in one flat bucket a dtype, in place,
        the f32 bucket (the master weights' grads) carrying `loss_part`
        last → the summed loss (None without one). One all-reduce counted
        in `grad_allreduces`."""
        buckets: Dict[torch.dtype, List[torch.Tensor]] = {torch.float32: []}
        for g in grads:
            buckets.setdefault(g.dtype, []).append(g)
        loss = None
        for dtype, part in buckets.items():
            parts = [g.reshape(-1) for g in part]
            if dtype == torch.float32 and loss_part is not None:
                parts.append(loss_part.reshape(1).float())
            if not parts:
                continue
            flat = torch.cat(parts)
            torch.distributed.all_reduce(flat, group=group)
            offset = 0
            for g in part:
                n = g.numel()
                g.copy_(flat[offset:offset + n].view_as(g))
                offset += n
            if dtype == torch.float32 and loss_part is not None:
                # a copy: a view would keep the bucket alive while the
                # log window holds the loss
                loss = flat[offset].clone()
        self.grad_allreduces += 1
        return loss

    # ---- eval ------------------------------------------------------------

    def evaluate(self, state: TrainState, eval_data) -> Dict[str, float]:
        """A pass over the eval split (`eval_batches`, the model in eval
        mode) → {top1, loss, count}. Each batch's three sums are read on
        the host, as the JAX package reads them; in a gang each rank
        takes its rows of the batch (padded to a multiple of the data
        ranks, the padding masked by `eval_mask`) and under a sequence
        axis its columns, and the sums are summed over the data ×
        sequence group first."""
        correct = count = loss_sum = 0.0
        state.model.eval()
        batches = (eval_data.eval_batches(pad_to_multiple=self.data_world)
                   if self.distributed else eval_data.eval_batches())
        with torch.no_grad(), sequence_parallel(self.seq):
            for batch_np in batches:
                if self.distributed:
                    rows = next(iter(batch_np.values())).shape[0]
                    batch_np = shard_batch(batch_np, local_rows(
                        rows, self.data_rank, self.data_world))
                if self.seq is not None:
                    batch_np = shard_columns(batch_np, self.seq.rank,
                                             self.seq.size)
                batch = to_device(batch_np, self.device)
                if self.pipe is not None:
                    sums = self._pipeline_eval_sums(state.model, batch)
                else:
                    stats = self.task.eval_stats(state.model, batch)
                    sums = torch.stack([stats["correct"], stats["count"],
                                        stats["loss_sum"]])
                if self.distributed:
                    torch.distributed.all_reduce(sums, group=self._group)
                if self.pipe is not None:
                    torch.distributed.all_reduce(sums, group=self.pipe.group)
                values = sums.tolist()
                correct += values[0]
                count += values[1]
                loss_sum += values[2]
        state.model.train()
        count = max(count, 1.0)
        return {"top1": correct / count, "loss": loss_sum / count,
                "count": count}

    def _pipeline_eval_sums(self, model, batch) -> torch.Tensor:
        """One eval batch's three sums through the stages (forward only;
        zeros on every stage but the last)."""
        out = []

        def forward(x):
            if self.pipe.first:
                x = model.embed(batch["input_ids"],
                                batch.get("token_type_ids"))
            y = model.stage(x, attention_mask=batch["attention_mask"])
            if self.pipe.last:
                stats = self.task.head_eval_stats(model, y, batch)
                out.append(torch.stack([stats["correct"], stats["count"],
                                        stats["loss_sum"]]))
                return None
            return y.to(model.cfg.dtype)

        ids = batch["input_ids"]
        like = torch.empty(tuple(ids.shape) + (model.cfg.hidden_size,),
                           dtype=model.cfg.dtype, device=self.device)
        run_forward(self.pipe, forward, like)
        return out[0] if out else torch.zeros(3, device=self.device)

    def rank_flops(self, batch) -> float:
        """This rank's share of an LM train step's model FLOPs at this
        rank's `batch` (observability/mfu.py `rank_train_flops`: the
        global step's count over data × fsdp × sequence × expert ×
        tensor)."""
        count = (encoder_train_flops if self.task.name == "mlm"
                 else lm_train_flops)
        seq = 1 if self.seq is None else self.seq.size
        stage = (None, 1) if self.pipe is None else (self.pipe.rank,
                                                     self.pipe.size)
        fsdp = self.cfg.mesh.fsdp
        return rank_train_flops(count, self.model.cfg,
                                *batch["input_ids"].shape,
                                data=self.data_world // fsdp, fsdp=fsdp,
                                sequence=seq, expert=self.cfg.mesh.expert,
                                stage=stage[0], stages=stage[1],
                                tensor=self.cfg.mesh.tensor)

    def step_flops(self, batch) -> float:
        """FLOPs of one training step of this model at `batch`'s shapes
        (forward and backward of the task's loss), counted once by
        `FlopCounterMode` on a meta-device twin of the model, so nothing
        runs on the card and no state moves. The LM and the encoder keep
        their analytic counts (`lm_train_flops`, `encoder_train_flops`)."""
        if self._step_flops is None:
            from torch.utils.flop_counter import FlopCounterMode

            twin = type(self.model)(self.model.cfg, device="meta").trainable()
            meta = {k: torch.empty(v.shape, device="meta", dtype=(
                v.dtype if isinstance(v, torch.Tensor)
                else torch.float32 if np.issubdtype(v.dtype, np.floating)
                else torch.int64)) for k, v in batch.items()}
            with FlopCounterMode(display=False) as counter:
                loss, _ = self.task.loss(twin, meta)
                loss.backward()
            self._step_flops = float(counter.get_total_flops())
        return self._step_flops

    # ---- the loop --------------------------------------------------------

    def fit(self, steps: Optional[int] = None, data=None,
            state: Optional[TrainState] = None, log_every: int = 10,
            checkpoint_manager=None, stop_event=None,
            eval_data=None) -> Optional[StepMetrics]:
        """Run the training loop; returns the last log window's metrics.
        Without `data`, the config's pipeline (`datasets.build_data`)
        gives the train data and its eval split. With eval data, a pass
        runs every `cfg.data.eval_every_steps` and at the end, and once
        `cfg.data.target_accuracy` (> 0) is reached the run stops early;
        the last eval's top1 and loss land in the metrics' aux as
        eval_top1/eval_loss. With `checkpoint_manager`
        (checkpointing/manager.py) the state is saved after every
        `cfg.checkpoint.interval_steps`-th update; the save blocks for its
        host copy only, and that time counts as overhead in goodput.
        `stop_event` (a threading.Event) is the preemption hook: once
        set, the loop finishes the step in flight and exits (unless that
        step is the last anyway; no eval runs); the save of that step is
        runtime/train_run.py's final forced save. Batches are read by
        global step (`batch_at(state.step + i)`), so a resumed run sees
        the batches an uninterrupted one would."""
        cfg = self.cfg
        steps = cfg.steps if steps is None else steps
        if data is None:
            from kubeflow_tpu_torch.training.datasets import build_data

            data, built_eval = build_data(cfg, self.task)
            if eval_data is None:
                eval_data = built_eval
        state = state if state is not None else self.init_state()
        start, end = state.step, state.step + steps
        # several ranks: each reads and decodes only its rows of a batch
        get_batch = data.batch_at
        if self.world > 1 and hasattr(data, "lazy_batch_at"):
            get_batch = data.lazy_batch_at
        # synthetic batches are made on the card: no host arrays and no
        # host→device copy a step
        device_gen = None
        if cfg.data.name == "synthetic" and hasattr(data, "device_batch_fn"):
            gen_fn = data.device_batch_fn(self.device)
            device_gen = lambda i: self.local_batch(gen_fn(i))  # noqa: E731
        self.input_path = "device" if device_gen is not None else "host"
        # host-fed: batches made and copied ahead of their step on the
        # prefetcher's thread (same step indices, so any depth trains on
        # the same sequence); depth 0 reads each in the loop
        prefetcher: Optional[DevicePrefetcher] = None
        if device_gen is None and cfg.data.prefetch_depth > 0 and steps > 0:
            prefetcher = DevicePrefetcher(
                lambda i: self.local_batch(get_batch(i)),
                lambda b: to_device(b, self.device),
                start_step=start, end_step=end,
                depth=cfg.data.prefetch_depth, model_label=cfg.model,
                device=self.device,
            ).start()
        try:
            return self._fit_loop(state, start, end, get_batch, device_gen,
                                  prefetcher, eval_data, checkpoint_manager,
                                  log_every, stop_event)
        finally:
            # every exit (normal, early stop, a non-finite loss, a data
            # error) reaps the worker thread
            if prefetcher is not None:
                prefetcher.close()

    def _fit_loop(self, state: TrainState, start: int, end: int, get_batch,
                  device_gen, prefetcher: Optional[DevicePrefetcher],
                  eval_data, checkpoint_manager, log_every: int,
                  stop_event) -> Optional[StepMetrics]:
        cfg = self.cfg
        steps = end - start
        model_label = cfg.model
        step_hist = training_step_histogram()
        thpt = training_items_gauge()
        host_wait = host_wait_histogram()
        mfu_gauge = training_mfu_gauge()
        goodput_gauge = training_goodput_gauge()
        acc_gauge = training_eval_top1_gauge()
        peak = peak_flops_per_chip(self.device)
        tracer = default_tracer()
        eval_every = cfg.data.eval_every_steps if eval_data is not None else 0
        target = cfg.data.target_accuracy if eval_data is not None else 0.0
        eval_metrics: Dict[str, float] = {}

        last: Optional[StepMetrics] = None
        # this window's (step, device loss): all read with the window's one
        # host sync, so every step's loss is kept without a sync a step
        pending: List[Tuple[int, torch.Tensor]] = []
        t_last = time.monotonic()
        steps_since_log = 0
        compile_s = 0.0
        stop_reason = ""
        self._stop_reason = ""
        w_start = time.monotonic()
        overhead_s = 0.0
        for i in range(start, end):
            t_wait = time.monotonic()
            with tracer.span("train.host_wait", model=model_label, step=i):
                if device_gen is not None:
                    batch = batch_np = device_gen(i)
                elif prefetcher is not None:
                    batch_np, batch = prefetcher.get(i)
                else:
                    batch_np = self.local_batch(get_batch(i))
                    batch = to_device(batch_np, self.device)
            waited = time.monotonic() - t_wait
            host_wait.observe(waited, model=model_label)
            overhead_s += waited
            # the span covers the step's launches (no sync is added); once
            # the launch queue is full they wait on the step before, so at
            # steady state it reads the step's time
            with tracer.span("train.device_step", model=model_label, step=i):
                self._chaos.maybe_fail("trainer.device_step")
                state, metrics = self.train_step(state, batch)
            pending.append((i + 1, metrics["loss"]))
            step_aux = {k: v for k, v in metrics.items() if k != "loss"}
            steps_since_log += 1
            if i == start and steps > 1:
                # the first step pays kernel builds and library warm-up:
                # fence it out of the throughput windows (one host sync)
                self._read_losses(pending)
                now = time.monotonic()
                compile_s = now - t_last
                t_last = now
                steps_since_log = 0
                # where steady state begins, in a trace
                tracer.event("train.compile_fence", model=model_label,
                             step=i + 1, compile_s=round(compile_s, 4))
                w_start = now
                overhead_s = 0.0
            if (checkpoint_manager is not None
                    and (i + 1) % cfg.checkpoint.interval_steps == 0):
                t_ckpt = time.monotonic()
                with tracer.span("train.checkpoint_block", model=model_label,
                                 step=i + 1):
                    checkpoint_manager.save(i + 1, state)
                overhead_s += time.monotonic() - t_ckpt
            if (stop_event is not None and stop_event.is_set()
                    and not stop_reason and i != end - 1):
                stop_reason = f"preempted at step {i + 1}"
                self._stop_reason = "preempted"
            is_last = i == end - 1
            # a stopping run does not spend its grace period on an eval
            if eval_data is not None and not stop_reason and (
                is_last or (eval_every and (i + 1) % eval_every == 0)
            ):
                t_eval = time.monotonic()
                with tracer.span("train.eval", model=model_label, step=i + 1):
                    eval_metrics = self.evaluate(state, eval_data)
                # eval time stays out of the step timing
                t_last += time.monotonic() - t_eval
                overhead_s += time.monotonic() - t_eval
                acc_gauge.set(eval_metrics["top1"], model=model_label)
                log.info("step %d eval top1=%.4f loss=%.4f (%d examples)",
                         i + 1, eval_metrics["top1"], eval_metrics["loss"],
                         int(eval_metrics["count"]))
                if target and eval_metrics["top1"] >= target:
                    stop_reason = (f"target accuracy {target:.2%} reached "
                                   f"at step {i + 1}")
                    is_last = True
            if (steps_since_log or (is_last and last is None)) and (
                (i + 1) % log_every == 0 or is_last
            ):
                loss = self._read_losses(pending)
                now = time.monotonic()
                dt = ((now - t_last) / steps_since_log if steps_since_log
                      else max(compile_s, 1e-9))
                t_last = now
                steps_since_log = 0
                # the global step's items: every rank feeds as many, and
                # the expert and tensor ranks and stages of a data shard
                # feed the same ones
                items = (self.task.count_items(batch_np) * self.world
                         // (self.cfg.mesh.expert * self.cfg.mesh.pipeline
                             * self.cfg.mesh.tensor))
                step_hist.observe(dt, model=model_label)
                thpt.set(items / dt, model=model_label)
                # the window's last step's aux, read after the losses' sync
                aux: Dict[str, float] = {k: float(v)
                                         for k, v in step_aux.items()}
                # the one-time FLOP count is fenced out of the next window
                t_acct = time.monotonic()
                if peak is None:
                    flops = None  # no MFU off a listed card
                elif getattr(self.task, "name", "") in ("mlm", "lm"):
                    flops = self.rank_flops(batch_np)
                else:
                    flops = self.step_flops(batch_np)
                mfu_val = mfu_fraction(flops, dt, peak)
                if mfu_val is not None:
                    mfu_gauge.set(mfu_val, model=model_label)
                    aux["mfu"] = mfu_val
                gp = goodput_fraction(now - w_start, overhead_s)
                goodput_gauge.set(gp, model=model_label)
                aux["goodput"] = gp
                t_last += time.monotonic() - t_acct
                w_start = time.monotonic()
                overhead_s = 0.0
                if compile_s:
                    aux["compile_s"] = compile_s
                if eval_metrics:
                    aux["eval_top1"] = eval_metrics["top1"]
                    aux["eval_loss"] = eval_metrics["loss"]
                last = StepMetrics(step=i + 1, loss=loss,
                                   items_per_sec=items / dt, step_time_s=dt,
                                   aux=aux)
                log.info("step %d loss=%.4f %.1f items/s (%.1f ms/step)",
                         last.step, last.loss, last.items_per_sec, dt * 1e3)
            if stop_reason:
                log.info("early stop: %s", stop_reason)
                if pending:
                    self._read_losses(pending)
                break
        self._final_state = state
        return last

    def _read_losses(self, pending: List[Tuple[int, torch.Tensor]]) -> float:
        """Read the window's losses in one host sync into `self.losses`;
        returns the last. A non-finite one stops the run: a "succeeded"
        run with a NaN loss is a silent failure. Nothing pending (a run
        stopping at its fenced first step): the last loss read."""
        if not pending:
            return self.losses[-1][1]
        values = torch.stack([loss for _, loss in pending]).tolist()
        for (step, _), loss in zip(pending, values):
            self.losses.append((step, loss))
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        pending.clear()
        return values[-1]
