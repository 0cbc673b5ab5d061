"""Mesh / topology layer (port of kubeflow_tpu/parallel/mesh.py).

The JAX package lays the gang's devices out as a `jax.sharding.Mesh`
and XLA inserts the collectives; here the same named axes form a
`torch.distributed.device_mesh.DeviceMesh` over the gang's ranks (one
rank a card), whose per-axis process groups carry the collectives the
training step issues itself (training/trainer.py).

Axis placement is the JAX package's: outermost the axes that may ride
the slow links between slices (pure data parallelism), innermost the
ones that communicate every layer (tensor). Ranks are numbered slice
by slice (`render_gang_env`), so the row-major layout of the ranks over
MESH_AXIS_ORDER puts the data axis across slices, and the sequence
axis, inner to data, makes each ring of consecutive ranks: rank
d·S + i holds sequence shard i of data shard d.

The JAX package's models find the sequence axis on the ambient mesh
(`active_mesh()`); here a training step names this rank's place on it
with `sequence_parallel(SequenceShard(...))`, and the models read
`active_sequence()` at each forward (and keep it for a remat recompute,
which runs outside the step's context).

The expert axis sits between them: rank d·(X·S) + x·S + i holds expert
block x of data shard d (sequence shard i). An MoE model is built for
its block (`ExpertShard`, from `expert_shard(mesh)`): its routed layers
hold only their E/ep experts and combine their partial outputs over
`expert_group(mesh)`.

The fsdp axis sits between data and pipeline: rank d·F + f holds
block f of every leaf whose spec names `fsdp` (training/annotations.py
over parallel/sharding.py), split along that dim (`FsdpShard`, from
`fsdp_shard(mesh)`; models/layers.py `shard_fsdp`), and its rows of the
global batch are data × fsdp block d·F + f. A leaf's block is gathered
over `fsdp_group(mesh)` at its use; the gather's backward reduce-scatters
its gradient back to the block.

The pipeline axis sits between fsdp and expert: its ranks are the
stages of one pipeline (`PipelineShard`, from `pipeline_shard(mesh)`),
each holding its run of layers; a stage's neighbours are the ranks one
step along the axis with every other coordinate the same, and they
exchange activations point to point (parallel/pipeline.py). The groups
a step sums over (`reduce_group`, `expert_group`) hold one pipeline
coordinate each: no sum spans stages.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from kubeflow_tpu_torch.config.platform import MeshConfig

# Outer → inner. Communication intensity increases left → right.
MESH_AXIS_ORDER: Tuple[str, ...] = (
    "data",
    "fsdp",
    "pipeline",
    "expert",
    "sequence",
    "tensor",
)

# Axes that may span slices without destroying step time.
DCN_FRIENDLY_AXES: Tuple[str, ...] = ("data", "pipeline")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A resolved mesh: ordered (axis, size) pairs covering all gang devices."""

    axis_sizes: Tuple[Tuple[str, int], ...]

    @classmethod
    def from_config(cls, cfg: MeshConfig) -> "MeshSpec":
        return cls(tuple((a, getattr(cfg, a)) for a in MESH_AXIS_ORDER))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axis_sizes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axis_sizes)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        for a, s in self.axis_sizes:
            if a == axis:
                return s
        raise KeyError(axis)

    def nontrivial_axes(self) -> List[str]:
        return [a for a, s in self.axis_sizes if s > 1]

    def dcn_split(self, num_slices: int) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Split axis sizes into (per-slice sizes, across-slice sizes).

        Only DCN-friendly axes are allowed to span slices; the outermost such
        axis absorbs the slice count. Raises if the mesh can't be laid out.
        """
        ici = dict(self.axis_sizes)
        dcn = {a: 1 for a, _ in self.axis_sizes}
        if num_slices == 1:
            return ici, dcn
        remaining = num_slices
        for axis in DCN_FRIENDLY_AXES:
            size = ici[axis]
            g = math.gcd(size, remaining)
            take = min(remaining, size)
            if size % take == 0:
                g = take
            if g > 1:
                ici[axis] = size // g
                dcn[axis] = g
                remaining //= g
            if remaining == 1:
                break
        if remaining != 1:
            raise ValueError(
                f"cannot lay {num_slices} slices across DCN-friendly axes "
                f"{DCN_FRIENDLY_AXES} of mesh {dict(self.axis_sizes)}; "
                f"increase data/pipeline parallelism to a multiple of the "
                f"slice count"
            )
        return ici, dcn


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def build_mesh(spec: MeshSpec, device_type: str = "cuda",
               num_slices: int = 1):
    """A `DeviceMesh` over the gang's ranks with `spec`'s axes as its
    `mesh_dim_names` (MESH_AXIS_ORDER), ranks laid out row-major. The
    spec must cover exactly the world's ranks; under several slices it
    must also lay out across them (`dcn_split`). Without a process group
    (one process) the mesh is the one rank's, with no groups behind it."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _world_size()
    if spec.num_devices != world:
        raise ValueError(
            f"mesh spec needs {spec.num_devices} devices "
            f"({dict(spec.axis_sizes)}), got {world}"
        )
    if num_slices > 1:
        spec.dcn_split(num_slices)
    ranks = torch.arange(world).reshape(spec.shape)
    if torch.distributed.is_initialized():
        return DeviceMesh(device_type, ranks, mesh_dim_names=spec.axis_names)
    try:
        return DeviceMesh(device_type, ranks, mesh_dim_names=spec.axis_names,
                          _init_backend=False, _rank=0)
    except TypeError:  # a torch whose DeviceMesh takes no `_rank`
        return DeviceMesh(device_type, ranks, mesh_dim_names=spec.axis_names,
                          _init_backend=False)


def mesh_from_config(cfg: MeshConfig, device_type: str = "cuda",
                     num_slices: int = 1):
    return build_mesh(MeshSpec.from_config(cfg), device_type=device_type,
                      num_slices=num_slices)


def single_device_mesh(device_type: str = "cuda"):
    """A one-rank mesh with the full axis vocabulary (every size 1), for
    single-card paths that share the distributed path's code."""
    return build_mesh(MeshSpec.from_config(MeshConfig()),
                      device_type=device_type)


def default_mesh_for(num_devices: int, tensor: int = 1, pipeline: int = 1,
                     sequence: int = 1, expert: int = 1, fsdp: int = 1,
                     device_type: str = "cuda"):
    """Convenience: fill the data axis with whatever devices remain."""
    denom = tensor * pipeline * sequence * expert * fsdp
    if num_devices % denom:
        raise ValueError(f"{num_devices} devices not divisible by {denom}")
    cfg = MeshConfig(
        data=num_devices // denom,
        fsdp=fsdp,
        tensor=tensor,
        pipeline=pipeline,
        sequence=sequence,
        expert=expert,
    )
    return mesh_from_config(cfg, device_type=device_type)


def data_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The process group of the mesh's data axis (None without a process
    group): the ranks whose gradients, BatchNorm statistics and item
    counts are summed."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    return mesh.get_group("data")


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh (the JAX `Mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coordinate(mesh, axis: str) -> int:
    """This rank's position along `axis` (0 without a process group)."""
    if mesh is None or not torch.distributed.is_initialized():
        return 0
    return mesh.get_local_rank(axis)


def sequence_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The process group of the mesh's sequence axis (None without a
    process group): the ranks of one ring, in ring order (group rank =
    position along the axis)."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    return mesh.get_group("sequence")


def axes_group(mesh, axes: Tuple[str, ...]
               ) -> Optional["torch.distributed.ProcessGroup"]:
    """The process group of the ranks that share this rank's coordinate
    on every axis but `axes` (None without a process group): the one axis
    of `axes` above 1's own group (the first's when none is), else one
    `new_group` for each block of ranks that share every other
    coordinate. Every rank creates every block's group (torch requires
    it), so call this once a mesh and axes, on every rank, in the same
    order."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    sizes = mesh_shape(mesh)
    live = [a for a in axes if sizes[a] > 1]
    if len(live) <= 1:
        return mesh.get_group(live[0] if live else axes[0])
    names = list(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    others = [i for i in range(len(names)) if i not in idx]
    blocks = mesh.mesh.permute(*others, *idx).reshape(
        -1, math.prod(sizes[a] for a in axes))
    me, mine = torch.distributed.get_rank(), None
    for ranks in blocks.tolist():
        group = torch.distributed.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def reduce_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The group a parameter's gradient is summed over once the step's
    backward has run: data × sequence at this rank's coordinate on every
    other axis (the expert, pipeline and fsdp axes' included: a stage's
    leaves are summed over the ranks of its stage only). A leaf held
    whole or as an expert stack's block is replicated over data ×
    sequence, so its gradient is summed over this group: the expert
    ranks of one data shard compute the same loss from the same rows,
    and their replicated leaves' gradients are already equal. An fsdp
    block's gradient has been reduce-scattered over the fsdp axis by the
    backward of its gather, so it too is summed over this group, at this
    rank's fsdp coordinate. A leaf held whole on an fsdp axis sums over
    `batch_group` instead. The data axis's own group when the sequence
    axis is 1, the sequence axis's when the data axis is (`axes_group`)."""
    return axes_group(mesh, ("data", "sequence"))


def batch_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The group the global batch is split over: data × fsdp × sequence
    at this rank's coordinate on every other axis. A step's item counts,
    its loss, BatchNorm's statistics and the gradients of the leaves held
    whole are summed over it. `reduce_group`'s own group when the fsdp
    axis is 1 (no second set of groups is made)."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    if mesh_shape(mesh)["fsdp"] == 1:
        return reduce_group(mesh)
    return axes_group(mesh, ("data", "fsdp", "sequence"))


def fsdp_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The process group of the mesh's fsdp axis (None without a process
    group): the ranks whose blocks make up every fsdp leaf, in block
    order."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    return mesh.get_group("fsdp")


@dataclasses.dataclass(frozen=True)
class FsdpShard:
    """This rank's place on the fsdp axis: the axis's process group, its
    position `rank` (its block of every fsdp leaf) and the axis's `size`.
    `writer`: this rank writes its blocks of a checkpoint (its coordinate
    on every other axis is 0, so each block is written once). `counts`
    tallies the collectives of its leaves: `all_gather` (a gather at a
    use, a remat recompute's included) and `reduce_scatter` (a gather's
    backward)."""

    group: Optional["torch.distributed.ProcessGroup"]
    rank: int
    size: int
    writer: bool = True
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_gather": 0, "reduce_scatter": 0},
        compare=False, repr=False)

    def block(self, length: int) -> Tuple[int, int]:
        """(first index, length) of this rank's block of a dim of
        `length`."""
        if length % self.size:
            raise ValueError(f"a dim of {length} does not split over the "
                             f"fsdp mesh axis {self.size}")
        n = length // self.size
        return self.rank * n, n

    def gather(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from every rank's `block`, joined along `dim` in
        rank order (`distributed.all_gather`: its backward reduce-scatters
        the leaf's gradient back to the blocks)."""
        from kubeflow_tpu_torch.parallel.distributed import all_gather

        self.counts["all_gather"] += 1
        return all_gather(block, self.group, dim, counts=self.counts)


def fsdp_shard(mesh) -> Optional[FsdpShard]:
    """The mesh's FsdpShard for this rank; None when the fsdp axis is 1
    or there is no process group."""
    group = fsdp_group(mesh)
    if group is None or mesh_shape(mesh)["fsdp"] == 1:
        return None
    others = [a for a in mesh.mesh_dim_names if a != "fsdp"]
    return FsdpShard(group, mesh.get_local_rank("fsdp"),
                     mesh_shape(mesh)["fsdp"],
                     writer=all(mesh.get_local_rank(a) == 0
                                for a in others))


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """This rank's place on one mesh axis: the axis's process group, its
    position `rank` and the axis's `size`."""

    group: Optional["torch.distributed.ProcessGroup"]
    rank: int
    size: int


def axis_shard(mesh, axis: str) -> Optional[AxisShard]:
    """The mesh's AxisShard of `axis` for this rank; None when the axis
    is 1 or there is no process group."""
    if mesh is None or not torch.distributed.is_initialized() \
            or mesh_shape(mesh)[axis] == 1:
        return None
    return AxisShard(mesh.get_group(axis), mesh.get_local_rank(axis),
                     mesh_shape(mesh)[axis])


def all_gather_bits(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every group rank's `x` joined along `dim` in rank order, moved as
    its bytes (its last dim viewed as uint8, which every backend
    carries; gloo has no 16-bit integer type): the bits arrive exactly,
    whatever the backend makes of the float type (gloo stages a CUDA
    tensor through host memory)."""
    from kubeflow_tpu_torch.parallel.distributed import all_gather

    wire = x.contiguous().view(torch.uint8)
    return all_gather(wire, group, dim % x.dim()).view(x.dtype)


@dataclasses.dataclass(frozen=True)
class MeshShard:
    """This rank's place on the axes that split a leaf at rest (`axes`:
    {axis: AxisShard} in gather order, e.g. a serving mesh's fsdp and
    tensor). A leaf's spec (parallel/sharding.py: one entry a dim, None,
    an axis or a tuple of axes) names the axes each dim is split over; a
    dim split over a tuple (a1, a2) is cut into size(a1)·size(a2)
    blocks, and this rank holds block rank(a1)·size(a2) + rank(a2) (the
    first axis major, as a JAX PartitionSpec lays them out). An axis this
    shard does not hold (size 1) leaves its dims whole.

    `gather_many` joins the blocks of several leaves into the whole
    leaves in rounds, one all-gather a round over one axis for every
    leaf that has a step on it (a tuple's last axis first), each leaf's
    bytes one span of the round's buffer: the whole leaves' bits are
    every rank's blocks, moved exactly, at one collective an axis for
    all of them. `counts` tallies the rounds (`all_gather`) and the
    bytes each brought from the other ranks (`bytes`)."""

    axes: Dict[str, AxisShard]
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_gather": 0, "bytes": 0},
        compare=False, repr=False)

    def split(self, spec) -> List[Tuple[int, Tuple[AxisShard, ...]]]:
        """[(dim, its AxisShards, major first)] of the dims `spec`
        splits over this shard's axes."""
        out = []
        for dim, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            shards = tuple(self.axes[a] for a in names if a in self.axes)
            if shards:
                out.append((dim, shards))
        return out

    def block(self, whole: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of a whole leaf (a view)."""
        for dim, shards in self.split(spec):
            parts = math.prod(s.size for s in shards)
            if whole.shape[dim] % parts:
                raise ValueError(f"dim {dim} of {tuple(whole.shape)} does "
                                 f"not split over {parts} ranks")
            index = 0
            for s in shards:
                index = index * s.size + s.rank
            n = whole.shape[dim] // parts
            whole = whole.narrow(dim, index * n, n)
        return whole

    def gather(self, block: torch.Tensor, spec) -> torch.Tensor:
        """The whole leaf from every rank's `block` (a collective: every
        rank of each axis calls it, in the same order)."""
        return self.gather_many([(block, spec)])[0]

    def gather_many(self, items) -> List[torch.Tensor]:
        """The whole leaves of [(block, spec)] `items` (a collective:
        every rank calls it with the same specs, in the same order). A
        round takes the first axis (in `axes`' order) that a leaf's next
        step is on; a leaf's steps are its dims', each dim's tuple last
        axis first."""
        parts = [block for block, _ in items]
        todo = [{dim: list(reversed(shards)) for dim, shards in
                 self.split(spec)} for _, spec in items]
        while any(q for t in todo for q in t.values()):
            shard = next(s for s in self.axes.values()
                         if any(q and q[0] is s for t in todo
                                for q in t.values()))
            batch = [(i, dim) for i, t in enumerate(todo)
                     for dim, q in t.items() if q and q[0] is shard]
            wholes = self._round(shard, [(parts[i], dim) for i, dim in batch])
            for (i, dim), whole in zip(batch, wholes):
                parts[i] = whole
                todo[i][dim].pop(0)
        return parts

    def _round(self, shard: AxisShard, pairs) -> List[torch.Tensor]:
        """One all-gather over `shard`'s group of every (tensor, dim) of
        `pairs`: their bytes in one buffer (each span padded to 16
        bytes), every rank's spans joined along each tensor's dim."""
        spans, offsets, at = [], [], 0
        for t, _ in pairs:
            raw = t.contiguous().view(torch.uint8).reshape(-1)
            pad = -raw.numel() % 16
            spans.append(torch.cat([raw, raw.new_zeros(pad)]) if pad
                         else raw)
            offsets.append(at)
            at += spans[-1].numel()
        got = all_gather_bits(torch.cat(spans), shard.group, 0).view(
            shard.size, at)
        out = []
        for (t, dim), first in zip(pairs, offsets):
            n = t.numel() * t.element_size()
            out.append(torch.cat([got[r, first:first + n].view(t.dtype)
                                  .view(t.shape)
                                  for r in range(shard.size)], dim))
            self.counts["bytes"] += (shard.size - 1) * n
        self.counts["all_gather"] += 1
        return out


def expert_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The process group of the mesh's expert axis (None without a
    process group): the ranks whose expert blocks make up every stack of
    one data (and sequence) shard and pipeline stage, in block order."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    return mesh.get_group("expert")


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """This rank's place on the expert axis: the axis's process group
    (None: this process alone, and a caller that sums the blocks' partial
    outputs itself), its position `rank` (its block of experts) and the
    axis's `size`. `writer`: this rank writes its blocks of a checkpoint
    (its coordinate on every other axis is 0, so each block is written
    once)."""

    group: Optional["torch.distributed.ProcessGroup"]
    rank: int
    size: int
    writer: bool = True

    def block(self, num_experts: int) -> Tuple[int, int]:
        """(first expert, experts) of this rank's block."""
        if num_experts % self.size:
            raise ValueError(f"{num_experts} experts do not divide over "
                             f"the expert mesh axis {self.size}")
        n = num_experts // self.size
        return self.rank * n, n


def expert_shard(mesh) -> Optional[ExpertShard]:
    """The mesh's ExpertShard for this rank; None when the expert axis is
    1 or there is no process group."""
    group = expert_group(mesh)
    if group is None or mesh_shape(mesh)["expert"] == 1:
        return None
    others = [a for a in mesh.mesh_dim_names if a != "expert"]
    return ExpertShard(group, mesh.get_local_rank("expert"),
                       mesh_shape(mesh)["expert"],
                       writer=all(mesh.get_local_rank(a) == 0
                                  for a in others))


@dataclasses.dataclass(frozen=True)
class SequenceShard:
    """This rank's place on the sequence axis: its ring's process group,
    its position (`rank`, which is also its sequence shard's index) and
    the ring's size. A rank holds positions [rank·s, (rank + 1)·s) of
    every sequence of s·size positions."""

    group: Optional["torch.distributed.ProcessGroup"]
    rank: int
    size: int

    def offset(self, local_len: int) -> int:
        """Global position of this shard's first position."""
        return self.rank * local_len


def sequence_shard(mesh) -> Optional[SequenceShard]:
    """The mesh's SequenceShard for this rank; None when the sequence
    axis is 1 or there is no process group."""
    group = sequence_group(mesh)
    if group is None or mesh_shape(mesh)["sequence"] == 1:
        return None
    return SequenceShard(group, torch.distributed.get_rank(group),
                         torch.distributed.get_world_size(group))


_ACTIVE_SEQUENCE: contextvars.ContextVar[Optional[SequenceShard]] = \
    contextvars.ContextVar("sequence_shard", default=None)


@contextlib.contextmanager
def sequence_parallel(shard: Optional[SequenceShard]) -> Iterator[None]:
    """Inside, `active_sequence()` is `shard` (None: no sequence axis)."""
    token = _ACTIVE_SEQUENCE.set(shard)
    try:
        yield
    finally:
        _ACTIVE_SEQUENCE.reset(token)


def active_sequence() -> Optional[SequenceShard]:
    """The sequence shard of the step being traced (the JAX package's
    `active_mesh()` sequence axis); None outside `sequence_parallel` or
    with a ring of one."""
    shard = _ACTIVE_SEQUENCE.get()
    return shard if shard is not None and shard.size > 1 else None


def forward_sequence(impl: str, sequence_impls) -> Optional[SequenceShard]:
    """A model forward's sequence axis (`active_sequence()`), which only
    the sequence-parallel attentions (`sequence_impls`) can run: any
    other attention would attend within the shard alone, so it raises."""
    seq = active_sequence()
    if seq is not None and impl not in sequence_impls:
        raise ValueError(
            f"attention {impl!r} runs no sequence axis (this forward holds "
            f"shard {seq.rank} of {seq.size}): use one of "
            f"{tuple(sequence_impls)}")
    return seq


def pipeline_group(mesh) -> Optional["torch.distributed.ProcessGroup"]:
    """The process group of the mesh's pipeline axis (None without a
    process group): the stages of one pipeline, in stage order."""
    if mesh is None or not torch.distributed.is_initialized():
        return None
    return mesh.get_group("pipeline")


@dataclasses.dataclass(frozen=True)
class PipelineShard:
    """This rank's place on the pipeline axis: the axis's process group
    (None: this process alone), its stage `rank`, the axis's `size`, the
    global ranks of the previous and next stages of its pipeline (None
    at the ends) and `writer`: this rank writes its stage's blocks of a
    checkpoint (its coordinate on every axis but pipeline and expert is
    0, so each block is written once)."""

    group: Optional["torch.distributed.ProcessGroup"]
    rank: int
    size: int
    prev: Optional[int] = None
    next: Optional[int] = None
    writer: bool = True

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


def pipeline_shard(mesh) -> Optional[PipelineShard]:
    """The mesh's PipelineShard for this rank; None when the pipeline
    axis is 1 or there is no process group. The neighbours are read off
    the DeviceMesh's layout (MESH_AXIS_ORDER): the ranks at pipeline
    coordinate ± 1 with every other coordinate this rank's."""
    group = pipeline_group(mesh)
    if group is None or mesh_shape(mesh)["pipeline"] == 1:
        return None
    names = list(mesh.mesh_dim_names)
    axis = names.index("pipeline")
    me = torch.distributed.get_rank()
    coord = [int(c) for c in (mesh.mesh == me).nonzero()[0]]
    size = mesh_shape(mesh)["pipeline"]

    def at(stage: int) -> Optional[int]:
        if not 0 <= stage < size:
            return None
        c = list(coord)
        c[axis] = stage
        return int(mesh.mesh[tuple(c)])

    stage = coord[axis]
    writer = all(c == 0 for i, c in enumerate(coord)
                 if names[i] not in ("pipeline", "expert"))
    return PipelineShard(group, stage, size, at(stage - 1), at(stage + 1),
                         writer)
