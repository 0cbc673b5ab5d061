"""Serving-mesh sharding (port of kubeflow_tpu/parallel/serving_mesh.py):
the decode engine's tensor × fsdp × expert layout.

The JAX engine runs its program family on one process's `tensor × fsdp
× expert` device mesh and lets XLA place the collectives; here the mesh
is a gang of processes, one a rank (parallel/distributed.py), and every
rank runs the same program on its shard (serving/relay.py keeps the
ranks in lockstep). The layout contract is the JAX package's, chosen so
that greedy output stays BIT FOR BIT the 1×1 engine's:

- **Weights at rest** are held as this rank's block by the training
  rules (training/annotations.py `logical_axes_for` → parallel/
  sharding.py `param_specs`): fsdp splits the embed dims, tensor the
  heads, mlp and vocab dims, and a dim the axes do not divide stays
  whole (GPT-2's 50,257-row vocabulary). Each module gathers its own
  leaves to whole at their use (models/layers.py `at_use`, over
  `MeshShard`), so every weight product runs on whole weights, as in the
  1×1 program; int8 leaves are gathered as int8 and dequantized after
  the gather, their per-channel scales held whole.
- **Expert stacks** (`…moe.wi|wo`) on an expert axis are held as their
  E/ep block on dim 0 (`expert_kernel_spec`) and never gathered: the
  routed layer runs its block and sums the partial outputs over the
  expert group (models/layers.py `MoeMlp`), exact under top-1 routing.
- **KV pools** are held by head shard under `tensor` (H at dim -2 of
  values and int8 scales alike) and whole under `fsdp` and `expert`: q,
  k and v are cut to the rank's heads (`HeadShard.local`), the page
  writes and the paged kernels run on the local heads, and the
  attention output is gathered on heads (`HeadShard.gather`) BEFORE the
  out projection, whose contraction is the heads dim: split, it would
  sum in another order. Everything after it is whole on every rank.

Collectives move bits exactly (each leaf travels as its bytes), so
every value computed from gathered ones is the unmeshed program's.
"""

from __future__ import annotations

import dataclasses
import math
from datetime import timedelta
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from kubeflow_tpu_torch.parallel.mesh import (
    MESH_AXIS_ORDER,
    AxisShard,
    ExpertShard,
    MeshShard,
    MeshSpec,
    all_gather_bits,
    axis_shard,
    build_mesh,
    mesh_shape,
)

# the mesh axis the KV pools (and the attention segment) split on: the
# heads dim of every pool leaf ([L, P, ps, H, D] values and [L, P, ps,
# H, 1] int8 scales alike: H sits at -2 in both)
POOL_HEAD_AXIS = "tensor"
# the mesh axis the MoE expert stacks split on: dim 0 of [E, D, F] wi /
# [E, F, D] wo, never gathered
MOE_EXPERT_AXIS = "expert"
# how long a rank of a serving gang waits for its peers in the relay
# (serving/relay.py: an idle rank 0 pings well inside it)
RELAY_TIMEOUT_S = 600.0


def expert_kernel_spec(ndim: int = 3) -> Tuple[Optional[str], ...]:
    """The spec of one expert-stack leaf: E at dim 0 on the expert axis,
    every other dim whole (its compute layout: never gathered)."""
    return (MOE_EXPERT_AXIS,) + (None,) * (ndim - 1)


def is_moe_expert_kernel_path(name: str) -> bool:
    """True for the MoE expert-stack leaves (`layers.<i>.moe.wi|wo`):
    the leaves the expert axis splits and the per-use gathering skips.
    The router follows the ordinary rules."""
    keys = name.split(".")
    return any(k == "moe" and nxt in ("wi", "wo")
               for k, nxt in zip(keys[:-1], keys[1:]))


def validate_serving_mesh(model_cfg, tensor: int, fsdp: int,
                          expert: int = 1, role: str = "model") -> None:
    """The divisibility contract (the JAX package's, message for
    message): tensor must divide the head count (the KV pools split on
    heads; there is no fallback for the engine's largest buffer) and the
    mlp dim; fsdp must divide the hidden dim. Any other weight dim (an
    odd vocabulary) stays whole, as training's rules leave it.

    expert > 1 needs an MoE model whose expert count it divides, with
    top-1 routing: a top-1 combine has at most one nonzero term an
    output element, so the sum over the expert group is exact in any
    order; a top-2 combine adds two nonzero terms in an order the shard
    boundary would change. A dense draft on an MoE target's mesh is
    fine: it has no expert stack and is whole over that axis."""
    t, f, e = int(tensor), int(fsdp), int(expert)
    for axis, v in (("tensor", t), ("fsdp", f), ("expert", e)):
        if v < 1:
            raise ValueError(f"serving mesh axes must be >= 1, got "
                             f"{axis}={v}")
    if t > 1:
        if model_cfg.num_heads % t:
            raise ValueError(
                f"serving mesh tensor={t} does not divide the {role}'s "
                f"num_heads={model_cfg.num_heads}: the KV pools shard "
                f"on the heads axis"
            )
        if model_cfg.mlp_dim % t:
            raise ValueError(
                f"serving mesh tensor={t} does not divide the {role}'s "
                f"mlp_dim={model_cfg.mlp_dim}"
            )
    if f > 1 and model_cfg.hidden_size % f:
        raise ValueError(
            f"serving mesh fsdp={f} does not divide the {role}'s "
            f"hidden_size={model_cfg.hidden_size}"
        )
    if e > 1:
        num_experts = int(getattr(model_cfg, "num_experts", 0) or 0)
        if num_experts == 0:
            if role == "model":
                raise ValueError(
                    f"serving mesh expert={e} requires a MoE model: the "
                    f"{role} has num_experts=0, so there is no expert "
                    f"stack to shard"
                )
        else:
            if num_experts % e:
                raise ValueError(
                    f"serving mesh expert={e} does not divide the "
                    f"{role}'s num_experts={num_experts}: each shard "
                    f"owns a contiguous E/ep block of the expert stack"
                )
            if int(getattr(model_cfg, "moe_top_k", 1)) != 1:
                raise ValueError(
                    f"serving mesh expert={e} requires top-1 routing "
                    f"(the {role} has moe_top_k={model_cfg.moe_top_k}): "
                    f"a top-k>1 combine sums k nonzero terms whose f32 "
                    f"reduction order the expert shard boundary would "
                    f"change; the bitwise parity contract only holds "
                    f"for top-1"
                )


def serving_leaf_specs(shapes: Mapping[str, Tuple[int, ...]],
                       tensor: int = 1, fsdp: int = 1, expert: int = 1
                       ) -> Dict[str, tuple]:
    """{leaf name: its spec on a `tensor × fsdp × expert` serving mesh}
    for whole leaf shapes (the JAX `param_shardings`' specs): the
    training rules at the mesh's sizes, the expert stacks pinned to
    `expert_kernel_spec` on an expert axis."""
    from kubeflow_tpu_torch.parallel.sharding import param_specs
    from kubeflow_tpu_torch.training.annotations import logical_axes_for

    sizes = {a: {"tensor": tensor, "fsdp": fsdp, "expert": expert}.get(a, 1)
             for a in MESH_AXIS_ORDER}
    meta = {name: torch.empty(shape, device="meta")
            for name, shape in shapes.items()}
    specs = param_specs(logical_axes_for(meta, fsdp_size=fsdp,
                                         mesh_axis_sizes=sizes), mesh=sizes)
    if expert > 1:
        specs = {name: (expert_kernel_spec(len(shapes[name]))
                        if is_moe_expert_kernel_path(name) else spec)
                 for name, spec in specs.items()}
    return specs


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """This rank's heads of the pools and of the attention segment: its
    block `rank` of `size` along the heads dim (dim -2) on the tensor
    axis. `counts`: the attention outputs gathered (`all_gather`)."""

    axis: AxisShard
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_gather": 0},
        compare=False, repr=False)

    @property
    def size(self) -> int:
        return self.axis.size

    def heads(self, num_heads: int) -> Tuple[int, int]:
        """(first head, heads) of this rank's block."""
        n = num_heads // self.size
        return self.axis.rank * n, n

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """x's heads of this rank (x's dim -2 is heads; contiguous)."""
        first, n = self.heads(x.shape[-2])
        return x.narrow(-2, first, n).contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's heads of x joined along dim -2 (a collective of
        the tensor group)."""
        out = all_gather_bits(x, self.axis.group, x.dim() - 2)
        self.counts["all_gather"] += 1
        return out


@dataclasses.dataclass
class ServingMesh:
    """One serving gang's `tensor × fsdp × expert` mesh as this rank
    sees it: the DeviceMesh over the gang (parallel/mesh.py axis order,
    data 1), this rank's `weights` shard (the fsdp and tensor axes a
    leaf's block follows), its `heads` (the tensor axis; None at tensor
    1), its `experts` (an ExpertShard of the expert axis; None at expert
    1), the `relay` group (gloo, whatever the gang's backend: the
    engine's host inputs travel on it, serving/relay.py) and the `device`
    this rank's blocks live on."""

    tensor: int
    fsdp: int
    expert: int
    device_mesh: object
    rank: int
    weights: MeshShard
    heads: Optional[HeadShard]
    experts: Optional[ExpertShard]
    relay: object
    device: torch.device

    @property
    def sizes(self) -> Dict[str, int]:
        return {"tensor": self.tensor, "fsdp": self.fsdp,
                "expert": self.expert}

    @property
    def leader(self) -> bool:
        """Rank 0: the engine's scheduler, HTTP server and host tier."""
        return self.rank == 0

    def shard_model(self, model: nn.Module) -> nn.Module:
        """Hold `model`'s leaves (parameters, and an int8 model's int8
        buffers; never its scales) as this rank's blocks on the mesh's
        device, in place, and return it. A leaf gathered at use records
        its spec on its module (`_mesh_specs`, read by models/layers.py
        `at_use`); an expert stack on an expert axis becomes its MoeMlp's
        E/ep block, with the ExpertShard the layer sums over. A model
        sharded already is returned as it is (a draft that is the
        target).

        `model` may live on the host (the serving entry points build it
        there): each block is cut there and only the block is copied to
        the device, so the card never holds a whole split leaf, and
        everything whole (leaves no axis divides, scales) follows it."""
        from kubeflow_tpu_torch.models.layers import (
            QSCALE,
            Dense,
            Embed,
            MoeMlp,
        )

        if getattr(model, "serving_mesh", None) is self:
            return model
        leaves = {name: t for name, t in model.state_dict(
            keep_vars=True).items() if not name.endswith(QSCALE)}
        specs = serving_leaf_specs({n: tuple(t.shape)
                                    for n, t in leaves.items()}, **self.sizes)
        with torch.no_grad():
            for name, leaf in leaves.items():
                owner, _, attr = name.rpartition(".")
                module = model.get_submodule(owner)
                if self.experts is not None and \
                        is_moe_expert_kernel_path(name):
                    if not isinstance(module, MoeMlp):
                        raise ValueError(f"{name} is not an expert stack")
                    first, n = self.experts.block(leaf.shape[0])
                    block = leaf.narrow(0, first, n)
                    module.expert, module.first = self.experts, first
                elif self.weights.split(specs[name]):
                    block = self.weights.block(leaf, specs[name])
                    module.__dict__.setdefault("_mesh_specs", {})[attr] = \
                        specs[name]
                    module.mesh_shard = self.weights
                    if leaf.is_floating_point() and isinstance(
                            module, (Dense, Embed, MoeMlp)):
                        # these uses cast the leaf to their compute dtype
                        # first: it crosses the mesh in that dtype
                        module.__dict__.setdefault("_mesh_wire", {})[
                            attr] = module.dtype
                else:
                    continue
                block = block.to(self.device, copy=True)
                if attr in module._parameters:
                    module._parameters[attr] = nn.Parameter(
                        block, requires_grad=False)
                else:
                    module._buffers[attr] = block
        model.to(self.device)
        # each transformer block gathers its own leaves at once
        # (models/layers.py `gathered`)
        for block_module in getattr(model, "layers", ()):
            block_module.__dict__["_mesh_unit"] = [
                (m, a) for m in block_module.modules()
                for a in m.__dict__.get("_mesh_specs", {})]
        model.serving_mesh = self
        return model


def resident_bytes(model: nn.Module) -> int:
    """Bytes of the weights a rank holds (parameters and buffers, the
    blocks where it holds blocks)."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def spec_bytes(shapes: Mapping[str, Tuple[int, ...]],
               itemsizes: Mapping[str, int], specs: Mapping[str, tuple],
               sizes: Mapping[str, int]) -> int:
    """The bytes a rank holds by the specs' formula: each leaf's bytes
    over the product of the sizes of the axes its spec names (the
    formula `resident_bytes` is checked against)."""
    total = 0
    for name, shape in shapes.items():
        parts = 1
        for entry in specs.get(name, ()):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            parts *= math.prod(sizes.get(a, 1) for a in names)
        total += math.prod(shape) * itemsizes[name] // parts
    return total


def build_serving_mesh(tensor: int, fsdp: int, expert: int = 1,
                       backend: Optional[str] = None, device=None
                       ) -> Optional[ServingMesh]:
    """The engine's mesh over the gang's ranks: `tensor × fsdp × expert`
    (data 1), which must be the gang's world size. 1×1×1 returns None:
    the unmeshed engine is the bitwise baseline and builds no mesh. A
    collective of the gang (every rank calls it, in the same order: the
    mesh's groups, then the relay's). `backend` is the gang's (default:
    its group's); `device` the engine's on this rank (default: the
    CPU)."""
    t, f, e = int(tensor), int(fsdp), int(expert)
    if t < 1 or f < 1 or e < 1:
        raise ValueError(
            f"serving mesh axes must be >= 1, got tensor={t} fsdp={f} "
            f"expert={e}"
        )
    need = t * f * e
    if need == 1:
        return None
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"serving mesh tensor={t} x fsdp={f} x expert={e} needs "
            f"{need} devices (a gang of {need} ranks, one a card), this "
            f"process's gang has {world}"
        )
    backend = backend or dist.get_backend()
    sizes = {"tensor": t, "fsdp": f, "expert": e}
    spec = MeshSpec(tuple((a, sizes.get(a, 1)) for a in MESH_AXIS_ORDER))
    dmesh = build_mesh(spec, device_type="cuda" if backend == "nccl"
                       else "cpu")
    relay = dist.new_group(backend="gloo",
                           timeout=timedelta(seconds=RELAY_TIMEOUT_S))
    axes = {a: s for a in ("fsdp", "tensor")
            if (s := axis_shard(dmesh, a)) is not None}
    heads = axes.get(POOL_HEAD_AXIS)
    experts = None
    if e > 1:
        experts = ExpertShard(dmesh.get_group("expert"),
                              dmesh.get_local_rank("expert"), e)
    assert mesh_shape(dmesh)["data"] == 1
    return ServingMesh(t, f, e, dmesh, dist.get_rank(), MeshShard(axes),
                       None if heads is None else HeadShard(heads), experts,
                       relay, torch.device(device or "cpu"))
