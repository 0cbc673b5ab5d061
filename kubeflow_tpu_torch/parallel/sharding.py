"""Logical-axis sharding rules (port of kubeflow_tpu/parallel/sharding.py).

Models annotate arrays with logical axis names ("batch", "embed",
"heads", ...) and one rules table maps them to mesh axes, so a change of
parallelism strategy is a change of the table. The table is the JAX
package's, verbatim. A spec here is the tuple of mesh axes a
`PartitionSpec` holds (None = replicated on that dim), with the same
size-1 filtering and trailing-None trim, so the two packages' specs
compare equal as tuples.

There is no GSPMD in eager PyTorch: `shard_constraint` is a no-op that
returns its input. The data axis's collectives are issued by the
training step itself (training/trainer.py); the spec tables say which
leaves an fsdp or a tensor rank holds a block of, and along which dim
(`fsdp_dim`, `axis_dim`), which an expert rank holds a block of
("expert") and, through a pipelined model's leading "stage" axis (→
`pipeline`), which stage holds a layer (training/annotations.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated).
# The default table implements DP+FSDP+TP+SP+EP simultaneously; size-1 mesh
# axes make the corresponding sharding a no-op, so one table serves every
# strategy mix.
LOGICAL_RULES: Dict[str, Union[None, str, Tuple[str, ...]]] = {
    # activations
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "kv_seq": None,            # KV length stays whole except in ring attention
    "act_embed": None,
    "act_mlp": "tensor",
    "act_heads": "tensor",
    "act_expert": "expert",
    # params
    "embed": "fsdp",           # FSDP shards the embed dim of weights
    "mlp": "tensor",
    "heads": "tensor",
    "kv": None,
    "vocab": "tensor",
    # lookup-table vocab dim: tensor-parallel AND fsdp-sharded (hidden dim
    # whole) — vocab-sharded gathers partition cleanly; hidden-sharded
    # tables force replicate-then-reshard (training/annotations.py)
    "vocab_table": ("tensor", "fsdp"),
    "stage": "pipeline",
    "expert": "expert",
    # conv/vision
    "conv_in": None,
    "conv_out": "tensor",
    "spatial": None,
}


def _mesh_sizes(mesh) -> Optional[Mapping[str, int]]:
    """{axis: size} of a DeviceMesh or a plain mapping (None passes)."""
    if mesh is None or isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Dict[str, Union[None, str, Tuple[str, ...]]]] = None,
    mesh=None,
) -> Spec:
    """Map a tuple of logical axis names (None = replicated) to the mesh
    axes of each dim, as a PartitionSpec's tuple.

    If `mesh` (a DeviceMesh, or a mapping axis → size) is given, mesh axes
    absent from it (or of size 1) are dropped — so the same logical
    annotations work on any mesh shape.
    """
    table = LOGICAL_RULES if rules is None else rules
    sizes = _mesh_sizes(mesh)
    out = []
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        target = table.get(name, None)
        if target is None:
            out.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        if sizes is not None:
            axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    # Trim trailing Nones: P() semantics are identical and specs print cleaner.
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard_constraint(x, logical_axes: Sequence[Optional[str]], mesh=None,
                     rules=None):
    """The JAX `with_sharding_constraint` by logical names. Eager PyTorch
    has no compiler to take the hint: returns `x` unchanged."""
    return x


def is_replicated(spec: Spec) -> bool:
    """No dim of the spec is split over a mesh axis."""
    return all(a is None for a in spec)


def param_specs(annotations: Mapping[str, Tuple[Optional[str], ...]],
                mesh=None) -> Dict[str, Spec]:
    """{leaf name: logical axes} → {leaf name: spec}."""
    return {k: logical_to_spec(ax, mesh=mesh) for k, ax in annotations.items()}


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim a spec splits over mesh axis `axis` (alone, or with other
    axes in a tuple), or None when it names no `axis`."""
    for i, axes in enumerate(spec):
        if axes == axis or (isinstance(axes, tuple) and axis in axes):
            return i
    return None


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the fsdp mesh axis (alone, or with
    other axes in a tuple), or None when it names no fsdp."""
    return axis_dim(spec, "fsdp")
