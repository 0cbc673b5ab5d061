"""The port's TrainState ↔ the JAX package's checkpoint keys (the
training side of kubeflow_tpu/training/checkpoint.py; the manager
itself is checkpointing/manager.py).

A JAX train state of the transformer recipe (`optax.chain(
clip_by_global_norm, adamw)`) saves these manifest keys, named-layer
flax paths throughout:

    step                        () int32   updates done
    params/<flax path>          f32        the master weights
    opt_state/1/0/count         () int32   AdamW's update count
    opt_state/1/0/mu/<path>     f32        first moments
    opt_state/1/0/nu/<path>     f32        second moments
    opt_state/1/2/count         () int32   the schedule's count

and one of the convnet recipe (`optax.chain(add_decayed_weights, sgd(
schedule, momentum=0.9, nesterov=True))`, a BatchNorm model):

    step                                  () int32
    params/<flax path>                    f32
    extra_vars/batch_stats/<path>/mean    f32   running averages
    extra_vars/batch_stats/<path>/var     f32
    opt_state/1/0/trace/<path>            f32   the momentum trace
    opt_state/1/1/count                   () int32   the schedule's count

(`clip_by_global_norm`, `add_decayed_weights` and the chain's empty
states hold no leaves.) An MoE model's JAX state also carries the
`moe_stats` its init forward sowed, which its step never reads:

    extra_vars/moe_stats/<layer>/moe/expert_tokens  [E] f32
    extra_vars/moe_stats/<layer>/moe/dropped        () f32

The port saves zeros there, so the JAX trainer restores a port state,
and ignores them on restore. The port's state maps onto them BY NAME
(models/convert.py `jax_path`), never by the optimizer's index order:
AdamW's `exp_avg` is `mu`, `exp_avg_sq` is `nu`, and torch's
per-parameter `step` (a float tensor) is both counts; SGD's
`momentum_buffer` is `trace` (optax's trace from zeros and torch's first
buffer are both the first gradient), the state's step is the schedule's
count, and the model's BatchNorm buffers are `batch_stats`. Before its
first update torch has no optimizer state: such a state saves zero
moments (a zero trace) and count 0, as the JAX package does, and a
restore creates the optimizer state before loading it.

Under an expert mesh axis a rank holds only its block of each expert
stack (models/layers.py `MoeMlp`), and under an fsdp or a tensor axis
its block of each fsdp or tensor leaf along the leaf's dim
(models/layers.py `shard_fsdp`, `shard_tensor`): the
parameter and its two moments enter the tree as `ShardedLeaf`s with
their global index ranges, written by one rank a block (the block's rank
at every other coordinate 0; checkpointing/manager.py) and read back by
region, so the manifest names the whole leaf as a JAX state or a world-1
port state names it, and a checkpoint restores at any fsdp size.

A pipelined model (`pipeline_stages > 1`) saves the JAX pipelined
state's keys: each stage's j-th layer is index s of the stacked leaf
`params/<decoder|encoder>/stages/layer_<j>/...` [S, ...] (models/
convert.py `StageLayout`), and so are its moments; the JAX state carries
no `moe_stats` then. A model holding one pipeline stage enters its
layers and their moments as `ShardedLeaf` blocks [s:s+1] of the stacked
leaves (and of the expert axis's blocks for an expert stack), written by
the stage's rank at every other coordinate 0 (`PipelineShard.writer`);
a leaf of the embeddings or the heads is one whole-leaf block written
by its owning stage, and every other rank names it with an empty block
that writes and reads nothing, so every rank's tree has the same keys
in the same order (the manifest's leaf ids).

The tree holds the live tensors; the manager makes the host copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from kubeflow_tpu_torch.checkpointing.manager import ShardedLeaf, nest
from kubeflow_tpu_torch.models.convert import is_batch_stat, jax_path
from kubeflow_tpu_torch.models.layers import (
    held_block,
    held_leaves,
    sharded_stacks,
    stage_layout,
    whole_leaf_shape,
    whole_model,
)


def _get(tree: Dict[str, Any], path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _full(shape) -> Tuple[Tuple[int, int], ...]:
    return tuple((0, int(d)) for d in shape)


def _blocks(model: torch.nn.Module) -> Dict[str, Tuple]:
    """{parameter name: (whole shape, every block's index ranges, this
    rank's block, writer)} of the leaves `model` holds a block of: the
    expert stacks' blocks along dim 0, the fsdp and the tensor blocks
    along their dim (written by the rank at every other coordinate 0:
    on a tensor axis, data coordinate 0 of each tensor coordinate)."""
    out = {}
    for name, (module, leaf) in sharded_stacks(model).items():
        shape, shard = module.stack_shape(leaf), module.expert
        n = shape[0] // shard.size
        out[name] = (shape, [((r * n, (r + 1) * n),) + _full(shape[1:])
                             for r in range(shard.size)],
                     shard.rank, shard.writer)
    for name, (module, leaf, dim) in held_leaves(model).items():
        shape = whole_leaf_shape(module, leaf)
        shard = module.fsdp if leaf in module.__dict__.get(
            "_fsdp_dims", {}) else module.tensor
        n = shape[dim] // shard.size
        out[name] = (shape, [tuple((r * n, (r + 1) * n) if i == dim
                                   else (0, d) for i, d in enumerate(shape))
                             for r in range(shard.size)],
                     shard.rank, shard.writer)
    return out


def _leaf(blocks, name: str, t: torch.Tensor):
    """`t` (a parameter or a moment of parameter `name`), or its block of
    an expert stack or an fsdp leaf as a `ShardedLeaf`."""
    if name not in blocks:
        return t
    shape, regions, rank, writer = blocks[name]
    return ShardedLeaf(t, shape, regions[rank], regions, writer)


def _held(model: torch.nn.Module, name: str,
          value: torch.Tensor) -> torch.Tensor:
    """A restored value of parameter `name` (or of its moment) as the
    model holds it: a whole leaf's value cut to its block (a restore
    reads the block's region itself)."""
    p = model.get_parameter(name)
    if tuple(value.shape) == tuple(p.shape):
        return value
    owner, _, leaf = name.rpartition(".")
    return held_block(model.get_submodule(owner), leaf, value)


def _stage_tree(model: torch.nn.Module, layout,
                value: Callable[[str], torch.Tensor]) -> Dict[str, Any]:
    """{flax path: leaf} of one family of the model's tensors (`value`
    of a parameter name: the parameter or one of its moments) in the JAX
    pipelined layout, every path of the whole model in its order."""
    from kubeflow_tpu_torch.training.annotations import whole_shapes

    pipe, expert = model.pipeline, model.expert
    stacks = sharded_stacks(model)
    own = dict(model.named_parameters())
    per = layout.layers_per_stage
    stages = ([(pipe.rank, pipe.rank + 1)] if pipe is not None
              else [(0, layout.stages)])
    all_stages = ([(r, r + 1) for r in range(layout.stages)]
                  if pipe is not None else stages)
    stacked = stage_layout(model) is not None
    out: Dict[str, Any] = {}
    for name, shape in whole_shapes(whole_model(model)).items():
        path, st = layout.path(name)
        if path in out:
            continue
        if st is not None:  # a layer's leaf: stacked [S, ...]
            shape = (layout.stages,) + (shape[1:] if stacked else shape)
        else:  # a leaf of the embeddings or the heads
            if pipe is None:
                out[path] = value(name)
            elif name in own:
                out[path] = ShardedLeaf(
                    value(name), shape, _full(shape), [_full(shape)],
                    pipe.writer and (expert is None or expert.rank == 0))
            else:  # another stage's: an empty block, never written
                out[path] = ShardedLeaf(
                    torch.empty((0,) * len(shape)), shape,
                    ((0, 0),) * len(shape), [_full(shape)], False)
            continue
        j, rest = int(name.split(".")[1]) % per, name.split(".", 2)[2]
        names = [f"layers.{s * per + j}.{rest}"
                 for s in range(*stages[0])]
        local = (value(names[0]).unsqueeze(0) if len(names) == 1
                 else torch.stack([value(n) for n in names]))
        if pipe is None and names[0] not in stacks:
            out[path] = local
            continue
        inner = [_full(shape[1:])]
        if names[0] in stacks:  # an expert stack's block
            n = local.shape[1]
            inner = [((r * n, (r + 1) * n),) + _full(shape[2:])
                     for r in range(expert.size)]
            mine = inner[expert.rank]
            writer = pipe.writer if pipe is not None else expert.writer
        else:
            mine = inner[0]
            writer = pipe.writer and (expert is None or expert.rank == 0)
        out[path] = ShardedLeaf(local, shape, (stages[0],) + mine,
                                [(sr,) + r for sr in all_stages
                                 for r in inner], writer)
    return out


def _read(tree: Dict[str, Any], model: torch.nn.Module, layout,
          name: str) -> torch.Tensor:
    """Parameter `name`'s value in a restored tree of the model's
    layout: a pipelined layer's index of the stacked [S, ...] leaf, or
    the one-stage block [1, ...] a stage's tree reads."""
    if layout is None:
        return _get(tree, jax_path(name))
    path, st = layout.path(name)
    value = _get(tree, path)
    if st is None:
        return value
    return value[0] if model.pipeline is not None else value[st]


# `layout` default: the model's own (models/layers.py `stage_layout`)
_OWN = object()


def params_tree(model: torch.nn.Module, layout=_OWN) -> Dict[str, Any]:
    """The model's parameters as the nested flax tree (live tensors; an
    expert stack's block as a `ShardedLeaf`) in `layout`: the named one
    (None), or a `StageLayout` (a pipelined model's own: its layers
    stacked a stage)."""
    if layout is _OWN:
        layout = stage_layout(model)
    if layout is not None:
        own = dict(model.named_parameters())
        return nest(_stage_tree(model, layout, own.__getitem__))
    blocks = _blocks(model)
    return nest({jax_path(n): _leaf(blocks, n, p)
                 for n, p in model.named_parameters()})


def tree_layout(params: Dict[str, Any]):
    """The `StageLayout` of a nested params tree (None: the named
    layout); its `stages` is the stacked leaves' leading dim as read."""
    from kubeflow_tpu_torch.models.convert import STAGE_PREFIXES, StageLayout

    for prefix in STAGE_PREFIXES:
        stages = params.get(prefix, {}).get("stages")
        if stages:
            leaf = stages["layer_0"]
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            return StageLayout(prefix, int(leaf.shape[0]), len(stages))
    return None


def manifest_layout(entries: Dict[str, Any]):
    """The `StageLayout` of a checkpoint's params from its manifest
    entries ({key: entry with "shape"}), or None (named)."""
    from kubeflow_tpu_torch.models.convert import STAGE_PREFIXES, StageLayout

    found: Dict[str, Any] = {}
    for key, entry in entries.items():
        parts = key.split("/")
        if (len(parts) > 4 and parts[0] == "params"
                and parts[1] in STAGE_PREFIXES and parts[2] == "stages"):
            j = int(parts[3][len("layer_"):])
            found[parts[1]] = (max(found.get(parts[1], (-1, 0))[0], j),
                               int(entry["shape"][0]))
    for prefix, (last, stages) in found.items():
        return StageLayout(prefix, stages, last + 1)
    return None


def load_params_tree(model: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Copy a nested flax tree (either layout) into the model's
    parameters, in place (an expert-sharded or fsdp model takes its block
    of a whole leaf, a pipeline stage its layers)."""
    layout = tree_layout(tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_held(model, name, _read(tree, model, layout, name)))


def batch_stats_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's BatchNorm running averages as the nested flax
    `batch_stats` tree (live tensors; empty for a model without)."""
    return nest({jax_path(n): b for n, b in model.named_buffers()
                 if is_batch_stat(n)})


def moe_stats_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """Zeroed `moe_stats` leaves of each routed layer, in the JAX
    state's shapes (empty for a dense model, and for a pipelined one:
    the JAX pipeline sows none)."""
    from kubeflow_tpu_torch.models.layers import MoeMlp

    leaves = {}
    if stage_layout(model) is not None:
        return leaves
    for name, module in model.named_modules():
        if isinstance(module, MoeMlp):
            dev = module.router.device
            path = jax_path(name)
            leaves[f"{path}/expert_tokens"] = torch.zeros(
                module.num_experts, device=dev)
            leaves[f"{path}/dropped"] = torch.zeros((), device=dev)
    return nest(leaves)


def _is_sgd(state) -> bool:
    return isinstance(state.optimizer, torch.optim.SGD)


def _update_count(state) -> int:
    """torch's per-parameter step, one value for the whole state (0
    before the first update)."""
    steps = {float(s["step"]) for s in state.optimizer.state.values()
             if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"AdamW parameters disagree on their update count: "
                         f"{sorted(steps)}")
    return int(steps.pop()) if steps else 0


def train_state_tree(state, layout=_OWN) -> Dict[str, Any]:
    """The JAX manifest's tree of a port `TrainState` (live tensors), in
    the model's own param layout or `layout` (`params_tree`'s)."""
    if layout is _OWN:
        layout = stage_layout(state.model)
    opt = state.optimizer
    tree: Dict[str, Any] = {
        "step": torch.tensor(state.step, dtype=torch.int32),
        "params": params_tree(state.model, layout),
    }
    stats = batch_stats_tree(state.model)
    if stats:
        tree["extra_vars"] = {"batch_stats": stats}
    moe = moe_stats_tree(state.model) if layout is None else {}
    if moe:
        tree.setdefault("extra_vars", {})["moe_stats"] = moe
    if _is_sgd(state):
        trace, blocks = {}, _blocks(state.model)
        for name, p in state.model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            trace[jax_path(name)] = _leaf(blocks, name, buf if buf is not None
                                          else torch.zeros_like(p))
        tree["opt_state"] = {"1": {
            "0": {"trace": nest(trace)},
            "1": {"count": torch.tensor(state.step, dtype=torch.int32)},
        }}
        return tree
    mu, nu = {}, {}
    blocks = _blocks(state.model)
    own = dict(state.model.named_parameters())

    def moment(key):
        def get(name):
            st = opt.state.get(own[name], {})
            return st[key] if key in st else torch.zeros_like(own[name])
        return get

    if layout is not None:
        mu = _stage_tree(state.model, layout, moment("exp_avg"))
        nu = _stage_tree(state.model, layout, moment("exp_avg_sq"))
    for name, p in state.model.named_parameters():
        if layout is not None:
            break
        path = jax_path(name)
        mu[path] = _leaf(blocks, name, moment("exp_avg")(name))
        nu[path] = _leaf(blocks, name, moment("exp_avg_sq")(name))
    count = _update_count(state)
    tree["opt_state"] = {"1": {
        "0": {"count": torch.tensor(count, dtype=torch.int32),
              "mu": nest(mu), "nu": nest(nu)},
        "2": {"count": torch.tensor(count, dtype=torch.int32)},
    }}
    return tree


def restore_tree(state, entries: Dict[str, Any]) -> Dict[str, Any]:
    """The tree a restore reads into `state`, in the layout of the
    checkpoint whose manifest entries are `entries`: a pipelined
    checkpoint restores into a model without stages (its layers read off
    the stacked leaves), a named one into a pipeline stage; a pipelined
    model takes a pipelined checkpoint of its own stage count only."""
    layout, own = manifest_layout(entries), stage_layout(state.model)
    if layout is not None and own is not None and layout != own:
        raise ValueError(f"checkpoint layout {layout} does not fit the "
                         f"model's {own}")
    return train_state_tree(state, layout)


def load_train_state_tree(state, tree: Dict[str, Any]) -> None:
    """Load a restored tree into a port `TrainState` in place: the step,
    the parameters, the BatchNorm running averages, and the optimizer's
    state for every parameter (created here: AdamW's with the step
    torch's own AdamW would hold, SGD's momentum buffer from the trace).
    The tree is in either param layout (`tree_layout`)."""
    load_params_tree(state.model, tree["params"])
    with torch.no_grad():
        for name, b in state.model.named_buffers():
            if is_batch_stat(name):
                b.copy_(_get(tree["extra_vars"]["batch_stats"], jax_path(name)))
    opt = state.optimizer
    if _is_sgd(state):
        trace = tree["opt_state"]["1"]["0"]["trace"]
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                opt.state[p] = {"momentum_buffer": _held(
                    state.model, name, _get(trace, jax_path(name))).to(
                        p, copy=True)}
        state.step = int(tree["step"])
        return
    adam = tree["opt_state"]["1"]["0"]
    count = int(adam["count"])
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    layout = tree_layout(tree["params"])
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            group = groups[id(p)]
            on_device = group.get("capturable") or group.get("fused")
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": _held(state.model, name, _read(
                    adam["mu"], state.model, layout, name)).to(p, copy=True),
                "exp_avg_sq": _held(state.model, name, _read(
                    adam["nu"], state.model, layout, name)).to(p, copy=True),
            }
    state.step = int(tree["step"])
