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
stack (models/layers.py `MoeMlp`): the stack's parameter and its two
moments enter the tree as `ShardedLeaf`s with their global index ranges,
written by one rank a block (checkpointing/manager.py) and read back by
region, so the manifest names the whole [E, ...] leaf as a JAX state or
a world-1 port state names it.

The tree holds the live tensors; the manager makes the host copy.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from kubeflow_tpu_torch.checkpointing.manager import ShardedLeaf, nest
from kubeflow_tpu_torch.models.convert import is_batch_stat, jax_path
from kubeflow_tpu_torch.models.layers import sharded_stacks


def _get(tree: Dict[str, Any], path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _leaf(stacks, name: str, t: torch.Tensor):
    """`t` (a parameter or a moment of parameter `name`), or its block of
    an expert stack as a `ShardedLeaf`."""
    if name not in stacks:
        return t
    module, leaf = stacks[name]
    shape = module.stack_shape(leaf)
    n, rest = t.shape[0], tuple((0, d) for d in shape[1:])
    regions = [((r * n, (r + 1) * n),) + rest
               for r in range(module.expert.size)]
    return ShardedLeaf(t, shape, regions[module.expert.rank], regions,
                       module.expert.writer)


def params_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as the nested flax tree (live tensors; an
    expert stack's block as a `ShardedLeaf`)."""
    stacks = sharded_stacks(model)
    return nest({jax_path(n): _leaf(stacks, n, p)
                 for n, p in model.named_parameters()})


def load_params_tree(model: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Copy a nested flax tree into the model's parameters, in place (an
    expert-sharded model takes its block of a whole stack)."""
    stacks = sharded_stacks(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            value = _get(tree, jax_path(name))
            if name in stacks and tuple(value.shape) != tuple(p.shape):
                module, leaf = stacks[name]
                value = module.block_of(leaf, value)
            p.copy_(value)


def batch_stats_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's BatchNorm running averages as the nested flax
    `batch_stats` tree (live tensors; empty for a model without)."""
    return nest({jax_path(n): b for n, b in model.named_buffers()
                 if is_batch_stat(n)})


def moe_stats_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """Zeroed `moe_stats` leaves of each routed layer, in the JAX
    state's shapes (empty for a dense model)."""
    from kubeflow_tpu_torch.models.layers import MoeMlp

    leaves = {}
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


def train_state_tree(state) -> Dict[str, Any]:
    """The JAX manifest's tree of a port `TrainState` (live tensors)."""
    opt = state.optimizer
    tree: Dict[str, Any] = {
        "step": torch.tensor(state.step, dtype=torch.int32),
        "params": params_tree(state.model),
    }
    stats = batch_stats_tree(state.model)
    if stats:
        tree["extra_vars"] = {"batch_stats": stats}
    moe = moe_stats_tree(state.model)
    if moe:
        tree.setdefault("extra_vars", {})["moe_stats"] = moe
    if _is_sgd(state):
        trace = {}
        for name, p in state.model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            trace[jax_path(name)] = buf if buf is not None else torch.zeros_like(p)
        tree["opt_state"] = {"1": {
            "0": {"trace": nest(trace)},
            "1": {"count": torch.tensor(state.step, dtype=torch.int32)},
        }}
        return tree
    mu, nu = {}, {}
    stacks = sharded_stacks(state.model)
    for name, p in state.model.named_parameters():
        st = opt.state.get(p, {})
        path = jax_path(name)
        mu[path] = _leaf(stacks, name, st["exp_avg"] if "exp_avg" in st
                         else torch.zeros_like(p))
        nu[path] = _leaf(stacks, name, st["exp_avg_sq"] if "exp_avg_sq" in st
                         else torch.zeros_like(p))
    count = _update_count(state)
    tree["opt_state"] = {"1": {
        "0": {"count": torch.tensor(count, dtype=torch.int32),
              "mu": nest(mu), "nu": nest(nu)},
        "2": {"count": torch.tensor(count, dtype=torch.int32)},
    }}
    return tree


def load_train_state_tree(state, tree: Dict[str, Any]) -> None:
    """Load a restored tree into a port `TrainState` in place: the step,
    the parameters, the BatchNorm running averages, and the optimizer's
    state for every parameter (created here: AdamW's with the step
    torch's own AdamW would hold, SGD's momentum buffer from the trace)."""
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
                opt.state[p] = {"momentum_buffer": _get(
                    trace, jax_path(name)).to(p, copy=True)}
        state.step = int(tree["step"])
        return
    adam = tree["opt_state"]["1"]["0"]
    count = int(adam["count"])
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            group = groups[id(p)]
            on_device = group.get("capturable") or group.get("fused")
            path = jax_path(name)
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": _get(adam["mu"], path).to(p, copy=True),
                "exp_avg_sq": _get(adam["nu"], path).to(p, copy=True),
            }
    state.step = int(tree["step"])
