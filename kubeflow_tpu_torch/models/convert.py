"""Param bridge: flax param trees ↔ the port's state dicts (GPT, BERT,
ResNet, mlp).

`params_from_jax` takes the flax tree as nested dicts of numpy arrays (or
anything `np.asarray` reads), so nothing of JAX crosses into the port.
Both layouts the JAX package writes are accepted: named blocks
(`layer_<i>`) and the scan-stacked serving layout (`layers/block/...`
with a leading [L] axis, kubeflow_tpu/models/gpt.py
`stack_layer_params`). Kernel shapes carry over unchanged (DenseGeneral
q/k/v [D, H, Dh], out [H, Dh, D]); the port's modules use flax's names.
BERT has only the named layout (`layer_<i>/attention/...`, `ln_att`,
`mlp/{wi,wo}`, `ln_mlp`, and the top-level embeddings and heads).

The image models keep flax's names and shapes too (a conv kernel is
HWIO, a Dense kernel [in, out]; models/resnet.py permutes to torch's
layout at use), so the same name-for-name bridge carries them. Their
BatchNorm running averages are the flax `batch_stats` collection
(`.../mean`, `.../var`) and the port's buffers of those names:
`params_from_jax(params, batch_stats)` takes both trees, and
`is_batch_stat` tells the two apart in a `params_to_jax` result.

`quantized_params_from_jax` carries the JAX int8 envelope
(checkpointing/quantize.py `quantize_params_int8`) across with its int8
values and f32 scales unchanged.

The JAX pipelined models' layout (`PipelinedDecoder` / `PipelinedEncoder`)
stacks each stage's j-th layer on a leading [S] axis under
`decoder/stages/layer_<j>/...` (BERT: `encoder/stages/...`): stage s's
j-th layer is the port's `layers.<s·L/S + j>`. `params_from_jax` reads
it, `params_to_jax(sd, layout=StageLayout(...))` writes it, and
`StageLayout.path` names one leaf in it.

`load_jax_params` loads a flax tree into a model in place; a model
built for one expert-axis rank (models/layers.py `MoeMlp`'s `expert`)
keeps its block of each whole [E, ...] expert stack, a model built for
one fsdp or tensor rank (`fsdp=`, `tensor=`; models/layers.py
`shard_fsdp`, `shard_tensor`) its block of each fsdp or tensor leaf, and
a model built for one pipeline stage keeps its stage's layers (and the
model-level leaves its stage holds). `params_to_jax` of
`models/layers.py join_blocks` of every fsdp (or tensor) rank's state
dict is the whole tree again.

`params_to_jax` is the inverse of `params_from_jax`: a state dict → a
flat `{flax path: np.ndarray}` ('/'-joined, e.g.
`layer_0/attention/query/kernel`) in either layout, as the JAX package's
checkpoints key them (`jax_path` names one leaf in the named layout).
Leaves also come as torch tensors (a restored checkpoint's); any float
dtype becomes f32, as in `params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import (Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested tree; a '/'-joined key (the flat form
    `params_to_jax` returns) counts as its parts."""
    for key, sub in tree.items():
        sub_path = path + tuple(str(key).split("/"))
        if isinstance(sub, Mapping):
            yield from _leaves(sub, sub_path)
        else:
            yield sub_path, sub


def _as_array(leaf) -> np.ndarray:
    """int8 leaves stay int8; every float leaf becomes f32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        # numpy holds no bf16: a torch float leaf widens first (exact)
        leaf = (leaf if leaf.dtype == torch.int8 else leaf.float()).numpy()
    arr = np.asarray(leaf)
    return arr.copy() if arr.dtype == np.int8 else arr.astype(np.float32)


# the JAX pipelined models' stacked modules
STAGE_PREFIXES = ("decoder", "encoder")


@dataclasses.dataclass(frozen=True)
class StageLayout:
    """The JAX pipelined param layout: `<prefix>/stages/layer_<j>/...`
    leaves stacked [stages, ...], index s holding stage s's j-th layer
    (the port's `layers.<s·layers_per_stage + j>`)."""

    prefix: str
    stages: int
    layers_per_stage: int

    def path(self, name: str) -> Tuple[str, Optional[int]]:
        """(flax path, stage) of a state-dict name; the stage is None for
        a leaf outside the layers (`jax_path`'s)."""
        parts = name.split(".")
        if parts[0] != "layers":
            return jax_path(name), None
        i = int(parts[1])
        j, s = i % self.layers_per_stage, i // self.layers_per_stage
        return "/".join([self.prefix, "stages", f"layer_{j}"]
                        + parts[2:]), s


def _stage_layers(params: Mapping) -> int:
    """Layers a stage of a JAX pipelined tree (0: not pipelined)."""
    js = {path[2] for path, _ in _leaves(params)
          if len(path) > 2 and path[0] in STAGE_PREFIXES
          and path[1] == "stages"}
    return len(js)


def _port_entries(path: Sequence[str], arr: np.ndarray, num_layers: int,
                  stacked_axis: bool, per_stage: int = 0
                  ) -> Iterator[Tuple[str, np.ndarray]]:
    """The port's state-dict entries of one flax leaf: a scan-stacked
    leaf (`layers/block/...`) splits into one entry per layer — along
    its leading [L] axis, or, for a scale shared by every layer
    (`stacked_axis=False`), the same array in each; a stage-stacked leaf
    (`<prefix>/stages/layer_<j>/...`, `per_stage` layers a stage) into
    one entry per stage."""
    top = path[0]
    if top in STAGE_PREFIXES and len(path) > 2 and path[1] == "stages":
        j = int(path[2][len("layer_"):])
        rest = ".".join(path[3:])
        for st in range(arr.shape[0]):
            yield f"layers.{st * per_stage + j}.{rest}", arr[st]
    elif top == "layers":
        rest = ".".join(path[2:])  # path[1] is the scanned "block"
        for i in range(num_layers):
            yield f"layers.{i}.{rest}", arr[i] if stacked_axis else arr
    elif top.startswith("layer_"):
        yield f"layers.{top[len('layer_'):]}.{'.'.join(path[1:])}", arr
    else:
        yield ".".join(path), arr


def _num_layers(params: Mapping) -> int:
    tops = set()
    for path, leaf in _leaves(params):
        if path[0] == "layers":
            return np.shape(leaf)[0]
        tops.add(path[0])
    return sum(1 for t in tops if t.startswith("layer_"))


def _to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}


def params_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """flax params (GPT: named or scan-stacked layout; nested, or flat
    with '/'-joined paths) → state dict; with `batch_stats` (the flax
    collection of a BatchNorm model) its running averages join it as the
    port's buffers."""
    n = _num_layers(params)
    per = _stage_layers(params)
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in _leaves(params):
        flat.update(_port_entries(path, _as_array(leaf), n, stacked_axis=True,
                                  per_stage=per))
    for path, leaf in _leaves(batch_stats or {}):
        if path[-1] not in BATCH_STAT_LEAVES:
            raise ValueError(f"batch_stats leaf {'/'.join(path)} is not a "
                             f"running {BATCH_STAT_LEAVES}")
        flat[".".join(path)] = _as_array(leaf)
    return _to_state_dict(flat)


# the leaves of flax's `batch_stats` collection (BatchNorm's running
# averages): the port's BatchNorm buffers of the same names
BATCH_STAT_LEAVES = ("mean", "var")


def is_batch_stat(name: str) -> bool:
    """Is this state-dict name (or flax path) a BatchNorm running
    average?"""
    return name.replace("/", ".").rsplit(".", 1)[-1] in BATCH_STAT_LEAVES


def quantized_params_from_jax(qparams: Mapping) -> Dict[str, Any]:
    """A JAX int8 envelope {"qvalues": flax tree, "qscales": {keystr
    path: [out]}} (as numpy arrays) → the port's envelope keyed by
    state-dict name (checkpointing/quantize.py), values and scales
    unchanged. `qscales` keys are `jax.tree_util.keystr` paths such as
    "['layer_0']['attention']['query']['kernel']". In the scan-stacked
    layout one scale per channel covers every layer (the JAX quantizer
    reduces over the layer axis too): each layer's entry gets that same
    scale, never a re-derived per-layer one."""
    values = qparams["qvalues"]
    n = _num_layers(values)
    qscales: Dict[str, np.ndarray] = {}
    for key, scale in qparams["qscales"].items():
        path = tuple(re.findall(r"\['([^']*)'\]", key))
        qscales.update(_port_entries(path, _as_array(scale), n,
                                     stacked_axis=False))
    return {"qvalues": params_from_jax(values),
            "qscales": _to_state_dict(qscales)}


PARAM_LAYOUTS = ("named", "scan")
# the scan-stacked layout's module path: flax's nn.scan over `block`
# under `layers`, every leaf with a leading [L] axis
SCAN_BLOCK = "layers/block"


def jax_path(name: str) -> str:
    """The named-layout flax path of a state-dict name:
    'layers.0.attention.query.kernel' → 'layer_0/attention/query/kernel',
    'BottleneckBlock_0.Conv_0.kernel' → 'BottleneckBlock_0/Conv_0/kernel'."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    return "/".join(parts)


def params_to_jax(state_dict: Mapping[str, Any],
                  layout: Union[str, StageLayout] = "named"
                  ) -> Dict[str, np.ndarray]:
    """State dict → flat {flax path: np.ndarray}, f32 (int8 stays int8):
    the named layout (`layer_<i>/...`), the scan-stacked one
    (`layers/block/...`, every layer's leaf stacked on a leading [L]
    axis) or a `StageLayout` (the JAX pipelined tree). `params_from_jax`
    of the result gives `state_dict` back, bit for bit."""
    if isinstance(layout, StageLayout):
        stacked: Dict[str, Dict[int, np.ndarray]] = {}
        for n, v in state_dict.items():
            path, st = layout.path(n)
            stacked.setdefault(path, {})[st] = _as_array(v)
        return {path: (parts[None] if None in parts else
                       np.stack([parts[i] for i in range(layout.stages)]))
                for path, parts in stacked.items()}
    if layout not in PARAM_LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {PARAM_LAYOUTS}")
    named = {jax_path(n): _as_array(v) for n, v in state_dict.items()}
    if layout == "named":
        return named
    out: Dict[str, np.ndarray] = {}
    per_layer: Dict[str, Dict[int, np.ndarray]] = {}
    for path, arr in named.items():
        top, _, rest = path.partition("/")
        if top.startswith("layer_"):
            per_layer.setdefault(rest, {})[int(top[len("layer_"):])] = arr
        else:
            out[path] = arr
    for rest, layers in per_layer.items():
        out[f"{SCAN_BLOCK}/{rest}"] = np.stack(
            [layers[i] for i in range(len(layers))]
        )
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy flax params into `model` in place (strict: every name must
    match both ways). A model built for an expert block (`expert=`)
    takes its block of each whole [E, ...] stack, one built for an fsdp
    or a tensor rank (`fsdp=`, `tensor=`) its block of each fsdp or
    tensor leaf."""
    from kubeflow_tpu_torch.models.layers import held_blocks

    sd = held_blocks(model, params_from_jax(params))
    if getattr(model, "pipeline", None) is not None:
        # a pipeline stage takes its own leaves of the whole tree
        own = model.state_dict()
        sd = {k: v for k, v in sd.items() if k in own}
    model.load_state_dict(sd, strict=True)
