"""Param bridge: flax GPT param trees → the port's state dicts.

`params_from_jax` takes the flax tree as nested dicts of numpy arrays (or
anything `np.asarray` reads), so nothing of JAX crosses into the port.
Both layouts the JAX package writes are accepted: named blocks
(`layer_<i>`) and the scan-stacked serving layout (`layers/block/...`
with a leading [L] axis, kubeflow_tpu/models/gpt.py
`stack_layer_params`). Kernel shapes carry over unchanged (DenseGeneral
q/k/v [D, H, Dh], out [H, Dh, D]); the port's modules use flax's names.

`quantized_params_from_jax` carries the JAX int8 envelope
(checkpointing/quantize.py `quantize_params_int8`) across with its int8
values and f32 scales unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path + (str(key),))
        else:
            yield path + (str(key),), sub


def _as_array(leaf) -> np.ndarray:
    """int8 leaves stay int8; every float leaf becomes f32."""
    arr = np.asarray(leaf)
    return arr.copy() if arr.dtype == np.int8 else arr.astype(np.float32)


def _port_entries(path: Sequence[str], arr: np.ndarray, num_layers: int,
                  stacked_axis: bool) -> Iterator[Tuple[str, np.ndarray]]:
    """The port's state-dict entries of one flax leaf: a scan-stacked
    leaf (`layers/block/...`) splits into one entry per layer — along
    its leading [L] axis, or, for a scale shared by every layer
    (`stacked_axis=False`), the same array in each."""
    top = path[0]
    if top == "layers":
        rest = ".".join(path[2:])  # path[1] is the scanned "block"
        for i in range(num_layers):
            yield f"layers.{i}.{rest}", arr[i] if stacked_axis else arr
    elif top.startswith("layer_"):
        yield f"layers.{top[len('layer_'):]}.{'.'.join(path[1:])}", arr
    else:
        yield ".".join(path), arr


def _num_layers(params: Mapping) -> int:
    if "layers" in params:
        return next(_leaves(params["layers"]))[1].shape[0]
    return sum(1 for k in params if str(k).startswith("layer_"))


def _to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax GPT params (named or scan-stacked layout) → state dict."""
    n = _num_layers(params)
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in _leaves(params):
        flat.update(_port_entries(path, _as_array(leaf), n, stacked_axis=True))
    return _to_state_dict(flat)


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


def load_jax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy flax params into `model` in place (strict: every name must
    match both ways)."""
    model.load_state_dict(params_from_jax(params), strict=True)
