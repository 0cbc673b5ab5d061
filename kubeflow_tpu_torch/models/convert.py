"""Param bridge: flax GPT param trees → the port's state dicts.

`params_from_jax` takes the flax tree as nested dicts of numpy arrays (or
anything `np.asarray` reads), so nothing of JAX crosses into the port.
Both layouts the JAX package writes are accepted: named blocks
(`layer_<i>`) and the scan-stacked serving layout (`layers/block/...`
with a leading [L] axis, kubeflow_tpu/models/gpt.py
`stack_layer_params`). Kernel shapes carry over unchanged (DenseGeneral
q/k/v [D, H, Dh], out [H, Dh, D]); the port's modules use flax's names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            _flatten(sub, name + ".", out)
        else:
            out[name] = np.array(sub, dtype=np.float32)


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax GPT params (named or scan-stacked layout) → state dict."""
    flat: Dict[str, np.ndarray] = {}
    for key, sub in params.items():
        if key == "layers":
            stacked: Dict[str, np.ndarray] = {}
            _flatten(sub["block"], "", stacked)
            num_layers = next(iter(stacked.values())).shape[0]
            for i in range(num_layers):
                for name, arr in stacked.items():
                    flat[f"layers.{i}.{name}"] = arr[i]
        elif key.startswith("layer_"):
            _flatten(sub, f"layers.{key[len('layer_'):]}.", flat)
        else:
            _flatten(sub, f"{key}.", flat)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}


def load_jax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy flax params into `model` in place (strict: every name must
    match both ways)."""
    model.load_state_dict(params_from_jax(params), strict=True)
