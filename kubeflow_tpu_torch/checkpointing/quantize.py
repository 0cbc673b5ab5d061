"""Per-channel int8 weight quantization, the `serving.quantize=int8`
dtype transform (port of kubeflow_tpu/checkpointing/quantize.py).

Granularity: symmetric per-OUTPUT-channel, one f32 scale per last-axis
column, for every floating leaf with ndim >= 2. The scale reduces over
every axis but the last, so a q/k/v kernel [D, H, Dh] gets a [Dh] scale,
the q/k/v biases [H, Dh] are quantized too, `out` [H, Dh, D] gets [D],
and both embedding tables and the head are quantized. 1-D leaves
(LayerNorm, the other biases) stay as they are.

Quantized params travel as one envelope keyed by state-dict name:

    {"qvalues": {<name>: int8 where quantized, else the leaf},
     "qscales": {<name>: f32 [out], ...}}

`quantization_accuracy` is the accuracy gate: logit max-abs-err and the
held-out next-token loss delta of the dequantized model against the
original (the JAX package pins 0.25 and 0.02).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

QUANT_TRANSFORMS = ("int8",)


def _eligible(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point() and leaf.dim() >= 2


def quantize_leaf_int8(w: torch.Tensor) -> tuple:
    """One weight leaf [..., out] → (int8 values, f32 scale [out]):
    scale = amax(|w[..., c]|) / 127, values rounded half to even against
    it (as jnp.round), clipped to ±127."""
    w32 = w.float()
    amax = w32.abs().amax(dim=tuple(range(w.dim() - 1)))
    # a device tensor divisor: torch turns a division by a Python scalar
    # into a multiply by its reciprocal on CUDA (not on the CPU), which
    # rounds ~5 % of the scales one ulp off the IEEE quotient
    scale = amax / amax.new_full((), 127.0)
    q = torch.round(w32 / torch.where(scale > 0.0, scale,
                                      torch.ones_like(scale)))
    return q.clamp(-127.0, 127.0).to(torch.int8), scale


def quantize_params_int8(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """State dict → envelope: every eligible leaf becomes int8 plus its
    per-channel scale under the same name; the rest rides through."""
    qvalues: Dict[str, torch.Tensor] = {}
    qscales: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        if _eligible(leaf):
            qvalues[name], qscales[name] = quantize_leaf_int8(leaf)
        else:
            qvalues[name] = leaf
    return {"qvalues": qvalues, "qscales": qscales}


def is_quantized_params(params) -> bool:
    """Recognize the quantized-params envelope."""
    return isinstance(params, Mapping) and set(params) == {"qvalues", "qscales"}


def dequantize_leaf(values: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """int8 values · f32 scale (broadcast over the last axis), one f32
    multiply rounded once into `dtype`."""
    return (values.float() * scale.float()).to(dtype)


def dequantize_params(qparams: Mapping[str, Any],
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Envelope → state dict in the compute dtype: quantized leaves are
    (int8 · scale) rounded once to `dtype`; the rest pass through
    bit-identical."""
    scales = qparams["qscales"]
    return {
        name: (dequantize_leaf(leaf, scales[name], dtype)
               if name in scales else leaf)
        for name, leaf in qparams["qvalues"].items()
    }


def pack_quantized_params(qparams: Mapping[str, Any]) -> Dict[str, Any]:
    """Envelope → per-leaf packed dict for dequantization at each use:
    every quantized leaf becomes {"qvalue": int8, "qscale": f32} under
    its name, every other leaf rides through. The module that owns a
    leaf holds both (models/gpt.py `int8_model`), gathers the int8 value
    whole on a serving mesh and dequantizes after the gather with
    `dequantize_leaf`: the same bits as the whole envelope's dequant,
    a quarter of an f32 leaf's bytes on the wire. The port holds every
    layer as its own module (`layers.<i>.…`), so no leaf is stacked and
    each scale stays the one per-channel vector of its leaf."""
    scales = qparams["qscales"]
    out: Dict[str, Any] = {}
    for name, leaf in qparams["qvalues"].items():
        s = scales.get(name)
        out[name] = leaf if s is None else {"qvalue": leaf, "qscale": s}
    return out


def apply_transform(params, transform: str):
    """"" / None is identity, "int8" the per-channel weight quantization
    above; unknown names raise rather than serve full width."""
    if not transform:
        return params
    if transform == "int8":
        return quantize_params_int8(params)
    raise ValueError(
        f"unknown checkpoint restore transform {transform!r} "
        f"(known: {QUANT_TRANSFORMS})"
    )


def quantization_accuracy(model: torch.nn.Module,
                          params: Mapping[str, torch.Tensor],
                          qparams: Mapping[str, Any],
                          ids: torch.Tensor) -> Dict[str, float]:
    """The int8 accuracy gate: run `model` over the held-out batch `ids`
    [B, S] with `params` and with the dequantized `qparams` (into the
    model's compute dtype) → {"logit_max_abs_err", "loss_delta"}: the
    largest absolute logit difference and the absolute difference of
    the mean next-token NLL."""
    deq = dequantize_params(qparams, model.cfg.dtype)
    with torch.inference_mode():
        ref = torch.func.functional_call(model, dict(params), (ids,))
        got = torch.func.functional_call(model, deq, (ids,))

    def nll(logits):
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        picked = torch.gather(logp, -1, ids[:, 1:, None].long())
        return -picked.mean()

    return {
        "logit_max_abs_err": (ref - got).abs().max().item(),
        "loss_delta": (nll(got) - nll(ref)).abs().item(),
    }
