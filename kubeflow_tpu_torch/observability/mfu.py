"""MFU / goodput accounting (port of kubeflow_tpu/observability/mfu.py).

Model-FLOPs utilization is achieved model FLOP/s over the card's peak.
The JAX package takes its numerator from XLA's cost model over the
compiled step; eager PyTorch has no such program, so the numerator here
is the analytic model-FLOPs count of a decoder-only LM train step
(`lm_train_flops`):

- 6 × (matmul parameters, the LM head included) × tokens: forward (2)
  and backward (4) of every weight matmul;
- plus 6·B·H·S²·D per layer for causal attention: QKᵀ and PV are
  4·B·H·S²·D forward over the full square, half of it under the causal
  mask, and the backward is twice the forward.

Recomputation under remat is NOT counted (it is work the model does not
need), and neither are embeddings, layernorms, softmax or the optimizer.

The denominator is the card's published dense bf16 peak (the JAX
package's convention: the per-chip peak whatever the step's dtype), from
`KFT_PEAK_FLOPS_PER_CHIP` or, on an H100, `H100_PEAK_OPS`. Another
device has no MFU (None): no denominator is made up. `chip_smoke.py`
takes its kernel bounds from the same H100 figures.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_PEAK_FLOPS = "KFT_PEAK_FLOPS_PER_CHIP"

# H100 SXM peaks (NVIDIA data sheet): dense ops/s by type, HBM bytes/s
H100_PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12


def peak_flops_per_chip(device=None) -> Optional[float]:
    """The MFU denominator: env override, else the spec table for the
    CUDA device's name; None on the CPU or an unlisted card."""
    raw = os.environ.get(ENV_PEAK_FLOPS, "").strip()
    if raw:
        return float(raw)
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if "H100" not in torch.cuda.get_device_name(dev):
        return None
    return H100_PEAK_OPS["bfloat16"]


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of a GPT config over batch × seq
    tokens (the module docstring's count)."""
    d, f, v = cfg.hidden_size, cfg.mlp_dim, cfg.vocab_size
    per_layer = 4 * d * d + 2 * d * f  # q, k, v, out + mlp_wi, mlp_wo
    matmul_params = cfg.num_layers * per_layer + d * v  # + the LM head
    tokens = batch * seq
    attention = 6 * batch * cfg.num_heads * seq * seq * cfg.head_dim
    return 6.0 * matmul_params * tokens + cfg.num_layers * attention


def mfu(flops_per_step: Optional[float], step_time_s: float,
        peak: Optional[float]) -> Optional[float]:
    """flops/step over wall time over `peak` (`peak_flops_per_chip` of the
    step's device); None when either side is unknown (the gauge is not
    set — never a fabricated 0)."""
    if not flops_per_step or step_time_s <= 0 or not peak:
        return None
    return flops_per_step / step_time_s / peak


def goodput(window_s: float, overhead_s: float) -> float:
    """Fraction of the training wall window not spent on host-side
    overheads (input wait): 1.0 = every wall second fed the device."""
    if window_s <= 0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - overhead_s / window_s))
