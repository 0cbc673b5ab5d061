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

An encoder (BERT) train step (`encoder_train_flops`) counts the same
way (bench.py's `causal=False` convention): 6 × (the layers' matmul
parameters, the MLM transform and the MLM head) × tokens, plus
12·B·H·S²·D per layer for bidirectional attention (the full square).
The pooler and NSP head (one row a sequence) are not counted.

A routed (MoE) layer (`cfg.num_experts` E > 0) replaces the MLP's
2·D·F a token by the router's D·E a token and the expert products at
capacity: each routing group (a batch row) fills E·C expert slots
(C = `parallel/moe.py expert_capacity(S·k, E, capacity_factor)`), and
the batched products compute every slot, used or not, so a layer's
expert matmul parameters count 2·D·F per slot: 6 × 2·D·F × B·E·C a
step. The one-hot dispatch and combine contractions move data and are
not counted.

Under data and sequence parallelism a rank's count is the global
step's over the ranks (`rank_train_flops`): the analytic count at the
global batch and the GLOBAL sequence length (attention grows with S²,
so a shard's own S/n would undercount it n times) divided by data ×
sequence, as the JAX package divides its global program's count by the
chips. An expert axis of ep ranks splits each data shard's count ep
ways: a rank runs its E/ep share of the expert products (exactly 1/ep
of them: every expert computes all C slots of every row), and the dense
and attention work of its rows, which every expert rank of the shard
repeats, counts once over the ep of them, so the ranks' counts still sum
to the global step's. A pipeline axis of S stages splits it by layers: a
stage counts its L/S layers' work on its data shard's tokens, and the
last stage also the head, so the stages' counts sum to the shard's.

Recomputation under remat is NOT counted (it is work the model does not
need), and neither are embeddings, layernorms, softmax or the optimizer.
Other models (ResNet, the mlp) take the count of
`torch.utils.flop_counter.FlopCounterMode` over one forward and backward
of the task's loss at the step's shapes, on a meta-device twin of the
model (training/trainer.py `Trainer.step_flops`): the convolutions and
matmuls, as XLA's cost model counts them.

The denominator is the card's published dense bf16 peak (the JAX
package's convention: the per-chip peak whatever the step's dtype), from
`KFT_PEAK_FLOPS_PER_CHIP` or, on an H100, `H100_PEAK_OPS`. Another
device has no MFU (None): no denominator is made up. `chip_smoke.py`
takes its kernel bounds from the same H100 figures.
"""

from __future__ import annotations

import dataclasses
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


def _mlp_train_flops(cfg, batch: int, seq: int) -> float:
    """One layer's MLP FLOPs a train step: 6 × 2·D·F a token, or for a
    routed layer 6 × D·E a token (the router) plus 6 × 2·D·F a slot over
    the B·E·C slots the batched expert products compute."""
    d, f = cfg.hidden_size, cfg.mlp_dim
    e = getattr(cfg, "num_experts", 0)
    if e <= 0:
        return 6.0 * 2 * d * f * batch * seq
    from kubeflow_tpu_torch.parallel.moe import expert_capacity

    c = expert_capacity(seq * cfg.moe_top_k, e, cfg.expert_capacity_factor)
    return 6.0 * (d * e * batch * seq + 2 * d * f * batch * e * c)


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of a GPT config over batch × seq
    tokens (the module docstring's count)."""
    d, v = cfg.hidden_size, cfg.vocab_size
    per_layer = 4 * d * d  # q, k, v, out
    matmul_params = cfg.num_layers * per_layer + d * v  # + the LM head
    tokens = batch * seq
    attention = 6 * batch * cfg.num_heads * seq * seq * cfg.head_dim
    return (6.0 * matmul_params * tokens
            + cfg.num_layers * (attention + _mlp_train_flops(cfg, batch, seq)))


def encoder_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of a BERT config over batch × seq
    tokens (the module docstring's count)."""
    d, v = cfg.hidden_size, cfg.vocab_size
    per_layer = 4 * d * d  # query, key, value, out
    matmul_params = cfg.num_layers * per_layer + d * d + d * v  # + MLM head
    attention = 12 * batch * cfg.num_heads * seq * seq * cfg.head_dim
    return (6.0 * matmul_params * batch * seq
            + cfg.num_layers * (attention + _mlp_train_flops(cfg, batch, seq)))


def rank_train_flops(count, cfg, local_batch: int, local_seq: int,
                     data: int = 1, sequence: int = 1,
                     expert: int = 1, stage: Optional[int] = None,
                     stages: int = 1, fsdp: int = 1,
                     tensor: int = 1) -> float:
    """One rank's share of a train step's model FLOPs: `count`
    (`lm_train_flops` or `encoder_train_flops`) of the global step, the
    rank's local_batch × local_seq tokens scaled by the batch's axes
    (data × fsdp) and the sequence axis, over data × fsdp × sequence ×
    expert. An fsdp rank computes its own rows through whole (gathered)
    leaves, so it counts as a data rank does. Without a sequence
    axis the count is linear in the batch, so a rank's is its own rows'
    over the expert axis (its E/ep share of the expert products, and the
    rows' dense work split over the expert ranks that repeat it). As
    pipeline `stage` of `stages` (no sequence axis with it) a rank counts
    its cfg.num_layers / stages layers, and the head on the last stage.
    The tensor ranks of a data shard split its rows' work (their heads,
    MLP columns and vocab): a rank counts 1/tensor of it, so the ranks'
    counts sum to world 1's."""
    if stages > 1:
        def at(layers: int) -> float:
            part = dataclasses.replace(cfg, num_layers=layers,
                                       pipeline_stages=1)
            return count(part, local_batch, local_seq) / expert

        head = at(0)
        layers = at(cfg.num_layers // stages) - head
        return layers + (head if stage == stages - 1 else 0.0)
    if sequence == 1:
        return count(cfg, local_batch, local_seq) / (expert * tensor)
    rows = data * fsdp
    return (count(cfg, local_batch * rows, local_seq * sequence)
            / (rows * sequence * expert * tensor))


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
