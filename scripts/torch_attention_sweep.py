#!/usr/bin/env python3
"""Flash against dense attention on the card, forward and backward, at
BERT-shaped inputs [batch, S, 12, 64] bf16 (port of bench.py's
`bench_attention_sweep`): the crossover table behind the port's
`attention_impl="auto"` (kubeflow_tpu_torch/ops/attention.py).

    python3 scripts/torch_attention_sweep.py [--batch 1] [--lens 512,...]

For each S, bidirectional and causal, each of `flash_attention` (the
hand-written CUDA kernels) and `dense_attention` (the plain product,
masked softmax and product) takes q, k, v → the gradient of the f32 sum
of its output with respect to q, k and v. A variant's time is the median
over CUDA events of single fwd+bwd calls after a warm-up; its peak is
`max_memory_allocated` over one call beyond the inputs. A variant that
runs out of device memory reads null, with the error's name: that null is
the datapoint (only flash is feasible there). Prints the card's name and
power limit, one line per S, and the table as one JSON line. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HEADS, HEAD_DIM = 12, 64
LENS = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def fwd_bwd(torch, impl, q, k, v):
    out = impl(q, k, v)
    return torch.autograd.grad(out.float().sum(), (q, k, v))


def time_variant(torch, impl, q, k, v, iters):
    """(median ms, peak bytes over the inputs) of one fwd+bwd call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd(torch, impl, q, k, v)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    fwd_bwd(torch, impl, q, k, v)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fwd_bwd(torch, impl, q, k, v)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), peak


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lens", default=",".join(str(s) for s in LENS))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_sweep: no CUDA device", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.ops.attention import dense_attention
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi} | torch {torch.__version__}", flush=True)
    bf16 = torch.bfloat16
    variants = {
        "flash": lambda q, k, v: flash_attention(q, k, v),
        "dense": lambda q, k, v: dense_attention(q, k, v, dtype=bf16),
        "flash_causal": lambda q, k, v: flash_attention(q, k, v, causal=True),
        "dense_causal": lambda q, k, v: dense_attention(q, k, v, dtype=bf16,
                                                        causal=True),
    }
    b = args.batch
    rows = {}
    for s in (int(x) for x in args.lens.split(",")):
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v = (torch.randn((b, s, HEADS, HEAD_DIM), generator=g,
                               device="cuda", dtype=bf16).requires_grad_()
                   for _ in range(3))
        row = {}
        for name, impl in variants.items():
            try:
                ms, peak = time_variant(torch, impl, q, k, v,
                                        iters=20 if s <= 4096 else 6)
                row[f"{name}_ms"], row[f"{name}_peak_bytes"] = ms, peak
            except torch.cuda.OutOfMemoryError as e:
                row[f"{name}_ms"] = None
                row[f"{name}_error"] = type(e).__name__
            torch.cuda.empty_cache()
        for pre in ("", "_causal"):
            f, d = row.get(f"flash{pre}_ms"), row.get(f"dense{pre}_ms")
            if f and d:
                row[f"flash{pre}_speedup"] = d / f
        rows[str(s)] = row
        print(f"S={s} B={b}: {json.dumps(row)}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    result = {"device": smi, "batch": b, "heads": HEADS, "head_dim": HEAD_DIM,
              "dtype": "bfloat16", "rows": rows}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
