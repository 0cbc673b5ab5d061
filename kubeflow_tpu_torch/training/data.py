"""Input pipeline (port of the synthetic-LM part of
kubeflow_tpu/training/data.py).

`SyntheticData.batch_at(step)` is the JAX package's numpy stream, bit for
bit: a run of the port and a run of the JAX trainer fed from `batch_at`
see identical batches. `to_device` moves a numpy batch onto the training
device: through pinned host memory with a non-blocking copy on the card,
a plain tensor on the CPU.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SyntheticData:
    """Deterministic synthetic causal-LM batches (task "lm"); the image
    and MLM streams wait for their models (ROADMAP A13 item 6)."""

    def __init__(self, task: str, global_batch_size: int, seed: int = 0,
                 seq_len: int = 128, vocab_size: int = 30522):
        if task != "lm":
            raise ValueError(
                f"synthetic task {task!r} is not ported yet (only 'lm'; "
                f"ROADMAP A13 item 6)"
            )
        self.task = task
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        b = self.global_batch_size
        # causal LM: next-token prediction over the full sequence
        ids = rng.integers(0, self.vocab_size, (b, self.seq_len), dtype=np.int32)
        return {
            "input_ids": ids,
            "attention_mask": np.ones((b, self.seq_len), dtype=np.int32),
        }


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → int64 tensors on `device`. On the card each array
    goes through pinned memory with a non-blocking copy (the caching host
    allocator keeps the pinned block until the copy has run), so the host
    returns at once."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
