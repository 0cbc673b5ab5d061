"""Input pipeline (port of kubeflow_tpu/training/data.py): the synthetic
streams and the host→device copy.

`SyntheticData.batch_at(step)` is the JAX package's numpy stream, bit for
bit, for the causal-LM ("lm"), masked-LM ("mlm") and image ("image")
tasks: a run of the port and a run of the JAX trainer fed from
`batch_at` see identical batches. `device_batch_fn` makes the image and
MLM tasks' batches on the card (a 64-image 224² f32 batch is 38.5 MB of
host normals a step): one `torch.Generator` on the batch's device
seeded by (seed, step), so
deterministic and resume-safe, though its stream differs from
`batch_at`'s, as the JAX package's own device stream differs from its
host stream. The causal-LM stream is made on the card too: ids uniform
over the vocabulary and an all-ones mask. `to_device` moves a numpy
batch onto the training device: through pinned host memory with a
non-blocking copy on the card, a plain tensor on the CPU.

Data parallelism (a gang of `world` ranks on the mesh's data axis): every
stream, host or device, makes the GLOBAL batch of a step and each rank
keeps its rows (`local_rows`, `shard_batch`), so a rank's rows are the
rows a world-1 run gives them whatever the gang's size: the JAX
package's layout-invariant RNG (`ensure_layout_invariant_rng`) by
construction. Under accumulation the rows are taken microbatch by
microbatch, so microbatch i of every rank is its share of the global
microbatch i, as the JAX step reshards each microbatch over the data
axis. `batch_spec` is the JAX package's one batch-layout policy: every
array splits its leading dim over (data, fsdp).

Sequence parallelism (the mesh's sequence axis, `n` ranks a ring): a
rank keeps its rows and then its columns [r·s, (r+1)·s) of every
[B, S] array (`shard_columns`), s = S / n, still cut from the global
batch. The causal LM's last position of a shard predicts the first
token of the next shard, so the ids and the mask also keep ONE
lookahead column, position (r+1)·s, as `next_input_ids` and
`next_attention_mask` ([B, 1]); the last rank's is a masked column.
The JAX task shifts the global array, which GSPMD keeps global.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import numpy as np
import torch

TASKS = ("lm", "mlm", "image")
# the MLM stream's masking: a position is masked with this probability,
# and a masked position's input id becomes MASK_ID ([MASK]-like)
MLM_MASK_RATE = 0.15
MASK_ID = 1
# the lookahead column a sequence shard keeps of each of these arrays
LOOKAHEAD = ("input_ids", "attention_mask")
NEXT = "next_"


class SyntheticData:
    """Deterministic synthetic batches of the causal-LM, masked-LM or
    image task."""

    def __init__(self, task: str, global_batch_size: int, seed: int = 0,
                 image_size: int = 224, num_classes: int = 1000,
                 seq_len: int = 128, vocab_size: int = 30522):
        if task not in TASKS:
            raise ValueError(f"unknown synthetic task {task!r}; known: {TASKS}")
        self.task = task
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.image_size = image_size
        self.num_classes = num_classes
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def _step_seed(self, step: int) -> int:
        return self.seed * 1_000_003 + step

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._step_seed(step))
        b = self.global_batch_size
        if self.task == "image":
            return {
                "image": rng.standard_normal(
                    (b, self.image_size, self.image_size, 3), dtype=np.float32
                ),
                "label": rng.integers(0, self.num_classes, (b,),
                                      dtype=np.int32),
            }
        # both LM streams start from uniform ids; the causal LM predicts
        # the next token over the full sequence
        ids = rng.integers(0, self.vocab_size, (b, self.seq_len), dtype=np.int32)
        if self.task == "lm":
            return {
                "input_ids": ids,
                "attention_mask": np.ones((b, self.seq_len), dtype=np.int32),
            }
        labels = ids.copy()
        # mask 15 % of positions; unmasked labels are -100 (ignored)
        mask = rng.random((b, self.seq_len)) < MLM_MASK_RATE
        labels[~mask] = -100
        ids[mask] = MASK_ID
        return {
            "input_ids": ids,
            "attention_mask": np.ones((b, self.seq_len), dtype=np.int32),
            "labels": labels,
            "nsp_labels": rng.integers(0, 2, (b,), dtype=np.int32),
        }

    def _generator(self, device: torch.device, step: int) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self._step_seed(step))
        return gen

    def _mlm_batch(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """The MLM batch of `batch_at`'s rule, drawn from `gen` on its
        device."""
        b = self.global_batch_size
        dev, shape = gen.device, (b, self.seq_len)
        ids = torch.randint(0, self.vocab_size, shape, generator=gen, device=dev)
        mask = torch.rand(shape, generator=gen, device=dev) < MLM_MASK_RATE
        return {
            "input_ids": torch.where(mask, MASK_ID, ids),
            "attention_mask": torch.ones(shape, dtype=torch.long, device=dev),
            "labels": torch.where(mask, ids, -100),
            "nsp_labels": torch.randint(0, 2, (b,), generator=gen, device=dev),
        }

    def _lm_batch(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """The causal-LM batch of `batch_at`'s rule (uniform ids, all-ones
        mask), drawn from `gen` on its device."""
        dev, shape = gen.device, (self.global_batch_size, self.seq_len)
        return {
            "input_ids": torch.randint(0, self.vocab_size, shape,
                                       generator=gen, device=dev),
            "attention_mask": torch.ones(shape, dtype=torch.long, device=dev),
        }

    def device_batch_fn(self, device) -> Callable[[int], Dict[str, torch.Tensor]]:
        """step → the global batch made on `device` (every task).
        Integer arrays come as int64, as `to_device` gives them."""
        dev = torch.device(device)
        b = self.global_batch_size
        if self.task == "mlm":
            return lambda step: self._mlm_batch(self._generator(dev, step))
        if self.task == "lm":
            return lambda step: self._lm_batch(self._generator(dev, step))
        s = self.image_size

        def fn(step: int) -> Dict[str, torch.Tensor]:
            gen = self._generator(dev, step)
            return {
                "image": torch.randn((b, s, s, 3), generator=gen, device=dev),
                "label": torch.randint(0, self.num_classes, (b,),
                                       generator=gen, device=dev),
            }

        return fn


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on `device`: integer arrays as int64, float
    arrays as f32. On the card each array goes through pinned memory
    with a non-blocking copy (the caching host allocator keeps the pinned
    block until the copy has run), so the host returns at once."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.float() if t.is_floating_point() else t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def batch_spec(batch: Dict[str, Any]) -> Dict[str, tuple]:
    """Batch arrays split along (data, fsdp) on their leading dim (the
    JAX `PartitionSpec(("data", "fsdp"))` as a tuple)."""
    return {k: (("data", "fsdp"),) for k in batch}


Rows = Union[slice, np.ndarray]


def local_rows(global_batch_size: int, rank: int, world: int,
               accum_steps: int = 1) -> Rows:
    """The rows of the global batch that `rank` of `world` feeds: a
    contiguous block, or under accumulation its block of every
    microbatch, in microbatch order (an index array)."""
    if global_batch_size % (world * accum_steps):
        raise ValueError(
            f"global_batch_size {global_batch_size} not divisible by "
            f"data*fsdp axes {world} x accum_steps {accum_steps}")
    micro = global_batch_size // accum_steps
    share = micro // world
    if accum_steps == 1:
        return slice(rank * share, (rank + 1) * share)
    return np.concatenate([i * micro + rank * share + np.arange(share)
                           for i in range(accum_steps)])


def row_indices(rows: Rows) -> np.ndarray:
    """`local_rows`' rows as an index array."""
    if isinstance(rows, slice):
        return np.arange(rows.start, rows.stop)
    return rows


def shard_batch(batch: Dict[str, Any], rows: Rows) -> Dict[str, Any]:
    """The rank's rows of a global batch (numpy arrays, lazy dataset
    columns, which read and decode only these rows, or tensors). A slice
    of a tensor is a view."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v[rows if isinstance(rows, slice)
                       else torch.from_numpy(rows).to(v.device)]
        else:
            out[k] = np.asarray(v[rows])
    return out


def local_columns(seq_len: int, rank: int, size: int) -> slice:
    """The columns sequence rank `rank` of `size` holds."""
    if seq_len % size:
        raise ValueError(f"sequence parallelism needs seq_len {seq_len} "
                         f"divisible by the sequence mesh axis {size}")
    s = seq_len // size
    return slice(rank * s, (rank + 1) * s)


def shard_columns(batch: Dict[str, Any], rank: int, size: int
                  ) -> Dict[str, Any]:
    """Sequence rank `rank` of `size`'s columns of a batch (numpy arrays
    or tensors): every [B, S] array (S the ids' length) cut to its
    columns, other arrays unchanged, plus the lookahead column of each
    LOOKAHEAD array as NEXT + its name (zeros on the last rank)."""
    seq_len = batch["input_ids"].shape[1]
    cols = local_columns(seq_len, rank, size)
    out = {}
    for k, v in batch.items():
        out[k] = (v[:, cols] if v.ndim == 2 and v.shape[1] == seq_len
                  else v)
    for k in LOOKAHEAD:
        if k not in batch:
            continue
        v = batch[k]
        if cols.stop < seq_len:
            out[NEXT + k] = v[:, cols.stop:cols.stop + 1]
        elif isinstance(v, torch.Tensor):
            out[NEXT + k] = torch.zeros_like(v[:, :1])
        else:
            out[NEXT + k] = np.zeros_like(v[:, :1])
    return out
