"""Real-data input pipeline (port of kubeflow_tpu/training/datasets.py):
array datasets, NPZ shards, the mmap `.npy` layout, eval splits.

All numpy, so every batch equals the JAX package's bit for bit:

- `ArrayDataset`: in-memory (or memory-mapped) arrays with deterministic
  epoch shuffling (seed + epoch → permutation): a restarted run sees the
  same batch sequence with no iterator state. uint8 images decode to
  centred f32 per batch.
- `load_npz`: one `.npz` file, or a directory of `train-*.npz` /
  `val-*.npz` shards read through the native `ShardPrefetcher`.
- `load_npy_mmap`: `<split>_<key>.npy` files opened with mmap, the layout
  for data that does not fit host memory.
- `make_blobs`: a learnable generated classification set (class blobs
  rendered as images), the hermetic stand-in for ImageNet.
- eval batches carry `eval_mask`, so a padded final batch counts exactly
  its real rows.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kubeflow_tpu_torch.config.platform import TrainingConfig

EVAL_MASK = "eval_mask"


def _decode(key: str, v: np.ndarray) -> np.ndarray:
    """uint8 images (the disk-efficient layout) → centred f32; every
    other array passes through."""
    if key == "image" and v.dtype == np.uint8:
        return v.astype(np.float32) / 127.5 - 1.0
    return v


class _LazyColumn:
    """A batch column whose rows read and decode only when sliced (a
    process reads just the rows it feeds)."""

    def __init__(self, base, indices: np.ndarray, key: str):
        self.base = base
        self.indices = indices
        self.key = key
        probe = _decode(key, np.asarray(base[indices[:1]]))
        self.dtype = probe.dtype
        self.shape = (len(indices),) + probe.shape[1:]

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            rows, rest = idx[0], idx[1:]
            out = _decode(self.key, np.asarray(self.base[self.indices[rows]]))
            return out[(slice(None),) + rest] if rest else out
        return _decode(self.key, np.asarray(self.base[self.indices[idx]]))

    def __array__(self, dtype=None):
        out = _decode(self.key, np.asarray(self.base[self.indices]))
        return out.astype(dtype) if dtype is not None else out


class ArrayDataset:
    """Finite dataset with deterministic epoch shuffling.

    `batch_at(step)` is a pure function of (arrays, seed, step): epoch
    `step // steps_per_epoch` is shuffled by `default_rng([seed, epoch])`
    and the batch is the step's slice of that permutation (the remainder
    rows land elsewhere in each epoch's permutation, so none is left out
    for good); with shuffle=False batches stream in order, wrapping
    around."""

    def __init__(self, arrays: Dict[str, np.ndarray], global_batch_size: int,
                 seed: int = 0, shuffle: bool = True):
        if not arrays:
            raise ValueError("empty dataset")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset arrays: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        if self.n < global_batch_size:
            raise ValueError(
                f"dataset has {self.n} examples < batch {global_batch_size}")
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.steps_per_epoch = self.n // global_batch_size
        self._perm_cache: Optional[Tuple[int, np.ndarray]] = None

    @property
    def num_examples(self) -> int:
        return self.n

    def _perm(self, epoch: int) -> np.ndarray:
        # one-slot memo: the permutation changes once an epoch
        if self._perm_cache is not None and self._perm_cache[0] == epoch:
            return self._perm_cache[1]
        perm = np.random.default_rng([self.seed, epoch]).permutation(self.n)
        self._perm_cache = (epoch, perm)
        return perm

    def _finalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Materialise (mmap rows → RAM) and decode storage dtypes."""
        return {k: _decode(k, np.asarray(v)) for k, v in batch.items()}

    def _batch_indices(self, step: int) -> np.ndarray:
        bs = self.global_batch_size
        if not self.shuffle:
            return (step * bs + np.arange(bs)) % self.n
        epoch, pos = divmod(step, self.steps_per_epoch)
        return self._perm(epoch)[pos * bs:(pos + 1) * bs]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = self._batch_indices(step)
        return self._finalize({k: v[idx] for k, v in self.arrays.items()})

    def lazy_batch_at(self, step: int) -> Dict[str, _LazyColumn]:
        """Columns that read and decode their rows only when sliced."""
        idx = self._batch_indices(step)
        return {k: _LazyColumn(v, idx, k) for k, v in self.arrays.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def eval_batches(self, batch_size: Optional[int] = None,
                     pad_to_multiple: int = 1
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Every example once, in order; every batch the same (padded)
        size, rounded up to `pad_to_multiple`, with `eval_mask` marking
        the real rows."""
        bs = batch_size or self.global_batch_size
        m = max(1, pad_to_multiple)
        padded = -(-bs // m) * m
        for start in range(0, self.n, bs):
            idx = np.arange(start, min(start + bs, self.n))
            batch = {k: v[idx] for k, v in self.arrays.items()}
            valid = len(idx)
            if valid < padded:
                pad = padded - valid
                batch = {
                    k: np.concatenate(
                        [np.asarray(v), np.repeat(np.asarray(v[-1:]), pad,
                                                  axis=0)])
                    for k, v in batch.items()
                }
            mask = np.zeros((padded,), np.float32)
            mask[:valid] = 1.0
            batch = self._finalize(batch)
            batch[EVAL_MASK] = mask
            yield batch


class _IndexedView:
    """Row-indexed view over a (possibly memory-mapped) array: a split of
    a memmap stays unread until a batch touches its rows."""

    def __init__(self, base, indices: np.ndarray):
        self.base = base
        self.indices = indices

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def shape(self):
        return (len(self.indices),) + self.base.shape[1:]

    @property
    def dtype(self):
        return self.base.dtype

    def __getitem__(self, idx):
        return self.base[self.indices[idx]]

    def __array__(self, dtype=None):
        out = self.base[self.indices]
        return out.astype(dtype) if dtype is not None else out


def split_eval(arrays: Dict[str, np.ndarray], eval_fraction: float,
               seed: int = 0
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Deterministic held-out split (the same permutation on every
    restart): memory-mapped arrays split as lazy views, in-RAM arrays
    sliced."""
    n = len(next(iter(arrays.values())))
    n_eval = max(1, int(n * eval_fraction))
    perm = np.random.default_rng([seed, 0xE7A1]).permutation(n)
    eval_idx, train_idx = np.sort(perm[:n_eval]), np.sort(perm[n_eval:])

    def take(v, idx):
        if isinstance(v, (np.memmap, _IndexedView)):
            return _IndexedView(v, idx)
        return v[idx]

    return ({k: take(v, train_idx) for k, v in arrays.items()},
            {k: take(v, eval_idx) for k, v in arrays.items()})


# -- sources -------------------------------------------------------------------


def make_blobs(num_examples: int = 4096, image_size: int = 8,
               num_classes: int = 10, seed: int = 0, noise: float = 0.6
               ) -> Dict[str, np.ndarray]:
    """Learnable image classification: each class is a gaussian blob
    around a fixed random template image."""
    rng = np.random.default_rng([seed, 0xB10B5])
    templates = rng.standard_normal(
        (num_classes, image_size, image_size, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, (num_examples,), dtype=np.int32)
    images = templates[labels] + noise * rng.standard_normal(
        (num_examples, image_size, image_size, 3)).astype(np.float32)
    return {"image": images.astype(np.float32), "label": labels}


def _npz_files(path: str, prefix: str) -> List[str]:
    if os.path.isfile(path):
        # a single-file dataset is train-only: it must not double as the
        # val split
        return [path] if prefix == "train" else []
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.startswith(prefix) and f.endswith(".npz"))


def load_npz(path: str, split: str = "train"
             ) -> Optional[Dict[str, np.ndarray]]:
    """`<path>` (one .npz) or its `<split>-*.npz` shards, read through the
    native prefetcher (disk reads overlap the decode of the shard
    before), arrays of one key concatenated in shard order; None when the
    split has no files."""
    from kubeflow_tpu_torch.native.shard_prefetch import ShardPrefetcher

    files = _npz_files(path, split)
    if not files:
        return None
    parts: Dict[str, List[np.ndarray]] = {}
    with ShardPrefetcher(files) as shards:
        for _path, blob in shards:
            with np.load(io.BytesIO(blob)) as z:
                for k in z.files:
                    parts.setdefault(k, []).append(z[k])
    return {k: (v[0] if len(v) == 1 else np.concatenate(v, axis=0))
            for k, v in parts.items()}


def load_npy_mmap(path: str, split: str = "train"
                  ) -> Optional[Dict[str, np.ndarray]]:
    """`<path>/<split>_<key>.npy` opened with mmap_mode='r': only the rows
    a batch touches are read."""
    if not os.path.isdir(path):
        return None
    prefix = f"{split}_"
    out = {}
    for f in sorted(os.listdir(path)):
        if f.startswith(prefix) and f.endswith(".npy"):
            key = f[len(prefix):-len(".npy")]
            out[key] = np.load(os.path.join(path, f), mmap_mode="r")
    return out or None


def build_data(cfg: TrainingConfig, task) -> Tuple[object, Optional[ArrayDataset]]:
    """The configured input pipeline → (train data, eval data or None).
    The train data has `batch_at(step)` (SyntheticData or ArrayDataset)."""
    d = cfg.data
    if d.name == "synthetic":
        return task.synthetic_data(), None
    if d.name == "blobs":
        if getattr(task, "name", "") != "image":
            raise ValueError(
                "data.name=blobs generates {image,label} batches and needs "
                f"an image-classification model; task is {task!r}")
        arrays = make_blobs(num_examples=d.num_examples, seed=cfg.seed,
                            image_size=task.image_size,
                            num_classes=task.num_classes)
        eval_arrays = None
        if d.eval_fraction > 0:
            arrays, eval_arrays = split_eval(arrays, d.eval_fraction, cfg.seed)
    elif d.name == "npz":
        # the mmap layout first, then npz, each split on its own
        arrays = load_npy_mmap(d.path, "train") or load_npz(d.path, "train")
        eval_arrays = load_npy_mmap(d.path, "val") or load_npz(d.path, "val")
        if arrays is None:
            raise FileNotFoundError(
                f"no train data at {d.path!r} (expected train_<key>.npy "
                f"mmap files, a single .npz, or train-*.npz shards)")
        if eval_arrays is None and d.eval_fraction > 0:
            arrays, eval_arrays = split_eval(arrays, d.eval_fraction, cfg.seed)
        if eval_arrays is None and (d.target_accuracy or d.eval_every_steps):
            raise FileNotFoundError(
                f"eval requested (target_accuracy/eval_every_steps) but "
                f"{d.path!r} has no val split and data.eval_fraction == 0")
    else:
        raise ValueError(f"unknown dataset {d.name!r}")
    train = ArrayDataset(arrays, cfg.global_batch_size, seed=cfg.seed,
                         shuffle=d.shuffle)
    eval_ds = None
    if eval_arrays is not None:
        eval_bs = d.eval_batch_size or cfg.global_batch_size
        # eval_batches pads, so an eval set smaller than a batch is fine
        eval_bs = min(eval_bs, len(next(iter(eval_arrays.values()))))
        eval_ds = ArrayDataset(eval_arrays, eval_bs, seed=cfg.seed,
                               shuffle=False)
    return train, eval_ds
