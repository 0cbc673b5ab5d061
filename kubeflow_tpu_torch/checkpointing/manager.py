"""Async CheckpointManager with a preemption-safe commit and a
layout-independent restore (port of kubeflow_tpu/checkpointing/manager.py).

The on-disk format is the JAX package's (checkpointing/layout.py), so a
checkpoint either package writes is read by the other:

- **async saves**: `save()` blocks only to copy every leaf to host
  memory. The port's trainer updates its parameters and AdamW moments IN
  PLACE, so that copy must be complete before `save()` returns (a lazy or
  stream-async copy would write the next step's weights): the device
  leaves are copied into one pinned buffer and the copying stream is
  synchronized before `save()` goes on. The file writes, the commit and
  the retention sweep run on a background writer thread behind a bounded
  in-flight window. The train loop's blocked time is
  `checkpoint_blocked_seconds`; the full save is `checkpoint_save_seconds`.
- **two-phase atomic commit** (checkpointing/layout.py): shards first,
  the manifest rename last. A process killed mid-save leaves an
  uncommitted step directory that readers ignore and a later retention
  sweep reclaims once stale: `latest_step()` never names a torn
  checkpoint.
- **region assembly on restore**: the manifest records each shard file's
  global index range, and `_ShardReader.region` assembles any region from
  the overlapping files, which is what reads a checkpoint the JAX package
  saved sharded over a mesh.
- **a gang's saves** (the JAX package's `_snapshot_leaf`):
  `process_index` / `process_count` are the `torch.distributed` rank and
  world size (0 and 1 without a group). A replicated leaf is process
  0's: as the JAX package writes one, it alone copies it to host memory
  and writes it whole. A leaf split over ranks comes as a `ShardedLeaf`
  (an expert stack's block, a pipeline stage's slice of a stacked
  layer leaf, or their AdamW moments'; a leaf one stage owns is one
  whole block, and the ranks that do not hold it name it with an empty
  block that writes and reads nothing): the one rank that writes each
  block (`writer`) copies and writes it with its global index ranges,
  and the manifest lists every block. Process 0 commits
  the manifest, which records the gang's `process_count`, once the
  commit barrier has seen every expected file, whoever wrote it. No
  block is gathered to one rank. Every rank restores from the shared
  directory, reading its own region of each leaf, and a checkpoint
  restores under any world size and layout (and in the JAX package)
  because every file carries its global index ranges.

A state is a nested mapping of leaves (torch tensors, numpy arrays or
Python scalars) keyed by strings, or an object with `checkpoint_tree()`
(the mapping to save) and `load_checkpoint_tree(tree)` (restore in
place), as training/trainer.py's `TrainState` has; with
`restore_tree(entries)` too, a restore reads the tree that method makes
from the checkpoint's manifest entries (a state that restores from
another param layout than it saves, such as a pipelined run's).
Manifest keys are the '/'-joined key paths.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.chaos import ChaosError, default_chaos
from kubeflow_tpu_torch.checkpointing import layout
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    checkpoint_blocked_histogram,
    checkpoint_bytes_counter,
    checkpoint_restores_counter,
    checkpoint_save_histogram,
    default_registry,
)
from kubeflow_tpu_torch.utils.retry import backoff_retry

log = get_logger(__name__)

_CLOSE = object()  # writer-queue sentinel

# Transient-I/O retry policy for the shard-write / commit / restore
# paths: network checkpoint volumes hiccup (and the kft-chaos points
# checkpoint.{shard_write,commit,restore} inject exactly that class of
# fault, so it rides the same retries), and one flaky write must not
# fail a whole save. Bounded exponential backoff WITH jitter: every host
# of a gang retries against the same volume, and lockstep retries would
# re-collide. A fault that survives all attempts propagates: a
# persistent failure leaves the step uncommitted (invisible to readers),
# never torn.
_IO_RETRY_ATTEMPTS = 3
_IO_RETRY_DELAY_S = 0.05
_IO_RETRY_MULTIPLIER = 2.0
_IO_RETRY_JITTER = 0.5
_IO_RETRY_ON = (OSError, ChaosError)


def _io_retry(fn, what: str):
    return backoff_retry(
        fn,
        attempts=_IO_RETRY_ATTEMPTS,
        delay_s=_IO_RETRY_DELAY_S,
        multiplier=_IO_RETRY_MULTIPLIER,
        jitter=_IO_RETRY_JITTER,
        retry_on=_IO_RETRY_ON,
        on_retry=lambda i, e: log.warning(
            "checkpoint %s failed (attempt %d): %s; retrying", what, i, e
        ),
    )


class _LeafSnapshot:
    """One leaf, host-side: what this process writes + what the manifest
    must list."""

    __slots__ = ("key", "shape", "dtype", "expected", "mine")

    def __init__(self, key, shape, dtype, expected, mine):
        self.key = key
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype  # torch dtype
        # every global shard region (manifest + commit barrier)
        self.expected: List[layout.IndexRanges] = expected
        # regions THIS process persists: [(ranges, CPU tensor)]
        self.mine: List[Tuple[layout.IndexRanges, torch.Tensor]] = mine


def _tree_of(state: Any) -> Any:
    return state.checkpoint_tree() if hasattr(state, "checkpoint_tree") else state


def _flatten_with_keys(tree: Any, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """[(manifest key, leaf)] of a nested mapping, in insertion order."""
    if isinstance(tree, Mapping):
        out: List[Tuple[str, Any]] = []
        for k, sub in tree.items():
            out.extend(_flatten_with_keys(sub, prefix + (str(k),)))
        return out
    return [(layout.path_str(prefix), tree)]


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': leaf} → {'a': {'b': {'c': leaf}}}: the inverse of the
    manifest's key paths."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


# leaf offsets in the pinned snapshot buffer (any dtype's alignment)
_PIN_ALIGN = 64


def _host_copies(leaves: List[Any]) -> List[torch.Tensor]:
    """Contiguous CPU tensors holding the leaves' values now, complete
    when this returns: the owner updates them in place right after.

    CUDA leaves are copied into views of ONE pinned buffer, all copies
    enqueued (non_blocking) and then each source device's current stream
    synchronized: one host sync at the pinned copy rate instead of a
    pageable round trip a leaf. The buffer comes from torch's caching
    host allocator, so a later save reuses it once this snapshot has
    been written and dropped. CPU leaves are cloned; other leaves
    (numpy, Python scalars) copied."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    on_card = [i for i, leaf in enumerate(leaves)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    if on_card:
        sizes = [leaves[i].numel() * leaves[i].element_size() for i in on_card]
        spans = [-(-n // _PIN_ALIGN) * _PIN_ALIGN for n in sizes]
        flat = torch.empty(sum(spans), dtype=torch.uint8, pin_memory=True)
        off = 0
        for i, n, span in zip(on_card, sizes, spans):
            src = leaves[i].detach()
            dst = flat[off:off + n].view(src.dtype).view(src.shape)
            dst.copy_(src, non_blocking=True)
            out[i] = dst
            off += span
        for dev in {leaves[i].device for i in on_card}:
            torch.cuda.current_stream(dev).synchronize()
    for i, leaf in enumerate(leaves):
        if out[i] is None:
            out[i] = (leaf.detach().clone(memory_format=torch.contiguous_format)
                      if isinstance(leaf, torch.Tensor)
                      else torch.from_numpy(np.array(leaf)))
    return out


class ShardedLeaf:
    """This process's block of a leaf split over ranks: `local` (the
    block's live tensor), the whole leaf's `shape`, the block's global
    `index` ranges, `regions` (every block's ranges: the manifest's
    shards) and `writer` (this process writes the block: exactly one
    rank holding each block does). A restore reads `index` of the saved
    leaf into a tensor like `local`."""

    __slots__ = ("local", "shape", "index", "regions", "writer")

    def __init__(self, local: torch.Tensor, shape, index, regions,
                 writer: bool):
        self.local = local
        self.shape = tuple(int(d) for d in shape)
        self.index: layout.IndexRanges = tuple(
            (int(a), int(b)) for a, b in index)
        self.regions: List[layout.IndexRanges] = [
            tuple((int(a), int(b)) for a, b in r) for r in regions]
        self.writer = bool(writer)


def _leaf_meta(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, dtype) a leaf is stored with, without copying it."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    t = torch.from_numpy(np.array(leaf))
    return tuple(t.shape), t.dtype


def _snapshot(state: Any, process_index: int) -> List[_LeafSnapshot]:
    """Every leaf's manifest entry, and host copies of what this process
    writes: a replicated leaf whole on process 0, a `ShardedLeaf`'s block
    on its writer."""
    plans = []  # (key, shape, dtype, expected regions, ranges, source)
    for key, leaf in _flatten_with_keys(_tree_of(state)):
        if isinstance(leaf, ShardedLeaf):
            plans.append((key, leaf.shape, leaf.local.dtype, leaf.regions,
                          leaf.index, leaf.local if leaf.writer else None))
            continue
        shape, dtype = _leaf_meta(leaf)
        ranges = tuple((0, int(d)) for d in shape)
        plans.append((key, shape, dtype, [ranges], ranges,
                      leaf if process_index == 0 else None))
    hosts = iter(_host_copies([p[5] for p in plans if p[5] is not None]))
    return [_LeafSnapshot(key, torch.Size(shape), dtype, expected,
                          [] if src is None else [(ranges, next(hosts))])
            for key, shape, dtype, expected, ranges, src in plans]


class CheckpointManager:
    """Async checkpointing bound to one directory: save / latest_step /
    all_steps / restore / wait / close, as the JAX package's manager."""

    def __init__(
        self,
        directory: str,
        keep: int = 3,
        async_save: bool = True,
        save_interval_steps: int = 1,
        keep_every: int = 0,
        max_in_flight: int = 2,
        commit_timeout_s: float = 120.0,
    ):
        directory = layout.local_checkpoint_dir(directory)
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.keep = max(1, int(keep))
        self.keep_every = max(0, int(keep_every))
        self.async_save = async_save
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.commit_timeout_s = commit_timeout_s
        self._max_in_flight = max(1, int(max_in_flight))
        self._slots = threading.Semaphore(self._max_in_flight)
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._in_flight: set = set()  # steps being written (GC must skip)
        # last step this manager scheduled: dedupes a forced re-save of a
        # step whose write already ran (run_training's final forced save
        # of the last interval step would otherwise rewrite it)
        self._last_scheduled: Optional[int] = None
        self._closed = False
        # test hook: raise after the shard phase, before the manifest —
        # simulates a kill mid-save (the torn state the commit protocol
        # must tolerate)
        self._crash_after_shards = False
        reg = default_registry()
        self._save_total = reg.counter(
            "checkpoint_save_total", "checkpoints saved"
        )
        self._save_seconds = checkpoint_save_histogram()
        self._blocked_seconds = checkpoint_blocked_histogram()
        self._bytes_total = checkpoint_bytes_counter()
        self._restores_total = checkpoint_restores_counter()

    # -- save -------------------------------------------------------------

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Snapshot every leaf to host memory and schedule the write;
        returns whether a save was scheduled. Blocks only for the host
        copy (and, when the in-flight window is full, for a slot)."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        self._raise_pending_error()
        t0 = time.monotonic()
        if not force and step % self.save_interval_steps != 0:
            return False
        if (
            step == self._last_scheduled
            or step in self._in_flight
            or layout.is_committed(self.directory, step)
        ):
            return False
        self._slots.acquire()
        try:
            snapshot = _snapshot(state, _process_index())
        except BaseException:
            self._slots.release()
            raise
        self._in_flight.add(step)
        self._last_scheduled = step
        if self.async_save:
            self._ensure_thread()
            self._queue.put((step, snapshot, t0))
            self._blocked_seconds.observe(time.monotonic() - t0)
        else:
            try:
                self._write_checkpoint(step, snapshot, t0)
            except BaseException:
                # let a retry of this step through the dedupe gate
                self._last_scheduled = None
                raise
            finally:
                self._in_flight.discard(step)
                self._slots.release()
            self._blocked_seconds.observe(time.monotonic() - t0)
        return True

    def _ensure_thread(self) -> None:
        if self._thread is None:
            # non-daemon: a leaked writer must fail loudly, never die
            # mid-commit with the interpreter
            self._thread = threading.Thread(
                target=self._writer_loop, name="checkpoint-writer", daemon=False
            )
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _CLOSE:
                    return
                step, snapshot, t0 = item
                try:
                    self._write_checkpoint(step, snapshot, t0)
                except BaseException as e:  # noqa: BLE001 - surfaced on wait()
                    if self._last_scheduled == step:
                        # let a retry of this step through the dedupe gate
                        self._last_scheduled = None
                    with self._error_lock:
                        if self._error is None:
                            self._error = e
                    log.error("async checkpoint save for step %d failed: %s", step, e)
                finally:
                    self._in_flight.discard(step)
                    self._slots.release()
            finally:
                self._queue.task_done()

    def _write_checkpoint(
        self, step: int, snapshot: List[_LeafSnapshot], t0: float
    ) -> None:
        dirpath = layout.step_dir(self.directory, step)
        os.makedirs(dirpath, exist_ok=True)
        written = 0
        for leaf_id, leaf in enumerate(snapshot):
            for ranges, host in leaf.mine:
                path = os.path.join(
                    dirpath, layout.shard_filename(leaf_id, ranges)
                )
                # the tensor's own buffer as bytes (a uint8 view, no copy;
                # reshape(-1) lets a 0-d leaf view too)
                buf = host.reshape(-1).view(torch.uint8).numpy()

                def _write_shard(path=path, buf=buf):
                    default_chaos().maybe_fail("checkpoint.shard_write")
                    layout.atomic_write_bytes(path, buf.data)

                _io_retry(_write_shard, "shard write")
                written += buf.nbytes
        if written:
            self._bytes_total.inc(written)
        # one directory fsync per host covers every shard rename above
        # (per-file dir fsyncs would cost O(shards) on network volumes)
        layout.fsync_dir(dirpath)
        if self._crash_after_shards:
            raise RuntimeError("simulated crash between shards and manifest")
        if _process_index() != 0:
            # non-coordinator hosts are done: the commit is process 0's
            self._save_seconds.observe(time.monotonic() - t0)
            return
        self._await_all_shards(dirpath, snapshot)
        # the barrier saw every host's files; make their renames durable
        # BEFORE the manifest rename can be (commit implies shards)
        layout.fsync_dir(dirpath)
        manifest = {
            "format": layout.FORMAT,
            "step": int(step),
            "created": time.time(),
            "process_count": _process_count(),
            "leaves": [
                {
                    "key": leaf.key,
                    "shape": list(leaf.shape),
                    "dtype": layout.dtype_name(leaf.dtype),
                    "shards": [
                        {
                            "file": layout.shard_filename(leaf_id, ranges),
                            "index": [list(r) for r in ranges],
                        }
                        for ranges in leaf.expected
                    ],
                }
                for leaf_id, leaf in enumerate(snapshot)
            ],
        }

        def _commit():
            # a persistent fault here leaves the step uncommitted: its
            # shards are on disk, no manifest names them
            default_chaos().maybe_fail("checkpoint.commit")
            layout.write_manifest(dirpath, manifest)

        _io_retry(_commit, "commit")
        self._save_total.inc()
        self._save_seconds.observe(time.monotonic() - t0)
        self._sweep_retention()

    def _await_all_shards(
        self, dirpath: str, snapshot: List[_LeafSnapshot]
    ) -> None:
        """Commit barrier: every expected shard file present (each appears
        atomically via rename, so presence == complete). With one process
        these are this host's own files."""
        expected = {
            layout.shard_filename(leaf_id, ranges)
            for leaf_id, leaf in enumerate(snapshot)
            for ranges in leaf.expected
        }
        deadline = time.monotonic() + self.commit_timeout_s
        while True:
            have = set(os.listdir(dirpath))
            missing = expected - have
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint commit: {len(missing)} shard file(s) from "
                    f"other hosts never arrived in {dirpath} "
                    f"(e.g. {sorted(missing)[:3]}); leaving step uncommitted"
                )
            time.sleep(0.02)

    # -- retention --------------------------------------------------------

    def _sweep_retention(self) -> None:
        """keep-last-N + keep-every-K over committed steps; torn
        uncommitted directories are removed once STALE (untouched for
        longer than the commit timeout: such a directory can no longer
        commit, while a fresh one may be a peer's save in progress)."""
        steps = layout.committed_steps(self.directory)
        keep = set(steps[-self.keep:])
        if self.keep_every:
            keep.update(s for s in steps if s % self.keep_every == 0)
        for s in steps:
            if s not in keep:
                shutil.rmtree(
                    layout.step_dir(self.directory, s), ignore_errors=True
                )
        now = time.time()
        for path in layout.uncommitted_step_dirs(self.directory):
            step = layout.parse_step(os.path.basename(path))
            if step in self._in_flight:
                continue
            try:
                # dir mtime advances on every shard rename into it
                age = now - os.path.getmtime(path)
            except OSError:
                continue  # racing a concurrent delete/commit
            if age > self.commit_timeout_s:
                shutil.rmtree(path, ignore_errors=True)

    # -- read side --------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = layout.committed_steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return layout.committed_steps(self.directory)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore the latest (or given) committed step into the structure,
        dtypes and devices of `state_like` (a TrainState-like object is
        loaded in place and returned)."""
        dirpath = _resolve_committed_dir(self.directory, step)
        restored = restore_pytree(dirpath, state_like)
        self._restores_total.inc()
        return restored

    # -- lifecycle --------------------------------------------------------

    def _raise_pending_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Block until every scheduled save committed; re-raise the first
        writer failure (call before relying on latest_step())."""
        self._queue.join()
        self._raise_pending_error()

    def close(self) -> None:
        """Drain + join the writer. Idempotent: double-close is a no-op."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(_CLOSE)
            self._thread.join()
            self._thread = None
        self._raise_pending_error()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# Restore-side assembly (manifest → tensors)
# ---------------------------------------------------------------------------


class _ShardReader:
    """Assemble arbitrary global regions of one leaf from its shard files."""

    def __init__(self, dirpath: str, entry: Dict[str, Any]):
        self.dirpath = dirpath
        self.key = entry["key"]
        self.shape = tuple(int(d) for d in entry["shape"])
        self.dtype = layout.dtype_from_name(entry["dtype"], self.key)
        self.shards = [
            (tuple((int(a), int(b)) for a, b in s["index"]), s["file"])
            for s in entry["shards"]
        ]
        self._cache: Dict[str, torch.Tensor] = {}

    def _load(self, ranges: layout.IndexRanges, fname: str) -> torch.Tensor:
        t = self._cache.get(fname)
        if t is None:
            raw = np.fromfile(os.path.join(self.dirpath, fname), dtype=np.uint8)
            # the raw little-endian buffer viewed as the leaf's dtype
            # (bf16: 2-byte words as torch.bfloat16, no ml_dtypes)
            t = torch.from_numpy(raw).view(self.dtype).reshape(
                layout.ranges_shape(ranges)
            )
            self._cache[fname] = t
        return t

    def region(self, ranges: layout.IndexRanges) -> torch.Tensor:
        if not ranges:  # scalar
            return self._load((), self.shards[0][1]).reshape(())
        out = torch.empty(layout.ranges_shape(ranges), dtype=self.dtype)
        filled = 0
        for shard_ranges, fname in self.shards:
            inter = layout.intersect_ranges(ranges, shard_ranges)
            if inter is None:
                continue
            src = self._load(shard_ranges, fname)
            src_sel = tuple(
                slice(i0 - s0, i1 - s0)
                for (i0, i1), (s0, _) in zip(inter, shard_ranges)
            )
            dst_sel = tuple(
                slice(i0 - r0, i1 - r0)
                for (i0, i1), (r0, _) in zip(inter, ranges)
            )
            out[dst_sel] = src[src_sel]
            filled += int(np.prod(layout.ranges_shape(inter)))
        want = int(np.prod(layout.ranges_shape(ranges)))
        if filled < want:
            raise ValueError(
                f"checkpoint shards cover only {filled}/{want} elements of "
                f"requested region {ranges} of {self.key!r} (corrupt or "
                f"partial manifest)"
            )
        return out

    def full(self) -> torch.Tensor:
        return self.region(tuple((0, d) for d in self.shape))


def _manifest_entries(dirpath: str) -> Dict[str, Dict[str, Any]]:
    manifest = layout.read_manifest(dirpath)
    return {e["key"]: e for e in manifest["leaves"]}


def _materialize(reader: _ShardReader, target) -> torch.Tensor:
    """One leaf in the target's dtype on its device (a tensor target; a
    `ShardedLeaf` reads its own region), or in the saved dtype on the
    CPU."""
    if isinstance(target, ShardedLeaf):
        if reader.shape != target.shape:
            raise ValueError(
                f"checkpoint leaf {reader.key!r} shape {reader.shape} != "
                f"target shape {target.shape}")
        return reader.region(target.index).to(device=target.local.device,
                                              dtype=target.local.dtype)
    if not isinstance(target, torch.Tensor):
        return reader.full()
    if reader.shape != tuple(target.shape):
        raise ValueError(
            f"checkpoint leaf {reader.key!r} shape {reader.shape} != target "
            f"shape {tuple(target.shape)}"
        )
    return reader.full().to(device=target.device, dtype=target.dtype)


def _restore_leaves(dirpath: str, target: Any, prefix: str) -> Dict[str, Any]:
    entries = _manifest_entries(dirpath)
    pairs = []
    for path, leaf in _flatten_with_keys(target):
        key = f"{prefix}/{path}" if prefix else path
        entry = entries.get(key)
        if entry is None:
            raise KeyError(
                f"checkpoint at {dirpath} has no leaf {key!r} "
                f"(saved keys: {sorted(entries)[:5]}...)"
            )
        pairs.append((path, _materialize(_ShardReader(dirpath, entry), leaf)))
    return nest(dict(pairs))


def restore_pytree(dirpath: str, target: Any) -> Any:
    """Restore a committed step directory into `target`'s structure: a
    nested mapping gives a new nested dict of tensors; an object with
    `load_checkpoint_tree` is loaded in place and returned.

    Retried with bounded backoff: a transient I/O fault mid-assembly must
    not fail a resume that a second read would satisfy."""
    def once():
        default_chaos().maybe_fail("checkpoint.restore")
        tree = (target.restore_tree(_manifest_entries(dirpath))
                if hasattr(target, "restore_tree") else _tree_of(target))
        return _restore_leaves(dirpath, tree, "")

    tree = _io_retry(once, "restore")
    if hasattr(target, "load_checkpoint_tree"):
        target.load_checkpoint_tree(tree)
        return target
    return tree


def latest_committed_step(directory: str) -> Optional[int]:
    steps = layout.committed_steps(layout.local_checkpoint_dir(directory))
    return steps[-1] if steps else None


def _resolve_committed_dir(directory: str, step: Optional[int]) -> str:
    """The ONE resolve-latest/verify-committed preamble every restore path
    shares (training resume, warm start, serving load)."""
    directory = layout.local_checkpoint_dir(directory)
    step = latest_committed_step(directory) if step is None else step
    if step is None or not layout.is_committed(directory, step):
        raise FileNotFoundError(
            f"no committed checkpoint for step {step} under {directory}"
        )
    return layout.step_dir(directory, step)


def restore_latest(
    directory: str, target: Any, step: Optional[int] = None
) -> Any:
    """Manager-free full-state restore: the latest (or given) committed
    step into `target`. The resume path for runs that only READ
    checkpoints (a restart of a job whose saving was since disabled must
    still resume, not retrain from 0)."""
    dirpath = _resolve_committed_dir(directory, step)
    restored = restore_pytree(dirpath, target)
    checkpoint_restores_counter().inc()
    return restored


def restore_params(
    directory: str,
    step: Optional[int] = None,
    prefix: str = "params",
    transform: str = "",
) -> Dict[str, Any]:
    """The serving loader: the `prefix` subtree of the latest committed
    checkpoint as a nested dict of CPU tensors (the saved dtypes); no
    target needed (shapes and dtypes come from the manifest).

    `transform="int8"` quantizes every >= 2-D floating leaf per output
    channel (checkpointing/quantize.py `apply_transform`, leaf by leaf)
    and returns the JAX package's envelope shape: {"qvalues": the nested
    tree, int8 where quantized, "qscales": {keystr path: f32 [out]}},
    which models/convert.py `quantized_params_from_jax` carries into the
    port's names."""
    dirpath = _resolve_committed_dir(directory, step)
    restored = _io_retry(
        lambda: _restore_params_once(dirpath, prefix), "params restore"
    )
    if transform:
        from kubeflow_tpu_torch.checkpointing.quantize import apply_transform

        flat = dict(_flatten_with_keys(restored))
        env = apply_transform(flat, transform)
        restored = {
            "qvalues": nest(env["qvalues"]),
            "qscales": {
                "".join(f"['{p}']" for p in key.split("/")): scale
                for key, scale in env["qscales"].items()
            },
        }
    return restored


def _restore_params_once(dirpath: str, prefix: str) -> Dict[str, Any]:
    default_chaos().maybe_fail("checkpoint.restore")
    entries = _manifest_entries(dirpath)
    want = prefix + "/"
    pairs = [
        (key[len(want):], _ShardReader(dirpath, entry).full())
        for key, entry in entries.items() if key.startswith(want)
    ]
    if not pairs:
        raise KeyError(f"checkpoint at {dirpath} has no {prefix!r} subtree")
    checkpoint_restores_counter().inc()
    return nest(dict(pairs))


def restore_subtree(
    directory: str, target: Any, prefix: str = "params",
    step: Optional[int] = None,
) -> Dict[str, Any]:
    """Restore one subtree into `target`'s structure, dtypes and devices:
    the warm-start path (a run's params from a parent run's checkpoint
    while the step and optimizer state start fresh)."""
    dirpath = _resolve_committed_dir(directory, step)
    tree = _restore_leaves(dirpath, target, prefix)
    checkpoint_restores_counter().inc()
    return tree


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1
