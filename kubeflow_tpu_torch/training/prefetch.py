"""Host→device input prefetch for the train loop (port of
kubeflow_tpu/training/prefetch.py).

`DevicePrefetcher` pulls `get_batch(i)` for future steps on a background
thread and copies each batch to the device while the step before runs,
so the card does not idle through the host's data time. The contract is
the JAX package's:

- **bounded**: at most `depth` device batches wait in the queue
  (`depth` >= 1; a depth of 0 is the trainer's synchronous path),
- **index-keyed**: the worker walks [start_step, end_step) in order and
  `get(step)` checks it receives exactly the step it asked for, so any
  depth trains on the same batch sequence, and a resumed run replays it
  (`get_batch(i)` is a pure function of i),
- **exceptions propagate**: a worker failure is raised by `get()` at the
  step it would have fed, never a silent hang,
- **clean shutdown**: `close()` wakes a blocked worker, joins the
  (non-daemon) thread and is idempotent; `Trainer.fit` closes it in a
  `finally`.

On the card the copy runs on a side CUDA stream of the prefetcher's own:
the worker assembles the batch (`assemble`: pinned host memory and a
non-blocking copy) under that stream and records an event after it.
`get()` makes the consumer's current stream wait on that event before
the step can read the batch, and marks every tensor with
`record_stream` on the consumer's stream, so the caching allocator does
not hand the memory to a later copy while the step still reads it. On
the CPU `assemble` runs on the worker and nothing waits.

A thread, not a process: the host work (numpy, pinned copies) releases
the GIL, so the overlap is real.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import prefetch_queue_depth_gauge

log = get_logger(__name__)

# queue sentinel: the worker failed; the consumer raises self._error
_ERROR = object()


class DevicePrefetcher:
    """Background producer of (batch_np, device_batch) keyed by step index.

    with DevicePrefetcher(get_batch, assemble, s0, s1, depth=2) as pf:
        for i in range(s0, s1):
            batch_np, batch = pf.get(i)
    """

    def __init__(
        self,
        get_batch: Callable[[int], Dict[str, Any]],
        assemble: Callable[[Dict[str, Any]], Dict[str, Any]],
        start_step: int,
        end_step: int,
        depth: int = 2,
        model_label: str = "",
        device: Optional[torch.device] = None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._get_batch = get_batch
        self._assemble = assemble
        self._start = start_step
        self._end = end_step
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._model = model_label
        self._gauge = prefetch_queue_depth_gauge()
        dev = torch.device(device) if device is not None else None
        self._device = dev if dev is not None and dev.type == "cuda" else None
        # the copies' own stream (created on the consumer's thread, where
        # the device is current)
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device is not None else None)
        # non-daemon on purpose: a leak must be loud, not silently reaped
        self._thread = threading.Thread(
            target=self._run, name="device-prefetcher", daemon=False
        )
        self._started = False

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "DevicePrefetcher":
        self._started = True
        self._thread.start()
        return self

    def __enter__(self) -> "DevicePrefetcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the worker and join it. Idempotent; safe mid-stream."""
        self._stop.set()
        # drain so a worker blocked on a full queue wakes and sees the stop
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self._started:
            self._thread.join(timeout=30)
            if self._thread.is_alive():  # pragma: no cover - defensive
                log.error("device-prefetcher failed to join within 30s")
        self._gauge.set(0, model=self._model)

    # -- producer ---------------------------------------------------------

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
            except queue.Full:
                continue
            self._gauge.set(self._queue.qsize(), model=self._model)
            return True
        return False

    def _produce(self, batch_np):
        """(device batch, the event its copy completes at or None)."""
        if self._stream is None:
            return self._assemble(batch_np), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            batch_dev = self._assemble(batch_np)
            done = torch.cuda.Event()
            done.record(self._stream)
        return batch_dev, done

    def _run(self) -> None:
        try:
            for i in range(self._start, self._end):
                if self._stop.is_set():
                    return
                batch_np = self._get_batch(i)
                batch_dev, done = self._produce(batch_np)
                if not self._put((i, batch_np, batch_dev, done)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            self._error = e
            self._put(_ERROR)

    # -- consumer ---------------------------------------------------------

    def get(self, step: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Block until step's batch is ready; returns (batch_np, device).
        On the card the caller's current stream waits for the copy.

        Raises the worker's exception if production failed, or RuntimeError
        if the worker died without producing this step.
        """
        while True:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    # the worker may have enqueued its final batch and
                    # exited between our timeout and this check — drain
                    # once more before declaring it dead-without-producing
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            f"prefetch worker exited before producing "
                            f"step {step}"
                        ) from None
                else:
                    continue
            if item is _ERROR:
                raise self._error
            self._gauge.set(self._queue.qsize(), model=self._model)
            i, batch_np, batch_dev, done = item
            if i != step:  # pragma: no cover - ordering invariant
                raise RuntimeError(
                    f"prefetch out of order: wanted step {step}, got {i}"
                )
            if done is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(done)
                for t in batch_dev.values():
                    if isinstance(t, torch.Tensor):
                        t.record_stream(consumer)
            return batch_np, batch_dev
