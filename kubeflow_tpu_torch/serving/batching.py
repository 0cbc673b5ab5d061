"""Cross-request micro-batching for the model server (port of
kubeflow_tpu/serving/batching.py; pure Python and numpy, the JAX
package's logic line for line).

TF Serving's batching_parameters fuse concurrent clients' rows into one
device call; this is that batcher:

- requests queue with a tiny collection window (a few ms);
- the collector drains the queue when the window closes OR the bucketed
  batch is full, groups rows by (trailing shape, dtype) — mixed-shape
  traffic never contaminates a batch — fuses each group into ONE padded
  device call, and fans per-request slices back out;
- callers block on their own event; errors propagate per request.

One device call per window instead of one per request: under concurrency
the card sees larger batches while p50 grows by at most the window.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from kubeflow_tpu_torch.utils.metrics import serving_fused_rows_histogram


class Completion:
    """One waiter's completion slot: a value or an error behind an event.

    The blocking-caller/background-worker handoff shared by the
    micro-batcher (per fused-batch slice) and the continuous-batching
    decode engine's request futures (serving/engine.py): the worker calls
    exactly one of set()/fail(); the caller blocks in wait()."""

    __slots__ = ("_event", "value", "error")

    def __init__(self):
        self._event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None

    def set(self, value) -> None:
        self.value = value
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"no completion within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.value


class _Pending:
    __slots__ = ("x", "done")

    def __init__(self, x: np.ndarray):
        self.x = x
        # completes with (rows, aux): this request's slice of the fused
        # batch plus the run fn's per-batch aux (see submit_with_aux)
        self.done = Completion()


class MicroBatcher:
    """Fuse concurrent predict calls into single device batches.

    run: [N, ...] -> [N, ...] (the served model's padded device call).
    """

    def __init__(
        self,
        run: Callable[[np.ndarray], np.ndarray],
        max_rows: int = 128,
        window_ms: float = 3.0,
        name: str = "default",
    ):
        self._run = run
        self.max_rows = max_rows
        self.window_s = window_ms / 1e3
        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._stop = False
        self._fused = serving_fused_rows_histogram()
        self._name = name
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"microbatch-{name}"
        )
        self._thread.start()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=2)

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Block until this request's rows come back from a fused batch."""
        return self.submit_with_aux(x)[0]

    def submit_with_aux(self, x: np.ndarray):
        """Like submit, additionally returning the aux value the run fn
        reported for the fused batch THIS request rode (None when the run
        fn returns a bare array). The aux rides the same completion event
        as the rows, so a caller never sees another batch's attribution —
        the race that reading shared server state after submit() had."""
        p = _Pending(np.asarray(x))
        with self._cv:
            # the stop check must share the collector's lock: checked
            # outside, a submit racing close() could enqueue after the
            # collector drained its last batch and block forever
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._queue.append(p)
            self._cv.notify_all()
        return p.done.wait()

    # -- collector thread -------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                # collection window: wait for stragglers until the window
                # closes or enough rows arrived to fill the largest bucket
                deadline = time.monotonic() + self.window_s
                while not self._stop:
                    rows = sum(p.x.shape[0] for p in self._queue)
                    remaining = deadline - time.monotonic()
                    if rows >= self.max_rows or remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._queue
                self._queue = []
            if batch:
                self._execute(batch)

    def _execute(self, batch: List[_Pending]) -> None:
        # group by element shape+dtype: one fused call per group
        groups = {}
        for p in batch:
            groups.setdefault((p.x.shape[1:], str(p.x.dtype)), []).append(p)
        for members in groups.values():
            xs = np.concatenate([p.x for p in members], axis=0)
            self._fused.observe(xs.shape[0], model=self._name)
            try:
                out = self._run(xs)
                # run may return (ys, aux): aux (e.g. the device-call
                # latency decomposition) fans out to every member of the
                # fused batch alongside its rows
                ys, aux = out if isinstance(out, tuple) else (out, None)
                off = 0
                for p in members:
                    n = p.x.shape[0]
                    p.done.set((ys[off : off + n], aux))
                    off += n
            except BaseException as e:  # propagate per request
                for p in members:
                    p.done.fail(e)
