"""Controller runtime: watch → workqueue → level-triggered reconcile (copy
of kubeflow_tpu/cluster/reconciler.py).

Reimplements the controller-runtime contract the reference's Go controllers
are built on (reference: components/notebook-controller/controllers/
notebook_controller.go:81 Reconcile, :512-606 SetupWithManager watch wiring):

- level-triggered: reconcile observes current state, never the event payload,
- one reconcile in flight per key (controller-runtime's guarantee the
  reference leans on for concurrency safety — SURVEY.md §5 race detection),
- Result{requeue_after} for periodic work (the culling loop idiom,
  reference: notebook_controller.go:229-247),
- error → exponential backoff requeue,
- `run_until_idle()` drains the queue deterministically for hermetic tests
  (no real cluster, SURVEY.md §4 implication).
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Set, Tuple

from kubeflow_tpu_torch.cluster.store import StateStore, WatchEvent
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import default_registry

log = get_logger(__name__)

ReconcileKey = Tuple[str, str]  # (namespace, name)


@dataclasses.dataclass
class Result:
    requeue: bool = False
    requeue_after_s: Optional[float] = None


class Controller:
    """Base class: subclass and implement `reconcile(store, namespace, name)`.

    `kind` is the primary watched kind; `watches` maps secondary kinds to a
    key-mapping function (event object → list of primary keys to enqueue),
    mirroring the reference's Owns()/Watches() wiring.
    """

    kind: str = ""
    name: str = "controller"

    def __init__(self) -> None:
        self.watches: Dict[str, Callable[[dict], List[ReconcileKey]]] = {}

    def reconcile(self, store: StateStore, namespace: str, name: str) -> Result:
        raise NotImplementedError

    def map_owned(self, obj: dict) -> List[ReconcileKey]:
        """Default secondary-kind mapper: follow ownerReferences of our kind."""
        keys = []
        ns = obj.get("metadata", {}).get("namespace", "default")
        for ref in obj.get("metadata", {}).get("ownerReferences", []):
            if ref.get("kind") == self.kind:
                keys.append((ns, ref["name"]))
        return keys


class _Workqueue:
    """Deduplicating delayed workqueue with per-key in-flight exclusion."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._ready: List[ReconcileKey] = []
        self._ready_set: Set[ReconcileKey] = set()
        self._delayed: List[Tuple[float, int, ReconcileKey]] = []
        self._seq = 0
        self._in_flight: Set[ReconcileKey] = set()
        self._redo: Set[ReconcileKey] = set()

    def add(self, key: ReconcileKey, delay_s: float = 0.0) -> None:
        with self._lock:
            if delay_s > 0:
                self._seq += 1
                heapq.heappush(
                    self._delayed, (time.monotonic() + delay_s, self._seq, key)
                )
            elif key in self._in_flight:
                # re-enqueue when current reconcile finishes (dedup while
                # running, but never lose a level change)
                self._redo.add(key)
            elif key not in self._ready_set:
                self._ready.append(key)
                self._ready_set.add(key)
            self._lock.notify_all()

    def _promote_delayed(self) -> Optional[float]:
        now = time.monotonic()
        next_at = None
        while self._delayed and self._delayed[0][0] <= now:
            _, _, key = heapq.heappop(self._delayed)
            if key in self._in_flight:
                self._redo.add(key)
            elif key not in self._ready_set:
                self._ready.append(key)
                self._ready_set.add(key)
        if self._delayed:
            next_at = self._delayed[0][0]
        return next_at

    def get(self, timeout: Optional[float] = None) -> Optional[ReconcileKey]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                next_at = self._promote_delayed()
                if self._ready:
                    key = self._ready.pop(0)
                    self._ready_set.discard(key)
                    self._in_flight.add(key)
                    return key
                waits = []
                if deadline is not None:
                    waits.append(deadline - time.monotonic())
                if next_at is not None:
                    waits.append(next_at - time.monotonic())
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                self._lock.wait(timeout=min(waits) if waits else None)

    def next_deadline(self) -> Optional[float]:
        """Monotonic time of the earliest delayed item, or None."""
        with self._lock:
            return self._delayed[0][0] if self._delayed else None

    def done(self, key: ReconcileKey) -> None:
        with self._lock:
            self._in_flight.discard(key)
            if key in self._redo:
                self._redo.discard(key)
                if key not in self._ready_set:
                    self._ready.append(key)
                    self._ready_set.add(key)
            self._lock.notify_all()

    def idle(self) -> bool:
        with self._lock:
            self._promote_delayed()
            return not self._ready and not self._in_flight and not self._redo

    def pending_delayed(self) -> int:
        with self._lock:
            return len(self._delayed)


class ControllerManager:
    """Runs a set of controllers against one StateStore."""

    def __init__(self, store: StateStore) -> None:
        self.store = store
        self._controllers: List[Tuple[Controller, _Workqueue]] = []
        self._threads: List[threading.Thread] = []
        self._watch_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._watch = None
        reg = default_registry()
        self._reconcile_total = reg.counter(
            "reconcile_total", "reconcile invocations", ["controller", "outcome"]
        )
        self._reconcile_seconds = reg.histogram(
            "reconcile_seconds", "reconcile latency", ["controller"]
        )
        self._backoff: Dict[Tuple[str, ReconcileKey], float] = {}

    def register(self, controller: Controller) -> None:
        self._controllers.append((controller, _Workqueue()))

    def _dispatch_event(self, ev: WatchEvent) -> None:
        obj = ev.object
        kind = obj.get("kind")
        ns = obj.get("metadata", {}).get("namespace", "default")
        name = obj.get("metadata", {}).get("name", "")
        for controller, q in self._controllers:
            if kind == controller.kind:
                q.add((ns, name))
            elif kind in controller.watches:
                for key in controller.watches[kind](obj):
                    q.add(key)

    def _process_one(self, controller: Controller, q: _Workqueue, key) -> None:
        ns, name = key
        bkey = (controller.name, key)
        try:
            with self._reconcile_seconds.time(controller=controller.name):
                result = controller.reconcile(self.store, ns, name)
            self._backoff.pop(bkey, None)
            outcome = "ok"
            if result is None:
                result = Result()
            if result.requeue_after_s is not None:
                q.add(key, delay_s=result.requeue_after_s)
            elif result.requeue:
                q.add(key, delay_s=0.01)
        except Exception:
            delay = min(30.0, self._backoff.get(bkey, 0.02) * 2)
            self._backoff[bkey] = delay
            outcome = "error"
            log.error(
                "reconcile %s %s/%s failed (retry in %.2fs):\n%s",
                controller.name,
                ns,
                name,
                delay,
                traceback.format_exc(),
            )
            q.add(key, delay_s=delay)
        finally:
            q.done(key)
        self._reconcile_total.inc(controller=controller.name, outcome=outcome)

    # -- deterministic mode (tests) --------------------------------------

    def enqueue_all(self) -> None:
        for controller, q in self._controllers:
            for obj in self.store.list(controller.kind):
                m = obj["metadata"]
                q.add((m.get("namespace", "default"), m["name"]))

    def run_until_idle(self, max_seconds: float = 30.0, settle_rounds: int = 3) -> None:
        """Synchronously drain all queues, feeding watch events between
        reconciles, until nothing is pending. Deterministic single-thread."""
        watch = self.store.watch()
        try:
            self.enqueue_all()
            deadline = time.monotonic() + max_seconds
            idle_rounds = 0
            while time.monotonic() < deadline:
                # drain pending watch events into queues
                while True:
                    try:
                        ev = watch.q.get_nowait()
                    except Exception:
                        break
                    self._dispatch_event(ev)
                progressed = False
                for controller, q in self._controllers:
                    key = None
                    if not q.idle():
                        key = q.get(timeout=0)
                    if key is not None:
                        progressed = True
                        self._process_one(controller, q, key)
                if progressed:
                    idle_rounds = 0
                    continue
                # nothing ready; are delayed items pending soon?
                soonest = None
                for _, q in self._controllers:
                    at = q.next_deadline()
                    if at is not None:
                        soonest = at if soonest is None else min(soonest, at)
                if soonest is not None and soonest - time.monotonic() < 0.25:
                    time.sleep(max(0.0, soonest - time.monotonic()))
                    continue
                idle_rounds += 1
                if idle_rounds >= settle_rounds:
                    return
                time.sleep(0.005)
        finally:
            self.store.close_watch(watch)

    # -- background mode -------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._watch = self.store.watch()

        def watch_loop():
            for ev in self._watch.stream(timeout=0.1):
                if self._stop.is_set():
                    return
                self._dispatch_event(ev)
                if self._stop.is_set():
                    return

        def watch_loop_forever():
            while not self._stop.is_set():
                watch_loop()

        self._watch_thread = threading.Thread(
            target=watch_loop_forever, daemon=True, name="cm-watch"
        )
        self._watch_thread.start()
        for controller, q in self._controllers:

            def worker(controller=controller, q=q):
                while not self._stop.is_set():
                    key = q.get(timeout=0.1)
                    if key is None:
                        continue
                    self._process_one(controller, q, key)

            t = threading.Thread(
                target=worker, daemon=True, name=f"cm-{controller.name}"
            )
            t.start()
            self._threads.append(t)
        self.enqueue_all()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self.store.close_watch(self._watch)
        for t in self._threads:
            t.join(timeout=2)
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=2)
        self._threads.clear()
