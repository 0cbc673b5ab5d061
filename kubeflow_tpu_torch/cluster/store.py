"""In-memory cluster state store — the k8s-API-shaped heart of the testable
control plane (copy of kubeflow_tpu/cluster/store.py; its write counter is
in the port's own metrics registry).

The reference's controllers talk to a real k8s API server and are unit-tested
against controller-runtime's fake client (reference:
components/notebook-controller/controllers/notebook_controller_test.go:73-86
uses fake.NewFakeClientWithScheme; SURVEY.md §4 T1). This store is that fake
client promoted to a first-class component: CRUD + optimistic concurrency
(resourceVersion), label selectors, finalizer-aware deletion, and watch
streams — enough API-server semantics that every controller in this package
runs unmodified against it, and a thin adapter can point the same controllers
at a real cluster.

Thread-safe; watches deliver events in write order per object.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from kubeflow_tpu_torch.cluster.objects import fresh_uid, matches_selector, now_iso
from kubeflow_tpu_torch.utils.metrics import default_registry


class NotFound(KeyError):
    pass


class Conflict(RuntimeError):
    """resourceVersion mismatch (optimistic concurrency failure)."""


class AlreadyExists(RuntimeError):
    pass


class AdmissionDenied(RuntimeError):
    """Raised by an admission hook to reject an object create."""


Key = Tuple[str, str, str]  # (kind, namespace, name)


class WatchEvent:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"

    __slots__ = ("type", "object")

    def __init__(self, type: str, object: Dict[str, Any]):
        self.type = type
        self.object = object

    def __repr__(self) -> str:
        m = self.object.get("metadata", {})
        return (
            f"WatchEvent({self.type}, {self.object.get('kind')} "
            f"{m.get('namespace')}/{m.get('name')})"
        )


class _Watch:
    def __init__(self, kind: Optional[str], namespace: Optional[str]):
        self.kind = kind
        self.namespace = namespace
        self.q: "queue.Queue[WatchEvent]" = queue.Queue()
        self.closed = False

    def matches(self, obj: Dict[str, Any]) -> bool:
        if self.kind is not None and obj.get("kind") != self.kind:
            return False
        if (
            self.namespace is not None
            and obj.get("metadata", {}).get("namespace") != self.namespace
        ):
            return False
        return True

    def stream(self, timeout: Optional[float] = None) -> Iterator[WatchEvent]:
        while not self.closed:
            try:
                yield self.q.get(timeout=timeout)
            except queue.Empty:
                return


class StateStore:
    def __init__(self) -> None:
        self._objects: Dict[Key, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._rv_counter = 0
        self._watches: List[_Watch] = []
        # Mutating-admission hooks by kind, run on create before persist —
        # the interception point the reference implements as a webhook server
        # (reference: components/admission-webhook/main.go:389 mutatePods).
        self._admission_hooks: Dict[str, List[Callable[[Dict[str, Any]], None]]] = {}
        # Normalizers by kind, run on EVERY write path (create, update,
        # apply) — the conversion-webhook interception for multi-version
        # CRDs (cluster/versions.py): a spoke-version payload converts to
        # the storage version no matter which verb carried it.
        self._normalizers: Dict[str, List[Callable[[Dict[str, Any]], None]]] = {}
        reg = default_registry()
        self._writes = reg.counter(
            "statestore_writes_total", "writes", ["kind", "op"]
        )

    def add_admission_hook(
        self, kind: str, hook: Callable[[Dict[str, Any]], None]
    ) -> None:
        """Register a mutating hook invoked on every create of `kind`.

        The hook mutates the object in place; raising AdmissionDenied rejects
        the create (the webhook allowed/denied contract)."""
        with self._lock:
            self._admission_hooks.setdefault(kind, []).append(hook)

    def add_normalizer(
        self, kind: str, fn: Callable[[Dict[str, Any]], None]
    ) -> None:
        """Register a write normalizer for `kind`, run on create, update,
        AND apply — unlike admission hooks (create-only). Raising rejects
        the write."""
        with self._lock:
            self._normalizers.setdefault(kind, []).append(fn)

    def _normalize(self, obj: Dict[str, Any]) -> None:
        # snapshot under the lock (add_normalizer appends concurrently);
        # the callbacks themselves run OUTSIDE it — a conversion hook must
        # not serialize every write path behind user code
        with self._lock:
            fns = list(self._normalizers.get(obj.get("kind", ""), []))
        for fn in fns:
            fn(obj)

    # -- internals -------------------------------------------------------

    def _next_rv(self) -> str:
        self._rv_counter += 1
        return str(self._rv_counter)

    def _emit(self, event_type: str, obj: Dict[str, Any]) -> None:
        for w in self._watches:
            if not w.closed and w.matches(obj):
                w.q.put(WatchEvent(event_type, copy.deepcopy(obj)))

    @staticmethod
    def _key(kind: str, namespace: str, name: str) -> Key:
        return (kind, namespace, name)

    # -- CRUD ------------------------------------------------------------

    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        obj = copy.deepcopy(obj)
        self._normalize(obj)
        m = obj.setdefault("metadata", {})
        kind = obj["kind"]
        namespace = m.setdefault("namespace", "default")
        name = m["name"]
        with self._lock:
            key = self._key(kind, namespace, name)
            if key in self._objects:
                raise AlreadyExists(f"{kind} {namespace}/{name} exists")
            for hook in self._admission_hooks.get(kind, []):
                hook(obj)
            m["uid"] = m.get("uid") or fresh_uid()
            m["resourceVersion"] = self._next_rv()
            m["creationTimestamp"] = now_iso()
            self._objects[key] = obj
            self._writes.inc(kind=kind, op="create")
            self._emit(WatchEvent.ADDED, obj)
            return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> Dict[str, Any]:
        with self._lock:
            key = self._key(kind, namespace, name)
            if key not in self._objects:
                raise NotFound(f"{kind} {namespace}/{name}")
            return copy.deepcopy(self._objects[key])

    def try_get(
        self, kind: str, name: str, namespace: str = "default"
    ) -> Optional[Dict[str, Any]]:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Full-object update with optimistic concurrency.

        The caller's resourceVersion must match the stored one (the reference
        relies on the same apiserver semantic for its create-or-update
        reconcile idiom, reference: components/common/reconcilehelper/
        util.go:18-101).
        """
        obj = copy.deepcopy(obj)
        self._normalize(obj)
        m = obj["metadata"]
        kind = obj["kind"]
        namespace = m.get("namespace", "default")
        name = m["name"]
        with self._lock:
            key = self._key(kind, namespace, name)
            if key not in self._objects:
                raise NotFound(f"{kind} {namespace}/{name}")
            stored = self._objects[key]
            if (
                m.get("resourceVersion")
                and m["resourceVersion"] != stored["metadata"]["resourceVersion"]
            ):
                raise Conflict(
                    f"{kind} {namespace}/{name}: resourceVersion "
                    f"{m['resourceVersion']} != {stored['metadata']['resourceVersion']}"
                )
            m["uid"] = stored["metadata"]["uid"]
            m["creationTimestamp"] = stored["metadata"]["creationTimestamp"]
            m["resourceVersion"] = self._next_rv()
            self._objects[key] = obj
            self._writes.inc(kind=kind, op="update")
            self._emit(WatchEvent.MODIFIED, obj)
            # Finalizer-aware deletion: a pending delete completes once the
            # last finalizer is removed.
            if m.get("deletionTimestamp") and not m.get("finalizers"):
                self._finalize_delete(key)
            return copy.deepcopy(self._objects.get(key, obj))

    def patch_status(
        self, kind: str, name: str, namespace: str, status: Dict[str, Any]
    ) -> Dict[str, Any]:
        with self._lock:
            obj = self.get(kind, name, namespace)
            obj["status"] = copy.deepcopy(status)
            obj["metadata"]["resourceVersion"] = ""  # skip conflict check
            return self.update(obj)

    def _finalize_delete(self, key: Key) -> None:
        obj = self._objects.pop(key, None)
        if obj is not None:
            self._writes.inc(kind=obj["kind"], op="delete")
            self._emit(WatchEvent.DELETED, obj)
            self._cascade_delete(obj)

    def _cascade_delete(self, owner: Dict[str, Any]) -> None:
        """ownerReference garbage collection (the k8s GC controller): when an
        owner goes away, its children follow — recursively, through the
        normal delete path so finalizers still gate each object."""
        uid = owner.get("metadata", {}).get("uid")
        if not uid:
            return
        orphans = [
            (k, ns, n)
            for (k, ns, n), obj in list(self._objects.items())
            if any(
                ref.get("uid") == uid
                for ref in obj.get("metadata", {}).get("ownerReferences", [])
            )
        ]
        for kind, ns, n in orphans:
            try:
                self.delete(kind, n, ns)
            except NotFound:
                pass

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._lock:
            key = self._key(kind, namespace, name)
            if key not in self._objects:
                raise NotFound(f"{kind} {namespace}/{name}")
            obj = self._objects[key]
            finalizers = obj["metadata"].get("finalizers") or []
            if finalizers:
                if not obj["metadata"].get("deletionTimestamp"):
                    obj["metadata"]["deletionTimestamp"] = now_iso()
                    obj["metadata"]["resourceVersion"] = self._next_rv()
                    self._emit(WatchEvent.MODIFIED, obj)
                return
            self._finalize_delete(key)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for (k, ns, _), obj in sorted(self._objects.items()):
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and not matches_selector(obj, label_selector):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def namespaces(self) -> List[str]:
        return [o["metadata"]["name"] for o in self.list("Namespace")]

    # -- watch -----------------------------------------------------------

    def watch(
        self, kind: Optional[str] = None, namespace: Optional[str] = None
    ) -> _Watch:
        w = _Watch(kind, namespace)
        with self._lock:
            self._watches.append(w)
        return w

    def close_watch(self, w: _Watch) -> None:
        with self._lock:
            w.closed = True
            if w in self._watches:
                self._watches.remove(w)

    # -- convenience -----------------------------------------------------

    def apply(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Create-or-update (server-side-apply-lite): the universal reconcile
        primitive (reference: reconcilehelper/util.go:18-46 Deployment/Service
        create-or-copy-fields)."""
        # normalize BEFORE the merge: an apply carrying a spoke-version
        # payload must convert to the storage schema, or its spec would
        # silently overwrite the hub-shaped stored spec
        obj = copy.deepcopy(obj)
        self._normalize(obj)
        m = obj.get("metadata", {})
        existing = self.try_get(
            obj["kind"], m.get("name", ""), m.get("namespace", "default")
        )
        if existing is None:
            return self.create(obj)
        merged = copy.deepcopy(existing)
        merged["spec"] = copy.deepcopy(obj.get("spec", {}))
        for field in ("labels", "annotations", "ownerReferences", "finalizers"):
            if field in m:
                merged["metadata"][field] = copy.deepcopy(m[field])
        if merged == existing:
            # no-op apply: don't churn resourceVersion or wake watchers
            return existing
        return self.update(merged)

    def record_event(
        self,
        involved: Dict[str, Any],
        reason: str,
        message: str,
        type: str = "Normal",
    ) -> Dict[str, Any]:
        """k8s-style Event object tied to an involved object (the reference
        mirrors Events into notebook status, reference:
        notebook_controller.go:85-106)."""
        im = involved["metadata"]
        name = f"{im['name']}.{fresh_uid()[:8]}"
        ev = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": im.get("namespace", "default")},
            "involvedObject": {
                "kind": involved["kind"],
                "name": im["name"],
                "namespace": im.get("namespace", "default"),
                "uid": im.get("uid", ""),
            },
            "reason": reason,
            "message": message,
            "type": type,
            "lastTimestamp": now_iso(),
            "spec": {},
            "status": {},
        }
        return self.create(ev)

    def events_for(self, involved: Dict[str, Any]) -> List[Dict[str, Any]]:
        uid = involved["metadata"].get("uid")
        name = involved["metadata"]["name"]
        out = []
        for ev in self.list("Event", involved["metadata"].get("namespace", "default")):
            io = ev.get("involvedObject", {})
            if io.get("uid") == uid or io.get("name") == name:
                out.append(ev)
        return out
