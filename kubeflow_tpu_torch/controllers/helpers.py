"""Shared reconcile helpers — the reconcilehelper equivalent (copy of
kubeflow_tpu/controllers/helpers.py).

The reference factors its create-or-update "apply" primitive and field-copy
diff functions into components/common/reconcilehelper/util.go:18-101 (used by
every controller). Here the StateStore provides apply(); this module adds the
owner-reference wiring, owned-child listing/GC, and the condition-polling
helper the reference's e2e tests are built around
(reference: testing/katib_studyjob_test.py:128-193 wait_for_condition).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from kubeflow_tpu_torch.cluster.objects import is_owned_by, set_owner
from kubeflow_tpu_torch.cluster.store import StateStore


def apply_owned(store: StateStore, owner: Dict[str, Any], obj: Dict[str, Any]) -> Dict[str, Any]:
    """Create-or-update a child object with an ownerReference on it."""
    set_owner(obj, owner)
    return store.apply(obj)


def list_owned(
    store: StateStore,
    owner: Dict[str, Any],
    kind: str,
    namespace: Optional[str] = None,
) -> List[Dict[str, Any]]:
    ns = namespace or owner["metadata"].get("namespace", "default")
    return [o for o in store.list(kind, ns) if is_owned_by(o, owner)]


def delete_owned(
    store: StateStore,
    owner: Dict[str, Any],
    kind: str,
    namespace: Optional[str] = None,
) -> int:
    """Delete all children of `kind` owned by `owner`; returns count deleted."""
    n = 0
    for obj in list_owned(store, owner, kind, namespace):
        m = obj["metadata"]
        try:
            store.delete(kind, m["name"], m["namespace"])
            n += 1
        except KeyError:
            pass
    return n


def ensure_finalizer(obj: Dict[str, Any], finalizer: str) -> bool:
    """Add finalizer if missing; returns True if the object changed."""
    fins = obj["metadata"].setdefault("finalizers", [])
    if finalizer in fins:
        return False
    fins.append(finalizer)
    return True


def remove_finalizer(obj: Dict[str, Any], finalizer: str) -> bool:
    fins = obj["metadata"].get("finalizers") or []
    if finalizer not in fins:
        return False
    fins.remove(finalizer)
    return True


def wait_for_condition(
    store: StateStore,
    kind: str,
    name: str,
    namespace: str,
    condition_type: str,
    timeout_s: float = 30.0,
    poll_s: float = 0.05,
    predicate: Optional[Callable[[Dict[str, Any]], bool]] = None,
) -> Dict[str, Any]:
    """Poll until `condition_type` is True on the object (test/e2e helper).

    Shaped like the reference's wait_for_condition
    (katib_studyjob_test.py:128-193): polls the CR, checks status.conditions,
    raises TimeoutError with the last-seen object on expiry.
    """
    deadline = time.monotonic() + timeout_s
    last: Optional[Dict[str, Any]] = None
    while time.monotonic() < deadline:
        last = store.try_get(kind, name, namespace)
        if last is not None:
            for c in last.get("status", {}).get("conditions", []):
                if c.get("type") == condition_type and c.get("status") == "True":
                    if predicate is None or predicate(last):
                        return last
        time.sleep(poll_s)
    raise TimeoutError(
        f"{kind} {namespace}/{name} never reached condition "
        f"{condition_type}; last status: {(last or {}).get('status')}"
    )
