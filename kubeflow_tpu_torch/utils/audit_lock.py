"""Runtime lock-order sanitizer (copy of the part of
kubeflow_tpu/utils/audit_lock.py the fleet collector reaches: the
recorder, `AuditLock` and its `audit_lock` factory).

Product modules construct their locks through `audit_lock(name)`.
Disarmed (the default) every wrapper method is one bool check plus a
delegate call into the real `threading.Lock`. Armed
(``default_auditor().enable()``), every acquisition:

- checks for SELF-DEADLOCK: re-acquiring a lock already held by this
  thread would block forever, so the auditor raises ``LockAuditError``
  at the call site instead of hanging;
- records an ORDER EDGE ``held -> acquired`` for every distinct lock the
  thread already holds, with a witness (thread name + held stack), into
  a process-global graph (`observed_edges()`).

Lock names follow the reference's ``ClassName._attr`` format (the
collector's lock is ``FleetCollector._lock`` in both packages).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class LockAuditError(RuntimeError):
    """A would-be deadlock caught at the acquisition site."""


class LockAuditor:
    """Process-global recorder of real lock-acquisition order.

    Thread-compatible by construction: the per-thread held stack lives in
    a ``threading.local`` (no sharing), and the shared edge/violation
    tables are guarded by a plain internal mutex that is only ever taken
    as the innermost lock (the auditor acquires nothing else while
    holding it, so it can never participate in an ordering cycle).
    """

    def __init__(self) -> None:
        self.enabled = False
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], str] = {}
        self._violations: List[str] = []

    # -- arming ------------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- recording (called by the wrappers, only when enabled) -------------

    def _stack(self) -> List[str]:
        try:
            return self._tls.stack
        except AttributeError:
            st: List[str] = []
            self._tls.stack = st
            return st

    def pre_acquire(self, name: str, reentrant: bool) -> None:
        """Self-deadlock check — runs BEFORE the blocking acquire so the
        failure is a raise at the call site, not a hung worker."""
        if not reentrant and name in self._stack():
            msg = (
                f"self-deadlock: thread {threading.current_thread().name!r} "
                f"re-acquired non-reentrant {name} while holding "
                f"{self._stack()!r}"
            )
            with self._mu:
                self._violations.append(msg)
            raise LockAuditError(msg)

    def note_acquired(self, name: str) -> None:
        stack = self._stack()
        if stack:
            witness = (
                f"thread {threading.current_thread().name!r} held "
                f"{stack!r} then took {name}"
            )
            with self._mu:
                for held in stack:
                    if held != name:
                        self._edges.setdefault((held, name), witness)
        stack.append(name)

    def note_released(self, name: str) -> None:
        stack = self._stack()
        # remove the LAST occurrence: reentrant locks nest
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- queries -------------------------------------------------------------

    def violations(self) -> List[str]:
        with self._mu:
            return list(self._violations)

    def observed_edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

_AUDITOR = LockAuditor()


def default_auditor() -> LockAuditor:
    return _AUDITOR


class AuditLock:
    """Drop-in for ``threading.Lock`` with order auditing. Disarmed cost:
    one bool read + delegation."""

    _reentrant = False

    def __init__(self, name: str,
                 auditor: Optional[LockAuditor] = None) -> None:
        self.name = name
        self._auditor = auditor if auditor is not None else _AUDITOR
        self._inner = self._make_inner()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        a = self._auditor
        if not a.enabled:
            return self._inner.acquire(blocking, timeout)
        a.pre_acquire(self.name, self._reentrant)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            a.note_acquired(self.name)
        return ok

    def release(self) -> None:
        a = self._auditor
        if a.enabled:
            a.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "AuditLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


# -- factory ------------------------------------------------------------------


def audit_lock(name: str) -> AuditLock:
    return AuditLock(name)
