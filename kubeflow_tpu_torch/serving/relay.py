"""The serving mesh's program relay: one engine over a gang of processes.

The JAX engine runs the mesh in one process over all its devices. Here
each rank of the mesh (parallel/serving_mesh.py) is a process of its
own, so the engine is split into a leader and its workers:

- **Rank 0** runs the whole engine: the HTTP server, the scheduler, the
  page allocator, the radix prefix index, admission, drain, recovery
  and the host KV tier. Its `EnginePrograms` are wrapped in a
  `ProgramRelay`: every program call (prefill, insert, chunk, cow,
  step, the draft family, verify, spill, upload, the pool resets) is
  broadcast to the other ranks with its host inputs before it runs on
  rank 0.
- **Every other rank** runs `serve_worker`: the same programs over its
  own shard (its blocks of the weights, its heads of the pools), one
  relayed call after another, until rank 0 closes. Each program's
  collectives (the weight gathers, the attention output's gather, the
  expert sums, a spill's page gather) then meet on every rank in the
  same order.

A call's inputs travel on the mesh's gloo `relay` group as one pickled
message: host arrays as they are, a device tensor as its host copy
(the one the engine moved it from, when it came from the host; moved
to the worker's device there), a pool by its role ("pool" or
"draft"), and a value an earlier call returned (a prefill's slot cache,
the draft's proposals) by reference: each rank keeps the results of its
last `KEEP_RESULTS` result-bearing calls, and the reference names the
call and the position in its result. Nothing is sent back: everything
after the attention output's gather is whole on every rank, so rank 0's
own results are the answer. A spill gathers every rank's heads to whole
pages on the ranks themselves.

Every wait in the relay has the relay group's time limit
(`serving_mesh.RELAY_TIMEOUT_S`); rank 0 pings an idle gang every
`HEARTBEAT_S`, so a worker waits out the limit only when rank 0 hangs,
and a dead peer fails the collective at once. A worker whose program
raises ends its process, and the gang with it.

A fault on rank 0 before a call is sent leaves the gang in step, and
the engine recovers as the 1×1 engine does (its pool resets are relayed
calls). A fault once a call is sent (the send itself, or rank 0's own
run of the program) may leave the workers inside the program's
collectives: the relay is then `broken`, refuses every later call and
sends nothing more, and the engine fails for good (serving/engine.py
`_fail_mesh`). Its process exits (serving/main.py), which fails the
workers' collectives and ends the gang.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch.models.gpt import KVPool

# the program calls rank 0 relays (every call that runs a device program
# or writes a pool); `make_pool` / `make_draft_pool` run at build on
# every rank, `heartbeat` and `close` are the relay's own
RELAYED = ("prefill", "insert", "chunk", "cow", "spill", "upload", "step",
           "draft_prefill", "draft_chunk", "draft", "verify", "reset")
# the calls whose results later calls take by reference
RESULT_CALLS = ("prefill", "draft_prefill", "draft")
# results each rank keeps (a prefill's cache is inserted by the next
# call or the one after it, the draft's proposals verified by the next)
KEEP_RESULTS = 4
# keyword arguments that stay on rank 0 (the host tier's arena slots a
# spill writes into)
LOCAL_KWARGS = ("out",)
# an idle rank 0 pings its workers this often (well inside the relay's
# time limit)
HEARTBEAT_S = 10.0


def _send(mesh, msg) -> None:
    torch.distributed.broadcast_object_list([msg], src=0, group=mesh.relay)


def _recv(mesh):
    box = [None]
    torch.distributed.broadcast_object_list(box, src=0, group=mesh.relay)
    return box[0]


def _walk(value, path=()):
    """(path, object) of `value` and of everything its tuples and lists
    hold."""
    yield path, value
    if isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            yield from _walk(v, path + (i,))


def _at(value, path):
    for i in path:
        value = value[i]
    return value


class ProgramRelay:
    """Rank 0's `EnginePrograms` (serving/engine.py), relayed to the
    gang's other ranks (module docstring). Attributes that are not
    program calls read through to the programs."""

    def __init__(self, programs, mesh):
        self._programs = programs
        self._mesh = mesh
        self._pools: Dict[int, str] = {}
        self._seq = 0
        # id of a result object → (seq, path), and each kept call's
        # objects (held, so an id is never reused while registered)
        self._refs: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._held: "OrderedDict[int, list]" = OrderedDict()
        # one relayed call at a time: the scheduler thread makes them,
        # and close()/recovery may run on another
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self.closed = False
        # the fault that left the gang out of step (module docstring)
        self.broken: Optional[BaseException] = None

    def __getattr__(self, name):
        return getattr(self._programs, name)

    @staticmethod
    def build(mesh, geometry: dict) -> None:
        """Hand the workers the engine's geometry (`serve_worker` builds
        its programs from it): the first message of a gang."""
        _send(mesh, (0, "build", geometry, {}))

    def make_pool(self, device) -> KVPool:
        pool = self._programs.make_pool(device)
        self._pools[id(pool)] = "pool"
        return pool

    def make_draft_pool(self, device) -> KVPool:
        pool = self._programs.make_draft_pool(device)
        self._pools[id(pool)] = "draft"
        return pool

    def _encode(self, value):
        if isinstance(value, KVPool):
            return ("P", self._pools[id(value)])
        ref = self._refs.get(id(value))
        if ref is not None:
            return ("R",) + ref
        if isinstance(value, torch.Tensor):
            # a host input moved to the card carries its host copy
            host = getattr(value, "relay_host", None)
            return ("T", value.detach().cpu() if host is None else host,
                    value.device.type != "cpu")
        if isinstance(value, (tuple, list)):
            return ("S", type(value) is tuple,
                    [self._encode(v) for v in value])
        if isinstance(value, dict):
            return ("D", {k: self._encode(v) for k, v in value.items()})
        return ("V", value)

    def _remember(self, seq: int, out) -> None:
        held = []
        for path, obj in _walk(out):
            if obj is None or isinstance(obj, (int, float, bool)):
                continue
            self._refs[id(obj)] = (seq, path)
            held.append(obj)
        self._held[seq] = held
        while len(self._held) > KEEP_RESULTS:
            old_seq, old = self._held.popitem(last=False)
            for obj in old:
                if self._refs.get(id(obj), (None,))[0] == old_seq:
                    del self._refs[id(obj)]

    def _check(self) -> None:
        if self.broken is not None:
            raise RuntimeError(
                "the serving mesh is out of step after a failed relayed "
                f"call: {self.broken!r}") from self.broken
        if self.closed:
            raise RuntimeError("the serving mesh's relay is closed")

    def _sent(self, msg, run=None):
        """Send `msg`, then (`run`) run rank 0's side: a fault in either
        breaks the relay."""
        try:
            _send(self._mesh, msg)
            self._last = time.monotonic()
            return None if run is None else run()
        except BaseException as e:
            self.broken = e
            raise

    def _run(self, name: str, args, kwargs):
        with self._lock:
            self._check()
            self._seq += 1
            seq = self._seq
            sent = {k: v for k, v in kwargs.items() if k not in LOCAL_KWARGS}
            msg = (seq, name, self._encode(tuple(args)), self._encode(sent))
            out = self._sent(
                msg, lambda: getattr(self._programs, name)(*args, **kwargs))
            if name in RESULT_CALLS:
                self._remember(seq, out)
            return out

    def heartbeat(self) -> None:
        """Ping the workers when the gang has been idle for HEARTBEAT_S
        (the scheduler's idle loop calls this)."""
        with self._lock:
            if self.closed or time.monotonic() - self._last < HEARTBEAT_S:
                return
            self._check()
            self._sent((-1, "ping", (), {}))

    def close(self) -> None:
        """End the workers' loops (once; a broken relay sends nothing:
        its workers end when rank 0's process does)."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            self._refs.clear()
            self._held.clear()
            if self.broken is None:
                self._sent((-1, "close", (), {}))


def _relayed(name):
    def call(self, *args, **kwargs):
        return self._run(name, args, kwargs)

    call.__name__ = name
    call.__doc__ = f"`EnginePrograms.{name}`, relayed to every rank."
    return call


for _name in RELAYED:
    setattr(ProgramRelay, _name, _relayed(_name))


class _Worker:
    """A worker rank's side of the relay: decodes each message against
    its own pools, results and device, and runs the call."""

    def __init__(self, programs, device):
        self.programs = programs
        self.device = device
        self.pools = {"pool": programs.make_pool(device),
                      "draft": (programs.make_draft_pool(device)
                                if programs.num_draft_tokens > 0 else None)}
        self.results: "OrderedDict[int, Any]" = OrderedDict()

    def decode(self, value):
        kind = value[0]
        if kind == "P":
            return self.pools[value[1]]
        if kind == "R":
            return _at(self.results[value[1]], value[2])
        if kind == "T":
            return value[1].to(self.device) if value[2] else value[1]
        if kind == "S":
            items = [self.decode(v) for v in value[2]]
            return tuple(items) if value[1] else items
        if kind == "D":
            return {k: self.decode(v) for k, v in value[1].items()}
        return value[1]

    def run(self, seq: int, name: str, args, kwargs) -> None:
        if name not in RELAYED:
            raise ValueError(f"the relay carries no call {name!r}")
        out = getattr(self.programs, name)(*self.decode(args),
                                           **self.decode(kwargs))
        if name in RESULT_CALLS:
            self.results[seq] = out
            while len(self.results) > KEEP_RESULTS:
                self.results.popitem(last=False)


def receive_geometry(mesh) -> dict:
    """A worker's first message: the engine's geometry (`ProgramRelay.
    build`). Raises when rank 0 ended the gang instead (its engine did
    not build)."""
    _, name, geometry, _ = _recv(mesh)
    if name == "close":
        raise RuntimeError("rank 0 of the serving mesh closed the gang "
                           "before its engine was built")
    if name != "build":
        raise RuntimeError(f"serving worker expected the engine's build, "
                           f"got {name!r}")
    return geometry


def run_worker(programs, mesh, device) -> Dict[str, int]:
    """Run rank 0's relayed calls on this rank's `programs` until rank 0
    closes → {call: times run}. Raises on any failure (the gang ends)."""
    worker = _Worker(programs, device)
    calls: Dict[str, int] = {}
    with torch.inference_mode():
        while True:
            seq, name, args, kwargs = _recv(mesh)
            if name == "close":
                return calls
            if name == "ping":
                continue
            worker.run(seq, name, args, kwargs)
            calls[name] = calls.get(name, 0) + 1

