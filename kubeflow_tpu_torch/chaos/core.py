"""kft-chaos — deterministic, named fault-injection points (copy of
kubeflow_tpu/chaos/core.py: the same catalog, grammar and per-point
random streams, so one plan fires on the same calls in both packages).

The platform's failure semantics (whole-gang restart with checkpoint
resume, engine scheduler recovery, fleet scrape degradation) are only
trustworthy if failures can be MADE to happen on demand, bitwise
reproducibly, in the exact seams production faults land in. This module
is that lever:

- **Named injection points** (`CATALOG`): a small registry of seams the
  platform's own code calls through — `chaos.maybe_fail("engine.step")`
  costs one attribute read and one bool check when chaos is disarmed
  (the shared-no-op discipline of the disabled tracer,
  observability/trace.py), and raises `ChaosError` when an armed plan
  says this call fails.
- **Deterministic plans**: each armed point carries `p=<prob>` /
  `after=<n>` / `once` / `attempt=<n>` semantics with a per-point RNG
  seeded from (seed, point name) — the SAME plan against the SAME call
  sequence injects the SAME faults, so every chaos test replays bitwise
  and a flake under chaos is a real bug, not injection noise.
- **The knob chain**: ChaosConfig (config/platform.py) → controller-
  rendered `KFT_CHAOS_POINTS` / `KFT_CHAOS_SEED` / `KFT_CHAOS_ATTEMPT`
  env → `configure_from_env()` in the entrypoints (runtime/train_run.py,
  serving/main.py), exactly like every other platform knob family (the
  port's GPUTrainJob controller, controllers/gpujob.py, renders it).
  `attempt=N` pins a point to one gang incarnation (the TPUJob
  controller renders the generation counter as KFT_CHAOS_ATTEMPT), which
  is what lets "kill the host once, mid-training" be expressed as config
  instead of test scaffolding.

Point spec grammar (one entry per point, `;`-separated in the env var):

    <point>[:qualifier[,qualifier...]]
    qualifiers: p=<float 0..1>   fire with this probability per call
                after=<int>      skip the first N calls of this point
                once             fire at most once, then go inert
                attempt=<int>    fire only in this gang incarnation

A bare `<point>` fires on every call (p=1). Unknown point names are
rejected at parse time — a typo'd point would otherwise arm nothing and
silently never fire (the same fail-at-config-time discipline as SLO
rules).
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, List, Optional, Sequence

from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# The env contract rendered by the controllers (controllers/tpujob.py,
# controllers/inference.py) and consumed here via configure_from_env().
ENV_CHAOS_POINTS = "KFT_CHAOS_POINTS"
ENV_CHAOS_SEED = "KFT_CHAOS_SEED"
# The gang incarnation this process runs as (the GPUTrainJob controller renders
# its generation counter; absent = 0): `attempt=N` specs fire only when
# they match, so a fault can target exactly one gang generation — the
# restarted/reshaped gang re-arms the same plan but its incarnation has
# moved on, and the fault stays behind.
ENV_CHAOS_ATTEMPT = "KFT_CHAOS_ATTEMPT"

# The injection-point registry: every seam the platform calls
# maybe_fail() through, with what a fault there simulates
# (docs/ROBUSTNESS.md carries the operator-facing version of this table).
CATALOG: Dict[str, str] = {
    "gang.host_exit": (
        "gang host dies at launch, before training starts (pod-level "
        "crash; the controller observes a Failed pod)"
    ),
    "trainer.device_step": (
        "device step fails mid-training (XLA abort / host losing its "
        "chips) — the canonical host-death-mid-run fault"
    ),
    "checkpoint.shard_write": (
        "transient I/O fault writing one checkpoint shard file "
        "(network volume hiccup); retried with backoff"
    ),
    "checkpoint.commit": (
        "transient I/O fault at the manifest commit rename; retried "
        "with backoff — a persistent fault leaves the step uncommitted, "
        "never torn"
    ),
    "checkpoint.restore": (
        "transient I/O fault assembling a restore from shard files; "
        "retried with backoff"
    ),
    "engine.prefill": (
        "device failure during one request's admission (prefill/insert "
        "path) — fails that request, engine keeps serving"
    ),
    "engine.step": (
        "device failure in the decode iteration — the scheduler's "
        "_recover path must fail residents fast and keep serving"
    ),
    "fleet.scrape_fetch": (
        "a fleet metrics scrape fetch fails (unreachable pod, partition)"
        " — the sweep must degrade per-target, never die"
    ),
}


class ChaosError(RuntimeError):
    """The injected fault. Deliberately a RuntimeError: the seams under
    test must handle it through their GENERIC failure paths (engine
    _recover, pod Failed, scrape error) — a dedicated except branch for
    chaos would test nothing."""

    def __init__(self, point: str):
        super().__init__(f"chaos: injected fault at {point!r}")
        self.point = point


class ChaosSpecError(ValueError):
    """Unparseable or unknown point spec (config-time rejection)."""


@dataclasses.dataclass(frozen=True)
class PointSpec:
    """One armed injection point's firing rule."""

    point: str
    probability: float = 1.0    # p=<float>: per-call fire probability
    after: int = 0              # skip the first N calls of this point
    once: bool = False          # at most one fault, then inert
    attempt: Optional[int] = None  # fire only in this gang incarnation

    def spec_str(self) -> str:
        quals: List[str] = []
        if self.probability < 1.0:
            quals.append(f"p={self.probability:g}")
        if self.after:
            quals.append(f"after={self.after}")
        if self.once:
            quals.append("once")
        if self.attempt is not None:
            quals.append(f"attempt={self.attempt}")
        return self.point + (":" + ",".join(quals) if quals else "")


def parse_point(entry: str) -> PointSpec:
    entry = entry.strip()
    if not entry:
        raise ChaosSpecError("empty chaos point entry")
    point, _, qualstr = entry.partition(":")
    point = point.strip()
    if point not in CATALOG:
        raise ChaosSpecError(
            f"unknown chaos point {point!r}; known: {sorted(CATALOG)}"
        )
    prob, after, once, attempt = 1.0, 0, False, None
    for raw in filter(None, (q.strip() for q in qualstr.split(","))):
        key, _, val = raw.partition("=")
        try:
            if key == "p":
                prob = float(val)
                if not 0.0 < prob <= 1.0:
                    raise ValueError
            elif key == "after":
                after = int(val)
                if after < 0:
                    raise ValueError
            elif key == "once":
                if val:
                    raise ValueError
                once = True
            elif key == "attempt":
                attempt = int(val)
                if attempt < 0:
                    raise ValueError
            else:
                raise ValueError
        except ValueError:
            raise ChaosSpecError(
                f"bad chaos qualifier {raw!r} in {entry!r} (grammar: "
                f"p=<prob in (0,1]> | after=<calls to skip> | once | "
                f"attempt=<gang incarnation>)"
            ) from None
    return PointSpec(point, prob, after, once, attempt)


def parse_points(entries: Sequence[str]) -> List[PointSpec]:
    """Parse a ChaosConfig.points list (or one `;`-joined env string
    split by the caller). Duplicate points are rejected — two rules for
    one seam have no defined composition."""
    specs = [parse_point(e) for e in entries]
    seen: Dict[str, str] = {}
    for s in specs:
        if s.point in seen:
            raise ChaosSpecError(f"duplicate chaos point {s.point!r}")
        seen[s.point] = s.point
    return specs


class _PointState:
    __slots__ = ("spec", "calls", "fired", "rng")

    def __init__(self, spec: PointSpec, seed: int):
        self.spec = spec
        self.calls = 0
        self.fired = 0
        # process-stable determinism: Random(str) seeds from the string
        # BYTES (not hash()), so the same (seed, point) always draws the
        # same uniform sequence in any process
        self.rng = random.Random(f"{seed}:{spec.point}")


class ChaosController:
    """The armed (or disarmed) fault plan for one process.

    `enabled` is a bare bool read lock-free on the hot path — a disarmed
    controller's `maybe_fail` is one attribute read and one branch, the
    same shared-no-op discipline as the disabled tracer. All armed-path
    state (call counters, per-point RNGs) is mutated under `_lock`:
    maybe_fail is called from scheduler threads, checkpoint writers and
    request handlers alike, and the deterministic call-count semantics
    need a consistent sequence.
    """

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._states: Dict[str, _PointState] = {}
        self._seed = 0
        self._attempt = 0
        self._faults = None  # metric bound lazily on first arm

    # -- arming ------------------------------------------------------------

    def arm(
        self,
        specs: Sequence[PointSpec],
        seed: int = 0,
        attempt: int = 0,
    ) -> None:
        """Install a fault plan. Specs pinned to another incarnation
        (`attempt=` mismatch) are dropped here — they are part of the
        plan but inert in this process. Arming replaces any previous
        plan (counters restart: determinism is per arming)."""
        from kubeflow_tpu_torch.utils.metrics import faults_injected_counter

        active = [
            s for s in specs if s.attempt is None or s.attempt == int(attempt)
        ]
        with self._lock:
            self._seed = int(seed)
            self._attempt = int(attempt)
            self._states = {s.point: _PointState(s, int(seed)) for s in active}
            if self._faults is None:
                self._faults = faults_injected_counter()
        # flipped LAST: a maybe_fail racing the arm sees either the old
        # plan or the complete new one, never a half-built table
        self.enabled = bool(active)

    def disarm(self) -> None:
        self.enabled = False
        with self._lock:
            self._states = {}

    def armed_points(self) -> List[str]:
        with self._lock:
            return sorted(self._states)

    # -- the injection point ----------------------------------------------

    def maybe_fail(self, point: str) -> None:
        """The seam call. Disarmed: a shared no-op (bool check, return).
        Armed: advance this point's deterministic call state and raise
        ChaosError when the plan says this call fails."""
        if not self.enabled:
            return
        with self._lock:
            st = self._states.get(point)
            if st is None:
                return
            st.calls += 1
            spec = st.spec
            if spec.once and st.fired:
                return
            if st.calls <= spec.after:
                return
            # the uniform is drawn even when p == 1 so adding/removing
            # a probability does not shift the point's later draws
            if st.rng.random() >= spec.probability:
                return
            st.fired += 1
            faults = self._faults
        if faults is not None:
            faults.inc(point=point)
        from kubeflow_tpu_torch.observability.trace import default_tracer

        default_tracer().event("chaos.fault", point=point)
        log.warning("chaos: injecting fault at %s", point)
        raise ChaosError(point)


_default = ChaosController()


def default_chaos() -> ChaosController:
    """The process-wide controller every seam calls through (the
    default_tracer() idiom: call sites bind it once at construction)."""
    return _default


def configure_from_env(environ=None) -> bool:
    """Arm (or disarm) the default controller from the controller-
    rendered KFT_CHAOS_* env. Returns True when a plan was armed. An
    empty/absent KFT_CHAOS_POINTS DISARMS — the env is the whole truth,
    so a simulated pod without chaos can never inherit a previous run's
    plan (the compile-cache env-wins discipline)."""
    import os

    env = os.environ if environ is None else environ
    raw = env.get(ENV_CHAOS_POINTS, "").strip()
    ctrl = default_chaos()
    if not raw:
        ctrl.disarm()
        return False
    specs = parse_points([e for e in raw.split(";") if e.strip()])
    seed = int(env.get(ENV_CHAOS_SEED, "0") or 0)
    attempt = int(env.get(ENV_CHAOS_ATTEMPT, "0") or 0)
    ctrl.arm(specs, seed=seed, attempt=attempt)
    return ctrl.enabled
