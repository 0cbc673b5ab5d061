"""Pod executor — the kubelet analog driving Pods through their phases
(port of kubeflow_tpu/runtime/executor.py).

- `FakePodRunner` — deterministic phase walk Pending→Running→Succeeded (or a
  scripted failure), for control-plane tests: gang semantics, restarts,
  conditions.
- `InProcessTrainerRunner` — runs the pod's job in this process: reads the
  pod's KFT_* env, runs `run_training` with that env (the controller's
  env-wins contract: KFT_CHECKPOINT_DIR, KFT_CHAOS_*, KFT_TRACE_*), reports
  items/sec into the pod's status and annotations and resumes from
  KFT_RESTORE_DIR after a gang restart. The port runs one process a rank
  and one device a process, so it runs jobs whose mesh product is 1; a
  larger mesh fails its pod with InsufficientDevices.
- `SubprocessPodRunner` — one `python -m kubeflow_tpu_torch.runtime.
  launcher` child a pod, with the pod's rendered env on a localhost
  coordinator: the gang's ranks join one torch.distributed group (NCCL on
  the cards, gloo with `device="cpu"`).

Every entry point runs on the card unless given `device="cpu"`: a child
that finds no CUDA fails its pod, and so the job fails.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.cluster.store import Conflict, NotFound, StateStore
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

PENDING, RUNNING, SUCCEEDED, FAILED = "Pending", "Running", "Succeeded", "Failed"
JOB_KIND = "GPUTrainJob"
ITEMS_PER_SEC_ANNOTATION = "kubeflow-tpu.dev/items-per-sec"


def pod_env(pod: Dict[str, Any]) -> Dict[str, str]:
    env = {}
    for c in pod.get("spec", {}).get("containers", []):
        for e in c.get("env", []):
            env[e["name"]] = e.get("value", "")
    return env


def _status_info(result: Dict[str, Any]) -> Dict[str, str]:
    """A run's result → the pod status fields the job controller reads
    (the JAX runners' strings)."""
    info = {}
    if "items_per_sec" in result:
        info["items_per_sec"] = f"{result['items_per_sec']:.2f}"
    if "final_step" in result:
        info["final_step"] = str(result["final_step"])
    if result.get("loss") is not None:
        info["final_loss"] = f"{result['loss']:.4f}"
    if "compile_s" in result:
        info["compile_s"] = f"{result['compile_s']:.2f}"
    if "eval_top1" in result:
        info["eval_top1"] = f"{result['eval_top1']:.4f}"
    return info


class PodRunner:
    """Decides what happens to a scheduled pod.

    Returns (terminal_phase, info) — or (None, {}) for a pod that keeps
    running (service/notebook pods have no terminal state)."""

    def run(self, pod: Dict[str, Any]) -> Tuple[Optional[str], Dict[str, str]]:
        raise NotImplementedError


class FakePodRunner(PodRunner):
    """Scripted runner: pods succeed instantly unless told to fail.

    `fail_next(pod_name, times)` scripts failures.
    """

    def __init__(self) -> None:
        self._fail: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.ran: List[str] = []

    def fail_next(self, pod_name: str, times: int = 1) -> None:
        with self._lock:
            self._fail[pod_name] = self._fail.get(pod_name, 0) + times

    def run(self, pod: Dict[str, Any]) -> Tuple[str, Dict[str, str]]:
        name = pod["metadata"]["name"]
        with self._lock:
            self.ran.append(name)
            if self._fail.get(name, 0) > 0:
                self._fail[name] -= 1
                return FAILED, {"reason": "ScriptedFailure"}
        return SUCCEEDED, {}


class InProcessTrainerRunner(PodRunner):
    """Runs a training pod's job in this process on `device` (default
    the card; "cpu" asks for the CPU). One rank: the job's mesh product
    must be 1. `last_metrics` holds the last run's metrics (the JAX
    runner's keys); `runs` every run's pod name, wall seconds and
    `run_training` result, in order."""

    def __init__(self, device: Optional[str] = None) -> None:
        self.device = device
        self.last_metrics: Optional[Dict[str, float]] = None
        self.runs: List[Dict[str, Any]] = []

    def run(self, pod: Dict[str, Any]) -> Tuple[Optional[str], Dict[str, str]]:
        from kubeflow_tpu_torch.config.platform import TrainingConfig
        from kubeflow_tpu_torch.runtime.train_run import run_training

        env = pod_env(pod)
        if "KFT_TRAINING_SPEC" not in env:
            # not a training pod (notebook/component/service): it has no
            # terminal state — it just keeps running
            return None, {}
        if env.get("KFT_PROCESS_ID", "0") != "0":
            # non-coordinator members report success; the coordinator's
            # run is the job (and fails it when its mesh is too large)
            return SUCCEEDED, {}
        cfg = TrainingConfig.from_dict(
            json.loads(env.get("KFT_TRAINING_SPEC") or "{}"))
        needed = cfg.mesh.num_devices
        if needed > 1:
            return FAILED, {
                "reason": "InsufficientDevices",
                "message": f"mesh needs {needed} devices, the in-process "
                           f"runner drives 1 (one process a rank: run the "
                           f"gang through SubprocessPodRunner)",
            }
        t0 = time.monotonic()
        try:
            result = run_training(
                cfg,
                restore=bool(env.get("KFT_RESTORE_DIR")),
                device=self.device,
                # the POD's rendered env, not this process's: the
                # controller's env-wins contract (KFT_CHECKPOINT_DIR,
                # KFT_CHAOS_*, KFT_TRACE_*) holds in-process too, and a
                # host-process env var does not leak into the job
                environ=env,
            )
        except FloatingPointError as e:
            # diverged training is a real failure, not a Succeeded job with
            # a NaN in the log (trainer.fit raises on non-finite loss)
            return FAILED, {"reason": "NonFiniteLoss", "message": str(e)}
        self.runs.append({"pod": pod["metadata"]["name"],
                          "wall_s": time.monotonic() - t0, "result": result})
        self.last_metrics = {
            "items_per_sec": result["items_per_sec"],
            "loss": result["loss"],
            "final_step": result["final_step"],
        }
        if "eval_top1" in result:
            self.last_metrics["eval_top1"] = result["eval_top1"]
        return SUCCEEDED, _status_info(result)


class SubprocessPodRunner(PodRunner):
    """Executes GPUTrainJob gang pods as real OS processes: every pod gets
    its own `python -m kubeflow_tpu_torch.runtime.launcher` child with the
    pod's rendered KFT_* env, the gang's coordinator on 127.0.0.1 and
    every rank on this host (`TPU_WORKER_HOSTNAMES` lists 127.0.0.1 once
    a rank, so rank i drives cuda:i). `device` is the children's
    `--device`: None runs them on the cards over NCCL, "cpu" on gloo.

    Asynchronous by design: run() spawns on first sight of a Running pod
    and then polls — a blocking run would deadlock the gang (rank 0 waits
    at the rendezvous for rank 1, which the executor has not started
    yet). Children of deleted pods are reaped each tick, which is what
    makes a gang restart kill and respawn real processes. `results`
    holds each finished child's record: pod name, gang generation
    (`attempt`), exit code, wall seconds and its launcher line (the
    result, or the error), in the order they finished."""

    def __init__(self, store: StateStore,
                 device: Optional[str] = None) -> None:
        import tempfile

        self.store = store
        self.device = device
        self.results: List[Dict[str, Any]] = []
        self._procs: Dict[str, Dict[str, Any]] = {}  # pod uid → proc meta
        # (ns, job, generation) → the coordinator port's held socket
        self._gang_ports: Dict[Tuple[str, str, int], Any] = {}
        self._workdir = tempfile.mkdtemp(prefix="kft-gang-")
        self._lock = threading.Lock()

    # -- helpers ----------------------------------------------------------

    def _gang_port_for(self, ns: str, job: str) -> Tuple[int, int]:
        """(coordinator_port, generation) for this gang generation.

        Every member of a generation gets the same port; a restarted gang
        gets a fresh one so it can never join a dying predecessor's store.
        The port stays held (`reserve_port`: bound, never listening) while
        the generation can still start ranks, so no other gang's socket
        takes it before rank 0 listens on it; an older generation's port
        is released when a newer one is allocated."""
        from kubeflow_tpu_torch.parallel.distributed import reserve_port

        try:
            restarts = int(
                self.store.get(JOB_KIND, job, ns)
                .get("status", {})
                .get("restarts", 0)
            )
        except NotFound:
            restarts = 0
        key = (ns, job, restarts)
        if key not in self._gang_ports:
            for old in [k for k in self._gang_ports
                        if k[:2] == (ns, job) and k[2] < restarts]:
                self._gang_ports.pop(old).close()
            self._gang_ports[key] = reserve_port()
        return self._gang_ports[key].getsockname()[1], restarts

    @staticmethod
    def _cleanup_meta(meta: Dict[str, Any]) -> None:
        """Close and unlink a child's log files."""
        for f in (meta["stdout"], meta["stderr"]):
            try:
                f.close()
            except Exception:  # noqa: BLE001 - already closed is fine
                pass
            try:
                os.unlink(f.name)
            except OSError:
                pass

    def _reap_orphans(self) -> None:
        """Kill children whose pods were deleted (gang teardown/restart)."""
        for uid, meta in list(self._procs.items()):
            proc = meta["proc"]
            try:
                pod = self.store.get("Pod", meta["name"], meta["namespace"])
                alive = (
                    pod["metadata"].get("uid") == uid
                    and not pod["metadata"].get("deletionTimestamp")
                )
            except NotFound:
                alive = False
            if not alive:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10)
                self._cleanup_meta(meta)
                del self._procs[uid]

    def _spawn(self, pod: Dict[str, Any], env_block: Dict[str, str]):
        import subprocess
        import sys
        import tempfile

        from kubeflow_tpu_torch.parallel.distributed import (
            ENV_COORDINATOR,
            ENV_WORKER_HOSTNAMES,
        )

        m = pod["metadata"]
        ns, job = m["namespace"], env_block.get("KFT_JOB_NAME", "job")
        port, attempt = self._gang_port_for(ns, job)
        nprocs = max(1, int(env_block.get("KFT_NUM_PROCESSES", "1")))

        child_env = dict(os.environ)
        child_env.update(env_block)
        # every gang member runs on THIS host: the coordinator rides
        # localhost, and rank i is local rank i (cuda:i on the cards)
        child_env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        child_env[ENV_WORKER_HOSTNAMES] = ",".join(["127.0.0.1"] * nprocs)
        # the rendered debug port assumes a network namespace a pod; on one
        # host each child binds a port of its own, and no scraper knows it
        if child_env.get("KFT_DEBUG_PORT", "").strip():
            child_env["KFT_DEBUG_PORT"] = "0"
        child_env.pop("KFT_FLEET_METRICS_PORT", None)
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        child_env["PYTHONPATH"] = (
            repo + os.pathsep + child_env.get("PYTHONPATH", "")
        )
        payload = [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher"]
        if self.device is not None:
            payload += ["--device", str(self.device)]
        # temp files, not pipes: a chatty child would fill a pipe buffer
        # and deadlock against the polling executor. stop_all() removes
        # the workdir, so a reused runner re-creates it first.
        os.makedirs(self._workdir, exist_ok=True)
        out_f = tempfile.NamedTemporaryFile(
            "w+", dir=self._workdir, suffix=".out", delete=False
        )
        err_f = tempfile.NamedTemporaryFile(
            "w+", dir=self._workdir, suffix=".err", delete=False
        )
        proc = subprocess.Popen(
            payload, env=child_env, stdout=out_f, stderr=err_f, text=True
        )
        return {
            "proc": proc,
            "stdout": out_f,
            "stderr": err_f,
            "name": m["name"],
            "namespace": m["namespace"],
            "attempt": attempt,
            "t0": time.monotonic(),
        }

    @staticmethod
    def _launcher_line(meta) -> Optional[Dict[str, Any]]:
        """The child's last launcher line (`{"job": ...}`), or None."""
        meta["stdout"].flush()
        with open(meta["stdout"].name) as f:
            for line in reversed(f.read().strip().splitlines()):
                if not line.startswith('{"job"'):
                    continue
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue
        return None

    # -- PodRunner --------------------------------------------------------

    def run(self, pod: Dict[str, Any]) -> Tuple[Optional[str], Dict[str, str]]:
        env = pod_env(pod)
        if "KFT_TRAINING_SPEC" not in env:
            return None, {}  # not a training pod
        with self._lock:
            self._reap_orphans()
            uid = pod["metadata"].get("uid", "")
            meta = self._procs.get(uid)
            if meta is None:
                meta = self._spawn(pod, env)
                self._procs[uid] = meta
                return None, {}  # spawned; poll on later ticks
            rc = meta["proc"].poll()
            if rc is None:
                return None, {}
            if "done" not in meta:
                meta["done"] = True
                self.results.append({
                    "pod": meta["name"], "attempt": meta["attempt"],
                    "rc": rc, "wall_s": time.monotonic() - meta["t0"],
                    "line": self._launcher_line(meta)})
            if rc == 0:
                return SUCCEEDED, _status_info(self.results[-1]["line"] or {})
            meta["stderr"].flush()
            with open(meta["stderr"].name) as f:
                tail = f.read()[-2000:]
            return FAILED, {"reason": "NonzeroExit", "message": tail}

    def stop_all(self) -> None:
        """Kill every child, release the held ports and reclaim the disk."""
        import shutil

        with self._lock:
            for meta in self._procs.values():
                if meta["proc"].poll() is None:
                    meta["proc"].kill()
                    meta["proc"].wait(timeout=10)
                self._cleanup_meta(meta)
            self._procs.clear()
            for sock in self._gang_ports.values():
                sock.close()
            self._gang_ports.clear()
            shutil.rmtree(self._workdir, ignore_errors=True)

    def kill_member(self, pod_name: str) -> bool:
        """Fault injection: kill the child of a named pod (crash a real
        gang member; the controller should observe NonzeroExit and gang-
        restart)."""
        with self._lock:
            for meta in self._procs.values():
                if meta["name"] == pod_name and meta["proc"].poll() is None:
                    meta["proc"].kill()
                    return True
        return False


class PodExecutor:
    """Drives every Pod in the store through Pending→Running→terminal.

    `tick()` advances synchronously (deterministic tests); `start()` runs a
    background loop. One phase transition per pod per tick so controllers
    observe Running before terminal — matching real kubelet event ordering.
    """

    def __init__(
        self,
        store: StateStore,
        runner: PodRunner,
        selector: Optional[Callable[[Dict[str, Any]], bool]] = None,
    ) -> None:
        self.store = store
        self.runner = runner
        self.selector = selector or (lambda pod: True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _set_phase(
        self, pod: Dict[str, Any], phase: str, info: Optional[Dict[str, str]] = None
    ) -> None:
        m = pod["metadata"]
        try:
            fresh = self.store.get("Pod", m["name"], m["namespace"])
        except NotFound:
            return
        fresh["status"]["phase"] = phase
        if info:
            fresh["status"].update(info)
            if "items_per_sec" in info:
                ann = fresh["metadata"].setdefault("annotations", {})
                ann[ITEMS_PER_SEC_ANNOTATION] = info["items_per_sec"]
        try:
            # one optimistic write for status + annotation (single watch event)
            self.store.update(fresh)
        except (NotFound, Conflict) as e:
            log.warning(
                "pod %s/%s phase write lost (%s); retrying status only",
                m["namespace"],
                m["name"],
                e,
            )
            try:
                self.store.patch_status(
                    "Pod", m["name"], m["namespace"], fresh["status"]
                )
            except NotFound:
                pass

    def tick(self) -> int:
        """Advance every eligible pod one phase; returns transitions made."""
        n = 0
        for pod in self.store.list("Pod"):
            if pod["metadata"].get("deletionTimestamp"):
                continue
            if not self.selector(pod):
                continue
            phase = pod.get("status", {}).get("phase", PENDING)
            if phase == PENDING:
                self._set_phase(pod, RUNNING)
                n += 1
            elif phase == RUNNING:
                try:
                    terminal, info = self.runner.run(pod)
                except Exception:
                    terminal, info = FAILED, {
                        "reason": "RunnerError",
                        "message": traceback.format_exc(limit=3),
                    }
                if terminal is None:
                    continue  # long-running pod: no terminal transition
                self._set_phase(pod, terminal, info)
                n += 1
        return n

    def run_until_settled(self, max_ticks: int = 50) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0:
                return

    def start(self, period_s: float = 0.05) -> None:
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    log.error("executor tick failed:\n%s", traceback.format_exc())
                self._stop.wait(period_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="pod-executor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
