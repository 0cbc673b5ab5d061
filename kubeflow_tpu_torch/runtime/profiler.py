"""Profiler capture service: `torch.profiler` traces on demand (port of
kubeflow_tpu/runtime/profiler.py, where `jax.profiler` takes traces).

The service runs inside the training runtime (runtime/launcher.py serves
it on the coordinator when the GPUTrainJob controller rendered
KFT_PROFILER_LOGDIR) and is driven over REST, with the reference's
routes, replies and 400s:

  POST /profiler/start            {"logdir": optional override}
  POST /profiler/stop             → {"active": false, "trace_dirs": [...]}
  POST /profiler/capture          {"duration_ms": N}: blocking one-shot
  GET  /profiler/status           → {"active": bool, "logdir": ..., "runs": N}

A capture records CPU and CUDA activity on the card (CPU alone when the
service was built with `device="cpu"`) and is written as one Chrome
trace, `<logdir>/plugins/profile/<run>/<host>.pt.trace.json`: the
reference's TensorBoard run layout, so `trace_runs` and
`status()["runs"]` count what the JAX service counts and a Tensorboard
CR on the logdir (controllers/tensorboard.py) finds the runs.

Threads: the REST handler thread starts and stops the profiler while the
training loop runs on another thread, and `torch.profiler` records only
the ops of the thread that started it unless `profile_all_threads` is
set in its experimental config, which this service always sets. Device
kernels come from CUPTI, which sees every thread's launches. A CUDA
capture that records no device kernel fails (500) and leaves no run.

CUPTI stays attached to the process after a capture, and CPU activity
slows the host several-fold while a capture runs: no step time should be
read from a profiled window, nor from a later window of the same
process.
"""

from __future__ import annotations

import os
import re
import shutil
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.api.wsgi import App, BadRequest, HttpError
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import profiler_captures_counter

log = get_logger(__name__)

# a device kernel's event in a Kineto Chrome trace
_KERNEL_EVENT = re.compile(rb'"cat"\s*:\s*"kernel"')


def count_kernel_events(path: str) -> int:
    """Device kernel events (`"cat": "kernel"`) in a Chrome trace file."""
    with open(path, "rb") as f:
        return len(_KERNEL_EVENT.findall(f.read()))


class ProfilerService:
    """Wraps `torch.profiler` start/stop with state and run discovery."""

    def __init__(self, logdir: str, device: DeviceLike = None):
        self.logdir = logdir
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._active: Optional[str] = None
        self._profile = None
        self._captures = profiler_captures_counter()

    # -- lifecycle --------------------------------------------------------

    def start(self, logdir: Optional[str] = None) -> Dict[str, Any]:
        import torch
        from torch._C._profiler import _ExperimentalConfig

        with self._lock:
            if self._active is not None:
                raise BadRequest(f"trace already active in {self._active}")
            target = logdir or self.logdir
            os.makedirs(target, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            # the training loop runs on another thread than this one
            profile = torch.profiler.profile(
                activities=activities,
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True),
            )
            profile.start()
            self._profile = profile
            self._active = target
            log.info("profiler trace started → %s", target)
            return {"active": True, "logdir": target}

    def stop(self) -> Dict[str, Any]:
        import torch

        with self._lock:
            if self._active is None:
                raise BadRequest("no active trace")
            target, profile = self._active, self._profile
            self._active, self._profile = None, None
            if self.device.type == "cuda":
                # the kernels launched so far finish inside the window
                torch.cuda.synchronize(self.device)
            profile.stop()
            run_dir = self._new_run_dir(target)
            path = os.path.join(
                run_dir, f"{socket.gethostname()}.pt.trace.json")
            profile.export_chrome_trace(path)
            if self.device.type == "cuda" and count_kernel_events(path) == 0:
                shutil.rmtree(run_dir, ignore_errors=True)
                raise HttpError(
                    500, f"the capture on {self.device} recorded no device "
                    f"kernel (CUPTI saw no launch)")
            self._captures.inc()
            log.info("profiler trace stopped → %s", path)
            return {"active": False, "trace_dirs": self.trace_runs(target)}

    def capture(self, duration_ms: float = 1000.0) -> Dict[str, Any]:
        """Blocking one-shot: start, let the training loop run, stop."""
        self.start()
        time.sleep(max(0.0, duration_ms) / 1e3)
        return self.stop()

    @staticmethod
    def _new_run_dir(logdir: str) -> str:
        """A fresh `<logdir>/plugins/profile/<run>` named by the wall
        clock, as the reference's runs are."""
        root = os.path.join(logdir, "plugins", "profile")
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        run, n = stamp, 1
        while os.path.exists(os.path.join(root, run)):
            run, n = f"{stamp}_{n}", n + 1
        path = os.path.join(root, run)
        os.makedirs(path)
        return path

    # -- introspection ----------------------------------------------------

    def trace_runs(self, logdir: Optional[str] = None) -> List[str]:
        """TensorBoard profile-plugin run dirs under the logdir."""
        root = os.path.join(logdir or self.logdir, "plugins", "profile")
        if not os.path.isdir(root):
            return []
        return sorted(
            os.path.join(root, d)
            for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": self._active is not None,
                "logdir": self._active or self.logdir,
                "runs": len(self.trace_runs()),
            }


def build_app(service: ProfilerService) -> App:
    app = App("profiler")

    @app.post("/profiler/start")
    def start(req):
        body = req.body or {}
        return service.start(logdir=body.get("logdir"))

    @app.post("/profiler/stop")
    def stop(req):
        return service.stop()

    @app.post("/profiler/capture")
    def capture(req):
        body = req.body or {}
        try:
            duration = float(body.get("duration_ms", 1000.0))
        except (TypeError, ValueError):
            raise BadRequest("duration_ms must be a number")
        return service.capture(duration_ms=duration)

    @app.get("/profiler/status")
    def status(req):
        return service.status()

    return app
