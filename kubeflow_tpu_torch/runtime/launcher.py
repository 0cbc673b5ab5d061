"""In-process training entry point of a gang rank (port of
kubeflow_tpu/runtime/launcher.py).

A gang controller renders the KFT_* env into every process
(parallel/distributed.py `render_gang_env`) and starts

    python -m kubeflow_tpu_torch.runtime.launcher [--config FILE] [--steps N]

once per rank. The launcher reads the job's TrainingConfig from
KFT_TRAINING_SPEC (JSON) or `--config` (YAML or JSON), joins the gang's
`torch.distributed` group (`initialize_from_env`: NCCL on the card, one
card a rank; `--device cpu` runs the gang on the CPU over gloo),
configures the tracer from KFT_TRACE_*, serves the debug surface when
KFT_DEBUG_PORT is set, runs `run_training` (KFT_RESTORE_DIR set turns on
the resume) and prints the JAX launcher's result line, `{"job": ...,
"backend": <the group's backend or null>, **result}`, then leaves the
group and exits 0. A run that raises prints `{"job": ..., "error":
"<type>: <message>"}` and exits 1. Both lines carry `kernel_launches`,
the process's flash-kernel launch counts (ops/flash_attention.py; one
process runs one job, so they are this run's). A config runs as it is:
its mesh's axes multiply to the gang's world size, one process a rank
(e.g. configs/gpt_moe_v5e16.yaml's `{data: 8, expert: 4}` is a gang of
32, `mesh: {data: 2, fsdp: 2}` one of 4 whose ranks hold blocks of the
fsdp leaves, and `mesh: {tensor: 2}` one of 2 whose ranks hold blocks of
the tensor leaves). KFT_PROFILER_LOGDIR set (the controller renders it
from `profiler_logdir`) serves the profiler endpoint (runtime/
profiler.py) on the coordinator at KFT_PROFILER_PORT (9431 by default)
for the run's length.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_TRAINING_SPEC = "KFT_TRAINING_SPEC"
ENV_RESTORE_DIR = "KFT_RESTORE_DIR"
# profiler capture endpoint (runtime/profiler.py): set the logdir to
# enable; traces land Tensorboard-readable so a Tensorboard CR can front
# them
ENV_PROFILER_LOGDIR = "KFT_PROFILER_LOGDIR"
ENV_PROFILER_PORT = "KFT_PROFILER_PORT"
DEFAULT_PROFILER_PORT = 9431
# kft-trace debug surface (observability/http.py): /statusz + /debug/trace
# + /metrics; unset = no debug server
ENV_DEBUG_PORT = "KFT_DEBUG_PORT"


def maybe_start_profiler_server(environ=None, device=None):
    """Start the `torch.profiler` REST endpoint when the env asks for
    one: KFT_PROFILER_LOGDIR set, on the coordinator only (same-host gang
    members would race for the port). Port 0 picks a free port; the
    rendered pod env uses DEFAULT_PROFILER_PORT. `device` is the rank's
    (the card unless the caller asks for the CPU). Returns the Server
    (the caller owns its shutdown) or None."""
    env = os.environ if environ is None else environ
    logdir = env.get(ENV_PROFILER_LOGDIR, "")
    if not logdir:
        return None
    if env.get("KFT_PROCESS_ID", "0") != "0":
        return None
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.runtime.profiler import ProfilerService, build_app

    port = int(env.get(ENV_PROFILER_PORT, str(DEFAULT_PROFILER_PORT)))
    server = Server(build_app(ProfilerService(logdir, device=device)),
                    port=port)
    server.start()
    log.info("profiler endpoint on :%d → %s", server.port, logdir)
    return server


def maybe_start_debug_server(environ=None):
    """Serve the kft-trace debug surface (/statusz, /debug/trace,
    /metrics) when KFT_DEBUG_PORT is set. Coordinator-only (same-host
    gang members would race for the port) unless KFT_FLEET_SCRAPE=1 opts
    every rank in. Best-effort: a taken port means no debug server, never
    a dead rank. Returns the Server (caller owns shutdown) or None."""
    env = os.environ if environ is None else environ
    port_raw = env.get(ENV_DEBUG_PORT, "").strip()
    if not port_raw:
        return None
    fleet_scrape = env.get("KFT_FLEET_SCRAPE", "").strip() not in (
        "", "0", "false", "False", "off",
    )
    if env.get("KFT_PROCESS_ID", "0") != "0" and not fleet_scrape:
        return None
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.observability.http import build_debug_app

    try:
        server = Server(build_debug_app("training-debug"), port=int(port_raw))
        server.start()
    except (OSError, ValueError) as e:
        log.warning("debug server on :%s unavailable (%s)", port_raw, e)
        return None
    log.info("kft-trace debug endpoint on :%d", server.port)
    return server


def load_spec(config_path: Optional[str] = None, environ=None) -> dict:
    """The job's TrainingConfig mapping: `config_path` (JSON, or YAML
    through PyYAML where it is installed) or the KFT_TRAINING_SPEC JSON
    env. A job spec file (a `training:` block beside `slice_spec:` and
    the rest, as configs/*.yaml hold one) gives its `training` block: a
    TrainingConfig has no field of that name."""
    env = os.environ if environ is None else environ
    if not config_path:
        return json.loads(env.get(ENV_TRAINING_SPEC, "{}"))
    with open(config_path) as f:
        text = f.read()
    try:
        spec = json.loads(text)
    except ValueError:
        import yaml

        spec = yaml.safe_load(text) or {}
    return spec.get("training", spec)


def run(config_path: Optional[str] = None, steps: Optional[int] = None,
        device: Optional[str] = None) -> int:
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.observability.trace import configure_from_env
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.distributed import (
        gang_device,
        initialize_from_env,
        shutdown,
    )
    from kubeflow_tpu_torch.runtime.train_run import run_training

    cfg = TrainingConfig.from_dict(load_spec(config_path))
    gang = initialize_from_env(device=device)
    dev = gang_device(device)
    log.info("launcher: job=%s process %d/%d device=%s model=%s",
             gang.job_name, gang.process_id, gang.num_processes, dev,
             cfg.model)
    configure_from_env()
    profiler_server = maybe_start_profiler_server(device=dev)
    debug_server = maybe_start_debug_server()
    try:
        result = run_training(
            cfg,
            restore=bool(os.environ.get(ENV_RESTORE_DIR)),
            steps_override=steps,
            device=dev,
        )
    except Exception as e:
        print(json.dumps({"job": gang.job_name,
                          "error": f"{type(e).__name__}: {e}",
                          "kernel_launches": dict(fa.launch_counts)}),
              flush=True)
        raise
    finally:
        if profiler_server is not None:
            profiler_server.stop()
        if debug_server is not None:
            debug_server.stop()
    import torch

    dist = torch.distributed
    backend = dist.get_backend() if dist.is_initialized() else None
    print(json.dumps({"job": gang.job_name, "backend": backend, **result,
                      "kernel_launches": dict(fa.launch_counts)}),
          flush=True)
    shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="kubeflow-tpu-torch training "
                                 "launcher")
    ap.add_argument("--config", default=None,
                    help="TrainingConfig yaml/json path")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the rank's card) or cpu (gloo)")
    args = ap.parse_args(argv)
    try:
        return run(args.config, args.steps, args.device)
    except Exception:
        import traceback

        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
