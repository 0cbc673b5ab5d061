"""Shared by the port's sequence-parallel tests: start a gang of the
port's ranks on the CPU (one process a rank, gloo over 127.0.0.1, the
env `render_gang_env` gives each) running a worker's source, and read
each rank's result line. Imports no JAX."""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a gang rank's own time limit: a hang fails the test, not the tier
RANK_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(worker: str, job: dict, world: int, name: str = "sp-test"):
    """Run `worker` (Python source that defines `main()`, which reads
    its job from KFT_TEST_JOB and prints one "RESULT <json>" line) on a
    gang of `world` ranks → each rank's result (rank order). Every rank
    has its own time limit and one thread; on any failure every rank is
    killed."""
    from kubeflow_tpu_torch.parallel.distributed import render_gang_env

    envs = render_gang_env(name, ["127.0.0.1"] * world,
                           coordinator_port=free_port())
    procs = []
    try:
        for e in envs:
            env = dict(os.environ, **e, KFT_TEST_JOB=json.dumps(job),
                       OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", worker + "\nmain()\n"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"gang rank exited {p.returncode}:\n"
                                     f"{err[-6000:]}")
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            outs.append(json.loads(line[-1][len("RESULT "):]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
