"""Shared by the port's gang tests: start a gang of the port's ranks on
the CPU (one process a rank, gloo over 127.0.0.1, the env
`render_gang_env` gives each) running a worker's source, and read each
rank's result line; rehearse chip_smoke.py's gang phases (19-21, 23-25)
on the CPU. Imports no JAX."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a gang rank's own time limit: a hang fails the test, not the tier
RANK_TIMEOUT_S = 240


# the coordinator ports handed out, each held for the life of this process
_HELD_PORTS = []


def free_port() -> int:
    """A coordinator port for one gang, held (bound with SO_REUSEADDR,
    never listening: `reserve_port`) until this process exits. Rank 0's
    store listens on it, and no other gang's store or gloo socket can be
    given it in between: a port probed and released at once could be
    (rank 0 then failed with EADDRINUSE under pytest-xdist)."""
    from kubeflow_tpu_torch.parallel.distributed import reserve_port

    _HELD_PORTS.append(reserve_port())
    return _HELD_PORTS[-1].getsockname()[1]


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


def chip_smoke():
    """chip_smoke.py, loaded as a module."""
    import importlib.util

    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# the cells of chip_smoke.py's phases 19-21 and 23-25 at test size, f32
# on the CPU:
# each phase's plan keywords (its `phase_gangs` argument)
SMOKE_SEQ = {"overrides": dict(model="gpt_tiny", seq_len=64,
                               dtype="float32", loss_chunk=16)}
SMOKE_EXPERT = {
    "overrides": dict(model="gpt_tiny_moe", seq_len=32, dtype="float32",
                      loss_chunk=16, attention_impl="dense"),
    "seq_overrides": dict(model="gpt_tiny_moe", seq_len=64,
                          dtype="float32", loss_chunk=16),
    "model_kwargs": {}}
SMOKE_PIPELINE = {"overrides": dict(model="gpt_tiny", seq_len=32,
                                    dtype="float32", attention_impl="dense"),
                  "model_kwargs": {"num_layers": 4}}
SMOKE_FSDP = {"overrides": dict(model="gpt_tiny", seq_len=32,
                                dtype="float32", loss_chunk=16,
                                attention_impl="dense"),
              "model_kwargs": {}}
# phase 24's cells: gpt_tiny and gpt_tiny_moe in f32, phase 5's traffic
# cut to gpt_tiny's window of 128 (two prompts past the largest bucket, the
# second sent again)
SMOKE_SERVE = {"overrides": dict(
    models={"gpt_small": "gpt_tiny", "gpt_small_moe": "gpt_tiny_moe"},
    lens=(5, 17, 33, 90, 70), max_new=8, buckets="8,16,32",
    dtype="float32")}
# phase 25's cells: 23's gpt_tiny cell and bert_tiny at 16a's dropout
SMOKE_TENSOR = {"overrides": dict(model="gpt_tiny", seq_len=32,
                                  dtype="float32", loss_chunk=16,
                                  attention_impl="dense"),
                "bert_overrides": dict(model="bert_tiny", seq_len=32,
                                       dtype="float32",
                                       attention_impl="dense"),
                "model_kwargs": {}}
# 19c's ring ranks at test size (phase_ring_cost's keywords, but dtype)
SMOKE_RING_COST = dict(b=1, s=64, n=8, h=4, d=16)


def rehearse_smoke(root, seq=None, expert=None, pipeline=None, fsdp=None,
                   serve=None, tensor=None):
    """chip_smoke.py's phases 19-21 and 23-25 as `main` runs them, on
    the CPU: `phase_gangs` (the same gangs, the given phases' cells), then
    each given phase's world 1 and gates on its gang's reports → {phase:
    its flash launches (phase 24: its cells' rank-0 reports; phase 25:
    its cells')}; phase 25 reads phase 23's world 1 where its cell is
    23's."""
    import torch

    smoke = chip_smoke()
    gangs = smoke.phase_gangs(torch, str(root), device="cpu", seq=seq,
                              expert=expert, pipeline=pipeline, fsdp=fsdp,
                              serve=serve, tensor=tensor)
    out = {}
    if seq is not None:
        out["seq"] = smoke.phase_sequence(
            torch, gangs["seq"], device="cpu",
            ring_cost=dict(SMOKE_RING_COST, dtype=torch.float32))
    if expert is not None:
        out["expert"] = smoke.phase_expert(torch, gangs["expert"],
                                           device="cpu")
    if pipeline is not None:
        out["pipeline"] = smoke.phase_pipeline(torch, gangs["pipeline"],
                                               device="cpu")
    ref = {}
    if fsdp is not None:
        out["fsdp"] = smoke.phase_fsdp(torch, gangs["fsdp"], device="cpu",
                                       ref=ref)
    if tensor is not None:
        out["tensor"] = smoke.phase_tensor(torch, gangs["tensor"],
                                           device="cpu", ref=ref or None)
    if serve is not None:
        out["serve"] = smoke.phase_serving_mesh(torch, gangs["serve"], None,
                                                device="cpu")
    return out
