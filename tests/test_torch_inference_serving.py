"""The env an InferenceService controller renders drives the same server,
on the CPU.

- The JAX controller renders a gpt_tiny service's pod env, and the JAX
  `build_server` runs under it; the port's controller renders the same
  spec's env, and the port's `build_server(device="cpu")` runs under it
  with the JAX params through the numpy bridge. Greedy `:generate`
  tokens must be equal (f32: the JAX registry's gpt_tiny is built in
  f32 here, as the port's is). The port's `kernel` read path (the JAX
  package's `pallas`, which it pins bitwise to `gather`) is held against
  the same JAX tokens.
- After that traffic both servers' /metrics declare the same `serving_*`
  series, apart from the port's `serving_kernel_launches` (the pod's
  paged-kernel launch counts), and `serving_num_slots` reads the
  engine's slots: the fleet collector's capacity signal.
- The rendered command with `--device cpu` and a `{tensor: 2}` mesh:
  `python -m kubeflow_tpu_torch.serving.main` starts its worker rank
  itself (gloo over localhost); its greedy tokens equal the 1×1 port
  engine's bit for bit, and SIGTERM drains it and leaves no worker
  alive. A worker's death fails the replica (exit 1).
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.controllers import InferenceServiceController  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serving.main import (  # noqa: E402
    build_server,
    engine_knobs_from_env,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the service's engine: 2 slots, pages of 8, buckets up to 32 (the
# 45-token prompt prefills its head and runs one chunk window)
SPEC = {"num_slots": 2, "page_size": 8, "prefill_buckets": [8, 32],
        "max_queue": 8}
LENS, MAX_NEW = (5, 20, 45), 6
ENV_PREFIXES = ("KFT_SERVING_", "KFT_TRACE_", "KFT_CHAOS_", "KFT_FLEET_")
# a replica process's time limits: up, and down after SIGTERM
START_TIMEOUT_S, STOP_TIMEOUT_S = 120, 60


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(1, 512, n).tolist() for n in LENS]


def _use_env(monkeypatch, env):
    """Exactly `env` of the serving contract in this process's env."""
    for key in list(os.environ):
        if key.startswith(ENV_PREFIXES):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def _serving_names(app):
    """The `serving_*` families a server's /metrics declares."""
    status, resp, _ = app.handle_full("GET", "/metrics")
    assert status == 200
    text = resp.body.decode() if hasattr(resp, "body") else resp
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE serving_")}


def _tokens(app, name, prompts):
    out = []
    for prompt in prompts:
        status, body, _ = app.handle_full(
            "POST", f"/v1/models/{name}:generate",
            body={"prompt_ids": [prompt], "max_new_tokens": MAX_NEW})
        assert status == 200, body
        out.append(body["sequences"][0][len(prompt):])
    return out


@pytest.fixture(scope="module")
def jax_tokens(gpt_and_params):
    """The JAX server's tokens under the JAX controller's rendered env,
    and the `serving_*` families its /metrics declares after them (a
    fresh registry: only this server's series)."""
    import jax.numpy as jnp

    from kubeflow_tpu.controllers.inference import (
        InferenceServiceController as JController,
    )
    from kubeflow_tpu.models import registry
    from kubeflow_tpu.serving.main import build_server as jbuild_server
    from kubeflow_tpu.utils import metrics as jmetrics

    _, params = gpt_and_params
    env = JController()._serving_env({"serving": SPEC})
    mp = pytest.MonkeyPatch()
    try:
        _use_env(mp, env)
        mp.setattr(jmetrics, "_default_registry", jmetrics.MetricsRegistry())
        get_model = registry.get_model
        # the served model in f32, as the port's below (the registry's
        # gpt_tiny computes in bf16 by default)
        mp.setattr(registry, "get_model", lambda name, **kw: get_model(
            name, **dict(kw, dtype=jnp.float32)))
        ms = jbuild_server("gpt_tiny", params=params, batch_window_ms=0)
        try:
            assert ms._engines["gpt_tiny"].num_slots == SPEC["num_slots"]
            tokens = _tokens(ms.app, "gpt_tiny", _prompts())
            return env, tokens, _serving_names(ms.app)
        finally:
            ms.close()
    finally:
        mp.undo()


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_the_rendered_env_serves_the_jax_servers_tokens(
        gpt_and_params, jax_tokens, monkeypatch, impl):
    jenv, want, _ = jax_tokens
    _, params = gpt_and_params
    env = InferenceServiceController()._serving_env(
        {"serving": dict(SPEC, paged_attention=impl)})
    assert env == dict(jenv, KFT_SERVING_PAGED_ATTENTION=impl)
    _use_env(monkeypatch, env)
    knobs = engine_knobs_from_env()
    assert (knobs["num_slots"], knobs["page_size"], knobs["prefill_buckets"],
            knobs["max_queue"], knobs["paged_attention"]) == (
        2, 8, [8, 32], 8, impl)
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      params=params_from_jax(params))
    try:
        got = _tokens(ms.app, "gpt_tiny", _prompts())
        stats = ms.engine("gpt_tiny").stats()
    finally:
        ms.close()
    assert got == want
    assert stats["attention_kernel"] == impl
    # the 45-token prompt ran a chunk window past the largest bucket
    assert any(int(w) > 1 for w in stats["paged_attention_windows"])


def test_both_servers_declare_the_same_serving_series(
        gpt_and_params, jax_tokens, monkeypatch):
    from kubeflow_tpu_torch.utils import metrics

    jenv, want_tokens, want = jax_tokens
    _use_env(monkeypatch, InferenceServiceController()._serving_env(
        {"serving": SPEC}))
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      params=params_from_jax(gpt_and_params[1]))
    try:
        assert _tokens(ms.app, "gpt_tiny", _prompts()) == want_tokens
        got = _serving_names(ms.app)
        reg = metrics.default_registry()
        slots = reg.get("serving_num_slots").value(model="gpt_tiny")
        pool = reg.get("serving_kv_pool_bytes").value(model="gpt_tiny")
        hit_rate = reg.get("serving_prefix_hit_rate").value(model="gpt_tiny")
        stats = ms.engine("gpt_tiny").stats()
    finally:
        ms.close()
    assert {"serving_num_slots", "serving_prefix_hit_rate",
            "serving_kv_pool_bytes"} <= want
    assert got - {"serving_kernel_launches"} == want
    assert slots == SPEC["num_slots"]
    assert pool == stats["kv_pool_bytes"] > 0
    assert hit_rate == pytest.approx(stats["prefix_cache_hit_rate"])


# -- the rendered command as a pod runs it: a {tensor: 2} replica ------------


@pytest.fixture(scope="module")
def replica_weights(tmp_path_factory, gpt_and_params):
    path = tmp_path_factory.mktemp("replica") / "gpt_tiny.pt"
    torch.save(params_from_jax(gpt_and_params[1]), path)
    return str(path)


def _rendered_pod(weights):
    """The command and env the port's controller renders for a
    {tensor: 2} gpt_tiny service, on the CPU: `--device cpu`, the
    weights file and a free port appended."""
    from kubeflow_tpu_torch.cluster.reconciler import ControllerManager
    from kubeflow_tpu_torch.cluster.store import StateStore
    from kubeflow_tpu_torch.controllers import (
        DeploymentController,
        new_inference_service,
    )

    store = StateStore()
    cm = ControllerManager(store)
    cm.register(DeploymentController())
    cm.register(InferenceServiceController())
    store.create(new_inference_service("lm", model="gpt_tiny", serving=dict(
        SPEC, paged_attention="kernel", mesh={"tensor": 2},
        drain_deadline_s=20)))
    cm.run_until_idle(max_seconds=5)
    pod = store.get("Pod", "lm-0", "default")
    c = pod["spec"]["containers"][0]
    cmd = list(c["command"])
    cmd[cmd.index("--port") + 1] = "0"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(ENV_PREFIXES)}
    env.update({e["name"]: e["value"] for e in c["env"]})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable] + cmd[1:] + ["--device", "cpu",
                                        "--weights", weights]
    return cmd, env, pod["spec"]["terminationGracePeriodSeconds"]


def _start(cmd, env, log):
    proc = subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + START_TIMEOUT_S
    while time.monotonic() < deadline:
        assert proc.poll() is None, open(log.name).read()[-4000:]
        text = open(log.name).read()
        workers = [ln for ln in text.splitlines()
                   if ln.startswith("serving replica:")]
        ports = [ln for ln in text.splitlines() if ln.startswith("serving ")
                 and " on :" in ln]
        if ports:
            pids = json.loads(workers[0].split("workers ")[1])
            return proc, int(ports[-1].rsplit(":", 1)[1]), pids
        time.sleep(0.2)
    proc.kill()
    raise AssertionError(open(log.name).read()[-4000:])


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie has exited: only its parent has yet to reap it
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(") ")[-1].split()[0] != "Z"


def test_a_tensor2_replica_pod_serves_the_1x1_engines_tokens(
        tmp_path, replica_weights):
    cmd, env, grace = _rendered_pod(replica_weights)
    assert cmd[1:3] == ["-m", "kubeflow_tpu_torch.serving.main"]
    assert env["KFT_SERVING_MESH_TENSOR"] == "2"
    assert "KFT_NUM_PROCESSES" not in env
    with open(tmp_path / "replica.log", "w+") as log:
        proc, port, pids = _start(cmd, env, log)
        try:
            assert len(pids) == 1 and _alive(pids[0])
            got = []
            for prompt in _prompts():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/models/gpt_tiny:generate",
                    data=json.dumps({"prompt_ids": [prompt],
                                     "max_new_tokens": MAX_NEW}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    assert resp.status == 200
                    got.append(json.loads(resp.read())["sequences"][0][
                        len(prompt):])
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz",
                                        timeout=30) as resp:
                assert b"mesh: tensor=2 fsdp=1 expert=1" in resp.read()
            t0 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(STOP_TIMEOUT_S)
            stop_s = time.monotonic() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = open(log.name).read()
    assert code == 0, text[-4000:]
    assert stop_s < grace
    assert "drain complete" in text and "workers exited [0]" in text
    assert not _alive(pids[0])
    # the 1×1 port engine on the same weights and knobs
    ms = build_server("gpt_tiny", device="cpu",
                      params=torch.load(replica_weights), num_slots=2,
                      page_size=8, prefill_buckets=[8, 32], max_queue=8,
                      paged_attention="kernel", mesh_tensor=1, mesh_fsdp=1,
                      mesh_expert=1)
    try:
        want = _tokens(ms.app, "gpt_tiny", _prompts())
    finally:
        ms.close()
    assert got == want


def test_a_workers_death_fails_the_replica(tmp_path, replica_weights):
    cmd, env, _ = _rendered_pod(replica_weights)
    with open(tmp_path / "replica.log", "w+") as log:
        proc, _, pids = _start(cmd, env, log)
        try:
            os.kill(pids[0], signal.SIGKILL)
            code = proc.wait(STOP_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = open(log.name).read()
    assert code == 1, text[-4000:]
    assert "worker rank 1 exited -9; the replica fails" in text


def test_no_worker_outlives_a_killed_rank0(tmp_path, replica_weights):
    cmd, env, _ = _rendered_pod(replica_weights)
    with open(tmp_path / "replica.log", "w+") as log:
        proc, _, pids = _start(cmd, env, log)
        proc.kill()
        proc.wait()
    deadline = time.monotonic() + 10
    while _alive(pids[0]) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(pids[0])
