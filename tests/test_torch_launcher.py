"""runtime/launcher.py, the gang rank's entry point: `main` from
KFT_TRAINING_SPEC and from `--config`, its result line against the JAX
launcher's, the resume through KFT_RESTORE_DIR, the debug server, the
profiler endpoint for the run's length (runtime/profiler.py), and
`python -m kubeflow_tpu_torch.runtime.launcher` as a 2-rank gloo gang on
the CPU."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu.runtime import launcher as jlauncher  # noqa: E402
from kubeflow_tpu_torch.parallel.distributed import render_gang_env  # noqa: E402
from kubeflow_tpu_torch.runtime import launcher  # noqa: E402
from test_torch_data_parallel import REPO, RANK_TIMEOUT_S, free_port  # noqa: E402

SPEC = {"model": "mlp", "global_batch_size": 8, "steps": 3,
        "dtype": "float32", "learning_rate": 0.01, "warmup_steps": 1,
        "checkpoint": {"enabled": False}}


def _result(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("KFT_", "TPU_WORKER")):
            monkeypatch.delenv(key)
    return monkeypatch


def test_main_from_the_spec_env_prints_the_jax_launchers_keys(
        clean_env, capsys, devices8):
    clean_env.setenv("KFT_TRAINING_SPEC", json.dumps(
        {**SPEC, "mesh": {"data": 8}}))
    assert jlauncher.main([]) == 0
    want = _result(capsys.readouterr().out)
    clean_env.setenv("KFT_TRAINING_SPEC", json.dumps(SPEC))
    assert launcher.main(["--device", "cpu"]) == 0
    got = _result(capsys.readouterr().out)
    assert set(want) <= set(got)
    assert got["job"] == want["job"] == "local"
    assert got["final_step"] == want["final_step"] == 3
    assert got["world_size"] == 1 and got["grad_allreduces"] == 0
    assert [s for s, _ in got["losses"]] == [1, 2, 3]


def test_main_from_a_config_file_and_resume(clean_env, capsys, tmp_path):
    path = tmp_path / "job.json"
    ckpt = str(tmp_path / "ckpt")
    path.write_text(json.dumps({**SPEC, "steps": 2, "checkpoint": {
        "directory": ckpt, "async_save": False}}))
    assert launcher.main(["--config", str(path), "--device", "cpu"]) == 0
    first = _result(capsys.readouterr().out)
    assert first["final_step"] == 2
    # KFT_RESTORE_DIR turns on the resume: step 3 alone runs
    clean_env.setenv("KFT_RESTORE_DIR", ckpt)
    assert launcher.main(["--config", str(path), "--device", "cpu",
                          "--steps", "3"]) == 0
    resumed = _result(capsys.readouterr().out)
    assert resumed["final_step"] == 3
    assert [s for s, _ in resumed["losses"]] == [3]
    yaml_path = tmp_path / "job.yaml"
    yaml_path.write_text("model: mlp\nglobal_batch_size: 4\nsteps: 1\n"
                         "dtype: float32\ncheckpoint: {enabled: false}\n")
    assert launcher.main(["--config", str(yaml_path), "--device", "cpu"]) == 0
    assert _result(capsys.readouterr().out)["final_step"] == 1


@pytest.mark.parametrize("key", ["KFT_PROFILER_LOGDIR", "KFT_PROFILER_PORT"])
def test_profiler_knobs_are_refused(clean_env, capsys, key, tmp_path,
                                    monkeypatch):
    """No knob is refused any more: the logdir serves the profiler
    endpoint for the run's length (a port alone serves nothing, as in
    the JAX launcher), and the run ends with it stopped."""
    clean_env.setenv(key, str(tmp_path) if "LOGDIR" in key else "9431")
    if "LOGDIR" in key:
        clean_env.setenv("KFT_PROFILER_PORT", "0")
    clean_env.setenv("KFT_TRAINING_SPEC", json.dumps(SPEC))
    served = []
    start = launcher.maybe_start_profiler_server

    def spy(environ=None, device=None):
        server = start(environ, device)
        served.append(server)
        return server

    monkeypatch.setattr(launcher, "maybe_start_profiler_server", spy)
    assert launcher.main(["--device", "cpu"]) == 0
    assert _result(capsys.readouterr().out)["final_step"] == 3
    (server,) = served
    if "LOGDIR" in key:
        assert server is not None and server.port > 0
        # stopped in the launcher's finally
        assert not server._thread.is_alive()
        assert server._httpd.socket.fileno() == -1
    else:
        assert server is None


def test_debug_server_on_the_coordinator_only(clean_env):
    assert launcher.maybe_start_debug_server({}) is None
    server = launcher.maybe_start_debug_server({"KFT_DEBUG_PORT": "0"})
    try:
        assert server is not None and server.port > 0
    finally:
        server.stop()
    assert launcher.maybe_start_debug_server(
        {"KFT_DEBUG_PORT": "0", "KFT_PROCESS_ID": "1"}) is None


def test_a_two_rank_gang_through_the_module_entry_point():
    envs = render_gang_env("launch", ["127.0.0.1"] * 2,
                           coordinator_port=free_port())
    spec = {**SPEC, "mesh": {"data": 2}}
    procs = []
    try:
        for e in envs:
            env = dict(os.environ, **e, KFT_TRAINING_SPEC=json.dumps(spec),
                       OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
                 "--device", "cpu"], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        results = []
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
            results.append(_result(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for res in results:
        assert res["job"] == "launch" and res["world_size"] == 2
        assert res["grad_allreduces"] == 3 and res["final_step"] == 3
        assert res["losses"] == results[0]["losses"]
