"""The profiler endpoint and the Tensorboard CR that fronts its traces:
runtime/profiler.py, runtime/launcher.py `maybe_start_profiler_server`,
controllers/gpujob.py's KFT_PROFILER_* env and controllers/tensorboard.py,
held against the JAX package's (tests/test_profiler.py,
tests/test_tensorboard.py) on the CPU.

- The service's state machine and replies are the JAX service's: a
  double start and a stray stop answer 400, and `status` has the same
  keys and values before and after captures.
- A capture started and stopped by the REST handler thread records the
  ops another thread runs meanwhile (`torch.profiler` records only the
  starting thread unless `profile_all_threads` is set), and lands as a
  Chrome trace in the reference's `<logdir>/plugins/profile/<run>/`.
- The launcher serves it on a real socket at port 0, only on the
  coordinator.
- `GPUTrainJobController` renders the JAX `TPUTrainJobController`'s
  KFT_PROFILER_* for the same `training` spec, and both Tensorboard
  controllers render the same Deployment, Service and VirtualService.
"""

import json
import os
import threading
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.api.wsgi import Server  # noqa: E402
from kubeflow_tpu_torch.runtime.launcher import (  # noqa: E402
    DEFAULT_PROFILER_PORT,
    maybe_start_profiler_server,
)
from kubeflow_tpu_torch.runtime.profiler import (  # noqa: E402
    ProfilerService,
    build_app,
    count_kernel_events,
)
from kubeflow_tpu_torch.utils.metrics import default_registry  # noqa: E402


def _events(run_dir):
    (name,) = os.listdir(run_dir)
    assert name.endswith(".pt.trace.json"), name
    with open(os.path.join(run_dir, name)) as f:
        return json.load(f)["traceEvents"]


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class TestProfilerService:
    def test_status_reply_is_the_jax_services(self, tmp_path):
        from kubeflow_tpu.runtime.profiler import (
            ProfilerService as JProfilerService,
            build_app as jbuild_app,
        )

        logdir = str(tmp_path / "traces")
        want = jbuild_app(JProfilerService(logdir)).handle(
            "GET", "/profiler/status")
        got = build_app(ProfilerService(logdir, device="cpu")).handle_full(
            "GET", "/profiler/status")[:2]
        assert got == want == (200, {"active": False, "logdir": logdir,
                                     "runs": 0})

    def test_double_start_and_stray_stop_rejected(self, tmp_path):
        from kubeflow_tpu.runtime.profiler import (
            ProfilerService as JProfilerService,
            build_app as jbuild_app,
        )

        japp = jbuild_app(JProfilerService(str(tmp_path / "jax")))
        app = build_app(ProfilerService(str(tmp_path), device="cpu"))
        status, body, _ = app.handle_full("POST", "/profiler/stop")
        assert (status, body) == japp.handle("POST", "/profiler/stop") == (
            400, {"success": False, "log": "no active trace"})
        assert app.handle_full("POST", "/profiler/start", body={})[:2] == (
            200, {"active": True, "logdir": str(tmp_path)})
        status, body, _ = app.handle_full("POST", "/profiler/start", body={})
        assert status == 400 and "already active" in body["log"]
        assert app.handle_full("GET", "/profiler/status")[1]["active"]
        status, body, _ = app.handle_full("POST", "/profiler/stop")
        assert status == 200 and body["active"] is False
        assert len(body["trace_dirs"]) == 1

    def test_rest_thread_capture_records_another_threads_ops(self, tmp_path):
        """The launcher's REST handler thread drives the capture while the
        training loop runs on another thread: the trace must hold that
        thread's ops, in the reference's run layout."""
        logdir = str(tmp_path / "traces")
        captures = default_registry().get("profiler_captures_total")
        before = captures.value() if captures is not None else 0.0
        server = Server(build_app(ProfilerService(logdir, device="cpu")))
        server.start()
        stop, steps, tids = threading.Event(), [], []
        a = torch.randn(32, 32)

        def train():
            tids.append(threading.get_native_id())
            while not stop.is_set():
                (a @ a).sum()
                steps.append(1)

        worker = threading.Thread(target=train, daemon=True)
        worker.start()
        try:
            assert _post(server.port, "/profiler/start")["active"] is True
            n = len(steps)
            deadline = time.monotonic() + 10
            while len(steps) < n + 20 and time.monotonic() < deadline:
                time.sleep(0.01)
            reply = _post(server.port, "/profiler/stop")
            status = _get(server.port, "/profiler/status")
        finally:
            stop.set()
            worker.join(timeout=10)
            server.stop()
        (run_dir,) = reply["trace_dirs"]
        # <logdir>/plugins/profile/<run>/, the TB profile plugin's layout
        assert os.path.dirname(run_dir) == os.path.join(
            logdir, "plugins", "profile")
        mm = [e for e in _events(run_dir) if e.get("name") == "aten::mm"]
        assert len(mm) >= 20
        # recorded on the training thread, not on the REST thread
        assert {e["tid"] for e in mm} == set(tids)
        assert status == {"active": False, "logdir": logdir, "runs": 1}
        assert default_registry().get(
            "profiler_captures_total").value() == before + 1

    def test_oneshot_capture(self, tmp_path):
        app = build_app(ProfilerService(str(tmp_path), device="cpu"))
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        status, body, _ = app.handle_full(
            "POST", "/profiler/capture", body={"duration_ms": 50})
        assert status == 200 and not body["active"]
        status, body, _ = app.handle_full(
            "POST", "/profiler/capture", body={"duration_ms": "soon"})
        assert status == 400 and "duration_ms" in body["log"]
        # a second capture is a second run beside the first
        app.handle_full("POST", "/profiler/capture", body={"duration_ms": 0})
        runs = app.handle_full("GET", "/profiler/status")[1]["runs"]
        assert runs == 2

    def test_kernel_events_are_counted_in_a_chrome_trace(self, tmp_path):
        path = tmp_path / "t.pt.trace.json"
        path.write_text(json.dumps({"traceEvents": [
            {"ph": "X", "cat": "kernel", "name": "flash_fwd"},
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm"},
            {"ph": "X", "cat": "kernel", "name": "gemm"}]}))
        assert count_kernel_events(str(path)) == 2

    def test_chip_smoke_ties_each_flash_launch_to_its_host_op(
            self, tmp_path):
        """chip_smoke.py phase 27a's accounting: each flash launch runs
        under a host op named for its kernel (`record_function`), so a
        launch whose kernel record CUPTI dropped still counts as that
        kernel's, by its external id or else by the op's span on its
        thread; any other launch without a record counts only as lost.
        The op's name and category are those a CPU capture writes."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                       "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        app = build_app(ProfilerService(str(tmp_path / "traces"),
                                        device="cpu"))
        app.handle_full("POST", "/profiler/start", body={})
        with torch.profiler.record_function("flash_fwd"):
            torch.ones(4).add_(1)
        (run_dir,) = app.handle_full("POST", "/profiler/stop")[1][
            "trace_dirs"]
        (name,) = os.listdir(run_dir)
        trace, kernels, lost = smoke.flash_trace_counts(
            os.path.join(run_dir, name))
        assert trace["hosted"] == {"flash_fwd": 1, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0}
        assert (kernels, lost) == (0, 0)

        events = []

        def op(name, ext, ts, tid=1):
            events.append({"ph": "X", "cat": "user_annotation", "name": name,
                           "pid": 7, "tid": tid, "ts": ts, "dur": 50,
                           "args": {"External id": ext}})

        def launch(corr, ext, ts, tid=1, symbol=None):
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": 7, "tid": tid,
                           "ts": ts, "dur": 1,
                           "args": {"External id": ext, "correlation": corr}})
            if symbol:
                events.append({"ph": "X", "cat": "kernel",
                               "name": f"void {symbol}<64>()", "pid": 0,
                               "tid": 7, "ts": 0, "dur": 1,
                               "args": {"External id": ext,
                                        "correlation": corr}})

        op("flash_fwd", 10, 100)
        launch(1, 10, 120, symbol="flash_fwd_bf16")
        op("flash_fwd", 11, 200)
        launch(2, 11, 220)  # dropped: tied by its external id
        op("flash_bwd_dq", 12, 300, tid=2)
        launch(3, 99, 320, tid=2)  # dropped: tied by the op's span
        op("flash_bwd_dkv", 13, 400, tid=2)
        launch(4, 98, 420, tid=2, symbol="flash_bwd_dkv_bf16")
        launch(5, 50, 500)  # no record, under no flash op
        launch(6, 51, 600, symbol="gemm")
        path = tmp_path / "t.pt.trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        trace, kernels, lost = smoke.flash_trace_counts(str(path))
        assert trace == {
            "counts": {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 1},
            "hosted": {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1},
            "under": {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 1},
            "dropped": {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 0}}
        assert (kernels, lost) == (3, 3)


class TestLauncherWiring:
    def test_disabled_without_env(self):
        assert maybe_start_profiler_server(environ={}, device="cpu") is None

    def test_env_serves_real_socket(self, tmp_path):
        server = maybe_start_profiler_server(
            environ={"KFT_PROFILER_LOGDIR": str(tmp_path / "traces"),
                     "KFT_PROFILER_PORT": "0"},
            device="cpu")
        assert isinstance(server, Server)
        try:
            body = _get(server.port, "/profiler/status")
            assert body == {"active": False,
                            "logdir": str(tmp_path / "traces"), "runs": 0}
        finally:
            server.stop()

    def test_only_the_coordinator_serves(self, tmp_path):
        env = {"KFT_PROFILER_LOGDIR": str(tmp_path), "KFT_PROFILER_PORT": "0"}
        assert maybe_start_profiler_server(
            dict(env, KFT_PROCESS_ID="1"), device="cpu") is None
        from kubeflow_tpu.runtime.launcher import (
            DEFAULT_PROFILER_PORT as JPORT,
        )

        assert DEFAULT_PROFILER_PORT == JPORT == 9431


def _tb_objects(pkg, logdir):
    """(Deployment spec, Service spec, VirtualService spec, Ready before
    and after the pod runs) of one Tensorboard CR, through `pkg`'s
    controllers."""
    import importlib

    reconciler = importlib.import_module(f"{pkg}.cluster.reconciler")
    store_mod = importlib.import_module(f"{pkg}.cluster.store")
    statefulset = importlib.import_module(f"{pkg}.controllers.statefulset")
    tensorboard = importlib.import_module(f"{pkg}.controllers.tensorboard")
    store = store_mod.StateStore()
    cm = reconciler.ControllerManager(store)
    cm.register(statefulset.DeploymentController())
    cm.register(tensorboard.TensorboardController())
    store.create(tensorboard.new_tensorboard("tb", "team-a", logdir=logdir))
    cm.run_until_idle(max_seconds=5)

    def ready():
        tb = store.get("Tensorboard", "tb", "team-a")
        return {c["type"]: c["status"]
                for c in tb["status"]["conditions"]}["Ready"]

    before = ready()
    store.patch_status("Pod", "tb-0", "team-a", {"phase": "Running"})
    cm.run_until_idle(max_seconds=5)
    return (store.get("Deployment", "tb", "team-a")["spec"],
            store.get("Service", "tb", "team-a")["spec"],
            store.get("VirtualService", "tensorboard-team-a-tb",
                      "team-a")["spec"],
            before, ready())


# Fields the port's Tensorboard controller renders differently from the
# JAX one: none (the same image, command, mount, Service and route).
TENSORBOARD_DIFFERENCES = {}


class TestTensorboardFronting:
    @pytest.mark.parametrize("logdir", ["gs://bkt/logs", "/logs/run1"])
    def test_both_controllers_render_the_same_objects(self, logdir):
        want = _tb_objects("kubeflow_tpu", logdir)
        got = _tb_objects("kubeflow_tpu_torch", logdir)
        assert got == want
        dep, svc, vs, before, after = got
        c = dep["template"]["spec"]["containers"][0]
        assert f"--logdir={logdir}" in c["command"]
        assert svc["ports"][0] == {"port": 9000, "targetPort": 6006}
        assert vs["http"][0]["match"][0]["uri"]["prefix"] == (
            "/tensorboard/team-a/tb/")
        assert (before, after) == ("False", "True")
        if logdir.startswith("gs://"):
            assert "volumes" not in dep["template"]["spec"]
        else:
            assert dep["template"]["spec"]["volumes"][0][
                "persistentVolumeClaim"]["claimName"] == "tb-logs"
            assert c["volumeMounts"][0]["mountPath"] == logdir

    def test_job_env_and_tensorboard_mount_share_logdir(self):
        """A profiled GPUTrainJob renders the JAX job's KFT_PROFILER_*,
        and a Tensorboard CR on the same logdir mounts it."""
        from kubeflow_tpu.cluster.reconciler import (
            ControllerManager as JManager,
        )
        from kubeflow_tpu.cluster.store import StateStore as JStore
        from kubeflow_tpu.controllers.tpujob import (
            TPUTrainJobController,
            new_tpu_train_job,
        )
        from kubeflow_tpu.runtime.executor import pod_env as jpod_env
        from kubeflow_tpu_torch.cluster.reconciler import ControllerManager
        from kubeflow_tpu_torch.cluster.store import StateStore
        from kubeflow_tpu_torch.controllers import (
            TensorboardController,
            new_tensorboard,
        )
        from kubeflow_tpu_torch.controllers.gpujob import (
            GPUTrainJobController,
            new_gpu_train_job,
        )
        from kubeflow_tpu_torch.runtime.executor import pod_env

        logdir = "/jobs/exp1/traces"
        training = {"model": "mlp", "global_batch_size": 8, "steps": 1,
                    "mesh": {"data": 4}, "profiler_logdir": logdir,
                    "checkpoint": {"enabled": False}}

        def profiler_env(env):
            return {k: v for k, v in env.items()
                    if k.startswith("KFT_PROFILER_")}

        jstore = JStore()
        jcm = JManager(jstore)
        jcm.register(TPUTrainJobController())
        jstore.create(new_tpu_train_job("exp1", slice_spec={
            "topology": "v5e-4"}, training=training))
        jcm.run_until_idle(max_seconds=10)
        want = [profiler_env(jpod_env(p)) for p in sorted(
            jstore.list("Pod", "default"),
            key=lambda p: p["metadata"]["name"])]

        store = StateStore()
        cm = ControllerManager(store)
        cm.register(GPUTrainJobController())
        cm.register(TensorboardController())
        store.create(new_gpu_train_job("exp1", slice_spec={
            "topology": "h100-4"}, training=training))
        store.create(new_tensorboard("exp1-tb", logdir=logdir))
        cm.run_until_idle(max_seconds=10)
        pods = sorted(store.list("Pod", "default"),
                      key=lambda p: p["metadata"]["name"])
        got = [profiler_env(pod_env(p)) for p in pods]
        # v5e-4 is one TPU host, h100-4 one pod a card: every pod carries
        # the JAX pod's env (only the coordinator serves it)
        assert len(want) == 1 and len(got) == 4 and got == want * 4
        assert got[0] == {"KFT_PROFILER_LOGDIR": logdir,
                          "KFT_PROFILER_PORT": "9431"}
        container = store.get("Deployment", "exp1-tb", "default")[
            "spec"]["template"]["spec"]["containers"][0]
        assert f"--logdir={logdir}" in container["command"]
        assert any(m["mountPath"] == logdir
                   for m in container.get("volumeMounts", []))
        assert TENSORBOARD_DIFFERENCES == {}
