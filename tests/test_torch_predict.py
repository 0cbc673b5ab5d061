"""The port's `:predict` path (kubeflow_tpu_torch/serving/server.py
`ServedModel`, serving/batching.py, the `:predict` and `:predict_npy`
routes, `build_server`'s non-causal branch) against the JAX package's on
the CPU, and the pool-telemetry repair of `build_server` (an auto-sized
pool follows the pressure an earlier engine left in the registry).

Both servers serve the same mlp weights (flax init carried over by
`params_from_jax`): predictions equal within atol 1e-6 (f32), status
codes equal, discovery bodies equal. A narrow resnet18 with its
batch_stats serves through `ServedModel(name, apply_fn, variables)` in
both packages within 1e-4 of the largest |logit|; `from_registry` of a
BatchNorm model refuses in both."""

import io
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.serving.engine import (  # noqa: E402
    resolve_num_pages as jresolve_num_pages,
)
from kubeflow_tpu.serving.server import (  # noqa: E402
    ModelServer as JModelServer,
    ServedModel as JServedModel,
)
from kubeflow_tpu_torch.api.wsgi import Server  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serving.batching import MicroBatcher  # noqa: E402
from kubeflow_tpu_torch.serving.kv_tiers import pool_sizing_telemetry  # noqa: E402
from kubeflow_tpu_torch.serving.main import (  # noqa: E402
    build_server,
    is_causal_family,
)
from kubeflow_tpu_torch.serving.server import (  # noqa: E402
    BATCH_BUCKETS,
    ModelServer,
    ServedModel,
    bucket_for,
)
from kubeflow_tpu_torch.utils import metrics  # noqa: E402

ATOL = 1e-6


@pytest.fixture(scope="module")
def mlp_pair():
    """(JAX ServedModel, port ServedModel) of one mlp (16 hidden, 4
    classes, 8 inputs), the reference's `mlp_served` fixture."""
    jm = jget_model("mlp", hidden=(16,), num_classes=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))["params"]
    ref = JServedModel("mlp", lambda p, x: jm.apply({"params": p}, x), params)
    model = get_model("mlp", hidden=(16,), num_classes=4, in_features=8,
                      device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    port = ServedModel("mlp", lambda m, x: m(x), model, device="cpu")
    return ref, port


def test_bucketing_equals_the_reference():
    from kubeflow_tpu.serving.server import BATCH_BUCKETS as J_BUCKETS
    from kubeflow_tpu.serving.server import bucket_for as jbucket_for

    assert BATCH_BUCKETS == J_BUCKETS
    for n in (1, 2, 3, 5, 64, 100, 128, 129, 1000):
        assert bucket_for(n) == jbucket_for(n)


@pytest.mark.parametrize("rows", [0, 1, 3, 8, 100, 130, 300])
def test_predict_array_equals_the_reference(mlp_pair, rows):
    """Padding to a bucket, chunking past the largest, the empty request."""
    ref, port = mlp_pair
    x = np.random.default_rng(rows).standard_normal((rows, 8)).astype(
        np.float32)
    want, got = ref.predict_array(x), port.predict_array(x)
    assert got.shape == want.shape == (rows, 4) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert port.predict(x[:0].tolist()) == ref.predict([]) == []


def test_predict_lists_and_determinism(mlp_pair):
    ref, port = mlp_pair
    inst = [[0.5] * 8, [0.1] * 8, [0.0] * 8]
    a, b = port.predict(inst), port.predict(inst)
    assert a == b and len(a) == 3 and len(a[0]) == 4
    np.testing.assert_allclose(a, ref.predict(inst), atol=ATOL)


def _servers(mlp_pair):
    ref, port = mlp_pair
    jserver, pserver = JModelServer(), ModelServer()
    jserver.add(ref)
    pserver.add(port)
    return jserver, pserver


def _handle(app, method, path, body=None):
    """(status, body) from either package's App."""
    if hasattr(app, "handle_full"):
        return app.handle_full(method, path, body)[:2]
    return app.handle(method, path, body=body)[:2]


def _npy(x):
    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    return buf.getvalue()


def test_predict_and_npy_routes_equal_the_reference(mlp_pair):
    jserver, pserver = _servers(mlp_pair)
    x = np.random.default_rng(0).random((3, 8)).astype(np.float32)
    for s in (jserver, pserver):
        status, body = _handle(s.app, "POST", "/v1/models/mlp:predict",
                                    body={"instances": x.tolist()})[:2]
        assert status == 200
        if s is jserver:
            want = np.asarray(body["predictions"])
        else:
            np.testing.assert_allclose(body["predictions"], want, atol=ATOL)
    status, body, headers = pserver.app.handle_full(
        "POST", "/v1/models/mlp:predict_npy", body=_npy(x))
    jstatus, jbody = _handle(jserver.app, "POST", "/v1/models/mlp:predict_npy",
                                        body=_npy(x))[:2]
    assert status == jstatus == 200
    assert body.content_type == jbody.content_type == "application/octet-stream"
    got = np.load(io.BytesIO(body.body), allow_pickle=False)
    np.testing.assert_allclose(got, np.load(io.BytesIO(jbody.body)), atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)
    names = [h for h, _ in headers]
    assert names == [h for h, _ in jbody.headers] == [
        "X-Parse-Ms", "X-Compute-Ms", "X-Serialize-Ms", "X-Transfer-In-Ms",
        "X-Device-Ms", "X-Transfer-Out-Ms", "X-Device-Batch-Rows"]
    assert dict(headers)["X-Device-Batch-Rows"] == "4.00"


BAD = [
    ("/v1/models/mlp:predict", {}),
    ("/v1/models/nope:predict", {"instances": [[0.0] * 8]}),
    ("/v1/models/mlp:predict", {"instances": [["x"] * 8]}),
    ("/v1/models/mlp:predict", {"instances": [[0.0] * 5]}),
    ("/v1/models/mlp:predict_npy", {"instances": [[0.0] * 8]}),
    ("/v1/models/mlp:predict_npy", b"not-an-npy"),
    ("/v1/models/ghost:predict_npy", _npy(np.zeros((1, 8)))),
    ("/v1/models/mlp:predict_npy", _npy(np.float32(3.0))),
    ("/v1/models/mlp:predict_npy", _npy(np.array(["a", "b"]))),
    ("/v1/models/mlp:predict", {"instances": []}),
]


@pytest.mark.parametrize("path,body", BAD, ids=[f"{p} {str(b)[:20]}"
                                                for p, b in BAD])
def test_error_codes_equal_the_reference(mlp_pair, path, body):
    jserver, pserver = _servers(mlp_pair)
    want = _handle(jserver.app, "POST", path, body)[0]
    assert _handle(pserver.app, "POST", path, body)[0] == want


def test_postprocessed_model_refuses_npy_in_both(mlp_pair):
    ref, port = mlp_pair
    jserver, pserver = JModelServer(), ModelServer()
    jserver.add(JServedModel("pp", ref._jitted, ref.params,
                             postprocess=lambda r: int(r.argmax())))
    pserver.add(ServedModel("pp", port._apply, port.params, device="cpu",
                            postprocess=lambda r: int(r.argmax())))
    x = np.zeros((2, 8), np.float32)
    for s in (jserver, pserver):
        assert _handle(s.app, "POST", "/v1/models/pp:predict_npy",
                            body=_npy(x))[0] == 400
    assert _handle(pserver.app, "POST", "/v1/models/pp:predict", body={
        "instances": x.tolist()})[1] == _handle(jserver.app, "POST", "/v1/models/pp:predict", body={"instances": x.tolist()})[1]


@pytest.mark.parametrize("path", ["/v1/models", "/v1/models/mlp",
                                  "/v1/models/nope", "/healthz"])
def test_discovery_bodies_equal_the_reference(mlp_pair, path):
    jserver, pserver = _servers(mlp_pair)
    assert _handle(pserver.app, "GET", path)[:2] == _handle(jserver.app, "GET", path)[:2]


def test_statusz_lists_the_predict_model(mlp_pair):
    _, pserver = _servers(mlp_pair)
    status, body = _handle(pserver.app, "GET", "/statusz")[:2]
    text = body.body.decode() if hasattr(body, "body") else str(body)
    assert status == 200 and "mlp (predict, version 1)" in text
    pserver.remove("mlp")
    assert _handle(pserver.app, "GET", "/v1/models/mlp")[0] == 404


def test_npy_over_a_socket_with_micro_batching(mlp_pair):
    ref, port = mlp_pair
    served = ServedModel("mlp-b", port._apply, port.params, device="cpu",
                         batch_window_ms=20.0)
    server = ModelServer()
    server.add(served)
    httpd = Server(server.app, port=0)
    httpd.start()
    import urllib.request

    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(6)]
    got = [None] * 6

    def client(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}/v1/models/mlp-b:predict_npy",
            data=_npy(xs[i]), method="POST",
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            got[i] = (np.load(io.BytesIO(resp.read())), dict(resp.headers))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.stop()
        server.close()
    for x, (y, headers) in zip(xs, got):
        np.testing.assert_allclose(y, ref.predict_array(x), atol=ATOL)
        assert float(headers["X-Device-Batch-Rows"]) >= 2.0
    stats = served.batch_stats()
    assert stats["fused_batches"] < 6 and stats["fused_rows_mean"] > 2.0


def test_warmup_runs_every_bucket_through_the_serving_thread(mlp_pair):
    _, port = mlp_pair
    seen = []
    served = ServedModel("mlp-w", lambda m, x: (seen.append(
        (x.shape[0], threading.current_thread().name)), m(x))[1],
        port.params, device="cpu", batch_window_ms=1.0)
    try:
        served.warmup((8,), np.float32, max_rows=20)
    finally:
        served.close()
    assert [n for n, _ in seen] == [1, 2, 4, 8, 16, 32]
    assert {t for _, t in seen} == {"microbatch-mlp-w"}


# -- the micro-batcher ----------------------------------------------------


def test_concurrent_submits_fuse_into_fewer_device_calls():
    calls = []

    def run(x):
        calls.append(x.shape[0])
        return x * 2.0

    mb = MicroBatcher(run, max_rows=64, window_ms=30.0)
    try:
        results = {}

        def client(i):
            results[i] = mb.submit(np.full((2, 3), float(i), np.float32))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        for i in range(6):
            np.testing.assert_allclose(results[i], np.full((2, 3), 2.0 * i))
        assert sum(calls) == 12 and len(calls) < 6
    finally:
        mb.close()


def test_mixed_shapes_batch_apart_and_an_error_fails_only_its_request():
    def run(x):
        if x.shape[1:] == (5,):
            raise ValueError("device exploded")
        return x.sum(axis=tuple(range(1, x.ndim)))

    mb = MicroBatcher(run, window_ms=30.0)
    out = {}

    def client(key, shape):
        try:
            out[key] = mb.submit(np.ones(shape, np.float32))
        except ValueError as e:
            out[key] = e

    try:
        threads = [threading.Thread(target=client, args=("a", (2, 4))),
                   threading.Thread(target=client, args=("b", (3, 5))),
                   threading.Thread(target=client, args=("c", (1, 4)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        mb.close()
    np.testing.assert_allclose(out["a"], [4.0, 4.0])
    np.testing.assert_allclose(out["c"], [4.0])
    assert isinstance(out["b"], ValueError)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.ones((1, 4), np.float32))


# -- ResNet: the constructor path and from_registry's refusal --------------


@pytest.fixture(scope="module")
def resnet18_variables():
    jm = jget_model("resnet18", num_classes=10, num_filters=8,
                    dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    rng = np.random.default_rng(2)
    variables = flax.core.unfreeze(jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
            np.float32), variables))
    return jm, variables


def test_a_resnet_serves_through_the_constructor_path_as_in_jax(
        resnet18_variables):
    jm, variables = resnet18_variables
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    ref = JServedModel("r18", lambda v, x: jm.apply(v, x, train=False),
                       variables)
    model = get_model("resnet18", num_classes=10, num_filters=8,
                      dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables["batch_stats"]))
    port = ServedModel("r18", lambda m, x: m(x, train=False), model,
                       device="cpu")
    x = np.random.default_rng(0).standard_normal((5, 32, 32, 3)).astype(
        np.float32)
    want, got = ref.predict_array(x), port.predict_array(x)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_from_registry_of_a_batchnorm_model_refuses_in_both(
        resnet18_variables):
    """The JAX package's `from_registry` applies params only, so flax finds
    no batch_stats at the first predict; the port refuses at build time,
    naming them."""
    _, variables = resnet18_variables
    ref = JServedModel.from_registry("resnet18", params=variables["params"],
                                     num_classes=10, num_filters=8)
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        ref.predict_array(np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="batch_stats"):
        ServedModel.from_registry("resnet18", params=variables["params"],
                                  num_classes=10, num_filters=8, device="cpu")


def test_from_registry_serves_the_mlp_from_flax_params(mlp_pair):
    ref, port = mlp_pair
    served = ServedModel.from_registry(
        "mlp", params=jax.tree.map(np.asarray, ref.params), hidden=(16,),
        num_classes=4, in_features=8, device="cpu")
    x = np.ones((3, 8), np.float32)
    np.testing.assert_allclose(served.predict_array(x), ref.predict_array(x),
                               atol=ATOL)


def test_build_server_serves_predict_for_non_causal_models():
    """The registry mlp (default widths) through both packages'
    build_server: the :predict branch with its 2 ms batch window."""
    from kubeflow_tpu.serving.main import build_server as jbuild_server

    assert is_causal_family("gpt_tiny") and not is_causal_family("mlp")
    assert not is_causal_family("resnet50")
    jm = jget_model("mlp")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 192)))["params"]
    ref = jbuild_server("mlp", params=params)
    server = build_server("mlp", device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, params)))
    try:
        x = np.random.default_rng(0).random((3, 192)).astype(np.float32)
        body = {"instances": x.tolist()}
        status, got = _handle(server.app, "POST", "/v1/models/mlp:predict",
                                        body=body)[:2]
        jstatus, want = _handle(ref.app, "POST", "/v1/models/mlp:predict",
                                       body=body)[:2]
        assert status == jstatus == 200
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   atol=ATOL)
        assert server._models["mlp"].batch_stats()["fused_batches"] == 1.0
    finally:
        server.close()
        ref.close()
    with pytest.raises(ValueError, match="batch_stats"):
        build_server("resnet18", device="cpu",
                     params={n: p for n, p in get_model(
                         "resnet18", device="cpu").named_parameters()})


# -- C5: an auto-sized pool follows the registry's telemetry ---------------


def test_an_auto_pool_follows_an_earlier_engines_pressure(monkeypatch,
                                                          gpt_and_params):
    """Two build_server calls in one process over a fresh registry: the
    first engine serves one short request and leaves its low page
    utilisation in the registry; the second's auto-sized pool is what the
    JAX `resolve_num_pages` gives with that telemetry (16 pages), not
    the static rule's 24."""
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    for knob in ("NUM_SLOTS", "PAGE_SIZE", "NUM_PAGES", "PREFIX_CACHE",
                 "QUANTIZE"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    knobs = dict(device="cpu", dtype=torch.float32, num_slots=2, page_size=8)
    first = build_server("gpt_tiny", **knobs)
    try:
        assert first.engine("gpt_tiny").num_pages == 24
        row = np.arange(1, 13, dtype=np.int64)
        first.engine("gpt_tiny").submit(row, 4).wait(60)
    finally:
        first.close()
    telemetry = pool_sizing_telemetry()
    assert telemetry is not None and telemetry["pages_utilization"] < 0.5
    jcfg = jget_model("gpt_tiny", dtype=jnp.float32).cfg
    want = jresolve_num_pages(None, 2, jcfg, 8, telemetry=telemetry)
    second = build_server("gpt_tiny", **knobs)
    try:
        assert second.engine("gpt_tiny").num_pages == want == 16
    finally:
        second.close()
    # an explicit pool ignores the telemetry
    third = build_server("gpt_tiny", num_pages=24, **knobs)
    try:
        assert third.engine("gpt_tiny").num_pages == 24
    finally:
        third.close()
