"""The port's InferenceService controller (kubeflow_tpu_torch/controllers/
inference.py) against the JAX package's, on the CPU, without a server.

For each spec both controllers reconcile it with their own
DeploymentController on their own store; the Deployment, Service,
VirtualService, `<name>-prefill` Deployment, `<name>-router` Deployment
and Service and the `Ready` condition (before and after the first pod
runs) must be equal, apart from three listed differences
(`DIFFERENCES`):

1. the modules: `kubeflow_tpu_torch.serving.main` for
   `kubeflow_tpu.serving.main`, `kubeflow_tpu_torch.routing` for
   `kubeflow_tpu.routing` (the router pod requests no accelerator in
   either package);
2. the accelerator request: `nvidia.com/gpu: m` (m = the serving mesh's
   cards) and the H100 node selector for `google.com/tpu` and the TPU
   slice's selectors, where a spec names a topology (`h100-m` for a TPU
   slice of m chips on one host);
3. `paged_attention`'s vocabulary: the port's CUDA page walk is
   `kernel`, the JAX package's TPU one `pallas`.

The pod env must equal the JAX `_serving_env`'s key for key, but for
`KFT_SERVING_PAGED_ATTENTION` (3). The JAX package's controller cases
(tests/test_serving.py TestInferenceServiceController, test_chaos.py,
test_spec_decode.py TestPlatformWiring, test_observability.py and
test_tracing.py) run here on the port's. Every JAX `ServingConfig`
ConfigError case raises in the port with the same fragment, `disagg.enabled`
without `router.enabled` included. `router`, the prefill tier's
knobs, and `autoscale` beside `disagg` load as the JAX package's do, and
a replica's topology must match its mesh on one node.
"""

import copy

import pytest

from kubeflow_tpu.cluster.reconciler import ControllerManager as JManager
from kubeflow_tpu.cluster.store import StateStore as JStore
from kubeflow_tpu.config.core import ConfigError as JConfigError
from kubeflow_tpu.config.core import from_dict as jfrom_dict
from kubeflow_tpu.config.platform import ServingConfig as JServingConfig
from kubeflow_tpu.controllers.inference import (
    InferenceServiceController as JController,
)
from kubeflow_tpu.controllers.inference import (
    new_inference_service as jnew_inference_service,
)
from kubeflow_tpu.controllers.statefulset import (
    DeploymentController as JDeploymentController,
)
from kubeflow_tpu_torch.cluster.reconciler import ControllerManager
from kubeflow_tpu_torch.cluster.store import StateStore
from kubeflow_tpu_torch.config.platform import (
    GPU_ACCELERATOR_LABEL,
    H100_ACCELERATOR,
    ConfigError,
    ServingConfig,
)
from kubeflow_tpu_torch.controllers import (
    DeploymentController,
    InferenceServiceController,
    new_inference_service,
)

NS = "team-a"
# the three differences the port's rendering may show against the JAX one
DIFFERENCES = {
    "module": ("kubeflow_tpu.serving.main", "kubeflow_tpu_torch.serving.main"),
    "router_module": ("kubeflow_tpu.routing", "kubeflow_tpu_torch.routing"),
    "accelerator": ("google.com/tpu", "nvidia.com/gpu"),
    "paged_attention": ("pallas", "kernel"),
}
# a TPU slice of m chips on one host and the H100 topology of m cards
TOPOLOGIES = {"v5e-1": "h100-1", "v5e-4": "h100-4", "v5e-8": "h100-8"}


def _port_serving(serving):
    """A JAX spec.serving in the port's terms: `pallas` is `kernel`."""
    serving = copy.deepcopy(serving or {})
    if serving.get("paged_attention") == "pallas":
        serving["paged_attention"] = "kernel"
    return serving


# (id, model, JAX topology, JAX spec.serving, JAX platform defaults)
SPECS = [
    ("resnet50_topology", "resnet50", "v5e-1", {}, {}),
    ("gpt_small_overrides", "gpt_small", "", {
        "max_queue": 16, "prefill_buckets": [8, 32]}, {"num_slots": 4}),
    ("drafts", "gpt_small", "", {"num_draft_tokens": 2}, {
        "draft_model": "gpt_tiny", "num_draft_tokens": 4,
        "draft_checkpoint_dir": "/ckpt/draft"}),
    ("chaos_armed", "gpt_tiny", "", {"chaos": {
        "enabled": True, "seed": 3, "points": ["engine.step:p=0.5"]}}, {}),
    ("chaos_unarmed", "gpt_tiny", "", {"chaos": {
        "enabled": False, "points": ["engine.step:p=0.5"]}}, {}),
    ("trace_sampling", "gpt_tiny", "", {"observability": {
        "trace_sample_prob": 0.25, "trace_buffer_spans": 99}}, {}),
    ("statusz_off", "gpt_tiny", "", {"observability": {
        "statusz_enabled": False, "trace_enabled": False}}, {}),
    ("kv_tiers", "gpt_small", "", {
        "kv_host_bytes": 1 << 20, "kv_persist_dir": "/kv/store",
        "kv_persist_interval_s": 90, "kv_persist_chains": 32,
        "page_size": 8, "num_pages": 24}, {}),
    ("disagg", "gpt_small", "", {
        "disagg": {"enabled": True, "prefill_replicas": 2,
                   "handoff_chains": 16},
        "router": {"enabled": True}}, {}),
    ("router", "gpt_small", "v5e-1", {
        "page_size": 8, "num_slots": 4,
        "router": {"enabled": True, "spill_queue_per_slot": 1.5,
                   "retry_budget": 4}}, {}),
    ("router_spray_statusz_off", "gpt_tiny", "", {
        "router": {"enabled": True, "affinity": False},
        "observability": {"statusz_enabled": False}}, {}),
    ("disagg_autoscaled", "gpt_small", "", {
        "disagg": {"enabled": True, "prefill_replicas": 1,
                   "max_prefill_replicas": 3, "cold_hit_rate": 0.5},
        "autoscale": {"enabled": True, "max_replicas": 3},
        "router": {"enabled": True}}, {}),
    ("mesh_tensor2_fsdp2", "gpt_small", "v5e-4", {
        "mesh": {"tensor": 2, "fsdp": 2}}, {}),
    ("kernel_int8_drain", "gpt_small", "v5e-1", {
        "paged_attention": "pallas", "quantize": "int8",
        "drain_deadline_s": 12, "prefix_cache": False}, {}),
]


def _reconcile(pkg, model, topology, serving, defaults):
    """Reconcile one InferenceService `svc` → ({object: rendering},
    [Ready condition before, after the first pod runs])."""
    if pkg == "jax":
        store = JStore()
        cm = JManager(store)
        cm.register(JDeploymentController())
        cm.register(JController(serving_defaults=jfrom_dict(
            JServingConfig, defaults)))
        cr = jnew_inference_service("svc", NS, model=model,
                                    checkpoint_dir="/ckpt/run",
                                    tpu_topology=topology, serving=serving)
    else:
        store = StateStore()
        cm = ControllerManager(store)
        cm.register(DeploymentController())
        cm.register(InferenceServiceController(
            serving_defaults=ServingConfig.from_dict(
                _port_serving(defaults))))
        cr = new_inference_service("svc", NS, model=model,
                                   checkpoint_dir="/ckpt/run",
                                   gpu_topology=TOPOLOGIES.get(topology, ""),
                                   serving=_port_serving(serving))
    store.create(cr)
    cm.run_until_idle(max_seconds=5)

    def ready():
        cond = [c for c in store.get("InferenceService", "svc", NS)[
            "status"]["conditions"] if c["type"] == "Ready"]
        return {k: cond[0][k] for k in ("status", "reason")}

    conds = [ready()]
    store.patch_status("Pod", "svc-0", NS, {"phase": "Running"})
    cm.run_until_idle(max_seconds=5)
    conds.append(ready())
    out = {}
    for kind, name in (("Deployment", "svc"), ("Service", "svc"),
                       ("VirtualService", f"inference-{NS}-svc"),
                       ("Deployment", "svc-prefill"),
                       ("Deployment", "svc-router"),
                       ("Service", "svc-router")):
        obj = store.try_get(kind, name, NS)
        out[(kind, name)] = None if obj is None else {
            "apiVersion": obj["apiVersion"],
            "labels": obj["metadata"]["labels"],
            "owners": [(r["kind"], r["name"])
                       for r in obj["metadata"].get("ownerReferences", [])],
            "spec": obj["spec"],
            "status": obj["status"],
        }
    return out, conds


def _as_port(objs, cards):
    """The JAX rendering with the listed differences applied."""
    objs = copy.deepcopy(objs)
    for (kind, _), obj in objs.items():
        if obj is None or kind != "Deployment":
            continue
        pod = obj["spec"]["template"]["spec"]
        for c in pod["containers"]:
            modules = dict(DIFFERENCES[k]
                           for k in ("module", "router_module"))
            c["command"] = [modules.get(a, a) for a in c["command"]]
            for e in c["env"]:
                if (e["name"] == "KFT_SERVING_PAGED_ATTENTION"
                        and e["value"] == DIFFERENCES["paged_attention"][0]):
                    e["value"] = DIFFERENCES["paged_attention"][1]
            if "resources" in c:
                chips = c["resources"]["limits"].pop(
                    DIFFERENCES["accelerator"][0])
                assert not c["resources"]["limits"]
                # the TPU host's chips are the replica's cards
                assert int(chips) == cards
                c["resources"]["limits"][DIFFERENCES["accelerator"][1]] = \
                    str(cards)
        if "nodeSelector" in pod:
            pod["nodeSelector"] = {GPU_ACCELERATOR_LABEL: H100_ACCELERATOR}
    return objs


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_the_rendered_objects_equal_the_jax_controllers(spec):
    _, model, topology, serving, defaults = spec
    want, want_ready = _reconcile("jax", model, topology, serving, defaults)
    got, got_ready = _reconcile("port", model, topology, serving, defaults)
    cards = InferenceServiceController(
        serving_defaults=ServingConfig.from_dict(_port_serving(defaults))
    )._serving_cfg({"serving": _port_serving(serving)}).mesh.num_devices
    assert got == _as_port(want, cards)
    assert got_ready == want_ready == [
        {"status": "False", "reason": "Pending"},
        {"status": "True", "reason": "Available"}]
    dep = got[("Deployment", "svc")]["spec"]["template"]["spec"]
    assert dep["containers"][0]["command"][2] == \
        "kubeflow_tpu_torch.serving.main"
    if topology:
        assert dep["containers"][0]["resources"]["limits"] == {
            "nvidia.com/gpu": str(cards)}
    # the prefill tier exactly when the spec splits the fleet, the router
    # exactly when the spec asks for it; the router requests no card
    split = "disagg" in serving and serving["disagg"].get("enabled")
    assert (got[("Deployment", "svc-prefill")] is not None) == bool(split)
    router = got[("Deployment", "svc-router")]
    assert (router is not None) == ("router" in serving)
    if router is not None:
        pod = router["spec"]["template"]["spec"]
        assert pod["containers"][0]["command"][:3] == [
            "python", "-m", "kubeflow_tpu_torch.routing"]
        assert "resources" not in pod["containers"][0]
        assert "nodeSelector" not in pod


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_the_pod_env_equals_the_jax_serving_env_key_for_key(spec):
    _, _, _, serving, defaults = spec
    want = JController(serving_defaults=jfrom_dict(
        JServingConfig, defaults))._serving_env({"serving": serving})
    got = InferenceServiceController(
        serving_defaults=ServingConfig.from_dict(_port_serving(defaults))
    )._serving_env({"serving": _port_serving(serving)})
    if want["KFT_SERVING_PAGED_ATTENTION"] == "pallas":
        want["KFT_SERVING_PAGED_ATTENTION"] = "kernel"
    assert got == want


# -- the JAX package's controller cases, on the port's ------------------------


def _harness(**kw):
    store = StateStore()
    cm = ControllerManager(store)
    cm.register(DeploymentController())
    cm.register(InferenceServiceController(**kw))
    return store, cm


def _env(store, name, ns="default"):
    dep = store.get("Deployment", name, ns)
    return {e["name"]: e["value"]
            for e in dep["spec"]["template"]["spec"]["containers"][0]["env"]}


def test_renders_deployment_service_route():
    store, cm = _harness()
    store.create(new_inference_service(
        "resnet-serve", NS, model="resnet50", checkpoint_dir="gs://bkt/ckpt",
        gpu_topology="h100-1"))
    cm.run_until_idle(max_seconds=5)
    dep = store.get("Deployment", "resnet-serve", NS)
    c = dep["spec"]["template"]["spec"]["containers"][0]
    assert "--model" in c["command"] and "resnet50" in c["command"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert dep["spec"]["template"]["spec"]["nodeSelector"] == {
        GPU_ACCELERATOR_LABEL: H100_ACCELERATOR}
    svc = store.get("Service", "resnet-serve", NS)
    assert svc["spec"]["ports"][0]["port"] == 8500
    vs = store.get("VirtualService", "inference-team-a-resnet-serve", NS)
    assert vs["spec"]["http"][0]["match"][0]["uri"]["prefix"] == \
        "/models/team-a/resnet-serve/"
    # becomes Ready when the pod runs
    store.patch_status("Pod", "resnet-serve-0", NS, {"phase": "Running"})
    cm.run_until_idle(max_seconds=5)
    isvc = store.get("InferenceService", "resnet-serve", NS)
    conds = {c["type"]: c["status"] for c in isvc["status"]["conditions"]}
    assert conds["Ready"] == "True"


def test_renders_decode_engine_env():
    store, cm = _harness(serving_defaults=ServingConfig(num_slots=4))
    store.create(new_inference_service(
        "lm-serve", NS, model="gpt_small",
        serving={"max_queue": 16, "prefill_buckets": [8, 32]}))
    cm.run_until_idle(max_seconds=5)
    pod_spec = store.get("Deployment", "lm-serve", NS)["spec"]["template"][
        "spec"]
    # the kill grace covers the drain deadline plus the shutdown machinery
    assert pod_spec["terminationGracePeriodSeconds"] == 30 + 30
    assert _env(store, "lm-serve", NS) == {
        "KFT_SERVING_NUM_SLOTS": "4",
        "KFT_SERVING_MAX_QUEUE": "16",
        "KFT_SERVING_PREFILL_BUCKETS": "8,32",
        "KFT_SERVING_PAGE_SIZE": "16",
        "KFT_SERVING_NUM_PAGES": "0",
        "KFT_SERVING_PREFIX_CACHE": "1",
        "KFT_SERVING_PAGED_ATTENTION": "gather",
        "KFT_SERVING_QUANTIZE": "none",
        "KFT_SERVING_MESH_TENSOR": "1",
        "KFT_SERVING_MESH_FSDP": "1",
        "KFT_SERVING_MESH_EXPERT": "1",
        "KFT_SERVING_DRAFT_MODEL": "",
        "KFT_SERVING_DRAFT_TOKENS": "0",
        "KFT_SERVING_DRAFT_CHECKPOINT_DIR": "",
        "KFT_SERVING_DRAIN_DEADLINE_S": "30",
        "KFT_SERVING_KV_HOST_BYTES": "0",
        "KFT_SERVING_KV_PERSIST_DIR": "",
        "KFT_SERVING_KV_PERSIST_INTERVAL_S": "0",
        "KFT_SERVING_KV_PERSIST_CHAINS": "64",
        "KFT_TRACE_ENABLED": "1",
        "KFT_TRACE_BUFFER_SPANS": "4096",
        "KFT_TRACE_STATUSZ": "1",
        "KFT_TRACE_SAMPLE_PROB": "1",
        "KFT_TRACE_SAMPLE_KEEP": "128",
        "KFT_FLEET_METRICS_PORT": "8500",
    }


def test_invalid_spec_serving_rejected():
    with pytest.raises(ConfigError, match="powers of two"):
        InferenceServiceController()._serving_env(
            {"serving": {"prefill_buckets": [3]}})


def test_engine_knobs_env_roundtrip(monkeypatch):
    """serving/main.py parses exactly what the controller renders."""
    from kubeflow_tpu_torch.serving.main import engine_knobs_from_env

    env = InferenceServiceController()._serving_env({"serving": {
        "num_slots": 4, "max_queue": 16, "prefill_buckets": [8, 32],
        "page_size": 8, "num_pages": 24, "prefix_cache": True,
        "paged_attention": "kernel", "quantize": "int8",
        "mesh": {"tensor": 2, "fsdp": 2, "expert": 2},
        "draft_model": "gpt_tiny", "num_draft_tokens": 3,
        "draft_checkpoint_dir": "/ckpt/d", "drain_deadline_s": 12,
        "kv_host_bytes": 1048576, "kv_persist_dir": "/kv/store",
        "kv_persist_interval_s": 90, "kv_persist_chains": 32}})
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert engine_knobs_from_env() == {
        "num_slots": 4, "max_queue": 16, "prefill_buckets": [8, 32],
        "page_size": 8, "num_pages": 24, "prefix_cache": True,
        "paged_attention": "kernel", "quantize": "int8",
        "mesh_tensor": 2, "mesh_fsdp": 2, "mesh_expert": 2,
        "draft_model": "gpt_tiny", "num_draft_tokens": 3,
        "draft_checkpoint_dir": "/ckpt/d", "drain_deadline_s": 12.0,
        "kv_host_bytes": 1048576, "kv_persist_dir": "/kv/store",
        "kv_persist_interval_s": 90.0, "kv_persist_chains": 32,
    }
    # at defaults the env parses to the defaults the config has
    defaults = InferenceServiceController()._serving_env({})
    for key, value in defaults.items():
        monkeypatch.setenv(key, value)
    knobs = engine_knobs_from_env()
    cfg = ServingConfig()
    assert knobs["prefill_buckets"] is None  # empty: the auto ladder
    for key in ("num_slots", "max_queue", "page_size", "num_pages",
                "prefix_cache", "paged_attention", "quantize",
                "draft_model", "num_draft_tokens", "draft_checkpoint_dir",
                "drain_deadline_s", "kv_host_bytes", "kv_persist_dir",
                "kv_persist_interval_s", "kv_persist_chains"):
        assert knobs[key] == getattr(cfg, key), key


def test_inference_controller_renders_chaos_env():
    store, cm = _harness()
    store.create(new_inference_service(
        "svc", model="gpt_tiny", serving={"chaos": {
            "enabled": True, "seed": 3, "points": ["engine.step:p=0.5"]}}))
    cm.run_until_idle(max_seconds=5)
    env = _env(store, "svc")
    assert env["KFT_CHAOS_POINTS"] == "engine.step:p=0.5"
    assert env["KFT_CHAOS_SEED"] == "3"
    # chaos-off services carry no plan keys at all
    store.create(new_inference_service("plain", model="gpt_tiny"))
    cm.run_until_idle(max_seconds=5)
    assert "KFT_CHAOS_POINTS" not in _env(store, "plain")


def test_serving_config_validation():
    ServingConfig(draft_model="gpt_tiny", num_draft_tokens=4).validate()
    with pytest.raises(ConfigError, match="draft_model"):
        ServingConfig(num_draft_tokens=4)
    with pytest.raises(ConfigError, match="num_draft_tokens"):
        ServingConfig(num_draft_tokens=-1)
    # speculation needs the engine: num_slots=0 would silently serve the
    # static path with the drafted knobs ignored
    with pytest.raises(ConfigError, match="num_slots"):
        ServingConfig(draft_model="gpt_tiny", num_draft_tokens=4,
                      num_slots=0)


def test_controller_renders_draft_env():
    ctl = InferenceServiceController(serving_defaults=ServingConfig(
        draft_model="gpt_tiny", num_draft_tokens=4,
        draft_checkpoint_dir="/ckpt/draft"))
    env = ctl._serving_env({})
    assert env["KFT_SERVING_DRAFT_MODEL"] == "gpt_tiny"
    assert env["KFT_SERVING_DRAFT_TOKENS"] == "4"
    assert env["KFT_SERVING_DRAFT_CHECKPOINT_DIR"] == "/ckpt/draft"
    # a per-CR override wins field by field
    env = ctl._serving_env({"serving": {"num_draft_tokens": 0}})
    assert env["KFT_SERVING_DRAFT_TOKENS"] == "0"
    # an invalid combination is rejected at reconcile time
    with pytest.raises(ConfigError, match="draft_model"):
        InferenceServiceController()._serving_env(
            {"serving": {"num_draft_tokens": 2}})


def test_inference_controller_renders_trace_env():
    ctrl = InferenceServiceController()
    env = ctrl._serving_env({})
    assert env["KFT_TRACE_ENABLED"] == "1"
    assert env["KFT_TRACE_BUFFER_SPANS"] == "4096"
    assert env["KFT_TRACE_STATUSZ"] == "1"
    # a per-CR override of one knob keeps the others at defaults
    env = ctrl._serving_env(
        {"serving": {"observability": {"trace_buffer_spans": 99}}})
    assert env["KFT_TRACE_BUFFER_SPANS"] == "99"
    assert env["KFT_TRACE_ENABLED"] == "1"


def test_inference_controller_renders_sampling_env():
    ctrl = InferenceServiceController()
    env = ctrl._serving_env({})
    assert env["KFT_TRACE_SAMPLE_PROB"] == "1"
    assert env["KFT_TRACE_SAMPLE_KEEP"] == "128"
    env = ctrl._serving_env(
        {"serving": {"observability": {"trace_sample_prob": 0.25}}})
    assert env["KFT_TRACE_SAMPLE_PROB"] == "0.25"
    assert env["KFT_TRACE_SAMPLE_KEEP"] == "128"


# -- ServingConfig's refusals against the JAX package's -----------------------

_ROUTED = {"router": {"enabled": True}}
# (id, spec.serving, the fragment both packages' ConfigError carries)
REFUSALS = [
    ("drain_deadline", {"drain_deadline_s": -1},
     "serving.drain_deadline_s must be >= 0"),
    ("num_slots", {"num_slots": -1}, "serving.num_slots must be >= 0"),
    ("max_queue", {"max_queue": 0}, "serving.max_queue must be >= 1"),
    ("draft_tokens", {"num_draft_tokens": -1},
     "serving.num_draft_tokens must be >= 0"),
    ("draft_model", {"num_draft_tokens": 2},
     "num_draft_tokens > 0 needs serving.draft_model"),
    ("paged_attention", {"paged_attention": "bogus"},
     "serving.paged_attention must be one of"),
    ("quantize", {"quantize": "int4"}, "serving.quantize must be one of"),
    ("kernel_without_engine", {"num_slots": 0, "paged_attention": "pallas"},
     "needs serving.num_slots >= 1: the kernel serves"),
    ("mesh_without_engine", {"num_slots": 0, "mesh": {"tensor": 2}},
     "serving.mesh needs serving.num_slots >= 1"),
    ("draft_without_engine", {"num_slots": 0, "draft_model": "gpt_tiny",
                              "num_draft_tokens": 2},
     "serving.num_draft_tokens > 0 needs serving.num_slots >= 1"),
    ("bucket_power", {"prefill_buckets": [3]}, "powers of two"),
    ("bucket_order", {"prefill_buckets": [32, 8]},
     "serving.prefill_buckets must be ascending"),
    ("page_size", {"page_size": 12},
     "serving.page_size must be a positive power of two"),
    ("num_pages", {"num_pages": -1}, "serving.num_pages must be >= 0"),
    ("kv_host_bytes", {"kv_host_bytes": -1},
     "serving.kv_host_bytes must be >= 0"),
    ("persist_interval", {"kv_persist_interval_s": -1},
     "serving.kv_persist_interval_s must be >= 0"),
    ("persist_chains", {"kv_persist_chains": 0},
     "serving.kv_persist_chains must be >= 1"),
    ("tiers_without_prefix", {"kv_host_bytes": 1, "prefix_cache": False},
     "need serving.prefix_cache=true"),
    ("persist_without_prefix", {"kv_persist_dir": "/kv",
                                "prefix_cache": False},
     "need serving.prefix_cache=true"),
    ("disagg_without_prefix", {"disagg": {"enabled": True},
                               "prefix_cache": False, **_ROUTED},
     "serving.disagg.enabled needs serving.prefix_cache"),
    ("disagg_without_engine", {"disagg": {"enabled": True}, "num_slots": 0,
                               **_ROUTED},
     "serving.disagg.enabled needs serving.num_slots >= 1"),
    ("prefill_replicas", {"disagg": {"prefill_replicas": -1}},
     "serving.disagg.prefill_replicas must be >= 0"),
    ("handoff_chains", {"disagg": {"handoff_chains": 0}},
     "serving.disagg.handoff_chains must be >= 1"),
    ("disagg_without_router", {"disagg": {"enabled": True}},
     "serving.disagg.enabled needs serving.router.enabled"),
    ("min_prefill_replicas", {"disagg": {"min_prefill_replicas": -1}},
     "serving.disagg.min_prefill_replicas must be >= 0"),
    ("max_prefill_replicas", {"disagg": {"min_prefill_replicas": 3,
                                         "max_prefill_replicas": 2}},
     "serving.disagg.max_prefill_replicas must be >="),
    ("cold_hit_rate", {"disagg": {"cold_hit_rate": 1.5}},
     "serving.disagg.cold_hit_rate must be in [0, 1]"),
    ("scale_up_ttft", {"disagg": {"scale_up_ttft_p99_s": 0}},
     "serving.disagg.scale_up_ttft_p99_s must be > 0"),
    ("scale_up_cold", {"disagg": {"scale_up_cold_per_s": 0}},
     "serving.disagg.scale_up_cold_per_s must be > 0"),
    ("router_spill", {"router": {"spill_queue_per_slot": -1}},
     "serving.router.spill_queue_per_slot must be >= 0"),
    ("router_retry_budget", {"router": {"retry_budget": -1}},
     "serving.router.retry_budget must be >= 0"),
    ("mesh_axis", {"mesh": {"tensor": 0}},
     "serving.mesh.tensor must be a positive int"),
    ("chaos_seed", {"chaos": {"seed": -1}}, "chaos.seed must be >= 0"),
    ("chaos_point", {"chaos": {"enabled": True, "points": ["nope.point"]}},
     "chaos.points"),
    ("chaos_attempt", {"chaos": {"enabled": True,
                                 "points": ["engine.step:attempt=0"]}},
     "attempt="),
    ("trace_spans", {"observability": {"trace_buffer_spans": 0}},
     "observability.trace_buffer_spans must be >= 1"),
    ("sample_prob", {"observability": {"trace_sample_prob": 2.0}},
     "observability.trace_sample_prob must be in [0, 1]"),
    ("sample_keep", {"observability": {"trace_sample_keep": 0}},
     "observability.trace_sample_keep must be >= 1"),
]


@pytest.mark.parametrize("serving,fragment", [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_every_jax_serving_refusal_raises_in_the_port(serving, fragment):
    with pytest.raises(JConfigError, match=fragment.replace("[", r"\[")):
        jfrom_dict(JServingConfig, serving).validate()
    match = fragment.replace("[", r"\[")
    with pytest.raises(ConfigError, match=match):
        ServingConfig.from_dict(_port_serving(serving))
    # and at reconcile time, through the merge with the defaults
    with pytest.raises(ConfigError, match=match):
        InferenceServiceController()._serving_env(
            {"serving": _port_serving(serving)})


def test_pallas_is_refused_naming_kernel():
    """The JAX package's read-path name is not mapped silently."""
    with pytest.raises(ConfigError, match="got 'pallas'.*is 'kernel'"):
        ServingConfig.from_dict({"paged_attention": "pallas"})
    store, _ = _harness()
    store.create(new_inference_service(
        "svc", NS, model="gpt_tiny", serving={"paged_attention": "pallas"}))
    with pytest.raises(ConfigError, match="'kernel'"):
        InferenceServiceController().reconcile(store, NS, "svc")
    assert ServingConfig.from_dict(
        {"paged_attention": "kernel"}).paged_attention == "kernel"


def test_disagg_without_the_router_is_the_listed_exception():
    """The name dates from when the port took a split fleet without its
    router. It checks that both packages refuse disagg without the
    router (the steering point), and that with the router the port
    renders the prefill tier, the decode tier's Service and a router
    whose registry carries the tiers' roles."""
    with pytest.raises(JConfigError, match="needs serving.router.enabled"):
        jfrom_dict(JServingConfig, {"disagg": {"enabled": True}}).validate()
    with pytest.raises(ConfigError, match="needs serving.router.enabled"):
        ServingConfig.from_dict({"disagg": {"enabled": True}})
    cfg = ServingConfig.from_dict({"disagg": {"enabled": True}, **_ROUTED})
    assert cfg.disagg.enabled and cfg.disagg.prefill_replicas == 1
    store, cm = _harness()
    store.create(new_inference_service(
        "split", NS, model="gpt_small",
        serving={"disagg": {"enabled": True}, **_ROUTED}))
    cm.run_until_idle(max_seconds=5)
    assert store.get("Deployment", "split-prefill", NS)["spec"][
        "replicas"] == 1
    assert store.get("Service", "split", NS)["spec"]["selector"] == {
        "inferenceservice": "split", "inferenceservice-tier": "decode"}
    assert _env(store, "split-router", NS)["KFT_ROUTER_REPLICAS"] == (
        "split-0=http://split-0:8500#decode,"
        "split-prefill-0=http://split-prefill-0:8500#prefill")


@pytest.mark.parametrize("serving", [
    {"autoscale": {"enabled": True, "max_replicas": 3},
     "disagg": {"enabled": True}, **_ROUTED},
    {"router": {"enabled": True}},
    {"router": {"enabled": False}},
    {"disagg": {"cold_hit_rate": 0.5}},
    {"disagg": {"max_prefill_replicas": 2}},
], ids=["autoscale", "router", "router_off", "cold_hit_rate",
        "max_prefill_replicas"])
def test_the_autoscaler_and_router_stay_refused(serving):
    """The name dates from when the port refused these specs. It checks
    that each loads with the JAX package's values and reconciles, with a
    `<name>-router` exactly when the router is enabled."""
    want = jfrom_dict(JServingConfig, serving)
    want.validate()
    got = ServingConfig.from_dict(serving)
    for sub in ("router", "disagg", "autoscale"):
        for f, v in vars(getattr(got, sub)).items():
            assert getattr(getattr(want, sub), f) == v, (sub, f)
    store, cm = _harness()
    store.create(new_inference_service("svc", NS, model="gpt_tiny",
                                       serving=serving))
    cm.run_until_idle(max_seconds=5)
    assert store.try_get("Deployment", "svc", NS) is not None
    assert (store.try_get("Deployment", "svc-router", NS) is not None) == \
        got.router.enabled


@pytest.mark.parametrize("topology,mesh,fragment", [
    ("h100-1", {"tensor": 2}, "h100-1 has 1 card.*runs a replica on 2"),
    ("h100-8", {"tensor": 2, "fsdp": 2}, "h100-8 has 8 card.*on 4"),
    ("h100-16", {"tensor": 4, "fsdp": 2, "expert": 2},
     "needs 16 cards .* more than the 8 of one node"),
    ("", {"tensor": 4, "fsdp": 4}, "needs 16 cards"),
    ("v5e-4", {"tensor": 2, "fsdp": 2}, "unknown GPU topology"),
], ids=["h100-1_vs_2", "h100-8_vs_4", "16_cards", "16_cards_no_topology",
        "tpu_topology"])
def test_a_replicas_topology_must_match_its_mesh_on_one_node(
        topology, mesh, fragment):
    store, cm = _harness()
    store.create(new_inference_service("svc", NS, model="gpt_small",
                                       gpu_topology=topology,
                                       serving={"mesh": mesh}))
    with pytest.raises(ConfigError, match=fragment):
        InferenceServiceController().reconcile(store, NS, "svc")
    assert store.try_get("Deployment", "svc", NS) is None


def test_a_mesh_replica_is_one_pod_on_its_cards():
    store, cm = _harness()
    store.create(new_inference_service(
        "mesh", NS, model="gpt_small", gpu_topology="h100-8",
        serving={"mesh": {"tensor": 2, "fsdp": 2, "expert": 2}}))
    cm.run_until_idle(max_seconds=5)
    pods = store.list("Pod", NS)
    assert [p["metadata"]["name"] for p in pods] == ["mesh-0"]
    c = pods[0]["spec"]["containers"][0]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "8"}
    env = {e["name"]: e["value"] for e in c["env"]}
    assert (env["KFT_SERVING_MESH_TENSOR"], env["KFT_SERVING_MESH_FSDP"],
            env["KFT_SERVING_MESH_EXPERT"]) == ("2", "2", "2")
    # no gang env: the pod's entry starts its own worker ranks
    assert not any(k.startswith("KFT_NUM_PROCESSES") for k in env)
