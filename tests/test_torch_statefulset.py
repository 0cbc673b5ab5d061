"""The port's workload controllers (kubeflow_tpu_torch/controllers/
statefulset.py) against the JAX package's, on the same store operations:
each script runs on a JAX store with the JAX controllers and on a port
store with the port's, and after every step the two stores hold the same
StatefulSets, Deployments and pods (names, labels, annotations, specs,
statuses and owner references; uids, resource versions and timestamps
aside, and every owner reference must name its owner's uid in its own
store). The notebook and tensorboard cases are the store operations that
tests/test_notebook.py and tests/test_tensorboard.py make through these
controllers, as plain scripts. No JAX is needed: both control planes
are plain Python."""

import types

import pytest

from kubeflow_tpu.cluster import objects as jobjects
from kubeflow_tpu.cluster.reconciler import ControllerManager as JManager
from kubeflow_tpu.cluster.store import StateStore as JStore
from kubeflow_tpu.controllers import statefulset as jsts
from kubeflow_tpu_torch.cluster import objects
from kubeflow_tpu_torch.cluster.reconciler import ControllerManager
from kubeflow_tpu_torch.cluster.store import StateStore
from kubeflow_tpu_torch.controllers import statefulset as sts

JAX = types.SimpleNamespace(store=JStore, manager=JManager, objects=jobjects,
                            sts=jsts)
PORT = types.SimpleNamespace(store=StateStore, manager=ControllerManager,
                             objects=objects, sts=sts)
KINDS = ("StatefulSet", "Deployment", "Pod")
NS = "team-a"


def _harness(pkg):
    store = pkg.store()
    cm = pkg.manager(store)
    cm.register(pkg.sts.StatefulSetController())
    cm.register(pkg.sts.DeploymentController())
    return store, cm


def _snapshot(store):
    """{(kind, name): the object without its store-made identity}; every
    owner reference is checked against its owner's uid here."""
    uids = {o["metadata"]["uid"]: (o["kind"], o["metadata"]["name"])
            for kind in ("StatefulSet", "Deployment", "Owner")
            for o in store.list(kind, NS)}
    out = {}
    for kind in KINDS:
        for obj in store.list(kind, NS):
            m = obj["metadata"]
            refs = []
            for ref in m.get("ownerReferences", []):
                assert uids.get(ref["uid"]) == (ref["kind"], ref["name"]), ref
                refs.append({k: v for k, v in ref.items() if k != "uid"})
            out[(kind, m["name"])] = {
                "apiVersion": obj.get("apiVersion"),
                "labels": m.get("labels"),
                "annotations": m.get("annotations"),
                "ownerReferences": refs,
                "spec": obj.get("spec"),
                "status": obj.get("status"),
            }
    return out


POD_SPEC = {"containers": [{"name": "main", "image": "img:1",
                            "ports": [{"containerPort": 8888}]}]}


def _create(pkg, store, kind, name, replicas, labels, annotations=None,
            owner=None):
    make = pkg.sts.new_statefulset if kind == "StatefulSet" \
        else pkg.sts.new_deployment
    obj = make(name, NS, replicas, dict(POD_SPEC), labels, annotations)
    if owner is not None:
        pkg.objects.set_owner(obj, store.get("Owner", owner, NS))
    store.create(obj)


def _scale(pkg, store, kind, name, replicas):
    obj = store.get(kind, name, NS)
    obj["spec"]["replicas"] = replicas
    store.update(obj)


def _phase(pkg, store, pod, phase):
    store.patch_status("Pod", pod, NS, {"phase": phase})


def _delete(pkg, store, kind, name):
    store.delete(kind, name, NS)


def _owner(pkg, store, name):
    store.create(pkg.objects.new_object("Owner", name, NS,
                                        spec={"replicas": 1}))


# each step: (function, arguments after (pkg, store)); the controllers
# settle after each
SCRIPTS = {
    "statefulset_scale_up_then_down": [
        (_create, ("StatefulSet", "web", 2, {"app": "web"})),
        (_scale, ("StatefulSet", "web", 4)),
        (_phase, ("web-3", "Running")),
        (_scale, ("StatefulSet", "web", 1)),
        (_scale, ("StatefulSet", "web", 0)),
    ],
    "deployment_scale_up_then_down": [
        (_create, ("Deployment", "api", 1, {"app": "api"}, {"a": "b"})),
        (_scale, ("Deployment", "api", 3)),
        (_scale, ("Deployment", "api", 2)),
    ],
    "ready_replicas_follow_pod_phases": [
        (_create, ("Deployment", "api", 3, {"app": "api"})),
        (_phase, ("api-1", "Running")),
        (_phase, ("api-2", "Failed")),
        (_phase, ("api-0", "Running")),
        (_phase, ("api-1", "Pending")),
        (_scale, ("Deployment", "api", 1)),
    ],
    "owner_references_and_a_lost_pod": [
        (_owner, ("nb",)),
        (_create, ("StatefulSet", "nb", 2, {"notebook-name": "nb"}, None,
                   "nb")),
        (_delete, ("Pod", "nb-1")),
        (_delete, ("StatefulSet", "nb")),
    ],
    # tests/test_notebook.py test_statefulset_pod_created_and_status_
    # mirrored: the notebook's StatefulSet makes wb-0 with its labels, and
    # a running pod is mirrored as readyReplicas
    "notebook_pod_created_and_status_mirrored": [
        (_owner, ("wb",)),
        (_create, ("StatefulSet", "wb", 1, {"notebook-name": "wb",
                                            "app": "wb"}, None, "wb")),
        (_phase, ("wb-0", "Running")),
    ],
    # tests/test_notebook.py test_stop_annotation_scales_to_zero: the
    # culler's stop scales the StatefulSet to 0 and wb-0 goes
    "notebook_stop_scales_to_zero": [
        (_owner, ("wb",)),
        (_create, ("StatefulSet", "wb", 1, {"notebook-name": "wb"}, None,
                   "wb")),
        (_phase, ("wb-0", "Running")),
        (_scale, ("StatefulSet", "wb", 0)),
    ],
    # tests/test_tensorboard.py test_ready_condition_tracks_deployment:
    # tb-0 pending, then running, read back as readyReplicas
    "tensorboard_ready_tracks_deployment": [
        (_owner, ("tb",)),
        (_create, ("Deployment", "tb", 1, {"app": "tensorboard",
                                           "tensorboard": "tb"}, None, "tb")),
        (_phase, ("tb-0", "Running")),
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_the_ports_workload_controllers_act_as_the_jax_packages(script):
    jstore, jcm = _harness(JAX)
    store, cm = _harness(PORT)
    seen = 0
    for i, (fn, args) in enumerate(SCRIPTS[script]):
        fn(JAX, jstore, *args)
        fn(PORT, store, *args)
        jcm.run_until_idle(max_seconds=5)
        cm.run_until_idle(max_seconds=5)
        want, got = _snapshot(jstore), _snapshot(store)
        assert got == want, f"step {i}: {fn.__name__}{args}"
        seen += len(want)
    assert seen, "the script left nothing to compare"


def test_the_workload_constructors_render_the_jax_packages_objects():
    labels, ann = {"app": "x"}, {"k": "v"}
    for make in ("new_statefulset", "new_deployment"):
        want = getattr(jsts, make)("x", NS, 3, POD_SPEC, labels, ann)
        got = getattr(sts, make)("x", NS, 3, POD_SPEC, labels, ann)
        assert got == want
        assert got["spec"]["selector"] == {"matchLabels": labels}


def test_ready_replicas_count_only_running_pods_of_the_desired_set():
    store, cm = _harness(PORT)
    _create(PORT, store, "StatefulSet", "web", 3, {"app": "web"})
    cm.run_until_idle(max_seconds=5)
    assert [p["metadata"]["name"] for p in store.list("Pod", NS)] == [
        "web-0", "web-1", "web-2"]
    for pod in ("web-0", "web-2"):
        _phase(PORT, store, pod, "Running")
    cm.run_until_idle(max_seconds=5)
    assert store.get("StatefulSet", "web", NS)["status"] == {
        "replicas": 3, "readyReplicas": 2}
    _scale(PORT, store, "StatefulSet", "web", 2)
    cm.run_until_idle(max_seconds=5)
    assert store.get("StatefulSet", "web", NS)["status"] == {
        "replicas": 2, "readyReplicas": 1}
    pod = store.get("Pod", "web-0", NS)
    assert pod["status"] == {"phase": "Running"}
    assert objects.is_owned_by(pod, store.get("StatefulSet", "web", NS))
