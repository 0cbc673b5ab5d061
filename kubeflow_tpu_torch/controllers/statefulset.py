"""Workload controllers: StatefulSet/Deployment → stably-named pods (copy
of kubeflow_tpu/controllers/statefulset.py).

The reference relies on k8s's built-in workload controllers underneath its
CR reconcilers (reference: components/notebook-controller/controllers/
notebook_controller.go:278 generateStatefulSet; tensorboard-controller/
controllers/tensorboard_controller.go:130 generateDeployment). The
platform's state store has no built-ins, so these supply the subset the
platform uses: `replicas` pods named <name>-0..N-1 from spec.template,
scale up/down on spec change, status.readyReplicas mirrored from pod phases.
Deployment shares the implementation (stable names are harmless) but stays a
distinct kind to match the reference's vocabulary
(reconcilehelper/util.go:18 Deployment vs :107 StatefulSet).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from kubeflow_tpu_torch.cluster.objects import new_object, set_owner
from kubeflow_tpu_torch.cluster.reconciler import Controller, Result
from kubeflow_tpu_torch.cluster.store import AlreadyExists, StateStore
from kubeflow_tpu_torch.controllers.helpers import list_owned


class StatefulSetController(Controller):
    kind = "StatefulSet"
    name = "statefulset-controller"

    def __init__(self) -> None:
        super().__init__()
        self.watches = {"Pod": self.map_owned}

    def reconcile(self, store: StateStore, namespace: str, name: str) -> Result:
        obj = store.try_get(self.kind, name, namespace)
        if obj is None:
            return Result()
        spec = obj.get("spec", {})
        replicas = int(spec.get("replicas", 1))
        template = spec.get("template", {})
        owned = {p["metadata"]["name"]: p for p in list_owned(store, obj, "Pod")}

        desired = {f"{name}-{i}" for i in range(replicas)}
        for pod_name in sorted(desired - set(owned)):
            pod = new_object(
                "Pod",
                pod_name,
                namespace,
                api_version="v1",
                spec=template.get("spec", {}),
                labels=template.get("metadata", {}).get("labels", {}),
                annotations=template.get("metadata", {}).get("annotations", {}),
            )
            pod["status"] = {"phase": "Pending"}
            set_owner(pod, obj)
            try:
                store.create(pod)
            except AlreadyExists:
                pass
        for pod_name in sorted(set(owned) - desired, reverse=True):
            try:
                store.delete("Pod", pod_name, namespace)
            except KeyError:
                pass

        ready = sum(
            1
            for p in owned.values()
            if p["metadata"]["name"] in desired
            and p.get("status", {}).get("phase") == "Running"
        )
        status = {"replicas": replicas, "readyReplicas": ready}
        if obj.get("status") != status:
            store.patch_status(self.kind, name, namespace, status)
        return Result()


class DeploymentController(StatefulSetController):
    kind = "Deployment"
    name = "deployment-controller"


def _new_workload(
    kind: str,
    name: str,
    namespace: str,
    replicas: int,
    pod_spec: Dict[str, Any],
    labels: Dict[str, str],
    annotations: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    return new_object(
        kind,
        name,
        namespace,
        api_version="apps/v1",
        labels=dict(labels),
        spec={
            "replicas": replicas,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {
                    "labels": dict(labels),
                    "annotations": dict(annotations or {}),
                },
                "spec": pod_spec,
            },
        },
    )


def new_statefulset(
    name: str,
    namespace: str,
    replicas: int,
    pod_spec: Dict[str, Any],
    labels: Dict[str, str],
    annotations: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    return _new_workload(
        "StatefulSet", name, namespace, replicas, pod_spec, labels, annotations
    )


def new_deployment(
    name: str,
    namespace: str,
    replicas: int,
    pod_spec: Dict[str, Any],
    labels: Dict[str, str],
    annotations: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    return _new_workload(
        "Deployment", name, namespace, replicas, pod_spec, labels, annotations
    )
