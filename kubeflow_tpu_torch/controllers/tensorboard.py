"""Tensorboard controller: training-log visualization per CR (port of
kubeflow_tpu/controllers/tensorboard.py).

Tensorboard CR → Deployment (a tensorboard container with --logdir from
the spec) + Service 9000→6006 + VirtualService /tensorboard/<ns>/<name>.
Cloud logdirs (gs://, s3://) run stateless; a local path gets a PVC
mounted at the logdir. The same CR fronts the `torch.profiler` captures
a GPUTrainJob's profiler endpoint writes under `profiler_logdir`
(runtime/profiler.py: `<logdir>/plugins/profile/<run>/`).
"""

from __future__ import annotations

from typing import Any, Dict

from kubeflow_tpu_torch.cluster.objects import (
    new_object,
    set_condition,
    set_owner,
)
from kubeflow_tpu_torch.cluster.reconciler import Controller, Result
from kubeflow_tpu_torch.cluster.store import StateStore
from kubeflow_tpu_torch.controllers.statefulset import new_deployment

KIND = "Tensorboard"
DEFAULT_IMAGE = "kubeflow-tpu/tensorboard:latest"
TB_PORT = 6006


def new_tensorboard(
    name: str, namespace: str = "default", logdir: str = "",
    image: str = DEFAULT_IMAGE,
) -> Dict[str, Any]:
    return new_object(KIND, name, namespace,
                      spec={"logspath": logdir, "image": image})


def is_cloud_path(path: str) -> bool:
    return path.startswith(("gs://", "s3://"))


class TensorboardController(Controller):
    kind = KIND
    name = "tensorboard-controller"

    def __init__(
        self, use_istio: bool = True,
        istio_gateway: str = "kubeflow/kubeflow-gateway",
    ) -> None:
        super().__init__()
        self.use_istio = use_istio
        self.istio_gateway = istio_gateway
        self.watches = {"Deployment": self.map_owned}

    def reconcile(self, store: StateStore, namespace: str, name: str) -> Result:
        tb = store.try_get(KIND, name, namespace)
        if tb is None or tb["metadata"].get("deletionTimestamp"):
            return Result()
        spec = tb.get("spec", {})
        logdir = spec.get("logspath", "")

        pod_spec: Dict[str, Any] = {
            "containers": [
                {
                    "name": "tensorboard",
                    "image": spec.get("image", DEFAULT_IMAGE),
                    "command": [
                        "tensorboard",
                        f"--logdir={logdir}",
                        "--bind_all",
                        f"--port={TB_PORT}",
                    ],
                    "ports": [{"containerPort": TB_PORT}],
                }
            ]
        }
        if logdir and not is_cloud_path(logdir):
            # a local logdir is a PVC mounted at that path
            pod_spec["volumes"] = [
                {
                    "name": "logs",
                    "persistentVolumeClaim": {"claimName": f"{name}-logs"},
                }
            ]
            pod_spec["containers"][0]["volumeMounts"] = [
                {"name": "logs", "mountPath": logdir}
            ]

        dep = new_deployment(
            name, namespace, 1, pod_spec,
            labels={"app": "tensorboard", "tb-name": name},
        )
        set_owner(dep, tb)
        store.apply(dep)

        svc = new_object(
            "Service",
            name,
            namespace,
            api_version="v1",
            spec={
                "selector": {"tb-name": name},
                "ports": [{"port": 9000, "targetPort": TB_PORT}],
            },
        )
        set_owner(svc, tb)
        store.apply(svc)

        if self.use_istio:
            vs = new_object(
                "VirtualService",
                f"tensorboard-{namespace}-{name}",
                namespace,
                api_version="networking.istio.io/v1alpha3",
                spec={
                    "hosts": ["*"],
                    "gateways": [self.istio_gateway],
                    "http": [
                        {
                            "match": [
                                {"uri": {
                                    "prefix": f"/tensorboard/{namespace}/{name}/"
                                }}
                            ],
                            "rewrite": {"uri": "/"},
                            "route": [
                                {
                                    "destination": {
                                        "host": f"{name}.{namespace}.svc.cluster.local",
                                        "port": {"number": 9000},
                                    }
                                }
                            ],
                        }
                    ],
                },
            )
            set_owner(vs, tb)
            store.apply(vs)

        ready = (
            store.try_get("Deployment", name, namespace) or {}
        ).get("status", {}).get("readyReplicas", 0)
        changed = set_condition(
            tb,
            "Ready",
            "True" if ready >= 1 else "False",
            "DeploymentReady" if ready >= 1 else "DeploymentNotReady",
        )
        if changed:
            store.patch_status(KIND, name, namespace, tb["status"])
        return Result()
