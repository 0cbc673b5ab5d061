"""The in-memory control plane (copy of kubeflow_tpu/cluster/): k8s-shaped
objects, the state store and the controller runtime the port's
controllers run against."""

from kubeflow_tpu_torch.cluster.objects import (
    Condition,
    get_condition,
    new_object,
    set_condition,
)
from kubeflow_tpu_torch.cluster.store import (
    Conflict,
    NotFound,
    StateStore,
    WatchEvent,
)
from kubeflow_tpu_torch.cluster.reconciler import (
    Controller,
    ControllerManager,
    Result,
)

__all__ = [
    "Condition",
    "get_condition",
    "new_object",
    "set_condition",
    "Conflict",
    "NotFound",
    "StateStore",
    "WatchEvent",
    "Controller",
    "ControllerManager",
    "Result",
]
