"""Controllers of the port's control plane: the GPU train-job gang
reconciler (gpujob.py), the StudyJob hyperparameter search over it
(studyjob.py), the InferenceService serving deployments (inference.py),
the StatefulSet/Deployment workload controllers under it
(statefulset.py) and the Tensorboard deployments that front training
logs and profiler traces (tensorboard.py), the counterparts of
kubeflow_tpu/controllers/tpujob.py, studyjob.py, inference.py,
statefulset.py and tensorboard.py. They run against the in-memory
StateStore (cluster/)."""

from kubeflow_tpu_torch.controllers.helpers import (  # noqa: F401
    apply_owned,
    delete_owned,
    wait_for_condition,
)
from kubeflow_tpu_torch.controllers.inference import (  # noqa: F401
    InferenceServiceController,
    new_inference_service,
)
from kubeflow_tpu_torch.controllers.statefulset import (  # noqa: F401
    DeploymentController,
    StatefulSetController,
)
from kubeflow_tpu_torch.controllers.tensorboard import (  # noqa: F401
    TensorboardController,
    new_tensorboard,
)
