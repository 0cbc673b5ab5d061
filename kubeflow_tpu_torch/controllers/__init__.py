"""Controllers of the port's control plane: the GPU train-job gang
reconciler (gpujob.py) and the StudyJob hyperparameter search over it
(studyjob.py), the counterparts of kubeflow_tpu/controllers/tpujob.py
and studyjob.py. They run against the in-memory StateStore (cluster/)."""

from kubeflow_tpu_torch.controllers.helpers import (  # noqa: F401
    apply_owned,
    delete_owned,
    wait_for_condition,
)
