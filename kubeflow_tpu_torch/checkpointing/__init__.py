"""Checkpointing (port of kubeflow_tpu/checkpointing/): the on-disk
layout, the async CheckpointManager and its module-level restores, and
the int8 weight transform applied at restore."""

from kubeflow_tpu_torch.checkpointing.manager import (  # noqa: F401
    CheckpointManager,
    latest_committed_step,
    restore_latest,
    restore_params,
    restore_pytree,
    restore_subtree,
)
