"""Models of the port: the GPT decoder family, ResNet, the mlp and the
param bridge."""

from kubeflow_tpu_torch.models.registry import get_model

__all__ = ["get_model"]
