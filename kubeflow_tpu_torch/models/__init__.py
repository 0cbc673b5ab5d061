"""Models of the port: the GPT decoder family and its param bridge."""

from kubeflow_tpu_torch.models.registry import get_model

__all__ = ["get_model"]
