"""Model registry (port of kubeflow_tpu/models/registry.py): maps the
platform's model names to factories that build an `nn.Module` on a
device. The names and shapes are the JAX package's."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(factory: Callable):
        if name in _REGISTRY:
            raise ValueError(f"model {name!r} already registered")
        _REGISTRY[name] = factory
        return factory

    return deco


def _import_builtin_models() -> None:
    import kubeflow_tpu_torch.models.gpt  # noqa: F401


def get_model(name: str, **kwargs):
    """Build registry model `name`. kwargs override config fields (e.g.
    `dtype`, `max_len`, `attention_impl`, `remat`, as the trainer passes
    them) and take `device` (default "cuda"; raises without CUDA unless
    "cpu") and `seed` (the seeded init's torch.Generator seed)."""
    _import_builtin_models()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
