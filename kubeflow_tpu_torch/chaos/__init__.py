"""kft-chaos — deterministic fault injection (copy of kubeflow_tpu/chaos/;
the operator-facing table is docs/ROBUSTNESS.md)."""

from kubeflow_tpu_torch.chaos.core import (
    CATALOG,
    ENV_CHAOS_ATTEMPT,
    ENV_CHAOS_POINTS,
    ENV_CHAOS_SEED,
    ChaosController,
    ChaosError,
    ChaosSpecError,
    PointSpec,
    configure_from_env,
    default_chaos,
    parse_point,
    parse_points,
)

__all__ = [
    "CATALOG",
    "ENV_CHAOS_ATTEMPT",
    "ENV_CHAOS_POINTS",
    "ENV_CHAOS_SEED",
    "ChaosController",
    "ChaosError",
    "ChaosSpecError",
    "PointSpec",
    "configure_from_env",
    "default_chaos",
    "parse_point",
    "parse_points",
]
