"""kft-router: the prefix-affinity serving front door (port of
kubeflow_tpu/routing/). `python -m kubeflow_tpu_torch.routing` is the
in-pod entrypoint the InferenceService controller deploys beside the
replica fleet when `serving.router.enabled` is set.

Only the pure affinity helpers load eagerly: the decode engine imports
`first_page_key` through this package and must not pull in the router's
wsgi, trace and metrics modules. The router's names resolve on first
use (PEP 562)."""

from kubeflow_tpu_torch.routing.affinity import first_page_key, rendezvous_rank

_ROUTER_EXPORTS = (
    "DEFAULT_PROBE_INTERVAL_S",
    "DEFAULT_RETRY_BUDGET",
    "DEFAULT_SPILL_QUEUE_PER_SLOT",
    "FleetRouter",
    "Replica",
    "default_transport",
    "discover_replicas",
    "fleet_signals_source",
)

__all__ = ["first_page_key", "rendezvous_rank", *_ROUTER_EXPORTS]


def __getattr__(name):
    if name in _ROUTER_EXPORTS:
        from kubeflow_tpu_torch.routing import router

        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
