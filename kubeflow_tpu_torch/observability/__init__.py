"""Observability: request/step tracing (kft-trace), its HTTP surface, the
training path's MFU and goodput accounting, and the fleet collector with
its SLO engine (observability/fleet.py, slo.py)."""

from kubeflow_tpu_torch.observability.http import (
    add_debug_routes,
    add_fleet_routes,
    build_debug_app,
    format_phase_row,
)
from kubeflow_tpu_torch.observability.trace import (
    DEFAULT_BUFFER_SPANS,
    TRACEPARENT_HEADER,
    Span,
    SpanRecord,
    Tracer,
    configure_from_env,
    default_tracer,
    format_traceparent,
    knobs_from_env,
    mint_span_id,
    mint_trace_id,
    parse_traceparent,
)

__all__ = [
    "DEFAULT_BUFFER_SPANS",
    "TRACEPARENT_HEADER",
    "Span",
    "SpanRecord",
    "Tracer",
    "add_debug_routes",
    "add_fleet_routes",
    "build_debug_app",
    "configure_from_env",
    "default_tracer",
    "format_phase_row",
    "format_traceparent",
    "knobs_from_env",
    "mint_span_id",
    "mint_trace_id",
    "parse_traceparent",
]
