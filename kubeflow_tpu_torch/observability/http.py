"""Observability HTTP surface (port of kubeflow_tpu/observability/http.py):
/debug/trace, /statusz, /tracez and /metrics on any App.

- GET /debug/trace   — the tracer ring buffer as Chrome trace-event JSON
  (Perfetto, chrome://tracing). `?trace_id=<id>` filters one request's
  spans: the id exactly OR any `<id>/<row>` child, so the id a client
  sent (and got echoed back) selects its whole request while `<id>/0`
  narrows to one row.
- GET /statusz       — a text snapshot: tracer state plus caller-provided
  sections (the model server's models and engines).
- GET /metrics       — the registry's Prometheus text, on the debug app
  only: the model server serves its own.
- GET /tracez        — the tail sampler's kept completed request traces
  plus the per-series worst-offender exemplars, as JSON; `?trace_id=`
  narrows as /debug/trace does.

`add_fleet_routes` mounts a fleet collector's aggregated surface
(observability/fleet.py): /fleetz and the merged /debug/fleet-trace and
/debug/fleet-tracez.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.api.wsgi import App, Response
from kubeflow_tpu_torch.observability.trace import Tracer, default_tracer
from kubeflow_tpu_torch.utils.metrics import (
    default_registry,
    instance_info_gauge,
)

# the host/replica identity the controllers render into every pod
ENV_FLEET_INSTANCE = "KFT_FLEET_INSTANCE"

# a statusz section: (title, lines-callable) — called per request so the
# snapshot is always current
StatuszSection = Tuple[str, Callable[[], List[str]]]


def instance_id(environ=None) -> str:
    """This process's fleet identity: KFT_FLEET_INSTANCE, else
    hostname-pid (distinct per process on one host)."""
    env = os.environ if environ is None else environ
    rendered = env.get(ENV_FLEET_INSTANCE, "").strip()
    if rendered:
        return rendered
    return f"{socket.gethostname()}-{os.getpid()}"


def _matches_trace(rid, trace_id: str) -> bool:
    """The exact id or one of its per-row `<id>/<row>` children."""
    return rid is not None and (
        rid == trace_id or str(rid).startswith(trace_id + "/")
    )


def add_debug_routes(
    app: App,
    tracer: Optional[Tracer] = None,
    statusz_sections: Optional[List[StatuszSection]] = None,
    role: str = "serving",
) -> App:
    """Mount /debug/trace, /statusz and /tracez on `app`, and set this
    process's kft_instance_info{instance, role}."""
    tr = tracer if tracer is not None else default_tracer()
    sections = list(statusz_sections or [])
    instance_info_gauge().set(1.0, instance=instance_id(), role=role)

    @app.get("/debug/trace")
    def debug_trace(req):
        doc = tr.chrome_trace()
        trace_id = req.query.get("trace_id")
        if trace_id:
            doc["traceEvents"] = [
                e for e in doc["traceEvents"]
                if e["ph"] == "M"
                or _matches_trace(e.get("args", {}).get("trace_id"), trace_id)
            ]
        return Response(json.dumps(doc), "application/json")

    @app.get("/statusz")
    def statusz(req):
        st = tr.stats()
        lines = [
            f"{app.name} statusz @ {time.strftime('%Y-%m-%d %H:%M:%S')}",
            "",
            (
                f"[kft-trace] enabled={st['enabled']} "
                f"buffered={st['buffered']}/{st['capacity']} "
                f"dropped={st['dropped']} "
                f"sample_prob={st['sample_prob']:g} "
                f"tracez={st['completed_traces']}/{st['sample_keep']}"
            ),
        ]
        for title, fn in sections:
            lines.append("")
            lines.append(f"[{title}]")
            try:
                lines.extend(fn())
            except Exception as e:  # noqa: BLE001 - statusz must render
                lines.append(f"  <section failed: {type(e).__name__}: {e}>")
        return Response("\n".join(lines) + "\n", "text/plain; charset=utf-8")

    @app.get("/tracez")
    def tracez(req):
        # ?exemplars_only=1: skip serializing every kept trace's spans
        exemplars_only = req.query.get("exemplars_only") not in (
            None, "", "0"
        )
        doc = tr.tracez(include_traces=not exemplars_only)
        trace_id = req.query.get("trace_id")
        if trace_id and "traces" in doc:
            doc["traces"] = [
                t for t in doc["traces"]
                if _matches_trace(t["trace_id"], trace_id)
            ]
        return Response(json.dumps(doc), "application/json")

    return app


def build_debug_app(
    name: str = "debug",
    tracer: Optional[Tracer] = None,
    statusz_sections: Optional[List[StatuszSection]] = None,
    role: str = "training",
    fleet=None,
) -> App:
    """A standalone debug app: the three debug routes and /metrics (the
    training runtime's debug server, runtime/launcher.py, mounts this).
    Pass a FleetCollector as `fleet` to also mount the aggregated
    /fleetz and /debug/fleet-trace surface (a controller's debug
    server)."""
    app = add_debug_routes(App(name), tracer, statusz_sections, role=role)

    @app.get("/metrics")
    def metrics_text(req):
        return Response(default_registry().render(),
                        "text/plain; charset=utf-8")

    if fleet is not None:
        add_fleet_routes(app, fleet)
    return app


def add_fleet_routes(app: App, collector) -> App:
    """Mount the fleet-aggregated surface (observability/fleet.py):

    - GET /fleetz: a text snapshot of the whole fleet: scrape targets,
      each service's condensed serving signals, SLO compliance and burn
      rates, and the gang straggler table.
    - GET /debug/fleet-trace: every target's trace ring stitched onto
      one timeline (a Perfetto process track a host, scrape-time
      clock-offset estimation, flow events binding one trace id's spans
      across tracks); load the body in Perfetto like /debug/trace.
    - GET /debug/fleet-tracez: every target's /tracez merged by trace
      id, plus the fleet-merged worst-offender exemplars per series.
    """

    @app.get("/fleetz")
    def fleetz(req):
        lines = [
            f"{app.name} fleetz @ "
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}",
            "",
        ]
        lines.extend(collector.fleetz_lines())
        return Response("\n".join(lines) + "\n", "text/plain; charset=utf-8")

    @app.get("/debug/fleet-trace")
    def fleet_trace(req):
        return Response(
            json.dumps(collector.merged_chrome_trace()),
            "application/json",
        )

    @app.get("/debug/fleet-tracez")
    def fleet_tracez(req):
        return Response(
            json.dumps(collector.merged_tracez()),
            "application/json",
        )

    return app


def format_phase_row(summary: Dict[str, float]) -> str:
    """One /statusz line for a finished request's phase breakdown."""
    return (
        f"  {summary.get('trace_id', '?'):<28} "
        f"queue={summary.get('queue_s', 0.0) * 1e3:8.1f}ms "
        f"prefill={summary.get('prefill_s', 0.0) * 1e3:8.1f}ms "
        f"decode={summary.get('decode_s', 0.0) * 1e3:9.1f}ms "
        f"ttft={summary.get('ttft_s', 0.0) * 1e3:8.1f}ms "
        f"tokens={int(summary.get('tokens', 0)):4d}"
    )
