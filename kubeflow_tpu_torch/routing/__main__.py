"""Router entrypoint: `python -m kubeflow_tpu_torch.routing` (port of
kubeflow_tpu/routing/__main__.py).

The in-pod command the InferenceService controller renders for the
`<name>-router` Deployment when `serving.router.enabled` is set
(controllers/inference.py). The env contract, re-rendered by the
controller on every scale event so the registry tracks the fleet:

- KFT_ROUTER_REPLICAS — comma-separated `id=http://host:port` pairs
  (the replica registry; ids are the Deployment's stable pod names).
- KFT_ROUTER_AFFINITY — "0" disables prefix affinity (round-robin
  spray; the bench's control arm).
- KFT_ROUTER_PAGE_SIZE — the fleet's KV page size: the affinity hash
  covers the first page-aligned chunk of the prompt, so this MUST match
  the replicas' KFT_SERVING_PAGE_SIZE (the controller renders both from
  one ServingConfig).
- KFT_ROUTER_SPILL_QUEUE_PER_SLOT — queue-depth-per-slot threshold past
  which an affinity request spills to its second rendezvous choice.
- KFT_ROUTER_REPLICA_SLOTS — the replicas' decode-slot capacity
  (ServingConfig.num_slots): the denominator for the router's own
  in-flight spill signal when no fleet collector is wired.
- KFT_ROUTER_RETRY_BUDGET — extra replica attempts after a 429/failure
  before the router answers 503.
- KFT_ROUTER_DISAGG — "1" enables disaggregated prefill/decode steering
  (serving.disagg; registry entries carry roles as `id=url#role`).
- KFT_ROUTER_DISAGG_COLD_HIT_RATE — decode-home prefix-cache hit rate
  under which arrivals steer through the prefill tier.
- KFT_SERVING_DISAGG_HANDOFF_CHAINS — hottest-chain budget one
  scale-down drain window ships (the same knob the replicas' handoff
  endpoint defaults to, rendered from one ServingConfig).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.routing.router import (
    DEFAULT_PAGE_SIZE,
    DEFAULT_COLD_HIT_RATE,
    DEFAULT_HANDOFF_CHAINS,
    DEFAULT_RETRY_BUDGET,
    DEFAULT_SPILL_QUEUE_PER_SLOT,
    FleetRouter,
    Replica,
)

# the controller's default router port (controllers/inference.py
# ROUTER_PORT renders the same number into the router Service)
DEFAULT_ROUTER_PORT = 8600


def parse_replicas(raw: str) -> List[Replica]:
    """`id=url[#role][,id=url[#role]...]` (a bare url doubles as its
    own id; role is prefill|decode, anything else — including absent —
    is unified)."""
    out: List[Replica] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        role = "unified"
        if "#" in part:
            part, tier = part.rsplit("#", 1)
            if tier.strip() in ("prefill", "decode"):
                role = tier.strip()
        if "=" in part:
            rid, url = part.split("=", 1)
        else:
            rid, url = part, part
        out.append(Replica(rid.strip(), url.strip().rstrip("/"), role))
    return out


def knobs_from_env(environ: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The controller-rendered KFT_ROUTER_* contract, parsed exactly as
    rendered."""
    env = os.environ if environ is None else environ

    def _f(name: str, default: float) -> float:
        raw = env.get(name, "").strip()
        return float(raw) if raw else default

    def _i(name: str, default: int) -> int:
        raw = env.get(name, "").strip()
        return int(raw) if raw else default

    return {
        "affinity": env.get("KFT_ROUTER_AFFINITY", "").strip() != "0",
        "page_size": _i("KFT_ROUTER_PAGE_SIZE", DEFAULT_PAGE_SIZE),
        "spill_queue_per_slot": _f(
            "KFT_ROUTER_SPILL_QUEUE_PER_SLOT", DEFAULT_SPILL_QUEUE_PER_SLOT
        ),
        "retry_budget": _i("KFT_ROUTER_RETRY_BUDGET", DEFAULT_RETRY_BUDGET),
        "replica_slots": _i("KFT_ROUTER_REPLICA_SLOTS", 0),
        "replicas": parse_replicas(env.get("KFT_ROUTER_REPLICAS", "")),
        "disagg": env.get("KFT_ROUTER_DISAGG", "").strip() == "1",
        "cold_hit_rate": _f(
            "KFT_ROUTER_DISAGG_COLD_HIT_RATE", DEFAULT_COLD_HIT_RATE
        ),
        "handoff_chains": _i(
            "KFT_SERVING_DISAGG_HANDOFF_CHAINS", DEFAULT_HANDOFF_CHAINS
        ),
    }


def build_router(replicas: Optional[List[Replica]] = None) -> FleetRouter:
    """Assemble the router from the env contract (testable core of the
    entrypoint); an explicit replica list wins over the env."""
    knobs = knobs_from_env()
    return FleetRouter(
        tuple(replicas if replicas is not None else knobs["replicas"]),
        affinity=knobs["affinity"],
        page_size=knobs["page_size"],
        spill_queue_per_slot=knobs["spill_queue_per_slot"],
        retry_budget=knobs["retry_budget"],
        replica_slots=knobs["replica_slots"],
        disagg=knobs["disagg"],
        cold_hit_rate=knobs["cold_hit_rate"],
        handoff_chains=knobs["handoff_chains"],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="kubeflow-tpu fleet router (PyTorch port)")
    ap.add_argument("--port", type=int, default=DEFAULT_ROUTER_PORT)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument(
        "--replicas", default="",
        help="static replica registry, id=url comma-separated (default "
        "from KFT_ROUTER_REPLICAS)",
    )
    ap.add_argument(
        "--service", default="",
        help="the fronted InferenceService as <namespace>/<name> "
        "(informational: the controller re-renders KFT_ROUTER_REPLICAS "
        "on scale events; this names whose fleet the registry is)",
    )
    args = ap.parse_args(argv)

    from kubeflow_tpu_torch.api.wsgi import Server

    router = build_router(
        parse_replicas(args.replicas) if args.replicas.strip() else None
    )
    router.start()  # health-probe loop
    httpd = Server(router.app, host=args.host, port=args.port)
    httpd.start()
    n = len(router.replica_states())
    what = args.service or "static fleet"
    print(f"routing {what} ({n} replicas) on :{httpd.port}", flush=True)
    import signal
    import threading

    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    except ValueError:
        pass  # no signal support in this context (not the main thread)
    try:
        while not stop.wait(1.0):
            pass
        # SIGTERM: let in-flight proxied requests finish before the
        # socket dies (the router-side mirror of the replicas' drain)
        print("SIGTERM: draining in-flight requests", flush=True)
        drained = router.drain()
        print(
            f"router drain {'complete' if drained else 'TIMED OUT'}",
            flush=True,
        )
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
        httpd.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
