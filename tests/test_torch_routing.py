"""The port's kft-router (kubeflow_tpu_torch/routing/) against the JAX
package's (kubeflow_tpu/routing/) on the CPU. The classes follow
tests/test_routing.py:

- affinity keys: the port's first-page keys and rendezvous ranks are the
  JAX package's, and reshuffle minimally as replicas join and leave;
- the router core: each case feeds the same requests through a JAX
  `FleetRouter` and a port one, each over the same dict-driven fake
  transport (and the same fake clock and signals). Both must call the
  same replicas in the same order, answer the same statuses, bodies and
  pass-through headers, leave the same replica states, and move the
  `router_*` series by the same amounts (`_Record`);
- discovery: the same pods give the same replica registry;
- the controller render: the router Deployment, Service and KFT_ROUTER_*
  env equal the JAX controller's but for the module path, through scale
  events and teardown;
- the entrypoint: the same env parses to the same knobs;
- /healthz and the engine's affinity stats;
- end to end: the port's router over real sockets in front of two port
  ModelServers on gpt_tiny f32 gives `generate()`'s tokens and routes as
  the JAX router does in front of two JAX servers;
- the probe loop's lifecycle.

Tolerance: tokens identical, counts and verdicts equal.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu import routing as jrouting  # noqa: E402
from kubeflow_tpu.cluster.objects import new_object as jnew_object  # noqa: E402
from kubeflow_tpu.cluster.reconciler import ControllerManager as JManager  # noqa: E402
from kubeflow_tpu.cluster.store import StateStore as JStore  # noqa: E402
from kubeflow_tpu.controllers.inference import (  # noqa: E402
    InferenceServiceController as JController,
)
from kubeflow_tpu.controllers.inference import (  # noqa: E402
    new_inference_service as jnew_inference_service,
)
from kubeflow_tpu.controllers.statefulset import (  # noqa: E402
    DeploymentController as JDeploymentController,
)
from kubeflow_tpu.routing import __main__ as jentry  # noqa: E402
from kubeflow_tpu.routing import router as jrouter_mod  # noqa: E402
from kubeflow_tpu.serving.generate import generate as jgenerate  # noqa: E402
from kubeflow_tpu_torch import routing  # noqa: E402
from kubeflow_tpu_torch.cluster.objects import new_object  # noqa: E402
from kubeflow_tpu_torch.cluster.reconciler import ControllerManager  # noqa: E402
from kubeflow_tpu_torch.cluster.store import StateStore  # noqa: E402
from kubeflow_tpu_torch.config.platform import ConfigError  # noqa: E402
from kubeflow_tpu_torch.controllers import (  # noqa: E402
    DeploymentController,
    InferenceServiceController,
    new_inference_service,
)
from kubeflow_tpu_torch.routing import __main__ as entry  # noqa: E402
from kubeflow_tpu_torch.routing import router as router_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")
MOD = {"jax": jrouting, "port": routing}
PAGE = list(range(100, 116))  # one 16-token page
STEERS = (("prefill", "cold"), ("decode", "page-complete"),
          ("unified", "tier-down"))


def _ok_body(sequences=((1, 2, 3),)):
    return json.dumps({"sequences": [list(s) for s in sequences]}).encode()


def ok_handler(method, path, body, headers):
    return 200, _ok_body(), {"x-ttft-ms": "1.00"}


def drain_handler(retry_after="3"):
    def handler(method, path, body, headers):
        return (429, json.dumps({"success": False, "log": "draining"}).encode(),
                {"retry-after": retry_after})

    return handler


def healthz(ok=True, draining=False, status=200):
    def handler(method, path, body, headers):
        assert path == "/healthz"
        return status, json.dumps({"ok": ok, "draining": draining,
                                   "models": ["m"]}).encode(), {}

    return handler


class FakeFleet:
    """Dict-driven transport (replica id → handler) that records every
    call; `pkg` picks the package whose `Replica` it hands out."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.handlers = {}
        self.calls = []
        self.lock = threading.Lock()

    def add(self, rid, handler=ok_handler, role="unified"):
        self.handlers[rid] = handler
        return MOD[self.pkg].Replica(rid, f"http://{rid}", role)

    def transport(self, method, url, body, headers):
        rid, _, path = url[len("http://"):].partition("/")
        with self.lock:
            self.calls.append((rid, "/" + path))
        return self.handlers[rid](method, "/" + path, body, headers)


def gen_body(prompt, n=2):
    return {"prompt_ids": [list(int(t) for t in prompt)], "max_new_tokens": n}


def counts(router):
    """The `router_*` series a request moves, read off the router."""
    out = {f"requests_{o}": router._requests.value(outcome=o)
           for o in ("ok", "upstream_4xx", "rejected")}
    out.update(affinity_hits=router._affinity_hits.value(),
               spills=router._spills.value(),
               retries=router._retries.value(),
               trace_minted=router._trace_minted.value(),
               request_count=router._request_seconds.count())
    for tier, reason in STEERS:
        out[f"steer_{tier}_{reason}"] = router._tier_steer.value(
            tier=tier, reason=reason)
    return out


class _Record:
    """What one scripted case leaves: the calls, every answer, the
    replica states and the `router_*` deltas."""

    def __init__(self, router, fleet):
        self.router, self.fleet = router, fleet
        self.before = counts(router)
        self.answers = []

    def handle(self, method, path, body=None, headers=None):
        status, doc, hdrs = self.router.app.handle_full(method, path, body,
                                                        headers)
        hdrs = sorted((k, v) for k, v in hdrs if k != "X-Trace-Id")
        self.answers.append((status, doc, hdrs))
        return status, doc, dict(hdrs)

    def result(self):
        after = counts(self.router)
        return {"calls": list(self.fleet.calls), "answers": self.answers,
                "states": self.router.replica_states(),
                "counts": {k: after[k] - self.before[k] for k in after}}


def both(case):
    """Run `case(pkg)` for each package; the two results must be equal.
    Returns the port's."""
    got = {pkg: case(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def affinity_top(key_prompt, ids, page_size=16):
    return routing.rendezvous_rank(routing.first_page_key(key_prompt,
                                                          page_size), ids)


class TestAffinityKeys:
    def test_first_page_key_is_page_aligned(self):
        for mod in MOD.values():
            a = mod.first_page_key(PAGE + [1, 2, 3], 16)
            assert a == mod.first_page_key(PAGE + [9, 9, 9, 9], 16)
            assert a != mod.first_page_key([0] + PAGE[1:] + [1, 2, 3], 16)
            assert mod.first_page_key([1, 2], 16) != mod.first_page_key(
                [1, 3], 16)
        rng = np.random.default_rng(0)
        for _ in range(20):
            row = rng.integers(0, 50000, 40).tolist()
            for ps in (1, 8, 16, 64):
                assert routing.first_page_key(row, ps) == \
                    jrouting.first_page_key(row, ps)

    def test_rendezvous_is_the_jax_ranking(self):
        ids = ["a", "b", "c", "d"]
        for i in range(50):
            key = routing.first_page_key([i, i + 1], 16)
            assert routing.rendezvous_rank(key, ids) == \
                jrouting.rendezvous_rank(key, ids)

    @pytest.mark.parametrize("change", ["remove", "add"])
    def test_rendezvous_minimal_reshuffle(self, change):
        ids = ["a", "b", "c"]
        new = ["a", "b"] if change == "remove" else ids + ["d"]
        keys = [routing.first_page_key([i, i + 1], 16) for i in range(100)]
        before = {k: routing.rendezvous_rank(k, ids)[0] for k in keys}
        after = {k: routing.rendezvous_rank(k, new)[0] for k in keys}
        moved = [k for k in keys if before[k] != after[k]]
        if change == "remove":
            # only the removed replica's keys move
            assert all(before[k] == "c" for k in moved)
            assert any(before[k] == "c" for k in keys)
        else:
            # a new replica takes only the keys it now wins
            assert all(after[k] == "d" for k in moved)
            assert 0 < len(moved) < len(keys)


class TestRouterCore:
    @staticmethod
    def _router(pkg, fleet, replicas, **kw):
        kw.setdefault("page_size", 16)
        return MOD[pkg].FleetRouter(tuple(replicas), transport=fleet.transport,
                                    **kw)

    def test_affinity_sticks_to_one_replica(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b", "c")]
            rec = _Record(self._router(pkg, fleet, reps), fleet)
            for i in range(8):
                rec.handle("POST", "/v1/models/m:generate",
                           gen_body(PAGE + [i]))
            return rec.result()

        got = both(case)
        assert {c[0] for c in got["calls"]} == {
            affinity_top(PAGE, ["a", "b", "c"])[0]}
        assert all(a[0] == 200 for a in got["answers"])
        assert got["counts"]["affinity_hits"] == 8
        assert got["counts"]["requests_ok"] == 8

    def test_spray_round_robin_spreads(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b")]
            rec = _Record(self._router(pkg, fleet, reps, affinity=False),
                          fleet)
            for i in range(4):
                rec.handle("POST", "/v1/models/m:generate",
                           gen_body(PAGE + [i]))
            return rec.result()

        got = both(case)
        assert [c[0] for c in got["calls"]] == ["a", "b", "a", "b"]
        assert got["counts"]["affinity_hits"] == 0

    def test_draining_replica_demoted_and_retry_after_honored(self):
        top = affinity_top(PAGE, ["a", "b"])[0]
        other = "b" if top == "a" else "a"

        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b")]
            fleet.handlers[top] = drain_handler(retry_after="30")
            now = [0.0]
            rec = _Record(self._router(pkg, fleet, reps,
                                       clock=lambda: now[0]), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            states = [rec.router.replica_states()]
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            fleet.handlers[top] = ok_handler
            now[0] = 31.0
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return dict(rec.result(), early=states)

        got = both(case)
        # 429 at the home, retried to the other; inside the window the
        # drainer is not offered (the survivor is then the first choice,
        # counted as an affinity hit); past it the home is again
        assert [c[0] for c in got["calls"]] == [top, other, other, top]
        assert got["early"][0][top]["draining"]
        assert [a[0] for a in got["answers"]] == [200, 200, 200]
        assert got["counts"]["retries"] == 1
        assert got["counts"]["affinity_hits"] == 2

    def test_traffic_200_does_not_cut_a_drain_window_short(self):
        def drain_generate_ok_get(method, path, body, headers):
            if method == "GET":
                return 200, json.dumps({"models": []}).encode(), {}
            return drain_handler("30")(method, path, body, headers)

        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add("a", drain_generate_ok_get)]
            now = [0.0]
            rec = _Record(self._router(pkg, fleet, reps,
                                       clock=lambda: now[0]), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            rec.handle("GET", "/v1/models")
            held = rec.router.replica_states()["a"]
            now[0] = 31.0
            return dict(rec.result(), held=held)

        got = both(case)
        assert [a[0] for a in got["answers"]] == [503, 200]
        assert got["held"]["demoted"] and got["held"]["draining"]
        assert not got["states"]["a"]["demoted"]

    def test_spill_to_second_choice_when_home_is_hot(self):
        order = affinity_top(PAGE, ["a", "b", "c"])

        def signals(rid):
            depth = 16.0 if rid == order[0] else 0.0
            return {"queue_depth": depth, "num_slots": 4.0}

        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b", "c")]
            rec = _Record(self._router(pkg, fleet, reps, signals=signals,
                                       spill_queue_per_slot=2.0), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return rec.result()

        got = both(case)
        assert [c[0] for c in got["calls"]] == [order[1]]
        assert got["counts"]["spills"] == 1
        assert got["counts"]["affinity_hits"] == 0

    def test_zero_threshold_never_spills_an_idle_home(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b")]
            rec = _Record(self._router(
                pkg, fleet, reps, spill_queue_per_slot=0.0,
                signals=lambda rid: {"queue_depth": 0.0, "num_slots": 4.0}),
                fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return rec.result()

        got = both(case)
        assert [c[0] for c in got["calls"]] == [
            affinity_top(PAGE, ["a", "b"])[0]]
        assert got["counts"]["spills"] == 0

    def test_inflight_fallback_spills_without_a_collector(self):
        order = affinity_top(PAGE, ["a", "b", "c"])

        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b", "c")]
            router = self._router(pkg, fleet, reps, spill_queue_per_slot=1.0,
                                  replica_slots=2)
            with router._lock:
                router._inflight[order[0]] = 3  # 3/2 > 1.0
            rec = _Record(router, fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return rec.result()

        got = both(case)
        assert [c[0] for c in got["calls"]] == [order[1]]

    @pytest.mark.parametrize("retry_budget", [0, 1, 2])
    def test_retry_budget_exhaustion_is_clean_503(self, retry_budget):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r, drain_handler("7")) for r in ("a", "b", "c")]
            rec = _Record(self._router(pkg, fleet, reps,
                                       retry_budget=retry_budget), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return rec.result()

        got = both(case)
        status, doc, hdrs = got["answers"][0]
        assert status == 503 and "no replica accepted" in doc["log"]
        assert len(got["calls"]) == 1 + retry_budget
        assert got["counts"]["requests_rejected"] == 1
        assert got["counts"]["retries"] == 1 + retry_budget
        # the drain's Retry-After survives to the client
        assert dict(hdrs).get("Retry-After") == "7"

    def test_connect_failure_demotes_then_probe_readmits(self):
        top = affinity_top(PAGE, ["a", "b"])[0]
        other = "b" if top == "a" else "a"

        def boom(method, path, body, headers):
            raise ConnectionError("refused")

        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b")]
            fleet.handlers[top] = boom
            rec = _Record(self._router(pkg, fleet, reps), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            demoted = rec.router.replica_states()[top]
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            fleet.handlers[top] = healthz()
            fleet.handlers[other] = healthz()
            rec.router.probe_once()
            return dict(rec.result(), demoted=demoted)

        got = both(case)
        assert [c[0] for c in got["calls"][:3]] == [top, other, other]
        assert not got["demoted"]["healthy"]
        assert got["states"][top]["healthy"]

    def test_probe_demotes_draining_healthz(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add("a", healthz(draining=True, status=503)),
                    fleet.add("b", healthz())]
            now = [0.0]
            rec = _Record(self._router(pkg, fleet, reps,
                                       clock=lambda: now[0]), fleet)
            rec.router.probe_once()
            return rec.result()

        got = both(case)
        assert got["states"]["a"]["draining"] and got["states"]["a"]["demoted"]
        assert not got["states"]["b"]["demoted"]

    def test_upstream_4xx_passes_through_without_retry(self):
        def bad(method, path, body, headers):
            return 400, json.dumps({"success": False,
                                    "log": "bad prompt"}).encode(), {}

        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add("a", bad), fleet.add("b", bad)]
            rec = _Record(self._router(pkg, fleet, reps), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return rec.result()

        got = both(case)
        assert got["answers"][0][:2] == (400, {"success": False,
                                               "log": "bad prompt"})
        assert len(got["calls"]) == 1
        assert got["counts"]["requests_upstream_4xx"] == 1

    def test_no_replicas_is_503(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            rec = _Record(self._router(pkg, fleet, []), fleet)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            return rec.result()

        assert both(case)["answers"][0][0] == 503

    def test_other_endpoints_proxied(self):
        def list_models(method, path, body, headers):
            assert (method, path) == ("GET", "/v1/models")
            return 200, json.dumps({"models": [{"name": "m"}]}).encode(), {}

        def case(pkg):
            fleet = FakeFleet(pkg)
            rec = _Record(self._router(pkg, fleet,
                                       [fleet.add("a", list_models)]), fleet)
            rec.handle("GET", "/v1/models")
            return rec.result()

        got = both(case)
        assert got["answers"][0][1]["models"][0]["name"] == "m"

    def test_router_healthz_reports_fleet(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b")]
            rec = _Record(self._router(pkg, fleet, reps), fleet)
            rec.handle("GET", "/healthz")
            return rec.result()

        status, doc, _ = both(case)["answers"][0]
        assert status == 200 and doc["draining"] is False
        assert doc["role"] == "router"
        assert doc["replicas"] == {"total": 2, "available": 2, "draining": 0}

    def test_drain_gates_new_admissions_and_flips_healthz(self):
        def case(pkg):
            fleet = FakeFleet(pkg)
            reps = [fleet.add(r) for r in ("a", "b")]
            rec = _Record(self._router(pkg, fleet, reps), fleet)
            drained = rec.router.drain(deadline_s=1.0)
            rec.handle("POST", "/v1/models/m:generate", gen_body(PAGE))
            rec.handle("GET", "/healthz")
            return dict(rec.result(), drained=drained)

        got = both(case)
        assert got["drained"] and got["calls"] == []
        (s1, _, h1), (s2, doc, _) = got["answers"]
        assert s1 == 429 and dict(h1).get("Retry-After") == "1"
        assert s2 == 503 and doc["draining"] is True
        assert got["counts"]["requests_rejected"] == 1

    def test_traceparent_passes_through_to_the_replica(self):
        """With tracing on, the router continues a client's traceparent:
        the replica receives the same trace id under the route span."""
        seen = []

        def record(method, path, body, headers):
            seen.append(headers.get("Traceparent"))
            return ok_handler(method, path, body, headers)

        parent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        for pkg in PKGS:
            mod = router_mod if pkg == "port" else jrouter_mod
            tracer = mod.default_tracer()
            was = tracer.enabled
            tracer.configure(enabled=True)
            try:
                fleet = FakeFleet(pkg)
                router = self._router(pkg, fleet, [fleet.add("a", record)])
                status, _, hdrs = router.app.handle_full(
                    "POST", "/v1/models/m:generate", gen_body(PAGE),
                    {"traceparent": parent})
            finally:
                tracer.configure(enabled=was)
            assert status == 200
            assert dict(hdrs)["X-Trace-Id"] == "ab" * 16
        assert len(seen) == 2
        assert all(s.startswith("00-" + "ab" * 16 + "-") for s in seen)

    def test_retry_after_parse_is_the_jax_parse(self):
        cases = ["", "3", "0", "-4", "inf", "nan", "garbage", "99999",
                 "Wed, 21 Oct 2015 07:28:00 GMT"]
        for raw in cases:
            hdrs = {"retry-after": raw} if raw else {}
            assert router_mod._parse_retry_after(hdrs) == \
                jrouter_mod._parse_retry_after(hdrs), raw

    def test_the_router_imports_neither_torch_nor_the_jax_package(self):
        """The router pod starts without torch, and the engine's import of
        `first_page_key` does not pull in the router's modules."""
        code = (
            "import sys\n"
            "from kubeflow_tpu_torch.routing.affinity import first_page_key\n"
            "heavy = [m for m in sys.modules if m in (\n"
            "    'kubeflow_tpu_torch.routing.router',\n"
            "    'kubeflow_tpu_torch.api.wsgi',\n"
            "    'kubeflow_tpu_torch.observability.trace')]\n"
            "assert not heavy, heavy\n"
            "import kubeflow_tpu_torch.routing.__main__\n"
            "from kubeflow_tpu_torch.routing import FleetRouter\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in (\n"
            "    'torch', 'jax', 'kubeflow_tpu', 'numpy')]\n"
            "assert not bad, bad\n"
        )
        subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                       cwd=REPO)


class TestDiscovery:
    @staticmethod
    def _pods(new):
        out = []
        for name, ns, labels, ip in (
                ("svc-0", "default", {"inferenceservice": "svc"}, "10.0.0.1"),
                ("svc-1", "default", {"inferenceservice": "svc"}, ""),
                ("svc-p-0", "default", {"inferenceservice": "svc",
                                        "inferenceservice-tier": "prefill"},
                 ""),
                ("other-0", "default", {"inferenceservice": "other"}, ""),
                ("svc-9", "elsewhere", {"inferenceservice": "svc"}, ""),
                ("plain-0", "default", {}, "")):
            pod = new("Pod", name, ns, api_version="v1", labels=labels,
                      spec={})
            if ip:
                pod["status"] = {"podIP": ip}
            out.append(pod)
        return out

    def test_discovers_labeled_pods_in_namespace(self):
        got = {}
        for pkg, store, new in (("jax", JStore(), jnew_object),
                                ("port", StateStore(), new_object)):
            for pod in self._pods(new):
                store.create(pod)
            got[pkg] = [dataclasses.astuple(r) for r in
                        MOD[pkg].discover_replicas(store, "default", "svc")]
        assert got["port"] == got["jax"] == [
            ("svc-0", "http://10.0.0.1:8500", "unified"),
            ("svc-1", "http://svc-1:8500", "unified"),
            ("svc-p-0", "http://svc-p-0:8500", "prefill"),
        ]

    def test_fleet_signals_source_reads_one_replica_row(self):
        class _Collector:
            def replica_serving_signals(self, ns, name, instance=None):
                assert (ns, name) == ("default", "svc")
                return {instance: {"queue_depth": 3.0, "num_slots": 8.0}}

        for mod in MOD.values():
            sig = mod.fleet_signals_source(_Collector(), "default", "svc")
            assert sig("svc-1") == {"queue_depth": 3.0, "num_slots": 8.0}


class TestControllerRender:
    @staticmethod
    def _reconcile(pkg, serving=None, replicas=2):
        if pkg == "jax":
            store, cm = JStore(), None
            cm = JManager(store)
            cm.register(JDeploymentController())
            cm.register(JController())
            store.create(jnew_inference_service(
                "lm", "team-a", model="gpt_small", replicas=replicas,
                serving=serving or {}))
        else:
            store = StateStore()
            cm = ControllerManager(store)
            cm.register(DeploymentController())
            cm.register(InferenceServiceController())
            store.create(new_inference_service(
                "lm", "team-a", model="gpt_small", replicas=replicas,
                serving=serving or {}))
        cm.run_until_idle(max_seconds=5)
        return store, cm

    @staticmethod
    def _router_objects(store):
        dep = store.try_get("Deployment", "lm-router", "team-a")
        svc = store.try_get("Service", "lm-router", "team-a")
        if dep is None:
            return None, svc
        tmpl = dep["spec"]["template"]
        c = tmpl["spec"]["containers"][0]
        return ({"labels": tmpl["metadata"]["labels"],
                 "command": c["command"], "ports": c["ports"],
                 "env": {e["name"]: e["value"] for e in c["env"]},
                 "probe": c["readinessProbe"],
                 "resources": c.get("resources"),
                 "replicas": dep["spec"]["replicas"]},
                svc and svc["spec"])

    def _both(self, serving=None, replicas=2, mutate=None):
        out = {}
        for pkg in PKGS:
            store, cm = self._reconcile(pkg, serving, replicas)
            if mutate is not None:
                cr = store.get("InferenceService", "lm", "team-a")
                mutate(cr)
                store.update(cr)
                cm.run_until_idle(max_seconds=5)
            dep, svc = self._router_objects(store)
            if dep is not None:
                dep["command"] = [
                    "kubeflow_tpu_torch.routing"
                    if a == "kubeflow_tpu.routing" else a
                    for a in dep["command"]]
            out[pkg] = (dep, svc)
        assert out["port"] == out["jax"]
        return out["port"]

    def test_router_disabled_by_default(self):
        assert self._both() == (None, None)

    def test_router_render_env_and_service(self):
        dep, svc = self._both(serving={
            "page_size": 8, "router": {"enabled": True,
                                       "spill_queue_per_slot": 1.5,
                                       "retry_budget": 4}}, replicas=3)
        assert dep["command"][:3] == ["python", "-m",
                                      "kubeflow_tpu_torch.routing"]
        assert dep["env"] == {
            "KFT_ROUTER_AFFINITY": "1",
            "KFT_ROUTER_PAGE_SIZE": "8",
            "KFT_ROUTER_SPILL_QUEUE_PER_SLOT": "1.5",
            "KFT_ROUTER_RETRY_BUDGET": "4",
            "KFT_ROUTER_REPLICA_SLOTS": "8",
            "KFT_ROUTER_REPLICAS": ("lm-0=http://lm-0:8500,"
                                    "lm-1=http://lm-1:8500,"
                                    "lm-2=http://lm-2:8500"),
            "KFT_FLEET_METRICS_PORT": "8600",
        }
        assert dep["probe"]["httpGet"] == {"path": "/healthz", "port": 8600}
        assert dep["resources"] is None  # the router pod requests no card
        assert "inferenceservice" not in dep["labels"]
        assert svc["selector"] == {"inferenceservice-router": "lm"}
        assert svc["ports"][0]["port"] == 8600

    def test_scale_event_rerenders_registry(self):
        def grow(cr):
            cr["spec"]["replicas"] = 2

        dep, _ = self._both(serving={"router": {"enabled": True}},
                            replicas=1, mutate=grow)
        assert dep["env"]["KFT_ROUTER_REPLICAS"] == (
            "lm-0=http://lm-0:8500,lm-1=http://lm-1:8500")

    def test_disable_tears_router_down(self):
        def off(cr):
            cr["spec"]["serving"]["router"]["enabled"] = False

        assert self._both(serving={"router": {"enabled": True}},
                          mutate=off) == (None, None)

    def test_serving_container_gets_readiness_probe(self):
        store, _ = self._reconcile("port")
        c = store.get("Deployment", "lm", "team-a")["spec"]["template"][
            "spec"]["containers"][0]
        assert c["readinessProbe"]["httpGet"] == {"path": "/healthz",
                                                  "port": 8500}

    def test_invalid_router_config_rejected(self):
        with pytest.raises(ConfigError, match="retry_budget"):
            InferenceServiceController()._serving_cfg(
                {"serving": {"router": {"retry_budget": -1}}})


class TestEntrypointKnobs:
    ENV = {
        "KFT_ROUTER_AFFINITY": "0",
        "KFT_ROUTER_PAGE_SIZE": "8",
        "KFT_ROUTER_SPILL_QUEUE_PER_SLOT": "1.5",
        "KFT_ROUTER_RETRY_BUDGET": "4",
        "KFT_ROUTER_REPLICA_SLOTS": "8",
        "KFT_ROUTER_REPLICAS": ("r0=http://h0:8500,r1=http://h1:8500#decode,"
                                "p0=http://p0:8500/#prefill,x=http://x:1#bogus"),
        "KFT_ROUTER_DISAGG": "1",
        "KFT_ROUTER_DISAGG_COLD_HIT_RATE": "0.35",
        "KFT_SERVING_DISAGG_HANDOFF_CHAINS": "12",
    }

    @staticmethod
    def _plain(knobs):
        return dict(knobs, replicas=[dataclasses.astuple(r)
                                     for r in knobs["replicas"]])

    @pytest.mark.parametrize("env", ["rendered", "empty"])
    def test_env_roundtrip_is_the_jax_entrypoints(self, env):
        environ = self.ENV if env == "rendered" else {}
        got = self._plain(entry.knobs_from_env(environ))
        assert got == self._plain(jentry.knobs_from_env(environ))
        if env == "empty":
            assert got == {"affinity": True, "page_size": 16,
                           "spill_queue_per_slot": 2.0, "retry_budget": 2,
                           "replica_slots": 0, "replicas": [],
                           "disagg": False, "cold_hit_rate": 0.2,
                           "handoff_chains": 64}
        else:
            assert got["replicas"] == [
                ("r0", "http://h0:8500", "unified"),
                ("r1", "http://h1:8500", "decode"),
                ("p0", "http://p0:8500", "prefill"),
                ("x", "http://x:1", "unified")]

    def test_parse_replicas_bare_url(self):
        assert [dataclasses.astuple(r) for r in entry.parse_replicas(
            "http://h:1/")] == [("http://h:1/", "http://h:1", "unified")]

    def test_build_router_from_the_rendered_env(self, monkeypatch):
        for k, v in self.ENV.items():
            monkeypatch.setenv(k, v)
        router = entry.build_router()
        assert (router.affinity, router.page_size, router.retry_budget,
                router.disagg, router.cold_hit_rate, router.handoff_chains,
                router.replica_slots) == (False, 8, 4, True, 0.35, 12, 8)
        assert sorted(router.replica_states()) == ["p0", "r0", "r1", "x"]
        assert entry.DEFAULT_ROUTER_PORT == jentry.DEFAULT_ROUTER_PORT == 8600


class TestHealthzSatellite:
    def test_plain_server_healthz_ok(self):
        from kubeflow_tpu_torch.serving.server import ModelServer

        status, body = ModelServer(statusz_enabled=False).app.handle(
            "GET", "/healthz")
        assert (status, body) == (200, {"ok": True, "draining": False,
                                        "models": []})

    def test_drained_server_reports_draining_not_dead(self, fleet_pair):
        from kubeflow_tpu_torch.serving.engine import DecodeEngine
        from kubeflow_tpu_torch.serving.server import ModelServer

        eng = DecodeEngine("g", fleet_pair["tmodel"], device="cpu",
                           num_slots=1, max_queue=4)
        ms = ModelServer(statusz_enabled=False)
        ms.add_engine(eng)
        status, body = ms.app.handle("GET", "/healthz")
        assert (status, body["draining"], body["models"]) == (200, False,
                                                               ["g"])
        assert ms.close(drain=True)
        status, body = ms.app.handle("GET", "/healthz")
        assert status == 503
        assert body["ok"] is True and body["draining"] is True


# -- a gpt_tiny fleet of each package --------------------------------------


@pytest.fixture(scope="module")
def fleet_pair(gpt_and_params):
    """gpt_tiny f32 from the shared seeded weights in both packages, and the
    JAX `generate()` of a row."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.models.convert import load_jax_params

    jmodel, params = gpt_and_params
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    run = jax.jit(functools.partial(jgenerate, jmodel), static_argnums=(2,))

    def ref(row, n):
        out = run(params, jnp.asarray(row, jnp.int32)[None], n)
        return np.asarray(out)[0, len(row):].tolist()

    return {"jmodel": jmodel, "params": params, "tmodel": tmodel, "ref": ref}


class TestEngineAffinityStats:
    def test_stats_expose_hit_rate_and_first_page_cardinality(
            self, fleet_pair):
        from kubeflow_tpu.serving.engine import DecodeEngine as JEngine
        from kubeflow_tpu_torch.serving.engine import DecodeEngine

        page = list(range(16))  # page_size defaults to 16 in both
        rows = [page + [21, 22, 23, 24], page + [31, 32, 33, 34], [40] * 20]
        got = {}
        for pkg in PKGS:
            eng = (JEngine("g", fleet_pair["jmodel"], fleet_pair["params"],
                           num_slots=1, max_queue=8, prefill_buckets=(8, 32))
                   if pkg == "jax" else
                   DecodeEngine("g", fleet_pair["tmodel"], device="cpu",
                                num_slots=1, max_queue=8,
                                prefill_buckets=(8, 32)))
            try:
                tokens = [eng.generate_row(r, 2)["tokens"] for r in rows]
                s = eng.stats()
            finally:
                eng.close()
            got[pkg] = (tokens, {k: s[k] for k in (
                "first_page_hashes", "prefix_hit_tokens",
                "prefill_compute_tokens", "prefix_cache_hit_rate")})
        assert got["port"] == got["jax"]
        s = got["port"][1]
        assert s["first_page_hashes"] == 2
        assert 0.0 < s["prefix_cache_hit_rate"] < 1.0
        assert s["prefix_cache_hit_rate"] == pytest.approx(
            s["prefix_hit_tokens"]
            / (s["prefix_hit_tokens"] + s["prefill_compute_tokens"]))


class TestTwoReplicaAffinityE2E:
    """Two replicas behind a router over real sockets, in each package:
    shared-prefix traffic lands on one replica, and greedy tokens through
    the port's router are `generate()`'s."""

    @staticmethod
    def _fleet(pkg, fleet_pair):
        if pkg == "jax":
            from kubeflow_tpu.api.wsgi import Server
            from kubeflow_tpu.serving.engine import DecodeEngine
            from kubeflow_tpu.serving.server import ModelServer

            def engine():
                return DecodeEngine("g", fleet_pair["jmodel"],
                                    fleet_pair["params"], num_slots=2,
                                    max_queue=16, prefill_buckets=(8, 32))
        else:
            from kubeflow_tpu_torch.api.wsgi import Server
            from kubeflow_tpu_torch.serving.engine import DecodeEngine
            from kubeflow_tpu_torch.serving.server import ModelServer

            def engine():
                return DecodeEngine("g", fleet_pair["tmodel"], device="cpu",
                                    num_slots=2, max_queue=16,
                                    prefill_buckets=(8, 32),
                                    paged_attention="kernel")
        engines, servers, reps = [], [], []
        for r in range(2):
            eng = engine()
            ms = ModelServer(statusz_enabled=False)
            ms.add_engine(eng)
            srv = Server(ms.app, port=0)
            srv.start()
            engines.append((eng, ms))
            servers.append(srv)
            reps.append(MOD[pkg].Replica(f"replica-{r}",
                                         f"http://127.0.0.1:{srv.port}"))
        router = MOD[pkg].FleetRouter(tuple(reps), page_size=16,
                                      statusz_enabled=False)
        rsrv = Server(router.app, port=0)
        rsrv.start()
        servers.append(rsrv)
        return engines, servers, router

    @staticmethod
    def _fetch(port, row, n):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/g:generate",
            data=json.dumps({"prompt_ids": [row],
                             "max_new_tokens": n}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())["sequences"][0][len(row):]

    def test_shared_prefix_lands_on_one_replica_bitwise(self, fleet_pair):
        page = list(range(200, 216))  # a shared first page (vocab 512)
        rows = [page + [220 + i, 230 + i] for i in range(6)]
        other = [300 + i for i in range(18)]
        got = {}
        for pkg in PKGS:
            engines, servers, router = self._fleet(pkg, fleet_pair)
            try:
                hits0 = router._affinity_hits.value()
                tokens = [self._fetch(servers[-1].port, r, 4) for r in rows]
                tokens.append(self._fetch(servers[-1].port, other, 4))
                admitted = [eng.stats()["admitted"] for eng, _ in engines]
                hot = engines[int(np.argmax(admitted))][0].stats()
                got[pkg] = {"tokens": tokens, "admitted": admitted,
                            "hits": router._affinity_hits.value() - hits0,
                            "hot": (hot["first_page_hashes"],
                                    hot["prefix_hit_tokens"] > 0)}
            finally:
                for srv in servers:
                    srv.stop()
                for _, ms in engines:
                    ms.close()
        assert got["port"] == got["jax"]
        want = [fleet_pair["ref"](r, 4) for r in rows + [other]]
        assert got["port"]["tokens"] == want
        # the shared-prefix requests all landed on one replica, where the
        # prefix's radix chain lives once
        home = int(routing.rendezvous_rank(
            routing.first_page_key(page, 16), ["replica-0", "replica-1"])[0][-1])
        elsewhere = int(routing.rendezvous_rank(
            routing.first_page_key(other, 16), ["replica-0", "replica-1"])[0][-1])
        want_admitted = [0, 0]
        want_admitted[home] += 6
        want_admitted[elsewhere] += 1
        assert got["port"]["admitted"] == want_admitted
        assert got["port"]["hits"] == 7
        assert got["port"]["hot"][1]


class TestProbeLoopLifecycle:
    def test_concurrent_starts_spawn_one_probe_thread(self):
        router = routing.FleetRouter((), transport=FakeFleet("port").transport,
                                     probe_interval_s=60.0)
        try:
            gate = threading.Barrier(8)

            def go():
                gate.wait(timeout=5)
                router.start()

            starters = [threading.Thread(target=go, daemon=True)
                        for _ in range(8)]
            for t in starters:
                t.start()
            for t in starters:
                t.join(timeout=5)
            probes = [t for t in threading.enumerate()
                      if t.name == "router-probe" and t.is_alive()]
            assert len(probes) == 1, probes
        finally:
            router.stop()
        assert not any(t.name == "router-probe" and t.is_alive()
                       for t in threading.enumerate())

    def test_restart_after_stop_probes_again(self):
        router = routing.FleetRouter((), transport=FakeFleet("port").transport,
                                     probe_interval_s=60.0)
        try:
            router.start()
            router.stop()
            router.start()
            t = router._thread
            assert t is not None and t.is_alive()
        finally:
            router.stop()


def test_chip_smoke_phase_28_rehearses_on_cpu():
    """chip_smoke.py's phase 28 on the CPU at gpt_tiny size: the pods run
    as children from their rendered commands (`--device cpu`), the
    routers from theirs; 28a's affinity, replay and drain gates, 28b's
    steering, split-path parity and warm handoff, 28c's collector and
    prefill-tier scale-up. CPU tensors take the plain versions: no
    launches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.phase_router(
        torch, model="gpt_tiny", device="cpu",
        serving=dict(smoke.ROUTE_SERVING, prefill_buckets=[8, 16, 32]),
        lens=(3, 5, 9, 17, 30, 90, 40), max_new=8,
        cold_lens=(40, 56, 70, 90), drain_new=64)
    assert not any(launches.values())
