"""kft-fleet in the port (observability/fleet.py, slo.py, the metrics
parser and the decode-tier autoscaler of controllers/inference.py), held
against the JAX package's on the CPU. The classes follow
tests/test_fleet.py:

- parse and merge: the same exposition texts parse and merge to the same
  samples, and the merged ladders give the same quantiles;
- SLO rules: the same rules parse to the same fields, refuse the same
  garbage, and burn at the same rate;
- the collector: both collectors scrape the same /metrics texts through
  the same fake fetch under the same fake clock, and agree sweep by
  sweep on the fleet series, SLO statuses and burn rates, the fleet_*
  gauges, stragglers, `serving_signals`, the decode half of
  `disagg_signals` (both tiers, the router's cold-prefix steer rate
  and the fleet TTFT p99), `replica_serving_signals`, the merged traces
  and the /fleetz lines; the chaos
  point `fleet.scrape_fetch` degrades one target in both;
- the autoscaler: both InferenceServiceControllers, fed the same
  FleetSignals sequence, give the same `spec.replicas` trajectory and
  events, and the whole loop (fake replicas → collector → SLO → the
  controller) closes the same way;
- the policy covers every metric name the port declares, each exactly
  once, and the collector scrapes a real port ModelServer over a socket.
"""

import ast
import dataclasses
import json
import os
import re
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu.chaos import default_chaos as jdefault_chaos  # noqa: E402
from kubeflow_tpu.chaos import parse_point as jparse_point  # noqa: E402
from kubeflow_tpu.observability import fleet as jfleet  # noqa: E402
from kubeflow_tpu.observability import slo as jslo  # noqa: E402
from kubeflow_tpu.utils import metrics as jmetrics  # noqa: E402
from kubeflow_tpu_torch.chaos import default_chaos, parse_point  # noqa: E402
from kubeflow_tpu_torch.observability import fleet  # noqa: E402
from kubeflow_tpu_torch.observability import slo  # noqa: E402
from kubeflow_tpu_torch.utils import metrics  # noqa: E402
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTFT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _replica_registry(queue=0.0, occupancy=0.0, num_slots=4, ttfts=(),
                      n_429=0, tokens=0, model="m"):
    """A replica's metric state, rendered through the port's renderer."""
    r = MetricsRegistry()
    r.gauge("serving_queue_depth", "", ["model"]).set(queue, model=model)
    r.gauge("serving_slot_occupancy", "", ["model"]).set(
        occupancy, model=model)
    r.gauge("serving_num_slots", "", ["model"]).set(num_slots, model=model)
    r.gauge("kft_instance_info", "", ["instance", "role"]).set(
        1, instance="replica", role="serving")
    if tokens:
        r.counter("serving_tokens_total", "", ["model"]).inc(
            tokens, model=model)
    if n_429:
        r.counter("http_requests_total", "", ["app", "method", "status"]).inc(
            n_429, app="model-server", method="POST", status="429")
    h = r.histogram("serving_time_to_first_token_seconds", "", ["model"],
                    buckets=TTFT_BUCKETS)
    for t in ttfts:
        h.observe(t, model=model)
    return r


def _host_registry(step_times, model="mlp"):
    r = MetricsRegistry()
    h = r.histogram("training_step_seconds", "", ["model"])
    for t in step_times:
        h.observe(t, model=model)
    r.gauge("training_goodput", "", ["model"]).set(0.95, model=model)
    return r


def _norm(series):
    """Parsed or merged families as plain data (histograms as tuples)."""
    out = {}
    for name, pm in series.items():
        samples = {}
        for key, v in pm.samples.items():
            if hasattr(v, "buckets"):
                v = ("histogram", tuple(sorted(v.buckets.items())), v.sum,
                     v.count)
            samples[key] = v
        out[name] = (pm.kind, samples)
    return out


def _statuses(col):
    return [(s.rule.name, s.value, s.compliant, s.burn_rate, s.evaluations)
            for s in col.slo_statuses()]


class _Fleet:
    """The same targets, texts and clock for a JAX and a port collector."""

    def __init__(self):
        self.registries = {}
        self.rows = []       # ScrapeTarget fields
        self.docs = {}       # (instance, path) -> body
        self.now = {"t": 100.0}

    def add(self, role, owner, instance, registry, namespace="default",
            tier="unified"):
        self.registries[instance] = registry
        self.rows.append((role, namespace, owner, instance,
                          f"fake://{instance}", tier))

    def fetch(self, url):
        instance, path = url.split("://", 1)[1].split("/", 1)
        if path == "metrics":
            return self.registries[instance].render()
        return self.docs[(instance, path)]

    def collectors(self, **kw):
        """(JAX collector, its registry, port collector, its registry)."""
        jreg, reg = jmetrics.MetricsRegistry(), MetricsRegistry()
        clock = lambda: self.now["t"]  # noqa: E731
        j = jfleet.FleetCollector(
            lambda: [jfleet.ScrapeTarget(*r) for r in self.rows],
            fetch=self.fetch, registry=jreg, clock=clock, **kw)
        p = fleet.FleetCollector(
            lambda: [fleet.ScrapeTarget(*r) for r in self.rows],
            fetch=self.fetch, registry=reg, clock=clock, **kw)
        return j, jreg, p, reg

    def sweep_both(self, j, jreg, p, reg):
        """One sweep of each; everything both expose must agree."""
        j.scrape_once()
        p.scrape_once()
        assert _norm(p.fleet_series()) == _norm(j.fleet_series())
        assert _statuses(p) == _statuses(j)
        assert p.stragglers() == j.stragglers() and p.sweeps() == j.sweeps()
        for role in ("serving", "training", "router"):
            assert reg.get("fleet_targets").value(role=role) == jreg.get(
                "fleet_targets").value(role=role)
        for name in ("fleet_slo_compliant", "fleet_slo_burn_rate",
                     "fleet_straggler"):
            g, jg = reg.get(name), jreg.get(name)
            assert g.values_snapshot() == jg.values_snapshot()
        owners = {(r[1], r[2]) for r in self.rows if r[0] == "serving"}
        for ns, owner in sorted(owners):
            sig, jsig = p.serving_signals(ns, owner), j.serving_signals(
                ns, owner)
            assert (sig and dataclasses.asdict(sig)) == (
                jsig and dataclasses.asdict(jsig))
            d, jd = p.disagg_signals(ns, owner), j.disagg_signals(ns, owner)
            assert (d is None) == (jd is None)
            if d is not None:
                for f in dataclasses.fields(d):
                    assert getattr(d, f.name) == getattr(jd, f.name), f.name
            assert p.replica_serving_signals(ns, owner) == \
                j.replica_serving_signals(ns, owner)
        assert p.fleetz_lines() == j.fleetz_lines()


# -- parse and merge ------------------------------------------------------------


class TestParseAndMerge:
    def test_render_parse_roundtrip_and_merge_policies(self):
        texts = [_replica_registry(queue=float(i), occupancy=0.3 * i,
                                   tokens=10 * (i + 1), n_429=i,
                                   ttfts=[0.2 * (i + 1)] * 5).render()
                 for i in range(3)]
        for text in texts:
            assert _norm(metrics.parse_rendered(text)) == _norm(
                jmetrics.parse_rendered(text))
        policy = dict(fleet.AGGREGATION_POLICY)
        for pol in ("sum", "max", "min", "mean"):
            policy["serving_slot_occupancy"] = pol
            got = metrics.merge_rendered(
                [metrics.parse_rendered(t) for t in texts], policy)
            want = jmetrics.merge_rendered(
                [jmetrics.parse_rendered(t) for t in texts], policy)
            assert _norm(got) == _norm(want)
        hs = got["serving_time_to_first_token_seconds"].samples[
            (("model", "m"),)]
        jhs = want["serving_time_to_first_token_seconds"].samples[
            (("model", "m"),)]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert hs.quantile(q) == jhs.quantile(q)
        assert metrics.HistogramState().quantile(0.5) is None
        with pytest.raises(ValueError):
            hs.quantile(1.5)


# -- SLO rules ------------------------------------------------------------------

RULES = ["serving_ttft_p99 < 5s", "training_goodput > 0.85",
         "queue: serving_queue_depth / num_slots < 0.8",
         "lat: serving_ttft_p50 <= 250ms", "x.y-z: training_goodput >= 1e-3"]


class TestSloRules:
    def test_rules_parse_to_the_jax_fields(self):
        for text in RULES:
            assert dataclasses.asdict(slo.parse_rule(text)) == (
                dataclasses.asdict(jslo.parse_rule(text)))

    @pytest.mark.parametrize("rules", [
        ["nonsense ~~ 4"], ["serving_ttft_p99 < 5s", "serving_ttft_p99 < 6s"],
        ["serving_ttft < 5s"], ["serving_queue_depth_p99 < 5"]])
    def test_garbage_is_refused_with_the_jax_message(self, rules):
        with pytest.raises(jslo.SloParseError) as jerr:
            jslo.check_signal_kinds(jslo.parse_rules(rules),
                                    jfleet.AGGREGATION_POLICY)
        with pytest.raises(slo.SloParseError) as err:
            slo.check_signal_kinds(slo.parse_rules(rules),
                                   fleet.AGGREGATION_POLICY)
        assert str(err.value) == str(jerr.value)

    def test_burn_rate_flips_as_breaches_accumulate(self):
        rules = ["queue: serving_queue_depth / num_slots < 0.8"]
        eng = slo.SloEngine(slo.parse_rules(rules), burn_window=4)
        jeng = jslo.SloEngine(jslo.parse_rules(rules), burn_window=4)
        for queue in (1, 10, 10, None, 1, 10, 10, 10):
            values = {"serving_queue_depth": queue, "serving_num_slots": 4}
            resolve = lambda m, q: values.get(m)  # noqa: E731
            got = [(s.value, s.compliant, s.burn_rate, s.evaluations)
                   for s in eng.evaluate(resolve)]
            want = [(s.value, s.compliant, s.burn_rate, s.evaluations)
                    for s in jeng.evaluate(resolve)]
            assert got == want


# -- the collector ---------------------------------------------------------------


class TestCollector:
    def test_counter_sum_gauge_policy_histogram_quantile(self):
        f = _Fleet()
        for i in range(3):
            f.add("serving", "svc1", f"r{i}", _replica_registry(
                queue=float(i), occupancy=0.3 * i, tokens=10,
                ttfts=[0.2 * (i + 1)] * 5))
        j, jreg, p, reg = f.collectors()
        f.sweep_both(j, jreg, p, reg)
        for q in (0.5, 0.99):
            assert p.resolve_signal(
                "serving_time_to_first_token_seconds", q) == j.resolve_signal(
                "serving_time_to_first_token_seconds", q)
        assert p.serving_signals("default", "svc1").num_slots == 12.0

    def test_scrape_error_tolerated_and_reported(self):
        f = _Fleet()
        f.add("serving", "svc1", "r0", _replica_registry(queue=2))
        f.rows.append(("serving", "default", "svc1", "dead", "fake://dead",
                       "unified"))
        j, jreg, p, reg = f.collectors()
        f.sweep_both(j, jreg, p, reg)
        assert p.serving_signals("default", "svc1").replicas == 1
        assert "ERR" in "\n".join(p.fleetz_lines())

    def test_429_rate_and_slo_breach_with_a_fake_clock(self):
        f = _Fleet()
        reg0 = _replica_registry(queue=1, num_slots=4, n_429=5)
        f.add("serving", "svc1", "r0", reg0)
        j, jreg, p, reg = f.collectors(
            slo_rules=["queue: serving_queue_depth / num_slots < 0.8",
                       "ttft: serving_ttft_p99 < 1s"], burn_window=3)
        f.sweep_both(j, jreg, p, reg)
        for step in range(4):
            reg0.get("http_requests_total").inc(
                10 * step, app="model-server", method="POST", status="429")
            reg0.get("serving_queue_depth").set(40 * (step % 2), model="m")
            reg0.get("serving_time_to_first_token_seconds").observe(
                0.3 + step, model="m")
            f.now["t"] += 10.0
            f.sweep_both(j, jreg, p, reg)
        assert reg.get("fleet_slo_burn_rate").value(slo="queue") > 0
        assert p.serving_signals("default", "svc1").rate_429_per_s == 3.0

    def test_the_decode_half_of_the_disagg_signals(self):
        f = _Fleet()
        f.add("serving", "svc1", "p0", _replica_registry(
            queue=5, occupancy=0.1, num_slots=8), tier="prefill")
        f.add("serving", "svc1", "d0", _replica_registry(
            queue=3, occupancy=0.9, num_slots=4), tier="decode")
        f.add("serving", "svc1", "d1", _replica_registry(
            queue=1, occupancy=0.5, num_slots=4), tier="unified")
        j, jreg, p, reg = f.collectors()
        f.sweep_both(j, jreg, p, reg)
        d = p.disagg_signals("default", "svc1")
        assert (d.prefill_replicas, d.decode_replicas, d.decode_queue_depth,
                d.decode_num_slots) == (1, 2, 4.0, 8.0)
        assert d.decode_occupancy == pytest.approx(0.7)

    def test_the_router_role_and_the_prefill_tier_signals(self):
        """A router target's cold-prefix steers become the prefill tier's
        arrival rate, the replicas' TTFT the fleet p99; the router never
        counts as a replica; each replica's row keeps its heat."""
        f = _Fleet()
        router = MetricsRegistry()
        steers = router.counter("router_tier_steer_total", "",
                                ["tier", "reason"])
        router.counter("router_requests_total", "", ["outcome"]).inc(
            3, outcome="ok")
        f.add("router", "svc1", "svc1-router-0", router)
        for inst, tier, ttft, rate in (("p0", "prefill", 0.4, None),
                                       ("d0", "decode", 0.9, 0.25),
                                       ("d1", "decode", 1.8, 0.0)):
            r = _replica_registry(queue=1, occupancy=0.5, ttfts=[ttft] * 4)
            if rate is not None:
                r.gauge("serving_prefix_hit_rate", "", ["model"]).set(
                    rate, model="m")
                r.gauge("serving_first_page_keys", "", ["model"]).set(
                    3, model="m")
            f.add("serving", "svc1", inst, r, tier=tier)
        j, jreg, p, reg = f.collectors()
        rates = []
        for n_cold in (0, 4, 0, 10):
            steers.inc(n_cold, tier="prefill", reason="cold")
            steers.inc(1, tier="decode", reason="page-complete")
            f.now["t"] += 2.0
            f.sweep_both(j, jreg, p, reg)
            rates.append(p.disagg_signals("default", "svc1").cold_per_s)
        assert rates == [0.0, 2.0, 0.0, 5.0]
        d = p.disagg_signals("default", "svc1")
        assert (d.prefill_replicas, d.decode_replicas) == (1, 2)
        assert d.ttft_p99_s is not None and d.ttft_p99_s > 1.0
        assert reg.get("fleet_targets").value(role="router") == 1
        assert p.serving_signals("default", "svc1").replicas == 3
        rows = p.replica_serving_signals("default", "svc1")
        assert rows["d0"]["prefix_hit_rate"] == 0.25
        assert rows["d0"]["first_page_keys"] == 3
        assert "prefix_hit_rate" not in rows["p0"]
        assert p.replica_serving_signals("default", "svc1",
                                         instance="d1") == {"d1": rows["d1"]}
        assert any("tiers: prefill=1 ttft_p99=" in line and "cold/s=5.000"
                   in line for line in p.fleetz_lines())

    def test_chaos_scrape_fetch_degrades_one_target(self):
        f = _Fleet()
        for i in range(3):
            f.add("serving", "svc1", f"r{i}", _replica_registry(queue=i))
        j, jreg, p, reg = f.collectors()
        try:
            jdefault_chaos().arm([jparse_point("fleet.scrape_fetch:once")])
            default_chaos().arm([parse_point("fleet.scrape_fetch:once")])
            f.sweep_both(j, jreg, p, reg)
            assert p.serving_signals("default", "svc1").replicas == 2
            assert reg.get("fleet_targets").value(role="serving") == 2
            errs = [line for line in p.fleetz_lines() if "ERR" in line]
            assert len(errs) == 1 and "ChaosError" in errs[0]
            f.sweep_both(j, jreg, p, reg)
            assert p.serving_signals("default", "svc1").replicas == 3
        finally:
            jdefault_chaos().disarm()
            default_chaos().disarm()

    def test_scrape_loop_thread_runs_stops_and_restarts(self):
        f = _Fleet()
        f.add("serving", "svc1", "r0", _replica_registry(queue=1))
        col = fleet.FleetCollector(
            lambda: [fleet.ScrapeTarget(*r) for r in f.rows],
            fetch=f.fetch, registry=MetricsRegistry(), scrape_interval_s=0.01)
        gate = threading.Barrier(4)

        def go():
            gate.wait(timeout=5)
            col.start()

        try:
            starters = [threading.Thread(target=go) for _ in range(4)]
            for t in starters:
                t.start()
            for t in starters:
                t.join(timeout=5)
            loops = [t for t in threading.enumerate()
                     if t.name == "fleet-collector" and t.is_alive()]
            assert len(loops) == 1
            col.stop()
            swept = col.sweeps()
            col.start()
            deadline = time.monotonic() + 5
            while col.sweeps() == swept and time.monotonic() < deadline:
                time.sleep(0.01)
            assert col.sweeps() > swept
        finally:
            col.stop()

    def test_the_collectors_lock_under_the_armed_auditor(self):
        from kubeflow_tpu_torch.utils.audit_lock import (
            LockAuditError,
            default_auditor,
        )

        f = _Fleet()
        f.add("serving", "svc1", "r0", _replica_registry(queue=1))
        _, _, p, _ = f.collectors()
        auditor = default_auditor()
        auditor.enable()
        try:
            p.scrape_once()
            p.fleetz_lines()
            assert auditor.violations() == []
            # the JAX name, and a re-acquisition raises instead of hanging
            assert p._lock.name == "FleetCollector._lock"
            with p._lock:
                with pytest.raises(LockAuditError, match="self-deadlock"):
                    p._lock.acquire()
        finally:
            auditor.disable()

    def test_collector_from_config_and_refused_rules(self):
        from kubeflow_tpu.config.platform import (
            ObservabilityConfig as JObservabilityConfig,
        )
        from kubeflow_tpu_torch.config.platform import ObservabilityConfig

        kw = dict(slo_rules=["training_goodput > 0.5"],
                  fleet_scrape_interval_s=1.0, fleet_straggler_zscore=2.5,
                  fleet_burn_window=4)
        c = fleet.FleetCollector.from_config(
            ObservabilityConfig(**kw), lambda: [], registry=MetricsRegistry())
        jc = jfleet.FleetCollector.from_config(
            JObservabilityConfig(**kw), lambda: [],
            registry=jmetrics.MetricsRegistry())
        assert (c.scrape_interval_s, c.straggler_zscore,
                c._slo.rules[0].name) == (jc.scrape_interval_s,
                                          jc.straggler_zscore,
                                          jc._slo.rules[0].name)
        for rule, match in (("serving_ttft < 5s", "without a quantile"),
                            ("serving_queue_depth_p99 < 5", "not a histogram")):
            with pytest.raises(slo.SloParseError, match=match):
                fleet.FleetCollector(lambda: [], registry=MetricsRegistry(),
                                     slo_rules=[rule])


class TestStraggler:
    def _gang(self, f, slow=None, hosts=4):
        regs = {}
        for i in range(hosts):
            regs[f"h{i}"] = _host_registry([])
            f.add("training", "job1", f"h{i}", regs[f"h{i}"])
        return regs

    def _steps(self, regs, slow=None):
        for host, reg in regs.items():
            h = reg.get("training_step_seconds")
            for _ in range(5):
                h.observe(0.300 if host == slow else 0.100, model="mlp")

    @pytest.mark.parametrize("hosts,slow", [(4, "h2"), (4, None), (2, "h1")])
    def test_flagged_cleared_and_uniform_as_the_jax_detector(self, hosts,
                                                             slow):
        f = _Fleet()
        regs = self._gang(f, hosts=hosts)
        j, jreg, p, reg = f.collectors(straggler_zscore=3.0)
        for _ in range(3):
            self._steps(regs, slow)
            f.sweep_both(j, jreg, p, reg)
        flags = p.stragglers()
        assert any(flags.values()) == (hosts > 2 and slow is not None)
        # recovery drains the rolling window
        for _ in range(fleet.STRAGGLER_WINDOW + 1):
            self._steps(regs)
            f.sweep_both(j, jreg, p, reg)
        assert not any(p.stragglers().values())

    def test_straggler_gauge_zeroed_when_host_vanishes(self):
        f = _Fleet()
        for i in range(3):
            f.add("training", "job1", f"h{i}",
                  _host_registry([0.3 if i == 0 else 0.1] * 5))
        j, jreg, p, reg = f.collectors()
        f.sweep_both(j, jreg, p, reg)
        g = reg.get("fleet_straggler")
        assert g.value(job="default/job1", host="h0") == 1.0
        f.rows = [r for r in f.rows if r[3] != "h0"]
        f.sweep_both(j, jreg, p, reg)
        assert g.value(job="default/job1", host="h0") == 0.0


class TestMergedTraceAndFleetz:
    def _fleet(self):
        f = _Fleet()
        for i in range(2):
            f.add("training" if i else "serving", "job1", f"h{i}",
                  _replica_registry(queue=i, ttfts=[0.3]))
            capture = 5e6 + 1e3 * i
            f.docs[(f"h{i}", "debug/trace")] = json.dumps({
                "captureUs": capture,
                "traceEvents": [
                    {"name": "process_name", "ph": "M", "pid": 9, "tid": 0,
                     "args": {"name": "x"}},
                    {"name": f"work-{i}", "ph": "X", "ts": capture - 500.0,
                     "dur": 40.0, "pid": 9, "tid": 3 + i,
                     "args": {"trace_id": "req1/0" if i else "req1"}},
                    {"name": "idle", "ph": "X", "ts": capture - 900.0,
                     "dur": 5.0, "pid": 9, "tid": 1, "args": {}}]})
            tracez = {
                "captureUs": capture,
                "traces": [{"trace_id": "req1/0" if i else "req1",
                            "keep_reason": "tail", "error": bool(i),
                            "dur_s": 0.1 + i,
                            "spans": [{"name": f"s{i}", "t_start": 4.0}]}],
                "exemplars": {"serving_time_to_first_token_seconds": [
                    {"trace_id": "req1", "value": 0.5 + i}]}}
            f.docs[(f"h{i}", "tracez")] = json.dumps(tracez)
            f.docs[(f"h{i}", "tracez?exemplars_only=1")] = json.dumps(
                {"exemplars": tracez["exemplars"]})
        return f

    def test_merged_traces_and_fleetz_are_the_jax_collectors(self):
        f = self._fleet()
        j, jreg, p, reg = f.collectors(
            slo_rules=["ttft: serving_ttft_p99 < 1s"])
        f.sweep_both(j, jreg, p, reg)
        doc = p.merged_chrome_trace()
        assert doc == j.merged_chrome_trace()
        procs = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
        assert len(procs) == 2
        assert [e["ph"] for e in doc["traceEvents"]
                if e.get("cat") == "request"] == ["s", "f"]
        assert p.merged_tracez() == j.merged_tracez()
        assert "worst: trace req1" in "\n".join(p.fleetz_lines())

    def test_fleet_routes_on_a_debug_app(self):
        from kubeflow_tpu_torch.observability.http import build_debug_app

        f = self._fleet()
        _, _, p, _ = f.collectors()
        p.scrape_once()
        app = build_debug_app("ctl", fleet=p)
        for path in ("/fleetz", "/debug/fleet-trace", "/debug/fleet-tracez"):
            assert app.handle_full("GET", path)[0] == 200
        text = app.handle_full("GET", "/fleetz")[1].body.decode()
        for section in ("[targets]", "[serving fleets]", "[slo]",
                        "[stragglers]"):
            assert section in text
        assert build_debug_app("ctl2").handle_full("GET", "/fleetz")[0] == 404


# -- discovery ------------------------------------------------------------------


def test_discover_targets_from_store_pods():
    from kubeflow_tpu.cluster.objects import new_object as jnew_object
    from kubeflow_tpu.cluster.store import StateStore as JStore
    from kubeflow_tpu_torch.cluster.objects import new_object
    from kubeflow_tpu_torch.cluster.store import StateStore
    from kubeflow_tpu_torch.controllers.gpujob import JOB_NAME_LABEL

    def pods(make):
        return [
            make("Pod", "svc1-0", "default", api_version="v1",
                 labels={"inferenceservice": "svc1",
                         "inferenceservice-tier": "decode"},
                 spec={"containers": [{"name": "model-server", "env": [
                     {"name": "KFT_FLEET_METRICS_PORT", "value": "8500"}]}]}),
            make("Pod", "job1-0", "default", api_version="v1",
                 labels={JOB_NAME_LABEL: "job1"},
                 spec={"hostname": "job1-0", "subdomain": "job1-gang",
                       "containers": [{"name": "trainer", "env": [
                           {"name": "KFT_FLEET_METRICS_PORT", "value": "9432"},
                           {"name": "KFT_FLEET_INSTANCE", "value": "job1-0"},
                       ]}]}),
            make("Pod", "svc1-router-0", "default", api_version="v1",
                 labels={"app": "kft-router",
                         "inferenceservice-router": "svc1"},
                 spec={"containers": [{"name": "router", "env": [
                     {"name": "KFT_FLEET_METRICS_PORT", "value": "8600"}]}]}),
            make("Pod", "other", "default", api_version="v1",
                 spec={"containers": [{"name": "x", "env": []}]}),
        ]

    jstore, store = JStore(), StateStore()
    for pod in pods(jnew_object):
        jstore.create(pod)
    for pod in pods(new_object):
        store.create(pod)
    store.patch_status("Pod", "svc1-0", "default", {"podIP": "10.0.0.7"})
    jstore.patch_status("Pod", "svc1-0", "default", {"podIP": "10.0.0.7"})
    got = sorted(dataclasses.astuple(t)
                 for t in fleet.discover_targets(store))
    want = sorted(dataclasses.astuple(t)
                  for t in jfleet.discover_targets(jstore))
    assert got == want and len(got) == 3
    assert ("serving", "default", "svc1", "svc1-0", "http://10.0.0.7:8500",
            "decode") in got
    # the router is scraped as its own role, never as a replica
    assert ("router", "default", "svc1", "svc1-router-0",
            "http://svc1-router-0:8600", "unified") in got
    assert fleet.instance_id({"KFT_FLEET_INSTANCE": "pod-3"}) == "pod-3"


# -- the aggregation policy --------------------------------------------------------

_DECLARATION = re.compile(
    r'\.(counter|gauge|histogram)\(\s*"([a-z][a-z0-9_]*)"', re.S)
_LEGAL = {"counter": ("sum",), "histogram": ("merge",),
          "gauge": ("sum", "max", "min", "mean")}


def test_the_policy_covers_every_metric_the_port_declares_once():
    declared = {}
    for root, _, files in os.walk(os.path.join(REPO, "kubeflow_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for kind, metric in _DECLARATION.findall(f.read()):
                        declared.setdefault(metric, set()).add(kind)
    scraped = {m: k for m, k in declared.items()
               if not m.startswith("fleet_")}
    assert set(fleet.AGGREGATION_POLICY) == set(scraped)
    for metric, kinds in scraped.items():
        (kind,) = kinds
        assert fleet.AGGREGATION_POLICY[metric] in _LEGAL[kind], metric
    # each name once in the table's literal (a dict keeps the last of a
    # duplicate silently)
    with open(fleet.__file__) as f:
        tree = ast.parse(f.read())
    (table,) = [n.value for n in ast.walk(tree)
                if isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", "") == "AGGREGATION_POLICY"]
    keys = [k.value for k in table.keys]
    assert len(keys) == len(set(keys))
    # the reference's entries under the port's names agree on the policy
    for metric, pol in fleet.AGGREGATION_POLICY.items():
        ref = jfleet.AGGREGATION_POLICY.get(
            metric.replace("gpujob_", "tpujob_"))
        assert ref in (None, pol), metric


# -- the decode-tier autoscaler ---------------------------------------------------


class _ScriptedFleet:
    """serving_signals scripted a reconcile (`make` builds the package's
    FleetSignals)."""

    def __init__(self, make, signals):
        self.signals = [None if s is None else make(**s) for s in signals]
        self.i = 0

    def serving_signals(self, namespace, name):
        sig = self.signals[min(self.i, len(self.signals) - 1)]
        self.i += 1
        return sig


def _pressure(replicas=1, sweep=-1):
    return dict(replicas=replicas, queue_depth=30.0, occupancy=1.0,
                num_slots=8.0 * replicas, rate_429_per_s=2.0, sweep=sweep)


def _idle(replicas=1, sweep=-1):
    return dict(replicas=replicas, queue_depth=0.0, occupancy=0.05,
                num_slots=8.0 * replicas, rate_429_per_s=0.0, sweep=sweep)


def _trajectory(pkg, signals, autoscale, replicas, reconciles, fleet_src=True,
                delete_at=None):
    """spec.replicas and the events after each reconcile, and the
    autoscale.resize trace events, through `pkg`'s controller."""
    import importlib

    store_mod = importlib.import_module(f"{pkg}.cluster.store")
    inference = importlib.import_module(f"{pkg}.controllers.inference")
    fleet_mod = importlib.import_module(f"{pkg}.observability.fleet")
    tracer = importlib.import_module(
        f"{pkg}.observability.trace").default_tracer()
    tracer.clear()
    store = store_mod.StateStore()
    src = _ScriptedFleet(fleet_mod.FleetSignals, signals) if fleet_src \
        else None
    ctrl = inference.InferenceServiceController(fleet=src)
    store.create(inference.new_inference_service(
        "svc1", model="gpt_tiny", replicas=replicas,
        serving={"autoscale": autoscale}))
    out = []
    for i in range(reconciles):
        if i == delete_at:
            store.delete("InferenceService", "svc1")
        res = ctrl.reconcile(store, "default", "svc1")
        cr = store.try_get("InferenceService", "svc1")
        out.append((cr and cr["spec"]["replicas"],
                    cr and [e["reason"] for e in store.events_for(cr)],
                    res.requeue_after_s, len(ctrl._scale_state)))
    resized = [(r.attrs["reason"], r.attrs["replicas_from"],
                r.attrs["replicas_to"]) for r in tracer.snapshot()
               if r.name == "autoscale.resize"]
    return out, resized


AUTOSCALE_CASES = {
    "scale_up_needs_breach_streak": (
        [_pressure()] * 10, dict(max_replicas=3, breach_cycles=3,
                                 cooldown_cycles=0), 1, 4),
    "scale_up_respects_max_and_cooldown": (
        [_pressure()] * 50, dict(max_replicas=2, breach_cycles=1,
                                 cooldown_cycles=3), 1, 7),
    "scale_down_on_receding_signals": (
        [_idle(2)] * 10, dict(max_replicas=3, breach_cycles=2,
                              cooldown_cycles=0), 2, 6),
    "mixed_signals_reset_streaks": (
        [_pressure(), _idle(), _pressure(), _idle()] * 3,
        dict(max_replicas=3, breach_cycles=2, cooldown_cycles=0), 1, 12),
    "disabled_never_scales": (
        [_pressure()] * 5, dict(enabled=False), 1, 5),
    "same_sweep_reads_do_not_advance_streaks": (
        [_pressure(sweep=1)] * 3 + [_pressure(sweep=2)],
        dict(max_replicas=3, breach_cycles=2, cooldown_cycles=0), 1, 4),
    "signal_outage_resets_streaks": (
        [_pressure(), _pressure(), None, None, _pressure()],
        dict(max_replicas=3, breach_cycles=3, cooldown_cycles=0), 1, 5),
    "replica_clamp_into_min_max_band": (
        [_idle(5)] * 3, dict(max_replicas=3, breach_cycles=99,
                             cooldown_cycles=0), 5, 1),
}


class TestAutoscaler:
    @pytest.mark.parametrize("case", sorted(AUTOSCALE_CASES))
    def test_the_jax_controllers_trajectory(self, case):
        signals, knobs, replicas, n = AUTOSCALE_CASES[case]
        autoscale = dict({"enabled": True, "min_replicas": 1}, **knobs)
        got = _trajectory("kubeflow_tpu_torch", signals, autoscale,
                          replicas, n)
        want = _trajectory("kubeflow_tpu", signals, autoscale, replicas, n)
        assert got == want
        if case == "scale_up_needs_breach_streak":
            assert [r for r, *_ in got[0]] == [1, 1, 2, 2]
            assert got[1] == [("ScaleUp", 1, 2)]

    def test_no_fleet_and_deletion_drop_the_state(self):
        autoscale = {"enabled": True, "max_replicas": 2, "breach_cycles": 1,
                     "cooldown_cycles": 99}
        for kw in (dict(fleet_src=False), dict(delete_at=1)):
            got = _trajectory("kubeflow_tpu_torch", [_pressure()] * 3,
                              autoscale, 1, 2, **kw)
            want = _trajectory("kubeflow_tpu", [_pressure()] * 3,
                               autoscale, 1, 2, **kw)
            assert got == want
            assert got[0][-1][-1] == 0   # no hysteresis entry left

    def test_autoscale_config_validates_as_the_jax_config(self):
        from kubeflow_tpu.config.core import ConfigError as JConfigError
        from kubeflow_tpu.config.platform import (
            AutoscaleConfig as JAutoscaleConfig,
        )
        from kubeflow_tpu_torch.config.platform import (
            AutoscaleConfig,
            ConfigError,
        )

        assert dataclasses.asdict(AutoscaleConfig()) == dataclasses.asdict(
            JAutoscaleConfig())
        for bad in (dict(min_replicas=3, max_replicas=2),
                    dict(scale_down_occupancy=0.9, scale_up_occupancy=0.9),
                    dict(breach_cycles=0), dict(cooldown_cycles=-1),
                    dict(scale_up_queue_per_slot=-1), dict(min_replicas=-1)):
            with pytest.raises(JConfigError) as jerr:
                JAutoscaleConfig(**bad).validate()
            with pytest.raises(ConfigError) as err:
                AutoscaleConfig(**bad)
            assert str(err.value) == str(jerr.value)


class TestEndToEndSignalLoop:
    """Three fake replicas with rising queue depth → aggregated series →
    the SLO breach → both controllers raise spec.replicas, and scale
    back down when the signals recede, sweep for sweep alike."""

    def test_full_loop(self):
        from kubeflow_tpu.cluster.store import StateStore as JStore
        from kubeflow_tpu.controllers.inference import (
            InferenceServiceController as JController,
            new_inference_service as jnew_service,
        )
        from kubeflow_tpu_torch.cluster.store import StateStore
        from kubeflow_tpu_torch.controllers.inference import (
            InferenceServiceController,
            new_inference_service,
        )

        f = _Fleet()
        regs = []
        for i in range(3):
            regs.append(_replica_registry(queue=0, occupancy=0.2,
                                          num_slots=4))
            f.add("serving", "svc1", f"r{i}", regs[-1])
        j, jreg, p, reg = f.collectors(
            slo_rules=["queue: serving_queue_depth / num_slots < 0.8"])
        serving = {"autoscale": {"enabled": True, "min_replicas": 1,
                                 "max_replicas": 3, "breach_cycles": 2,
                                 "cooldown_cycles": 0}}
        jstore, store = JStore(), StateStore()
        jctrl, ctrl = JController(fleet=j), InferenceServiceController(
            fleet=p)
        jstore.create(jnew_service("svc1", model="gpt_tiny", serving=serving))
        store.create(new_inference_service("svc1", model="gpt_tiny",
                                           serving=serving))

        def step(sweep=True):
            if sweep:
                f.sweep_both(j, jreg, p, reg)
            jctrl.reconcile(jstore, "default", "svc1")
            ctrl.reconcile(store, "default", "svc1")
            got = store.get("InferenceService", "svc1")["spec"]["replicas"]
            want = jstore.get("InferenceService", "svc1")["spec"]["replicas"]
            assert got == want
            return got, reg.get("fleet_slo_compliant").value(slo="queue")

        assert step() == (1, 1.0)
        for r in regs:
            r.get("serving_queue_depth").set(20, model="m")
            r.get("serving_slot_occupancy").set(1.0, model="m")
        assert step() == (1, 0.0)
        assert step(sweep=False) == (1, 0.0)   # one sweep, read twice
        assert step() == (2, 0.0)
        for r in regs:
            r.get("serving_queue_depth").set(0, model="m")
            r.get("serving_slot_occupancy").set(0.05, model="m")
        assert step() == (2, 1.0)
        assert step() == (1, 1.0)


# -- a real socket ------------------------------------------------------------------


def test_the_collector_scrapes_a_real_port_model_server(monkeypatch):
    """The port's ModelServer behind a socket: one sweep reads its slots,
    tokens and identity, and /fleetz answers on a debug server."""
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.observability.http import build_debug_app
    from kubeflow_tpu_torch.serving.main import build_server

    monkeypatch.setattr(metrics, "_default_registry", MetricsRegistry())
    monkeypatch.setenv("KFT_FLEET_INSTANCE", "svc1-0")
    ms = build_server("gpt_tiny", device="cpu", dtype=torch.float32,
                      num_slots=2, page_size=8, prefill_buckets=[8, 32],
                      batch_window_ms=0)
    server = Server(ms.app)
    server.start()
    debug = None
    try:
        status, body, _ = ms.app.handle_full(
            "POST", "/v1/models/gpt_tiny:generate",
            body={"prompt_ids": [[1, 2, 3, 4, 5]], "max_new_tokens": 4})
        assert status == 200
        targets = [fleet.ScrapeTarget("serving", "default", "svc1", "svc1-0",
                                      f"http://127.0.0.1:{server.port}")]
        col = fleet.FleetCollector(lambda: targets,
                                   registry=MetricsRegistry())
        col.scrape_once()
        sig = col.serving_signals("default", "svc1")
        assert (sig.replicas, sig.num_slots, sig.queue_depth) == (1, 2.0, 0.0)
        series = col.fleet_series()
        assert series["serving_tokens_total"].samples[
            (("model", "gpt_tiny"),)] == 4.0
        # the identity line, its instance label dropped by the merge
        assert series["kft_instance_info"].samples == {
            (("role", "serving"),): 1.0}
        debug = Server(build_debug_app("ctl", fleet=col))
        debug.start()
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{debug.port}/fleetz", timeout=10) as resp:
            text = resp.read().decode()
        assert "default/svc1: replicas=1" in text and "slots=2" in text
    finally:
        if debug is not None:
            debug.stop()
        server.stop()
        ms.close()
