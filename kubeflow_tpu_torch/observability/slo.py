"""Declarative SLO rules over fleet-aggregated metrics (copy of
kubeflow_tpu/observability/slo.py; the aliases name the port's series,
which keep the reference's names).

The fleet collector (observability/fleet.py) merges every replica's and
every gang host's /metrics into fleet-level series; this module turns an
operator-declared rule list (`ObservabilityConfig.slo_rules`, slo.yaml
style) into live compliance + burn-rate gauges:

    serving_ttft_p99 < 5s
    training_goodput > 0.85
    queue: serving_queue_depth / num_slots < 0.8

Grammar (one rule per string):

    [name :] signal [/ signal] OP threshold[unit]

- `signal` is a fleet metric name, an alias from SIGNAL_ALIASES, or a
  `<metric>_p<NN>` histogram quantile (p99 = 0.99 over the MERGED
  bucket ladder — the cross-replica quantile, not a mean of per-replica
  quantiles, which is statistically meaningless).
- OP is one of < <= > >=.
- threshold takes an optional `s`/`ms` duration unit (5s, 250ms).
- `name:` labels the `fleet_slo_*{slo=...}` series; defaults to the
  left-hand expression text.

Evaluation is pure: `SloEngine.evaluate(resolver)` takes a callable
mapping signal names to floats (the collector passes its merged-series
resolver; tests pass a dict lookup), so the engine needs no scrape
infrastructure. Each evaluation appends to a bounded per-rule window;
burn rate = breached fraction of that window — the page-worthy signal
(a single breached scrape is noise, a half-burned window is not).
"""

from __future__ import annotations

import dataclasses
import re
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

# operator-facing shorthand -> the registered metric name (the engine's
# `serving_time_to_first_token_seconds` and utils/metrics.py
# `serving_num_slots_gauge`)
SIGNAL_ALIASES: Dict[str, str] = {
    "serving_ttft": "serving_time_to_first_token_seconds",
    "num_slots": "serving_num_slots",
}

_RULE_RE = re.compile(
    r"^\s*(?:(?P<name>[A-Za-z0-9_.-]+)\s*:\s*)?"
    r"(?P<lhs>[a-z][a-z0-9_]*)"
    r"(?:\s*/\s*(?P<div>[a-z][a-z0-9_]*))?"
    r"\s*(?P<op><=|>=|<|>)\s*"
    r"(?P<thr>[0-9]+(?:\.[0-9]+)?(?:e-?[0-9]+)?)"
    r"\s*(?P<unit>ms|s)?\s*$"
)
_QUANTILE_RE = re.compile(r"^(?P<base>[a-z][a-z0-9_]*?)_p(?P<q>[0-9]{1,2})$")

_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class SloParseError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Signal:
    """One side of a rule: a metric name, optionally a quantile of it."""

    metric: str
    quantile: Optional[float] = None  # None = scalar value
    raw: str = ""

    def __str__(self) -> str:
        return self.raw or self.metric


def parse_signal(text: str) -> Signal:
    name = SIGNAL_ALIASES.get(text, text)
    m = _QUANTILE_RE.match(text)
    if m is not None:
        base = SIGNAL_ALIASES.get(m.group("base"), m.group("base"))
        return Signal(metric=base, quantile=int(m.group("q")) / 100.0, raw=text)
    return Signal(metric=name, raw=text)


@dataclasses.dataclass(frozen=True)
class SloRule:
    name: str            # the {slo} label value
    lhs: Signal
    divisor: Optional[Signal]
    op: str
    threshold: float
    raw: str

    def check(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)


def parse_rule(text: str) -> SloRule:
    m = _RULE_RE.match(text)
    if m is None:
        raise SloParseError(
            f"unparseable SLO rule {text!r}; expected "
            f"'[name:] signal [/ signal] <op> threshold[s|ms]' with op "
            f"in {sorted(_OPS)}"
        )
    threshold = float(m.group("thr"))
    if m.group("unit") == "ms":
        threshold /= 1e3
    lhs = parse_signal(m.group("lhs"))
    div = parse_signal(m.group("div")) if m.group("div") else None
    name = m.group("name") or (
        f"{m.group('lhs')}/{m.group('div')}" if div else m.group("lhs")
    )
    return SloRule(
        name=name, lhs=lhs, divisor=div, op=m.group("op"),
        threshold=threshold, raw=text.strip(),
    )


def parse_rules(texts: Sequence[str]) -> List[SloRule]:
    rules = [parse_rule(t) for t in texts if t.strip()]
    seen: Dict[str, str] = {}
    for r in rules:
        if r.name in seen:
            raise SloParseError(
                f"duplicate SLO name {r.name!r} ({seen[r.name]!r} vs "
                f"{r.raw!r}) — the fleet_slo_* series would collide"
            )
        seen[r.name] = r.raw
    return rules


def check_signal_kinds(
    rules: Sequence[SloRule], policy: Dict[str, str]
) -> None:
    """Cross-check every rule's signals against the fleet aggregation-
    policy table (observability/fleet.py): a histogram metric used
    without a quantile — or a quantile of a scalar metric — parses fine
    but can NEVER resolve, so the rule would silently stay 'unknown'
    forever. Caught at config/collector construction instead. Metrics
    absent from the table (foreign exporters) are left alone."""
    for rule in rules:
        for sig in (rule.lhs, rule.divisor):
            if sig is None:
                continue
            pol = policy.get(sig.metric)
            if pol == "merge" and sig.quantile is None:
                raise SloParseError(
                    f"{rule.raw!r}: signal {sig!s} names histogram "
                    f"metric {sig.metric!r} without a quantile — it "
                    f"would never evaluate; use {sig!s}_p99 (or another "
                    f"_pNN)"
                )
            if sig.quantile is not None and pol is not None and pol != "merge":
                raise SloParseError(
                    f"{rule.raw!r}: signal {sig!s} takes a quantile of "
                    f"{sig.metric!r}, which is not a histogram"
                )


# resolver contract: (metric_name, quantile-or-None) -> float, or None when
# the fleet has no data for that signal yet
SignalResolver = Callable[[str, Optional[float]], Optional[float]]


@dataclasses.dataclass
class SloStatus:
    rule: SloRule
    value: Optional[float]      # None = no data this evaluation
    compliant: Optional[bool]   # None = never evaluated with data
    burn_rate: float
    evaluations: int


class SloEngine:
    """Evaluates parsed rules against a signal resolver, keeping a bounded
    burn-rate window per rule. Single-threaded by contract: the fleet
    collector drives it from its one scrape loop (or a test drives it
    directly); it holds no lock of its own."""

    def __init__(self, rules: Sequence[SloRule], burn_window: int = 30):
        if burn_window < 1:
            raise ValueError("burn_window must be >= 1")
        self.rules = list(rules)
        self._window: Dict[str, Deque[bool]] = {
            r.name: deque(maxlen=burn_window) for r in self.rules
        }
        self._last: Dict[str, SloStatus] = {
            r.name: SloStatus(r, None, None, 0.0, 0)
            for r in self.rules
        }

    def _value(self, rule: SloRule, resolve: SignalResolver) -> Optional[float]:
        lhs = resolve(rule.lhs.metric, rule.lhs.quantile)
        if lhs is None:
            return None
        if rule.divisor is None:
            return lhs
        div = resolve(rule.divisor.metric, rule.divisor.quantile)
        if div is None or div == 0:
            return None
        return lhs / div

    def evaluate(self, resolve: SignalResolver) -> List[SloStatus]:
        """One evaluation sweep. Rules whose signals have no data are
        SKIPPED (status keeps its last verdict, the window does not grow):
        an empty fleet is unknown, not compliant."""
        out: List[SloStatus] = []
        for rule in self.rules:
            value = self._value(rule, resolve)
            status = self._last[rule.name]
            if value is not None:
                ok = rule.check(value)
                window = self._window[rule.name]
                window.append(not ok)
                status = SloStatus(
                    rule=rule,
                    value=value,
                    compliant=ok,
                    burn_rate=sum(window) / len(window),
                    evaluations=status.evaluations + 1,
                )
                self._last[rule.name] = status
            out.append(status)
        return out

    def statuses(self) -> List[SloStatus]:
        return [self._last[r.name] for r in self.rules]
