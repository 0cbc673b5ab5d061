"""StudyJob controller — hyperparameter search over gang-scheduled trials
(port of kubeflow_tpu/controllers/studyjob.py, the Katib StudyJob
equivalent): suggestions → trials → conditions.

Each trial IS a GPUTrainJob (controllers/gpujob.py), so the parallelism
unit is a whole gang; trials/hr on a fixed pool of cards is the metric
BASELINE.md names. Parameters address TrainingConfig fields by dotted path
(e.g. `training.learning_rate`).

Spec:
  objective:   {type: maximize|minimize, metric: items_per_sec|final_loss|…}
  algorithm:   {name: grid|random, seed}
  parameters:  [{name: training.learning_rate, type: double,
                 min: 0.001, max: 0.1, step?: …, list?: […]}]
  maxTrials, parallelism
  trialTemplate: a GPUTrainJob spec (slice + training + runPolicy)
  warmStartFrom: a checkpoint directory — every trial initializes its
                 params from the latest committed checkpoint there
                 (rendered as training.checkpoint.warm_start_dir)
"""

from __future__ import annotations

import copy
import itertools
import random as _random
from typing import Any, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.cluster.objects import new_object, set_condition, set_owner
from kubeflow_tpu_torch.cluster.reconciler import Controller, Result
from kubeflow_tpu_torch.cluster.store import AlreadyExists, StateStore
from kubeflow_tpu_torch.controllers.helpers import list_owned
from kubeflow_tpu_torch.controllers.gpujob import (
    COND_FAILED as JOB_FAILED,
    COND_SUCCEEDED as JOB_SUCCEEDED,
    KIND as TRIAL_KIND,
)
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import default_registry

log = get_logger(__name__)

KIND = "StudyJob"
STUDY_LABEL = "kubeflow-tpu.dev/study-name"
TRIAL_INDEX_LABEL = "kubeflow-tpu.dev/trial-index"

COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_COMPLETED = "Completed"
COND_FAILED = "Failed"


def new_study_job(
    name: str,
    namespace: str = "default",
    objective: Optional[Dict[str, Any]] = None,
    algorithm: Optional[Dict[str, Any]] = None,
    parameters: Optional[List[Dict[str, Any]]] = None,
    trial_template: Optional[Dict[str, Any]] = None,
    max_trials: int = 6,
    parallelism: int = 2,
) -> Dict[str, Any]:
    return new_object(
        KIND,
        name,
        namespace,
        spec={
            "objective": objective
            or {"type": "maximize", "metric": "items_per_sec"},
            "algorithm": algorithm or {"name": "grid"},
            "parameters": list(parameters or []),
            "maxTrials": max_trials,
            "parallelism": parallelism,
            "trialTemplate": dict(trial_template or {}),
        },
    )


def _grid_points(param: Dict[str, Any]) -> List[Any]:
    if param.get("list"):
        return list(param["list"])
    lo, hi = param["min"], param["max"]
    n = int(param.get("gridPoints", 3))
    if param.get("type") == "int":
        if n == 1:
            return [int(lo)]
        step = (hi - lo) / (n - 1)
        return sorted({int(round(lo + i * step)) for i in range(n)})
    if n == 1:
        return [lo]
    return [lo + i * (hi - lo) / (n - 1) for i in range(n)]


def _random_point(param: Dict[str, Any], rng: _random.Random) -> Any:
    if param.get("list"):
        return rng.choice(param["list"])
    lo, hi = param["min"], param["max"]
    if param.get("type") == "int":
        return rng.randint(int(lo), int(hi))
    if param.get("scale") == "log":
        import math

        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    return rng.uniform(lo, hi)


def generate_suggestions(
    spec: Dict[str, Any], max_trials: int
) -> List[Dict[str, Any]]:
    """Suggestion engine: grid (cartesian, truncated) or seeded random."""
    params = spec.get("parameters", [])
    algo = spec.get("algorithm", {}).get("name", "grid")
    if not params:
        return [{}]
    if algo == "grid":
        axes = [[(p["name"], v) for v in _grid_points(p)] for p in params]
        combos = list(itertools.product(*axes))[:max_trials]
        return [dict(c) for c in combos]
    if algo == "random":
        rng = _random.Random(spec.get("algorithm", {}).get("seed", 0))
        return [
            {p["name"]: _random_point(p, rng) for p in params}
            for _ in range(max_trials)
        ]
    raise ValueError(f"unknown suggestion algorithm {algo!r}")


def set_by_path(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


class StudyJobController(Controller):
    kind = KIND
    name = "studyjob-controller"

    def __init__(self) -> None:
        super().__init__()
        self.watches = {TRIAL_KIND: self.map_owned}
        reg = default_registry()
        self._trials_total = reg.counter(
            "study_trials_total", "trial outcomes", ["outcome"]
        )
        self._studies_total = reg.counter(
            "study_total", "study outcomes", ["outcome"]
        )

    def reconcile(self, store: StateStore, namespace: str, name: str) -> Result:
        study = store.try_get(KIND, name, namespace)
        if study is None or study["metadata"].get("deletionTimestamp"):
            return Result()
        status = study.setdefault("status", {})
        # written back only when this pass changed it: a write is a watch
        # event that enqueues the study again, so an unconditional write
        # reconciled it in a loop (the JAX controller writes every pass)
        before = copy.deepcopy(status)
        if any(
            c.get("type") in (COND_COMPLETED, COND_FAILED)
            and c.get("status") == "True"
            for c in status.get("conditions", [])
        ):
            return Result()

        spec = study.get("spec", {})
        max_trials = int(spec.get("maxTrials", 6))
        parallelism = max(1, int(spec.get("parallelism", 2)))
        objective = spec.get("objective", {})
        metric_key = objective.get("metric", "items_per_sec")
        maximize = objective.get("type", "maximize") != "minimize"

        try:
            suggestions = generate_suggestions(spec, max_trials)
        except (ValueError, KeyError) as e:
            self._fail(store, study, "InvalidSpec", str(e))
            return Result()
        if not status.get("suggestions"):
            status["suggestions"] = suggestions
            set_condition(study, COND_CREATED, "True", "SuggestionsGenerated", "")
        suggestions = status["suggestions"]
        total = len(suggestions)

        trials = {
            int(t["metadata"]["labels"][TRIAL_INDEX_LABEL]): t
            for t in list_owned(store, study, TRIAL_KIND)
        }

        # collect finished trials
        results: List[Tuple[int, Optional[float], str]] = []
        trial_metrics: Dict[int, Dict[str, Any]] = {}
        for idx, t in trials.items():
            conds = {
                c["type"]: c["status"]
                for c in t.get("status", {}).get("conditions", [])
            }
            if conds.get(JOB_SUCCEEDED) == "True":
                tm = t.get("status", {}).get("trainingMetrics", {})
                trial_metrics[idx] = tm
                val = tm.get(metric_key)
                results.append((idx, val, "succeeded"))
            elif conds.get(JOB_FAILED) == "True":
                results.append((idx, None, "failed"))

        done = {idx for idx, _, _ in results}
        active = [i for i in trials if i not in done]

        # launch next trials up to the parallelism budget
        launched = set(trials)
        for idx in range(total):
            if len(active) >= parallelism:
                break
            if idx in launched:
                continue
            trial = self._build_trial(study, idx, suggestions[idx])
            try:
                store.create(trial)
            except AlreadyExists:
                pass
            active.append(idx)

        status["trialsRunning"] = len(active)
        status["trialsSucceeded"] = sum(
            1 for _, _, outcome in results if outcome == "succeeded"
        )
        status["trialsFailed"] = sum(
            1 for _, _, outcome in results if outcome == "failed"
        )
        if active:
            set_condition(study, COND_RUNNING, "True", "TrialsRunning", "")

        if len(done) >= total:
            scored = [
                (idx, val)
                for idx, val, outcome in results
                if outcome == "succeeded" and val is not None
            ]
            if not scored:
                self._fail(store, study, "AllTrialsFailed", "no trial produced a metric")
                return Result()
            best_idx, best_val = (
                max(scored, key=lambda x: x[1])
                if maximize
                else min(scored, key=lambda x: x[1])
            )
            status["bestTrial"] = {
                "index": best_idx,
                "parameters": suggestions[best_idx],
                "metric": {metric_key: best_val},
                # every metric the trial surfaced (items_per_sec is
                # steady-state; compile_s is the separated one-time cost)
                "allMetrics": trial_metrics.get(best_idx, {}),
            }
            set_condition(study, COND_RUNNING, "False", "TrialsDone", "")
            set_condition(
                study,
                COND_COMPLETED,
                "True",
                "StudyCompleted",
                f"best trial {best_idx}: {metric_key}={best_val:.4f}",
            )
            self._studies_total.inc(outcome="completed")
            store.record_event(
                study,
                "StudyCompleted",
                f"best {suggestions[best_idx]} → {metric_key}={best_val:.4f}",
            )

        if status != before:
            store.patch_status(KIND, name, namespace, status)
        return Result()

    def _build_trial(
        self, study: Dict[str, Any], index: int, assignment: Dict[str, Any]
    ) -> Dict[str, Any]:
        m = study["metadata"]
        template = copy.deepcopy(study["spec"].get("trialTemplate", {}))
        warm_start = study["spec"].get("warmStartFrom")
        if warm_start:
            # parent-checkpoint warm start: the trial's run restores
            # params (not step/optimizer) from this directory on a fresh
            # start — runtime/train_run.py run_training
            set_by_path(
                template, "training.checkpoint.warm_start_dir", warm_start
            )
        for dotted, value in assignment.items():
            set_by_path(template, dotted, value)
        trial = new_object(
            TRIAL_KIND,
            f"{m['name']}-trial-{index}",
            m["namespace"],
            spec=template,
            labels={
                STUDY_LABEL: m["name"],
                TRIAL_INDEX_LABEL: str(index),
            },
        )
        set_owner(trial, study)
        self._trials_total.inc(outcome="launched")
        return trial

    def _fail(self, store, study, reason: str, message: str) -> None:
        set_condition(study, COND_FAILED, "True", reason, message)
        self._studies_total.inc(outcome="failed")
        m = study["metadata"]
        store.patch_status(KIND, m["name"], m["namespace"], study["status"])
