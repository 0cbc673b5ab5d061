"""Training-run entry point (port of kubeflow_tpu/runtime/train_run.py):
config → Trainer → (resume, fit, final save) → the result dict.

`run_training` returns the JAX `_run_training_armed` keys (`final_step`,
`loss`, `items_per_sec`, `already_complete`, `preempted`, `warm_started`
when a warm start ran, and `compile_s` when the first step was fenced),
plus the last window's `step_time_s`, `mfu` (on a listed card) and
`goodput`, `restore_s` (the resume's restore, wall seconds, when one
ran), `losses`: every step's (step, loss), read on the host at the
first-step fence and at each log window (one sync a window), and the
gang's `world_size` and `grad_allreduces` (0 off a gang), and on an
fsdp mesh axis `fsdp_collectives` (the rank's gathers and
reduce-scatters of its fsdp blocks, the trainer's `FsdpShard.counts`),
and on a tensor mesh axis `tensor_collectives` (the rank's all-reduces
over the tensor group, `TensorShard.counts`). A run with
eval data (the config's `data`: blobs or npz with a held-out split) adds
the JAX keys `eval_top1`, `eval_loss` and `target_reached`. Every
registry model trains here: the GPT family, ResNet and the mlp.

The restore gate is the JAX package's: `KFT_CHECKPOINT_DIR` overrides
`cfg.checkpoint.directory`; `restore=True` resumes from the latest
committed step whether or not saving is enabled; a budget the checkpoint
already covers returns `already_complete` and trains nothing;
`cfg.checkpoint.warm_start_dir` restores params only on a run that did
not resume. SIGTERM sets the stop event (from the main thread), so a
preempted run finishes its step in flight, saves it (forced) and exits
cleanly; the manager is closed in `finally` with the SIGTERM handler
still installed.

In a `torch.distributed` group (runtime/launcher.py starts one process a
rank) the run builds `cfg.mesh` as a DeviceMesh over the group's ranks
(its size must be the world's) and trains data-parallel
(training/trainer.py). Every rank restores from the one checkpoint
directory; only rank 0 writes and commits (checkpointing/manager.py),
and only rank 0 logs the result. A preemption stops every rank at the
step its SIGTERM lands on; as in the JAX package there is no
cross-rank stop protocol (each process of a gang receives the signal).

kft-chaos: the run's KFT_CHAOS_* env arms the process's injection
points for THIS run only (no plan disarms them), the `gang.host_exit`
point fires before anything is built, and the plan is disarmed on every
exit path. The run's KFT_TRACE_* knobs configure the process tracer (the
run's spans: `train.*`). As in the JAX package, only the env is read:
the config's `chaos` and `observability` reach a run as the KFT_CHAOS_*
and KFT_TRACE_* env the GPUTrainJob controller renders into its pods
(controllers/gpujob.py); a run given the config alone carries them and
ignores them. Not ported yet (ROADMAP A14): the compile cache.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.utils.device import DeviceLike
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Rendered by the GPUTrainJob controller into every gang pod whenever the job
# checkpoints: the one directory both the periodic saves and the
# restart-resume path read. Wins over the config knob.
ENV_CHECKPOINT_DIR = "KFT_CHECKPOINT_DIR"


def _install_preempt_handler(stop_event: threading.Event):
    """SIGTERM → stop_event; returns the undo callable. Signal handlers
    install only from the main thread; elsewhere the event can still be
    set directly."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    try:
        previous = signal.signal(
            signal.SIGTERM, lambda signum, frame: stop_event.set()
        )
    except ValueError:  # no signal support in this context
        return lambda: None
    return lambda: signal.signal(signal.SIGTERM, previous)


def run_training(cfg: TrainingConfig, restore: bool = False,
                 steps_override: Optional[int] = None,
                 stop_event: Optional[threading.Event] = None,
                 device: DeviceLike = None, log_every: int = 10,
                 environ=None, trainer=None) -> Dict[str, Any]:
    """Run one training job to its step budget (cfg.steps, or
    `steps_override`, counted from step 0: a resumed run takes only the
    remaining steps); returns the result metrics. `device` defaults to
    "cuda" and raises without CUDA unless "cpu" is asked for. `environ`
    is the job's environment (default the process's): its KFT_CHAOS_*
    plan is armed for this run and disarmed on every exit, and its
    KFT_TRACE_* knobs configure the tracer. `trainer`
    runs the job in place of a fresh `Trainer(cfg, device=device)`; its
    `_final_state` is the run's state afterwards."""
    from kubeflow_tpu_torch.chaos import (
        configure_from_env as configure_chaos,
        default_chaos,
    )
    from kubeflow_tpu_torch.observability.trace import (
        configure_from_env as configure_tracer,
    )

    env = os.environ if environ is None else environ
    if any(key.startswith("KFT_TRACE_") for key in env):
        configure_tracer(env)
    chaos_armed = configure_chaos(environ=env)
    try:
        # the host-exit seam: a fault here is the process dying before
        # the run trains at all
        default_chaos().maybe_fail("gang.host_exit")
        return _run_training_armed(cfg, restore, steps_override, stop_event,
                                   device, log_every, env, trainer)
    finally:
        if chaos_armed:
            default_chaos().disarm()


def _run_training_armed(cfg: TrainingConfig, restore: bool,
                        steps_override: Optional[int],
                        stop_event: Optional[threading.Event],
                        device: DeviceLike, log_every: int, env,
                        trainer) -> Dict[str, Any]:
    from kubeflow_tpu_torch.parallel.distributed import rank
    from kubeflow_tpu_torch.training.trainer import Trainer

    if trainer is None:
        trainer = Trainer(cfg, device=device)
    ckpt_mgr = None
    state = None
    restored_step = 0
    restore_s = None
    warm_started = False
    # the controller-rendered dir wins over the spec knob
    ckpt_dir = env.get(ENV_CHECKPOINT_DIR, "") or cfg.checkpoint.directory
    if cfg.checkpoint.enabled and ckpt_dir:
        from kubeflow_tpu_torch.checkpointing import CheckpointManager

        ckpt_mgr = CheckpointManager(
            ckpt_dir,
            keep=cfg.checkpoint.keep,
            async_save=cfg.checkpoint.async_save,
            keep_every=cfg.checkpoint.keep_every,
            max_in_flight=cfg.checkpoint.max_in_flight,
        )
    if restore and ckpt_dir:
        # restore is independent of SAVE enablement: a restarted job with
        # checkpoint.enabled since flipped off must still resume from the
        # committed steps on disk, not silently retrain from step 0
        from kubeflow_tpu_torch.checkpointing import (
            latest_committed_step,
            restore_latest,
        )

        if latest_committed_step(ckpt_dir) is not None:
            state = trainer.init_state()
            t_restore = time.monotonic()
            state = (ckpt_mgr.restore(state) if ckpt_mgr is not None
                     else restore_latest(ckpt_dir, state))
            restore_s = time.monotonic() - t_restore
            restored_step = state.step
            log.info("resumed from step %d in %.3f s", restored_step, restore_s)
    if state is None and cfg.checkpoint.warm_start_dir:
        # parent-checkpoint warm start: params only, step and optimizer
        # state fresh; never taken over a real resume above
        from kubeflow_tpu_torch.checkpointing import (
            latest_committed_step,
            restore_subtree,
        )
        from kubeflow_tpu_torch.training.checkpoint import (
            load_params_tree,
            params_tree,
        )

        parent = cfg.checkpoint.warm_start_dir
        if latest_committed_step(parent) is not None:
            state = trainer.init_state()
            load_params_tree(state.model,
                             restore_subtree(parent, params_tree(state.model)))
            warm_started = True
            log.info("warm-started params from %s", parent)
        else:
            log.warning("warm_start_dir %s has no committed checkpoint; "
                        "starting from scratch", parent)

    total = steps_override if steps_override is not None else cfg.steps
    if restored_step >= total:
        # the checkpoint already covers the budget: report complete,
        # train nothing
        if ckpt_mgr is not None:
            ckpt_mgr.close()
        return {
            "final_step": restored_step,
            "loss": None,
            "items_per_sec": 0.0,
            "already_complete": True,
            "preempted": False,
            "losses": [],
        }
    stop_event = stop_event if stop_event is not None else threading.Event()
    restore_sigterm = _install_preempt_handler(stop_event)
    fit_ok = False
    try:
        metrics = trainer.fit(steps=total - restored_step, state=state,
                              checkpoint_manager=ckpt_mgr,
                              stop_event=stop_event, log_every=log_every)
        preempted = trainer._stop_reason == "preempted"
        final = trainer._final_state
        # the state's own step, not the last LOGGED step
        final_step = final.step if final is not None else restored_step
        if ckpt_mgr is not None and final is not None:
            # the final save, and on a preemption the save of the step in
            # flight (one process: every preempted run saves it)
            ckpt_mgr.save(final_step, final, force=True)
        fit_ok = True
    finally:
        # the manager owns a NON-daemon writer thread: every exit must
        # join it. The SIGTERM handler stays installed until close() has
        # drained the writer (a notice landing during the final commit is
        # absorbed, not a kill mid-write), and is restored even when
        # close() raises (a failed async write re-raises there)
        try:
            if ckpt_mgr is not None:
                if fit_ok:
                    ckpt_mgr.close()
                else:
                    try:
                        ckpt_mgr.close()
                    except Exception as e:  # noqa: BLE001 - don't mask fit's error
                        log.warning("checkpoint close failed during unwind: %s", e)
        finally:
            restore_sigterm()
    result = {
        "final_step": final_step,
        "loss": metrics.loss if metrics is not None else None,
        # steady state: fit fences the first step out of its windows
        "items_per_sec": metrics.items_per_sec if metrics is not None else 0.0,
        "already_complete": False,
        "preempted": preempted,
        "losses": list(trainer.losses),
        "world_size": trainer.world,
        "grad_allreduces": trainer.grad_allreduces,
    }
    if trainer.fsdp is not None:
        result["fsdp_collectives"] = dict(trainer.fsdp.counts)
    if trainer.tensor is not None:
        result["tensor_collectives"] = dict(trainer.tensor.counts)
    if warm_started:
        result["warm_started"] = True
    if restore_s is not None:
        result["restore_s"] = restore_s
    if metrics is not None:
        result["step_time_s"] = metrics.step_time_s
        for key in ("compile_s", "mfu", "goodput"):
            if key in metrics.aux:
                result[key] = metrics.aux[key]
        if "eval_top1" in metrics.aux:
            result["eval_top1"] = metrics.aux["eval_top1"]
            result["eval_loss"] = metrics.aux["eval_loss"]
            target = cfg.data.target_accuracy
            result["target_reached"] = bool(
                target and metrics.aux["eval_top1"] >= target)
    if rank() == 0:
        log.info("training result: final_step=%d loss=%s items/s=%.1f "
                 "preempted=%s world=%d", final_step, result["loss"],
                 result["items_per_sec"], preempted, trainer.world)
    return result
