"""Training-run entry point (port of kubeflow_tpu/runtime/train_run.py):
config → Trainer → fit → the result dict.

`run_training` returns the JAX `_run_training_armed` keys (`final_step`,
`loss`, `items_per_sec`, `already_complete`, `preempted`, and
`compile_s` when the first step was fenced), plus the last window's
`step_time_s`, `mfu` (on a listed card) and `goodput`, and `losses`:
every step's (step, loss), read on the host at the first-step fence and
at each log window (one sync a window).
SIGTERM sets the stop event (from the main thread), so a preempted run
finishes its step in flight and exits cleanly. Not ported yet (ROADMAP):
checkpoint save/restore and warm start (A12), the compile cache and
chaos injection (A14): the port's config has no `checkpoint` field.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.utils.device import DeviceLike


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


def run_training(cfg: TrainingConfig, steps_override: Optional[int] = None,
                 stop_event: Optional[threading.Event] = None,
                 device: DeviceLike = None, log_every: int = 10) -> Dict[str, Any]:
    """Run one training job to its step budget (cfg.steps, or
    `steps_override`); returns the result metrics. `device` defaults to
    "cuda" and raises without CUDA unless "cpu" is asked for."""
    from kubeflow_tpu_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    total = steps_override if steps_override is not None else cfg.steps
    stop_event = stop_event if stop_event is not None else threading.Event()
    restore_sigterm = _install_preempt_handler(stop_event)
    try:
        metrics = trainer.fit(steps=total, stop_event=stop_event,
                              log_every=log_every)
    finally:
        restore_sigterm()
    final = trainer._final_state
    result = {
        "final_step": final.step if final is not None else 0,
        "loss": metrics.loss if metrics is not None else None,
        # steady state: fit fences the first step out of its windows
        "items_per_sec": metrics.items_per_sec if metrics is not None else 0.0,
        "already_complete": False,
        "preempted": trainer._stop_reason == "preempted",
        "losses": list(trainer.losses),
    }
    if metrics is not None:
        result["step_time_s"] = metrics.step_time_s
        for key in ("compile_s", "mfu", "goodput"):
            if key in metrics.aux:
                result[key] = metrics.aux[key]
    return result
