"""Retry with backoff (copy of kubeflow_tpu/utils/retry.py
`backoff_retry`): the one primitive the checkpoint manager's transient
I/O policy rides on."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


def backoff_retry(
    fn: Callable[[], T],
    attempts: int = 3,
    delay_s: float = 1.0,
    multiplier: float = 1.0,
    max_delay_s: float = 60.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    jitter: float = 0.0,
    rng: Optional[random.Random] = None,
) -> T:
    """Call `fn` up to `attempts` times with (constant or exponential)
    backoff; the last failure propagates.

    `jitter` adds a uniform [0, jitter·delay) slice on top of each sleep
    so retrying peers (every host of a gang hitting the same flaky
    volume) decorrelate instead of re-colliding in lockstep; pass `rng`
    for a deterministic jitter stream in tests.
    """
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    if jitter < 0:
        raise ValueError("jitter must be >= 0")
    current = delay_s
    last: BaseException
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            last = e
            if i == attempts - 1:
                break
            if on_retry is not None:
                on_retry(i + 1, e)
            base = min(current, max_delay_s)
            if jitter:
                base += (rng or random).random() * jitter * base
            sleep(base)
            current *= multiplier
    raise last
