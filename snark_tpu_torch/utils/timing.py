"""Phase timers — the `start_timer!` / `end_timer!` equivalent.

The port's own copy of the JAX package's `utils/timing.py`, without its
printing: a timer measures, and its caller keeps what it measured
(`ConstraintSystem.finalize` keeps its inline and outline times in
`finalize_ms`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    label: str
    start: float = field(default_factory=time.perf_counter)
    elapsed: float | None = None


def start_timer(label: str) -> Timer:
    return Timer(label)


def end_timer(timer: Timer) -> float:
    """Seconds since the timer started; also kept in `timer.elapsed`."""
    timer.elapsed = time.perf_counter() - timer.start
    return timer.elapsed


@contextlib.contextmanager
def timed(label: str):
    t = start_timer(label)
    try:
        yield t
    finally:
        end_timer(t)
