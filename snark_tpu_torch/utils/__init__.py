"""Cross-cutting utilities: phase timers, reproducible RNG (the ark-std
surface — SURVEY.md §2.3 "RNG plumbing, timer/profiling macros").

The port's own copy of the JAX package's `utils/__init__.py`.
"""

from .timing import end_timer, start_timer, timed
from .rng import test_rng

__all__ = ["end_timer", "start_timer", "test_rng", "timed"]
