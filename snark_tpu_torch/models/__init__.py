"""Example circuits — the framework's "model zoo" (the port's own copy of
the JAX package's `models/`).

Includes the reference's golden test fixtures (Circuit1/Circuit2, transcribed
as data from relations/src/gr1cs/tests/) and the benchmark circuits from
BASELINE.json configs (multiplication chains at 2^10..2^24 constraints).
"""

from .circuits import (
    Circuit1,
    Circuit2,
    DummyCircuit,
    MulChainCircuit,
    RandomLcCircuit,
)

__all__ = [
    "Circuit1",
    "Circuit2",
    "DummyCircuit",
    "MulChainCircuit",
    "RandomLcCircuit",
]
