"""SNARK trait layer (the ark-snark surface, snark/src/lib.rs)."""

from .api import (
    SNARK,
    CircuitSpecificSetupSNARK,
    NeedLargerBound,
    UniversalSetupIndexError,
    UniversalSetupSNARK,
)
from . import serialize
from .universal import ComputationBound, PublicParameters, UniversalGroth16

__all__ = [
    "SNARK",
    "CircuitSpecificSetupSNARK",
    "NeedLargerBound",
    "UniversalSetupIndexError",
    "UniversalSetupSNARK",
    "serialize",
    "ComputationBound",
    "PublicParameters",
    "UniversalGroth16",
]
