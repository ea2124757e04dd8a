"""Synthesis errors (mirrors ark-relations SynthesisError, utils/error.rs:5-21).

The port's own copy of the JAX package's `relations/error.py`.
"""

from __future__ import annotations


class SynthesisError(Exception):
    """Base class for errors during constraint synthesis."""


class MissingCS(SynthesisError):
    """During synthesis, we lacked knowledge of the constraint system."""


class AssignmentMissing(SynthesisError):
    """During synthesis, we didn't have the variable assignment."""


class DivisionByZero(SynthesisError):
    """During synthesis, we divided by zero."""


class Unsatisfiable(SynthesisError):
    """During synthesis, the constraint system was unsatisfiable."""


class PolynomialDegreeTooLarge(SynthesisError):
    """During synthesis, our polynomials ended up being too high of degree."""


class PredicateNotFound(SynthesisError):
    """During synthesis, the predicate was not registered."""


class ArityMismatch(SynthesisError):
    """During synthesis, the number of LCs did not match the predicate arity."""
