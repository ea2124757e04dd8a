"""The SNARK trait layer: prover/verifier lifecycle contracts.

The port's own copy of the JAX package's `snark/api.py`; it holds no tensors.

Mirrors arkworks snark/src/lib.rs:
  * `SNARK` (:22-81): associated types ProvingKey / VerifyingKey / Proof /
    ProcessedVerifyingKey / Error; circuit_specific_setup, prove, verify
    (default impl = process_vk ∘ verify_with_processed_vk), process_vk,
    verify_with_processed_vk.
  * `CircuitSpecificSetupSNARK` (:84-93): setup defaulting to
    circuit_specific_setup.
  * `UniversalSetupSNARK` (:107-133): universal_setup + index returning
    `UniversalSetupIndexError::{NeedLargerBound, Other}`.

Python rendering: abstract base classes; associated types become class
attributes (type hints); `verify`'s default impl is provided concretely.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Generic, TypeVar

PK = TypeVar("PK")
VK = TypeVar("VK")
PVK = TypeVar("PVK")
Pf = TypeVar("Pf")


class SNARK(abc.ABC):
    """The basic functionality for a SNARK (snark/src/lib.rs:22-81)."""

    @abc.abstractmethod
    def circuit_specific_setup(self, circuit, rng):
        """(circuit, rng) -> (proving_key, verifying_key)."""

    @abc.abstractmethod
    def prove(self, circuit_pk, circuit, rng):
        """Generate a proof of satisfaction of `circuit`."""

    @abc.abstractmethod
    def process_vk(self, circuit_vk):
        """Preprocess `circuit_vk` for faster verification (:69-71)."""

    @abc.abstractmethod
    def verify_with_processed_vk(self, circuit_pvk, public_input, proof) -> bool:
        """Check `proof` against a processed vk (:76-80). `public_input`
        does NOT include the leading ONE — the vk encodes it (SURVEY §3.3)."""

    def verify(self, circuit_vk, public_input, proof) -> bool:
        """Default impl: process_vk then verify_with_processed_vk (:59-66)."""
        pvk = self.process_vk(circuit_vk)
        return self.verify_with_processed_vk(pvk, public_input, proof)


class CircuitSpecificSetupSNARK(SNARK):
    """A SNARK with (only) circuit-specific setup (:84-93)."""

    def setup(self, circuit, rng):
        return self.circuit_specific_setup(circuit, rng)


@dataclass
class NeedLargerBound(Exception):
    """The provided universal parameters were insufficient; carries the
    suggested larger bound (UniversalSetupIndexError::NeedLargerBound,
    :97-103)."""

    bound: Any


class UniversalSetupIndexError(Exception):
    """UniversalSetupIndexError::Other."""


class UniversalSetupSNARK(SNARK):
    """A SNARK with universal (circuit-independent) setup (:107-133)."""

    @abc.abstractmethod
    def universal_setup(self, compute_bound, rng):
        """bound -> public parameters."""

    @abc.abstractmethod
    def index(self, pp, circuit, rng):
        """(pp, circuit) -> (pk, vk); raises NeedLargerBound(bound) or
        UniversalSetupIndexError."""
