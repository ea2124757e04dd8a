"""UniversalSetupSNARK exemplar over the port's Groth16.

The port's counterpart of the JAX package's `snark/universal.py`. arkworks
defines the universal-setup trait surface (snark/src/lib.rs:107-133) but
ships no implementation (Marlin et al. live in external repos). This
adapter exercises the full contract — bounded public parameters, `index`
with `NeedLargerBound` — over the Groth16 backend: the "universal"
parameters fix a size bound and a seed, and indexing derives the
circuit-specific keys deterministically from them.

NOTE: this is a contract exemplar, not a trustless universal SNARK —
Groth16 keys are circuit-specific by construction. Real universal backends
(Marlin/Plonk-style) slot into the same API.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..fields.host import Fp
from ..fields.params import CurveParams
from ..groth16.groth16 import Groth16
from ..relations import SynthesisMode, new_ref
from .api import NeedLargerBound, UniversalSetupSNARK


@dataclass(frozen=True)
class ComputationBound:
    """Max supported constraint count (the `ComputationBound` assoc. type)."""

    max_constraints: int = 1 << 10


@dataclass(frozen=True)
class PublicParameters:
    bound: ComputationBound
    seed: int


class UniversalGroth16(UniversalSetupSNARK):
    """Groth16 behind the universal-setup lifecycle, on `device` (CUDA
    unless the caller names the CPU)."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        self._g16 = Groth16(curve, device=device)

    # --- universal lifecycle -------------------------------------------
    def universal_setup(self, compute_bound: ComputationBound, rng: random.Random):
        return PublicParameters(bound=compute_bound, seed=rng.getrandbits(128))

    def index(self, pp: PublicParameters, circuit, rng=None):
        """-> (pk, vk); raises NeedLargerBound(bound) if the circuit exceeds
        the parameters' capacity (UniversalSetupIndexError::NeedLargerBound,
        snark/src/lib.rs:97-103), before any setup work."""
        cs = new_ref(Fp(self.curve.fr))
        cs.set_mode(SynthesisMode.setup())
        circuit.generate_constraints(cs)
        nc = cs.num_constraints()
        if nc > pp.bound.max_constraints:
            raise NeedLargerBound(ComputationBound(max_constraints=1 << (nc - 1).bit_length()))
        return self._g16.circuit_specific_setup(circuit, random.Random(pp.seed))

    # --- SNARK surface (delegated) -------------------------------------
    def circuit_specific_setup(self, circuit, rng):
        return self._g16.circuit_specific_setup(circuit, rng)

    def prove(self, circuit_pk, circuit, rng=None, **kw):
        return self._g16.prove(circuit_pk, circuit, rng=rng, **kw)

    def process_vk(self, circuit_vk):
        return self._g16.process_vk(circuit_vk)

    def verify_with_processed_vk(self, pvk, public_input, proof):
        return self._g16.verify_with_processed_vk(pvk, public_input, proof)
