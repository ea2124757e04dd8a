from .groth16 import (
    Groth16,
    PreparedVerifyingKey,
    Proof,
    ProvingKey,
    VerifyingKey,
    assemble_proof,
    synthesize_matrices,
    synthesize_witness,
)
from .pairing import Pairing, get_pairing
from .qap import (
    PaddedCsr,
    WitnessMapPlan,
    domain_size_for,
    evaluate_variable_polys_at_tau,
    lagrange_coeffs_at,
)

__all__ = ["Groth16", "PaddedCsr", "Pairing", "PreparedVerifyingKey", "Proof", "ProvingKey",
           "VerifyingKey", "WitnessMapPlan", "assemble_proof", "domain_size_for",
           "evaluate_variable_polys_at_tau", "get_pairing", "lagrange_coeffs_at",
           "synthesize_matrices", "synthesize_witness"]
