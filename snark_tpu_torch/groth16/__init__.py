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

__all__ = ["Groth16", "PreparedVerifyingKey", "Proof", "ProvingKey", "VerifyingKey",
           "assemble_proof", "synthesize_matrices", "synthesize_witness"]
