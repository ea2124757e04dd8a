from .groth16 import (
    Groth16,
    Proof,
    ProvingKey,
    VerifyingKey,
    assemble_proof,
)

__all__ = ["Groth16", "Proof", "ProvingKey", "VerifyingKey", "assemble_proof"]
