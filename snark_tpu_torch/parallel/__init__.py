"""Proving across many proofs: batched proving under one key (`BatchProver`).

The port's counterpart of the JAX package's `parallel/` so far holds its
batched prover alone; the distributed MSM, NTT and prover follow.
"""

from .batch import BatchProver, BatchRun

__all__ = ["BatchProver", "BatchRun"]
