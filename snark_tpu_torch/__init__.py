"""BN254 Groth16 in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package `snark_tpu`, which stays the reference. Entry
points take `device=` and default to `"cuda"`; `device="cpu"` runs every
kernel's plain PyTorch version instead. See `groth16.Groth16`.
"""
