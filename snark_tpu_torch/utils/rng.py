"""Reproducible RNG — the ark-std `test_rng` equivalent.

The port's own copy of the JAX package's `utils/rng.py`.

ark-std's test_rng is a fixed-seed deterministic generator used throughout
the reference's tests and benches (e.g. variable.rs:210, bench.rs). Ours is
a seeded `random.Random` with the same role: deterministic across runs,
explicitly NOT cryptographically secure (setup/prove in production must be
fed a CSPRNG; `secure_rng` wraps SystemRandom for that).
"""

from __future__ import annotations

import random

TEST_SEED = 0x5EED_CAFE


def test_rng(seed: int = TEST_SEED) -> random.Random:
    """Deterministic RNG for tests and benches."""
    return random.Random(seed)


def secure_rng() -> random.SystemRandom:
    """OS-entropy RNG for real key generation and proving randomness."""
    return random.SystemRandom()
