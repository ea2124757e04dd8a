"""Benchmark circuits, as witnesses and matrices.

The relations layer (synthesis) is not ported yet, so a circuit here
gives its full assignment and its constraint matrices directly, in the
order the JAX package's synthesis produces them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MulChainCircuit:
    """The a·b = c chain of the JAX package's `models/circuits.py`:
    x_0 = seed (instance), x_{i+1} = x_i · m_i with fixed multipliers
    m_i = (i·2654435761 + 12345) mod p; constraint i is x_i · m_i = x_{i+1}.

    Variables, in assignment order: ONE, seed (the instance part), then the
    witnesses m_0..m_{n-1}, x_1..x_n."""

    seed: int
    n: int

    num_instance = 2

    @property
    def num_variables(self) -> int:
        return self.num_instance + 2 * self.n

    def assignment(self, p: int) -> list[int]:
        """[1, seed, m_0..m_{n-1}, x_1..x_n] mod p."""
        x = self.seed % p
        mults, chain = [], []
        for i in range(self.n):
            m = (i * 2654435761 + 12345) % p
            mults.append(m)
            x = x * m % p
            chain.append(x)
        return [1, self.seed % p] + mults + chain

    def csr_columns(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Column of the single coefficient-1 entry of each constraint row
        in A, B and C, each (n, 1) int32: A_i = x_i (x_0 is variable 1),
        B_i = m_i, C_i = x_{i+1}."""
        n = self.n
        m_at = 2 + np.arange(n)
        x_at = 2 + n + np.arange(n)  # x_1..x_n
        a = np.concatenate([[1], x_at[:-1]])
        return tuple(v.astype(np.int32).reshape(n, 1) for v in (a, m_at, x_at))
