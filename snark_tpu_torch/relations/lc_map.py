"""Columnar CSR store for all linear combinations in a constraint system.

The port's own copy of the JAX package's `relations/lc_map.py`.

Mirrors the reference LcMap (relations/src/gr1cs/lc_map.rs:50-56): flattened
parallel arrays `vars`, `coeff_ids` plus an `offsets` array of length
num_lcs + 1, with the invariants documented at lc_map.rs:14-49. We keep the
hot append path as plain Python lists (amortized O(1) appends) and expose
zero-copy NumPy views for the vectorized passes (instance outlining's
variable rewrite, device handoff), which replace the reference's custom
rayon producer (lc_map.rs:313-469) with NumPy data parallelism.
"""

from __future__ import annotations

import numpy as np

from .field_interner import FieldInterner


class LcMap:
    __slots__ = ("vars", "coeff_ids", "offsets")

    def __init__(self):
        self.vars: list[int] = []
        self.coeff_ids: list[int] = []
        self.offsets: list[int] = [0]

    @classmethod
    def with_capacity(cls, num_lcs: int, total_size: int) -> "LcMap":
        return cls()  # python lists grow amortized; capacity hint unused

    def num_lcs(self) -> int:
        return len(self.offsets) - 1

    def total_lc_size(self) -> int:
        return len(self.vars)

    def push(self, lc, interner: FieldInterner) -> None:
        """Append one LC; terms must already be sorted/compact."""
        vs, cs = self.vars, self.coeff_ids
        intern = interner.get_or_intern
        for v, c in lc.terms:
            vs.append(v)
            cs.append(intern(c))
        self.offsets.append(len(vs))

    def push_interned(self, vars_: list[int], coeff_ids: list[int]) -> None:
        self.vars.extend(vars_)
        self.coeff_ids.extend(coeff_ids)
        self.offsets.append(len(self.vars))

    def get(self, i: int) -> tuple[list[int], list[int]]:
        """(vars, coeff_ids) slice for LC i."""
        s, e = self.offsets[i], self.offsets[i + 1]
        return self.vars[s:e], self.coeff_ids[s:e]

    def get_len(self, i: int) -> int:
        return self.offsets[i + 1] - self.offsets[i]

    def iter_lcs(self):
        offs = self.offsets
        for i in range(len(offs) - 1):
            s, e = offs[i], offs[i + 1]
            yield self.vars[s:e], self.coeff_ids[s:e]

    # --- vectorized views -------------------------------------------------
    def vars_array(self) -> np.ndarray:
        return np.array(self.vars, dtype=np.uint64)

    def coeff_ids_array(self) -> np.ndarray:
        return np.array(self.coeff_ids, dtype=np.uint32)

    def offsets_array(self) -> np.ndarray:
        return np.array(self.offsets, dtype=np.int64)

    def set_vars_from_array(self, arr: np.ndarray) -> None:
        """Write back a rewritten variable column (e.g. after outlining)."""
        self.vars = [int(x) for x in arr]
