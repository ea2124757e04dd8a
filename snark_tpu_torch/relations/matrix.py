"""Sparse matrix utilities (relations/src/utils/matrix.rs:4-36) plus the
device-handoff CSR codec that the reference does not need (its consumers are
in-process Rust; ours are device tensors).

The port's own copy of the JAX package's `relations/matrix.py`.
"""

from __future__ import annotations

import numpy as np

# Matrix = list of rows; row = list of (coeff, col_index) — same shape as the
# reference `Matrix<F> = Vec<Vec<(F, usize)>>`.
Matrix = list


def transpose(matrix, num_cols: int):
    """Transpose a sparse row-list matrix (matrix.rs:8-23)."""
    out = [[] for _ in range(num_cols)]
    for r, row in enumerate(matrix):
        for coeff, c in row:
            out[c].append((coeff, r))
    return out


def mat_vec_mul(matrix, vector, p: int):
    """Sparse matrix--dense vector product over F_p (matrix.rs:26-36)."""
    return [
        sum(coeff * vector[c] for coeff, c in row) % p if row else 0
        for row in matrix
    ]


class CsrMatrix:
    """Device-ready CSR: row_ptr / col_idx / coeff ids + interned value table.

    This is the host->device boundary object (SURVEY.md §3.1: "the boundary
    sits exactly at to_matrices()"). Coefficient values are carried as an
    interner-id column plus a dense (num_distinct, num_limbs) limb table so
    the device never sees bignums outside limb form.
    """

    __slots__ = (
        "num_rows",
        "num_cols",
        "row_ptr",
        "col_idx",
        "coeff_ids",
        "field",
        "interner",
    )

    def __init__(
        self, num_rows, num_cols, row_ptr, col_idx, coeff_ids, field, interner=None
    ):
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.row_ptr = row_ptr  # (num_rows+1,) int64
        self.col_idx = col_idx  # (nnz,) int32
        self.coeff_ids = coeff_ids  # (nnz,) int32
        self.field = field
        self.interner = interner  # FieldInterner carrying coeff_ids' values

    @classmethod
    def from_rows(cls, rows, num_cols: int, field, interner=None):
        nnz = sum(len(r) for r in rows)
        row_ptr = np.zeros(len(rows) + 1, dtype=np.int64)
        col_idx = np.zeros(nnz, dtype=np.int32)
        coeff_ids = np.zeros(nnz, dtype=np.int32)
        from .field_interner import FieldInterner

        interner = interner or FieldInterner(field)
        k = 0
        for i, row in enumerate(rows):
            for coeff, c in row:
                col_idx[k] = c
                coeff_ids[k] = interner.get_or_intern(coeff % field.p)
                k += 1
            row_ptr[i + 1] = k
        return cls(len(rows), num_cols, row_ptr, col_idx, coeff_ids, field, interner)

    def mat_vec_mul_ints(self, interner, vector: list[int]) -> list[int]:
        """Host-side reference product (for tests)."""
        p = self.field.p
        vals = (interner or self.interner).values
        out = []
        for i in range(self.num_rows):
            s, e = self.row_ptr[i], self.row_ptr[i + 1]
            acc = 0
            for k in range(s, e):
                acc += vals[self.coeff_ids[k]] * vector[self.col_idx[k]]
            out.append(acc % p)
        return out
