"""R1CS -> QAP witness map: the padded-CSR matvec over K4.

Counterpart of the JAX package's `groth16/qap.py` (`PaddedCsr`,
`PaddedCsr.from_coo`, `WitnessMapPlan.matvec`, `domain_size_for`). The
evaluation domain is
num_constraints + num_instance rounded up to a power of two; the A side
gets one input-consistency row per instance variable (libsnark reduction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.limbs import FR, Field, pack16_to_u32, split_u32_to16, u32_tensor
from ..ops.ntt import field_ew


def domain_size_for(num_constraints: int, num_instance: int) -> int:
    n = num_constraints + num_instance
    return 1 << (n - 1).bit_length()


@dataclass
class PaddedCsr:
    """Rows padded to one width; empty slots hold (column 0, coefficient 0)."""

    cols: torch.Tensor  # (rows, width) int64
    coeffs: torch.Tensor  # (rows, width, 8) int32, Montgomery R = 2^256 (Fr of either curve)
    num_rows: int

    @staticmethod
    def from_reference(cols: np.ndarray, coeffs16: np.ndarray, device) -> "PaddedCsr":
        """The reference's arrays: cols (rows, width) int32, coeffs
        (rows, width, 16) 16-bit limbs, Montgomery with R = 2^256 (16
        limbs for BN254 Fr and BLS12-381 Fr alike)."""
        coeffs = u32_tensor(pack16_to_u32(coeffs16), device)
        return PaddedCsr(
            torch.as_tensor(np.asarray(cols, np.int64), device=device),
            coeffs,
            int(cols.shape[0]),
        )

    @staticmethod
    def from_coo(coo, values: list[int], field: Field, num_rows: int, device) -> "PaddedCsr":
        """From one matrix of `ConstraintSystem.to_coo_arrays` (indptr, col, cid),
        vectorised: row i's entries fill its first slots in order, absent
        slots hold (column 0, coefficient 0), and coefficient id
        len(values) is the literal zero. The width is the longest row."""
        indptr, col, cid = coo
        lens = np.diff(indptr)
        width = max(1, int(lens.max()) if len(lens) else 1)
        row_of = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
        inner = np.arange(int(indptr[-1]), dtype=np.int64) - np.repeat(indptr[:-1], lens)
        flat = row_of * width + inner
        cols = np.zeros(num_rows * width, np.int64)
        cols[flat] = col
        ids = np.full(num_rows * width, len(values), np.int64)
        ids[flat] = cid
        table = field.encode(list(values) + [0])  # (V + 1, L) Montgomery
        coeffs = u32_tensor(table[ids].reshape(num_rows, width, field.limbs), device)
        return PaddedCsr(torch.as_tensor(cols.reshape(num_rows, width), device=device),
                         coeffs, num_rows)

    def row_block(self, lo: int, hi: int, device) -> "PaddedCsr":
        """Rows [lo, hi) on `device`: a rank's share of the matvec."""
        return PaddedCsr(self.cols[lo:hi].to(device), self.coeffs[lo:hi].to(device), hi - lo)

    def to_reference(self) -> tuple[np.ndarray, np.ndarray]:
        """-> the reference's arrays (the inverse of `from_reference`): cols
        (rows, width) int32 and coeffs (rows, width, 16) uint32, each u32
        word split into two 16-bit limbs."""
        return (self.cols.cpu().numpy().astype(np.int32),
                split_u32_to16(self.coeffs.cpu().numpy()))


def matvec(mat: PaddedCsr, z_mont: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """(rows, L) = mat · z over the scalar field: gather, K4 products, K4
    log-tree row sums."""
    rows, width = mat.cols.shape
    L = field.limbs
    zg = z_mont[mat.cols.reshape(-1)]
    x = field_ew("mul", mat.coeffs.reshape(-1, L), zg, field=field).reshape(rows, width, L)
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        h = x.shape[1] // 2
        s = field_ew(
            "add",
            x[:, :h].reshape(-1, L).contiguous(),
            x[:, h:].reshape(-1, L).contiguous(),
            field=field,
        )
        x = s.reshape(rows, h, L)
    return x[:, 0].contiguous()
