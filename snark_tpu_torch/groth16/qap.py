"""R1CS -> QAP witness map: the padded-CSR matvec over K4.

Counterpart of the JAX package's `groth16/qap.py` (`PaddedCsr`,
`WitnessMapPlan.matvec`, `domain_size_for`). The evaluation domain is
num_constraints + num_instance rounded up to a power of two; the A side
gets one input-consistency row per instance variable (libsnark reduction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.limbs import FR, Field, pack16_to_u32, u32_tensor
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
