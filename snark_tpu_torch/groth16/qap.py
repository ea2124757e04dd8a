"""R1CS -> QAP: the host instance map and the witness map on K3 and K4.

Counterpart of the JAX package's `groth16/qap.py` (`domain_size_for`,
`batch_inverse`, `lagrange_coeffs_at`, `evaluate_variable_polys_at_tau`,
`PaddedCsr`, `PaddedCsr.from_coo`, `WitnessMapPlan`). The evaluation domain
is num_constraints + num_instance rounded up to a power of two; the A side
gets one input-consistency row per instance variable (libsnark reduction).
The instance map (Lagrange coefficients and u, v, w at τ) is exact host
work on Python ints, as in the reference (the setup runs its device
counterpart, `qap_device.py`). `matvec` is the padded-CSR product on K4;
`WitnessMapPlan` is the reference's legacy witness map, whose
`h_from_evals` runs on the legacy `NttPlan` (`ops/ntt_u32.py`, K3 and K4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import field_impl, get_compute_field
from ..fields.host import Fp
from ..fields.limbs import FR, Field, field_of, pack16_to_u32, split_u32_to16, u32_tensor
from ..fields.params import FieldParams
from ..ops.ntt import field_ew
from ..ops.ntt_u32 import get_ntt_plan


def domain_size_for(num_constraints: int, num_instance: int) -> int:
    n = num_constraints + num_instance
    return 1 << (n - 1).bit_length()


def batch_inverse(f: Fp, xs: list[int]) -> list[int]:
    """Montgomery's batch inversion: 3n products and one inversion."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % f.p
    inv_all = f.inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % f.p
        inv_all = inv_all * xs[i] % f.p
    return out


def lagrange_coeffs_at(params: FieldParams, n: int, tau: int) -> list[int]:
    """L_j(τ) for the radix-2 domain H of size n, j = 0..n − 1:
    L_j(x) = (Z(x)/n)·ω^j/(x − ω^j), or the indicator of j where τ = ω^j."""
    p = params.modulus
    omega = params.root_of_unity(n)
    pows = [1] * n
    for j in range(1, n):
        pows[j] = pows[j - 1] * omega % p
    diffs = [(tau - w) % p for w in pows]
    if any(d == 0 for d in diffs):
        return [1 if d == 0 else 0 for d in diffs]
    zn = (pow(tau, n, p) - 1) * pow(n, -1, p) % p
    inv_diffs = batch_inverse(Fp(params), diffs)
    return [zn * w % p * inv_d % p for w, inv_d in zip(pows, inv_diffs)]


def evaluate_variable_polys_at_tau(params: FieldParams, matrices: list, num_constraints: int,
                                   num_instance: int, num_variables: int, tau: int):
    """-> (u_i(τ), v_i(τ), w_i(τ) for every variable, Z_H(τ)); matrices
    [A, B, C] as lists of rows of (coefficient, column). u includes the
    input-consistency rows A[num_constraints + i][i] = 1."""
    p = params.modulus
    n = domain_size_for(num_constraints, num_instance)
    lag = lagrange_coeffs_at(params, n, tau)
    out = [[0] * num_variables for _ in range(3)]
    for j in range(num_constraints):
        lj = lag[j]
        for acc, mat in zip(out, matrices):
            for coeff, col in mat[j]:
                acc[col] = (acc[col] + coeff * lj) % p
    u, v, w = out
    for i in range(num_instance):
        u[i] = (u[i] + lag[num_constraints + i]) % p
    return u, v, w, (pow(tau, n, p) - 1) % p


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


class WitnessMapPlan:
    """The reference's legacy witness map (`snark_tpu/groth16/qap.py:187-248`)
    for one scalar field and domain size, in the legacy API's layout
    ((rows, L16) Montgomery 16-bit limbs, or f32 digits): `matvec` is
    `matvec` above on K4, `h_from_evals` the h pipeline on the legacy
    `NttPlan` (K3 `ntt_pass` launches through `ntt_rows`, K4)."""

    def __init__(self, params: FieldParams, domain_n: int, device="cuda"):
        self.params = params
        self.n = domain_n
        self.df = get_compute_field(params, device, field_impl())
        self.field = field_of(params)
        self.ntt = get_ntt_plan(params, domain_n, device=device)
        p = params.modulus
        z_coset = (pow(params.generator, domain_n, p) - 1) % p  # Z_H on g·H
        self.z_coset_inv = self.field.const(pow(z_coset, -1, p), device)

    def matvec(self, mat: PaddedCsr, z_mont: torch.Tensor) -> torch.Tensor:
        """The port's `PaddedCsr` (its coefficients in the kernels' words)
        times z (M, L16) Montgomery -> (rows, L16)."""
        df = self.df
        return df.from_words(matvec(mat, df.to_words(z_mont).contiguous(), self.field))

    def h_from_evals(self, a_evals, b_evals, c_evals) -> torch.Tensor:
        """Domain evaluations (n, L16) Montgomery of A·z, B·z, C·z -> the
        coefficients of h = (A·B − C)/Z_H (n, L16), natural order,
        Montgomery form; the last is structurally zero. Each input: the
        inverse transform, the coset scale and the forward transform
        (arkworks' coset_fft); then (a·b − c)/Z_H(g) (one K4 "hadamard"
        launch) and the inverse coset transform."""
        df, ntt = self.df, self.ntt

        def on_coset(x):
            return ntt.coset_fft_words(ntt.ifft_words(df.to_words(x).contiguous()))

        h_ev = field_ew("hadamard", on_coset(a_evals), on_coset(b_evals), on_coset(c_evals),
                        self.z_coset_inv, field=self.field)
        return df.from_words(ntt.coset_ifft_words(h_ev))
