"""Montgomery arithmetic on float32 base-256 digit planes, in plain PyTorch
ops: the port's `PlaneFieldV3`.

The counterpart of the JAX package's `snark_tpu/ops/pallas_field_v3.py`
(`_sweep`, `_sweep_n`, `sweep3`, `PlaneFieldV3`, `get_plane_field_v3`),
with the same constants and the same steps on the same layout: an element
is one column of an (R8, N) float32 plane, base-256 digits on the rows
(little-endian), lanes on the columns, R8 = 2·num_limbs + extra_digits,
Montgomery R = 256^R8.

Lazy digits: a digit may exceed 255 (or be negative) as long as every
partial sum stays an integer below 2^24, which float32 holds exactly; a
sweep (`floor(z · 2^-8)`, a scaling by a power of two, then floor) is exact
on such integers. So no step of a product rounds, and the digits equal the
reference's digit for digit whatever order a device sums the terms in. The
one float sum that is not exact, the carry out of the low half in
`reduce`, has a total error below 0.05 before it is rounded to the integer
it approximates (the reference's module docstring).

The reference writes its products into a scratch ref (`t_ref[...] +=`)
inside a Pallas kernel. Here `mul_acc` and `conv_into` return the
accumulated tensor, and `reduce` takes the (2R8, N) product and returns
(R8, N). `reduce` has both of the reference's backends for the
convolutions by N' and p: scalar multiply-adds (`m_np` and `m_p` None),
which `scripts/bench_vpu_peak.py` runs, and products by the band matrices
`M_NP` (R8, R8) and `M_P` (2R8, R8) with bf16 factors and float32 sums,
which variant A of `scripts/bench_reduce_parts.py` runs. The band products
round their inputs to bf16 and multiply in float32 (`torch.mm` of two bf16
tensors would round the sums to bf16 too): exact while every input digit
lies in [-256, 256], which `band_mm` asserts, and every sum below 2^24
(below 2^22 here). Both backends give the same digits. Of the
reference's other members only those the port calls are here: not `add`,
`sub`, the canonicalisation (`_strict`, `cond_sub_p`, `to_canonical`) or
the columns only they take (`P4_COL`, `KP_COLS`, `RMP_COL`,
`ONE_MONT_COL`, `R2_COL`). The constants are numpy arrays, as in the
reference; the methods take them, or tensors, wherever a column is an
argument.

These are the plain versions of K15 (`ops/vpu_peak.py`), K16 and K17
(`ops/mul_parts.py`); no kernel runs here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import FieldParams

F32 = torch.float32
INV256 = 1.0 / 256.0

# rows of s_lo that contribute >= 2^-73 to the carry (see `reduce`)
_CARRY_ROWS = 12


def _col(x, like: torch.Tensor) -> torch.Tensor:
    """A constant column (numpy or tensor) as a float32 tensor on like's
    device."""
    return torch.as_tensor(x, dtype=F32, device=like.device)


def band_mm(m, x: torch.Tensor) -> torch.Tensor:
    """m @ x as the reference's bf16 matmul with float32 sums
    (`jnp.dot(m, x.astype(bf16), preferred_element_type=f32)`): both factors
    rounded to bf16, the product taken in float32. Exact for integer
    digits in [-256, 256] and sums below 2^24; a digit outside that range
    would round, so it fails here instead."""
    if float(x.abs().max()) > 256:
        raise AssertionError("band product: a digit outside [-256, 256] is not bf16-exact")
    m = _col(m, x).to(torch.bfloat16).float()
    return m @ x.to(torch.bfloat16).float()


def _sweep(z: torch.Tensor) -> torch.Tensor:
    """One base-256 carry sweep between rows (sign-correct); the carry out
    of the top row is dropped."""
    c = torch.floor(z * INV256)
    r = z - 256.0 * c
    return torch.cat([r[:1], r[1:] + c[:-1]], dim=0)


def _sweep_n(z: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        z = _sweep(z)
    return z


def sweep3(z: torch.Tensor) -> torch.Tensor:
    """Digits <= 2^23 lazy -> digits in [0, 256] (or (-256, 256) if
    signed): 2^23 -> 255 + 2^15 -> 255 + 129 -> 255 + 1. The carry out of
    the top row is dropped."""
    return _sweep_n(z, 3)


class PlaneFieldV3:
    """Per-field constants and plain plane ops (see the module docstring).

    `extra_digits` widens R beyond the minimal 2L digits: with extra = 2,
    p/R <= 2^-17, so a product of two lazily bounded inputs lands in
    [0, ~2p] and needs no conditional subtraction.
    """

    def __init__(self, params: FieldParams, extra_digits: int = 0):
        self.params = params
        self.L = params.num_limbs
        self.extra = extra_digits
        R8 = self.R8 = 2 * self.L + extra_digits
        p = params.modulus
        self.r_eff = 1 << (8 * R8)
        self.n_prime_eff = (-pow(p, -1, self.r_eff)) % self.r_eff

        def digits_col(v: int, rows: int) -> np.ndarray:
            return np.array(
                [(v >> (8 * i)) & 0xFF for i in range(rows)], dtype=np.float32
            )[:, None]

        def band(v: int, rows: int, cols: int) -> np.ndarray:
            """Banded lower-triangular conv matrix: M[k, i] = digit_{k-i}(v)."""
            d = [(v >> (8 * i)) & 0xFF for i in range(rows)]
            m = np.zeros((rows, cols), dtype=np.float32)
            for k in range(rows):
                for i in range(cols):
                    if 0 <= k - i < rows:
                        m[k, i] = d[k - i]
            return m

        self.P_COL = digits_col(p, R8)
        self.P2_COL = digits_col(2 * p, R8)
        # the band matrices of the band-product backend
        self.M_NP = band(self.n_prime_eff, R8, R8)  # x -> x·N' mod R
        self.M_P = band(p, 2 * R8, R8)  # x -> x·P
        # the constant multiplies of the reduction, as digit sequences
        self.NP_DIGITS = self.digits_list(self.n_prime_eff)
        self.P_DIGITS = self.digits_list(p)
        # carry extraction: 2^{8(i-R8)} for the top _CARRY_ROWS rows
        sc = np.zeros((R8, 1), dtype=np.float32)
        for i in range(R8 - _CARRY_ROWS, R8):
            sc[i, 0] = 2.0 ** (8 * (i - R8))
        self.CARRY_SCALE = sc

    # ------------------------------------------------------------------
    # plane ops ((R8, N) float32 tensors)
    # ------------------------------------------------------------------
    def digits_list(self, v: int, rows: int | None = None) -> tuple:
        """Base-256 digits of v as Python floats."""
        rows = rows or self.R8
        return tuple(float((v >> (8 * i)) & 0xFF) for i in range(rows))

    @staticmethod
    def conv_into(digits, x: torch.Tensor, rows_out: int, scale: float = 1.0) -> torch.Tensor:
        """scale·conv(digits, x), rows truncated at rows_out:
        out[k] = Σ_i digits[i]·x[k-i], summed over increasing i, zero
        digits skipped. Exact while every partial sum stays below 2^24."""
        rx = x.shape[0]
        out = torch.zeros((rows_out, x.shape[1]), dtype=F32, device=x.device)
        for i, d in enumerate(digits):
            if d == 0.0 or i >= rows_out:
                continue
            hi = min(rows_out - i, rx)
            out[i : i + hi] += (d * scale) * x[:hi]
        return out

    def mul_acc(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """The (2R8, N) lazy digit product A·B: row i of A times B, added at
        row offset i, over increasing i."""
        R8 = self.R8
        t = torch.zeros((2 * R8, A.shape[1]), dtype=F32, device=A.device)
        for i in range(R8):
            t[i : i + R8] += A[i : i + 1] * B
        return t

    def reduce(self, t: torch.Tensor, carry_scale, plus_p=None, m_np=None, m_p=None) -> torch.Tensor:
        """Montgomery-reduce a lazy (2R8, N) product t -> (R8, N), value
        t·R^-1 (+ plus_p, a k·p column). Signed digits (|d| <= 2^22) are fine; pass
        `plus_p` to keep values nonnegative. Output digits in
        [-1, 256] ([0, 256] for nonnegative inputs). With `m_np` and `m_p`
        (the band matrices `M_NP`, `M_P`) the constant multiplies are band
        products (`band_mm`), else scalar multiply-adds; the digits are the
        same."""
        R8 = self.R8
        tlo = sweep3(t[:R8])  # mod-R truncation: the top carry is dropped
        if m_np is None:
            m = sweep3(self.conv_into(self.NP_DIGITS, tlo, R8))  # ≡ t·N' (mod R)
            mp = self.conv_into(self.P_DIGITS, m, 2 * R8)
        else:
            m = sweep3(band_mm(m_np, tlo))
            mp = band_mm(m_p, m)
        s = t + mp  # low half's value ≡ 0 mod R
        carry = torch.round(torch.sum(s[:R8] * _col(carry_scale, s), dim=0, keepdim=True))
        hi = s[R8:]
        out = torch.cat([hi[:1] + carry, hi[1:]], dim=0)
        if plus_p is not None:
            out = out + _col(plus_p, out)
        return sweep3(out)

    def mont_mul(
        self, A: torch.Tensor, B: torch.Tensor, carry_scale, plus_p=None, m_np=None, m_p=None
    ) -> torch.Tensor:
        """Full Montgomery product on planes: reduce(mul_acc(A, B))."""
        return self.reduce(self.mul_acc(A, B), carry_scale, plus_p, m_np, m_p)

    # ------------------------------------------------------------------
    # host codecs
    # ------------------------------------------------------------------
    def pack_np(self, vals, mont: bool = True) -> np.ndarray:
        """Python ints -> (R8, N) float32 digit planes (Montgomery form by
        default)."""
        p = self.params.modulus
        r = self.r_eff
        R8 = self.R8
        buf = bytearray(R8 * len(vals))
        for j, v in enumerate(vals):
            v = v % p
            if mont:
                v = v * r % p
            buf[j * R8 : (j + 1) * R8] = v.to_bytes(R8, "little")
        arr = np.frombuffer(bytes(buf), dtype=np.uint8).reshape(len(vals), R8)
        return arr.T.astype(np.float32)

    def unpack_np(self, planes, mont: bool = True) -> list[int]:
        """(R8, N) lazy or canonical digit planes (numpy, or a tensor on any
        device) -> Python ints mod p."""
        if isinstance(planes, torch.Tensor):
            planes = planes.detach().cpu().numpy()
        p = self.params.modulus
        d = np.asarray(planes, dtype=np.int64)
        rinv = pow(self.r_eff, -1, p)
        out = []
        for j in range(d.shape[1]):
            v = int(sum(int(x) << (8 * i) for i, x in enumerate(d[:, j])))
            if mont:
                v = v * rinv
            out.append(v % p)
        return out


@functools.lru_cache(maxsize=None)
def get_plane_field_v3(params: FieldParams, extra_digits: int = 0) -> PlaneFieldV3:
    return PlaneFieldV3(params, extra_digits)
