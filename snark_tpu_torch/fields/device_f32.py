"""Batched Montgomery arithmetic on float32 base-256 digits, in plain
PyTorch ops.

The counterpart of the JAX package's `fields/device_f32.py`
(`DeviceFieldF32`, `get_device_field_f32`), with the same layout and the
same steps: an element is (..., R8) float32 digits, R8 = 2·num_limbs,
little-endian, canonical (every digit below 256, the value below p), in
Montgomery form with R = 2^(16·num_limbs) for multiplicative work.

Exactness: digits stay below 2^9, digit products below 2^18 and every
accumulation below 2^23, so every intermediate is an integer below 2^24,
which float32 holds exactly; `floor(z · 2^-8)` of such an integer is exact
too (a scaling by a power of two, then floor). No step rounds, so the
order in which a device sums the terms does not matter: the digits equal
the reference's, digit for digit, on the CPU and on the card.

This is the `f32` line of `bench_field` and, under
SNARK_TPU_FIELD_IMPL=f32, the layout of the legacy device API; no kernel
runs here. `to_words` and `from_words` pack and unpack four digits to and
from the kernels' 32-bit words (R = 2^(16·num_limbs) is the kernels' R).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device import limbs16_decode
from .params import FieldParams

F32 = torch.float32
INV256 = 1.0 / 256.0


def _shift_digits(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift digits to higher significance by k (zero fill), last axis."""
    if k == 0:
        return x
    return torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)


def _sweep(z: torch.Tensor) -> torch.Tensor:
    """One base-256 carry sweep; floor handles negative digits too."""
    c = torch.floor(z * INV256)
    return (z - 256.0 * c) + _shift_digits(c, 1)


def _strict_normalize(z: torch.Tensor) -> torch.Tensor:
    """Digits below 2^23 in size -> exact canonical digits below 256: four
    sweeps bound every digit by 256, then a Kogge-Stone carry-lookahead on
    (generate, propagate) in 0-1 floats resolves the last ripple."""
    for _ in range(4):
        z = _sweep(z)
    R = z.shape[-1]
    G = (z >= 256.0).to(F32)
    P = (z == 255.0).to(F32)
    shift = 1
    while shift < R:
        G = torch.maximum(G, P * _shift_digits(G, shift))
        P = P * _shift_digits(P, shift)
        shift <<= 1
    z = z + _shift_digits(G, 1)
    return z - 256.0 * torch.floor(z * INV256)


def to_words(t: torch.Tensor) -> torch.Tensor:
    """(..., 4k) float32 base-256 digits (canonical, below 256) -> (..., k)
    int32 words of the kernels' format, digit 4j + i at bits 8i of word j.
    Exact."""
    if t.shape[-1] % 4:
        raise ValueError(f"digits not in fours: {tuple(t.shape)}")
    d = t.to(torch.int64).reshape(t.shape[:-1] + (-1, 4))
    w = d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16) | (d[..., 3] << 24)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> (..., 4k) float32 digits: the inverse of
    `to_words`."""
    d = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return d.reshape(w.shape[:-1] + (-1,)).to(F32)


class DeviceFieldF32:
    """Batched Montgomery arithmetic over one prime field, f32 digits.

    Ops take float32 digit tensors on any device and return tensors on
    that device; `const` and `array` build on the field's device, `cuda`
    unless the caller asks for another. The reference's `<op>_impl` names
    are the ops themselves (nothing is traced).
    """

    def __init__(self, params: FieldParams, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.R8 = 2 * params.num_limbs
        self.L = self.R8  # "limb" count of this representation
        p = params.modulus
        self.P_DIGITS = self._digits_np(p)
        self.NP_DIGITS = self._digits_np(params.n_prime)
        self._vals = {
            "r_minus_p": params.r - p,
            "p": p,
            "one_mont": params.r % p,
            "one_std": 1,
            "r2": params.r2,
        }
        self._consts: dict[torch.device, dict] = {}

    def _digits_np(self, v: int) -> np.ndarray:
        return np.array([(v >> (8 * i)) & 0xFF for i in range(self.R8)], dtype=np.float32)

    def _c(self, device: torch.device) -> dict:
        c = self._consts.get(device)
        if c is None:
            c = self._consts[device] = {
                k: torch.from_numpy(self._digits_np(v)).to(device) for k, v in self._vals.items()
            }
        return c

    # ----- constructors -------------------------------------------------
    def const(self, value: int, mont: bool = True) -> torch.Tensor:
        p = self.params.modulus
        v = value % p
        if mont:
            v = v * self.params.r % p
        return torch.from_numpy(self._digits_np(v)).to(self.device)

    def array(self, values, mont: bool = True) -> torch.Tensor:
        p, r = self.params.modulus, self.params.r
        vals = [(v % p) * r % p if mont else v % p for v in values]
        nb = self.R8
        raw = b"".join(v.to_bytes(nb, "little") for v in vals)
        d = np.frombuffer(raw, dtype=np.uint8).reshape(-1, nb).astype(np.float32)
        return torch.from_numpy(d).to(self.device)

    def _limbs_to_digits_np(self, limbs: np.ndarray) -> np.ndarray:
        """(N, L16) 16-bit limbs -> (N, R8) float32 digits (host)."""
        limbs = np.asarray(limbs, dtype=np.int64)
        lo = (limbs & 0xFF).astype(np.float32)
        hi = ((limbs >> 8) & 0xFF).astype(np.float32)
        return np.stack([lo, hi], axis=-1).reshape(limbs.shape[0], self.R8)

    def digits_to_limbs_np(self, digits) -> np.ndarray:
        """(..., R8) digits -> (M, L16) uint32 16-bit limbs (host)."""
        if isinstance(digits, torch.Tensor):
            digits = digits.detach().cpu().numpy()
        d = np.asarray(digits, dtype=np.int64).reshape(-1, self.R8)
        pairs = d.reshape(d.shape[0], self.R8 // 2, 2)
        return (pairs[..., 0] | (pairs[..., 1] << 8)).astype(np.uint32)

    # ----- the kernels' words -------------------------------------------
    @staticmethod
    def to_words(t: torch.Tensor) -> torch.Tensor:
        return to_words(t)

    @staticmethod
    def from_words(w: torch.Tensor) -> torch.Tensor:
        return from_words(w)

    # ----- internal helpers ---------------------------------------------
    def _mul_wide(self, A: torch.Tensor, B: torch.Tensor, out_rows: int) -> torch.Tensor:
        """Lazy product digits (below 2^23), shifted accumulation."""
        A, B = torch.broadcast_tensors(A, B)
        Z = torch.zeros(A.shape[:-1] + (out_rows,), dtype=F32, device=A.device)
        for i in range(min(self.R8, out_rows)):
            width = min(self.R8, out_rows - i)
            Z[..., i : i + width] += A[..., i : i + 1] * B[..., :width]
        return Z

    def _mul_wide_const(self, A: torch.Tensor, c_digits: np.ndarray, out_rows: int) -> torch.Tensor:
        """A · a constant given as host digits."""
        Z = torch.zeros(A.shape[:-1] + (out_rows,), dtype=F32, device=A.device)
        for i in range(min(len(c_digits), out_rows)):
            coeff = float(c_digits[i])
            if coeff == 0.0:
                continue
            width = min(A.shape[-1], out_rows - i)
            Z[..., i : i + width] += coeff * A[..., :width]
        return Z

    def _cond_sub_p(self, A: torch.Tensor) -> torch.Tensor:
        """Canonical digits of A in [0, 2p) -> A mod p (strict compare via
        the carry out of A + (R − p))."""
        rmp = self._c(A.device)["r_minus_p"]
        t = _strict_normalize(torch.cat([A + rmp, torch.zeros_like(A[..., :1])], dim=-1))
        return torch.where(t[..., -1:] > 0, t[..., :-1], A)

    # ----- ring ops ------------------------------------------------------
    def add_impl(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._cond_sub_p(_strict_normalize(a + b))

    def sub_impl(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a − b by digit complement: a + (255 − b) + 1 + p = a − b + p + R;
        the R carry always leaves the top (a − b + p ≥ 1), so normalise one
        digit wider and drop it."""
        c = self._c(a.device)
        z = a + (255.0 - b) + c["p"] + c["one_std"]
        t = _strict_normalize(torch.cat([z, torch.zeros_like(z[..., :1])], dim=-1))[..., :-1]
        return self._cond_sub_p(t)  # t = a − b + p in [1, 2p)

    def neg_impl(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub_impl(torch.zeros_like(a), a)

    def double_impl(self, a: torch.Tensor) -> torch.Tensor:
        return self.add_impl(a, a)

    def mul_impl(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product, canonical in and out."""
        R8 = self.R8
        t = _strict_normalize(self._mul_wide(a, b, 2 * R8))
        m = _strict_normalize(self._mul_wide_const(t[..., :R8], self.NP_DIGITS, R8))
        s = _strict_normalize(t + self._mul_wide_const(m, self.P_DIGITS, 2 * R8))
        # s = t + m·p < p² + R·p fits 2·R8 digits and its low R8 digits are
        # zero, so the quotient is the high digits, below 2p
        return self._cond_sub_p(s[..., R8:])

    def square_impl(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul_impl(a, a)

    def to_mont_impl(self, a_std: torch.Tensor) -> torch.Tensor:
        return self.mul_impl(a_std, self._c(a_std.device)["r2"])

    def from_mont_impl(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul_impl(a, self._c(a.device)["one_std"])

    add, sub, neg, double = add_impl, sub_impl, neg_impl, double_impl
    mul, square, to_mont, from_mont = mul_impl, square_impl, to_mont_impl, from_mont_impl

    # ----- host / MSM codecs ---------------------------------------------
    def to_host_ints(self, arr, mont: bool = True) -> list[int]:
        vals = limbs16_decode(self.digits_to_limbs_np(arr))
        if mont:
            p = self.params.modulus
            r_inv = pow(self.params.r, -1, p)
            vals = [v * r_inv % p for v in vals]
        return vals

    def window_digits(self, std_arr: torch.Tensor, c: int, num_bits: int) -> torch.Tensor:
        """(N, R8) standard-form digits -> (N, W) c-bit window digits
        (int32). c = 8 is the digits themselves; c in {1, 2, 4} splits them,
        16 merges pairs."""
        d = std_arr.to(torch.int32)
        n = d.shape[0]
        if c == 8:
            digits = d
        elif c == 16:
            pairs = d.reshape(n, self.R8 // 2, 2)
            digits = pairs[..., 0] | (pairs[..., 1] << 8)
        elif c in (1, 2, 4):
            per, mask = 8 // c, (1 << c) - 1
            digits = torch.stack([(d >> (c * k)) & mask for k in range(per)], dim=-1)
            digits = digits.reshape(n, self.R8 * per)
        else:
            raise ValueError(f"unsupported window size {c}")
        return digits[:, : -(-num_bits // c)]

    # ----- predicates / select -------------------------------------------
    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return torch.all(a == 0, dim=-1)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.all(a == b, dim=-1)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(mask[..., None], a, b)

    # ----- exponentiation -------------------------------------------------
    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a host-known exponent: left-to-right square and multiply."""
        if e == 0:
            return self._c(a.device)["one_mont"].expand(a.shape).clone()
        r = a
        for bit in bin(e)[3:]:
            r = self.mul_impl(r, r)
            if bit == "1":
                r = self.mul_impl(r, a)
        return r

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        return self.pow_const(a, self.params.modulus - 2)


@functools.lru_cache(maxsize=None)
def _cached(params: FieldParams, device: str) -> DeviceFieldF32:
    return DeviceFieldF32(params, device)


def get_device_field_f32(params: FieldParams, device="cuda") -> DeviceFieldF32:
    """One `DeviceFieldF32` per field and device."""
    return _cached(params, str(torch.device(device)))
