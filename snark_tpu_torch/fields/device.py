"""Batched Montgomery arithmetic over 16-bit limbs, in plain PyTorch ops.

The counterpart of the JAX package's `fields/device.py` (`DeviceField`,
`get_device_field`), with the same layout, so arrays carry across
unchanged: an element is (..., L) little-endian base-2^16 limbs
(L = `params.num_limbs`), in Montgomery form with R = 2^(16·L), canonical
(every limb below 2^16, the value below p) between ops. Tensors hold the
limbs as `torch.int32` (each limb is below 2^16, so the value equals the
reference's uint32 limb).

The arithmetic runs in int64 on (limbs, M) rows, the batch flattened into
M: a product of two 16-bit limbs is below 2^32 and a column sum of L of
them below 2^37, exact. The Montgomery product is SOS, as the reference's
(`mul`): T = a·b from L shifted row adds, m = T_lo·N' mod R and m·p the
same way with the constants' limbs as Python ints, u = (T + m·p)/R < 2p,
then one conditional subtraction; each carry is one pass up the rows
(`limbs._carry_rows`). Every result is the canonical residue, so it equals
the reference's limb for limb on any device.

This is setup's field layer, the `u32` line of `bench_field` and the
default layout of the legacy device API (`ops/curve_u32.py`,
`ops/msm_u32.py`, `ops/ntt_u32.py`); no kernel runs here (the kernels'
field core is `csrc/field.cuh`, over 32-bit limbs). `to_words` and
`from_words` pack and unpack pairs of limbs to and from the kernels'
32-bit words: R = 2^(16·L) is the kernels' 2^(32·L/2), so the Montgomery
form carries across unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .limbs import _carry_rows
from .params import LIMB_BITS, LIMB_MASK, FieldParams


def limbs16_encode(vals, params: FieldParams) -> np.ndarray:
    """Python ints (already reduced) -> (N, L) uint32 16-bit limbs."""
    nb = 2 * params.num_limbs
    raw = b"".join(int(v).to_bytes(nb, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, params.num_limbs).astype(np.uint32)


def limbs16_decode(arr) -> list[int]:
    """(..., L) 16-bit limbs (numpy or tensor) -> flat list of ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr)
    rows = a.reshape(-1, a.shape[-1]).astype("<u2")
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def to_words(t: torch.Tensor) -> torch.Tensor:
    """(..., 2k) int32 16-bit limbs -> (..., k) int32 words of the kernels'
    format (limbs 2j, 2j + 1 the low and high halves of word j). Exact."""
    if t.shape[-1] % 2:
        raise ValueError(f"an odd number of 16-bit limbs: {tuple(t.shape)}")
    pairs = t.to(torch.int64).reshape(t.shape[:-1] + (-1, 2))
    w = pairs[..., 0] | (pairs[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> (..., 2k) int32 16-bit limbs, low first: the
    inverse of `to_words`."""
    return torch.stack([w & LIMB_MASK, (w >> 16) & LIMB_MASK], dim=-1).reshape(
        w.shape[:-1] + (-1,))


class DeviceField:
    """Batched Montgomery arithmetic over one prime field.

    Ops take int32 (or int64) limb tensors on any device and return int32
    tensors on that device; the constructors (`const`, `array`) build on
    the field's device, `cuda` unless the caller asks for another.
    """

    def __init__(self, params: FieldParams, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.L = params.num_limbs
        p = params.modulus
        self._p_limbs = params.to_limbs(p)
        self._np_limbs = params.to_limbs(params.n_prime)
        self._consts: dict[torch.device, dict] = {}

    def _c(self, device: torch.device) -> dict:
        c = self._consts.get(device)
        if c is None:
            col = torch.tensor(self._p_limbs + [0], dtype=torch.int64, device=device)
            lim = lambda v: torch.tensor(self.params.to_limbs(v), dtype=torch.int32, device=device)  # noqa: E731
            c = self._consts[device] = {
                "p_col": col[:, None],  # p in L + 1 rows
                "r2": lim(self.params.r2),
                "one_std": lim(1),
                "one_mont": lim(self.params.r % self.params.modulus),
            }
        return c

    # ----- constructors ------------------------------------------------
    def const(self, value: int, mont: bool = True) -> torch.Tensor:
        """A host int as an (L,) constant on the field's device."""
        return self.array([value], mont)[0]

    def array(self, values, mont: bool = True) -> torch.Tensor:
        """Host ints as an (N, L) array on the field's device."""
        p, r = self.params.modulus, self.params.r
        vals = [(v % p) * r % p if mont else v % p for v in values]
        arr = limbs16_encode(vals, self.params).astype(np.int32)
        return torch.from_numpy(arr).to(self.device)

    # ----- rows ----------------------------------------------------------
    def _rows(self, *xs: torch.Tensor):
        """Broadcast, flatten the batch -> ((L, M) int64 rows each, shape)."""
        xs = torch.broadcast_tensors(*xs)
        shape = xs[0].shape
        return [x.reshape(-1, self.L).t().to(torch.int64) for x in xs], shape

    @staticmethod
    def _out(rows: torch.Tensor, shape) -> torch.Tensor:
        return rows.t().to(torch.int32).reshape(shape)

    def _cond_sub_p(self, x: torch.Tensor) -> torch.Tensor:
        """(L + 1, M) carried rows of a value in [0, 2p) -> (L, M) canonical."""
        d = _carry_rows(x - self._c(x.device)["p_col"], LIMB_BITS)
        return torch.where(d[-1] < 0, x, d)[:-1]

    @staticmethod
    def _widen(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, torch.zeros_like(x[:1])])

    # ----- the kernels' words -------------------------------------------
    @staticmethod
    def to_words(t: torch.Tensor) -> torch.Tensor:
        return to_words(t)

    @staticmethod
    def from_words(w: torch.Tensor) -> torch.Tensor:
        return from_words(w)

    # ----- ring ops ----------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        (A, B), shape = self._rows(a, b)
        s = _carry_rows(self._widen(A + B), LIMB_BITS)
        return self._out(self._cond_sub_p(s), shape)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        (A, B), shape = self._rows(a, b)
        d = _carry_rows(self._widen(A - B), LIMB_BITS)  # top row -1 on a borrow
        w = _carry_rows(d + self._c(d.device)["p_col"], LIMB_BITS)
        return self._out(torch.where(d[-1] < 0, w, d)[:-1], shape)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a·b·R^-1 mod p (SOS)."""
        (A, B), shape = self._rows(a, b)
        L = self.L
        t = torch.zeros((2 * L + 1, A.shape[1]), dtype=torch.int64, device=A.device)
        for i in range(L):
            t[i : i + L] += A[i] * B  # column sums below L·2^32
        _carry_rows(t, LIMB_BITS)  # T = a·b, 2L + 1 rows
        m = torch.zeros_like(t[:L])
        for i, d in enumerate(self._np_limbs):
            if d:
                m[i:] += t[: L - i] * d
        _carry_rows(m, LIMB_BITS)
        m[-1] &= LIMB_MASK  # T·N' mod R
        for i, d in enumerate(self._p_limbs):
            if d:
                t[i : i + L] += m * d
        _carry_rows(t, LIMB_BITS)  # T + m·p: the low L rows are 0
        return self._out(self._cond_sub_p(t[L:]), shape)  # (T + m·p)/R < 2p

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_const(self, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """Multiply by a Montgomery-form (L,) constant."""
        return self.mul(a, c)

    # ----- Montgomery domain conversion --------------------------------
    def to_mont(self, a_std: torch.Tensor) -> torch.Tensor:
        return self.mul(a_std, self._c(a_std.device)["r2"])

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self._c(a.device)["one_std"])

    # ----- host / MSM codecs -------------------------------------------
    def to_host_ints(self, arr, mont: bool = True) -> list[int]:
        """(..., L) limbs -> canonical host ints (out of Montgomery form
        when `mont`)."""
        vals = limbs16_decode(arr)
        if mont:
            p = self.params.modulus
            r_inv = pow(self.params.r, -1, p)
            vals = [v * r_inv % p for v in vals]
        return vals

    def window_digits(self, std_arr: torch.Tensor, c: int, num_bits: int) -> torch.Tensor:
        """(N, L) standard-form limbs -> (N, W) c-bit window digits, c | 16
        (int32)."""
        if 16 % c:
            raise ValueError(f"window size {c} does not divide 16")
        per = 16 // c
        n = std_arr.shape[0]
        mask = (1 << c) - 1
        parts = [(std_arr >> (c * k)) & mask for k in range(per)]
        digits = torch.stack(parts, dim=-1).reshape(n, self.L * per)
        return digits[:, : -(-num_bits // c)]

    # ----- predicates / select -----------------------------------------
    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return torch.all(a == 0, dim=-1)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.all(a == b, dim=-1)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """mask (...,) bool -> where(mask, a, b) over the limbs."""
        return torch.where(mask[..., None], a, b)

    # ----- exponentiation / inversion ----------------------------------
    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a host-known exponent: left-to-right square and multiply."""
        if e == 0:
            return self._c(a.device)["one_mont"].expand(a.shape).clone()
        r = a
        for bit in bin(e)[3:]:
            r = self.mul(r, r)
            if bit == "1":
                r = self.mul(r, a)
        return r

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat: a^(p−2); inv(0) = 0."""
        return self.pow_const(a, self.params.modulus - 2)


@functools.lru_cache(maxsize=None)
def _cached(params: FieldParams, device: str) -> DeviceField:
    return DeviceField(params, device)


def get_device_field(params: FieldParams, device="cuda") -> DeviceField:
    """One `DeviceField` per field and device."""
    return _cached(params, str(torch.device(device)))
