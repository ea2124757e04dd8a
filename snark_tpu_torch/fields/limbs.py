"""The port's limb format and its plain PyTorch field arithmetic.

Format: an element of a prime field p is L = ceil(bits(p) / 32)
little-endian 32-bit limbs in Montgomery form with R = 2^(32·L), always
fully reduced (canonical, in [0, p)): L = 8 (R = 2^256) for BN254 Fr and
Fq and BLS12-381 Fr, L = 12 (R = 2^384) for BLS12-381 Fq. Tensors hold the
limbs as `torch.int32` (the bit pattern of the u32 limb) with the limbs in
the last dimension, shape (..., L). The CUDA field core (`csrc/field.cuh`)
uses the same format, so a kernel and its plain version produce
bit-identical tensors.

The one bound the arithmetic needs is p < R/2: a Montgomery product of
two canonical values is below 2p before its conditional subtraction, and
so is a sum, so both fit L words (BLS12-381 Fr, 255 bits, has no more
room than that).

The boundary formats of the reference's keys are converted only at the
edges: 16-bit-limb CSR coefficients (`fields.host`, R = 2^256 for both
scalar fields, repacked by `pack16_to_u32`) and wide-Montgomery u8 rows
(R = 2^272 for BN254 Fq, 2^400 for BLS12-381 Fq, decoded in `ops.curve`).

The plain arithmetic below is what the kernels' plain versions are built
from. It holds the 32-bit words in int64 and splits one factor of every
product into 16-bit digits, so each partial product is below 2^48 and
each column sum (at most 12 of them) exact in int64. Products by the
constants p and N' of the reduction run as float64 matrix products over
16-bit digits, whose column sums (at most 24 terms below 2^32) stay below
2^53 and so are exact too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .params import BLS12_381, BN254, CurveParams, FieldParams

_MASK16 = 0xFFFF
_FEW_LANES = 256  # below this many lanes a carry runs as whole-array passes


class Field:
    """Constants of one prime field in the port's limb format."""

    def __init__(self, params: FieldParams):
        p = params.modulus
        self.limbs = -(-p.bit_length() // 32)  # u32 limbs per element
        self.digits = 2 * self.limbs  # 16-bit digits in the plain arithmetic
        assert 2 * p < 1 << (32 * self.limbs), "the core needs p < R/2"
        self.params = params
        self.p = p
        self.r = 1 << (32 * self.limbs)
        self.r_inv = pow(self.r, -1, p)
        self.r2 = self.r * self.r % p
        self.one = self.r % p  # Montgomery form of 1
        self.n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)  # CIOS word constant
        self.n_prime = (-pow(p, -1, self.r)) % self.r  # REDC constant

    # ----- host codecs -------------------------------------------------
    def to_mont(self, x: int) -> int:
        return x % self.p * self.r % self.p

    def from_mont(self, x: int) -> int:
        return x * self.r_inv % self.p

    def encode(self, vals, mont: bool = True) -> np.ndarray:
        """Python ints -> (N, L) uint32 limbs (Montgomery form by default)."""
        p, nb = self.p, 4 * self.limbs
        if mont:
            vals = (v * self.r for v in vals)
        raw = b"".join((v % p).to_bytes(nb, "little") for v in vals)
        return np.frombuffer(raw, dtype="<u4").reshape(-1, self.limbs)

    def decode(self, limbs, mont: bool = True) -> list[int]:
        """(..., L) limbs (numpy or tensor) -> flat list of ints."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.detach().cpu().numpy()
        raw = np.ascontiguousarray(limbs).astype("<u4", copy=False).tobytes()
        nb = 4 * self.limbs
        out = [int.from_bytes(raw[nb * j : nb * (j + 1)], "little") for j in range(len(raw) // nb)]
        if mont:
            out = [v * self.r_inv % self.p for v in out]
        return out

    def tensor(self, vals, device, mont: bool = True) -> torch.Tensor:
        """Python ints -> (N, L) int32 limb tensor on `device`."""
        return u32_tensor(self.encode(vals, mont), device)

    def const(self, v: int, device, mont: bool = True) -> torch.Tensor:
        """One element as an (L,) limb tensor."""
        return self.tensor([v], device, mont)[0]

    # ----- plain-arithmetic constants ----------------------------------
    @functools.lru_cache(maxsize=None)
    def _consts(self, device: torch.device) -> dict:
        def digits(v, n, bits):
            return torch.tensor(
                [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(n)],
                dtype=torch.int64,
                device=device,
            )

        L, D = self.limbs, self.digits
        return {
            "p9": digits(self.p, L + 1, 32),  # p in L + 1 words
            "n16": self.n_prime & _MASK16,
            "p_band": _band(digits(self.p, D, 16), 2 * D, D),
            "np_band": _band(digits(self.n_prime, D, 16), D, D),
        }


@functools.lru_cache(maxsize=None)
def fields_of(curve: CurveParams) -> tuple[Field, Field]:
    """(Fr, Fq) of a curve in the port's limb format."""
    return Field(curve.fr), Field(curve.fq)


@functools.lru_cache(maxsize=None)
def field_of(params: FieldParams) -> Field:
    """The port's `Field` of a prime field: the one `fields_of` keeps for a
    ported curve's Fr or Fq, else a new one."""
    for curve in (BN254, BLS12_381):
        for f in fields_of(curve):
            if f.params == params:
                return f
    return Field(params)


FR, FQ = fields_of(BN254)  # BN254, the default curve of every entry point
BLS_FR, BLS_FQ = fields_of(BLS12_381)


def u32_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor holding the same bits."""
    arr = np.ascontiguousarray(arr, dtype="<u4")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def pack16_to_u32(arr16: np.ndarray) -> np.ndarray:
    """(..., 2L) 16-bit limbs in uint32 lanes -> (..., L) uint32 limbs (the
    value is unchanged where the 16-bit radix equals the port's, as for the
    reference's CSR coefficients: R = 2^256 for both scalar fields)."""
    a = np.asarray(arr16, dtype=np.uint32)
    assert a.shape[-1] % 2 == 0, a.shape
    pairs = a.reshape(a.shape[:-1] + (a.shape[-1] // 2, 2))
    return (pairs[..., 0] | (pairs[..., 1] << 16)).astype(np.uint32)


def split_u32_to16(words: np.ndarray) -> np.ndarray:
    """(..., L) uint32 limbs (or their int32 bits) -> (..., 2L) 16-bit limbs
    in uint32 lanes, low first: the inverse of pack16_to_u32."""
    w = np.ascontiguousarray(words).view(np.uint32)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(w.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# plain arithmetic: 32-bit words in int64, products through 16-bit digits
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 limbs -> (..., L) int64 words in [0, 2^32)."""
    return x.to(torch.int64) & _MASK32


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., L) normalized words -> (..., L) int32 limbs (same bits)."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _band(digits: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Constant 16-bit digits -> (rows, cols) float64 matrix M with
    (M @ x)[k] = sum_i digits[k - i] * x_i (a digit convolution)."""
    n = digits.shape[0]
    m = torch.zeros((rows, cols), dtype=torch.float64, device=digits.device)
    for i in range(cols):
        hi = max(0, min(n, rows - i))
        m[i : i + hi, i] = digits[:hi].to(torch.float64)
    return m


def _carry_rows(t: torch.Tensor, bits: int) -> torch.Tensor:
    """In place on (k, ...) rows of `bits`-bit digits: leaves every row but
    the last in [0, 2^bits); the last keeps the overflow and the sign (a
    borrow makes it negative). Few lanes: whole-array passes until nothing
    carries (fewer ops); many lanes: one pass from row 0 up (no syncs)."""
    mask = (1 << bits) - 1
    if t[0].numel() <= _FEW_LANES:
        while True:
            c = t[:-1] >> bits
            if not bool(c.any()):
                return t
            t[:-1] &= mask
            t[1:] += c
    for i in range(t.shape[0] - 1):
        c = t[i] >> bits
        t[i] &= mask
        t[i + 1] += c
    return t


def _carry(t: torch.Tensor) -> torch.Tensor:
    """(..., k) words -> carried words: every word but the last in
    [0, 2^32), the last with the overflow and the sign. Works on a copy."""
    tt = t.movedim(-1, 0).clone(memory_format=torch.contiguous_format)
    return _carry_rows(tt, 32).movedim(0, -1)


def _cond_sub_p(x: torch.Tensor, c: dict) -> torch.Tensor:
    """(N, L + 1) carried value < 2p -> (N, L) canonical words."""
    d = _carry(x - c["p9"])
    return torch.where((d[:, -1] < 0)[:, None], x, d)[:, :-1]


def _digits16(w: torch.Tensor) -> torch.Tensor:
    """(k, N) words -> (2k, N) float64 16-bit digits, low digit first."""
    return torch.stack([w & _MASK16, w >> 16], dim=1).reshape(-1, w.shape[1]).to(torch.float64)


def _words32(d: torch.Tensor) -> torch.Tensor:
    """(2k, N) float64 digit sums (each below 2^37) -> (k, N) int64 words
    (each below 2^54, not yet carried)."""
    d = d.to(torch.int64)
    return d[0::2] + (d[1::2] << 16)


def mont_mul_w(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    """Montgomery product a·b·R^-1 mod p on (N, L) canonical words.

    Works on rows, (words, N): T = a·b from 32-bit words of a times 16-bit
    digits of b (each partial sum below 2^52); m = T·N' mod R and m·p as
    float64 products of 16-bit digits with constant band matrices (sums
    below 2^37, exact); u = (T + m·p)/R < 2p, then one conditional
    subtraction of p. Each carry is one pass over the words."""
    c = f._consts(a.device)
    L, D = f.limbs, f.digits
    n = a.shape[0]
    A, B = a.t().contiguous(), b.t()
    b16 = torch.empty((D, n), dtype=torch.int64, device=a.device)
    b16[0::2] = B & _MASK16
    b16[1::2] = B >> 16
    t = torch.zeros((2 * D + 2, n), dtype=torch.int64, device=a.device)
    for i in range(L):
        t[2 * i : 2 * i + D] += A[i] * b16
    carry = t >> 16  # one pass in 16 bits, so that the words below fit
    t &= _MASK16
    t[1:] += carry[:-1]
    w = _carry_rows(t[0::2] + (t[1::2] << 16), 32)  # T = a·b: 2L + 1 words
    m = _carry_rows(_words32(c["np_band"] @ _digits16(w[:L])), 32)
    m[-1] &= _MASK32  # T·N' mod R
    w[: 2 * L] += _words32(c["p_band"] @ _digits16(m))
    u = _carry_rows(w, 32)[L:]  # T + m·p = 0 mod R; u < 2p
    d = _carry_rows(u - c["p9"][:, None], 32)
    return torch.where(d[-1] < 0, u, d)[:L].t().contiguous()


def div_r16_words(w: torch.Tensor, f: Field) -> torch.Tensor:
    """(..., L) canonical words of x -> canonical words of x·2^-16 mod p:
    one 16-bit Montgomery reduction step, (x + m·p) / 2^16 with
    m = −x·p^-1 mod 2^16 (< 2^16·2p / 2^16 = 2p), then one conditional
    subtraction."""
    c = f._consts(w.device)
    shape = w.shape
    w = w.reshape(-1, f.limbs)
    m = ((w[:, 0] & _MASK16) * c["n16"]) & _MASK16
    zero = torch.zeros((w.shape[0], 1), dtype=torch.int64, device=w.device)
    s = _carry(torch.cat([w, zero], dim=1) + m[:, None] * c["p9"])  # = 0 mod 2^16
    r = (s >> 16) | ((torch.roll(s, -1, dims=1) & _MASK16) << 16)
    r[:, -1] = s[:, -1] >> 16
    return _cond_sub_p(r, c).reshape(shape)


def add_w(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    c = f._consts(a.device)
    zero = torch.zeros((a.shape[0], 1), dtype=torch.int64, device=a.device)
    return _cond_sub_p(_carry(torch.cat([a + b, zero], dim=1)), c)


def sub_w(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    c = f._consts(a.device)
    zero = torch.zeros((a.shape[0], 1), dtype=torch.int64, device=a.device)
    t = _carry(torch.cat([a - b, zero], dim=1))
    t = torch.where((t[:, -1] < 0)[:, None], _carry(t + c["p9"]), t)
    return t[:, :-1]


def _flat(fn):
    """Lift an (N, L)-word op to any broadcastable leading shapes."""

    @functools.wraps(fn)
    def run(a, b, f):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a2 = a.expand(shape).reshape(-1, f.limbs)
        b2 = b.expand(shape).reshape(-1, f.limbs)
        return fn(a2, b2, f).reshape(shape)

    return run


mont_mul_words = _flat(mont_mul_w)
add_words = _flat(add_w)
sub_words = _flat(sub_w)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    """Plain Montgomery product on (..., L) int32 limb tensors."""
    return from_words(mont_mul_words(to_words(a), to_words(b), f))


def add_plain(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    return from_words(add_words(to_words(a), to_words(b), f))


def sub_plain(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    return from_words(sub_words(to_words(a), to_words(b), f))
