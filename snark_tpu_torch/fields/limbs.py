"""The port's limb format and its plain PyTorch field arithmetic.

Format: an element of a ~254-bit prime field is 8 little-endian 32-bit
limbs in Montgomery form with R = 2^256, always fully reduced (canonical,
in [0, p)). Tensors hold the limbs as `torch.int32` (the bit pattern of
the u32 limb) with the limbs in the last dimension, shape (..., 8). The
CUDA field core (`csrc/field.cuh`) uses the same format, so a kernel and
its plain version produce bit-identical tensors.

The boundary formats of the reference's keys are converted only at the
edges: 16-bit-limb CSR coefficients (`fields.host`, R = 2^256 as well,
repacked by `pack16_to_u32`) and wide-Montgomery u8 rows (R = 2^272,
decoded in `ops.curve`).

The plain arithmetic below is what the kernels' plain versions are built
from. It holds the eight 32-bit words in int64 and splits one factor of
every product into 16-bit digits, so each partial product is below 2^48
and each column sum exact in int64. Products by the constants p and N'
of the reduction run as float64 matrix products over 16-bit digits, whose
column sums stay below 2^53 and so are exact too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .params import BN254_FQ, BN254_FR, FieldParams

LIMBS = 8  # u32 limbs per element
DIGITS = 16  # 16-bit digits per element in the plain arithmetic
R_BITS = 32 * LIMBS
_MASK16 = 0xFFFF


class Field:
    """Constants of one prime field in the port's limb format."""

    def __init__(self, params: FieldParams):
        p = params.modulus
        assert p.bit_length() <= R_BITS - 2, "the CIOS core assumes 4p < 2^256"
        self.params = params
        self.p = p
        self.r = 1 << R_BITS
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
        """Python ints -> (N, 8) uint32 limbs (Montgomery form by default)."""
        p = self.p
        if mont:
            vals = (v * self.r for v in vals)
        raw = b"".join((v % p).to_bytes(32, "little") for v in vals)
        return np.frombuffer(raw, dtype="<u4").reshape(-1, LIMBS)

    def decode(self, limbs, mont: bool = True) -> list[int]:
        """(..., 8) limbs (numpy or tensor) -> flat list of ints."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.detach().cpu().numpy()
        raw = np.ascontiguousarray(limbs).astype("<u4", copy=False).tobytes()
        out = [
            int.from_bytes(raw[32 * j : 32 * (j + 1)], "little")
            for j in range(len(raw) // 32)
        ]
        if mont:
            out = [v * self.r_inv % self.p for v in out]
        return out

    def tensor(self, vals, device, mont: bool = True) -> torch.Tensor:
        """Python ints -> (N, 8) int32 limb tensor on `device`."""
        return u32_tensor(self.encode(vals, mont), device)

    def const(self, v: int, device, mont: bool = True) -> torch.Tensor:
        """One element as an (8,) limb tensor."""
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

        return {
            "p9": digits(self.p, LIMBS + 1, 32),
            "p_band": _band(digits(self.p, DIGITS, 16), DIGITS, 2 * DIGITS),
            "np_band": _band(digits(self.n_prime, DIGITS, 16), DIGITS, DIGITS),
        }


FR = Field(BN254_FR)
FQ = Field(BN254_FQ)


def u32_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor holding the same bits."""
    arr = np.ascontiguousarray(arr, dtype="<u4")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def pack16_to_u32(arr16: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit limbs in uint32 lanes -> (..., 8) uint32 limbs (the
    value is unchanged: the reference's CSR already uses R = 2^256)."""
    a = np.asarray(arr16, dtype=np.uint32)
    assert a.shape[-1] == 2 * LIMBS, a.shape
    pairs = a.reshape(a.shape[:-1] + (LIMBS, 2))
    return (pairs[..., 0] | (pairs[..., 1] << 16)).astype(np.uint32)


# ---------------------------------------------------------------------------
# plain arithmetic: 32-bit words in int64, products through 16-bit digits
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 8) int64 words in [0, 2^32)."""
    return x.to(torch.int64) & _MASK32


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) normalized words -> (..., 8) int32 limbs (same bits)."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _split16(w: torch.Tensor) -> torch.Tensor:
    """(N, k) words -> (N, 2k) float64 16-bit digits (exact)."""
    d = torch.stack([w & _MASK16, w >> 16], dim=-1)
    return d.reshape(w.shape[0], -1).to(torch.float64)


def _join16(c: torch.Tensor) -> torch.Tensor:
    """(N, 2k) float64 digit columns (each < 2^37) -> (N, k) int64 words
    (each < 2^54, not yet carried)."""
    c = c.to(torch.int64).reshape(c.shape[0], -1, 2)
    return c[..., 0] + (c[..., 1] << 16)


def _band(digits: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Constant 16-bit digits -> (rows, cols) float64 matrix M with
    (x @ M)[k] = sum_i x_i * digits[k - i] (a digit convolution)."""
    n = digits.shape[0]
    m = torch.zeros((rows, cols), dtype=torch.float64, device=digits.device)
    for i in range(rows):
        hi = max(0, min(n, cols - i))
        m[i, i : i + hi] = digits[:hi].to(torch.float64)
    return m


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (and borrows) until every word but the last is in
    [0, 2^32); the last word keeps the overflow and the sign."""
    while True:
        c = t[..., :-1] >> 32
        if not bool(c.any()):
            return t
        t = torch.cat([t[..., :-1] & _MASK32, t[..., -1:]], dim=-1)
        t[..., 1:] += c


def _mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (N, 8) words -> (N, 16) uncarried product words: 32-bit
    words of a times 16-bit digits of b, each column sum below 2^51."""
    n = a.shape[0]
    b16 = torch.stack([b & _MASK16, b >> 16], dim=-1).reshape(n, DIGITS)
    p = torch.zeros((n, 2 * DIGITS), dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        p[:, 2 * i : 2 * i + DIGITS] += a[:, i : i + 1] * b16
    c = p >> 16  # one carry pass so that the words below fit int64
    p = p & _MASK16
    p[:, 1:] += c[:, :-1]
    return p[:, 0::2] + (p[:, 1::2] << 16)


def _cond_sub_p(x: torch.Tensor, c: dict) -> torch.Tensor:
    """(N, 9) carried value < 2p -> (N, 8) canonical words."""
    d = _carry(x - c["p9"])
    return torch.where((d[:, -1] < 0)[:, None], x, d)[:, :LIMBS]


def mont_mul_w(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    """Montgomery product a·b·2^-256 mod p on (N, 8) canonical words."""
    c = f._consts(a.device)
    zero = torch.zeros((a.shape[0], 1), dtype=torch.int64, device=a.device)
    t = _carry(torch.cat([_mul_wide(a, b), zero], dim=1))  # (N, 17) = ab
    m = _join16(_split16(t[:, :LIMBS]) @ c["np_band"])  # T·N' (mod R)
    m = _carry(torch.cat([m, zero], dim=1))[:, :LIMBS]
    mp = _join16(_split16(m) @ c["p_band"])
    u = _carry(t + torch.cat([mp, zero], dim=1))  # T + m·p = 0 mod R
    return _cond_sub_p(u[:, LIMBS:], c)


def add_w(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    c = f._consts(a.device)
    zero = torch.zeros((a.shape[0], 1), dtype=torch.int64, device=a.device)
    return _cond_sub_p(_carry(torch.cat([a + b, zero], dim=1)), c)


def sub_w(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    c = f._consts(a.device)
    zero = torch.zeros((a.shape[0], 1), dtype=torch.int64, device=a.device)
    t = _carry(torch.cat([a - b, zero], dim=1))
    t = torch.where((t[:, -1] < 0)[:, None], _carry(t + c["p9"]), t)
    return t[:, :LIMBS]


def _flat(fn):
    """Lift an (N, 8)-word op to any broadcastable leading shapes."""

    @functools.wraps(fn)
    def run(a, b, f):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a2 = a.expand(shape).reshape(-1, LIMBS)
        b2 = b.expand(shape).reshape(-1, LIMBS)
        return fn(a2, b2, f).reshape(shape)

    return run


mont_mul_words = _flat(mont_mul_w)
add_words = _flat(add_w)
sub_words = _flat(sub_w)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    """Plain Montgomery product on (..., 8) int32 limb tensors."""
    return from_words(mont_mul_words(to_words(a), to_words(b), f))


def add_plain(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    return from_words(add_words(to_words(a), to_words(b), f))


def sub_plain(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    return from_words(sub_words(to_words(a), to_words(b), f))
