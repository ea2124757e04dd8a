"""Scalar-field kernels K3 (`ntt_stage`) and K4 (`field_ew`), their plain
PyTorch versions, and the radix-2 NTT plan with the Groth16 h pipeline.

Counterpart of the JAX package's `ops/ntt_plane.py` (`_Kernels`,
`PlaneNtt`). Elements are (n, 8) int32 limb tensors over BN254 Fr in the
port's format (`fields/limbs.py`): Montgomery R = 2^256, fully reduced.

The h pipeline keeps the reference's permutation-free order: inverse
transforms are DIF (natural in, bit-reversed out), forward transforms DIT
(bit-reversed in, natural out), and the per-coefficient coset scale
vectors are stored pre-permuted. h comes out in bit-reversed coefficient
order, the order of the reference's `h_tbl` rows. Since every value stays
reduced, the reference's normalising DIF stage has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _native
from ..fields.limbs import (
    FR,
    LIMBS,
    add_words,
    from_words,
    mont_mul_words,
    sub_words,
)

EW_MODES = {"mul": 0, "add": 1, "hadamard": 2}


def bit_reverse_indices(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _check_elems(t: torch.Tensor, name: str, n: int = -1) -> int:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != LIMBS:
        raise ValueError(f"{name}: want int32 (n, 8), got {t.dtype} {tuple(t.shape)}")
    if n >= 0 and t.shape[0] != n:
        raise ValueError(f"{name}: want {n} rows, got {t.shape[0]}")
    return t.shape[0]


# ---------------------------------------------------------------------------
# K4: elementwise field ops
# ---------------------------------------------------------------------------


def field_ew_plain(mode: str, a, b, c=None, d=None) -> torch.Tensor:
    """Plain version of K4."""
    x, y = _words(a), _words(b)
    if mode == "mul":
        r = mont_mul_words(x, y, FR)
    elif mode == "add":
        r = add_words(x, y, FR)
    else:
        ab = mont_mul_words(x, y, FR)
        r = mont_mul_words(sub_words(ab, _words(c), FR), _words(d), FR)
    return from_words(r)


def field_ew(
    mode: str,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor | None = None,
    d: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4 over Fr. mode "mul": a·b; "add": a + b; "hadamard": (a·b − c)·d.
    a is (n, 8); b is (n, 8), or (8,) to use one value for every element;
    c is (n, 8) and d (8,) in "hadamard" mode."""
    if mode not in EW_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n = _check_elems(a, "a")
    b_bcast = b.dim() == 1
    if b_bcast:
        if b.dtype != torch.int32 or b.shape != (LIMBS,):
            raise ValueError(f"b: want int32 (8,), got {b.dtype} {tuple(b.shape)}")
    else:
        _check_elems(b, "b", n)
    if mode == "add" and b_bcast:
        raise ValueError("add takes b of shape (n, 8)")
    if mode == "hadamard":
        if c is None or d is None:
            raise ValueError("hadamard needs c and d")
        _check_elems(c, "c", n)
        if d.dtype != torch.int32 or d.shape != (LIMBS,):
            raise ValueError(f"d: want int32 (8,), got {d.dtype} {tuple(d.shape)}")
    if a.device.type == "cpu":
        return field_ew_plain(mode, a, b, c, d)
    c = a if c is None else c
    d = b if d is None else d
    _native.require_cuda(a, b, c, d)
    out = torch.empty_like(a)
    _native.launch(
        "field_ew", "field_ew", EW_MODES[mode], out.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), n, int(b_bcast),
    )
    return out


def to_mont(x_std: torch.Tensor) -> torch.Tensor:
    """Standard-form limbs -> Montgomery form (a K4 mul by R^2)."""
    return field_ew("mul", x_std, FR.const(FR.r2, x_std.device, mont=False))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery-form limbs -> canonical standard form (a K4 mul by 1)."""
    return field_ew("mul", x, FR.const(1, x.device, mont=False))


# ---------------------------------------------------------------------------
# K3: one radix-2 stage
# ---------------------------------------------------------------------------


def ntt_stage_plain(x, tw, log_half: int, tw_stride: int, dif: bool) -> torch.Tensor:
    """Plain version of K3."""
    n = x.shape[0]
    half = 1 << log_half
    xr = _words(x).reshape(n // (2 * half), 2, half, LIMBS)
    lo, hi = xr[:, 0], xr[:, 1]
    j = torch.arange(half, device=x.device) * tw_stride
    w = _words(tw)[j].unsqueeze(0)
    if dif:
        o0 = add_words(lo, hi, FR)
        o1 = mont_mul_words(sub_words(lo, hi, FR), w, FR)
    else:
        v = mont_mul_words(hi, w, FR)
        o0, o1 = add_words(lo, v, FR), sub_words(lo, v, FR)
    return from_words(torch.stack([o0, o1], dim=1).reshape(n, LIMBS))


def ntt_stage(
    x: torch.Tensor, tw: torch.Tensor, log_half: int, tw_stride: int, dif: bool
) -> torch.Tensor:
    """K3: butterflies (x[lo], x[hi]) with hi = lo + 2^log_half, twiddle
    tw[j·tw_stride] for butterfly j of its block. DIT: (lo + hi·w,
    lo − hi·w); DIF: (lo + hi, (lo − hi)·w)."""
    n = _check_elems(x, "x")
    half = 1 << log_half
    if n % (2 * half):
        raise ValueError(f"n = {n} is not a multiple of 2·half = {2 * half}")
    t = _check_elems(tw, "tw")
    if (half - 1) * tw_stride >= t:
        raise ValueError("twiddle table too short for this stage")
    if x.device.type == "cpu":
        return ntt_stage_plain(x, tw, log_half, tw_stride, dif)
    _native.require_cuda(x, tw)
    y = torch.empty_like(x)
    _native.launch(
        "ntt_stage", "ntt_stage", x.data_ptr(), y.data_ptr(), tw.data_ptr(), n, log_half,
        tw_stride, int(dif),
    )
    return y


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _powers(base: int, count: int, p: int, start: int = 1) -> list[int]:
    out, x = [], start
    for _ in range(count):
        out.append(x)
        x = x * base % p
    return out


class NttPlan:
    """Twiddles and coset vectors for one domain size n over BN254 Fr."""

    def __init__(self, n: int, device):
        assert n & (n - 1) == 0 and n >= 2
        p = FR.p
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = torch.device(device)
        params = FR.params
        omega = params.root_of_unity(n)
        g = params.generator
        n_inv = pow(n, -1, p)
        self.fwd_tw = FR.tensor(_powers(omega, n // 2, p), device)
        self.inv_tw = FR.tensor(_powers(pow(omega, -1, p), n // 2, p), device)
        rev = bit_reverse_indices(n)
        pows = _powers(g, n, p, n_inv)  # g^i / n
        ipows = _powers(pow(g, -1, p), n, p, n_inv)  # g^-i / n
        # pre-permuted: coefficient i sits at bitrev(i) after a DIF iNTT
        self.coset_scale_rev = FR.tensor([pows[r] for r in rev], device)
        self.coset_unscale_rev = FR.tensor([ipows[r] for r in rev], device)
        z_coset = (pow(g, n, p) - 1) % p
        self.z_coset_inv = FR.const(pow(z_coset, -1, p), device)
        self.rev = torch.as_tensor(rev, device=device)

    def dit(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Bit-reversed input -> natural output."""
        for s in range(self.log_n):
            x = ntt_stage(x, tw, s, self.n >> (s + 1), dif=False)
        return x

    def dif(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Natural input -> bit-reversed output."""
        for s in range(self.log_n - 1, -1, -1):
            x = ntt_stage(x, tw, s, self.n >> (s + 1), dif=True)
        return x

    def h_from_evals(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """(n, 8) Montgomery domain evaluations of A·z, B·z, C·z -> h
        coefficients, Montgomery form, in bit-reversed order."""

        def to_coset(x):
            x = self.dif(x, self.inv_tw)  # iNTT without the 1/n, bitrev
            x = field_ew("mul", x, self.coset_scale_rev)  # g^i / n
            return self.dit(x, self.fwd_tw)  # coset evaluations, natural

        h_ev = field_ew(
            "hadamard", to_coset(a_ev), to_coset(b_ev), to_coset(c_ev), self.z_coset_inv
        )
        h = self.dif(h_ev, self.inv_tw)
        return field_ew("mul", h, self.coset_unscale_rev)

    # natural-order transforms (tests against the reference vectors)
    def fft(self, x: torch.Tensor) -> torch.Tensor:
        return self.dit(x[self.rev].contiguous(), self.fwd_tw)

    def ifft(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dit(x[self.rev].contiguous(), self.inv_tw)
        return field_ew("mul", y, FR.const(pow(self.n, -1, FR.p), y.device))
