"""Scalar-field kernels K3 (`ntt_stage`) and K4 (`field_ew`), their plain
PyTorch versions, and the radix-2 NTT plan with the Groth16 h pipeline.

Counterpart of the JAX package's `ops/ntt_plane.py` (`_Kernels`,
`PlaneNtt`). Elements are (n, 8) int32 limb tensors over a scalar field,
BN254 Fr by default or BLS12-381 Fr (every function takes the `Field`), in
the port's format (`fields/limbs.py`): Montgomery R = 2^256, fully
reduced.

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
    Field,
    add_words,
    from_words,
    mont_mul_words,
    sub_words,
)

EW_MODES = {"mul": 0, "add": 1, "hadamard": 2}
SCALAR_FIELDS = {"bn254_fr": "bn254", "bls12_381_fr": "bls12_381"}  # field -> curve


def _curve_of(field: Field) -> str:
    name = field.params.name
    if name not in SCALAR_FIELDS:
        raise ValueError(f"K3 and K4 run over a scalar field, got {name}")
    return SCALAR_FIELDS[name]


def _launch(kernel: str, field: Field, *args) -> None:
    curve = _curve_of(field)
    _native.launch(
        kernel, _native.counter_name(kernel, curve), _native.CURVE_CODES[curve], *args
    )


def bit_reverse_indices(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _check_elems(t: torch.Tensor, name: str, n: int = -1, limbs: int = 8) -> int:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != limbs:
        raise ValueError(f"{name}: want int32 (n, {limbs}), got {t.dtype} {tuple(t.shape)}")
    if n >= 0 and t.shape[0] != n:
        raise ValueError(f"{name}: want {n} rows, got {t.shape[0]}")
    return t.shape[0]


# ---------------------------------------------------------------------------
# K4: elementwise field ops
# ---------------------------------------------------------------------------


def field_ew_plain(mode: str, a, b, c=None, d=None, field: Field = FR) -> torch.Tensor:
    """Plain version of K4."""
    x, y = _words(a), _words(b)
    if mode == "mul":
        r = mont_mul_words(x, y, field)
    elif mode == "add":
        r = add_words(x, y, field)
    else:
        ab = mont_mul_words(x, y, field)
        r = mont_mul_words(sub_words(ab, _words(c), field), _words(d), field)
    return from_words(r)


def field_ew(
    mode: str,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor | None = None,
    d: torch.Tensor | None = None,
    field: Field = FR,
) -> torch.Tensor:
    """K4 over a scalar field. mode "mul": a·b; "add": a + b; "hadamard":
    (a·b − c)·d. a is (n, 8); b is (n, 8), or (8,) to use one value for
    every element; c is (n, 8) and d (8,) in "hadamard" mode."""
    if mode not in EW_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    L = field.limbs
    n = _check_elems(a, "a", limbs=L)
    b_bcast = b.dim() == 1
    if b_bcast:
        if b.dtype != torch.int32 or b.shape != (L,):
            raise ValueError(f"b: want int32 ({L},), got {b.dtype} {tuple(b.shape)}")
    else:
        _check_elems(b, "b", n, L)
    if mode == "add" and b_bcast:
        raise ValueError(f"add takes b of shape (n, {L})")
    if mode == "hadamard":
        if c is None or d is None:
            raise ValueError("hadamard needs c and d")
        _check_elems(c, "c", n, L)
        if d.dtype != torch.int32 or d.shape != (L,):
            raise ValueError(f"d: want int32 ({L},), got {d.dtype} {tuple(d.shape)}")
    if a.device.type == "cpu":
        return field_ew_plain(mode, a, b, c, d, field)
    c = a if c is None else c
    d = b if d is None else d
    _native.require_cuda(a, b, c, d)
    out = torch.empty_like(a)
    _launch(
        "field_ew", field, EW_MODES[mode], out.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), n, int(b_bcast),
    )
    return out


def to_mont(x_std: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """Standard-form limbs -> Montgomery form (a K4 mul by R^2)."""
    return field_ew("mul", x_std, field.const(field.r2, x_std.device, mont=False), field=field)


def from_mont(x: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """Montgomery-form limbs -> canonical standard form (a K4 mul by 1)."""
    return field_ew("mul", x, field.const(1, x.device, mont=False), field=field)


# ---------------------------------------------------------------------------
# K3: one radix-2 stage
# ---------------------------------------------------------------------------


def ntt_stage_plain(
    x, tw, log_half: int, tw_stride: int, dif: bool, field: Field = FR
) -> torch.Tensor:
    """Plain version of K3."""
    n, L = x.shape
    half = 1 << log_half
    xr = _words(x).reshape(n // (2 * half), 2, half, L)
    lo, hi = xr[:, 0], xr[:, 1]
    j = torch.arange(half, device=x.device) * tw_stride
    w = _words(tw)[j].unsqueeze(0)
    if dif:
        o0 = add_words(lo, hi, field)
        o1 = mont_mul_words(sub_words(lo, hi, field), w, field)
    else:
        v = mont_mul_words(hi, w, field)
        o0, o1 = add_words(lo, v, field), sub_words(lo, v, field)
    return from_words(torch.stack([o0, o1], dim=1).reshape(n, L))


def ntt_stage(
    x: torch.Tensor, tw: torch.Tensor, log_half: int, tw_stride: int, dif: bool,
    field: Field = FR,
) -> torch.Tensor:
    """K3: butterflies (x[lo], x[hi]) with hi = lo + 2^log_half, twiddle
    tw[j·tw_stride] for butterfly j of its block. DIT: (lo + hi·w,
    lo − hi·w); DIF: (lo + hi, (lo − hi)·w)."""
    n = _check_elems(x, "x", limbs=field.limbs)
    half = 1 << log_half
    if n % (2 * half):
        raise ValueError(f"n = {n} is not a multiple of 2·half = {2 * half}")
    t = _check_elems(tw, "tw", limbs=field.limbs)
    if (half - 1) * tw_stride >= t:
        raise ValueError("twiddle table too short for this stage")
    if x.device.type == "cpu":
        return ntt_stage_plain(x, tw, log_half, tw_stride, dif, field)
    _native.require_cuda(x, tw)
    y = torch.empty_like(x)
    _launch(
        "ntt_stage", field, x.data_ptr(), y.data_ptr(), tw.data_ptr(), n, log_half,
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
    """Twiddles and coset vectors for one domain size n over a scalar field
    (BN254 Fr by default): the two-adic root of unity, the coset generator
    (the field's multiplicative generator: 5 for BN254 Fr, 7 for BLS12-381
    Fr) and 1/n all come from the field's params."""

    def __init__(self, n: int, device, field: Field = FR):
        assert n & (n - 1) == 0 and n >= 2
        f = self.field = field
        p = f.p
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = torch.device(device)
        params = f.params
        omega = params.root_of_unity(n)
        g = params.generator
        n_inv = pow(n, -1, p)
        self.fwd_tw = f.tensor(_powers(omega, n // 2, p), device)
        self.inv_tw = f.tensor(_powers(pow(omega, -1, p), n // 2, p), device)
        rev = bit_reverse_indices(n)
        pows = _powers(g, n, p, n_inv)  # g^i / n
        ipows = _powers(pow(g, -1, p), n, p, n_inv)  # g^-i / n
        # pre-permuted: coefficient i sits at bitrev(i) after a DIF iNTT
        self.coset_scale_rev = f.tensor([pows[r] for r in rev], device)
        self.coset_unscale_rev = f.tensor([ipows[r] for r in rev], device)
        z_coset = (pow(g, n, p) - 1) % p
        self.z_coset_inv = f.const(pow(z_coset, -1, p), device)
        self.rev = torch.as_tensor(rev, device=device)

    def dit(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Bit-reversed input -> natural output."""
        for s in range(self.log_n):
            x = ntt_stage(x, tw, s, self.n >> (s + 1), dif=False, field=self.field)
        return x

    def dif(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Natural input -> bit-reversed output."""
        for s in range(self.log_n - 1, -1, -1):
            x = ntt_stage(x, tw, s, self.n >> (s + 1), dif=True, field=self.field)
        return x

    def h_from_evals(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """(n, 8) Montgomery domain evaluations of A·z, B·z, C·z -> h
        coefficients, Montgomery form, in bit-reversed order."""

        f = self.field

        def to_coset(x):
            x = self.dif(x, self.inv_tw)  # iNTT without the 1/n, bitrev
            x = field_ew("mul", x, self.coset_scale_rev, field=f)  # g^i / n
            return self.dit(x, self.fwd_tw)  # coset evaluations, natural

        h_ev = field_ew(
            "hadamard", to_coset(a_ev), to_coset(b_ev), to_coset(c_ev), self.z_coset_inv,
            field=f,
        )
        h = self.dif(h_ev, self.inv_tw)
        return field_ew("mul", h, self.coset_unscale_rev, field=f)

    # natural-order transforms (tests against the reference vectors)
    def fft(self, x: torch.Tensor) -> torch.Tensor:
        return self.dit(x[self.rev].contiguous(), self.fwd_tw)

    def ifft(self, x: torch.Tensor) -> torch.Tensor:
        f = self.field
        y = self.dit(x[self.rev].contiguous(), self.inv_tw)
        return field_ew("mul", y, f.const(pow(self.n, -1, f.p), y.device), field=f)
