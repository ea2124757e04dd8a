"""Scalar-field kernels K3 (`ntt_pass`, one stage of it `ntt_stage`) and
K4 (`field_ew`), their plain PyTorch versions, and the radix-2 NTT plan
with the Groth16 h pipeline.

Counterpart of the JAX package's `ops/ntt_plane.py` (`_Kernels`,
`PlaneNtt`). Elements are (n, 8) int32 limb tensors over a scalar field,
BN254 Fr by default or BLS12-381 Fr (every function takes the `Field`), in
the port's format (`fields/limbs.py`): Montgomery R = 2^256, fully
reduced, 16-byte aligned.

K3 runs k consecutive radix-2 stages of a transform in one launch, the
array cut into tiles of whole sub-transforms in shared memory
(`pass_geometry`, `pass_maps`; `ntt_pass_emulate` runs plain butterflies
over the kernel's own index maps). A transform of 2^20 is two launches
(`pass_split`). `ntt_rows` runs B independent transforms of the rows of
one vector as the first log m stages of one (the distributed NTT's local
step; `NttPlan.fft` and `ifft` are its one-row case). The h pipeline keeps the reference's permutation-free
order: inverse transforms are DIF (natural in, bit-reversed out), forward
transforms DIT (bit-reversed in, natural out), and the per-coefficient
coset scale vectors are stored pre-permuted. K4's products of the
pipeline run inside the passes: the coset scale as the last pass of each
DIF stores, the Hadamard step as the first pass of h's inverse transform
loads, the unscale as its last pass stores. h comes out in bit-reversed
coefficient order, the order of the reference's `h_tbl` rows; `h_std`
gives it in canonical standard form (the unscale table stored in standard
form), `h_from_evals` in Montgomery form. Since every value stays reduced,
the reference's normalising DIF stage has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    _native.require_aligned(a, b, c, d)
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
# K3: k radix-2 stages in one pass
# ---------------------------------------------------------------------------

LOG_TILE = 11  # csrc/ntt_kernels.cuh kPassLogTile: 2^11 elements, 64 KB a tile
RADIX = 3  # kPassRadix: stages a thread runs in registers between exchanges
STRIDED_STAGES = 9  # a pass with s0 > 0 keeps >= 2^(11 - 9) sub-transforms a tile


def pass_split(log_n: int) -> list[int]:
    """Stages of each pass of a transform over 2^log_n, in DIT order (the
    first pass runs stages [0, k0), the next [k0, k0 + k1), ...): one pass
    up to 2^11; else as few as cover log n with a first pass of at most 11
    stages (contiguous tiles) and later ones of at most 9, whose tiles then
    hold at least 4 sub-transforms side by side, so every global access is
    a run of 128 bytes or more. 2^20: [11, 9]; 2^18: [9, 9]."""
    if log_n <= LOG_TILE:
        return [log_n]
    passes = 2
    while LOG_TILE + STRIDED_STAGES * (passes - 1) < log_n:
        passes += 1
    base, extra = divmod(log_n, passes)
    ks = [base + (i < extra) for i in range(passes)]
    while max(ks[1:]) > STRIDED_STAGES:
        i = ks.index(max(ks[1:]), 1)
        ks[i] -= 1
        ks[0] += 1
    return ks


@dataclass(frozen=True)
class PassGeometry:
    """One launch of K3: stages [s0, s0 + k) of a transform over
    n = 2^log_n, stage s reading twiddle tw[j << (tw_log − s)]. A block
    holds G = 2^log_g sub-transforms of 2^k elements: a tile of
    2^log_t = 2^(k + log_g) elements, run by 2^(log_t − radix) threads of
    2^radix elements each."""

    log_n: int
    s0: int
    k: int
    log_g: int
    tw_log: int

    @property
    def log_t(self) -> int:
        return self.k + self.log_g

    @property
    def radix(self) -> int:
        return min(RADIX, self.log_t)

    @property
    def blocks(self) -> int:
        return 1 << (self.log_n - self.log_t)

    @property
    def threads(self) -> int:
        return 1 << (self.log_t - self.radix)


def pass_geometry(n: int, s0: int, k: int, tw_log: int | None = None,
                  log_tile: int = LOG_TILE) -> PassGeometry:
    """The launch of stages [s0, s0 + k) over n elements, or ValueError for
    what the kernel does not take. The tile is min(n, 2^log_tile) elements
    (the kernel's 2^11 at most; a smaller one, for `ntt_pass_emulate`, gives
    more blocks). tw_log defaults to log n − 1, the plan's one table of n/2
    powers."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"n = {n} is not a power of two >= 2")
    log_n = n.bit_length() - 1
    if k < 1 or s0 < 0 or s0 + k > log_n:
        raise ValueError(f"stages [{s0}, {s0 + k}) are not inside [0, {log_n})")
    if k > LOG_TILE:
        raise ValueError(
            f"{k} stages need a tile of 2^{k} elements in shared memory; the pass "
            f"kernel's holds 2^{LOG_TILE} (64 KB)"
        )
    log_t = min(log_n, log_tile, LOG_TILE)
    if k > log_t:
        raise ValueError(f"{k} stages do not fit a tile of 2^{log_t} elements")
    tw_log = log_n - 1 if tw_log is None else tw_log
    if tw_log < s0 + k - 1:
        raise ValueError(f"tw_log = {tw_log} cannot index stage {s0 + k - 1}")
    return PassGeometry(log_n, s0, k, log_t - k, tw_log)


def swz(p):
    """Tile position -> its slot in shared memory (csrc/ntt_kernels.cuh swz)."""
    return p ^ ((p >> 5) & 31)


def pass_maps(g: PassGeometry, dif: bool) -> dict:
    """The kernel's index maps (`ntt_pass_kernel`), as numpy int64 arrays:
    `index` (blocks, T), the global index each block loads tile position p
    from and stores it to; `rounds`, for each round the positions
    (threads, 2^radix) each thread holds and the round's stages in order,
    each (window bit, stage, twiddle index (blocks, threads, 2^radix / 2)
    of each butterfly's low element)."""
    R, G = g.radix, 1 << g.log_g
    blk = np.arange(g.blocks, dtype=np.int64)

    def q_m(p):  # sub-transform (blocks, ...) and m of tile positions p
        q = (blk.reshape((-1,) + (1,) * p.ndim) << g.log_g) | (p & (G - 1))
        return q, p >> g.log_g

    q, m = q_m(np.arange(1 << g.log_t, dtype=np.int64))
    index = ((q >> g.s0) << (g.s0 + g.k)) | (m << g.s0) | (q & ((1 << g.s0) - 1))
    u = np.arange(g.threads, dtype=np.int64)
    rounds = []
    for r in range(-(-g.k // R)):
        if dif:
            top = g.k - r * R
            b = max(top - R, 0)
            cnt = top - b
        else:
            b = r * R
            cnt = min(R, g.k - b)
        c = min(g.log_g + b, g.log_t - R)
        w_lo = g.log_g + b - c
        base = ((u >> c) << (c + R)) | (u & ((1 << c) - 1))
        pos = base[:, None] | (np.arange(1 << R, dtype=np.int64) << c)
        stages = []
        for wb in (range(R - 1, -1, -1) if dif else range(R)):
            if not w_lo <= wb < w_lo + cnt:
                continue
            sb = c + wb - g.log_g
            s = g.s0 + sb
            q, m = q_m(pos[:, [j for j in range(1 << R) if not j >> wb & 1]])
            jt = ((m & ((1 << sb) - 1)) << g.s0) | (q & ((1 << g.s0) - 1))
            stages.append((wb, s, jt << (g.tw_log - s)))
        rounds.append((pos, stages))
    return {"index": index, "rounds": rounds}


def _butterflies(lo, hi, w, dif: bool, field: Field):
    if dif:
        return add_words(lo, hi, field), mont_mul_words(sub_words(lo, hi, field), w, field)
    v = mont_mul_words(hi, w, field)
    return add_words(lo, v, field), sub_words(lo, v, field)


def ntt_pass_emulate(x, tw, g: PassGeometry, dif: bool, hadamard=None, scale=None,
                     field: Field = FR) -> torch.Tensor:
    """K3's block schedule on the CPU: plain butterflies over exactly the
    kernel's maps (`pass_maps`), the tile kept at its shared-memory slots
    (`swz`), the prologue and epilogue where the kernel runs them. Equal to
    `ntt_pass_plain` when the maps are right."""
    maps = pass_maps(g, dif)
    L, R = field.limbs, g.radix
    index = torch.as_tensor(maps["index"])
    xw = _words(x)
    v = xw[index]  # (blocks, T, L), row p at slot swz(p)
    if hadamard is not None:
        b, c, d = (_words(t) for t in hadamard)
        v = mont_mul_words(sub_words(mont_mul_words(v, b[index], field), c[index], field), d, field)
    tile = torch.empty_like(v)
    tile[:, torch.as_tensor(swz(np.arange(v.shape[1])))] = v
    tww = _words(tw)
    for pos, stages in maps["rounds"]:
        slots = torch.as_tensor(swz(pos))
        e = tile[:, slots]  # (blocks, threads, 2^R, L)
        for wb, _s, tw_index in stages:
            lo = [j for j in range(1 << R) if not j >> wb & 1]
            hi = [j | 1 << wb for j in lo]
            e[:, :, lo], e[:, :, hi] = _butterflies(
                e[:, :, lo], e[:, :, hi], tww[torch.as_tensor(tw_index)], dif, field)
        tile[:, slots] = e
    v = tile[:, torch.as_tensor(swz(np.arange(v.shape[1])))]
    if scale is not None:
        v = mont_mul_words(v, _words(scale)[index], field)
    y = torch.empty_like(xw)
    y[index.reshape(-1)] = v.reshape(-1, L)
    return from_words(y)


def ntt_stage_plain(
    x, tw, log_half: int, tw_stride: int, dif: bool, field: Field = FR
) -> torch.Tensor:
    """One radix-2 stage, the butterflies of K3's plain version."""
    n, L = x.shape
    half = 1 << log_half
    xr = _words(x).reshape(n // (2 * half), 2, half, L)
    j = torch.arange(half, device=x.device) * tw_stride
    o0, o1 = _butterflies(xr[:, 0], xr[:, 1], _words(tw)[j].unsqueeze(0), dif, field)
    return from_words(torch.stack([o0, o1], dim=1).reshape(n, L))


def ntt_pass_plain(x, tw, s0: int, k: int, dif: bool, tw_log: int | None = None,
                   hadamard=None, scale=None, field: Field = FR) -> torch.Tensor:
    """Plain version of K3: the prologue as K4's plain Hadamard step, the
    stages one by one, the epilogue as K4's plain product."""
    tw_log = x.shape[0].bit_length() - 2 if tw_log is None else tw_log
    if hadamard is not None:
        x = field_ew_plain("hadamard", x, *hadamard, field=field)
    stages = range(s0 + k - 1, s0 - 1, -1) if dif else range(s0, s0 + k)
    for s in stages:
        x = ntt_stage_plain(x, tw, s, 1 << (tw_log - s), dif, field)
    if scale is not None:
        x = field_ew_plain("mul", x, scale, field=field)
    return x


def ntt_pass(
    x: torch.Tensor, tw: torch.Tensor, s0: int, k: int, dif: bool, tw_log: int | None = None,
    hadamard: tuple | None = None, scale: torch.Tensor | None = None, field: Field = FR,
) -> torch.Tensor:
    """K3: stages [s0, s0 + k) of a radix-2 transform of x (n a power of
    two) in one launch. Stage s pairs x[i], x[i + 2^s] (bit s of i clear)
    with twiddle w = tw[(i mod 2^s) << (tw_log − s)]: DIT (lo + hi·w,
    lo − hi·w), DIF (lo + hi, (lo − hi)·w); DIT runs the stages upwards,
    DIF downwards. `hadamard` = (b, c, d): x becomes (x·b − c)·d[0] as the
    pass loads it; `scale` (n, 8): the output is multiplied by it as the
    pass stores."""
    L = field.limbs
    n = _check_elems(x, "x", limbs=L)
    g = pass_geometry(n, s0, k, tw_log)
    t = _check_elems(tw, "tw", limbs=L)
    s_top = s0 + k - 1
    if ((1 << s_top) - 1) << (g.tw_log - s_top) >= t:
        raise ValueError("twiddle table too short for these stages")
    operands = [x, tw]
    if hadamard is not None:
        b, c, d = hadamard
        _check_elems(b, "b", n, L)
        _check_elems(c, "c", n, L)
        if d.dtype != torch.int32 or d.shape != (L,):
            raise ValueError(f"d: want int32 ({L},), got {d.dtype} {tuple(d.shape)}")
        operands += [b, c, d]
    if scale is not None:
        _check_elems(scale, "scale", n, L)
        operands.append(scale)
    _native.require_aligned(*operands)
    if x.device.type == "cpu":
        return ntt_pass_plain(x, tw, s0, k, dif, g.tw_log, hadamard, scale, field)
    _native.require_cuda(*operands)
    y = torch.empty_like(x)
    b, c, d = (None, None, None) if hadamard is None else (t.data_ptr() for t in hadamard)
    _launch(
        "ntt_pass", field, x.data_ptr(), y.data_ptr(), tw.data_ptr(), n, g.s0, g.k, g.log_g,
        g.tw_log, int(dif), b, c, d, None if scale is None else scale.data_ptr(),
    )
    return y


def ntt_stage(
    x: torch.Tensor, tw: torch.Tensor, log_half: int, tw_stride: int, dif: bool,
    field: Field = FR,
) -> torch.Tensor:
    """One stage of K3 (a pass of k = 1): butterflies (x[lo], x[hi]) with
    hi = lo + 2^log_half, twiddle tw[j·tw_stride] for butterfly j of its
    block, tw_stride a power of two. DIT: (lo + hi·w, lo − hi·w); DIF:
    (lo + hi, (lo − hi)·w)."""
    if tw_stride < 1 or tw_stride & (tw_stride - 1):
        raise ValueError(f"tw_stride = {tw_stride} is not a power of two")
    return ntt_pass(x, tw, log_half, 1, dif, log_half + tw_stride.bit_length() - 1, field=field)


def ntt_rows(x: torch.Tensor, m: int, tw: torch.Tensor, scale: torch.Tensor | None = None,
             field: Field = FR) -> torch.Tensor:
    """B = len(x) / m independent length-m transforms, row b being
    x[b·m : (b + 1)·m], natural order in and out. Each row is bit-reversed,
    then K3 runs stages [0, log m) over the whole B·m vector (`pass_split`
    of log m) with tw_log = log m − 1, `tw` holding the m/2 powers of the
    rows' root. Stage s pairs elements inside a block of 2^(s + 1) and reads
    tw[(i mod 2^s) << (tw_log − s)], which depends only on the position in
    the row, so below log m no butterfly crosses a row and the B·m vector
    is B transforms side by side. `scale` (L,) multiplies every output (a
    broadcast K4 mul): 1/m for an inverse transform."""
    x, log_m = _rows_bit_reversed(x, m, field)
    s0 = 0
    for k in pass_split(log_m):
        x = ntt_pass(x, tw, s0, k, dif=False, tw_log=log_m - 1, field=field)
        s0 += k
    return x if scale is None else field_ew("mul", x, scale, field=field)


def ntt_rows_plain(x: torch.Tensor, m: int, tw: torch.Tensor, scale: torch.Tensor | None = None,
                   field: Field = FR) -> torch.Tensor:
    """Plain version of `ntt_rows`: the same passes through `ntt_pass_plain`
    and the scale through `field_ew_plain`."""
    x, log_m = _rows_bit_reversed(x, m, field)
    s0 = 0
    for k in pass_split(log_m):
        x = ntt_pass_plain(x, tw, s0, k, dif=False, tw_log=log_m - 1, field=field)
        s0 += k
    return x if scale is None else field_ew_plain("mul", x, scale, field=field)


def _rows_bit_reversed(x: torch.Tensor, m: int, field: Field) -> tuple[torch.Tensor, int]:
    """Each row of m elements of x in bit-reversed order -> (that, log m)."""
    n = _check_elems(x, "x", limbs=field.limbs)
    if m < 2 or m & (m - 1) or n % m:
        raise ValueError(f"{n} elements are not rows of a power of two m = {m}")
    pos = torch.arange(n, device=x.device)
    rev = torch.as_tensor(bit_reverse_indices(m), device=x.device)
    return x[pos - pos % m + rev[pos % m]], m.bit_length() - 1


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
    """Twiddles, coset vectors and the passes of each transform for one
    domain size n over a scalar field (BN254 Fr by default): the two-adic
    root of unity, the coset generator (the field's multiplicative
    generator: 5 for BN254 Fr, 7 for BLS12-381 Fr) and 1/n all come from
    the field's params."""

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
        unscale = [ipows[r] for r in rev]
        self.coset_unscale_rev = f.tensor(unscale, device)
        # x R · u · R^-1 = x u: the unscale by a standard-form table leaves
        # the canonical standard form
        self.coset_unscale_std = f.tensor(unscale, device, mont=False)
        z_coset = (pow(g, n, p) - 1) % p
        self.z_coset_inv = f.const(pow(z_coset, -1, p), device)
        s0, self.passes = 0, []  # (s0, k) of each pass, DIT order
        for k in pass_split(self.log_n):
            self.passes.append((s0, k))
            s0 += k

    def dit(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Bit-reversed input -> natural output."""
        for s0, k in self.passes:
            x = ntt_pass(x, tw, s0, k, dif=False, field=self.field)
        return x

    def dif(self, x: torch.Tensor, tw: torch.Tensor, hadamard=None, scale=None) -> torch.Tensor:
        """Natural input -> bit-reversed output; `hadamard` (b, c, d) runs
        as the first pass loads, `scale` as the last pass stores (ntt_pass)."""
        passes = self.passes[::-1]
        for i, (s0, k) in enumerate(passes):
            x = ntt_pass(
                x, tw, s0, k, dif=True, hadamard=hadamard if i == 0 else None,
                scale=scale if i == len(passes) - 1 else None, field=self.field,
            )
        return x

    def _h(self, a_ev, b_ev, c_ev, unscale: torch.Tensor) -> torch.Tensor:
        # to the coset: iNTT without the 1/n (bit-reversed) scaled by g^i / n
        # as it stores, then the NTT (coset evaluations, natural order)
        a_c, b_c, c_c = (
            self.dit(self.dif(v, self.inv_tw, scale=self.coset_scale_rev), self.fwd_tw)
            for v in (a_ev, b_ev, c_ev)
        )
        return self.dif(a_c, self.inv_tw, hadamard=(b_c, c_c, self.z_coset_inv), scale=unscale)

    def h_from_evals(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """(n, 8) Montgomery domain evaluations of A·z, B·z, C·z -> h
        coefficients, Montgomery form, in bit-reversed order."""
        return self._h(a_ev, b_ev, c_ev, self.coset_unscale_rev)

    def h_std(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """As `h_from_evals`, in canonical standard form: what the prover
        takes."""
        return self._h(a_ev, b_ev, c_ev, self.coset_unscale_std)

    def h_plain(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """Plain version of `h_std` on any device: every stage and product
        apart (K3's and K4's plain versions), the pipeline the passes fuse."""
        f, n = self.field, self.n

        def transform(x, tw, dif):
            stages = range(self.log_n - 1, -1, -1) if dif else range(self.log_n)
            for s in stages:
                x = ntt_stage_plain(x, tw, s, n >> (s + 1), dif, f)
            return x

        def to_coset(x):
            x = field_ew_plain("mul", transform(x, self.inv_tw, True), self.coset_scale_rev, field=f)
            return transform(x, self.fwd_tw, False)

        h_ev = field_ew_plain(
            "hadamard", to_coset(a_ev), to_coset(b_ev), to_coset(c_ev), self.z_coset_inv, field=f
        )
        h = field_ew_plain("mul", transform(h_ev, self.inv_tw, True), self.coset_unscale_rev, field=f)
        return field_ew_plain("mul", h, f.const(1, h.device, mont=False), field=f)

    # natural-order transforms (tests against the reference vectors)
    def fft(self, x: torch.Tensor) -> torch.Tensor:
        return ntt_rows(x, self.n, self.fwd_tw, field=self.field)

    def ifft(self, x: torch.Tensor) -> torch.Tensor:
        f = self.field
        return ntt_rows(x, self.n, self.inv_tw, f.const(pow(self.n, -1, f.p), x.device), f)
