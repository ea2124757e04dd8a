"""Batch-affine bucket accumulation for the plane MSM: kernels K6
(`affine_phase1`), K7 (`affine_tree_mul`, `affine_inverse`), K8
(`affine_phase3`) and K19 (`affine_batch_inverse`), their plain PyTorch
versions, the batch inversion and the orchestration (`AffineAccum`).

Counterpart of the JAX package's `ops/msm_affine.py` (and of the Fermat
inverse of `ops/plane_affine.py`). Instead of adding each bucket's sorted
elements one by one into a projective accumulator (the K1 scan), the
elements are first scattered into per-bucket blocks of B0 = 2^v slots
(padding slots hold the identity), and v levels of pairwise affine adds
halve the blocks: pair (2j, 2j+1) of a level becomes row j of the next.
An affine add needs 1/(x2 − x1) (or 1/(2y1) for a double); one batch
inversion per level serves every pair of the level. The per-block partial
sums are rows in the key's format, contiguous per bucket, and the K1 scan
with its spill finishes them.

The batch inversion (`batch_inverse`) is K19: Montgomery's trick over
chunks of consecutive products, in three launches whatever the count (up:
each thread's chunk and each block's product; top: one block inverts the
block products, one Fermat inverse on 4-bit windows at its root; down: each
block's and each chunk's inverses), its plain version
`affine_batch_inverse_plain` the same algorithm with the same index map.
The inputs must be nonzero: one zero zeroes every inverse of its block
(K6 gives den = 1 to the pairs that compute nothing, and the affine codec
inverts one in place of Z = 0). K7 stays for products: mode 0 runs the
affine codec's and the former product tree (`tree_inverse`, which the Fr
inverse of `groth16/qap_device.py` runs on K4), mode 1 an inverse a thread.

Every degenerate pair is exact: identity operands (the row flag), P + P
(double), P + (−P) (identity), told apart by exact comparison of canonical
coordinates. The port's values are always reduced, so the rows K8 writes are
canonical without the reference's explicit canonicalisation; the CPU tests
hold them byte for byte against the reference's.

Every function takes the curve (BN254 by default); K6-K8 have instances
for BN254 and BLS12-381, and `AffineAccum` runs on its plan's curve.

Layouts: rows (2M, row_bytes) uint8 in the key's format (`ops/curve.py`:
2·K·D + 1 bytes, D = 34 for BN254 and 50 for BLS12-381); sign bytes (2M,)
uint8 at level 0; den and dinv (M, K, L) int32 limbs at R = 2^(32·L), L = 8
for BN254 and 12 for BLS12-381; classes (M,) uint8: ADD 0, DOUBLE 1, DEAD 2,
COPY_L 3, COPY_R 4.
"""

from __future__ import annotations

import math

import torch

from .. import _native
from ..fields.limbs import Field, from_words, mont_mul_words, to_words
from ..fields.params import BN254, CurveParams
from .curve import GROUPS, _launch, _PlainCurve, limbs_of, row_bytes, row_digits

ADD, DOUBLE, DEAD, COPY_L, COPY_R = range(5)
PLAIN_CHUNK = 1 << 20  # pairs per step of the plain versions (bounds memory)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _field_one(K: int, fq: Field, device) -> torch.Tensor:
    """(1, K, L) words of the field's one (Montgomery)."""
    one = torch.zeros((1, K, fq.limbs), dtype=torch.int64, device=device)
    one[0, 0] = to_words(fq.const(1, device))
    return one


def _decode_pairs(pc: _PlainCurve, rows: torch.Tensor, sgn):
    """(2M, row_bytes) rows -> x1, y1, x2, y2 (M, K, L) words and the live
    flags f1, f2 (M,); the sign bytes negate y."""
    x, y = pc.decode_rows(rows)
    if sgn is not None:
        neg = sgn.bool()
        y = torch.where(neg[:, None, None], pc.sub(torch.zeros_like(y), y), y)
    live = rows[:, -1] != 0
    return x[0::2], y[0::2], x[1::2], y[1::2], live[0::2], live[1::2]


def _classify(x1, y1, x2, y2, f1, f2) -> torch.Tensor:
    eq_x = (x1 == x2).flatten(1).all(1)
    eq_y = (y1 == y2).flatten(1).all(1)
    both = f1 & f2
    cls = torch.full_like(f1, ADD, dtype=torch.uint8)
    cls[both & eq_x] = DEAD
    cls[both & eq_x & eq_y] = DOUBLE
    cls[f1 & ~f2] = COPY_L
    cls[~f1 & f2] = COPY_R
    cls[~f1 & ~f2] = DEAD
    return cls


def _chunks(total: int):
    for lo in range(0, total, PLAIN_CHUNK):
        yield lo, min(total, lo + PLAIN_CHUNK)


def affine_phase1_plain(rows, sgn, group: str, curve: CurveParams = BN254):
    """Plain version of K6."""
    K = GROUPS[group]
    pc = _PlainCurve(group, rows.device, curve)
    M = rows.shape[0] // 2
    den = torch.empty((M, K, pc.fq.limbs), dtype=torch.int32, device=rows.device)
    cls = torch.empty((M,), dtype=torch.uint8, device=rows.device)
    one = _field_one(K, pc.fq, rows.device)
    for lo, hi in _chunks(M):
        s = None if sgn is None else sgn[2 * lo : 2 * hi]
        x1, y1, x2, y2, f1, f2 = _decode_pairs(pc, rows[2 * lo : 2 * hi], s)
        c = _classify(x1, y1, x2, y2, f1, f2)
        d = torch.where((c == ADD)[:, None, None], pc.sub(x2, x1), one)
        d = torch.where((c == DOUBLE)[:, None, None], pc.add(y1, y1), d)
        den[lo:hi] = from_words(d)
        cls[lo:hi] = c
    return den, cls


def _encode_rows(pc: _PlainCurve, x, y, live) -> torch.Tensor:
    """x, y (M, K, L) words, live (M,) -> (M, row_bytes) uint8 rows: each
    component the D bytes of x·2^(8·D) mod q (K8 multiplies by that radix
    and writes the 4·L bytes of the product and two zero bytes)."""
    M, K, L = x.shape
    fq, D = pc.fq, row_digits(pc.curve)
    to_row = to_words(fq.const((1 << (8 * D)) % fq.p, x.device, mont=False))
    w = mont_mul_words(torch.cat([x, y], dim=1), to_row, fq)  # (M, 2K, L)
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1).reshape(M, 2 * K, 4 * L)
    pad = torch.zeros((M, 2 * K, D - 4 * L), dtype=b.dtype, device=b.device)
    body = torch.cat([b, pad], dim=2).reshape(M, 2 * K * D)
    return torch.cat([body, live.to(body.dtype)[:, None]], dim=1).to(torch.uint8)


def affine_phase3_plain(rows, sgn, dinv, cls, group: str, curve: CurveParams = BN254):
    """Plain version of K8."""
    K = GROUPS[group]
    pc = _PlainCurve(group, rows.device, curve)
    M = rows.shape[0] // 2
    out = torch.empty((M, row_bytes(group, curve)), dtype=torch.uint8, device=rows.device)
    one = _field_one(K, pc.fq, rows.device)
    for lo, hi in _chunks(M):
        s = None if sgn is None else sgn[2 * lo : 2 * hi]
        x1, y1, x2, y2, _, _ = _decode_pairs(pc, rows[2 * lo : 2 * hi], s)
        c = cls[lo:hi][:, None, None]
        (sq,) = pc.mul_many([(x1, x1)])
        num = torch.where(c == DOUBLE, pc.add(pc.add(sq, sq), sq), pc.sub(y2, y1))
        (lam,) = pc.mul_many([(num, to_words(dinv[lo:hi]))])
        (lam2,) = pc.mul_many([(lam, lam)])
        x3 = pc.sub(pc.sub(lam2, x1), x2)
        (m,) = pc.mul_many([(lam, pc.sub(x1, x3))])
        y3 = pc.sub(m, y1)
        x = torch.where(c == COPY_L, x1, torch.where(c == COPY_R, x2, x3))
        y = torch.where(c == COPY_L, y1, torch.where(c == COPY_R, y2, y3))
        x = torch.where(c == DEAD, torch.zeros_like(x), x)
        y = torch.where(c == DEAD, one, y)
        out[lo:hi] = _encode_rows(pc, x, y, cls[lo:hi] != DEAD)
    return out


def affine_tree_mul_plain(a, b, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K7, mode 0: a·b per element of Fq (G1) or Fq2 (G2)."""
    (r,) = _PlainCurve(group, a.device, curve).mul_many([(to_words(a), to_words(b))])
    return from_words(r)


def fermat_windows(p: int) -> list[int]:
    """The 4-bit windows of p − 2, most significant first (the top one is
    nonzero)."""
    e = p - 2
    return [(e >> (4 * k)) & 15 for k in range((e.bit_length() + 3) // 4)][::-1]


def _fermat_inv_words(z: torch.Tensor, fq: Field) -> torch.Tensor:
    """z^(q−2) on (N, L) Fq words (0 for 0) over fixed 4-bit windows, as K7
    and K19 do it: a table of z^1 .. z^15, then four squares a window and
    one product by the table a nonzero window."""
    tbl = [z]
    for _ in range(14):
        tbl.append(mont_mul_words(tbl[-1], z, fq))
    wins = fermat_windows(fq.p)
    acc = tbl[wins[0] - 1]
    for d in wins[1:]:
        for _ in range(4):
            acc = mont_mul_words(acc, acc, fq)
        if d:
            acc = mont_mul_words(acc, tbl[d - 1], fq)
    return acc


def _inverse_words(w: torch.Tensor, pc: _PlainCurve) -> torch.Tensor:
    """(N, K, L) words -> their inverses (0 for 0). Fq2 goes through the
    norm: (c0 + c1·u)^-1 = (c0 − c1·u) / (c0² + c1²), as u² = −1 on both
    curves."""
    fq = pc.fq
    if w.shape[1] == 1:
        return _fermat_inv_words(w[:, 0], fq)[:, None]
    c0, c1 = w[:, 0], w[:, 1]
    sq = mont_mul_words(torch.stack([c0, c1]), torch.stack([c0, c1]), fq)
    ninv = _fermat_inv_words(pc.add(sq[0], sq[1]), fq)
    r = mont_mul_words(torch.stack([c0, c1]), torch.stack([ninv, ninv]), fq)
    return torch.stack([r[0], pc.sub(torch.zeros_like(r[1]), r[1])], dim=1)


def affine_inverse_plain(a, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K7, mode 1: a^-1 per element (0 for 0)."""
    return from_words(_inverse_words(to_words(a), _PlainCurve(group, a.device, curve)))


# K19's sizes an instance (csrc/affine_kernels.cuh `InverseSizes`): threads
# a block and elements a chunk of the up and down launches, threads of the
# top block.
INVERSE_SIZES = {
    ("bn254", "g1"): (128, 32, 256), ("bn254", "g2"): (128, 16, 256),
    ("bls12_381", "g1"): (128, 32, 256), ("bls12_381", "g2"): (128, 16, 256),
}


def _inverse_up(x, blocks: int, T: int, C: int, mul, one):
    """Up over the chunks of (n, K, L) words x: element b·T·C + t + i·T is
    the i-th of block b's thread t (a (blocks, C, T) view of the padded
    elements). -> (prefixes p_i (blocks, C, T, K, L), valid (blocks, C, T),
    each block's heap levels from the chunk products (blocks, T, K, L) up
    to the block's product (blocks, 1, K, L))."""
    n = x.shape[0]
    valid = (torch.arange(blocks * C * T, device=x.device) < n).view(blocks, C, T)
    xs = torch.cat([x, one.expand(blocks * C * T - n, *x.shape[1:])]).view(
        blocks, C, T, *x.shape[1:])
    pre = torch.empty_like(xs)
    pre[:, 0] = acc = torch.where(valid[:, 0, :, None, None], xs[:, 0], one)
    for i in range(1, C):
        pre[:, i] = acc = torch.where(valid[:, i, :, None, None], mul(acc, xs[:, i]), acc)
    heap = [acc]
    while heap[-1].shape[1] > 1:
        heap.append(mul(heap[-1][:, 0::2], heap[-1][:, 1::2]))
    return pre, valid, xs, heap


def _inverse_down(pre, valid, xs, heap, inv, mul):
    """Down from the blocks' inverses inv (blocks, 1, K, L): each heap
    node's children get its inverse times their sibling, then each chunk
    from its end: y_i = inv·p_(i−1), inv = inv·x_i; y_0 = inv. -> the
    inverses (blocks·C·T, K, L), padding included."""
    for level in reversed(heap[:-1]):
        inv = torch.stack([mul(inv, level[:, 1::2]), mul(inv, level[:, 0::2])], dim=2)
        inv = inv.flatten(1, 2)
    y = torch.empty_like(xs)
    for i in range(xs.shape[1] - 1, 0, -1):
        on = valid[:, i, :, None, None]
        y[:, i] = torch.where(on, mul(inv, pre[:, i - 1]), 0)
        inv = torch.where(on, mul(inv, xs[:, i]), inv)
    y[:, 0] = inv
    return y.flatten(0, 2)


def affine_batch_inverse_plain(den, group: str, curve: CurveParams = BN254, chunk=None,
                               threads=None, top_threads=None) -> torch.Tensor:
    """Plain version of K19 with its index map, heaps, top and windowed
    root: the inverses of (M, K, L) nonzero elements. `threads` (T),
    `chunk` (C) and `top_threads` default to the instance's sizes
    (`INVERSE_SIZES`); T and top_threads powers of two."""
    T0, C0, TT0 = INVERSE_SIZES[(curve.name, group)]
    T, C, TT = threads or T0, chunk or C0, top_threads or TT0
    M = den.shape[0]
    if M == 0:
        return den.clone()
    pc = _PlainCurve(group, den.device, curve)
    one = _field_one(GROUPS[group], pc.fq, den.device)[0]

    def mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        (r,) = pc.mul_many([(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))])
        return r.reshape(a.shape)

    G = -(-M // (T * C))
    up = _inverse_up(to_words(den), G, T, C, mul, one)
    products = up[3][-1][:, 0]  # the G blocks' products, their heaps' roots
    top = _inverse_up(products, 1, TT, -(-G // TT), mul, one)
    # the one inversion, at the top's root: hundreds of dependent products of
    # one element, which run faster on the host than as tiny device ops
    root_inv = _inverse_words(top[3][-1][:, 0].cpu(), _PlainCurve(group, "cpu", curve))
    root_inv = root_inv.to(den.device)
    blk_inv = _inverse_down(*top, root_inv[:, None], mul)[:G]
    return from_words(_inverse_down(*up, blk_inv[:, None], mul)[:M])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_rows(rows: torch.Tensor, sgn, group: str, curve: CurveParams) -> int:
    rb = row_bytes(group, curve)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != rb or rows.shape[0] % 2:
        raise ValueError(f"rows: want uint8 (2M, {rb}), got {rows.dtype} {tuple(rows.shape)}")
    if sgn is not None and (sgn.dtype != torch.uint8 or tuple(sgn.shape) != (rows.shape[0],)):
        raise ValueError(f"sgn: want uint8 ({rows.shape[0]},), got {sgn.dtype} {tuple(sgn.shape)}")
    return rows.shape[0] // 2


def _check_elems(t: torch.Tensor, n: int, group: str, name: str, curve: CurveParams) -> int:
    K, L = GROUPS[group], limbs_of(curve)
    if t.dtype != torch.int32 or t.dim() != 3 or tuple(t.shape[1:]) != (K, L) or (
        n >= 0 and t.shape[0] != n
    ):
        raise ValueError(f"{name}: want int32 ({n}, {K}, {L}), got {t.dtype} {tuple(t.shape)}")
    return t.shape[0]


def _ptr(t):
    return None if t is None else t.data_ptr()


def affine_phase1(rows: torch.Tensor, sgn, group: str = "g1", curve: CurveParams = BN254):
    """K6: pairs (2j, 2j+1) of `rows` -> (den (M, K, L), classes (M,))."""
    _native.require_ported("affine_phase1", curve.name)
    M = _check_rows(rows, sgn, group, curve)
    if rows.device.type == "cpu":
        return affine_phase1_plain(rows, sgn, group, curve)
    _native.require_cuda(rows, *([] if sgn is None else [sgn]))
    den = torch.empty((M, GROUPS[group], limbs_of(curve)), dtype=torch.int32, device=rows.device)
    cls = torch.empty((M,), dtype=torch.uint8, device=rows.device)
    _launch(
        "affine_phase1", "affine_phase1", curve, group, rows.data_ptr(), rows.shape[1], _ptr(sgn),
        den.data_ptr(), cls.data_ptr(), M,
    )
    return den, cls


def affine_phase3(
    rows: torch.Tensor, sgn, dinv: torch.Tensor, cls: torch.Tensor, group: str = "g1",
    curve: CurveParams = BN254,
):
    """K8: the affine add of each pair -> (M, row_bytes) rows."""
    _native.require_ported("affine_phase3", curve.name)
    M = _check_rows(rows, sgn, group, curve)
    _check_elems(dinv, M, group, "dinv", curve)
    if cls.dtype != torch.uint8 or tuple(cls.shape) != (M,):
        raise ValueError(f"cls: want uint8 ({M},), got {cls.dtype} {tuple(cls.shape)}")
    if rows.device.type == "cpu":
        return affine_phase3_plain(rows, sgn, dinv, cls, group, curve)
    _native.require_cuda(rows, dinv, cls, *([] if sgn is None else [sgn]))
    out = torch.empty((M, rows.shape[1]), dtype=torch.uint8, device=rows.device)
    _launch(
        "affine_phase3", "affine_phase3", curve, group, rows.data_ptr(), rows.shape[1], _ptr(sgn),
        dinv.data_ptr(), cls.data_ptr(), out.data_ptr(), M,
    )
    return out


def affine_tree_mul(
    a: torch.Tensor, b: torch.Tensor, group: str = "g1", out=None, curve: CurveParams = BN254
) -> torch.Tensor:
    """K7, mode 0: a·b per element (into `out` when given)."""
    _native.require_ported("affine_tree_mul", curve.name)
    n = _check_elems(a, -1, group, "a", curve)
    _check_elems(b, n, group, "b", curve)
    if out is not None:
        _check_elems(out, n, group, "out", curve)
    if a.device.type == "cpu":
        r = affine_tree_mul_plain(a, b, group, curve)
        if out is None:
            return r
        out.copy_(r)
        return out
    out = torch.empty_like(a) if out is None else out
    _native.require_cuda(a, b, out)
    _launch(
        "affine_tree_mul", "affine_tree_mul", curve, group, 0, a.data_ptr(), b.data_ptr(),
        out.data_ptr(), n,
    )
    return out


def affine_inverse(a: torch.Tensor, group: str = "g1", curve: CurveParams = BN254) -> torch.Tensor:
    """K7, mode 1: a^-1 per element (0 for 0)."""
    _native.require_ported("affine_tree_mul", curve.name)
    n = _check_elems(a, -1, group, "a", curve)
    if a.device.type == "cpu":
        return affine_inverse_plain(a, group, curve)
    _native.require_cuda(a)
    out = torch.empty_like(a)
    _launch(
        "affine_tree_mul", "affine_tree_mul", curve, group, 1, a.data_ptr(), None,
        out.data_ptr(), n,
    )
    return out


# ---------------------------------------------------------------------------
# batch inversion and orchestration
# ---------------------------------------------------------------------------


def tree_inverse(x: torch.Tensor, mul, inv_root, one: torch.Tensor) -> torch.Tensor:
    """Inverses of (M, ...) nonzero elements by a product tree: the
    up-sweep multiplies element i with element i + m (the halves of the
    level; an odd level is padded with `one`, a (1, ...) element),
    inv_root inverts the width-1 root, and the down-sweep gives the left
    child inv·right and the right child inv·left. 3·ceil(log2 M) calls of
    mul(a, b), one of inv_root."""
    levels = []
    while x.shape[0] > 1:
        w = x.shape[0]
        if w % 2:
            x = torch.cat([x, one])
        m = x.shape[0] // 2
        levels.append((x, w))
        x = mul(x[:m], x[m:])
    inv = inv_root(x)
    for x, w in reversed(levels):
        m = x.shape[0] // 2
        inv = torch.cat([mul(inv, x[m:]), mul(inv, x[:m])])[:w]
    return inv


def affine_batch_inverse(den: torch.Tensor, group: str = "g1",
                         curve: CurveParams = BN254) -> torch.Tensor:
    """K19: the inverses of (M, K, L) nonzero elements of Fq (G1) or Fq2
    (G2), in three launches (up, top, down) whatever M; the output and the
    workspace (2·T elements a block of T·C) from `torch.empty`."""
    _native.require_ported("affine_batch_inverse", curve.name)
    M = _check_elems(den, -1, group, "den", curve)
    if den.device.type == "cpu":
        return affine_batch_inverse_plain(den, group, curve)
    _native.require_cuda(den)
    _native.require_aligned(den)
    out = torch.empty_like(den)
    if M == 0:
        return out
    T, C, _ = INVERSE_SIZES[(curve.name, group)]
    ws = torch.empty((2 * T * -(-M // (T * C)), *den.shape[1:]), dtype=den.dtype,
                     device=den.device)
    for phase in range(3):
        _launch(
            "affine_batch_inverse", "affine_batch_inverse", curve, group, phase, den.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws.shape[0], M,
        )
    return out


# The batch inversion the affine levels and the affine codec call: K19 on a
# CUDA tensor, its plain version on the CPU.
batch_inverse = affine_batch_inverse


def pick_block_size(mean_len: int) -> int:
    """Per-bucket block B0 = 2^v, about mean/8 in [4, 32] (the reference's
    choice: level-0 slots at least 88% used, about 8 blocks per bucket left
    for the scan)."""
    v = int(round(math.log2(max(mean_len, 1)))) - 3
    return 1 << max(2, min(5, v))


class AffineAccum:
    """Batch-affine bucket accumulation bound to one `PlaneMsm` plan, on
    its curve and group."""

    def __init__(self, plan):
        self.plan = plan

    def blocks(self, table, perm, start, length, n: int, mean_len: int):
        """Scatter the sorted elements into per-bucket blocks of B0 slots ->
        (rows (TB·B0, row_bytes), sign bytes (TB·B0,), block offsets per
        lane (lanes + 1,), blocks per lane (lanes,), B0). Unused slots read
        the identity sentinel row appended at index n."""
        plan = self.plan
        dev = table.device
        lanes = length.shape[0]
        B0 = pick_block_size(mean_len)
        # block capacity: sum ceil(len/B0) <= total/B0 + lanes
        TB = -(-(plan.W * n) // B0) + lanes
        nblk = (length + B0 - 1) // B0
        boff = torch.cat([nblk.new_zeros(1), torch.cumsum(nblk, 0)])
        blk = torch.arange(TB, device=dev)
        b_of = (torch.searchsorted(boff, blk, right=True) - 1).clamp(0, lanes - 1)
        j = ((blk - boff[b_of]) * B0)[:, None] + torch.arange(B0, device=dev)[None, :]
        in_range = (j < length[b_of][:, None]) & (blk < boff[lanes])[:, None]
        pos = (start[b_of][:, None] + j.clamp(max=n - 1)).clamp(max=n - 1)
        pay = perm[(b_of // plan.nb * n)[:, None] + pos]
        idx = torch.where(in_range, pay & 0x7FFFFFFF, n).reshape(-1)
        sgn = (in_range & (pay < 0)).to(torch.uint8).reshape(-1)
        table_s = torch.cat([table, table.new_zeros((1, table.shape[1]))])
        return table_s[idx], sgn, boff, nblk, B0

    def accumulate(self, table, perm, start, length, n: int, mean_len: int):
        """-> (lanes, 3, K, L) bucket accumulators: v levels of pairwise
        affine adds (K6, the batch inverse, K8), then the K1 scan over the
        block partials."""
        plan = self.plan
        group, curve = plan.group, plan.curve
        rows, sgn, boff, nblk, B0 = self.blocks(table, perm, start, length, n, mean_len)
        for _ in range(B0.bit_length() - 1):
            den, cls = affine_phase1(rows, sgn, group, curve)
            rows = affine_phase3(rows, sgn, batch_inverse(den, group, curve), cls, group, curve)
            sgn = None
        TB = rows.shape[0]
        return plan.run_scan(
            rows, torch.arange(TB, dtype=torch.int32, device=rows.device),
            torch.zeros_like(nblk), boff[:-1], nblk, max(1, mean_len // B0 + 1),
        )
