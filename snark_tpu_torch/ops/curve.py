"""Curve kernels K1 (`bucket_madd_rows`), K2 (`masked_add`, and
`point_add`: K2 with no mask), K5 (`point_double`), K11
(`masked_mixed_add`) and K18 (`horner_combine`, the MSM's Horner combine
in one launch), their plain PyTorch versions, and the codecs between host
points, the reference's u8 row tables and the port's projective limb
tensors, for BN254 and BLS12-381 (every function takes the curve, BN254 by
default).

A batch of points is an int32 tensor (lanes, 3, K, L): projective X, Y, Z,
each K base-field elements (K = 1 for G1 over Fq, 2 for G2 over Fq2) of L
u32 limbs in Montgomery form, R = 2^(32·L) (`fields/limbs.py`): L = 8 for
BN254, 12 for BLS12-381. The identity is (0, 1, 0).

The reference's tables (`ProvingKey.*_tbl`) are u8 rows of width
2·K·D + 1: X digits ‖ Y digits ‖ identity flag, each component the D
little-endian bytes of x·2^(8·D) mod q ("wide" Montgomery, canonical),
D = 34 for BN254 and 50 for BLS12-381. K1 reads them as they are;
`rows_to_points` and `pack_rows_u8` convert on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _native
from ..fields.limbs import (
    add_words,
    div_r16_words,
    fields_of,
    from_words,
    mont_mul_words,
    sub_words,
)
from ..fields.params import BN254, CurveParams
from ..fields.towers import Fq2 as HostFq2

GROUPS = {"g1": 1, "g2": 2}  # group name -> K (base-field components)


def row_digits(curve: CurveParams = BN254) -> int:
    """Base-256 digits per component in the reference's rows: 2·L + 2 for
    Fq of L 16-bit limbs (its R8), 34 for BN254 and 50 for BLS12-381."""
    return 2 * curve.fq.num_limbs + 2


def row_bytes(group: str, curve: CurveParams = BN254) -> int:
    return 2 * GROUPS[group] * row_digits(curve) + 1


def limbs_of(curve: CurveParams = BN254) -> int:
    """u32 limbs of one Fq element."""
    return fields_of(curve)[1].limbs


# ---------------------------------------------------------------------------
# host codecs
# ---------------------------------------------------------------------------


def _components(pt, idx: int, K: int) -> list[int]:
    return [pt[idx]] if K == 1 else list(pt[idx])


def pack_rows_u8(points, group: str = "g1", curve: CurveParams = BN254) -> np.ndarray:
    """Host affine points (None = identity) -> (N, 2·K·D+1) uint8 rows in
    the reference's layout (byte-identical to its `pack_rows_u8_host`)."""
    K = GROUPS[group]
    q = curve.fq.modulus
    D = row_digits(curve)
    r_wide = 1 << (8 * D)
    one_wide = r_wide % q
    out = np.zeros((len(points), row_bytes(group, curve)), np.uint8)
    for i, pt in enumerate(points):
        if pt is None:
            vals = [0] * K + [one_wide] + [0] * (K - 1)
            flag = 0
        else:
            vals = [v * r_wide % q for v in _components(pt, 0, K) + _components(pt, 1, K)]
            flag = 1
        buf = b"".join(v.to_bytes(D, "little") for v in vals)
        out[i, :-1] = np.frombuffer(buf, np.uint8)
        out[i, -1] = flag
    return out


def rows_to_points(rows: np.ndarray, group: str = "g1", curve: CurveParams = BN254) -> list:
    """(N, 2·K·D+1) uint8 rows -> host affine points (None = identity)."""
    K = GROUPS[group]
    q = curve.fq.modulus
    D = row_digits(curve)
    r_inv = pow(1 << (8 * D), -1, q)
    rows = np.asarray(rows, np.uint8)
    out = []
    for row in rows:
        if row[-1] == 0:
            out.append(None)
            continue
        raw = row[:-1].tobytes()
        vals = [
            int.from_bytes(raw[D * c : D * (c + 1)], "little")
            * r_inv
            % q
            for c in range(2 * K)
        ]
        out.append((vals[0], vals[1]) if K == 1 else ((vals[0], vals[1]), (vals[2], vals[3])))
    return out


def points_to_limbs(
    points, group: str = "g1", device="cuda", curve: CurveParams = BN254
) -> torch.Tensor:
    """Host affine points (None = identity) -> (N, 3, K, L) projective
    Montgomery limbs (Z = 1, identity (0, 1, 0))."""
    K = GROUPS[group]
    fq = fields_of(curve)[1]
    vals = []
    for pt in points:
        if pt is None:
            coords = [0] * K + [1] + [0] * (K - 1) + [0] * K
        else:
            coords = _components(pt, 0, K) + _components(pt, 1, K) + [1] + [0] * (K - 1)
        vals.extend(coords)
    return fq.tensor(vals, device).reshape(len(points), 3, K, fq.limbs)


def limbs_to_points(t: torch.Tensor, group: str = "g1", curve: CurveParams = BN254) -> list:
    """(N, 3, K, L) projective Montgomery limbs -> host affine points."""
    K = GROUPS[group]
    fq = fields_of(curve)[1]
    q = fq.p
    vals = fq.decode(t.reshape(-1, fq.limbs))
    out = []
    if K == 1:
        for i in range(0, len(vals), 3):
            x, y, z = vals[i : i + 3]
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, q)
                out.append((x * zi % q, y * zi % q))
        return out
    f2 = HostFq2(q)
    for i in range(0, len(vals), 6):
        x, y, z = (tuple(vals[i + 2 * c : i + 2 * c + 2]) for c in range(3))
        if f2.is_zero(z):
            out.append(None)
        else:
            zi = f2.inv(z)
            out.append((f2.mul(x, zi), f2.mul(y, zi)))
    return out


# ---------------------------------------------------------------------------
# work counts: the 32-bit multiply-adds the kernels' bounds count
# ---------------------------------------------------------------------------


def imad_per_mul(limbs: int) -> int:
    """One L-limb CIOS product (`csrc/field.cuh`): 2L² for a·b, 2L² for
    m·p and L for m; 264 at L = 8, 588 at L = 12."""
    return 4 * limbs * limbs + limbs


def imad_per_decode(limbs: int) -> int:
    """One row component's 16-bit reduction step (`csrc/curve.cuh`): the L
    low and L high halves of m·q, and m."""
    return 2 * limbs + 1


# Base-field products of RCB15 Alg 8 (madd), 7 (add) and 9 (dbl), and how
# many of them multiply by 3b
FORMULA_PRODUCTS = {"madd": (13, 2), "add": (14, 2), "dbl": (9, 1)}


def small_b3(group: str, curve: CurveParams = BN254) -> bool:
    """Whether the kernels multiply by 3b with additions: 9 in BN254 G1, 12
    in BLS12-381 G1 and 12·(1 + u) in its G2; BN254 G2's 3/(9 + u) is a
    product."""
    return not (curve.name == "bn254" and group == "g2")


def op_imads(op: str, group: str, curve: CurveParams = BN254) -> int:
    """32-bit multiply-adds of one curve operation as the kernels compute
    it: "madd" (Alg 8, K11), "madd_rows" (Alg 8 and the decode of the row,
    K1), "add" (Alg 7, K2), "dbl" (Alg 9, K5). An Fq2 product is 3 base
    products (Karatsuba)."""
    n, by_b3 = FORMULA_PRODUCTS["madd" if op == "madd_rows" else op]
    K, L = GROUPS[group], limbs_of(curve)
    products = (n - by_b3 * small_b3(group, curve)) * (1 if K == 1 else 3)
    decodes = 2 * K if op == "madd_rows" else 0
    return products * imad_per_mul(L) + decodes * imad_per_decode(L)


# ---------------------------------------------------------------------------
# edge operands: limb patterns at the edges of the field core's chains
# ---------------------------------------------------------------------------


def edge_values(p: int, limbs: int) -> list[int]:
    """Raw limb values in [0, p) at the edges of the carry chains: 0, 1, 2,
    p − 1, p − 2, R mod p, (p ± 1)/2, p less its low limb, the largest value
    whose limbs below the top one are all ones, p's top limb less one over
    all-ones limbs, all-ones and zero limbs in turn, and powers of 2^32."""
    top = p >> (32 * (limbs - 1))
    low_ones = (1 << (32 * (limbs - 1))) - 1
    turns = sum(0xFFFFFFFF << (64 * k) for k in range(limbs // 2))  # limb L−1 is 0
    vals = {
        0, 1, 2, p - 1, p - 2, (1 << (32 * limbs)) % p, (p - 1) // 2, (p + 1) // 2,
        p - (p & 0xFFFFFFFF), low_ones, ((top - 1) << (32 * (limbs - 1))) + low_ones, turns,
        1 << 32, 1 << (32 * (limbs - 1)),
    }
    assert all(0 <= v < p for v in vals)
    return sorted(vals)


def edge_words(p: int, limbs: int) -> list[int]:
    """edge_values and raw words at or above p, below R = 2^(32·L): what a
    row component may hold for the kernels' decode (all ones, p, 2p − 1,
    R − p)."""
    r = 1 << (32 * limbs)
    return sorted(set(edge_values(p, limbs)) | {p, p + 1, 2 * p - 1, 2 * p, r - p, r - 2, r - 1})


def edge_points(n: int, group: str, device, curve: CurveParams = BN254, seed: int = 0):
    """(n, 3, K, L) int32 points whose every component is an edge value of
    Fq, drawn from a seeded generator. The complete formulas are defined
    on any field elements, so the points need not lie on the curve."""
    rng = np.random.default_rng(seed)
    fq = fields_of(curve)[1]
    vals = edge_values(fq.p, fq.limbs)
    pick = rng.integers(0, len(vals), n * 3 * GROUPS[group])
    return fq.tensor([vals[i] for i in pick], device, mont=False).reshape(
        n, 3, GROUPS[group], fq.limbs)


def edge_scan(n: int, k: int, group: str, device, curve: CurveParams = BN254, seed: int = 0):
    """K1's operands from edge patterns: n lanes of edge_points accumulators,
    each scanning up to k rows of a table whose components are edge_words
    (some rows the identity), signs drawn at random. -> (acc, table, perm,
    lane_base, start, length)."""
    rng = np.random.default_rng(seed)
    fq = fields_of(curve)[1]
    K, L, D = GROUPS[group], fq.limbs, row_digits(curve)
    words = edge_words(fq.p, L)
    rows = 4 * n
    table = np.zeros((rows, row_bytes(group, curve)), np.uint8)
    for r, pick in enumerate(rng.integers(0, len(words), (rows, 2 * K))):
        raw = b"".join(words[i].to_bytes(4 * L, "little") + b"\0\0" for i in pick)
        table[r, :-1] = np.frombuffer(raw, np.uint8)
    table[:, -1] = rng.random(rows) > 0.1  # about a tenth identity rows
    pay = rng.integers(0, rows, n * k, dtype=np.int64) | (rng.integers(0, 2, n * k) << 31)
    length = rng.integers(0, k + 1, n)
    length[: min(n, 4)] = k
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64).astype(np.uint32).view(np.int32), device=device)  # noqa: E731
    return (
        edge_points(n, group, device, curve, seed + 1),
        torch.as_tensor(table, device=device),
        i32(pay),
        torch.zeros(n, dtype=torch.int32, device=device),
        i32(np.arange(n) * k),
        i32(length),
    )


def identity(lanes: int, group: str, device, curve: CurveParams = BN254) -> torch.Tensor:
    """(lanes, 3, K, L) identity points."""
    K = GROUPS[group]
    fq = fields_of(curve)[1]
    one = torch.zeros((3, K, fq.limbs), dtype=torch.int32, device=device)
    one[1, 0] = fq.const(1, device)
    return one.expand(lanes, 3, K, fq.limbs).contiguous()


# ---------------------------------------------------------------------------
# plain versions (int64 words; see fields/limbs.py)
# ---------------------------------------------------------------------------


class _PlainCurve:
    """RCB15 complete formulas (a = 0) on (N, K, L) int64 word elements,
    with the independent Montgomery products of each phase batched into
    one call."""

    def __init__(self, group: str, device, curve: CurveParams = BN254):
        self.K = GROUPS[group]
        self.curve = curve
        fq = self.fq = fields_of(curve)[1]
        b = [curve.b] if self.K == 1 else list(curve.b2)
        b3 = fq.tensor([3 * v % fq.p for v in b], device).to(torch.int64) & 0xFFFFFFFF
        self.b3 = b3.reshape(1, self.K, fq.limbs)

    def add(self, a, b):
        return add_words(a, b, self.fq)

    def sub(self, a, b):
        return sub_words(a, b, self.fq)

    def mul_many(self, pairs):
        pairs = [torch.broadcast_tensors(a, b) for a, b in pairs]
        A = torch.cat([a for a, _ in pairs])
        B = torch.cat([b for _, b in pairs])
        fq = self.fq
        if self.K == 1:
            out = mont_mul_words(A, B, fq)
        else:
            a0, a1, b0, b1 = A[:, 0], A[:, 1], B[:, 0], B[:, 1]
            pr = mont_mul_words(
                torch.stack([a0, a1, a0, a1]), torch.stack([b0, b1, b1, b0]), fq
            )
            out = torch.stack(
                [sub_words(pr[0], pr[1], fq), add_words(pr[2], pr[3], fq)], dim=1
            )
        return torch.split(out, [a.shape[0] for a, _ in pairs])

    def _tail(self, t0, t1, t3, t4, y3p, z1_or_t2):
        """Shared end of Alg 7 and Alg 8 from the phase-1 products."""
        t0p = self.add(self.add(t0, t0), t0)
        t2p, y3 = self.mul_many([(self.b3, z1_or_t2), (self.b3, y3p)])
        z3p = self.add(t1, t2p)
        t1p = self.sub(t1, t2p)
        m = self.mul_many(
            [(t3, t1p), (t4, y3), (t1p, z3p), (y3, t0p), (z3p, t4), (t0p, t3)]
        )
        return torch.stack(
            [self.sub(m[0], m[1]), self.add(m[2], m[3]), self.add(m[4], m[5])], dim=1
        )

    def madd(self, P, qx, qy):
        """Alg 8: P (N, 3, K, L) + affine (qx, qy) (N, K, L)."""
        X1, Y1, Z1 = P[:, 0], P[:, 1], P[:, 2]
        t0, t1, m4, yz, xz = self.mul_many(
            [(X1, qx), (Y1, qy), (self.add(X1, Y1), self.add(qx, qy)), (qy, Z1), (qx, Z1)]
        )
        t3 = self.sub(m4, self.add(t0, t1))
        return self._tail(t0, t1, t3, self.add(yz, Y1), self.add(xz, X1), Z1)

    def padd(self, P, Q):
        """Alg 7: P + Q, both (N, 3, K, L)."""
        X1, Y1, Z1 = P[:, 0], P[:, 1], P[:, 2]
        X2, Y2, Z2 = Q[:, 0], Q[:, 1], Q[:, 2]
        t0, t1, t2, m4, m5, m6 = self.mul_many(
            [
                (X1, X2),
                (Y1, Y2),
                (Z1, Z2),
                (self.add(X1, Y1), self.add(X2, Y2)),
                (self.add(Y1, Z1), self.add(Y2, Z2)),
                (self.add(X1, Z1), self.add(X2, Z2)),
            ]
        )
        t3 = self.sub(m4, self.add(t0, t1))
        t4 = self.sub(m5, self.add(t1, t2))
        y3p = self.sub(m6, self.add(t0, t2))
        return self._tail(t0, t1, t3, t4, y3p, t2)

    def pdbl(self, P):
        """Alg 9: 2P, P (N, 3, K, L)."""
        X, Y, Z = P[:, 0], P[:, 1], P[:, 2]
        t0, t1, zz, xy = self.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        (t2,) = self.mul_many([(self.b3, zz)])
        z8 = self.add(t0, t0)
        z8 = self.add(z8, z8)
        z8 = self.add(z8, z8)
        t0n = self.sub(t0, self.add(self.add(t2, t2), t2))
        x3, z3, m, xyn = self.mul_many(
            [(t2, z8), (t1, z8), (t0n, self.add(t0, t2)), (t0n, xy)]
        )
        return torch.stack([self.add(xyn, xyn), self.add(x3, m), z3], dim=1)

    def decode_rows(self, rows: torch.Tensor):
        """(M, row_bytes) uint8 -> (qx, qy) (M, K, L) words at R = 2^(32·L).
        The rows' radix is 2^16 above the limbs' on both curves (2^272 over
        2^256, 2^400 over 2^384), so one 16-bit reduction step moves the
        value (K1 multiplies by 2^(32·L − 16) instead)."""
        K, L, D = self.K, self.fq.limbs, row_digits(self.curve)
        assert 8 * D - 32 * L == 16
        b = rows[:, : 2 * K * D].reshape(-1, 2 * K, D)[:, :, : 4 * L]
        b = b.to(torch.int64).reshape(-1, 2 * K, L, 4)
        w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)  # (M, 2K, L)
        w = div_r16_words(w, self.fq)
        return w[:, :K], w[:, K:]

    def signed_rows(self, rows: torch.Tensor, pay: torch.Tensor):
        """Decoded rows with y negated where the payload's bit 31 is set."""
        qx, qy = self.decode_rows(rows)
        neg = (pay >> 31).bool()
        if bool(neg.any()):
            zero = torch.zeros_like(qy[neg])
            qy[neg] = sub_words(zero, qy[neg], self.fq)
        return qx, qy


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _madd_step(pc: _PlainCurve, P, rows, pay):
    return pc.madd(P, *pc.signed_rows(rows, pay))


def scan_rows_plain(
    acc, table, perm, lane_base, start, length, i0: int, k_steps: int, group: str,
    curve: CurveParams, step,
) -> torch.Tensor:
    """K1's loop on masked lane subsets: at each step i, the lanes whose run
    reaches i on a row that is not the identity take
    P <- step(pc, P, rows, payloads) (int64 words)."""
    pc = _PlainCurve(group, acc.device, curve)
    out = _words(acc).clone()
    flag_at = row_bytes(group, curve) - 1
    base = lane_base.to(torch.int64) + start.to(torch.int64)
    length = length.to(torch.int64)
    perm = perm.to(torch.int64) & 0xFFFFFFFF
    stop = min(i0 + k_steps, int(length.max()) if length.numel() else 0)
    for i in range(i0, stop):
        lanes = torch.nonzero(length > i).flatten()
        pay = perm[base[lanes] + i]
        rows = table[pay & 0x7FFFFFFF]
        keep = rows[:, flag_at] != 0
        lanes, pay, rows = lanes[keep], pay[keep], rows[keep]
        if lanes.numel() == 0:
            continue
        out[lanes] = step(pc, out[lanes], rows, pay)
    return from_words(out)


def bucket_madd_rows_plain(
    acc, table, perm, lane_base, start, length, i0: int, k_steps: int, group: str,
    curve: CurveParams = BN254,
) -> torch.Tensor:
    """Plain version of K1: the same function, on masked lane subsets."""
    return scan_rows_plain(
        acc, table, perm, lane_base, start, length, i0, k_steps, group, curve, _madd_step
    )


def decode_rows(rows: torch.Tensor, group: str, curve: CurveParams = BN254):
    """(M, row_bytes) uint8 rows -> affine (x, y), each (M, K, L) int32
    limbs in the port's format (plain torch ops, on the rows' device). An
    identity row decodes to (0, 1), which no kernel may add."""
    qx, qy = _PlainCurve(group, rows.device, curve).decode_rows(rows)
    return from_words(qx).contiguous(), from_words(qy).contiguous()


def masked_mixed_add_plain(p, x2, y2, mask, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K11."""
    pc = _PlainCurve(group, p.device, curve)
    out = _words(p).clone()
    lanes = torch.nonzero(mask).flatten()
    if lanes.numel():
        out[lanes] = pc.madd(out[lanes], _words(x2[lanes]), _words(y2[lanes]))
    return from_words(out)


def masked_add_plain(p, q, mask, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K2."""
    pc = _PlainCurve(group, p.device, curve)
    out = _words(p).clone()
    lanes = torch.nonzero(mask).flatten()
    if lanes.numel():
        out[lanes] = pc.padd(out[lanes], _words(q[lanes]))
    return from_words(out)


def point_add_plain(p, q, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K2 without a mask."""
    return from_words(_PlainCurve(group, p.device, curve).padd(_words(p), _words(q)))


def point_double_plain(p, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K5."""
    return from_words(_PlainCurve(group, p.device, curve).pdbl(_words(p)))


def horner_combine_plain(sums, c: int, group: str, curve: CurveParams = BN254) -> torch.Tensor:
    """Plain version of K18: from the identity, top window first, c
    doublings (Alg 9) and one add (Alg 7) of sums[w] a window; the chain
    of point_double_plain and point_add_plain. -> (3, K, L)."""
    pc = _PlainCurve(group, sums.device, curve)
    s = _words(sums)
    acc = _words(identity(1, group, sums.device, curve))
    for w in range(s.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = pc.pdbl(acc)
        acc = pc.padd(acc, s[w : w + 1])
    return from_words(acc[0])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_points(t: torch.Tensor, group: str, name: str, curve: CurveParams) -> int:
    K, L = GROUPS[group], limbs_of(curve)
    if t.dtype != torch.int32 or t.dim() != 4 or tuple(t.shape[1:]) != (3, K, L):
        raise ValueError(f"{name}: want int32 (lanes, 3, {K}, {L}), got {t.dtype} {tuple(t.shape)}")
    return t.shape[0]


def _check_aligned(group: str, *tensors: torch.Tensor) -> None:
    """K2 reads G2 points as 16-byte vectors (`csrc/curve.cuh` MemPoint)."""
    for t in tensors:
        if group == "g2" and t.data_ptr() % 16:
            raise ValueError("K2's G2 points must start on a 16-byte boundary")


def _check_vec(t: torch.Tensor, n: int, name: str, dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 1 or (n >= 0 and t.shape[0] != n):
        raise ValueError(f"{name}: want {dtype} ({n},), got {t.dtype} {tuple(t.shape)}")


def check_scan(acc, table, perm, lane_base, start, length, group: str, curve: CurveParams) -> int:
    """K1's operands: (lanes, 3, K, L) int32 accumulators, (N, row_bytes)
    uint8 rows, int32 vectors. -> lanes."""
    lanes = _check_points(acc, group, "acc", curve)
    rb = row_bytes(group, curve)
    if table.dtype != torch.uint8 or table.dim() != 2 or table.shape[1] != rb:
        raise ValueError(f"table: want uint8 (N, {rb}), got {table.dtype} {tuple(table.shape)}")
    _check_vec(perm, -1, "perm")
    for name, t in (("lane_base", lane_base), ("start", start), ("length", length)):
        _check_vec(t, lanes, name)
    return lanes


def _launch(kernel: str, counter: str, curve: CurveParams, group: str, *args) -> None:
    _native.launch(
        kernel, _native.counter_name(counter, curve.name, group),
        _native.CURVE_CODES[curve.name], GROUPS[group], *args,
    )


def bucket_madd_rows(
    acc: torch.Tensor,
    table: torch.Tensor,
    perm: torch.Tensor,
    lane_base: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    i0: int,
    k_steps: int,
    group: str = "g1",
    curve: CurveParams = BN254,
) -> torch.Tensor:
    """K1: for every lane l, add the rows perm[lane_base + start + i] for
    i in [i0, min(i0 + k_steps, length)) into acc[l] (mixed add; a payload
    with bit 31 set adds the negated point; identity rows are skipped).
    Returns the new accumulators."""
    _native.require_ported("bucket_madd_rows", curve.name)
    lanes = check_scan(acc, table, perm, lane_base, start, length, group, curve)
    if acc.device.type == "cpu":
        return bucket_madd_rows_plain(
            acc, table, perm, lane_base, start, length, i0, k_steps, group, curve
        )
    _native.require_cuda(acc, table, perm, lane_base, start, length)
    out = torch.empty_like(acc)
    _launch(
        "bucket_madd_rows", "bucket_madd_rows", curve, group,
        acc.data_ptr(), out.data_ptr(), table.data_ptr(), table.shape[1], perm.data_ptr(),
        lane_base.data_ptr(), start.data_ptr(), length.data_ptr(), lanes, int(i0), int(k_steps),
    )
    return out


def masked_add(
    p: torch.Tensor, q: torch.Tensor, mask: torch.Tensor, group: str = "g1",
    curve: CurveParams = BN254,
) -> torch.Tensor:
    """K2: mask ? p + q : p per lane (complete projective add)."""
    _native.require_ported("masked_add", curve.name)
    lanes = _check_points(p, group, "p", curve)
    if _check_points(q, group, "q", curve) != lanes:
        raise ValueError("p and q differ in lanes")
    _check_vec(mask, lanes, "mask", torch.bool)
    if p.device.type == "cpu":
        return masked_add_plain(p, q, mask, group, curve)
    _native.require_cuda(p, q, mask)
    _check_aligned(group, p, q)
    out = torch.empty_like(p)
    _launch(
        "masked_add", "masked_add", curve, group,
        p.data_ptr(), q.data_ptr(), mask.data_ptr(), out.data_ptr(), lanes,
    )
    return out


def masked_mixed_add(
    p: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor, mask: torch.Tensor,
    group: str = "g1", curve: CurveParams = BN254,
) -> torch.Tensor:
    """K11: mask ? p + (x2, y2) : p per lane (RCB15 Alg 8, complete mixed
    add). p is projective (lanes, 3, K, L), Q = (x2, y2) affine, each
    (lanes, K, L), mask (lanes,) bool. The caller clears the mask wherever
    Q is the identity, which affine coordinates cannot encode. The
    counterpart of `snark_tpu/ops/pallas_curve.py` `make_masked_mixed_add`."""
    _native.require_ported("masked_mixed_add", curve.name)
    lanes = _check_points(p, group, "p", curve)
    K, L = GROUPS[group], limbs_of(curve)
    for name, t in (("x2", x2), ("y2", y2)):
        if t.dtype != torch.int32 or tuple(t.shape) != (lanes, K, L):
            raise ValueError(f"{name}: want int32 ({lanes}, {K}, {L}), got {t.dtype} {tuple(t.shape)}")
    _check_vec(mask, lanes, "mask", torch.bool)
    if p.device.type == "cpu":
        return masked_mixed_add_plain(p, x2, y2, mask, group, curve)
    _native.require_cuda(p, x2, y2, mask)
    out = torch.empty_like(p)
    _launch(
        "masked_mixed_add", "masked_mixed_add", curve, group,
        p.data_ptr(), x2.data_ptr(), y2.data_ptr(), mask.data_ptr(), out.data_ptr(), lanes,
    )
    return out


def point_add(
    p: torch.Tensor, q: torch.Tensor, group: str = "g1", curve: CurveParams = BN254
) -> torch.Tensor:
    """K2 with no mask: p + q per lane (complete projective add)."""
    _native.require_ported("masked_add", curve.name)
    lanes = _check_points(p, group, "p", curve)
    if _check_points(q, group, "q", curve) != lanes:
        raise ValueError("p and q differ in lanes")
    if p.device.type == "cpu":
        return point_add_plain(p, q, group, curve)
    _native.require_cuda(p, q)
    _check_aligned(group, p, q)
    out = torch.empty_like(p)
    _launch(
        "masked_add", "point_add", curve, group,
        p.data_ptr(), q.data_ptr(), None, out.data_ptr(), lanes,
    )
    return out


def horner_combine(
    sums: torch.Tensor, c: int, group: str = "g1", curve: CurveParams = BN254
) -> torch.Tensor:
    """K18: Horner over the window totals sums (W, 3, K, L), top window
    first, from the identity: acc = 2^c acc + sums[w] -> (3, K, L)
    projective, canonical. One launch of one warp for the whole combine."""
    _native.require_ported("horner_combine", curve.name)
    windows = _check_points(sums, group, "sums", curve)
    if windows < 1 or c < 0:
        raise ValueError(f"horner_combine: want W >= 1 and c >= 0, got W = {windows}, c = {c}")
    if sums.device.type == "cpu":
        return horner_combine_plain(sums, c, group, curve)
    _native.require_cuda(sums)
    out = torch.empty((3, GROUPS[group], limbs_of(curve)), dtype=torch.int32, device=sums.device)
    _launch("horner_combine", "horner_combine", curve, group, sums.data_ptr(), out.data_ptr(),
            windows, int(c))
    return out


def horner_chain(sums, c: int, group: str, curve: CurveParams = BN254, double=None, add=None):
    """The combine one group operation at a time, as it ran before K18:
    from the identity, top window first, c calls of double and one of add
    a window -> (3, K, L). double and add default to K5 and K2 without a
    mask; point_double_plain and point_add_plain make it the chain of
    their plain versions."""
    double, add = double or point_double, add or point_add
    acc = identity(1, group, sums.device, curve)
    for w in range(sums.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = double(acc, group, curve)
        acc = add(acc, sums[w : w + 1], group, curve)
    return acc[0]


def horner_cases(W: int, c: int, group: str, device, curve: CurveParams = BN254, seed: int = 0):
    """Window totals at the edges of the Horner combine -> [(name, sums,
    c)]: every total the identity; random multiples of the generator with
    two equal totals, with T and −T in adjacent windows, with a top total T
    and the next 2^c·T (the add meets its own point: a doubling) or
    −2^c·T (it meets its inverse: the identity); one window; c = 1; and
    limb patterns at the field core's edges (`edge_points`, not curve
    points: the complete formulas take any field elements)."""
    import random

    from .curve_host import host_g1, host_g2

    hc = host_g1(curve) if group == "g1" else host_g2(curve)
    rng = random.Random(seed)
    r = curve.fr.modulus
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(W)]
    top = pts[-1]
    top_c = hc.scalar_mul(top, 1 << c)
    k = W // 2
    cases = [
        ("identity", [None] * W, c),
        ("equal", pts[:k] + [pts[k + 1]] + pts[k + 1 :], c),
        ("negated", pts[:k] + [hc.neg(pts[k + 1])] + pts[k + 1 :], c),
        ("doubling", pts[:-2] + [top_c, top], c),
        ("inverse", pts[:-2] + [hc.neg(top_c), top], c),
        ("one_window", pts[:1], c),
        ("c1", pts, 1),
    ]
    out = [(name, points_to_limbs(p, group, device, curve), cc) for name, p, cc in cases]
    return out + [("edge_limbs", edge_points(W, group, device, curve, seed), c)]


def point_double(p: torch.Tensor, group: str = "g1", curve: CurveParams = BN254) -> torch.Tensor:
    """K5: 2p per lane (complete projective double)."""
    _native.require_ported("point_double", curve.name)
    lanes = _check_points(p, group, "p", curve)
    if p.device.type == "cpu":
        return point_double_plain(p, group, curve)
    _native.require_cuda(p)
    out = torch.empty_like(p)
    _launch("point_double", "point_double", curve, group, p.data_ptr(), out.data_ptr(), lanes)
    return out
