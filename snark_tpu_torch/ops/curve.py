"""Curve kernels K1 (`bucket_madd_rows`) and K2 (`masked_add`), their plain
PyTorch versions, and the codecs between host points, the reference's u8
row tables and the port's projective limb tensors.

A batch of points is an int32 tensor (lanes, 3, K, 8): projective X, Y, Z,
each K base-field elements (K = 1 for G1 over Fq, 2 for G2 over Fq2) of 8
u32 limbs in Montgomery form, R = 2^256 (`fields/limbs.py`). The identity
is (0, 1, 0).

The reference's tables (`ProvingKey.*_tbl`) are u8 rows of width
2·K·34 + 1: X digits ‖ Y digits ‖ identity flag, each component the 34
little-endian bytes of x·2^272 mod q ("wide" Montgomery, canonical). K1
reads them as they are; `rows_to_points` and `pack_rows_u8` convert on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _native
from ..fields.limbs import FQ, add_words, from_words, mont_mul_words, sub_words
from ..fields.params import BN254
from ..fields.towers import Fq2 as HostFq2

ROW_DIGITS = 34  # base-256 digits per component in the reference's rows
R_WIDE = 1 << (8 * ROW_DIGITS)  # the rows' Montgomery radix, 2^272
GROUPS = {"g1": 1, "g2": 2}  # group name -> K (base-field components)


def row_bytes(group: str) -> int:
    return 2 * GROUPS[group] * ROW_DIGITS + 1


# ---------------------------------------------------------------------------
# host codecs
# ---------------------------------------------------------------------------


def _components(pt, idx: int, K: int) -> list[int]:
    return [pt[idx]] if K == 1 else list(pt[idx])


def pack_rows_u8(points, group: str = "g1") -> np.ndarray:
    """Host affine points (None = identity) -> (N, 2·K·34+1) uint8 rows in
    the reference's layout (byte-identical to its `pack_rows_u8_host`)."""
    K = GROUPS[group]
    q = FQ.p
    one_wide = R_WIDE % q
    out = np.zeros((len(points), row_bytes(group)), np.uint8)
    for i, pt in enumerate(points):
        if pt is None:
            vals = [0] * K + [one_wide] + [0] * (K - 1)
            flag = 0
        else:
            vals = [v * R_WIDE % q for v in _components(pt, 0, K) + _components(pt, 1, K)]
            flag = 1
        buf = b"".join(v.to_bytes(ROW_DIGITS, "little") for v in vals)
        out[i, :-1] = np.frombuffer(buf, np.uint8)
        out[i, -1] = flag
    return out


def rows_to_points(rows: np.ndarray, group: str = "g1") -> list:
    """(N, 2·K·34+1) uint8 rows -> host affine points (None = identity)."""
    K = GROUPS[group]
    q = FQ.p
    r_inv = pow(R_WIDE, -1, q)
    rows = np.asarray(rows, np.uint8)
    out = []
    for row in rows:
        if row[-1] == 0:
            out.append(None)
            continue
        raw = row[:-1].tobytes()
        vals = [
            int.from_bytes(raw[ROW_DIGITS * c : ROW_DIGITS * (c + 1)], "little")
            * r_inv
            % q
            for c in range(2 * K)
        ]
        out.append((vals[0], vals[1]) if K == 1 else ((vals[0], vals[1]), (vals[2], vals[3])))
    return out


def points_to_limbs(points, group: str = "g1", device="cpu") -> torch.Tensor:
    """Host affine points (None = identity) -> (N, 3, K, 8) projective
    Montgomery limbs (Z = 1, identity (0, 1, 0))."""
    K = GROUPS[group]
    vals = []
    for pt in points:
        if pt is None:
            coords = [0] * K + [1] + [0] * (K - 1) + [0] * K
        else:
            coords = _components(pt, 0, K) + _components(pt, 1, K) + [1] + [0] * (K - 1)
        vals.extend(coords)
    return FQ.tensor(vals, device).reshape(len(points), 3, K, 8)


def limbs_to_points(t: torch.Tensor, group: str = "g1") -> list:
    """(N, 3, K, 8) projective Montgomery limbs -> host affine points."""
    K = GROUPS[group]
    q = FQ.p
    vals = FQ.decode(t.reshape(-1, 8))
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


def identity(lanes: int, group: str, device) -> torch.Tensor:
    """(lanes, 3, K, 8) identity points."""
    K = GROUPS[group]
    one = torch.zeros((3, K, 8), dtype=torch.int32, device=device)
    one[1, 0] = FQ.const(1, device)
    return one.expand(lanes, 3, K, 8).contiguous()


# ---------------------------------------------------------------------------
# plain versions (int64 words; see fields/limbs.py)
# ---------------------------------------------------------------------------


class _PlainCurve:
    """RCB15 complete formulas (a = 0) on (N, K, 8) int64 word elements,
    with the independent Montgomery products of each phase batched into
    one call."""

    def __init__(self, group: str, device):
        self.K = GROUPS[group]
        q = FQ.p
        b = [BN254.b] if self.K == 1 else list(BN254.b2)
        b3 = FQ.tensor([3 * v % q for v in b], device).to(torch.int64) & 0xFFFFFFFF
        self.b3 = b3.reshape(1, self.K, 8)
        self.row_c = (
            FQ.const(1 << 240, device, mont=False).to(torch.int64) & 0xFFFFFFFF
        )

    def add(self, a, b):
        return add_words(a, b, FQ)

    def sub(self, a, b):
        return sub_words(a, b, FQ)

    def mul_many(self, pairs):
        pairs = [torch.broadcast_tensors(a, b) for a, b in pairs]
        A = torch.cat([a for a, _ in pairs])
        B = torch.cat([b for _, b in pairs])
        if self.K == 1:
            out = mont_mul_words(A, B, FQ)
        else:
            a0, a1, b0, b1 = A[:, 0], A[:, 1], B[:, 0], B[:, 1]
            pr = mont_mul_words(
                torch.stack([a0, a1, a0, a1]), torch.stack([b0, b1, b1, b0]), FQ
            )
            out = torch.stack(
                [sub_words(pr[0], pr[1], FQ), add_words(pr[2], pr[3], FQ)], dim=1
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
        """Alg 8: P (N, 3, K, 8) + affine (qx, qy) (N, K, 8)."""
        X1, Y1, Z1 = P[:, 0], P[:, 1], P[:, 2]
        t0, t1, m4, yz, xz = self.mul_many(
            [(X1, qx), (Y1, qy), (self.add(X1, Y1), self.add(qx, qy)), (qy, Z1), (qx, Z1)]
        )
        t3 = self.sub(m4, self.add(t0, t1))
        return self._tail(t0, t1, t3, self.add(yz, Y1), self.add(xz, X1), Z1)

    def padd(self, P, Q):
        """Alg 7: P + Q, both (N, 3, K, 8)."""
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

    def decode_rows(self, rows: torch.Tensor):
        """(M, row_bytes) uint8 -> (qx, qy) (M, K, 8) words at R = 2^256."""
        K = self.K
        comps = [
            rows[:, ROW_DIGITS * c : ROW_DIGITS * c + 32].contiguous().view(torch.int32)
            for c in range(2 * K)
        ]
        w = torch.stack(comps, dim=1).to(torch.int64) & 0xFFFFFFFF  # (M, 2K, 8)
        w = mont_mul_words(w, self.row_c, FQ)
        return w[:, :K], w[:, K:]


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def bucket_madd_rows_plain(
    acc, table, perm, lane_base, start, length, i0: int, k_steps: int, group: str
) -> torch.Tensor:
    """Plain version of K1: the same function, on masked lane subsets."""
    pc = _PlainCurve(group, acc.device)
    out = _words(acc).clone()
    flag_at = row_bytes(group) - 1
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
        qx, qy = pc.decode_rows(rows)
        neg = (pay >> 31).bool()
        if bool(neg.any()):
            zero = torch.zeros_like(qy[neg])
            qy[neg] = sub_words(zero, qy[neg], FQ)
        out[lanes] = pc.madd(out[lanes], qx, qy)
    return from_words(out)


def masked_add_plain(p, q, mask, group: str) -> torch.Tensor:
    """Plain version of K2."""
    pc = _PlainCurve(group, p.device)
    out = _words(p).clone()
    lanes = torch.nonzero(mask).flatten()
    if lanes.numel():
        out[lanes] = pc.padd(out[lanes], _words(q[lanes]))
    return from_words(out)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_points(t: torch.Tensor, group: str, name: str) -> int:
    K = GROUPS[group]
    if t.dtype != torch.int32 or t.dim() != 4 or tuple(t.shape[1:]) != (3, K, 8):
        raise ValueError(f"{name}: want int32 (lanes, 3, {K}, 8), got {t.dtype} {tuple(t.shape)}")
    return t.shape[0]


def _check_vec(t: torch.Tensor, n: int, name: str, dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 1 or (n >= 0 and t.shape[0] != n):
        raise ValueError(f"{name}: want {dtype} ({n},), got {t.dtype} {tuple(t.shape)}")


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
) -> torch.Tensor:
    """K1: for every lane l, add the rows perm[lane_base + start + i] for
    i in [i0, min(i0 + k_steps, length)) into acc[l] (mixed add; a payload
    with bit 31 set adds the negated point; identity rows are skipped).
    Returns the new accumulators."""
    lanes = _check_points(acc, group, "acc")
    if table.dtype != torch.uint8 or table.dim() != 2 or table.shape[1] != row_bytes(group):
        raise ValueError(f"table: want uint8 (N, {row_bytes(group)}), got {table.dtype} {tuple(table.shape)}")
    _check_vec(perm, -1, "perm")
    for name, t in (("lane_base", lane_base), ("start", start), ("length", length)):
        _check_vec(t, lanes, name)
    if acc.device.type == "cpu":
        return bucket_madd_rows_plain(
            acc, table, perm, lane_base, start, length, i0, k_steps, group
        )
    _native.require_cuda(acc, table, perm, lane_base, start, length)
    out = torch.empty_like(acc)
    _native.launch(
        "bucket_madd_rows",
        "bucket_madd_rows_" + group,
        GROUPS[group],
        acc.data_ptr(),
        out.data_ptr(),
        table.data_ptr(),
        table.shape[1],
        perm.data_ptr(),
        lane_base.data_ptr(),
        start.data_ptr(),
        length.data_ptr(),
        lanes,
        int(i0),
        int(k_steps),
    )
    return out


def masked_add(
    p: torch.Tensor, q: torch.Tensor, mask: torch.Tensor, group: str = "g1"
) -> torch.Tensor:
    """K2: mask ? p + q : p per lane (complete projective add)."""
    lanes = _check_points(p, group, "p")
    if _check_points(q, group, "q") != lanes:
        raise ValueError("p and q differ in lanes")
    _check_vec(mask, lanes, "mask", torch.bool)
    if p.device.type == "cpu":
        return masked_add_plain(p, q, mask, group)
    _native.require_cuda(p, q, mask)
    out = torch.empty_like(p)
    _native.launch(
        "masked_add", "masked_add_" + group, GROUPS[group], p.data_ptr(), q.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lanes,
    )
    return out
