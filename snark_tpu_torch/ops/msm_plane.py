"""Pippenger MSM over the curve kernels, signed or unsigned digits.

Counterpart of the JAX package's `ops/msm_plane.py` `PlaneMsm`: the same
replica-slot sort keys, sort and searchsorted into buckets, the bucket
accumulation (the scan with its rank-split spill, or the batch-affine tree
of `ops/msm_affine.py`), the replica and suffix folds, and the Horner
combine over the window totals, on the device (`msm`) or on the host
(`msm_host`). The group arithmetic is K1 (`bucket_madd_rows`, the scan),
K2 (`masked_add`, the folds), K6-K8 (the affine tree) and K18
(`horner_combine`, the whole device combine in one launch).

Signed digits (the prover's): bucket b holds |digit| = b + 1 (cb = c − 1
bucket bits), zero digits are dropped and a digit's sign rides bit 31 of
the gather payload. Unsigned digits: bucket b holds digit b (cb = c), and
bucket 0 is emptied. Per window, bucket b of a window with only `bits` < cb
digit bits is split over 2^r replica slots (r = cb − bits, slot =
b·2^r | (i mod 2^r)), so every window has 2^cb slots of even expected
size. The scan runs one K1 launch over all W·2^cb lanes: lane l adds its
bucket's run of sorted rows. The longest runs would set the launch's time,
so runs longer than T1 = mean + 1.5·sqrt(mean) among the S2 longest are
cut at T1 and their overflow is split evenly over the spill lanes, which a
second K1 launch scans; segmented K2 folds bring the partial sums back.
Real witnesses need this: the MulChain witness puts about 5% of N into
single buckets. `part` picks the body of both K1 launches
(`ops/madd_parts.py`): the shipped one by default, a variant of
`bench_madd_parts` otherwise, as the reference's one rows kernel carries
the body the script swaps in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.params import BN254, CurveParams
from .curve import GROUPS, horner_combine, identity, limbs_of, limbs_to_points, masked_add
from .madd_parts import bucket_madd_rows_part

_SIGN = 1 << 31
SPILL_BUCKETS = 2048  # most buckets a scan spills (the reference's default)
AFFINE_MIN_MEAN = 8  # the affine tree runs when n >= 8 · 2^cb (the reference's gate)


class PlaneMsm:
    """Bucket MSM for one (c, num_bits, group, digit mode, curve). With
    `affine=True` the buckets are accumulated by the batch-affine tree
    wherever the mean bucket holds at least 8 elements, else by the scan;
    `part` is K1's body (`ops/madd_parts.py` PARTS; the prover's is
    "full")."""

    def __init__(
        self,
        c: int,
        num_bits: int = 254,
        group: str = "g1",
        signed: bool = True,
        affine: bool = False,
        curve: CurveParams = BN254,
        part: str = "full",
    ):
        self.c = c
        self.part = part
        self.group = group
        self.curve = curve
        self.K = GROUPS[group]
        self.L = limbs_of(curve)
        self.num_bits = num_bits
        self.signed = signed
        self.affine = affine
        cb = self.cb = c - 1 if signed else c
        nb = self.nb = 1 << cb
        if signed:
            w_u = -(-num_bits // c)
            b_top = num_bits - (w_u - 1) * c
            if b_top >= c:
                W = w_u + 1
                bits_w = [cb] * w_u + [0]
            else:
                W = w_u
                bits_w = [cb] * (W - 1) + [min(b_top, cb)]
        else:
            W = -(-num_bits // c)
            bits_w = [min(c, num_bits - w * c) for w in range(W)]
        self.W = W
        self.lanes = W * nb
        r_w = np.array([cb - b for b in bits_w], dtype=np.int64)
        self.mult = (1 << r_w).reshape(W, 1)  # replicas per bucket
        slot = np.arange(nb, dtype=np.int64)[None, :]
        rw = r_w[:, None]
        self.max_r = int(r_w.max())
        # replica collapse, step j: slot += slot + 2^j where r > j and
        # slot % 2^(j+1) == 0
        self.collapse = [
            ((rw > j) & (slot % (1 << (j + 1)) == 0)).reshape(-1)
            for j in range(self.max_r)
        ]
        # suffix scan, step k (stride 2^k): on the window's coarse grid,
        # with the rolled-in neighbour inside the window
        self.scan = [
            (((1 << k) >= self.mult) & (slot % self.mult == 0) & (slot + (1 << k) < nb)).reshape(-1)
            for k in range(cb)
        ]
        # unsigned: the slots of digit 0 (emptied before the scan)
        self.bucket0 = (slot < self.mult).reshape(-1)
        # spill lanes: about a tenth of the bucket lanes, in steps of 256
        self.spill_lanes = (
            max(1, (self.lanes // 10) // 256) * 256 if self.lanes >= 2048 else 0
        )
        self._affine = None

    # -- phase 1-2: sort into buckets ----------------------------------------
    def sort_keys(self, digits_t: torch.Tensor):
        """(W, N) digits -> (keys, payload): key = bucket·2^r | (i mod 2^r).
        Signed: bucket |digit| − 1, zero digits past the last bucket (key
        nb), the digit's sign in payload bit 31. Unsigned: bucket = digit.
        The payload is the row index (int32 holding the u32 bits)."""
        W, n = digits_t.shape
        dev = digits_t.device
        iota = torch.arange(n, dtype=torch.int64, device=dev).expand(W, n)
        mult = torch.as_tensor(self.mult, device=dev)
        d = digits_t.to(torch.int64)
        if not self.signed:
            return d * mult + (iota & (mult - 1)), iota.to(torch.int32)
        mag = d.abs()
        keys = torch.where(mag == 0, self.nb, (mag - 1) * mult + (iota & (mult - 1)))
        payload = iota | torch.where(digits_t < 0, _SIGN, 0)
        payload = torch.where(payload >= _SIGN, payload - (1 << 32), payload)
        return keys, payload.to(torch.int32)

    def _buckets(self, digits_t: torch.Tensor):
        """-> (perm, start, length): the flat sort payload and each lane's
        run in it."""
        W, n = digits_t.shape
        keys, payload = self.sort_keys(digits_t)
        keys_sorted, order = torch.sort(keys, dim=1, stable=True)
        perm = torch.gather(payload, 1, order).reshape(-1).contiguous()
        targets = torch.arange(self.nb + 1, device=keys.device).expand(W, self.nb + 1)
        bounds = torch.searchsorted(keys_sorted, targets.contiguous())
        start = bounds[:, :-1].reshape(-1)
        length = (bounds[:, 1:] - bounds[:, :-1]).reshape(-1)
        if not self.signed:  # digit 0 adds nothing
            length = torch.where(torch.as_tensor(self.bucket0, device=length.device), 0, length)
        return perm, start, length

    # -- phase 3: bucket scan + spill -----------------------------------------
    def spill_plan(self, length: torch.Tensor, mean: int):
        """-> (eff_len, spill): the main scan's run lengths, and for the
        spill (None when nothing spills) the cut T1 and the top-S2 buckets
        (top lengths, their lanes, which of them spill). `mean` is the
        expected run length."""
        S = self.spill_lanes
        lanes = length.shape[0]
        S2 = min(SPILL_BUCKETS, max(1, S // 4))
        if not 0 < S < lanes:
            return length, None
        T1 = int(mean + max(2, int(1.5 * mean**0.5)))
        top_vals, top_idx = torch.topk(length, S2)
        t_star = max(T1, int(top_vals[S2 - 1]))
        spilled = top_vals > t_star
        if not bool(spilled.any()):
            return length, None
        eff_len = torch.where(length > t_star, length.clamp(max=T1), length)
        return eff_len, (T1, top_vals, top_idx, spilled)

    def run_scan(self, table, perm, lane_base, start, length, mean: int):
        """Phase 3 over any element source: lane l adds the rows
        perm[lane_base[l] + start[l] + i], i < length[l], of `table`. The
        bucket scan passes the sort payload with window offsets; the affine
        path passes its block partials (perm = iota, lane_base = 0)."""
        dev = table.device
        lanes = length.shape[0]
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        lane_base = i32(lane_base)
        eff_len, spill = self.spill_plan(length, mean)
        acc = bucket_madd_rows_part(
            self.part, identity(lanes, self.group, dev, self.curve), table, perm, lane_base,
            i32(start), i32(eff_len), 0, int(eff_len.max()), self.group, self.curve,
        )
        if spill is None:
            return acc
        T1, top_vals, top_idx, spilled = spill
        S = self.spill_lanes
        S2 = top_vals.shape[0]
        # overflow of each spilled bucket, padded to whole chunks, is dealt
        # to the S spill lanes in proportion: lane (b, j) scans
        # [start_b + T1 + j·chunk, + chunk)
        ov = torch.where(spilled, top_vals - T1, 0)
        chunk = max(1, -(-int(ov.sum()) // (S - S2)))
        lanes_b = -(-ov // chunk)
        cum_pad = torch.cat([ov.new_zeros(1), torch.cumsum(lanes_b * chunk, 0)])
        g = torch.arange(S, device=dev, dtype=torch.int64) * chunk
        b_of = (torch.searchsorted(cum_pad, g, right=True) - 1).clamp(0, S2 - 1)
        o_l = g - cum_pad[b_of]
        bidx = top_idx[b_of]
        sp_len = (ov[b_of] - o_l).clamp(0, chunk)
        sacc = bucket_madd_rows_part(
            self.part, identity(S, self.group, dev, self.curve), table, perm,
            lane_base[bidx].contiguous(), i32(start[bidx] + T1 + o_l), i32(sp_len), 0,
            int(sp_len.max()), self.group, self.curve,
        )
        # segmented suffix fold: each bucket's chunk partials into its
        # first spill lane
        lane_ids = torch.arange(S, device=dev)
        st, max_lpb = 1, int(lanes_b.max())
        while st < max_lpb:
            same = (b_of == torch.roll(b_of, -st)) & (lane_ids + st < S)
            sacc = masked_add(sacc, torch.roll(sacc, -st, dims=0), same, self.group, self.curve)
            st *= 2
        first_lane = cum_pad[:S2] // chunk
        inv = torch.full((lanes,), -1, dtype=torch.int64, device=dev)
        inv[top_idx] = torch.where(spilled, first_lane, -1)
        return masked_add(
            acc, sacc[inv.clamp(min=0)].contiguous(), inv >= 0, self.group, self.curve
        )

    def uses_affine(self, n: int) -> bool:
        return self.affine and n >= AFFINE_MIN_MEAN * self.nb

    def accumulate(self, table, digits_t):
        """Phases 1-3: table (N, row_bytes) rows, digits_t (W, N) -> (W·2^cb,
        3, K, L) bucket accumulators."""
        W, n = digits_t.shape
        perm, start, length = self._buckets(digits_t)
        mean = max(1, n // self.nb)
        if self.uses_affine(n):
            from .msm_affine import AffineAccum

            if self._affine is None:
                self._affine = AffineAccum(self)
            return self._affine.accumulate(table, perm, start, length, n, mean)
        lane_base = torch.arange(self.lanes, device=table.device) // self.nb * n
        return self.run_scan(table, perm, lane_base, start, length, mean)

    # -- phase 4: replica collapse and the double suffix scan ------------------
    def fold_block(self, acc, win0: int, num_win: int):
        """Phase 4 on a block of whole windows: acc (num_win·2^cb, 3, K, L),
        the bucket accumulators of windows [win0, win0 + num_win) ->
        (num_win, 3, K, L) window totals. The collapse and scan masks are
        those of the block's windows (the last window's differ, as its
        replica count does), so the distributed MSM can fold its share of
        the windows; the whole fold is fold_block(acc, 0, W)."""
        nb, K, L = self.nb, self.K, self.L
        dev = acc.device
        lanes = slice(win0 * nb, (win0 + num_win) * nb)
        if acc.shape[0] != num_win * nb or win0 < 0 or win0 + num_win > self.W:
            raise ValueError(f"{acc.shape[0]} lanes for windows [{win0}, {win0 + num_win})")

        def step(a, stride, mask):
            rolled = torch.roll(a.view(num_win, nb, 3, K, L), -stride, dims=1)
            return masked_add(a, rolled.reshape(a.shape).contiguous(), mask, self.group, self.curve)

        for j in range(self.max_r):
            acc = step(acc, 1 << j, torch.as_tensor(self.collapse[j][lanes], device=dev))
        scan = [torch.as_tensor(m[lanes], device=dev) for m in self.scan]
        # S_b = sum_{j >= b} B_j, then a second suffix scan. Signed: bucket
        # b holds |digit| = b + 1, and sum_{b >= 0} S_b = sum (b + 1)·B_b.
        # Unsigned: bucket b holds digit b; S_0 is emptied first, so the
        # second scan gives sum_{b >= 1} S_b = sum b·B_b.
        for k in range(self.cb):
            acc = step(acc, 1 << k, scan[k])
        if not self.signed:
            acc = acc.view(num_win, nb, 3, K, L).clone()
            acc[:, 0] = identity(num_win, self.group, dev, self.curve)
            acc = acc.view(num_win * nb, 3, K, L)
        for k in range(self.cb):
            acc = step(acc, 1 << k, scan[k])
        return acc.view(num_win, nb, 3, K, L)[:, 0].contiguous()

    # -- public API --------------------------------------------------------------
    def window_sums(self, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """table (N, row_bytes) uint8 rows; digits (N, W) int32 (signed or
        unsigned, as the plan) -> (W, 3, K, L) window totals."""
        n, W = digits.shape
        if W != self.W:
            raise ValueError(f"digits have {W} windows, plan has {self.W}")
        if table.shape[0] != n:
            raise ValueError(f"table has {table.shape[0]} rows for {n} digits")
        return self.fold_block(self.accumulate(table, digits.t().contiguous()), 0, self.W)

    def combine(self, sums: torch.Tensor) -> torch.Tensor:
        """Horner over the window totals on the device: c doublings and one
        add per window, all in one K18 launch -> (3, K, L) projective."""
        return horner_combine(sums, self.c, self.group, self.curve)

    def combine_host(self, sums: torch.Tensor, host_curve):
        """Horner over the window totals on the host -> affine point."""
        affs = limbs_to_points(sums, self.group, self.curve)
        acc = None
        for w in range(self.W - 1, -1, -1):
            for _ in range(self.c):
                acc = host_curve.double(acc)
            acc = host_curve.add(acc, affs[w])
        return acc

    def msm(self, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """The whole MSM on the device -> (3, K, L) projective point."""
        return self.combine(self.window_sums(table, digits))

    def msm_host(self, table: torch.Tensor, digits: torch.Tensor, host_curve):
        """Window sums on the device, Horner on the host -> affine point."""
        return self.combine_host(self.window_sums(table, digits), host_curve)
