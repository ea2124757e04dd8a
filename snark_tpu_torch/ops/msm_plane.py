"""Pippenger MSM over the curve kernels K1 and K2, signed digits.

Counterpart of the JAX package's `ops/msm_plane.py` `PlaneMsm` (signed
mode, the prover's): the same replica-slot sort keys, sort and
searchsorted into buckets, the bucket scan with its rank-split spill, the
replica and suffix folds, and the host Horner combine. The group arithmetic
is K1 (`bucket_madd_rows`, the scan) and K2 (`masked_add`, the folds).

Per window, bucket b (|digit| = b + 1) of a window with only `bits` < cb
digit bits is split over 2^r replica slots (r = cb − bits, slot =
b·2^r | (i mod 2^r)), so every window has 2^cb slots of even expected
size. The scan runs one K1 launch over all W·2^cb lanes: lane l adds its
bucket's run of sorted rows. The longest runs would set the launch's time,
so runs longer than T1 = mean + 1.5·sqrt(mean) among the S2 longest are
cut at T1 and their overflow is split evenly over the spill lanes, which a
second K1 launch scans; segmented K2 folds bring the partial sums back.
Real witnesses need this: the MulChain witness puts about 5% of N into
single buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import GROUPS, identity, limbs_to_points, masked_add, bucket_madd_rows

_SIGN = 1 << 31
SPILL_BUCKETS = 2048  # most buckets a scan spills (the reference's default)


class PlaneMsm:
    """Signed-digit bucket MSM for one (c, num_bits, group)."""

    def __init__(self, c: int, num_bits: int = 254, group: str = "g1"):
        self.c = c
        self.group = group
        self.K = GROUPS[group]
        self.num_bits = num_bits
        cb = self.cb = c - 1  # signed: bucket = |digit| − 1
        nb = self.nb = 1 << cb
        w_u = -(-num_bits // c)
        b_top = num_bits - (w_u - 1) * c
        if b_top >= c:
            W = w_u + 1
            bits_w = [cb] * w_u + [0]
        else:
            W = w_u
            bits_w = [cb] * (W - 1) + [min(b_top, cb)]
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
        # spill lanes: about a tenth of the bucket lanes, in steps of 256
        self.spill_lanes = (
            max(1, (self.lanes // 10) // 256) * 256 if self.lanes >= 2048 else 0
        )

    # -- phase 1-2: sort into buckets ----------------------------------------
    def sort_keys(self, digits_t: torch.Tensor):
        """(W, N) signed digits -> (keys, payload): key = bucket·2^r |
        (i mod 2^r), zero digits past the last bucket (key nb); the payload
        is the row index with the digit's sign in bit 31."""
        W, n = digits_t.shape
        dev = digits_t.device
        iota = torch.arange(n, dtype=torch.int64, device=dev).expand(W, n)
        mult = torch.as_tensor(self.mult, device=dev)
        mag = digits_t.to(torch.int64).abs()
        keys = torch.where(mag == 0, self.nb, (mag - 1) * mult + (iota & (mult - 1)))
        payload = iota | torch.where(digits_t < 0, _SIGN, 0)
        # int32 holding the u32 payload bits
        payload = torch.where(payload >= _SIGN, payload - (1 << 32), payload)
        return keys, payload.to(torch.int32)

    def _buckets(self, digits_t: torch.Tensor):
        W, n = digits_t.shape
        keys, payload = self.sort_keys(digits_t)
        keys_sorted, order = torch.sort(keys, dim=1, stable=True)
        perm = torch.gather(payload, 1, order).reshape(-1).contiguous()
        targets = torch.arange(self.nb + 1, device=keys.device).expand(W, self.nb + 1)
        bounds = torch.searchsorted(keys_sorted, targets.contiguous())
        start = bounds[:, :-1].reshape(-1)
        length = (bounds[:, 1:] - bounds[:, :-1]).reshape(-1)
        return perm, start, length

    # -- phase 3: bucket scan + spill -----------------------------------------
    def spill_plan(self, length: torch.Tensor, n: int):
        """-> (eff_len, spill): the main scan's run lengths, and for the
        spill (None when nothing spills) the cut T1 and the top-S2 buckets
        (top lengths, their lanes, which of them spill)."""
        S = self.spill_lanes
        S2 = min(SPILL_BUCKETS, max(1, S // 4))
        if not 0 < S < self.lanes:
            return length, None
        mean = max(1, n // self.nb)
        T1 = int(mean + max(2, int(1.5 * mean**0.5)))
        top_vals, top_idx = torch.topk(length, S2)
        t_star = max(T1, int(top_vals[S2 - 1]))
        spilled = top_vals > t_star
        if not bool(spilled.any()):
            return length, None
        eff_len = torch.where(length > t_star, length.clamp(max=T1), length)
        return eff_len, (T1, top_vals, top_idx, spilled)

    def _scan(self, table, perm, start, length, n):
        dev = table.device
        lanes = self.lanes
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        lane_base = torch.arange(lanes, device=dev, dtype=torch.int64) // self.nb * n
        eff_len, spill = self.spill_plan(length, n)
        acc = bucket_madd_rows(
            identity(lanes, self.group, dev), table, perm, i32(lane_base), i32(start),
            i32(eff_len), 0, int(eff_len.max()), self.group,
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
        sacc = bucket_madd_rows(
            identity(S, self.group, dev), table, perm, i32(lane_base[bidx]),
            i32(start[bidx] + T1 + o_l), i32(sp_len), 0, int(sp_len.max()), self.group,
        )
        # segmented suffix fold: each bucket's chunk partials into its
        # first spill lane
        lane_ids = torch.arange(S, device=dev)
        st, max_lpb = 1, int(lanes_b.max())
        while st < max_lpb:
            same = (b_of == torch.roll(b_of, -st)) & (lane_ids + st < S)
            sacc = masked_add(sacc, torch.roll(sacc, -st, dims=0), same, self.group)
            st *= 2
        first_lane = cum_pad[:S2] // chunk
        inv = torch.full((lanes,), -1, dtype=torch.int64, device=dev)
        inv[top_idx] = torch.where(spilled, first_lane, -1)
        return masked_add(acc, sacc[inv.clamp(min=0)].contiguous(), inv >= 0, self.group)

    # -- phase 4: replica collapse and the double suffix scan ------------------
    def _fold(self, acc):
        W, nb, K = self.W, self.nb, self.K
        dev = acc.device

        def step(a, stride, mask):
            rolled = torch.roll(a.view(W, nb, 3, K, 8), -stride, dims=1)
            return masked_add(a, rolled.reshape(a.shape).contiguous(), mask, self.group)

        for j in range(self.max_r):
            acc = step(acc, 1 << j, torch.as_tensor(self.collapse[j], device=dev))
        scan = [torch.as_tensor(m, device=dev) for m in self.scan]
        # S_b = sum_{j >= b} B_j, then sum_{b >= 0} S_b = sum (b + 1)·B_b:
        # bucket b holds |digit| = b + 1
        for _ in range(2):
            for k in range(self.cb):
                acc = step(acc, 1 << k, scan[k])
        return acc.view(W, nb, 3, K, 8)[:, 0].contiguous()

    # -- public API --------------------------------------------------------------
    def window_sums(self, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """table (N, row_bytes) uint8 rows; digits (N, W) int32 signed ->
        (W, 3, K, 8) window totals."""
        n, W = digits.shape
        if W != self.W:
            raise ValueError(f"digits have {W} windows, plan has {self.W}")
        if table.shape[0] != n:
            raise ValueError(f"table has {table.shape[0]} rows for {n} digits")
        perm, start, length = self._buckets(digits.t().contiguous())
        return self._fold(self._scan(table, perm, start, length, n))

    def combine_host(self, sums: torch.Tensor, host_curve):
        """Horner over the window totals on the host -> affine point."""
        affs = limbs_to_points(sums, self.group)
        acc = None
        for w in range(self.W - 1, -1, -1):
            for _ in range(self.c):
                acc = host_curve.double(acc)
            acc = host_curve.add(acc, affs[w])
        return acc

    def msm(self, table, digits, host_curve):
        return self.combine_host(self.window_sums(table, digits), host_curve)
