"""The reference's legacy Pippenger MSM and fixed-base product, on the
port's kernels.

Counterpart of `snark_tpu/ops/msm.py:160-435` (`MsmPlan`, `get_msm_plan`,
`memory_aware_window_chunk`, `msm_host_combine`, `msm_device_digits`,
`msm`, `FixedBasePlan`). Points and results keep the reference's layout
(`ops/curve_u32.py`); a plan converts the points to the kernels' words
once, runs every step on them, and converts the W window totals (or the
one total) back.

`MsmPlan.window_sums` is the reference's `_window_sums` (`:179-232`) for
each chunk of windows: the (W, N) digits sorted (stable, so each bucket's
points keep their order) and the bucket boundaries searched
(`torch.sort`, `torch.searchsorted`; bucket 0 gets no points); then
`max_len` steps of one K2 `masked_add` launch over the W·2^c bucket
lanes, lane (w, b) adding point perm[w, start + i] where i < length; then
the two stride-doubling suffix scans, c K2 `masked_add` launches each on
the rolled buckets (the first gives S_b = Σ_{j>=b} B_j, bucket 0 set to
the identity, the second Σ_{b>=1} S_b at lane 0). `__call__` adds one K18
`horner_combine` launch (the reference's `_msm_impl` Horner, `:249-265`).
The same adds in the same order, so the projective outputs equal the
reference's limb for limb. `FixedBasePlan.__call__` is
`ops/fixed_base.py` `table_walk` (K2 `point_add`), the routine the setup's
`FixedBase.walk_legacy` runs.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import horner_combine, identity, masked_add
from .curve_u32 import _CurveOpsBase
from .fixed_base import table_walk
from .msm import pick_window, scalars_to_digits


def digit_tensor(digits, device) -> torch.Tensor:
    """(N, W) window digits (numpy, as the reference's host functions give
    them, or a tensor) -> int64 tensor on `device`."""
    if isinstance(digits, torch.Tensor):
        return digits.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(digits).astype(np.int64)).to(device)


class MsmPlan:
    """MSM executor for one (curve ops, c) pair; `window_chunk` windows at
    a time where it is given (the reference's cap on the sorted-points
    gather)."""

    def __init__(self, ops: _CurveOpsBase, c: int, window_chunk: int | None = None):
        self.ops = ops
        self.c = c
        self.window_chunk = window_chunk

    def _window_sums(self, pw: torch.Tensor, digits_t: torch.Tensor) -> torch.Tensor:
        """pw (N, 3, kc, L) words; digits_t (W, N) int64 -> (W, 3, kc, L)
        window totals."""
        ops, c = self.ops, self.c
        group, curve = ops.group, ops.curve
        nb = 1 << c
        W, n = digits_t.shape
        dev = pw.device
        d_sorted, perm = torch.sort(digits_t, dim=-1, stable=True)
        targets = torch.arange(nb + 1, device=dev).expand(W, nb + 1).contiguous()
        bounds = torch.searchsorted(d_sorted.contiguous(), targets)
        start = bounds[:, :-1]
        length = bounds[:, 1:] - start
        length[:, 0] = 0  # bucket 0 contributes nothing
        max_len = int(length.max()) if length.numel() else 0
        lanes = W * nb
        acc = identity(lanes, group, dev, curve)
        for i in range(max_len):
            idx = torch.clamp(start + i, max=n - 1)
            src = torch.gather(perm, 1, idx).reshape(-1)
            acc = masked_add(acc, pw[src], (length > i).reshape(-1), group, curve)
        shape = (W, nb) + tuple(acc.shape[1:])
        col = torch.arange(nb, device=dev)

        def scan(a: torch.Tensor) -> torch.Tensor:
            for s in range(c):
                stride = 1 << s
                shifted = torch.roll(a.view(shape), -stride, dims=1).reshape(a.shape)
                valid = (col + stride < nb).expand(W, nb).reshape(-1)
                a = masked_add(a, shifted, valid, group, curve)
            return a

        suffix = scan(acc).view(shape).clone()
        suffix[:, 0] = identity(1, group, dev, curve)[0]
        return scan(suffix.reshape(acc.shape)).view(shape)[:, 0].contiguous()

    def window_sums_words(self, points, digits) -> torch.Tensor:
        """points (N, 3, K); digits (N, W) -> (W, 3, kc, L) window totals in
        the kernels' words."""
        pw = self.ops.to_kernel(points)
        dt = digit_tensor(digits, self.ops.device).t()
        W = dt.shape[0]
        wc = self.window_chunk or W
        parts = [self._window_sums(pw, dt[i : i + wc]) for i in range(0, W, wc)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def window_sums(self, points, digits) -> torch.Tensor:
        """points (N, 3, K); digits (N, W) -> per-window sums (W, 3, K)."""
        sums = self.window_sums_words(points, digits)
        return self.ops.from_kernel(sums, sums.shape[:1])

    def msm_words(self, points, digits) -> torch.Tensor:
        """-> the total as (3, kc, L) words: the window sums, then one K18
        launch."""
        return horner_combine(self.window_sums_words(points, digits), self.c, self.ops.group,
                              self.ops.curve)

    def __call__(self, points, digits) -> torch.Tensor:
        """points (N, 3, K); digits (N, W) -> one (3, K) point."""
        return self.ops.from_kernel(self.msm_words(points, digits), ())


_PLANS: dict = {}


def get_msm_plan(ops: _CurveOpsBase, c: int, window_chunk: int | None = None) -> MsmPlan:
    key = (id(ops), c, window_chunk)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = MsmPlan(ops, c, window_chunk)
    return plan


def memory_aware_window_chunk(n: int, k_limbs: int, budget_bytes: float = 1.2e9) -> int:
    """Windows a chunk so that the reference's (wc, N, 3, K) sorted-points
    gather stays near budget_bytes (its budget, kept so that both packages
    cut the same chunks)."""
    per_window = n * 3 * k_limbs * 4
    return max(1, int(budget_bytes // max(per_window, 1)))


def _padded(n: int) -> int:
    return 1 << max(2, (n - 1).bit_length())


def _pad_inputs(ops: _CurveOpsBase, points, digits):
    """Identity points and zero digits up to the next power of two (at
    least 4), as the reference pads. -> (points, digits tensor, n_pad)."""
    points = ops.from_numpy(points)
    digits = digit_tensor(digits, ops.device)
    n = points.shape[0]
    n_pad = _padded(n)
    if n_pad != n:
        points = torch.cat([points, ops.identity_like((n_pad - n,))])
        digits = torch.cat([digits, digits.new_zeros((n_pad - n, digits.shape[1]))])
    return points, digits, n_pad


def _chunk(n_pad: int, k: int, W: int) -> int | None:
    wc = memory_aware_window_chunk(n_pad, k)
    return None if wc >= W else wc


def msm_host_combine(ops: _CurveOpsBase, host_curve, points, digits, c: int):
    """MSM whose window sums run on the device and whose Horner combine
    runs on the host (`:309-335`) -> host affine point."""
    points, digits, n_pad = _pad_inputs(ops, points, digits)
    W = digits.shape[1]
    sums = get_msm_plan(ops, c, _chunk(n_pad, points.shape[-1], W)).window_sums(points, digits)
    affs = ops.to_affine_host(sums)
    acc = None
    for w in range(W - 1, -1, -1):
        for _ in range(c):
            acc = host_curve.double(acc)
        acc = host_curve.add(acc, affs[w])
    return acc


def msm_device_digits(ops: _CurveOpsBase, points, digits, c: int) -> torch.Tensor:
    """MSM whose (N, W) window digits are already on the device -> (3, K)."""
    points, digits, n_pad = _pad_inputs(ops, points, digits)
    return get_msm_plan(ops, c, _chunk(n_pad, points.shape[-1], digits.shape[1]))(points, digits)


def msm(ops: _CurveOpsBase, points, scalars_limbs, num_bits: int, c: int | None = None):
    """Σ scalars[i]·points[i] -> one (3, K) point; scalars (N, L) 16-bit
    standard-form limbs (host), padded to the next power of two as the
    reference pads."""
    n_pad = _padded(ops.from_numpy(points).shape[0])
    c = c or pick_window(n_pad)
    return msm_device_digits(ops, points, scalars_to_digits(scalars_limbs, c, num_bits), c)


class FixedBasePlan:
    """[s_i]·G for a fixed G: windowed tables, then W complete additions of
    gathered entries (`:344-393`). Table (W, 2^c, 3, K):
    table[w][d] = d·2^(cw)·G."""

    def __init__(self, ops: _CurveOpsBase, c: int = 8):
        self.ops = ops
        self.c = c

    def make_table(self, base_affine, host_curve, num_bits: int, pack) -> torch.Tensor:
        """The table on the host (Python ints), each window's row packed by
        `pack` (the ops' `pack_affine_host`)."""
        c = self.c
        rows = []
        g = base_affine
        for _ in range(-(-num_bits // c)):
            row, acc = [None], None
            for _ in range((1 << c) - 1):
                acc = host_curve.add(acc, g)
                row.append(acc)
            rows.append(pack(row))
            for _ in range(c):
                g = host_curve.double(g)
        return torch.stack(rows)

    def __call__(self, table, digits) -> torch.Tensor:
        """table (W, 2^c, 3, K); digits (N, W) -> (N, 3, K)."""
        ops = self.ops
        table = ops.from_numpy(table)
        pts = ops.to_kernel(table.reshape(-1, 3, ops.K))
        d = digit_tensor(digits, ops.device)
        return ops.from_kernel(table_walk(pts, d, self.c, ops.group, ops.curve), d.shape[:1])
