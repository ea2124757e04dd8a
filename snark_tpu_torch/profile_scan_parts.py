"""The bucket scan's cost split into its row gather and its products.

    python -m snark_tpu_torch.profile_scan_parts [--log-n N] [--window C] [--iters K]
                                                 [--device cuda|cpu]

The counterpart of the repository's `scripts/profile_scan_parts.py`. The
script runs its scan loop as shipped, then with the mixed add swapped for
a trivial consume (the gather alone), then the mixed add on fixed rows (the
products alone). The port's K1 gathers its rows itself (`ops/curve.py`
`bucket_madd_rows`: row perm[lane_base + start + i] of `table` at step
i), so the split is rebuilt around it, on the same sorted buckets (BN254
G1, signed c = 13, 2^N points of the 64-point pool of `bench.make_inputs`,
N = BENCH_LOG_N, 20):

    scan        the shipped scan: `PlaneMsm.run_scan` (K1's main launch,
                the spill's K1 launch and its K2 folds)
    k1          K1's main launch alone, as the scan makes it
    gather      the same rows gathered by torch indexing in scan order,
                STEP_CHUNK steps a gather, each summed into a per-lane
                int32 accumulator (a trivial reduction)
    k1_iota     K1 on those rows gathered beforehand into one contiguous
                array in scan order, with perm = iota (each payload's sign
                kept): K1's products and its reads of rows that sit
                together, without the scattered gather

Each is the mean of K calls after a warm-up, between CUDA events; the
line gives each time a step (over the main launch's step count) and
`equal`: `k1_iota` gives K1's accumulators exactly. One JSON line, with
the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import torch

from . import bench as B
from . import toolkit as T
from .ops.curve import bucket_madd_rows, identity
from .ops.msm_plane import PlaneMsm

STEP_CHUNK = 8  # scan steps a torch gather covers


def gather_in_scan_order(table, perm, base, eff_len, steps: int) -> torch.Tensor:
    """(lanes, row_bytes) int32: each lane's rows of the scan, gathered by
    torch indexing STEP_CHUNK steps at a time and summed."""
    n = table.shape[0]
    table_z = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    acc = torch.zeros((base.shape[0], table.shape[1]), dtype=torch.int32, device=table.device)
    for i0 in range(0, steps, STEP_CHUNK):
        i = torch.arange(i0, min(i0 + STEP_CHUNK, steps), device=table.device)
        valid = i[None, :] < eff_len[:, None]
        pay = perm[(base[:, None] + i[None, :]).clamp(max=perm.shape[0] - 1)]
        idx = torch.where(valid, pay & 0x7FFFFFFF, n)
        acc += table_z[idx].sum(dim=1, dtype=torch.int32)
    return acc


def run(log_n: int, c: int, iters: int, device) -> dict:
    dev = T.resolve(device)
    inp = B.make_inputs(log_n, signed=True, c=c, group="g1", device=dev)
    plan = PlaneMsm(c, inp.curve.fr.num_bits, "g1", signed=True)
    n, lanes = inp.n, plan.lanes
    perm, start, length = plan._buckets(inp.digits.t().contiguous())
    mean = max(1, n // plan.nb)
    lane_base = torch.arange(lanes, device=dev) // plan.nb * n
    eff_len, _ = plan.spill_plan(length, mean)
    steps = int(eff_len.max())
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    lb, st, el = i32(lane_base), i32(start), i32(eff_len)
    acc0 = identity(lanes, "g1", dev)
    table = inp.table

    def k1(tbl, p):
        return bucket_madd_rows(acc0, tbl, p, lb, st, el, 0, steps, "g1")

    t_scan = T.time_ms(lambda: plan.run_scan(table, perm, lane_base, start, length, mean), dev,
                       iters)
    t_k1 = T.time_ms(lambda: k1(table, perm), dev, iters)
    base = lane_base + start
    t_gather = T.time_ms(lambda: gather_in_scan_order(table, perm, base, eff_len, steps), dev,
                         iters)
    # the rows in scan order, contiguous; perm = iota with each payload's sign
    sorted_rows = table[(perm & 0x7FFFFFFF).long()]
    iota = torch.arange(perm.shape[0], dtype=torch.int64, device=dev)
    perm_iota = i32(torch.where(perm < 0, iota - (1 << 32) + (1 << 31), iota))
    t_iota = T.time_ms(lambda: k1(sorted_rows, perm_iota), dev, iters)
    equal = bool(torch.equal(k1(sorted_rows, perm_iota), k1(table, perm)))
    per = lambda ms: ms / max(steps, 1)  # noqa: E731
    return {
        "tool": "profile_scan_parts", "log_n": log_n, "c": c, "W": plan.W, "lanes": lanes,
        "steps": steps, "rows": int(eff_len.sum()),
        "scan_ms": t_scan, "k1_ms": t_k1, "gather_ms": t_gather, "k1_iota_ms": t_iota,
        "k1_ms_per_step": per(t_k1), "gather_ms_per_step": per(t_gather),
        "k1_iota_ms_per_step": per(t_iota), "equal": equal, "iters": iters, **T.card(dev),
    }


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(os.environ.get("BENCH_LOG_N", "20")))
    ap.add_argument("--window", type=int, default=13)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    rec = T.emit(run(a.log_n, a.window, a.iters, a.device))
    return 0 if rec["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
