"""The plane MSM timed stage by stage on one card.

    python -m snark_tpu_torch.profile_msm [--log-n N] [--window C] [--unsigned]
                                          [--iters K] [--device cuda|cpu]

The counterpart of the repository's `scripts/profile_msm.py`, on the
port's `PlaneMsm` (BN254 G1, a table that tiles the 64-point pool of
`bench.make_inputs`, uniform scalars from `random.Random(7)`):

    sort         the sort into buckets: `sort_keys`, the sort, the
                 searchsorted (`PlaneMsm._buckets`)
    window_sums  the whole window sums (sort, K1 scan and spill, K2 folds)
    combine      the device Horner combine over the window totals (K18)

each the mean of K calls after a warm-up, between CUDA events. It also
gives the bucket runs' longest and mean length (the scan's step count),
the scan's time a step as the script computes it, (window_sums − sort)
over (longest run + 2·cb + max_r), and `correct`: the combined point
equals the pool oracle. Environment as the script reads it: BENCH_LOG_N
(20), BENCH_SIGNED (1), BENCH_WINDOW (13 signed, 12 unsigned),
BENCH_ITERS (3). One JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

from . import bench as B
from . import toolkit as T
from .ops.curve import limbs_to_points
from .ops.msm_plane import PlaneMsm


def run(log_n: int, signed: bool, c: int, iters: int, device) -> dict:
    dev = T.resolve(device)
    inp = B.make_inputs(log_n, signed=signed, c=c, group="g1", device=dev)
    plan = PlaneMsm(c, inp.curve.fr.num_bits, "g1", signed=signed)
    digits_t = inp.digits.t().contiguous()
    t_sort, (_, _, length) = T.timed(lambda: plan._buckets(digits_t), dev, iters)
    length = length.float()
    t_sums, sums = T.timed(lambda: plan.window_sums(inp.table, inp.digits), dev, iters)
    t_comb, point = T.timed(lambda: plan.combine(sums), dev, iters)
    got = limbs_to_points(point.cpu()[None], "g1", inp.curve)[0]
    max_len = int(length.max())
    return {
        "tool": "profile_msm", "log_n": log_n, "signed": signed, "c": c, "W": plan.W,
        "lanes": plan.lanes, "max_len": max_len, "mean_len": float(length.mean()),
        "sort_ms": t_sort, "window_sums_ms": t_sums, "combine_ms": t_comb,
        "scan_steps": max_len,
        "per_step_ms": (t_sums - t_sort) / max(max_len + 2 * plan.cb + plan.max_r, 1),
        "correct": got == inp.want, "iters": iters, **T.card(dev),
    }


def main(argv=None) -> int:
    env = os.environ.get
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(env("BENCH_LOG_N", "20")))
    ap.add_argument("--unsigned", action="store_true", default=env("BENCH_SIGNED", "1") != "1")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--iters", type=int, default=int(env("BENCH_ITERS", "3")))
    a = ap.parse_args(argv)
    signed = not a.unsigned
    c = a.window or int(env("BENCH_WINDOW", "13" if signed else "12"))
    rec = T.emit(run(a.log_n, signed, c, a.iters, a.device))
    return 0 if rec["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
