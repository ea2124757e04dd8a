"""The batch-affine MSM's front and its tail scan timed apart, at 2^20,
c = 13.

    python -m snark_tpu_torch.profile_affine_front [--log-n N] [--window C] [--iters K]
                                                   [--device cuda|cpu]

The counterpart of the repository's `scripts/profile_affine_front.py`, on
the port (BN254 G1, 2^N points, N = LOG_N, 20, of the 64-point pool of
`bench.make_inputs`, signed c = 13). The lines, each the mean of K calls
after a warm-up between CUDA events:

    sort        the sort into buckets and the searchsorted
                (`PlaneMsm._buckets`)
    front       sort → block indices → row gather (`_buckets`, then
                `AffineAccum.blocks`). The script packs its u8 rows into u32
                words before its gather and unpacks them after; the port
                gathers the u8 rows as they are, so its front has no unpack
    tail        the block scan at the level-0 shapes: K1 over TB rows,
                lane l adding its nblk[l] block partials (nblk multinomial
                over the lanes, W·n / B0 in all, as the script draws them),
                B0 = `pick_block_size(n / 2^cb)`
    window_sums the whole window sums of the affine plan

`equal`: the affine plan's window totals equal the scan's, as points. One
JSON line, with B0, TB, the slots and the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from . import bench as B
from . import toolkit as T
from .ops.curve import limbs_to_points
from .ops.msm_affine import AffineAccum, pick_block_size
from .ops.msm_plane import PlaneMsm


def run(log_n: int, c: int, iters: int, device) -> dict:
    dev = T.resolve(device)
    inp = B.make_inputs(log_n, signed=True, c=c, group="g1", device=dev)
    n = inp.n
    nbits = inp.curve.fr.num_bits
    plan = PlaneMsm(c, nbits, "g1", signed=True, affine=True)
    digits_t = inp.digits.t().contiguous()
    acc = AffineAccum(plan)
    mean = max(1, n // plan.nb)
    B0 = pick_block_size(mean)
    TB = -(-(plan.W * n) // B0) + plan.lanes

    def front():
        perm, start, length = plan._buckets(digits_t)
        return acc.blocks(inp.table, perm, start, length, n, mean)

    rng = np.random.default_rng(0)
    nblk = rng.multinomial(plan.W * n // B0, np.ones(plan.lanes) / plan.lanes)
    boff = np.concatenate([[0], np.cumsum(nblk)])
    rows = inp.table[torch.as_tensor(rng.integers(0, n, size=TB), device=dev)]
    iota = torch.arange(TB, dtype=torch.int32, device=dev)
    zeros = torch.zeros(plan.lanes, dtype=torch.int32, device=dev)
    boff_t = torch.as_tensor(boff[:-1], dtype=torch.int32, device=dev)
    nblk_t = torch.as_tensor(nblk, dtype=torch.int32, device=dev)
    tail = lambda: plan.run_scan(rows, iota, zeros, boff_t, nblk_t, max(1, mean // B0 + 1))  # noqa: E731
    rec = {
        "tool": "profile_affine_front", "log_n": log_n, "c": c, "W": plan.W, "B0": B0,
        "TB": TB, "slots": TB * B0,
        "sort_ms": T.time_ms(lambda: plan._buckets(digits_t), dev, iters),
        "front_ms": T.time_ms(front, dev, iters),
        "tail_ms": T.time_ms(tail, dev, iters),
        "window_sums_ms": T.time_ms(lambda: plan.window_sums(inp.table, inp.digits), dev, iters),
    }
    scan = PlaneMsm(c, nbits, "g1", signed=True)
    rec["equal"] = (limbs_to_points(plan.window_sums(inp.table, inp.digits).cpu())
                    == limbs_to_points(scan.window_sums(inp.table, inp.digits).cpu()))
    return {**rec, "affine_engaged": plan.uses_affine(n), "iters": iters, **T.card(dev)}


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(os.environ.get("LOG_N", "20")))
    ap.add_argument("--window", type=int, default=13)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    rec = T.emit(run(a.log_n, a.window, a.iters, a.device))
    return 0 if rec["equal"] and rec["affine_engaged"] else 1


if __name__ == "__main__":
    sys.exit(main())
