"""Each prover MSM shape timed alone on one card.

    python -m snark_tpu_torch.profile_prover_msms [--log-n N] [--configs LIST]
                                                  [--iters K] [--device cuda|cpu]

The counterpart of the repository's `scripts/profile_prover_msms.py`: one
`PlaneMsm.window_sums` (the sort, K1's scan and spill, K2's folds) for
each plan shape of the 2^16 prove (configuration 2), so that a change is
pinned to a plan and not to its place in the prove. BN254, 2^N points
(N = PROF_LOG_N, 16) of a table that tiles 16 multiples of the generator,
uniform scalars from `random.Random(7)`:

    g1s11   G1, signed digits, c = 11
    g2s11   G2, signed, c = 11
    g1u10   G1, unsigned, c = 10
    h13     G1, signed, c = 13

PROF_CONFIGS (or --configs) picks some of them, comma-separated. Each line
is the mean of K (3) calls after a warm-up, between CUDA events, with
M adds/s at n·W adds, as the script counts them, and `correct`: the window
sums, combined on the host, equal the pool oracle. PROF_TILES, the
script's TPU tile widths, has no counterpart: K1's block is fixed at 128
threads (`csrc/curve_kernels.cuh`). The module runs each shape once per
value listed there, as the script loops over them, and writes the value
beside the line as `tile` (null when PROF_TILES is unset); the runs are the
same run. One JSON line a shape, with the card's name and power limit.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import torch

from . import toolkit as T
from .bench import host_curve
from .fields.limbs import fields_of
from .fields.params import BN254
from .ops.curve import pack_rows_u8
from .ops.msm import signed_digits, unsigned_digits
from .ops.msm_plane import PlaneMsm

POOL = 16
CONFIGS = {  # name -> (group, signed, c)
    "g1s11": ("g1", True, 11),
    "g2s11": ("g2", True, 11),
    "g1u10": ("g1", False, 10),
    "h13": ("g1", True, 13),
}


def run(log_n: int, configs, tiles, iters: int, device, max_window: int | None = None) -> list[dict]:
    """One record a (tile, shape); `max_window` caps each shape's c (for
    tiny runs on the CPU, where the plain folds of c = 13's 81,920 lanes
    take most of a minute)."""
    dev = T.resolve(device)
    curve = BN254
    n = 1 << log_n
    r = curve.fr.modulus
    nbits = curve.fr.num_bits
    rng = random.Random(7)
    pools, tables = {}, {}
    for group in ("g1", "g2"):
        hc = host_curve(group, curve)
        pools[group] = [hc.scalar_mul(hc.generator, k + 1) for k in range(POOL)]
        rows = pack_rows_u8(pools[group], group, curve)
        tables[group] = torch.as_tensor(np.tile(rows, (n // POOL, 1)), device=dev)
    scalars = [rng.randrange(0, r) for _ in range(n)]
    std = fields_of(curve)[0].tensor(scalars, dev, mont=False)
    agg = [0] * POOL
    for i, s in enumerate(scalars):
        agg[i % POOL] += s
    agg = [a % r for a in agg]
    card = T.card(dev)
    out = []
    for tile in tiles:
        for name in configs:
            group, signed, c = CONFIGS[name]
            c = min(c, max_window or c)
            plan = PlaneMsm(c, nbits, group, signed=signed, curve=curve)
            digits = (signed_digits if signed else unsigned_digits)(std, c, nbits).contiguous()
            ms, sums = T.timed(lambda: plan.window_sums(tables[group], digits), dev, iters)
            hc = host_curve(group, curve)
            got = plan.combine_host(sums, hc)
            adds = n * plan.W
            out.append({
                "tool": "profile_prover_msms", "config": name, "log_n": log_n, "tile": tile,
                "c": c, "W": plan.W, "ms": ms, "adds": adds, "m_adds_per_s": adds / ms / 1e3,
                "correct": got == hc.msm(pools[group], agg), "iters": iters, **card,
            })
    return out


def main(argv=None) -> int:
    env = os.environ.get
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(env("PROF_LOG_N", "16")))
    ap.add_argument("--configs", default=env("PROF_CONFIGS") or ",".join(CONFIGS))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-window", type=int, default=None,
                    help="cap each shape's window (tiny runs on the CPU)")
    a = ap.parse_args(argv)
    configs = [c for c in a.configs.split(",") if c in CONFIGS]
    tiles = [int(t) for t in env("PROF_TILES", "").split(",") if t] or [None]
    recs = run(a.log_n, configs, tiles, a.iters, a.device, a.max_window)
    for rec in recs:
        T.emit(rec)
    return 0 if all(rec["correct"] for rec in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
