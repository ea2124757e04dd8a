"""The plane MSM by the batch-affine tree against the projective scan, on
the same inputs.

    python -m snark_tpu_torch.bench_affine_msm [--log-n N] [--window C] [--iters K]
                                               [--g2-log-n N2] [--g2-window C2]
                                               [--device cuda|cpu]

The counterpart of the repository's `scripts/bench_affine_msm.py`: the
whole `PlaneMsm.msm` (sort, accumulation, folds, the K18 combine) of 2^N
BN254 G1 points (N = BENCH_LOG_N, 18) of a tiled 64-point pool, uniform
scalars from `random.Random(7)` (BENCH_CLUSTER=1: every other scalar one
of eight 44-bit values, the real-witness shape whose boundary buckets
overflow), signed c = BENCH_WINDOW (13), with `affine=True` (K6-K8, then
K1 over the block partials) and with the scan (K1). A JSON line a mode:
`wall_s` (host clock, the readback included, mean of BENCH_ITERS = 2
after the first call), `ms` (the same calls between CUDA events; null on
the CPU),
`first_s`, adds/s as `bench.py` counts them, `correct` against the pool
oracle; then, unless BENCH_G2=0, the G2 affine check (2^N2 points, N2 =
14, of a 16-point pool, c2 = 8, combined on the host) as
`g2_affine_correct`; then the speedup line (projective wall over affine
wall) with `correct` for all of them. Every line carries the card's name
and power limit.
"""

from __future__ import annotations

import os
import random
import sys
import time

import numpy as np
import torch

from . import toolkit as T
from .bench import host_curve, work_adds
from .fields.limbs import fields_of
from .fields.params import BN254
from .ops.curve import limbs_to_points, pack_rows_u8
from .ops.msm import signed_digits
from .ops.msm_plane import PlaneMsm


def pool_inputs(log_n: int, pool: int, group: str, c: int, rng, dev, cluster: bool = False):
    """(table, digits (n, W), oracle point) for 2^log_n points tiling a pool
    of `pool` generator multiples."""
    curve = BN254
    n, r = 1 << log_n, curve.fr.modulus
    hc = host_curve(group, curve)
    pts = [hc.scalar_mul(hc.generator, k + 1) for k in range(pool)]
    table = torch.as_tensor(np.tile(pack_rows_u8(pts, group, curve), (n // pool, 1)), device=dev)
    scalars = [rng.randrange(0, r) for _ in range(n)]
    if cluster:
        vals = [rng.randrange(0, 1 << 44) for _ in range(8)]
        for i in range(0, n, 2):
            scalars[i] = vals[(i // 2) % 8]
    std = fields_of(curve)[0].tensor(scalars, dev, mont=False)
    digits = signed_digits(std, c, curve.fr.num_bits).contiguous()
    agg = [0] * pool
    for i, s in enumerate(scalars):
        agg[i % pool] += s
    return table, digits, hc.msm(pts, [a % r for a in agg])


def run(log_n: int, c: int, iters: int, device, cluster: bool = False,
        g2_log_n: int | None = 14, g2_c: int = 8) -> list[dict]:
    dev = T.resolve(device)
    card = T.card(dev)
    rng = random.Random(7)
    table, digits, want = pool_inputs(log_n, 64, "g1", c, rng, dev, cluster)
    n = 1 << log_n
    out, results = [], {}
    for affine in (True, False):
        name = "affine" if affine else "projective"
        plan = PlaneMsm(c, BN254.fr.num_bits, "g1", signed=True, affine=affine)
        t0 = time.perf_counter()
        out0 = plan.msm(table, digits).cpu()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            plan.msm(table, digits).cpu()
        wall = (time.perf_counter() - t0) / iters
        ms = T.time_ms(lambda: plan.msm(table, digits), dev, iters) if dev.type == "cuda" else None
        results[name] = {
            "wall_s": wall, "ms": ms, "first_s": first_s,
            "adds_per_s": work_adds(plan, n) / wall,
            "engaged": plan.uses_affine(n) if affine else True,
            "correct": limbs_to_points(out0[None], "g1", BN254)[0] == want,
        }
        out.append(T.emit({"tool": "bench_affine_msm", name: results[name], **card}))
    ok = all(r["correct"] and r["engaged"] for r in results.values())
    if g2_log_n is not None:
        t2, d2, want2 = pool_inputs(g2_log_n, 16, "g2", g2_c, rng, dev)
        plan2 = PlaneMsm(g2_c, BN254.fr.num_bits, "g2", signed=True, affine=True)
        if not plan2.uses_affine(1 << g2_log_n):
            raise RuntimeError("the G2 affine tree did not engage")
        ok2 = plan2.msm_host(t2, d2, host_curve("g2")) == want2
        ok = ok and ok2
        out.append(T.emit({"tool": "bench_affine_msm", "g2_affine_correct": ok2,
                           "n": 1 << g2_log_n, "c": g2_c, **card}))
    out.append(T.emit({
        "tool": "bench_affine_msm",
        "speedup": results["projective"]["wall_s"] / results["affine"]["wall_s"],
        "log_n": log_n, "c": c, "cluster": cluster, "correct": ok, **card,
    }))
    return out


def main(argv=None) -> int:
    env = os.environ.get
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(env("BENCH_LOG_N", "18")))
    ap.add_argument("--window", type=int, default=int(env("BENCH_WINDOW", "13")))
    ap.add_argument("--iters", type=int, default=int(env("BENCH_ITERS", "2")))
    ap.add_argument("--g2-log-n", type=int, default=14)
    ap.add_argument("--g2-window", type=int, default=8)
    a = ap.parse_args(argv)
    recs = run(a.log_n, a.window, a.iters, a.device, env("BENCH_CLUSTER") == "1",
               a.g2_log_n if env("BENCH_G2", "1") == "1" else None, a.g2_window)
    return 0 if recs[-1]["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
