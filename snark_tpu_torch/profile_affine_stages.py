"""The batch-affine MSM's stages timed apart, at level 0 of a 2^20, c = 13
accumulation.

    python -m snark_tpu_torch.profile_affine_stages [--log-n N] [--window C] [--iters K]
                                                    [--device cuda|cpu]

The counterpart of the repository's `scripts/profile_affine_stages.py`,
on the port's `ops/msm_affine.py` (BN254 G1; 2^N points, N = LOG_N, 20, of
the 64-point pool of `bench.make_inputs`, signed c = 13). The level-0
shapes are those of the script: W windows, B0 = `pick_block_size(mean)`
slots a block, TB = ⌈W·n / B0⌉ + lanes blocks, M = TB·B0 / 2 pairs. The
lines, each the mean of K calls after a warm-up between CUDA events:

    gather         TB·B0 rows gathered by torch indexing from an (n + 1)-row
                   table at uniform random indices (the script's `take`)
    blocks         the level-0 rows as the accumulation makes them
                   (`AffineAccum.blocks`: block offsets, indices, gather)
    phase1         K6 on the M pairs
    tree_mul       one K7 product at width M / 2
    batch_inverse  the whole `tree_inverse` of the M dens (3·⌈log2 M⌉ K7
                   products and one root inverse), timed three ways: between
                   two CUDA events (`device_ms`), by the host clock ending in
                   a synchronise (`host_ms`), and under `torch.profiler`:
                   its kernels' device time (`kernel_ms`), each K7 launch's
                   in launch order (`k7_us`), the copies' (`other_us`), the
                   launches, and `busy_share` = kernel_ms / device_ms (the
                   rest of the interval the card waits on the host)
    phase3         K8 on the M pairs
    accumulate     the whole batch-affine accumulation of the MSM
                   (`AffineAccum.accumulate`: blocks, v levels, the scan)

`equal`: K6's and K8's outputs on the first EQUAL_PAIRS pairs equal their
plain versions on the same rows. One JSON line, with the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys

import torch

from . import _native
from . import bench as B
from . import toolkit as T
from .ops import msm_affine as MA
from .ops.msm_plane import PlaneMsm

EQUAL_PAIRS = 1024


def trace_inverse(inv) -> dict:
    """One inv() under `torch.profiler` (CUDA activity): the device time of
    all its kernels and copies (`kernel_ms`), of K7's launches in launch
    order (`k7_us`, the tree's levels: up-sweep, root, down-sweep) and of
    the rest (`other_us`, the `torch.cat` copies)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        inv()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    k7 = [e.time_range.elapsed_us() for e in events if "affine_tree_mul" in e.name]
    total = sum(e.time_range.elapsed_us() for e in events)
    return {"kernel_ms": total / 1e3, "k7_us": k7, "other_us": total - sum(k7)}


def run(log_n: int, c: int, iters: int, device) -> dict:
    dev = T.resolve(device)
    inp = B.make_inputs(log_n, signed=True, c=c, group="g1", device=dev)
    plan = PlaneMsm(c, inp.curve.fr.num_bits, "g1", signed=True, affine=True)
    perm, start, length = plan._buckets(inp.digits.t().contiguous())
    mean = max(1, inp.n // plan.nb)
    acc = MA.AffineAccum(plan)
    blocks = lambda: acc.blocks(inp.table, perm, start, length, inp.n, mean)  # noqa: E731
    rows, sgn, _, _, B0 = blocks()
    M = rows.shape[0] // 2
    slots = rows.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, inp.n + 1, (slots,), generator=gen, device=dev)
    table_s = torch.cat([inp.table, inp.table.new_zeros((1, inp.table.shape[1]))])
    out = {"tool": "profile_affine_stages", "log_n": log_n, "c": c, "W": plan.W,
           "B0": B0, "slots": slots, "pairs": M}
    out["gather_ms"] = T.time_ms(lambda: table_s[idx], dev, iters)
    out["blocks_ms"] = T.time_ms(blocks, dev, iters)
    out["phase1_ms"], (den, cls) = T.timed(lambda: MA.affine_phase1(rows, sgn), dev, iters)
    h = M // 2
    a, b = den[:h].contiguous(), den[h : 2 * h].contiguous()
    out["tree_mul_ms"] = T.time_ms(lambda: MA.affine_tree_mul(a, b), dev, iters)
    inv = lambda: MA.batch_inverse(den)  # noqa: E731
    t_inv, dinv = T.timed(inv, dev, iters)
    inv_rec = {"device_ms": t_inv, "host_ms": T.host_ms(inv, dev, iters)}
    if dev.type == "cuda":
        before = _native.LAUNCHES.copy()
        inv_rec.update(trace_inverse(inv))
        inv_rec["launches"] = {k: v - before.get(k, 0) for k, v in _native.LAUNCHES.items()
                               if v != before.get(k, 0)}
        inv_rec["busy_share"] = inv_rec["kernel_ms"] / inv_rec["device_ms"]
    out["batch_inverse"] = inv_rec
    out["phase3_ms"], rows3 = T.timed(lambda: MA.affine_phase3(rows, sgn, dinv, cls), dev, iters)
    out["accumulate_ms"] = T.time_ms(
        lambda: acc.accumulate(inp.table, perm, start, length, inp.n, mean), dev, iters)
    k = min(EQUAL_PAIRS, M)
    r_k, s_k = rows[: 2 * k], sgn[: 2 * k]
    d_k, c_k = MA.affine_phase1_plain(r_k, s_k, "g1")
    out["equal"] = bool(
        torch.equal(d_k, den[:k]) and torch.equal(c_k, cls[:k])
        and torch.equal(MA.affine_phase3_plain(r_k, s_k, dinv[:k], cls[:k], "g1"),
                        rows3[:k]))
    return {**out, "iters": iters, **T.card(dev)}


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(os.environ.get("LOG_N", "20")))
    ap.add_argument("--window", type=int, default=13)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    rec = T.emit(run(a.log_n, a.window, a.iters, a.device))
    return 0 if rec["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
