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
    batch_inverse  the M dens' inverses, K19 (`batch_inverse`: three
                   launches), timed three ways: between two CUDA events
                   (`device_ms`), by the host clock ending in a synchronise
                   (`host_ms`), and under `torch.profiler`: its kernels'
                   device time (`kernel_ms`), each K19 launch's in launch
                   order (`kernel_us`: up, top, down), the rest's
                   (`other_us`), the launches, and `busy_share` =
                   kernel_ms / device_ms (the rest of the interval the card
                   waits on the host)
    tree_inverse   the former batch inverse, timed the same three ways:
                   `tree_inverse` on K7 (3·⌈log2 M⌉ products and one root
                   inverse; `kernel_us` its K7 launches, `other_us` its
                   `torch.cat` copies)
    phase3         K8 on the M pairs
    accumulate     the whole batch-affine accumulation of the MSM
                   (`AffineAccum.accumulate`: blocks, v levels, the scan)

`equal`: K6's and K8's outputs on the first EQUAL_PAIRS pairs equal their
plain versions on the same rows, and the two batch inverses are equal. One JSON line, with the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys

import torch

from . import _native
from . import bench as B
from . import toolkit as T
from .fields.limbs import fields_of
from .ops import msm_affine as MA
from .ops.msm_plane import PlaneMsm

EQUAL_PAIRS = 1024


def trace(fn, kernel: str) -> dict:
    """One fn() under `torch.profiler` (CUDA activity): the device time of
    all its kernels and copies (`kernel_ms`), of the launches whose name
    holds `kernel` in launch order (`kernel_us`) and of the rest
    (`other_us`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    own = [e.time_range.elapsed_us() for e in events if kernel in e.name]
    total = sum(e.time_range.elapsed_us() for e in events)
    return {"kernel_ms": total / 1e3, "kernel_us": own, "other_us": total - sum(own)}


def inverse_record(fn, kernel: str, dev, iters: int):
    """fn() timed by CUDA events, by the host clock and (on a card) under
    the profiler, with its launches -> (record, fn's output)."""
    t, out = T.timed(fn, dev, iters)
    rec = {"device_ms": t, "host_ms": T.host_ms(fn, dev, iters)}
    if dev.type == "cuda":
        before = _native.LAUNCHES.copy()
        rec.update(trace(fn, kernel))
        rec["launches"] = {k: v - before.get(k, 0) for k, v in _native.LAUNCHES.items()
                           if v != before.get(k, 0)}
        rec["busy_share"] = rec["kernel_ms"] / rec["device_ms"]
    return rec, out


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
    out["batch_inverse"], dinv = inverse_record(lambda: MA.batch_inverse(den), "affine_inverse_",
                                                dev, iters)
    one = MA.from_words(MA._field_one(1, fields_of(inp.curve)[1], dev))
    out["tree_inverse"], tree = inverse_record(
        lambda: MA.tree_inverse(den, MA.affine_tree_mul, MA.affine_inverse, one),
        "affine_tree_mul", dev, iters)
    out["phase3_ms"], rows3 = T.timed(lambda: MA.affine_phase3(rows, sgn, dinv, cls), dev, iters)
    out["accumulate_ms"] = T.time_ms(
        lambda: acc.accumulate(inp.table, perm, start, length, inp.n, mean), dev, iters)
    k = min(EQUAL_PAIRS, M)
    r_k, s_k = rows[: 2 * k], sgn[: 2 * k]
    d_k, c_k = MA.affine_phase1_plain(r_k, s_k, "g1")
    out["equal"] = bool(
        torch.equal(d_k, den[:k]) and torch.equal(c_k, cls[:k])
        and torch.equal(MA.affine_phase3_plain(r_k, s_k, dinv[:k], cls[:k], "g1"),
                        rows3[:k])
        and torch.equal(dinv, tree))
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
