"""Does a gather on a second stream hide behind the bucket scan's products?

    python -m snark_tpu_torch.bench_scan_overlap [--lanes L] [--log-table T] [--steps S]
                                                 [--iters K] [--device cuda|cpu]

The counterpart of the repository's `scripts/bench_scan_overlap.py`: S (64)
scan steps of K1's mixed add on L (81,920) lanes, BN254 G1, rows from a
2^T-row table (T = 21, 145 MB, three times the card's 50 MB L2; the rows
tile the 64-point pool of `bench.make_inputs`) at uniform random indices,
one K1 launch a step. On the TPU the script's variants ask whether XLA
overlaps a DMA gather with the Pallas call; on this card they mean:

    nogather   K1 on the same contiguous rows at every step, perm = iota
               (lane l reads row l): the products with the cheapest reads,
               the floor
    dep        the shipped step: K1 gathers its lanes' rows from the table
               itself, through perm, inside the kernel (`ops/curve.py`
               `bucket_madd_rows`), each step after the last
    dep_torch  the rows of a step gathered by torch (`index_select` into
               a preallocated contiguous buffer), then K1 on it with
               perm = iota, on one stream: gather and products in turn
    pipe       as dep_torch, but the next step's gather runs on a second
               CUDA stream into the other of two buffers while K1 runs
               the current step (the script's software pipeline); each K1
               waits only for its own rows, each gather only for the K1
               that last read its buffer

Each is the mean of K (3) runs of the S steps after a warm-up, between
CUDA events; the line gives ms a step and the gather's tax over
`nogather` for each. `equal`: dep, dep_torch and pipe give the same
accumulators. On the CPU (the plain versions) there is no second stream
and pipe runs as dep_torch. One JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import toolkit as T
from .bench import POOL, host_curve
from .ops.curve import bucket_madd_rows, identity, pack_rows_u8


def run(lanes: int, log_table: int, steps: int, iters: int, device) -> dict:
    dev = T.resolve(device)
    hc = host_curve("g1")
    pool = pack_rows_u8([hc.scalar_mul(hc.generator, k + 1) for k in range(POOL)], "g1")
    n_table = 1 << log_table
    table = torch.as_tensor(np.tile(pool, (-(-n_table // POOL), 1))[:n_table], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    idxs = torch.randint(0, n_table, (steps, lanes), generator=gen, device=dev,
                         dtype=torch.int32)
    iota = torch.arange(lanes, dtype=torch.int32, device=dev)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
    ones = torch.ones(lanes, dtype=torch.int32, device=dev)
    acc0 = identity(lanes, "g1", dev)
    fixed = table[idxs[0].long()]
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def k1(acc, rows, perm):
        return bucket_madd_rows(acc, rows, perm, zeros, iota, ones, 0, 1, "g1")

    def nogather():
        acc = acc0
        for _ in range(steps):
            acc = k1(acc, fixed, iota)
        return acc

    def dep():
        acc = acc0
        for i in range(steps):
            acc = k1(acc, table, idxs[i])
        return acc

    bufs = [torch.empty_like(fixed), torch.empty_like(fixed)]

    def gather(i: int, out: torch.Tensor) -> None:
        torch.index_select(table, 0, idxs[i], out=out)

    def dep_torch():
        acc = acc0
        for i in range(steps):
            gather(i, bufs[0])
            acc = k1(acc, bufs[0], iota)
        return acc

    def pipe():
        """Two row buffers in turn: the side stream gathers step i + 1 into
        one after K1 of step i − 1 has read it, while K1 of step i reads
        the other; K1 of step i + 1 waits for that gather."""
        if dev.type != "cuda":
            return dep_torch()
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            gather(0, bufs[0])
        main.wait_stream(side)
        acc = acc0
        for i in range(steps):
            if i + 1 < steps:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    gather(i + 1, bufs[(i + 1) % 2])
            acc = k1(acc, bufs[i % 2], iota)
            main.wait_stream(side)
        return acc

    variants = {"nogather": nogather, "dep": dep, "dep_torch": dep_torch, "pipe": pipe}
    ms, outs = {}, {}
    for name, fn in variants.items():
        ms[name], outs[name] = T.timed(fn, dev, iters)
    rec = {"tool": "bench_scan_overlap", "lanes": lanes, "table_rows": n_table, "steps": steps}
    for name in variants:
        rec[f"{name}_ms_per_step"] = ms[name] / steps
        if name != "nogather":
            rec[f"gather_tax_{name}_ms"] = (ms[name] - ms["nogather"]) / steps
    rec["equal"] = bool(torch.equal(outs["dep"], outs["dep_torch"])
                        and torch.equal(outs["dep"], outs["pipe"]))
    return {**rec, "iters": iters, **T.card(dev)}


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("--lanes", type=int, default=81920)
    ap.add_argument("--log-table", type=int, default=21)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    rec = T.emit(run(a.lanes, a.log_table, a.steps, a.iters, a.device))
    return 0 if rec["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
