"""In-context decomposition of the bucket scan's kernel K1 on one CUDA
card: how its time splits between the products, the add/sub glue and the
row gather and decode.

    python -m snark_tpu_torch.bench_madd_parts

The counterpart of the repository's `scripts/bench_madd_parts.py`. Like
the script, it times the whole window-sum pipeline (`PlaneMsm.window_sums`:
the sort, both K1 launches of the scan and its spill, the folds) at
2^BENCH_LOG_N points (20 by default), signed c = 13, BN254 G1, on a table
that tiles a pool of 64 points (`bench.make_inputs`), once for each body of
K1 (`ops/madd_parts.py`), so that every number includes the gather, the
identity skip and the loop exactly as the prover runs them. Each line
builds a fresh plan, runs it once, then times 3 calls, each ending in a
readback. The script's seven lines, in its order:

    full      the shipped K1 (correct: the window sums, combined on the
              host, equal the pool oracle)
    nosub     Alg 8's 13 products without its add/sub glue  [wrong math]
    halfmul   6 of the products                             [wrong math]
    sweep2    no counterpart (below)
    sweep1    no counterpart
    vpu       no counterpart
    nodecode  Q built from the accumulator, no row decode   [wrong math]

The port's K1 works on 32-bit Montgomery limbs with reduced products
(`csrc/field.cuh`): it has no digit sweeps for `sweep2` and `sweep1` to
cut and no band products for `vpu` to turn off. What those lines ask is
priced on the card by K17 (`bench_bisect_mul`, the sweeps) and by K16 A
against C (`bench_reduce_parts`, band products on tensor cores against
scalar FMAs). The script's BENCH_TILE, the TPU block width of its rows
kernel, has no counterpart either: K1's block is fixed at
`kCurveBlock = 128` threads (`csrc/curve_kernels.cuh`), and this module
does not read the variable.

Each line with a counterpart gives ms a call, M adds/s with adds = n·W as
the script counts them, the ratio to `full`, the peak device memory and
the bound of its scan: the rows it adds (the nonzero digits) times its
products (`PRODUCTS`: 11, 11, 5, 11) times 264 32-bit multiply-adds and
its row decodes (`DECODES`: 2, 2, 2, 0) times 17, over 1.67e13/s, or its
bytes (a row and a payload word an add, the flag byte
and the payload for `nodecode`; the accumulators and runs once a lane)
over 3.35e12/s, whichever is longer; the sort and the folds are left out.
On the CPU, `run` computes the lines with the plain versions, checks
`full` and times nothing; without a card, `main` exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from . import _native
from . import bench as B
from .bench_vpu_peak import PEAK_IMAD, bound_ms
from .ops import curve as C
from .ops.madd_parts import DECODES, PRODUCTS
from .ops.msm_plane import PlaneMsm

C_WINDOW = 13
LINES = ("full", "nosub", "halfmul", "sweep2", "sweep1", "vpu", "nodecode")
NO_COUNTERPART = {
    "sweep2": "the port's K1 works on 32-bit Montgomery limbs with reduced products "
              "(csrc/field.cuh): it has no digit sweeps to cut; K17 (bench_bisect_mul) "
              "prices the sweeps on the card",
    "vpu": "the port's K1 runs no band products to turn off (32-bit limb products, "
           "csrc/field.cuh); K16 A against C (bench_reduce_parts) prices band products "
           "on tensor cores against scalar FMAs on the card",
}
NO_COUNTERPART["sweep1"] = NO_COUNTERPART["sweep2"]


def kernel_of(part: str) -> str:
    """The launch counter of a part's K1."""
    return "bucket_madd_rows_g1" if part == "full" else f"bucket_madd_rows_part_{part}"


def scan_bound(part: str, scan_adds: int, lanes: int) -> tuple[float, str]:
    """(ms, "operations" or "bytes") of a part's scan over `scan_adds` rows
    on `lanes` lanes."""
    row = 1 if part == "nodecode" else C.row_bytes("g1")
    point = 3 * C.limbs_of() * 4
    nbytes = scan_adds * (row + 4) + lanes * (2 * point + 12)
    L = C.limbs_of()
    imads = PRODUCTS[part] * C.imad_per_mul(L) + DECODES[part] * C.imad_per_decode(L)
    return bound_ms(scan_adds * imads, PEAK_IMAD, nbytes)


def _line(part: str, inp: B.BenchInputs, iters: int, scan_adds: int) -> dict:
    """One line: a fresh plan with K1 body `part`, one run, `iters` timed
    runs (none on the CPU)."""
    dev = inp.table.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    plan = PlaneMsm(inp.c, inp.curve.fr.num_bits, "g1", signed=True, part=part)
    sums = plan.window_sums(inp.table, inp.digits).cpu()
    ms = None
    if cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            plan.window_sums(inp.table, inp.digits).cpu()
        ms = (time.perf_counter() - t0) / iters * 1e3
    adds = inp.n * plan.W
    b_ms, by = scan_bound(part, scan_adds, plan.lanes)
    return {
        "line": part, "counterpart": kernel_of(part), "ms": ms,
        "adds": adds, "adds_per_s": None if ms is None else adds / (ms * 1e-3),
        "scan_adds": scan_adds, "bound_ms": b_ms, "bound_by": by,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "correct": plan.combine_host(sums, B.host_curve("g1")) == inp.want
        if part == "full" else None,
        "note": None if part == "full" else "wrong math by design",
    }


def run(log_n: int | None = None, device="cuda", iters: int = 3,
        inputs: B.BenchInputs | None = None) -> dict:
    """The seven lines -> {"log_n", "n", "c", "windows", "device", "lines",
    "correct"} (`correct`: the `full` line's). `inputs`: BN254 G1 with
    signed digits, as `bench.make_inputs` makes them; when None, the
    script's, made here at 2^log_n points (BENCH_LOG_N), c = 13. A smaller
    c suits checks on a CPU, where the plain folds of c = 13's 81,920
    lanes take most of a minute a line."""
    if inputs is None:
        log_n = int(os.environ.get("BENCH_LOG_N", "20")) if log_n is None else log_n
        inputs = B.make_inputs(log_n, signed=True, c=C_WINDOW, group="g1", device=device)
    inp = inputs
    if (inp.group, inp.signed, inp.curve.name) != ("g1", True, "bn254"):
        raise ValueError("inputs: BN254 G1, signed digits")
    scan_adds = int((inp.digits != 0).sum())
    lines = []
    for line in LINES:
        if line in NO_COUNTERPART:
            lines.append({"line": line, "counterpart": None, "reason": NO_COUNTERPART[line]})
        else:
            lines.append(_line(line, inp, iters, scan_adds))
    full = lines[0]
    for rec in lines:
        if rec.get("ms") is not None:
            rec["ratio_to_full"] = rec["ms"] / full["ms"]
    dev = inp.table.device
    return {
        "log_n": inp.n.bit_length() - 1, "n": inp.n, "c": inp.c, "windows": inp.digits.shape[1],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "lines": lines, "correct": bool(full["correct"]),
    }


def format_line(rec: dict) -> str:
    """The script's line, with the ratio, the bound, the peak memory and the
    verdict after it."""
    label = rec["line"]
    if rec["counterpart"] is None:
        return f"{label:9s}: counterpart: null ({rec['reason']})"
    dt = rec["ms"] * 1e-3
    verdict = "correct" if rec["correct"] else rec["note"] or "WRONG"
    return (f"{label:9s}: {dt*1e3:8.1f} ms  ({rec['adds']/dt/1e6:6.1f} M adds/s)  "
            f"{rec['ratio_to_full']:.3f}x full; bound {rec['bound_ms']:.3f} ms by "
            f"{rec['bound_by']}; peak {rec['max_memory_allocated']} B; {verdict}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("snark_tpu_torch.bench_madd_parts: no CUDA device")
    res = run()
    print(f"n = 2^{res['log_n']}, signed c = {res['c']}, {res['windows']} windows, BN254 G1, "
          f"device {res['device']}", flush=True)
    for rec in res["lines"]:
        print(format_line(rec), flush=True)
    res["nvidia_smi"] = B.nvidia_smi()
    res["launches"] = {k: v for k, v in _native.LAUNCHES.items() if v}
    print(json.dumps(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
