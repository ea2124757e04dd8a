"""Bisection micro-benchmark of the port: where the float32-digit
Montgomery product's time goes, between its digit convolution and its
carry sweeps.

    python -m snark_tpu_torch.bench_bisect_mul [lanes]

The counterpart of the repository's `scripts/bench_bisect_mul.py`, with its
shapes (digit planes of BN254 Fq with two extra digits, R8 = 34, on `lanes`
= 256·512 lanes; the script's BENCH_LANES, T = 512), its 256 Montgomery
pairs tiled, its depth (8) and its six lines, all through K17
`bisect_chain` (`ops/mul_parts.py`):

    conv0    mul_acc, then A = t[:R8]·1e-7
    conv1    mul_acc, then one sweep of t[:R8]
    conv3    mul_acc, then sweep3
    conv9    mul_acc, then sweep3 three times
    sweep9   nine sweeps, then +1; no product
    convreg  the product summed as values (a register sum per digit), sweep3

Each line runs for 0.1 s to bring the card's clocks up, then times `iters`
calls between two CUDA events, and reports, in the script's units, M ops/s,
ns an op and ms a call, with its bound (its FP32 instructions over
33.45e12/s or its bytes over 3.35e12/s, the H100 SXM's published peaks),
the share of the bound, the peak device memory and `correct`.

Unlike the script, every line's output is checked:

- on the card, equal to its plain PyTorch version bit for bit;
- on every device, every lane equal to its lane mod 256, and on the first
  256 lanes against the host: conv0 and conv1, whose values leave the
  integers below 2^24, equal a numpy float32 recurrence in the same order
  (subnormals kept: conv0's smallest values fall below 2^-126 by depth 8);
  conv3, conv9 and convreg give values mod R = 256^R8 equal to a·b^8 mod R
  (a sweep drops only multiples of R, and the low half of a product is the
  product mod R), sweep9 a + 8·(R − 1)/255 mod R.

On the CPU, `run` computes the lines with the plain versions, checks them
and times nothing; without a card, `main` exits non-zero.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import bench_vpu_peak as BV
from .bench_reduce_parts import bound_ms, values_mod_r
from .ops import mul_parts as MP
from .ops import vpu_peak as V

LANES = BV.LANES


def host_float_chain(a: np.ndarray, b: np.ndarray, kind: str, reps: int) -> np.ndarray:
    """conv0 or conv1 in numpy float32: each product and sum rounded, rows
    of A over increasing i, as the plain version."""
    R8 = a.shape[0]
    A = a.astype(np.float32)
    for _ in range(reps):
        t = np.zeros((2 * R8, A.shape[1]), np.float32)
        for i in range(R8):
            t[i : i + R8] += A[i] * b
        if kind == "conv0":
            A = t[:R8] * np.float32(MP.CONV_SCALE)
        else:
            c = np.floor(t[:R8] * np.float32(1.0 / 256.0))
            r = t[:R8] - np.float32(256.0) * c
            A = np.concatenate([r[:1], r[1:] + c[:-1]], axis=0)
    return A


def host_values(a: torch.Tensor, b: torch.Tensor, kind: str, reps: int) -> list[int]:
    """The integer kinds' values mod R after `reps` steps."""
    R = 1 << (8 * V.ROWS)
    ones = (R - 1) // 255  # a 1 in every digit
    out = []
    for v, w in zip(values_mod_r(a), values_mod_r(b)):
        for _ in range(reps):
            v = (v + ones) % R if kind == "sweep9" else v * w % R
        out.append(v)
    return out


def run(lanes: int = LANES, device="cuda", iters: int = 5) -> dict:
    """Run the six lines; -> {"lanes", "device", "lines": [...],
    "correct"}. Each line: line, kernel (its launch counter), reps, lanes,
    ms, ops_per_s, ns_per_op, ops, bytes, bound_ms, bound_by, bound_share,
    max_memory_allocated (the timed fields None on the CPU), correct."""
    device = torch.device(device)
    if lanes <= 0 or lanes % MP.BISECT_T:
        raise ValueError(f"lanes: a positive multiple of {MP.BISECT_T}, got {lanes}")
    cuda = device.type == "cuda"
    am, bm = BV.mont_inputs(lanes, device)
    hs = slice(0, BV.PAIRS)
    a_np, b_np = (x[:, hs].cpu().numpy() for x in (am, bm))
    reps = MP.REPS
    lines = []
    for kind in MP.BISECT_KINDS:
        def fn(kind=kind):
            return MP.bisect_chain(am, bm, kind, reps)

        out, ms, mem = BV.timed(fn, iters, cuda, device)
        checks = [BV.tiles_equal(out, BV.PAIRS)]
        if cuda:
            checks.append(torch.equal(out, MP.bisect_chain_plain(am, bm, kind, reps)))
        if kind in ("conv0", "conv1"):
            want = host_float_chain(a_np, b_np, kind, reps)
            checks.append(np.array_equal(out[:, hs].cpu().numpy(), want))
        else:
            checks.append(values_mod_r(out[:, hs]) == host_values(am[:, hs], bm[:, hs], kind, reps))
        ops = MP.bisect_ops(kind) * reps * lanes
        nbytes = 3 * V.ROWS * lanes * 4
        b_ms, by = bound_ms(ops, 0, nbytes)
        n = reps * lanes
        lines.append({
            "line": kind, "kernel": f"bisect_chain_{kind}", "reps": reps, "lanes": lanes,
            "ms": ms, "ops_per_s": None if ms is None else n / (ms * 1e-3),
            "ns_per_op": None if ms is None else ms * 1e6 / n, "ops": ops, "bytes": nbytes,
            "bound_ms": b_ms, "bound_by": by, "bound_share": None if ms is None else b_ms / ms,
            "max_memory_allocated": mem, "correct": all(checks),
        })
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    return {"lanes": lanes, "device": name, "lines": lines,
            "correct": all(rec["correct"] for rec in lines)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("snark_tpu_torch.bench_bisect_mul: no CUDA device")
    from .bench import nvidia_smi

    lanes = int(argv[0]) if argv else LANES
    res = run(lanes)
    print(f"lanes = {lanes}, R8 = {V.ROWS} (BN254 Fq, 2 extra digits), device {res['device']}")
    for rec in res["lines"]:
        print(f"{rec['line']:8s}: {rec['ops_per_s'] / 1e6:8.1f} M/s ({rec['ns_per_op']:7.4f} ns/op, "
              f"total {rec['ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
              f"{100 * rec['bound_share']:.1f}%)  peak {rec['max_memory_allocated']} B  "
              f"{'correct' if rec['correct'] else 'WRONG'}")
    res["nvidia_smi"] = nvidia_smi()
    print(json.dumps(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
