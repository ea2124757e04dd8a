"""Decomposition micro-benchmark of the port: which part of the
float32-digit Montgomery product costs what, and whether tensor cores help
its reduction.

    python -m snark_tpu_torch.bench_reduce_parts [lanes]

The counterpart of the repository's `scripts/bench_reduce_parts.py`, with
its shapes (digit planes of BN254 Fq with two extra digits, R8 = 34, on
`lanes` = 256·512 lanes; the script's BENCH_LANES), its 256 Montgomery
pairs tiled, its depth (8) and its five lines, all through K16
`reduce_parts_chain` (`ops/mul_parts.py`):

    A T=512    mont_mul, constant multiplies as band products (tensor cores)
    B T=512    the product and sweeps only, not a product
    C T=512    mont_mul, constant multiplies as scalar FMAs
    A T=2048   as A, the TPU's 2048 lanes a grid step
    C T=2048   as C, the TPU's 2048 lanes a grid step

T is the script's TPU block width; on the card it only names the line and
divides the lanes, and both T launch the same geometry (`ops/mul_parts.py`
`launch_geometry`, `csrc/mul_parts.cu`). The script's variant A passes
`plus_p` twice and raises (`scripts/bench_reduce_parts.py:84-86`); the port
runs what it means, `mont_mul(A, B, t_ref, carry, plus_p=2p, m_np=M_NP,
m_p=M_P)`.

Each line runs for 0.1 s to bring the card's clocks up, then times `iters`
calls between two CUDA events, and reports ms a call, M muls/s, ns a mul,
its bound, the share of the bound (bound / ms), the peak device memory of
its chain and `correct`. The bound is the largest of its FP32 instructions
over 33.45e12/s, for A its useful bf16 multiply-adds (unpadded) over the
dense bf16 rate of 989 TFLOP/s, and its bytes over 3.35e12/s (the H100
SXM's published peaks).

Unlike the script, every line's output is checked:

- on the card, equal to its plain PyTorch version on the same inputs;
- on every device, every lane equal to its lane mod 256, and on the first
  256 lanes against host integers: A and C equal a·b^8 in Montgomery form
  (`unpack_np`), and B's value mod R = 256^R8 equals the recurrence
  v <- v·b + 2p mod R (sweeps drop only multiples of R);
- A and C equal K15's plain chain at depth 8 (the script's own check,
  C == A, extended).

On the CPU, `run` computes the lines with the plain versions, checks them
and times nothing; without a card, `main` exits non-zero.
"""

from __future__ import annotations

import json
import sys

import torch

from . import bench_vpu_peak as BV
from .ops import mul_parts as MP
from .ops import vpu_peak as V

LANES = BV.LANES
LINES = (("A", 512), ("B", 512), ("C", 512), ("A", 2048), ("C", 2048))
LABEL = {"A": "full mont_mul", "B": "conv+sweeps", "C": "vpu-band"}
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (published)


def bound_ms(fp32_ops: float, mma_macs: float, nbytes: float) -> tuple[float, str]:
    """The least time for the FP32 instructions, the bf16 multiply-adds
    (two FLOPs each) and the bytes: (ms, "operations" or "bytes")."""
    t_ops = max(fp32_ops / BV.PEAK_FP32, 2 * mma_macs / PEAK_BF16) * 1e3
    t_bytes = nbytes / BV.PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def values_mod_r(planes: torch.Tensor) -> list[int]:
    """Each lane's digit column as an integer mod R = 256^R8."""
    d = planes.detach().cpu().to(torch.int64).tolist()
    R = 1 << (8 * len(d))
    return [sum(int(row[j]) << (8 * i) for i, row in enumerate(d)) % R for j in range(len(d[0]))]


def skeleton_oracle(a: torch.Tensor, b: torch.Tensor, reps: int) -> list[int]:
    """B's values mod R: v <- v·b + 2p, reps times."""
    R = 1 << (8 * V.ROWS)
    p2 = 2 * V.plane_field().params.modulus
    out = []
    for v, w in zip(values_mod_r(a), values_mod_r(b)):
        for _ in range(reps):
            v = (v * w + p2) % R
        out.append(v)
    return out


def run(lanes: int = LANES, device="cuda", iters: int = 5) -> dict:
    """Run the five lines; -> {"lanes", "device", "lines": [...],
    "correct"}. Each line: line, kind, T, kernel (its launch counter),
    reps, lanes, ms, muls_per_s, ns_per_mul, ops, mma_macs, bytes,
    bound_ms, bound_by, bound_share, max_memory_allocated (the timed fields
    None on the CPU), correct."""
    device = torch.device(device)
    if lanes <= 0 or lanes % max(MP.PARTS_T):
        raise ValueError(f"lanes: a positive multiple of {max(MP.PARTS_T)}, got {lanes}")
    cuda = device.type == "cuda"
    pf = V.plane_field()
    am, bm = BV.mont_inputs(lanes, device)
    hs = slice(0, BV.PAIRS)
    reps = MP.REPS
    mont = BV.mont_oracle(reps)
    k15 = V.mont_mul_chain_plain(am, bm, reps)
    skeleton = skeleton_oracle(am[:, hs], bm[:, hs], reps)
    plane_bytes = V.ROWS * lanes * 4
    lines = []
    for kind, T in LINES:
        def fn(kind=kind, T=T):
            return MP.reduce_parts_chain(am, bm, kind, T, reps)

        out, ms, mem = BV.timed(fn, iters, cuda, device)
        checks = [BV.tiles_equal(out, BV.PAIRS)]
        if cuda:
            checks.append(torch.equal(out, MP.reduce_parts_chain_plain(am, bm, kind, T, reps)))
        if kind == "B":
            checks.append(values_mod_r(out[:, hs]) == skeleton)
        else:
            checks += [pf.unpack_np(out[:, hs]) == mont, torch.equal(out, k15)]
        ops, macs = MP.parts_ops(kind) * reps * lanes, MP.parts_mma_macs(kind) * reps * lanes
        nbytes = 3 * plane_bytes + (MP.band_fragments().nbytes if kind == "A" else 0)
        b_ms, by = bound_ms(ops, macs, nbytes)
        muls = reps * lanes
        lines.append({
            "line": f"{kind} {LABEL[kind]} T={T}", "kind": kind, "T": T,
            "kernel": f"reduce_parts_chain_{kind}_{T}", "reps": reps, "lanes": lanes, "ms": ms,
            "muls_per_s": None if ms is None else muls / (ms * 1e-3),
            "ns_per_mul": None if ms is None else ms * 1e6 / muls,
            "ops": ops, "mma_macs": macs, "bytes": nbytes, "bound_ms": b_ms, "bound_by": by,
            "bound_share": None if ms is None else b_ms / ms, "max_memory_allocated": mem,
            "correct": all(checks),
        })
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    return {"lanes": lanes, "device": name, "lines": lines,
            "correct": all(rec["correct"] for rec in lines)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("snark_tpu_torch.bench_reduce_parts: no CUDA device")
    from .bench import nvidia_smi

    lanes = int(argv[0]) if argv else LANES
    res = run(lanes)
    print(f"lanes = {lanes}, R8 = {V.ROWS} (BN254 Fq, 2 extra digits), device {res['device']}")
    for rec in res["lines"]:
        print(f"{rec['line']:24s}: {rec['muls_per_s'] / 1e6:8.1f} M muls/s "
              f"({rec['ns_per_mul']:6.4f} ns/mul, {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"by {rec['bound_by']}, {100 * rec['bound_share']:.1f}%)  "
              f"peak {rec['max_memory_allocated']} B  {'correct' if rec['correct'] else 'WRONG'}")
    res["nvidia_smi"] = nvidia_smi()
    print(json.dumps(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
