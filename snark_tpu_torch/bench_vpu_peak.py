"""Roofline micro-benchmark of the port: the FP32 rate of one card and the
cost of the float32-digit Montgomery product against it.

    python -m snark_tpu_torch.bench_vpu_peak [lanes]

The counterpart of the repository's `scripts/bench_vpu_peak.py`, with its
shapes (digit planes of BN254 Fq with two extra digits, R8 = 34, on
`lanes` = 256·512 lanes; the script's BENCH_LANES) and its five lines,
each chained as deep as there:

    fma       K12 fma_chain: acc <- acc·b + a, 256 deep       T FMA/s
    sweep     K13 sweep_chain: z <- sweep(z) + 1, 64 deep     G sweeps/s
    conv      K14 conv_chain: t = A·B, A <- t[:R8]·1e-7, 8    T FMA/s effective (R8² a lane a rep)
    mont_mul  K15 mont_mul_chain: A <- A·B·R^-1 + 2p, 32 deep M muls/s
    madd      K1 bucket_madd_rows: 4 chained mixed adds of each
              lane's own row (81,920 lanes, 64 points of BN254 G1
              tiled), one step a launch                       M adds/s

The script's inputs are unseeded; here they come from a fixed seed. Where the
script sets BENCH_TILE (a TPU block width), `threads` sets threads per
block of K12-K15. Each line runs for 0.1 s to bring the card's clocks up
from idle, then times `iters` calls between two CUDA events, and reports ms a call, its rate in the script's unit, its
bound (the larger of its FP32 instructions over 33.45e12/s, or for madd its
32-bit multiply-adds over 1.67e13/s, and its bytes over 3.35e12/s: the
H100 SXM's published peaks) with what bounds it, the share of the bound
(bound / ms), the peak device memory of its chain, and `correct`.

Unlike the script, every line's output is checked:

- on the card, against its plain PyTorch version on the same inputs: FMA
  within rtol 1e-4 (the kernel rounds once a step, the plain version
  twice); sweep and mont_mul exactly; conv within rtol 1e-5 at depth 4
  (summation order and FMA fusion) and within rtol 1e-4 plus 8 subnormal
  ulps (8·2^-149) at depth 8, where every value is subnormal and a
  difference of one ulp in an input is a relative 1e-3 or so; madd exactly;
- on every device, on the first 256 lanes, against host references:
  float64 recurrences for FMA and for conv at depth 4, numpy float32
  recurrences, subnormals kept, for the sweep (exact) and for conv at depth
  8 (the depth-8 tolerance), the host field for mont_mul (a·b^32 in
  Montgomery form, via `unpack_np`), and the host curve for madd (every
  lane 4·P).

On the CPU, `run` computes the lines with the plain versions, checks them
against the host references and times nothing; without a card, `main`
exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .fields.params import BN254
from .ops import curve as C
from .ops import vpu_peak as V
from .ops.curve_host import host_g1

LANES = 256 * 512  # the script's BENCH_LANES default
MADD_LANES = 256 * 320  # the script's LAN (fewer lanes when `lanes` is smaller)
SEED = 0
REPS = {"fma": 256, "sweep": 64, "conv": 8, "mont_mul": 32, "madd": 4}
CONV_CHECK_REPS = 4  # the conv depth held within rtol: every value still normal
PAIRS = 256  # lanes checked against host references; mont_mul's tiled pairs
POOL = 64  # madd: distinct points, tiled
KERNEL = {
    "fma": "K12 fma_chain", "sweep": "K13 sweep_chain", "conv": "K14 conv_chain",
    "mont_mul": "K15 mont_mul_chain", "madd": "K1 bucket_madd_rows",
}
# each line's rate: its unit, the unit's scale, and the work a lane and rep
UNIT = {
    "fma": ("T FMA/s", 1e12, V.ROWS), "sweep": ("G sweeps/s", 1e9, 1),
    "conv": ("T FMA/s effective", 1e12, V.ROWS * V.ROWS), "mont_mul": ("M muls/s", 1e6, 1),
    "madd": ("M adds/s", 1e6, 1),
}
# H100 SXM published peaks: FP32 instructions (128 a clock on each of 132
# SMs at 1.98 GHz: 67 TFLOP/s counting an FMA as two), 32-bit integer
# multiply-adds (64 a clock), HBM bytes
PEAK_FP32 = 132 * 128 * 1.98e9
PEAK_IMAD = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12
# each line runs this long before it is timed: an idle card's clocks need
# milliseconds to rise, longer than a line's few timed calls
WARMUP_S = 0.1
FMA_RTOL = 1e-4
CONV_RTOL = 1e-5  # depth <= 5: every value normal
# depth 8: every value subnormal, float32's grid there 2^-149
CONV_RTOL_DEEP = 1e-4
CONV_ATOL_DEEP = 8 * 2.0**-149


def bound_ms(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """The least time for `ops` at `peak` a second and `nbytes` of memory
    traffic: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def float_inputs(lanes: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The script's a ~ U(1, 1.0001) and b ~ U(0.999, 1), (R8, lanes)."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(1.0, 1.0001, (V.ROWS, lanes)).astype(np.float32)
    b = rng.uniform(0.999, 1.0, (V.ROWS, lanes)).astype(np.float32)
    return a, b


def mont_values() -> tuple[list[int], list[int]]:
    """The script's 256 pairs of BN254 Fq values."""
    q = BN254.fq.modulus
    return ([(i * 12345 + 7) % q for i in range(PAIRS)],
            [(i * 999331 + 3) % q for i in range(PAIRS)])


def mont_inputs(lanes: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's pairs as Montgomery digit planes, tiled to `lanes`."""
    pf = V.plane_field()
    return tuple(torch.from_numpy(np.tile(pf.pack_np(v), (1, lanes // PAIRS))).to(device)
                 for v in mont_values())


def mont_oracle(reps: int) -> list[int]:
    """a·b^reps mod q for the script's pairs."""
    q = BN254.fq.modulus
    return [a * pow(b, reps, q) % q for a, b in zip(*mont_values())]


def host_fma(a: np.ndarray, b: np.ndarray, reps: int) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    acc = a.copy()
    for _ in range(reps):
        acc = acc * b + a
    return acc


def host_sweep(z: np.ndarray, reps: int) -> np.ndarray:
    """The sweep chain in numpy float32, step for step (exact)."""
    z = z.astype(np.float32)
    for _ in range(reps):
        c = np.floor(z * np.float32(1.0 / 256.0))
        r = z - np.float32(256.0) * c
        z = np.concatenate([r[:1], r[1:] + c[:-1]], axis=0) + np.float32(1.0)
    return z


def host_conv(a: np.ndarray, b: np.ndarray, reps: int, dtype=np.float64) -> np.ndarray:
    """The conv chain in numpy: float64, or float32 rounding each product
    and sum as the plain version does (subnormals kept)."""
    R8 = a.shape[0]
    A, B = a.astype(dtype), b.astype(dtype)
    for _ in range(reps):
        t = np.zeros((2 * R8, A.shape[1]), dtype)
        for i in range(R8):
            t[i : i + R8] += A[i] * B
        A = t[:R8] * dtype(np.float32(V.CONV_SCALE))
    return t


def _close(got: torch.Tensor, want, rtol: float = 0.0, atol: float = 0.0) -> bool:
    """got within rtol and atol of want (a tensor or numpy array), compared
    in float64; equal when both are 0."""
    want = torch.as_tensor(want, device=got.device, dtype=torch.float64)
    return bool(torch.allclose(got.to(torch.float64), want, rtol=rtol, atol=atol))


def tiles_equal(t: torch.Tensor, period: int) -> bool:
    """Every lane equals lane (index mod period): lanes on the last axis of
    a plane, on the first of a point batch."""
    if t.dim() == 2:
        v = t.reshape(t.shape[0], -1, period)
        return bool(torch.equal(v, v[:, :1].expand_as(v)))
    v = t.reshape(-1, period, *t.shape[1:])
    return bool(torch.equal(v, v[:1].expand_as(v)))


def timed(fn, iters: int, cuda: bool, device):
    """-> (fn(), ms a call or None, peak bytes or None)."""
    if not cuda:
        return fn(), None, None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()  # the output that is checked
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        fn()
        torch.cuda.synchronize(device)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize(device)
    return out, e0.elapsed_time(e1) / iters, torch.cuda.max_memory_allocated(device)


def madd_inputs(lanes: int, device):
    """K1's operands for the madd line: identity accumulators, the tiled
    rows of (k+1)·G, k < 64, and runs of one row, each lane its own."""
    hc = host_g1(BN254)
    pool = [hc.scalar_mul(hc.generator, k + 1) for k in range(POOL)]
    rows = C.pack_rows_u8(pool, "g1", BN254)
    table = torch.as_tensor(np.tile(rows, (lanes // POOL, 1)), device=device)
    idx = torch.arange(lanes, dtype=torch.int32, device=device)
    zero, one = torch.zeros_like(idx), torch.ones_like(idx)
    return pool, C.identity(lanes, "g1", device, BN254), table, idx, idx, zero, one


def run(
    lanes: int = LANES, threads: int = V.DEFAULT_THREADS, device="cuda", iters: int = 5
) -> dict:
    """Run the five lines; -> {"lanes", "madd_lanes", "threads", "device",
    "lines": [...], "correct"}. Each line: line, kernel, reps, lanes, ms,
    rate, unit, ops, bytes, bound_ms, bound_by, bound_share,
    max_memory_allocated (the timed fields None on the CPU), correct."""
    device = torch.device(device)
    if lanes <= 0 or lanes % PAIRS:
        raise ValueError(f"lanes: a positive multiple of {PAIRS}, got {lanes}")
    madd_lanes = min(MADD_LANES, lanes)
    cuda = device.type == "cuda"
    pf = V.plane_field()
    a_np, b_np = float_inputs(lanes, SEED)
    a, b = (torch.from_numpy(x).to(device) for x in (a_np, b_np))
    am, bm = mont_inputs(lanes, device)
    hs = slice(0, PAIRS)
    lines = []

    def line(name, fn, checks, n_lanes, ops, peak, nbytes):
        out, ms, mem = timed(fn, iters, cuda, device)
        unit, scale, per_lane = UNIT[name]
        work = REPS[name] * n_lanes * per_lane
        b_ms, by = bound_ms(ops, peak, nbytes)
        lines.append({
            "line": name, "kernel": KERNEL[name], "reps": REPS[name], "lanes": n_lanes,
            "ms": ms, "rate": None if ms is None else work / (ms * 1e-3) / scale,
            "unit": unit, "ops": ops, "bytes": nbytes, "bound_ms": b_ms, "bound_by": by,
            "bound_share": None if ms is None else b_ms / ms, "max_memory_allocated": mem,
            "correct": all(check(out) for check in checks),
        })
        return out

    plane_bytes = V.ROWS * lanes * 4
    R = REPS["fma"]
    line("fma", lambda: V.fma_chain(a, b, R, threads), [
        lambda out: not cuda or _close(out, V.fma_chain_plain(a, b, R), rtol=FMA_RTOL),
        lambda out: _close(out[:, hs], host_fma(a_np[:, hs], b_np[:, hs], R), rtol=FMA_RTOL),
    ], lanes, V.fma_ops(lanes, R), PEAK_FP32, 3 * plane_bytes)

    R = REPS["sweep"]
    line("sweep", lambda: V.sweep_chain(a, R, threads), [
        lambda out: not cuda or _close(out, V.sweep_chain_plain(a, R)),
        lambda out: _close(out[:, hs], host_sweep(a_np[:, hs], R)),
    ], lanes, V.sweep_ops(lanes, R), PEAK_FP32, 2 * plane_bytes)

    R, Rc = REPS["conv"], CONV_CHECK_REPS
    deep = {"rtol": CONV_RTOL_DEEP, "atol": CONV_ATOL_DEEP}
    line("conv", lambda: V.conv_chain(a, b, R, threads), [
        lambda out: not cuda or _close(out, V.conv_chain_plain(a, b, R), **deep),
        lambda out: not cuda or _close(V.conv_chain(a, b, Rc, threads),
                                          V.conv_chain_plain(a, b, Rc), rtol=CONV_RTOL),
        lambda out: _close(V.conv_chain(a, b, Rc, threads)[:, hs],
                              host_conv(a_np[:, hs], b_np[:, hs], Rc), rtol=CONV_RTOL),
        lambda out: _close(out[:, hs], host_conv(a_np[:, hs], b_np[:, hs], R, np.float32),
                              **deep),
    ], lanes, V.conv_ops(lanes, R), PEAK_FP32, 4 * plane_bytes)

    R = REPS["mont_mul"]
    line("mont_mul", lambda: V.mont_mul_chain(am, bm, R, threads=threads), [
        lambda out: not cuda or _close(out, V.mont_mul_chain_plain(am, bm, R)),
        lambda out: tiles_equal(out, PAIRS),
        lambda out: pf.unpack_np(out[:, hs]) == mont_oracle(R),
    ], lanes, R * lanes * V.mont_mul_ops(), PEAK_FP32, 3 * plane_bytes)

    R = REPS["madd"]
    pool, acc0, table, perm, lane_base, start, length = madd_inputs(madd_lanes, device)
    hc = host_g1(BN254)

    def madd_chain(step=C.bucket_madd_rows):
        acc = acc0
        for _ in range(R):
            acc = step(acc, table, perm, lane_base, start, length, 0, 1, "g1", BN254)
        return acc

    line("madd", madd_chain, [
        lambda out: not cuda or torch.equal(out, madd_chain(C.bucket_madd_rows_plain)),
        lambda out: tiles_equal(out, POOL),
        lambda out: C.limbs_to_points(out[:POOL], "g1", BN254)
        == [hc.scalar_mul(pt, R) for pt in pool],
    ], madd_lanes, R * madd_lanes * C.op_imads("madd_rows", "g1", BN254), PEAK_IMAD,
        table.numel() + 4 * 4 * madd_lanes + 2 * acc0.numel() * 4)

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    return {"lanes": lanes, "madd_lanes": madd_lanes, "threads": threads, "device": name,
            "lines": lines, "correct": all(rec["correct"] for rec in lines)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("snark_tpu_torch.bench_vpu_peak: no CUDA device")
    from .bench import nvidia_smi

    lanes = int(argv[0]) if argv else LANES
    res = run(lanes)
    print(f"lanes = {lanes}, R8 = {V.ROWS} (BN254 Fq, 2 extra digits), device {res['device']}")
    for rec in res["lines"]:
        print(f"{rec['line']:9s} {rec['kernel']:22s}: {rec['rate']:10.3f} {rec['unit']:18s} "
              f"({rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
              f"{100 * rec['bound_share']:.1f}%)  peak {rec['max_memory_allocated']} B  "
              f"{'correct' if rec['correct'] else 'WRONG'}")
    res["nvidia_smi"] = nvidia_smi()
    print(json.dumps(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
