"""Benchmark of the port: Pippenger MSM point-adds/s on one CUDA card.

    python -m snark_tpu_torch.bench

Prints ONE JSON line:
  {"metric": "msm_point_adds_per_s", "value": N, "unit": "adds/s",
   "detail": {..., "correct": true, "device": "<card>", ...}}

The counterpart of the repository's `bench.py`, on the port: the whole MSM
(sort, bucket accumulation, bucket reduction, the device Horner combine) of
`PlaneMsm.msm`, timed from the call to the readback of the final point, on
a table that tiles a pool of 64 distinct points (point values do not change
the work; the pool gives an exact host oracle). Work accounting (group ops
performed): per window N adds (bucket accumulation) + 2·cb·2^cb (suffix and
total scans) + max_r·2^cb (replica collapse), plus c doublings and one add
per window in the combine.

Environment, as `bench.py` reads it: BENCH_LOG_N (20), BENCH_SIGNED (1),
BENCH_WINDOW (13 signed, 12 unsigned), BENCH_ITERS (3); and
SNARK_TPU_MSM_AFFINE (0): 1 accumulates the buckets with the batch-affine
tree. The library itself reads no environment variable. The command line
runs BN254, as `bench.py` does; `make_inputs` and `run` take any ported
curve (`chip_smoke.py` runs them on BLS12-381 as well).
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch

from .fields.limbs import fields_of
from .fields.params import BN254, CurveParams
from .ops.curve import limbs_to_points, pack_rows_u8
from .ops.curve_host import host_g1, host_g2
from .ops.msm import signed_digits, unsigned_digits
from .ops.msm_plane import PlaneMsm

POOL = 64


@dataclass
class BenchInputs:
    group: str
    n: int
    c: int
    signed: bool
    table: torch.Tensor  # (n, row_bytes) uint8 on the device
    digits: torch.Tensor  # (n, W) int32 on the device
    want: tuple  # the host oracle's affine point
    curve: CurveParams = BN254


def host_curve(group: str, curve: CurveParams = BN254):
    return host_g1(curve) if group == "g1" else host_g2(curve)


def make_inputs(
    log_n: int = 20, signed: bool = True, c: int | None = None, group: str = "g1",
    device="cuda", seed: int = 7, curve: CurveParams = BN254,
) -> BenchInputs:
    """The table of a tiled 64-point pool, uniform scalars from `seed`, the
    window digits on the device, and the exact oracle
    Σ_j pool_j · (Σ_{i ≡ j mod 64} s_i)."""
    n = 1 << log_n
    c = c or (13 if signed else 12)
    hc = host_curve(group, curve)
    r = curve.fr.modulus
    pool = [hc.scalar_mul(hc.generator, k + 1) for k in range(POOL)]
    rows = pack_rows_u8(pool, group, curve)
    table = torch.as_tensor(np.tile(rows, (n // POOL, 1)), device=device)
    rng = random.Random(seed)
    scalars = [rng.randrange(0, r) for _ in range(n)]
    std = fields_of(curve)[0].tensor(scalars, device, mont=False)
    digits = (signed_digits if signed else unsigned_digits)(std, c, curve.fr.num_bits)
    agg = [0] * POOL
    for i, s in enumerate(scalars):
        agg[i % POOL] += s
    want = hc.msm(pool, [a % r for a in agg])
    return BenchInputs(group, n, c, signed, table, digits.contiguous(), want, curve)


def work_adds(plan: PlaneMsm, n: int) -> int:
    """Group operations of one MSM, as `bench.py` counts them."""
    W, nb = plan.W, plan.nb
    return W * n + 2 * plan.cb * W * nb + plan.max_r * W * nb + W * (plan.c + 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_ms(plan: PlaneMsm, inp: BenchInputs) -> dict:
    """One MSM with a synchronise after each stage: bucket accumulation
    (sort included), the folds, the device combine; milliseconds."""
    dev = inp.table.device
    out, t = {}, time.perf_counter()

    def tick(name):
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    tick("start")
    acc = plan.accumulate(inp.table, inp.digits.t().contiguous())
    tick("accumulate")
    sums = plan.fold_block(acc, 0, plan.W)
    tick("fold")
    plan.combine(sums)
    tick("combine")
    del out["start"]
    return out


def run(inp: BenchInputs, affine: bool = False, iters: int = 3) -> dict:
    """Time `iters` MSMs after one warm-up; check the warm-up's result
    against the oracle. -> the JSON record."""
    dev = inp.table.device
    curve = inp.curve
    plan = PlaneMsm(
        inp.c, curve.fr.num_bits, inp.group, signed=inp.signed, affine=affine, curve=curve
    )
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out0 = plan.msm(inp.table, inp.digits).cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        plan.msm(inp.table, inp.digits).cpu()  # the readback synchronises
    dt = (time.perf_counter() - t0) / iters
    got = limbs_to_points(out0[None], inp.group, curve)[0]
    adds = work_adds(plan, inp.n)
    detail = {
        "n_points": inp.n,
        "window_bits": inp.c,
        "num_windows": plan.W,
        "msm_wall_s": dt,
        "curve": f"{curve.name}_{inp.group}",
        "signed_digits": inp.signed,
        "affine": affine,
        "affine_engaged": plan.uses_affine(inp.n),
        "correct": got == inp.want,
        "stage_ms": stage_ms(plan, inp),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "pipeline": "torch_cuda_plane_msm",
    }
    if dev.type == "cuda":
        detail["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return {"metric": "msm_point_adds_per_s", "value": adds / dt, "unit": "adds/s", "detail": detail}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("snark_tpu_torch.bench: no CUDA device")
    signed = os.environ.get("BENCH_SIGNED", "1") == "1"
    window = os.environ.get("BENCH_WINDOW")
    inp = make_inputs(
        log_n=int(os.environ.get("BENCH_LOG_N", "20")),
        signed=signed,
        c=int(window) if window else None,
        device="cuda",
    )
    rec = run(
        inp,
        affine=os.environ.get("SNARK_TPU_MSM_AFFINE", "0") == "1",
        iters=int(os.environ.get("BENCH_ITERS", "3")),
    )
    rec["detail"]["nvidia_smi"] = nvidia_smi()
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
