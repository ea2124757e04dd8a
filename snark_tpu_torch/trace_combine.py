"""Trace the MSM's device Horner combine (`PlaneMsm.combine`) on one card.

    python -m snark_tpu_torch.trace_combine [CURVE_GROUP ...]

For each curve and group (default: bn254_g1 and bls12_381_g2; also
bn254_g2, bls12_381_g1), W = 20 random window totals at the bench's
window (signed c = 13, as `bench.py` plans it) go through one combine
under `torch.profiler` (CPU and CUDA activities), after two warm-ups.
Prints one JSON line each with the device events by name (count, summed
µs), their sum (`device_us`), the span of the profiled region on the host
clock (`span_us`, the synchronise included) and the device's idle share
over it (`idle_share` = 1 − device_us / span_us; the region's own
device-side annotation is not a device event). Where the profiler gives
no device time, `device_us` is null and the line says so. The combine's
time without the profiler is msm_bench's `stage_ms.combine`.

The card's name and power limit lead the output. Needs one card.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys

import torch

from .bench import host_curve
from .fields.params import BLS12_381, BN254
from .ops.curve import points_to_limbs
from .ops.msm_plane import PlaneMsm

CASES = {
    "bn254_g1": (BN254, "g1"),
    "bn254_g2": (BN254, "g2"),
    "bls12_381_g1": (BLS12_381, "g1"),
    "bls12_381_g2": (BLS12_381, "g2"),
}
DEFAULT = ("bn254_g1", "bls12_381_g2")
C_BITS = 13  # the bench's signed window
SPAN = "combine"  # the profiled region's name


def window_totals(plan: PlaneMsm, seed: int = 5) -> torch.Tensor:
    """(W, 3, K, L) totals: random multiples of the generator, on the card."""
    hc = host_curve(plan.group, plan.curve)
    rng = random.Random(seed)
    r = plan.curve.fr.modulus
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(plan.W)]
    return points_to_limbs(pts, plan.group, "cuda", plan.curve)


def _device_events(prof):
    """The profiler's device events (kernels, copies, sets), without the
    device-side copy of the region's own annotation."""
    return [
        e for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
        and e.name != SPAN and not getattr(e, "is_user_annotation", False)
    ]


def trace_one(plan: PlaneMsm, sums: torch.Tensor) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            plan.combine(sums)
            torch.cuda.synchronize()
    span = next((e for e in prof.events() if e.name == SPAN
                 and not str(getattr(e, "device_type", "")).endswith("CUDA")), None)
    span_us = span.time_range.elapsed_us() if span is not None else None
    kernels: dict = {}
    events = _device_events(prof)
    for e in events:
        k = kernels.setdefault(e.name, {"count": 0, "us": 0.0})
        k["count"] += 1
        k["us"] += e.time_range.elapsed_us()
    device_us = sum(k["us"] for k in kernels.values()) or None
    out = {"device_events": len(events), "device_us": device_us, "span_us": span_us,
           "by_name": kernels}
    if device_us is None:
        out["note"] = "the profiler gave no device time"
    elif span_us:
        out["idle_share"] = 1 - device_us / span_us
    return out


def run(name: str) -> dict:
    curve, group = CASES[name]
    plan = PlaneMsm(C_BITS, curve.fr.num_bits, group, signed=True, curve=curve)
    sums = window_totals(plan)
    for _ in range(2):
        plan.combine(sums)
    torch.cuda.synchronize()
    return {"combine": name, "W": plan.W, "c": plan.c, "trace": trace_one(plan, sums)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("trace_combine: no CUDA device", file=sys.stderr)
        return 1
    names = argv[1:] or list(DEFAULT)
    unknown = set(names) - set(CASES)
    if unknown:
        raise SystemExit(f"trace_combine: unknown cases {sorted(unknown)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    for name in names:
        print(json.dumps(run(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
