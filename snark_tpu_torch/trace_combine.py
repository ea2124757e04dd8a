"""Trace the MSM's device Horner combine (`PlaneMsm.combine`) and the
prove's h pipeline (`NttPlan.h_from_evals`) on one card.

    python -m snark_tpu_torch.trace_combine [CASE ...]

A combine case names a curve and group (default: bn254_g1 and
bls12_381_g2; also bn254_g2, bls12_381_g1): W = 20 random window totals
at the bench's window (signed c = 13, as `bench.py` plans it) go through
one combine. An h case (h_bn254 at 2^18, h_bls12_381 at 2^20, the proves'
domains) runs one `h_from_evals` on random Montgomery evaluations. Each
runs under `torch.profiler` (CPU and CUDA activities), after two warm-ups.
Prints one JSON line each with the device events by name (count, summed
µs), their sum (`device_us`), the span of the profiled region on the host
clock (`span_us`, the synchronise included) and the device's idle share
over it (`idle_share` = 1 − device_us / span_us; the region's own
device-side annotation is not a device event). Where the profiler gives
no device time, `device_us` is null and the line says so. The times
without the profiler are msm_bench's `stage_ms.combine` and the proves'
`stage_ms.h`. The module calls nothing that another tree of the port
lacks, so a copy of it traces that tree.

The card's name and power limit lead the output. Needs one card.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys

import torch

from .bench import host_curve
from .fields.limbs import fields_of
from .fields.params import BLS12_381, BN254
from .ops.curve import points_to_limbs
from .ops.msm_plane import PlaneMsm
from .ops.ntt import NttPlan

CASES = {
    "bn254_g1": (BN254, "g1"),
    "bn254_g2": (BN254, "g2"),
    "bls12_381_g1": (BLS12_381, "g1"),
    "bls12_381_g2": (BLS12_381, "g2"),
}
H_CASES = {"h_bn254": (BN254, 18), "h_bls12_381": (BLS12_381, 20)}  # log2 of the domain
DEFAULT = ("bn254_g1", "bls12_381_g2")
C_BITS = 13  # the bench's signed window


def window_totals(plan: PlaneMsm, seed: int = 5) -> torch.Tensor:
    """(W, 3, K, L) totals: random multiples of the generator, on the card."""
    hc = host_curve(plan.group, plan.curve)
    rng = random.Random(seed)
    r = plan.curve.fr.modulus
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(plan.W)]
    return points_to_limbs(pts, plan.group, "cuda", plan.curve)


def random_elements(fr, n: int, seed: int) -> torch.Tensor:
    """(n, L) random Montgomery elements below p, made on the card: random
    words under a top word below p's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = torch.randint(-(1 << 31), 1 << 31, (n, fr.limbs), dtype=torch.int64,
                          device="cuda", generator=gen)
    top = fr.p >> (32 * (fr.limbs - 1))
    words[:, -1] = torch.randint(0, top, (n,), device="cuda", generator=gen)
    return words.to(torch.int32)


def _device_events(prof, span: str):
    """The profiler's device events (kernels, copies, sets), without the
    device-side copy of the region's own annotation."""
    return [
        e for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
        and e.name != span and not getattr(e, "is_user_annotation", False)
    ]


def trace_one(fn, span: str) -> dict:
    """fn() once under the profiler, in a region named `span`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            fn()
            torch.cuda.synchronize()
    region = next((e for e in prof.events() if e.name == span
                   and not str(getattr(e, "device_type", "")).endswith("CUDA")), None)
    span_us = region.time_range.elapsed_us() if region is not None else None
    kernels: dict = {}
    events = _device_events(prof, span)
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
    if name in H_CASES:
        curve, log_n = H_CASES[name]
        fr = fields_of(curve)[0]
        plan = NttPlan(1 << log_n, "cuda", fr)
        evals = [random_elements(fr, plan.n, seed) for seed in (1, 2, 3)]
        fn, span, info = (lambda: plan.h_from_evals(*evals)), "h", {"h": name, "n": plan.n}
    else:
        curve, group = CASES[name]
        plan = PlaneMsm(C_BITS, curve.fr.num_bits, group, signed=True, curve=curve)
        sums = window_totals(plan)
        fn, span = (lambda: plan.combine(sums)), "combine"
        info = {"combine": name, "W": plan.W, "c": plan.c}
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    return {**info, "trace": trace_one(fn, span)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("trace_combine: no CUDA device", file=sys.stderr)
        return 1
    names = argv[1:] or list(DEFAULT)
    unknown = set(names) - set(CASES) - set(H_CASES)
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
