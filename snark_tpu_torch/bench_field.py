"""Micro-benchmark of the port: Montgomery products per second on one card.

    python -m snark_tpu_torch.bench_field [log_n] [impls...]

The counterpart of the repository's `scripts/bench_field.py`, with its
defaults (2^log_n = 2^20 elements of BN254 Fr, 256 random pairs from
`np.random.RandomState(42)` tiled) and its selectors, each mapped to the
port's version of the same product a·b·R^-1 mod p (R = 2^256) on the same
limbs:

    u32      DeviceField.mul (torch ops, 16-bit limbs; fields/device.py)
    f32      DeviceFieldF32.mul_impl (torch ops, f32 digits; fields/device_f32.py)
    pallas2  K10 mont_mul16_limb_major (CUDA; ops/mont16.py)
    pallas1  K9 mont_mul16 (CUDA; ops/mont16.py)
    pallas3  K4 field_ew "mul" (CUDA; ops/ntt.py), on the limbs packed to
             32-bit words (pack16_to_u32)

Each line chains the product as the script does (x ← x·b, 8 deep for the
torch lines, 4 for the kernels), warms up, and times `iters` chains between
two CUDA events; the wrappers' layout conversions (K10's transposes) run
inside the timed call. Where the script sweeps the Pallas tile, K9 and K10
sweep threads per block (K4 keeps its launcher's block). Each line prints
ms per mul-batch, M muls/s and the peak device memory of its chain.

Unlike the script, every line's output is checked: it must equal the host
oracle (the 256 host products chained as deep, tiled), so lines of equal
depth equal each other. A mismatch exits non-zero. `run` takes either
scalar field (`chip_smoke.py` runs BLS12-381 Fr too); on the CPU it checks
the lines through the plain versions and times nothing.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .fields.device import get_device_field, limbs16_encode
from .fields.device_f32 import get_device_field_f32
from .fields.limbs import BLS_FR, FR, Field, pack16_to_u32, u32_tensor
from .fields.params import BN254, FieldParams
from .ops import mont16
from .ops.ntt import field_ew

IMPLS = ("u32", "f32", "pallas2", "pallas1", "pallas3")
PORT_NAME = {
    "u32": "DeviceField.mul",
    "f32": "DeviceFieldF32.mul_impl",
    "pallas2": "K10 mont_mul16_limb_major",
    "pallas1": "K9 mont_mul16",
    "pallas3": "K4 field_ew mul",
}
CHAIN = {"u32": 8, "f32": 8, "pallas2": 4, "pallas1": 4, "pallas3": 4}
THREADS = (128, 256, 512, 1024)  # the sweep of K9 and K10
PAIRS = 256


def scalar_field(params: FieldParams) -> Field:
    """The port's `Field` of a scalar field (the kernels' field code)."""
    for f in (FR, BLS_FR):
        if f.params.name == params.name:
            return f
    raise ValueError(f"bench_field runs over BN254 Fr or BLS12-381 Fr, got {params.name}")


def host_pairs(params: FieldParams) -> tuple[list[int], list[int]]:
    """The script's 256 pairs (plain values, below 2^62)."""
    rng = np.random.RandomState(42)
    vals_a = [int(rng.randint(0, 2**62)) for _ in range(PAIRS)]
    vals_b = [int(rng.randint(1, 2**62)) for _ in range(PAIRS)]
    return vals_a, vals_b


def oracle(params: FieldParams, chain: int) -> np.ndarray:
    """(256, L16) limbs of the chained host products, Montgomery form."""
    p, r = params.modulus, params.r
    r_inv = pow(r, -1, p)
    vals_a, vals_b = host_pairs(params)
    out = []
    for a, b in zip(vals_a, vals_b):
        x, bm = a * r % p, b * r % p
        for _ in range(chain):
            x = x * bm * r_inv % p
        out.append(x)
    return limbs16_encode(out, params)


def inputs(params: FieldParams, log_n: int) -> tuple[np.ndarray, np.ndarray]:
    """(2^log_n, L16) uint32 Montgomery limbs of a and b: the 256 pairs,
    tiled."""
    if log_n < 8:
        raise ValueError("log_n >= 8: the 256 pairs are tiled")
    p, r = params.modulus, params.r
    reps = (1 << log_n) // PAIRS
    return tuple(
        np.tile(limbs16_encode([v * r % p for v in vals], params), (reps, 1))
        for vals in host_pairs(params)
    )


def _line(impl: str, params: FieldParams, fr: Field, limbs_a, limbs_b, device, threads):
    """-> (the product on the line's layout, its inputs, a converter of its
    output back to (n, L16) 16-bit limbs)."""
    if impl == "u32":
        df = get_device_field(params, device)
        a, b = (mont16.limbs16_tensor(x, device) for x in (limbs_a, limbs_b))
        return df.mul, a, b, lambda out: out
    if impl == "f32":
        dff = get_device_field_f32(params, device)
        a, b = (torch.from_numpy(dff._limbs_to_digits_np(x)).to(device) for x in (limbs_a, limbs_b))

        def to_limbs(out):
            d = out.to(torch.int32).reshape(out.shape[0], -1, 2)
            return d[..., 0] | (d[..., 1] << 8)

        return dff.mul_impl, a, b, to_limbs
    if impl == "pallas3":
        a, b = (u32_tensor(pack16_to_u32(x), device) for x in (limbs_a, limbs_b))
        words = lambda out: mont16.unpack_words(out.to(torch.int64) & 0xFFFFFFFF)  # noqa: E731
        return lambda x, y: field_ew("mul", x, y, field=fr), a, b, words
    kernel = {"pallas2": mont16.mont_mul16_limb_major, "pallas1": mont16.mont_mul16}[impl]
    a, b = (mont16.limbs16_tensor(x, device) for x in (limbs_a, limbs_b))
    return lambda x, y: kernel(x, y, fr, threads), a, b, lambda out: out


def run(
    log_n: int = 20, impls=IMPLS, field: FieldParams = BN254.fr, device="cuda", iters: int = 10
) -> dict:
    """Run the lines; -> {"n", "field", "device", "lines": [...], "correct"}.
    Each line: impl, port, threads, chain, ms_per_mul_batch,
    m_muls_per_s, max_memory_allocated (None on the CPU), correct."""
    device = torch.device(device)
    bad = [i for i in impls if i not in IMPLS]
    if bad:
        raise ValueError(f"unknown impls {bad}; choose from {IMPLS}")
    fr = scalar_field(field)
    limbs_a, limbs_b = inputs(field, log_n)
    n, reps = 1 << log_n, (1 << log_n) // PAIRS
    cuda = device.type == "cuda"
    lines = []
    for impl in impls:
        want = torch.from_numpy(oracle(field, CHAIN[impl]).astype(np.int32)).to(device)
        for threads in THREADS if cuda and impl in ("pallas1", "pallas2") else (None,):
            fn, a, b, to_limbs = _line(impl, field, fr, limbs_a, limbs_b, device, threads)

            def chained():
                x = a
                for _ in range(CHAIN[impl]):
                    x = fn(x, b)
                return x

            rec = {"impl": impl, "port": PORT_NAME[impl], "threads": threads,
                   "chain": CHAIN[impl], "ms_per_mul_batch": None, "m_muls_per_s": None,
                   "max_memory_allocated": None}
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            out = chained()  # the warm-up, and the output that is checked
            if cuda:
                torch.cuda.synchronize(device)
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                for _ in range(iters):
                    chained()
                e1.record()
                torch.cuda.synchronize(device)
                ms = e0.elapsed_time(e1) / (iters * CHAIN[impl])
                rec.update(ms_per_mul_batch=ms, m_muls_per_s=n / ms / 1e3,
                           max_memory_allocated=torch.cuda.max_memory_allocated(device))
            got = to_limbs(out).reshape(reps, PAIRS, -1)
            rec["correct"] = bool(torch.equal(got, want.expand_as(got)))
            lines.append(rec)
            del out, got, a, b
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    return {"n": n, "field": field.name, "device": name, "lines": lines,
            "correct": all(rec["correct"] for rec in lines)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("snark_tpu_torch.bench_field: no CUDA device")
    from .bench import nvidia_smi

    log_n = int(argv[0]) if argv else 20
    impls = argv[1:] or IMPLS
    res = run(log_n, impls)
    print(f"n = 2^{log_n} = {res['n']}, field BN254.Fr, device {res['device']}")
    for rec in res["lines"]:
        tag = rec["impl"] + (f" t={rec['threads']:4d}" if rec["threads"] else "")
        print(f"{tag:13s} {rec['port']:26s}: {rec['ms_per_mul_batch']:9.3f} ms/mul-batch "
              f"{rec['m_muls_per_s']:10.2f} M muls/s  peak {rec['max_memory_allocated']} B"
              f"  {'correct' if rec['correct'] else 'WRONG'}")
    res["nvidia_smi"] = nvidia_smi()
    print(json.dumps(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
