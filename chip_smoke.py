#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`snark_tpu_torch`) on one card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds as it ends:

0. device: the card's name; `nvidia-smi` name and power limit.
1. build: the one nvcc call that builds every kernel (registers and spills
   per kernel from ptxas).
2. kernels: K1-K4 against their plain PyTorch versions on the card, at the
   shapes of the 2^18 prove below, exact equality; each kernel's time
   (CUDA events, warmed up), its plain version's time and its bound.
3. prove_fixture: proves the committed MulChain(4, 1023) key
   (`tests/vectors/torch_pk_bn254_mulchain1023.npz`) at its committed
   (r, s); the proof must equal the JAX package's committed proof bit for
   bit and pass the host pairing check.
4. prove_full: MulChain(seed=4, n = 2^18 − 64) (domain 2^18, m = 524162)
   against a synthetic key made here from a seed: the MulChain matrices
   and tables that tile a pool of 64 distinct points. Every MSM sum is
   checked exactly against the host pool oracle, h against
   h(x)·Z_H(x) = a(x)·b(x) − c(x) at a random x, and the proof against
   `assemble_proof` on the oracle sums. Launch counts of this prove go into
   the kernel line.

The last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed; any failure exits non-zero. No card: exit 1, no result.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_PK = os.path.join(HERE, "tests", "vectors", "torch_pk_bn254_mulchain1023.npz")
FIXTURE_PROOF = os.path.join(HERE, "tests", "vectors", "torch_proof_bn254_mulchain1023.json")
FULL_N = (1 << 18) - 64  # constraints: domain 2^18, m = 524162
FULL_SEED = 4
POOL = 64
# H100 SXM peaks (published): 3.35e12 bytes/s of HBM; 32-bit integer
# multiply-adds at 64 per SM per clock (CUDA programming guide, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost = 1.6727e13 per second.
PEAK_BYTES = 3.35e12
PEAK_IMAD = 132 * 64 * 1.98e9
IMAD_PER_MUL = 264  # 8x8-limb CIOS: 2·64 (a·b) + 2·64 (m·p) + 8 (m)
# Montgomery muls per operation, from csrc/curve.cu and csrc/ntt.cu
MULS = {
    "madd_g1": 13 + 2,  # RCB15 Alg 8 + row decode (X, Y)
    "madd_g2": 13 * 3 + 4,  # Fq2 Karatsuba: 3 base muls each; decode 4
    "add_g1": 14,  # RCB15 Alg 7
    "add_g2": 14 * 3,
}


def phase_line(name: str, t0: float, **info) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3), **info}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of fn() on the card: one warm-up, then `reps`
    runs between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(imads: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = imads / PEAK_IMAD * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# the synthetic full-width key
# ---------------------------------------------------------------------------


class SyntheticKey:
    """A proving key for MulChain(seed, n) whose five tables tile pools of
    64 distinct points, and whose vk points come from fixed scalars. It
    is not the output of a setup (its proofs do not verify); it feeds the
    prover's device path at full width with an exact host oracle."""

    def __init__(self, n_constraints: int, seed: int, device):
        import numpy as np
        import torch

        from snark_tpu_torch.fields.limbs import FR
        from snark_tpu_torch.fields.params import BN254
        from snark_tpu_torch.groth16 import ProvingKey, VerifyingKey
        from snark_tpu_torch.groth16.qap import PaddedCsr, domain_size_for
        from snark_tpu_torch.models import MulChainCircuit
        from snark_tpu_torch.ops.curve import pack_rows_u8
        from snark_tpu_torch.ops.curve_host import host_g1, host_g2

        rng = random.Random(seed)
        r = BN254.fr.modulus
        g1, g2 = host_g1(BN254), host_g2(BN254)
        self.g1, self.g2 = g1, g2
        self.circuit = MulChainCircuit(seed=FULL_SEED, n=n_constraints)
        ni = self.circuit.num_instance
        m = self.circuit.num_variables
        nw = m - ni
        n = domain_size_for(n_constraints, ni)

        def pool(hc):
            return [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(POOL)]

        self.pools = {name: pool(g2 if name == "b_g2" else g1) for name in ("a", "b_g1", "b_g2", "h", "l")}

        def table(name, rows, identity_row=None):
            group = "g2" if name == "b_g2" else "g1"
            pts = pack_rows_u8(self.pools[name], group)
            tiled = np.tile(pts, (-(-rows // POOL), 1))[:rows].copy()
            if identity_row is not None:
                tiled[identity_row] = pack_rows_u8([None], group)[0]
            return torch.as_tensor(tiled, device=device)

        alpha, beta, gamma, delta = (rng.randrange(1, r) for _ in range(4))
        vk = VerifyingKey(
            curve=BN254,
            alpha_g1=g1.scalar_mul(g1.generator, alpha),
            beta_g2=g2.scalar_mul(g2.generator, beta),
            gamma_g2=g2.scalar_mul(g2.generator, gamma),
            delta_g2=g2.scalar_mul(g2.generator, delta),
            gamma_abc_g1=[g1.scalar_mul(g1.generator, rng.randrange(1, r)) for _ in range(ni)],
        )
        # the reference's CSR format: (rows, 1) columns, 16-bit-limb
        # Montgomery coefficients (all 1 for MulChain)
        one16 = np.array(
            [(FR.to_mont(1) >> (16 * i)) & 0xFFFF for i in range(16)], np.uint32
        )
        coeffs = np.broadcast_to(one16, (n_constraints, 1, 16))
        cols = self.circuit.csr_columns()
        self.cols = cols
        self.pk = ProvingKey(
            vk=vk,
            beta_g1=g1.scalar_mul(g1.generator, beta),
            delta_g1=g1.scalar_mul(g1.generator, delta),
            a_tbl=table("a", m),
            b_g1_tbl=table("b_g1", m),
            b_g2_tbl=table("b_g2", m),
            # row k is coefficient bitrev(k); coefficient n-1 (row n-1) has
            # no query point in a real key: the identity row
            h_tbl=table("h", n, identity_row=n - 1),
            l_tbl=table("l", nw),
            mat_a=PaddedCsr.from_reference(cols[0], coeffs, device),
            mat_b=PaddedCsr.from_reference(cols[1], coeffs, device),
            mat_c=PaddedCsr.from_reference(cols[2], coeffs, device),
            num_instance=ni,
            num_witness=nw,
            num_constraints=n_constraints,
            domain_size=n,
        )

    def pool_oracle(self, name: str, scalars: list[int], skip_row: int | None = None):
        """sum_j pool_j · (sum over rows i = j mod 64 of scalars[i])."""
        from snark_tpu_torch.fields.params import BN254

        r = BN254.fr.modulus
        agg = [0] * POOL
        for i, s in enumerate(scalars):
            if i != skip_row:
                agg[i % POOL] += s
        hc = self.g2 if name == "b_g2" else self.g1
        return hc.msm(self.pools[name], [a % r for a in agg])

    def check_h(self, z: list[int], h_bitrev: list[int], rng: random.Random) -> bool:
        """h(x)·Z_H(x) == a(x)·b(x) − c(x) at a random x, with a, b, c
        interpolated on the host from z and the matrices."""
        from snark_tpu_torch.fields.params import BN254
        from snark_tpu_torch.ops.ntt import bit_reverse_indices

        p = BN254.fr.modulus
        pk = self.pk
        n, nc, ni = pk.domain_size, pk.num_constraints, pk.num_instance
        evals = [
            [z[c] for c in self.cols[0][:, 0]] + z[:ni] + [0] * (n - nc - ni),
            [z[c] for c in self.cols[1][:, 0]] + [0] * (n - nc),
            [z[c] for c in self.cols[2][:, 0]] + [0] * (n - nc),
        ]
        x = rng.randrange(p)
        omega = BN254.fr.root_of_unity(n)
        w, ws = 1, []
        for _ in range(n):
            ws.append(w)
            w = w * omega % p
        # L_i(x) = Z_H(x)/n · ω^i / (x − ω^i), with one batched inversion
        d = [(x - wi) % p for wi in ws]
        prefix = [1]
        for v in d:
            prefix.append(prefix[-1] * v % p)
        inv = pow(prefix[-1], -1, p)
        lag = [0] * n
        zx = (pow(x, n, p) - 1) % p
        zn = zx * pow(n, -1, p) % p
        for i in range(n - 1, -1, -1):
            lag[i] = zn * ws[i] % p * (prefix[i] * inv % p) % p
            inv = inv * d[i] % p
        ax, bx, cx = (sum(e * l for e, l in zip(ev, lag)) % p for ev in evals)
        rev = bit_reverse_indices(n)
        coeffs = [0] * n
        for k, v in enumerate(h_bitrev):
            coeffs[rev[k]] = v
        hx = 0
        for v in reversed(coeffs):
            hx = (hx * x + v) % p
        return hx * zx % p == (ax * bx - cx) % p


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from snark_tpu_torch import _native

    res = _native.build()
    kernels = {}
    name = None
    for line in res.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            kernels[name]["spill_stores"] = int(m.group(1))
            kernels[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    return {"nvcc_seconds": round(res.seconds, 3), "built": res.built, "ptxas": kernels}


def phase_kernels(key: SyntheticKey, z_std, device) -> list[dict]:
    """K1-K4 against their plain versions at the 2^18 prove's shapes."""
    import torch

    from snark_tpu_torch.fields.limbs import FR
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops import ntt as N
    from snark_tpu_torch.ops.msm import pick_window_plane_signed, signed_digits
    from snark_tpu_torch.ops.msm_plane import PlaneMsm

    pk = key.pk
    c = pick_window_plane_signed(z_std.shape[0])
    digits = signed_digits(z_std, c, 254)
    rows = []

    def entry(name, route, source, replaces, ms, plain_ms, err, imads, nbytes):
        b, by = bound_ms(imads, nbytes)
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })

    def max_abs_err(a, b):
        if torch.equal(a, b):
            return 0
        raise AssertionError("kernel and plain version differ")

    def plain_time(fn):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    for group, tbl in (("g1", pk.a_tbl), ("g2", pk.b_g2_tbl)):
        plan = PlaneMsm(c, 254, group)
        perm, start, length = plan._buckets(digits.t().contiguous())
        n = digits.shape[0]
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        lane_base = i32(torch.arange(plan.lanes, device=device) // plan.nb * n)
        # the main scan's runs: overflow past the spill cut is left out
        length = i32(plan.spill_plan(length, n)[0])
        start = i32(start)
        acc0 = C.identity(plan.lanes, group, device)
        steps = int(length.max())

        def k1():
            return C.bucket_madd_rows(acc0, tbl, perm, lane_base, start, length, 0, steps, group)

        out = k1()
        ms = cuda_ms(k1)
        ref, pms = plain_time(lambda: C.bucket_madd_rows_plain(
            acc0, tbl, perm, lane_base, start, length, 0, steps, group))
        err = max_abs_err(out, ref)
        adds = int(length.sum())  # rows this run adds (identity rows included)
        pt_bytes = out[0].numel() * 4
        # bytes: table, payloads and per-lane runs read once, accumulators
        # read and written once
        entry(f"bucket_madd_rows_{group}", "cuda", "snark_tpu_torch/csrc/curve.cu",
              "snark_tpu/ops/pallas_curve.py:754", ms, pms, err,
              adds * MULS[f"madd_{group}"] * IMAD_PER_MUL,
              tbl.numel() + perm.numel() * 4 + plan.lanes * (2 * pt_bytes + 12))

        # K2 on the scan's output: one suffix-scan step (stride 1)
        q = torch.roll(out.view(plan.W, plan.nb, *out.shape[1:]), -1, dims=1).reshape(out.shape).contiguous()
        mask = torch.as_tensor(plan.scan[0], device=device)

        def k2():
            return C.masked_add(out, q, mask, group)

        o2 = k2()
        ms2 = cuda_ms(k2)
        ref2, pms2 = plain_time(lambda: C.masked_add_plain(out, q, mask, group))
        err2 = max_abs_err(o2, ref2)
        active = int(mask.sum())
        entry(f"masked_add_{group}", "cuda", "snark_tpu_torch/csrc/curve.cu",
              "snark_tpu/ops/pallas_curve.py:716", ms2, pms2, err2,
              active * MULS[f"add_{group}"] * IMAD_PER_MUL,
              plan.lanes * (3 * pt_bytes + 1))

    # K3, K4 at the domain size
    n = pk.domain_size
    rng = random.Random(11)
    x = FR.tensor([rng.randrange(FR.p) for _ in range(n)], device)
    y = FR.tensor([rng.randrange(FR.p) for _ in range(n)], device)
    plan = N.NttPlan(n, device)
    s = 9  # a middle stage: half = 512
    for dif in (False, True):
        o3 = N.ntt_stage(x, plan.inv_tw, s, n >> (s + 1), dif)
        ref3 = N.ntt_stage_plain(x, plan.inv_tw, s, n >> (s + 1), dif)
        max_abs_err(o3, ref3)
    ms3 = cuda_ms(lambda: N.ntt_stage(x, plan.inv_tw, s, n >> (s + 1), False))
    _, pms3 = plain_time(lambda: N.ntt_stage_plain(x, plan.inv_tw, s, n >> (s + 1), False))
    entry("ntt_stage", "cuda", "snark_tpu_torch/csrc/ntt.cu",
          "snark_tpu/ops/ntt_plane.py:158", ms3, pms3, 0,
          (n // 2) * IMAD_PER_MUL, n * 64 + (1 << s) * 32)

    for mode in ("mul", "add", "hadamard"):
        o4 = N.field_ew(mode, x, y, plan.coset_scale_rev, plan.z_coset_inv)
        max_abs_err(o4, N.field_ew_plain(mode, x, y, plan.coset_scale_rev, plan.z_coset_inv))
    ms4 = cuda_ms(lambda: N.field_ew("mul", x, y))
    _, pms4 = plain_time(lambda: N.field_ew_plain("mul", x, y))
    entry("field_ew", "cuda", "snark_tpu_torch/csrc/ntt.cu",
          "snark_tpu/ops/ntt_plane.py:197", ms4, pms4, 0, n * IMAD_PER_MUL, n * 96)
    return rows


def phase_prove_fixture(device) -> dict:
    from snark_tpu_torch.fields.params import BN254
    from snark_tpu_torch.groth16 import Groth16, ProvingKey
    from snark_tpu_torch.models import MulChainCircuit
    from snark_tpu_torch.snark import serialize as ser

    with open(FIXTURE_PROOF) as f:
        want = json.load(f)
    pk = ProvingKey.load(FIXTURE_PK, device=device)
    g16 = Groth16(device=device)
    z = MulChainCircuit(seed=4, n=1023).assignment(BN254.fr.modulus)
    t = time.time()
    proof = g16.prove_from_assignment(pk, z, int(want["r"]), int(want["s"]))
    prove_s = time.time() - t
    got = ser.serialize_proof(proof, BN254).hex()
    if got != want["proof_bytes_hex"]:
        raise AssertionError(f"fixture proof differs from the JAX package's: {got}")
    if not g16.verify(pk.vk, want["public_input"], proof):
        raise AssertionError("fixture proof does not verify")
    return {"equal_to_jax_proof": True, "verifies": True, "prove_seconds": round(prove_s, 3)}


def phase_prove_full(key: SyntheticKey, z: list[int], device) -> tuple[dict, dict]:
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.fields.limbs import FR
    from snark_tpu_torch.groth16 import Groth16, assemble_proof

    pk = key.pk
    rng = random.Random(2024)
    r, s = rng.randrange(FR.p), rng.randrange(FR.p)
    g16 = Groth16(device=device)
    g16.ntt_plan(pk.domain_size)  # host-built twiddles: set-up, not prove time
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    t = time.time()
    proof = g16.prove_from_assignment(pk, z, r, s)
    prove_s = time.time() - t
    launches = dict(_native.LAUNCHES)
    run = g16.last_run
    h = FR.decode(run.h_std, mont=False)
    ni = pk.num_instance
    n = pk.domain_size
    want = {
        "A": key.pool_oracle("a", z),
        "B": key.pool_oracle("b_g2", z),
        "B1": key.pool_oracle("b_g1", z),
        "L": key.pool_oracle("l", z[ni:]),
        "H": key.pool_oracle("h", h, skip_row=n - 1),
    }
    for name, pt in want.items():
        if run.sums[name] != pt:
            raise AssertionError(f"MSM {name} differs from the pool oracle")
    if not key.check_h(z, h, rng):
        raise AssertionError("h(x)·Z_H(x) != a(x)·b(x) − c(x)")
    if proof != assemble_proof(g16, pk, want["A"], want["B"], want["B1"], want["L"], want["H"], r, s):
        raise AssertionError("proof differs from assemble_proof on the oracle sums")
    info = {
        "constraints": pk.num_constraints, "m": ni + pk.num_witness, "domain": n,
        "prove_seconds": round(prove_s, 3),
        "stage_ms": {k: round(v, 3) for k, v in run.stage_ms.items()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "msm_exact": True, "h_identity": True, "proof_equals_assembly": True,
    }
    return info, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import snark_tpu_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda")
    t0 = time.time()
    smi = nvidia_smi_line()
    phase_line("device", t0, kind=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print(smi, flush=True)

    t0 = time.time()
    phase_line("build", t0, **phase_build())

    from snark_tpu_torch.fields.limbs import FR
    from snark_tpu_torch.fields.params import BN254

    t0 = time.time()
    key = SyntheticKey(FULL_N, seed=1, device=device)
    z = key.circuit.assignment(BN254.fr.modulus)
    z_std = FR.tensor(z, device, mont=False)
    phase_line("setup", t0, constraints=FULL_N, m=len(z), domain=key.pk.domain_size)

    t0 = time.time()
    rows = phase_kernels(key, z_std, device)
    phase_line("kernels", t0, all_equal=True, kernels=rows)

    t0 = time.time()
    phase_line("prove_fixture", t0, **phase_prove_fixture(device))

    t0 = time.time()
    info, launches = phase_prove_full(key, z, device)
    phase_line("prove_full", t0, **info)

    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
