"""The graded configurations of the JAX package's `scripts/run_configs.py`,
on the port:

    python -m snark_tpu_torch.run_configs [CONFIG ...] [--batch-prover]
        [--batch B] [--log-n N] [--config3-log-n N] [--config4-log-n N]
        [--ranks R] [--device DEVICE]

Each configuration prints one JSON line with the reference's keys (and
the device it ran on):

  1: 2^10 a*b=c chain (MulChain(7, 2^10, batch=True)), synthesize, finalize
     and is_satisfied on the host. The default.
  2: BN254 Groth16 at n = 2^16 − 64 constraints: the setup from
     random.Random(0), a warm prove from random.Random(5), the timed prove
     from random.Random(1), verify with [7].
  3: the same over BLS12-381 at n = 2^config3-log-n − 64 (default 2^20).
  4: the distributed MSM and NTT (`parallel/plane_dist.py`): BN254 G1
     window sums (`DistPlaneMsm`) of 2^config4-log-n points (a pool of 64
     points tiled, scalars from random.Random(3), signed c from
     `pick_window_plane_signed(max(n / ranks, 256))`) and the six-step
     `DistPlaneNtt.fft` of as many coefficients (drawn next from the same
     rng), each timed (3 runs after a warm one) in a world of one rank and
     in a world of --ranks ranks (processes spawned on this host by
     `parallel/launch.py`, each world's backend from its layout: on one
     card NCCL at one rank, gloo at two), their results equal. Scaling
     efficiency = t1 / (ranks · t_ranks). It spawns its own worlds, so it
     does not run under torchrun.
  5: batched proving throughput: B proofs (--batch, default 256) of
     MulChain(s, 2^log-n − 64, batch=True) for s < B (--log-n, default 18)
     under one key set up for the first from random.Random(0). The (r, s)
     pairs come from random.Random(1): a warm pair, then one a proof. By
     default the reference's one-card mode: after a warm prove, each
     witness is synthesized on a one-thread executor while the main thread
     proves the previous one (`prove_from_assignment`). --batch-prover runs
     the same circuits and pairs through `BatchProver.prove_batch` (each
     MSM's Horner combine on the device) after a warm batch of one; the
     proofs are the same. The first four proofs are verified. The line
     adds the timed run's peak device memory (`max_memory_allocated`) and
     the process's peak resident host memory (`host_max_rss_bytes`).

Every configuration but 1 runs on --device (default "cuda").
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import random
import resource
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import _native
from .fields.host import Fp
from .fields.limbs import FR
from .fields.params import BLS12_381, BN254, CurveParams
from .groth16 import Groth16, Proof, ProvingKey, VerifyingKey, synthesize_witness
from .models import MulChainCircuit
from .ops.curve import limbs_to_points, pack_rows_u8
from .ops.curve_host import host_g1
from .ops.msm import pick_window_plane_signed, signed_digits
from .parallel import BatchProver, DistPlaneMsm, DistPlaneNtt, local_mesh
from .parallel.launch import run_ranks
from .relations import new_ref

CONFIG4_ITERS = 3


def device_kind(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def config1() -> dict:
    """2^10 a*b=c chain: synthesize, finalize, is_satisfied (host)."""
    n = 1 << 10
    t0 = time.time()
    cs = new_ref(Fp(BN254.fr))
    MulChainCircuit(seed=7, n=n, batch=True).generate_constraints(cs)
    cs.finalize()
    sat = cs.is_satisfied()
    dt = time.time() - t0
    if not sat:
        raise RuntimeError("configuration 1: the chain is not satisfied")
    return {"config": 1, "desc": "2^10 a*b=c chain, synthesize+sat-check (host)",
            "constraints": n, "satisfied": sat, "wall_s": round(dt, 4), "device": "cpu"}


def config_prove(config: int, curve: CurveParams, log_n: int, device) -> dict:
    """Configurations 2 and 3: set up, warm prove, prove, verify."""
    n = (1 << log_n) - 64
    g16 = Groth16(curve, device=device)
    circuit = MulChainCircuit(seed=7, n=n, batch=True)
    t0 = time.time()
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(0))
    t_setup = time.time() - t0
    g16.prove(pk, circuit, rng=random.Random(5))  # warm
    t0 = time.time()
    proof = g16.prove(pk, circuit, rng=random.Random(1))
    t_prove = time.time() - t0
    t0 = time.time()
    ok = g16.verify(vk, [7], proof)
    t_verify = time.time() - t0
    if not ok:
        raise RuntimeError(f"configuration {config}: the proof does not verify")
    return {"config": config, "desc": f"{curve.name} Groth16 prove (one device)",
            "constraints": n, "domain": pk.domain_size, "verified": ok,
            "setup_s": round(t_setup, 4), "prove_s": round(t_prove, 4),
            "verify_s": round(t_verify, 4), "stage_ms": g16.last_run.stage_ms,
            "device": device_kind(device)}


def config2(device="cuda") -> dict:
    return config_prove(2, BN254, 16, device)


def config3(log_n: int = 20, device="cuda") -> dict:
    return config_prove(3, BLS12_381, log_n, device)


def config4_rank(log_n: int, ranks: int, device) -> dict:
    """One rank of configuration 4 in a world of its own: the inputs made on
    every rank from the seed (c and the six-step split chosen for `ranks`
    ranks, so that the one-rank and the `ranks`-rank worlds compute the
    same), the MSM and the NTT timed on the mesh of the world. -> this
    rank's seconds, rank 0's window totals and this rank's transform shard
    (CPU)."""
    world = dist.get_world_size()
    n = 1 << log_n
    host_fr, hc = Fp(BN254.fr), host_g1(BN254)
    rng = random.Random(3)
    pool = [hc.scalar_mul(hc.generator, k + 1) for k in range(64)]
    rows = np.tile(pack_rows_u8(pool), (n // 64, 1))
    scalars = [host_fr.rand(rng) for _ in range(n)]
    c = pick_window_plane_signed(max(n // ranks, 256))
    digits = signed_digits(FR.tensor(scalars, "cpu", mont=False), c, BN254.fr.num_bits).numpy()
    coeffs = [host_fr.rand(rng) for _ in range(n)]
    n1 = 1 << (log_n // 2)
    while n1 % ranks or (n // n1) % ranks:
        n1 *= 2
    mesh = local_mesh("tp", device=device)

    def timed(run):
        """-> (mean seconds of CONFIG4_ITERS runs after a warm one, the result)."""
        y = run()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        for _ in range(CONFIG4_ITERS):
            y = run()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return (time.perf_counter() - t0) / CONFIG4_ITERS, y

    dm = DistPlaneMsm(c, mesh, "tp")
    tbl, dig = dm.shard_table(rows), dm.shard_table(digits)
    msm_s, sums = timed(lambda: dm.window_sums(tbl, dig))
    dn = DistPlaneNtt(n1, n // n1, mesh, "tp")
    i, nl = mesh.index("tp"), n // world
    x = FR.tensor(coeffs[i * nl : (i + 1) * nl], mesh.device)
    ntt_s, ev = timed(lambda: dn.fft(x))
    res = {"rank": dist.get_rank(), "backend": mesh.backend, "window_bits": c, "n1": n1,
           "block_path": dm.block_path, "msm_s": msm_s, "ntt_s": ntt_s, "ntt": ev.cpu(),
           "msm": sums.cpu() if i == 0 else None}
    if mesh.device.type == "cuda":
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(mesh.device)
    return res


def config4(log_n: int = 12, ranks: int = 2, device="cuda") -> dict:
    """Configuration 4: a world of one rank, then a world of `ranks` ranks
    (each spawned on this host, its backend from the layout), the second's
    results equal to the first's."""
    t0 = time.time()
    one = run_ranks(config4_rank, 1, device, log_n, ranks, device)[0]
    per_rank = run_ranks(config4_rank, ranks, device, log_n, ranks, device)
    head = per_rank[0]
    msm_equal = limbs_to_points(one["msm"]) == limbs_to_points(head["msm"])
    ntt_equal = torch.equal(one["ntt"], torch.cat([r["ntt"] for r in per_rank]))
    if not (msm_equal and ntt_equal):
        raise RuntimeError(f"configuration 4: the {ranks}-rank results differ from one rank's")
    t1, tn = one["msm_s"], max(r["msm_s"] for r in per_rank)
    s1, sn = one["ntt_s"], max(r["ntt_s"] for r in per_rank)
    rec = {"config": 4, "desc": "distributed plane MSM + six-step NTT over a mesh of ranks",
           "n": 1 << log_n, "devices": ranks, "ranks": ranks, "backend": head["backend"],
           "backend_1dev": one["backend"],
           "cards": torch.cuda.device_count() if torch.device(device).type == "cuda" else 0,
           "window_bits": head["window_bits"], "block_path": head["block_path"],
           "msm_1dev_s": round(t1, 6), "msm_ndev_s": round(tn, 6),
           "msm_scaling_eff": round(t1 / (ranks * tn), 4),
           "ntt_n1": head["n1"], "ntt_1dev_s": round(s1, 6), "ntt_ndev_s": round(sn, 6),
           "ntt_scaling_eff": round(s1 / (ranks * sn), 4), "equal": True,
           "wall_s": round(time.time() - t0, 3), "device": device_kind(device)}
    if "max_memory_allocated" in head:
        rec["max_memory_allocated_1dev"] = one["max_memory_allocated"]
        rec["max_memory_allocated"] = [r["max_memory_allocated"] for r in per_rank]
    return rec


@dataclass
class Config5:
    """Configuration 5's key, circuits and randomness: the warm pair and
    one (r, s) a circuit, drawn in that order from random.Random(1)."""

    g16: Groth16
    pk: ProvingKey
    vk: VerifyingKey
    circuits: list
    warm_rs: tuple
    rs: list
    setup_s: float


def config5_setup(batch: int, log_n: int, device="cuda") -> Config5:
    n = (1 << log_n) - 64
    g16 = Groth16(BN254, device=device)
    circuits = [MulChainCircuit(seed=s, n=n, batch=True) for s in range(batch)]
    t0 = time.time()
    pk, vk = g16.circuit_specific_setup(circuits[0], random.Random(0))
    setup_s = time.time() - t0
    rng, fr = random.Random(1), Fp(BN254.fr)
    warm_rs = (fr.rand(rng), fr.rand(rng))
    rs = [(fr.rand(rng), fr.rand(rng)) for _ in circuits]
    return Config5(g16, pk, vk, circuits, warm_rs, rs, setup_s)


def _timed_start(device) -> float:
    """After a warm run: the device drained, its peak memory and the
    kernels' launch counters set to 0. -> the start time."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    _native.reset_launches()
    return time.time()


def config5_loop(run: Config5) -> tuple[list[Proof], float]:
    """The one-card mode: a warm prove, then each witness synthesized on a
    one-thread executor while the main thread proves the previous one.
    -> (proofs, wall seconds of the timed loop)."""
    g16, pk, curve = run.g16, run.pk, run.g16.curve
    g16.prove_from_assignment(pk, synthesize_witness(run.circuits[0], curve), *run.warm_rs)
    t0 = _timed_start(g16.device)
    proofs = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(synthesize_witness, run.circuits[0], curve)
        for i in range(len(run.circuits)):
            z = fut.result()
            if i + 1 < len(run.circuits):
                fut = ex.submit(synthesize_witness, run.circuits[i + 1], curve)
            proofs.append(g16.prove_from_assignment(pk, z, *run.rs[i]))
    return proofs, time.time() - t0


def config5_batch(run: Config5) -> tuple[list[Proof], float, BatchProver]:
    """The same circuits and (r, s) pairs through `BatchProver`, after a
    warm batch of one. -> (proofs, wall seconds, the prover)."""
    bp = BatchProver(run.g16, run.pk)
    bp.prove_batch(run.circuits[:1], rs=[run.warm_rs])
    t0 = _timed_start(run.g16.device)
    proofs = bp.prove_batch(run.circuits, rs=run.rs)
    return proofs, time.time() - t0, bp


def verify_sample(run: Config5, proofs: list[Proof]) -> bool:
    """The first four proofs verify with their circuit's seed."""
    pvk = run.g16.process_vk(run.vk)
    return all(run.g16.verify_with_processed_vk(pvk, [s], pf)
               for s, pf in list(enumerate(proofs))[:4])


def config5(batch: int = 256, log_n: int = 18, batch_prover: bool = False,
            device="cuda") -> dict:
    run = config5_setup(batch, log_n, device)
    extra = {}
    if batch_prover:
        proofs, dt, bp = config5_batch(run)
        mode = "BatchProver (one device, device Horner combine)"
        extra["stage_ms"] = bp.last_run.stage_ms
        extra["device_ms"] = bp.last_run.device_ms
    else:
        proofs, dt = config5_loop(run)
        mode = "prove loop (one device, witness prefetch)"
    if torch.device(device).type == "cuda":
        extra["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    ok = verify_sample(run, proofs)
    if not ok:
        raise RuntimeError("configuration 5: a sampled proof does not verify")
    return {"config": 5, "desc": "batched proving throughput", "mode": mode, "batch": batch,
            "constraints": (1 << log_n) - 64, "devices": 1, "verified_sample": ok,
            "setup_s": round(run.setup_s, 4), "wall_s": round(dt, 4),
            "proofs_per_s": round(batch / dt, 4), **extra,
            "host_max_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "device": device_kind(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", type=int, default=[1], help="1 to 5 (default 1)")
    ap.add_argument("--batch", type=int, default=256, help="configuration 5's proofs")
    ap.add_argument("--log-n", type=int, default=18, help="configuration 5's log2 domain")
    ap.add_argument("--config3-log-n", type=int, default=20)
    ap.add_argument("--config4-log-n", type=int, default=12)
    ap.add_argument("--ranks", type=int, default=2, help="configuration 4's world size")
    ap.add_argument("--batch-prover", action="store_true",
                    help="configuration 5 through BatchProver")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not set(args.configs) <= {1, 2, 3, 4, 5}:
        ap.error(f"no configuration {sorted(set(args.configs) - {1, 2, 3, 4, 5})}: "
                 "choose from 1 to 5")
    for config in args.configs:
        if config == 1:
            rec = config1()
        elif config == 2:
            rec = config2(args.device)
        elif config == 3:
            rec = config3(args.config3_log_n, args.device)
        elif config == 4:
            rec = config4(args.config4_log_n, args.ranks, args.device)
        else:
            rec = config5(args.batch, args.log_n, args.batch_prover, args.device)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
