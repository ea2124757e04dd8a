"""The multichip dry run: a distributed prove and verify, then a dp-sharded
batch step, on a world of ranks.

    python -m snark_tpu_torch.dryrun [--ranks N] [--device cuda|cpu]
        [--log-n L] [--full]

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`, which
runs the same two stages on a virtual n-device CPU mesh:

1. `DistPlaneProver` (`parallel/plane_dist.py`) on a 1-D "tp" mesh of the
   ranks proves MulChainCircuit(seed=5, n=2^log_n − 2, batch=True) (domain
   2^log_n) at r = 3, s = 4 from a key set up from random.Random(0); every
   rank's proof must verify with public input [5].
2. A `lite` `BatchProver` on a (dp, tp) mesh, tp the largest of 1, 2, 4
   that divides the ranks (the reference's rule), over max(dp, 2) copies
   of MulChain(seed=5, n=8) under its key from random.Random(0): its h
   pipeline alone (`h_core`), or with `full` its device core (the A and B
   MSMs).

The keys are set up in this process, on `device`, and saved to a temporary
directory for the ranks, which load the first on the CPU and move their
blocks to their devices. Prints a timestamped line per stage and, last, one
JSON line: the ranks, the backend, the stages' seconds, every rank's proof
verified. Under torchrun (RANK set) each rank runs both stages on the world
that torchrun made; --ranks must equal its size.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time

import torch

from .fields.params import BN254
from .groth16 import Groth16, ProvingKey, synthesize_witness
from .models import MulChainCircuit
from .parallel.batch import BatchProver
from .parallel.launch import run_ranks, use_local_card
from .parallel.mesh import make_mesh
from .parallel.plane_dist import prove_from_file

PUBLIC = 5  # the circuits' seed, their public input


def dp_tp(n_ranks: int) -> tuple[int, int]:
    """The reference's (dp, tp) split of n ranks: tp the largest of 1, 2, 4
    dividing n."""
    tp = 1
    while n_ranks % (tp * 2) == 0 and tp < 4:
        tp *= 2
    return n_ranks // tp, tp


def dryrun_rank(path: str, circuit, small_path: str, small_circuit, full: bool,
                device) -> dict:
    """One rank of both stages -> its proof and stage records."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    stage1 = prove_from_file(path, circuit, device, "tp", r=3, s=4)
    t1 = time.perf_counter()
    dp, tp = dp_tp(dist.get_world_size())
    mesh = make_mesh((dp, tp), ("dp", "tp"), device)
    pk = ProvingKey.load(small_path, device=mesh.device)
    bp = BatchProver(Groth16(pk.vk.curve, device=mesh.device), pk, mesh, "dp", lite=True)
    batch = max(dp, 2)
    share = bp.share(batch)
    zs = [synthesize_witness(small_circuit, pk.vk.curve) if b in share else None
          for b in range(batch)]
    if full:
        g1, g2 = bp.core(zs)
        stage2 = {"core": "lite", "g1": list(g1.shape), "g2": list(g2.shape)}
    else:
        stage2 = {"core": "h_core", "h_digits": list(bp.h_core(zs).shape)}
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return {"proof": stage1.pop("proof"), "prove": stage1, "batch": {
        "dp": dp, "tp": tp, "proofs": batch, "share": list(share), **stage2},
        "stage_s": {"dist_prove": t1 - t0, "batch": time.perf_counter() - t1}}


def dryrun_multichip(n_ranks: int, device="cuda", log_n: int = 10, full: bool = False) -> dict:
    """Both stages on a world of n_ranks ranks; raises if a rank fails or a
    proof does not verify. -> the run's record (every rank's)."""
    t0 = time.perf_counter()

    def mark(stage: str) -> None:
        print(f"[dryrun +{time.perf_counter() - t0:7.1f}s] {stage}", flush=True)

    use_local_card(device)
    g16 = Groth16(BN254, device=device)
    circuit = MulChainCircuit(seed=PUBLIC, n=(1 << log_n) - 2, batch=True)
    small = MulChainCircuit(seed=PUBLIC, n=8, batch=False)
    mark(f"setting up the keys (log_n={log_n}) on {device}")
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(0))
    if pk.domain_size != 1 << log_n:
        raise AssertionError(f"domain {pk.domain_size}, want 2^{log_n}")
    small_pk, _ = g16.circuit_specific_setup(small, random.Random(0))
    with tempfile.TemporaryDirectory(prefix="snark_dryrun_") as d:
        path, small_path = os.path.join(d, "pk.npz"), os.path.join(d, "pk_small.npz")
        pk.save(path)
        small_pk.save(small_path)
        mark(f"keys saved; {n_ranks} ranks: distributed prove, then the dp-sharded batch")
        ranks = run_ranks(dryrun_rank, n_ranks, device, path, circuit, small_path, small, full,
                          device)
    mark("ranks done, verifying every rank's proof")
    pvk = g16.process_vk(vk)
    for r, res in enumerate(ranks):
        if not g16.verify_with_processed_vk(pvk, [PUBLIC], res["proof"]):
            raise AssertionError(f"rank {r}'s distributed proof does not verify")
    if any(res["proof"] != ranks[0]["proof"] for res in ranks):
        raise AssertionError("the ranks' proofs differ")
    mark("every proof verified")
    return {"ranks": n_ranks, "backend": ranks[0]["prove"]["backend"],
            "device": str(torch.device(device)), "log_n": log_n, "full": full,
            "verified": True, "seconds": round(time.perf_counter() - t0, 3),
            "per_rank": [{k: v for k, v in res.items() if k != "proof"} for res in ranks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=int(os.environ.get("WORLD_SIZE", 2)))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-n", type=int, default=10)
    ap.add_argument("--full", action="store_true", help="the lite device core in stage 2")
    args = ap.parse_args(argv)
    rec = dryrun_multichip(args.ranks, args.device, args.log_n, args.full)
    print(json.dumps(rec, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
