"""Configuration 4 end to end on one card: the setup, two proves and the
verify of a 2^log-n BN254 MulChain.

    python -m snark_tpu_torch.config4_e2e [--log-n 24] [--pk PATH]
        [--setup-only] [--device cuda]

The counterpart of `scripts/run_config4_e2e.py`. The circuit is
MulChain(seed=4, n = 2^log-n − 64, batch=True), set up by
`circuit_specific_setup` from random.Random(0) with want_query=False (the
reference made its 2^23 key with SNARK_TPU_SETUP_QUERY=0, which leaves
the legacy query arrays out); with --pk the key is loaded from PATH where
it exists and saved there otherwise. Then `prove` from random.Random(5)
(cold: the first prove of the process) and from random.Random(1) (warm),
and `verify(vk, [4], proof)`.

Each stage prints one JSON line as it ends (`stage`: setup, prove_cold,
prove_warm, verify; seconds on the host clock, each device stage ending in
a synchronise, and the setup's and proves' own stage times in ms); the
last line holds every stage's seconds, the peak device memory
(`max_memory_allocated`, CUDA) and the process's peak resident host
memory (`host_max_rss_bytes`), and exits non-zero unless the proof
verifies.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import resource
import time

import torch

from .fields.params import BN254
from .groth16 import Groth16, ProvingKey
from .models import MulChainCircuit


def _line(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _ms(stage_ms: dict) -> dict:
    return {k: round(v, 3) for k, v in stage_ms.items()}


def run(log_n: int = 24, pk_path: str | None = None, setup_only: bool = False,
        device="cuda", emit=_line) -> dict:
    """The configuration as the command line runs it -> the final record."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    n = (1 << log_n) - 64
    g16 = Groth16(BN254, device=dev)
    circuit = MulChainCircuit(seed=4, n=n, batch=True)
    stages = {}
    t0 = time.perf_counter()
    if pk_path and os.path.exists(pk_path):
        pk = ProvingKey.load(pk_path, device=dev)
        vk = pk.vk
        stages["pk_load_s"] = time.perf_counter() - t0
        emit({"stage": "setup", "pk_loaded": True, "s": stages["pk_load_s"]})
    else:
        pk, vk = g16.circuit_specific_setup(circuit, random.Random(0), want_query=False)
        stages["setup_s"] = time.perf_counter() - t0
        setup = {"stage": "setup", "s": stages["setup_s"],
                 "stage_ms": _ms(g16.last_setup.stage_ms)}
        if pk_path:
            t1 = time.perf_counter()
            pk.save(pk_path)
            stages["pk_save_s"] = setup["pk_save_s"] = time.perf_counter() - t1
        emit(setup)
    rec = {"config": 4, "desc": f"end-to-end 2^{log_n} Groth16 prove, one card",
           "constraints": n, "domain": pk.domain_size, "device": str(dev)}
    if not setup_only:
        for label, seed in (("prove_cold", 5), ("prove_warm", 1)):
            t0 = time.perf_counter()
            proof = g16.prove(pk, circuit, rng=random.Random(seed))
            stages[f"{label}_s"] = time.perf_counter() - t0
            emit({"stage": label, "s": stages[f"{label}_s"],
                  "stage_ms": _ms(g16.last_run.stage_ms)})
        t0 = time.perf_counter()
        rec["verified"] = bool(g16.verify(vk, [4], proof))
        stages["verify_s"] = time.perf_counter() - t0
        emit({"stage": "verify", "s": stages["verify_s"], "verified": rec["verified"]})
    else:
        rec["setup_only"] = True
    rec.update(stages)
    if cuda:
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        rec["device_kind"] = torch.cuda.get_device_name(dev)
    rec["host_max_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=24)
    ap.add_argument("--pk", default=None, help="load the key from here, or save it here")
    ap.add_argument("--setup-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.log_n, args.pk, args.setup_only, args.device)
    _line(rec)
    return 0 if args.setup_only or rec["verified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
