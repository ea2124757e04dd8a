"""Where the wall clock of a Groth16 setup goes, under cProfile.

    python -m snark_tpu_torch.profile_setup [--log-n N] [--curve bls|bn] [--top K]
                                            [--device cuda|cpu]

The counterpart of the repository's `scripts/profile_setup.py`: a setup
shaped like configuration 3, MulChain(seed=7, 2^N − 64 constraints,
batch=True) over BLS12-381 (PROFILE_CURVE=bn: BN254) from
`random.Random(0)`, at N = PROFILE_LOG_N (17), under cProfile. It prints
the setup's total, the top K (40) entries by cumulative time, then one
JSON line: the total, the setup's own `stage_ms` (`Groth16.last_setup`,
each stage ending in a device synchronise), the seconds spent inside
`torch.cuda.synchronize` (`sync_wait_s`: the host's explicit waits on
the card; a wait inside a readback counts with the host), the seconds of
the imports the setup triggered (`import_s`: modules that torch loads at
first use count, as a first setup in a process pays them), the top entries
again, and the card's name and power limit.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import random
import sys
import time

from . import toolkit as T
from .fields.params import BLS12_381, BN254
from .groth16.groth16 import Groth16
from .models import MulChainCircuit


def run(log_n: int, curve, device, top: int = 40) -> tuple[dict, str]:
    """-> (the JSON record, the printed cProfile table)."""
    dev = T.resolve(device)
    g16 = Groth16(curve, device=dev)
    circuit = MulChainCircuit(seed=7, n=(1 << log_n) - 64, batch=True)
    t0 = time.perf_counter()
    prof = cProfile.Profile()
    prof.enable()
    g16.circuit_specific_setup(circuit, random.Random(0))
    T.sync(dev)
    prof.disable()
    total_s = time.perf_counter() - t0
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out).sort_stats("cumulative")
    stats.print_stats(top)
    sync_s = sum(v[3] for k, v in stats.stats.items() if k[2] == "synchronize")
    import_s = sum(v[3] for k, v in stats.stats.items() if k[2] == "_find_and_load")
    rec = {
        "tool": "profile_setup", "curve": curve.name, "log_n": log_n,
        "constraints": circuit.n, "total_s": total_s,
        "stage_ms": g16.last_setup.stage_ms,
        "sync_wait_s": sync_s, "import_s": import_s,
        "top": [
            {"function": f"{k[0]}:{k[1]}({k[2]})", "calls": v[1], "tottime_s": v[2],
             "cumtime_s": v[3]}
            for k, v in sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:top]
        ],
        **T.card(dev),
    }
    return rec, out.getvalue()


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("--log-n", type=int, default=int(os.environ.get("PROFILE_LOG_N", "17")))
    ap.add_argument("--curve", choices=("bls", "bn"),
                    default=os.environ.get("PROFILE_CURVE", "bls"))
    ap.add_argument("--top", type=int, default=40)
    a = ap.parse_args(argv)
    curve = BLS12_381 if a.curve == "bls" else BN254
    rec, table = run(a.log_n, curve, a.device, a.top)
    print(f"TOTAL setup: {rec['total_s']:.1f}s at log_n={a.log_n} {curve.name}", flush=True)
    print(table, flush=True)
    T.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
