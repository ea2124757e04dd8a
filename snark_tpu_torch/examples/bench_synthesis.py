"""Constraint-synthesis throughput, after ark-relations' examples/bench.rs
and bench-no-finalize.rs.

    python -m snark_tpu_torch.examples.bench_synthesis [log2_n]

The counterpart of the repository's `examples/bench_synthesis.py`: n =
2^log2_n (16; the reference benches 2^23, all host work) random
constraints with LCs of at most 10 terms (`RandomLcCircuit`), timed with
finalize (LC inlining) and without finalize or matrices; the batch API on
the a·b = c chain (MulChain, configuration 1's shape) with finalize; and
the LC engine end to end on the bench.rs workload (`NativeSynthesizer`,
then `NativeInliner.inline_raw`). Prints a line each, as the script.
"""

import sys
import time

import numpy as np

from ..fields import BLS12_381_FR, Fp
from ..models import MulChainCircuit, RandomLcCircuit
from ..relations import SynthesisMode, new_ref
from ..relations.native import NativeInliner, NativeSynthesizer

NUM_COEFFS_IN_LC = 10  # bench.rs:13


def bench(n: int, finalize: bool, construct_matrices: bool = True) -> float:
    cs = new_ref(Fp(BLS12_381_FR))
    cs.set_mode(SynthesisMode.prove(construct_matrices=construct_matrices,
                                    generate_lc_assignments=False))
    circuit = RandomLcCircuit(n=n, terms_per_lc=NUM_COEFFS_IN_LC, seed=0)
    t0 = time.perf_counter()
    circuit.generate_constraints(cs)
    if finalize:
        cs.finalize()
    dt = time.perf_counter() - t0
    if construct_matrices:
        assert cs.num_constraints() == n
    return dt


def bench_batch_chain(n: int) -> float:
    """The columnar batch path on the a·b = c chain."""
    cs = new_ref(Fp(BLS12_381_FR))
    t0 = time.perf_counter()
    MulChainCircuit(seed=7, n=n, batch=True).generate_constraints(cs)
    cs.finalize()
    dt = time.perf_counter() - t0
    assert cs.num_constraints() == n
    return dt


def bench_native(n: int) -> tuple[float, float]:
    """The LC engine on the bench.rs workload: random-LC generation,
    interning and columnar storage, then the inline pass over them (the
    interner's first two slots hold 1 and −1, as a constraint system's)."""
    p = BLS12_381_FR.modulus
    ns_, ni = NativeSynthesizer(p), NativeInliner(p)
    t0 = time.perf_counter()
    off, vars_, cids, vals, _ = ns_.synthesize(n, NUM_COEFFS_IN_LC, seed=0,
                                               num_vars=max(64, n // 4))
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = np.zeros((2, 4), dtype=np.uint64)
    pre[0, 0] = 1
    pre[1] = [((p - 1) >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]
    ni.inline_raw(off, vars_, cids, np.concatenate([pre, vals], axis=0))
    return t_synth, time.perf_counter() - t0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    log_n = int(argv[0]) if argv else 16
    n = 1 << log_n
    dt1 = bench(n, finalize=True)
    print(f"random-LC synthesis 2^{log_n} with finalize:    {dt1:8.3f} s "
          f"({n/dt1:,.0f} constraints/s)", flush=True)
    dt2 = bench(n, finalize=False, construct_matrices=False)
    print(f"random-LC synthesis 2^{log_n} no finalize/mats: {dt2:8.3f} s "
          f"({n/dt2:,.0f} constraints/s)", flush=True)
    dt3 = bench_batch_chain(n)
    print(f"batch-API a*b=c chain 2^{log_n} + finalize:     {dt3:8.3f} s "
          f"({n/dt3:,.0f} constraints/s)", flush=True)
    ts, ti = bench_native(n)
    print(f"native-engine random-LC 2^{log_n}: synth {ts:7.3f} s "
          f"({n/ts:,.0f} c/s) + inline {ti:7.3f} s "
          f"({n/ti:,.0f} c/s)", flush=True)


if __name__ == "__main__":
    main()
