"""Synthesis and witness-evaluation throughput at bench.rs shapes.

    python -m snark_tpu_torch.bench_synth [log_n] [--device cuda|cpu]

The counterpart of the repository's `scripts/bench_synth.py`. The
workload is relations/examples/bench.rs:85-109 (2^23 random constraints,
LCs of at most 10 terms, BLS12-381 Fr), which prints its wall clock and
publishes no numbers. On the host, in the port's LC engine
(`relations/native.py`, `csrc/lc_engine.cpp`):

  1. native random-LC synthesis (`NativeSynthesizer`: generation,
     interning, columnar CSR), 3·2^log_n constraints as the script asks;
  2. native witness evaluation of every argument LC against a random
     assignment (`NativeEvaluator.eval_rows`, ark-relations' eval_lc);
  3. the native inline pass over those LCs (`NativeInliner.inline_raw`,
     `finalize`'s inlining);
  4. the Python batch API on MulChain(7, 2^log_n, batch=True) with
     `finalize` (the a·b = c chain of configuration 1).

The coefficient ids start at 2, past a constraint system's pre-interned
1 and −1; the script hands the engine the table without those two slots,
so its evaluation and inlining read two rows past the table's end. The
port puts them in front.

All of it is host code: `--device` only says whether to put the card's
name and power limit beside the numbers. Prints one JSON line (the
script's keys, unrounded; `correct`: CHECK_ROWS evaluated rows equal
Python integer dot products; the host's CPU count) and writes no file.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import toolkit as T
from .fields.host import Fp
from .fields.params import BLS12_381
from .models import MulChainCircuit
from .relations import new_ref
from .relations.native import (
    NativeEvaluator,
    NativeSynthesizer,
    _from_u64x4,
    _to_u64x4,
    get_inliner,
)

TAG_SHIFT = 61
TERMS = 10
CHECK_ROWS = 64  # evaluated rows held against Python integer dot products


def witness_inputs(vars_: np.ndarray, num_vars: int):
    """A random canonical assignment (num_vars, 4) u64 from
    `RandomState(3)`, and each entry's column (−1 for the Zero variable)."""
    rng = np.random.RandomState(3)
    assignment = rng.randint(0, 2**63, size=(num_vars, 4)).astype(np.uint64)
    assignment[:, 3] &= (1 << 58) - 1  # < p
    var_to_col = (vars_ & ((1 << TAG_SHIFT) - 1)).astype(np.int64)
    var_to_col[(vars_ >> TAG_SHIFT).astype(np.int64) == 0] = -1
    return assignment, var_to_col


def eval_correct(out, offsets, coeff_ids, values, assignment, var_to_col, p: int) -> bool:
    """CHECK_ROWS rows of `eval_rows`' output, spread over all of them,
    equal Python integer dot products."""
    for row in np.linspace(0, len(offsets) - 2, CHECK_ROWS).astype(np.int64):
        lo, hi = offsets[row], offsets[row + 1]
        cols = var_to_col[lo:hi]
        coeffs = _from_u64x4(values[coeff_ids[lo:hi]])
        xs = _from_u64x4(assignment[np.maximum(cols, 0)])
        want = sum(c * x for c, x, col in zip(coeffs, xs, cols) if col >= 0) % p
        if _from_u64x4(out[row])[0] != want:
            return False
    return True


def run(log_n: int, device) -> dict:
    dev = T.resolve(device)
    n = 1 << log_n
    p = BLS12_381.fr.modulus
    res = {}
    synth = NativeSynthesizer(p)
    t0 = time.perf_counter()
    offsets, vars_, coeff_ids, values, _ = synth.synthesize(n * 3, TERMS, seed=7, num_vars=n)
    dt = time.perf_counter() - t0
    # the interner's slots 0 and 1 hold 1 and −1 (the ids start at 2)
    values = np.concatenate([_to_u64x4([1, p - 1]), values])
    res["native_synth_s"] = dt
    res["native_synth_constraints_per_s"] = n / dt
    res["nnz"] = int(offsets[-1])

    ev = NativeEvaluator(p)
    t0 = time.perf_counter()
    assignment, var_to_col = witness_inputs(vars_, n)
    out = ev.eval_rows(offsets, vars_, coeff_ids, values, assignment, var_to_col)
    dt = time.perf_counter() - t0
    res["native_witness_eval_s"] = dt
    res["native_witness_eval_lcs_per_s"] = 3 * n / dt
    res["native_witness_eval_constraints_per_s"] = n / dt
    res["witness_eval_checksum"] = int(out[:, 0].sum() % (1 << 63))
    correct = eval_correct(out, offsets, coeff_ids, values, assignment, var_to_col, p)

    inliner = get_inliner(p)
    t0 = time.perf_counter()
    inliner.inline_raw(offsets, vars_, coeff_ids, values)
    dt = time.perf_counter() - t0
    res["native_inline_s"] = dt
    res["native_inline_constraints_per_s"] = n / dt

    total = res["native_synth_s"] + res["native_witness_eval_s"]
    res["synth_plus_witness_s"] = total
    res["synth_plus_witness_constraints_per_s"] = n / total

    cs = new_ref(Fp(BLS12_381.fr))
    t0 = time.perf_counter()
    MulChainCircuit(seed=7, n=n, batch=True).generate_constraints(cs)
    cs.finalize()
    dt = time.perf_counter() - t0
    if cs.num_constraints() != n:
        raise RuntimeError(f"MulChain gave {cs.num_constraints()} constraints, want {n}")
    res["python_batch_chain_s"] = dt
    res["python_batch_chain_constraints_per_s"] = n / dt
    return {
        "tool": "bench_synth", "metric": f"gr1cs_synthesis_2e{log_n}",
        "shape": f"bench.rs parity: 2^{log_n} random constraints, <={TERMS}-term LCs, "
                 "BLS12-381 Fr",
        "results": res, "correct": correct, "host_cpus": os.cpu_count(),
        "reference": "relations/examples/bench.rs:85-109 prints wall-clock only, "
                     "publishes no numbers",
        **T.card(dev),
    }


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("log_n", type=int, nargs="?", default=23)
    a = ap.parse_args(argv)
    return 0 if T.emit(run(a.log_n, a.device))["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
