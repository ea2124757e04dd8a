"""Gadget-style circuit authoring with namespace tracing: the satisfiable
case.

    python -m snark_tpu_torch.examples.satisfiable

The counterpart of the repository's `examples/satisfiable.py` (itself
after ark-relations' examples/satisfiable.rs): helpers build sub-circuits
inside named spans, so each constraint's provenance is recorded, and the
system satisfies. The script turns its phase timers on
(SNARK_TPU_TIMERS=1) and so prints finalize's timer tree; the port's
timers print nothing, so this module prints the same tree from the times
`finalize` keeps (`finalize_ms`), then the counts and the verdict.
"""

import time

from ..fields import BN254_FR, Fp
from ..relations import ConstraintLayer, FpVar, new_ref, ns


def cube_gadget(cs, x: FpVar) -> FpVar:
    """x^3 inside its own namespace."""
    with ns(cs, "cube"):
        x2 = x.square()
        return x2 * x


def range_gadget(cs, x: FpVar, bits: int):
    with ns(cs, "range-check"):
        x.to_bits(bits)


def print_finalize_timers(stage_ms: dict, total_ms: float) -> None:
    """finalize's timer tree, as the JAX package's timers print it."""
    print("Start: Finalize GR1CS")
    print("  Start: Inline/Outline LCs")
    print(f"  End:   Inline/Outline LCs {stage_ms['inline']:.3f} ms")
    print("  Start: Instance Outlining")
    print(f"  End:   Instance Outlining {stage_ms['outline']:.3f} ms")
    print(f"End:   Finalize GR1CS {total_ms:.3f} ms")


def main():
    with ConstraintLayer():
        cs = new_ref(Fp(BN254_FR))
        with ns(cs, "inputs"):
            x = FpVar.new_input(cs, 3)
            y = FpVar.new_input(cs, 35)
        with ns(cs, "x^3 + x + 5 == y"):
            x3 = cube_gadget(cs, x)
            lhs = x3 + x + FpVar.constant(cs, 5)
            lhs.enforce_equal(y)
        range_gadget(cs, x, 8)

        t0 = time.perf_counter()
        cs.finalize()
        print_finalize_timers(cs.inner.finalize_ms, (time.perf_counter() - t0) * 1e3)
        print(f"constraints: {cs.num_constraints()}")
        print(f"variables:   {cs.num_variables()}")
        sat = cs.is_satisfied()
        print(f"satisfied:   {sat}")
        assert sat


if __name__ == "__main__":
    main()
