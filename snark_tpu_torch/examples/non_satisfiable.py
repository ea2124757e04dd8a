"""A deliberately broken circuit and trace-driven debugging.

    python -m snark_tpu_torch.examples.non_satisfiable

The counterpart of the repository's `examples/non_satisfiable.py` (after
ark-relations' examples/non_satisfiable.rs): the circuit of
`satisfiable` with a wrong public input; `which_is_unsatisfied` renders
the namespace trace captured for the first failing constraint like a
backtrace.
"""

from ..fields import BN254_FR, Fp
from ..relations import ConstraintLayer, FpVar, new_ref, ns


def main():
    with ConstraintLayer():
        cs = new_ref(Fp(BN254_FR))
        with ns(cs, "inputs"):
            x = FpVar.new_input(cs, 3)
            y = FpVar.new_input(cs, 36)  # wrong on purpose: x^3 + x + 5 = 35
        with ns(cs, "x^3 + x + 5 == y"):
            x3 = x.square() * x
            (x3 + x + FpVar.constant(cs, 5)).enforce_equal(y)

        cs.finalize()
        which = cs.which_is_unsatisfied()
        print("satisfied:", which is None)
        print("first unsatisfied constraint trace:")
        print(which)
        assert which is not None


if __name__ == "__main__":
    main()
