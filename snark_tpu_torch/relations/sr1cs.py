"""R1CS -> SR1CS whole-system compiler (relations/src/sr1cs/mod.rs:18-266).

The port's own copy of the JAX package's `relations/sr1cs.py`.

Per R1CS row <a,z>*<b,z> = <c,z>, emits two square constraints with a fresh
witness s:  (a+b)^2 = 4c + s  and  (a-b)^2 = s  (ref :141-175; the c
coefficients are doubled twice = x4 at :166-169). All original public vars
become witnesses, re-bound to fresh instances via (old - new)^2 = 0
(ref :177-182).
"""

from __future__ import annotations

from ..fields.host import Fp
from . import variable as V
from .constraint_system import ConstraintSystem, SynthesisMode, OptimizationGoal
from .constraint_system_ref import ConstraintSystemRef
from .error import AssignmentMissing
from .linear_combination import LinearCombination
from .predicate import (
    R1CS_PREDICATE_LABEL,
    SR1CS_PREDICATE_LABEL,
    PredicateConstraintSystem,
)


def evaluate_constraint(terms, assignment, p: int) -> int:
    """Sparse-row dot product (ref :24-56)."""
    acc = 0
    for coeff, index in terms:
        if coeff == 1:
            acc += assignment[index]
        else:
            acc += assignment[index] * coeff
    return acc % p


class Sr1csAdapter:
    @staticmethod
    def _map_row(
        row, public_variables, witness_variables, num_public, value_of, new_cs
    ):
        """Rebuild a matrix row as an LC over NEW variables, allocating a new
        witness on first sight of each old column (ref :85-116)."""
        field = new_cs.field
        terms = []
        val = 0
        for coeff, index in row:
            if index == 0:
                var, v = V.ONE, 1
            elif index < num_public:
                v = value_of(index)
                if index not in public_variables:
                    public_variables[index] = new_cs.new_witness_variable(
                        (lambda vv=v: vv) if v is not None else None
                    )
                var = public_variables[index]
            else:
                v = value_of(index)
                if index not in witness_variables:
                    witness_variables[index] = new_cs.new_witness_variable(
                        (lambda vv=v: vv) if v is not None else None
                    )
                var = witness_variables[index]
            terms.append((var, coeff % field.p))
            if v is not None:
                val += coeff * v
        lc = LinearCombination(field, terms)
        lc.compactify()
        return lc, val % field.p

    @staticmethod
    def _convert(cs_ref, with_assignment: bool) -> ConstraintSystemRef:
        cs = cs_ref.into_inner() if isinstance(cs_ref, ConstraintSystemRef) else cs_ref
        field: Fp = cs.field
        matrices = cs.to_matrices()[R1CS_PREDICATE_LABEL]
        a_mat, b_mat, c_mat = matrices[0], matrices[1], matrices[2]
        num_public = cs.num_instance_variables
        public_variables: dict[int, int] = {}
        witness_variables: dict[int, int] = {}

        if with_assignment:
            r1cs_assignment = cs.full_assignment()

            def value_of(index):
                return r1cs_assignment[index]

        else:

            def value_of(index):
                return 1  # placeholder (ref uses F::ONE in setup path :74-79)

        new_ref_ = ConstraintSystemRef.new(ConstraintSystem(field))
        new_cs = new_ref_.into_inner()
        new_cs.remove_predicate(R1CS_PREDICATE_LABEL)
        new_cs.register_predicate(
            SR1CS_PREDICATE_LABEL, PredicateConstraintSystem.new_sr1cs(field)
        )
        if with_assignment:
            new_cs.set_optimization_goal(OptimizationGoal.Constraints)
        else:
            new_cs.set_mode(SynthesisMode.setup())

        four = 4 % field.p
        for a_i, b_i, c_i in zip(a_mat, b_mat, c_mat):
            a_lc, a_val = Sr1csAdapter._map_row(
                a_i, public_variables, witness_variables, num_public, value_of, new_cs
            )
            b_lc, b_val = Sr1csAdapter._map_row(
                b_i, public_variables, witness_variables, num_public, value_of, new_cs
            )
            c_lc, _ = Sr1csAdapter._map_row(
                c_i, public_variables, witness_variables, num_public, value_of, new_cs
            )
            s_val = field.square(field.sub(a_val, b_val))
            square_variable = new_cs.new_witness_variable(lambda sv=s_val: sv)

            c4 = c_lc * four  # coefficients doubled twice (ref :166-169)
            left_1 = a_lc + b_lc
            right_1 = c4 + square_variable
            new_cs.enforce_sr1cs_constraint(left_1, right_1)

            left_2 = a_lc - b_lc
            right_2 = new_cs.lc(square_variable)
            new_cs.enforce_sr1cs_constraint(left_2, right_2)

        # re-bind old public columns to fresh instance variables (ref :253-262)
        for old_index in sorted(public_variables):  # BTreeMap order
            old_var = public_variables[old_index]
            if with_assignment:
                value = new_cs.assigned_value(old_var)
                if value is None:
                    raise AssignmentMissing(f"public column {old_index}")
                new_var = new_cs.new_input_variable(lambda vv=value: vv)
            else:
                new_var = new_cs.new_input_variable(None)
            new_cs.enforce_sr1cs_constraint(
                new_cs.lc_diff(old_var, new_var), new_cs.lc()
            )

        if with_assignment:
            new_cs.finalize()
        return new_ref_

    @staticmethod
    def r1cs_to_sr1cs(cs_ref) -> ConstraintSystemRef:
        """Setup-mode conversion (ref :124-183)."""
        cs = cs_ref.into_inner() if isinstance(cs_ref, ConstraintSystemRef) else cs_ref
        assert cs.num_predicates() == 1, "expected a pure-R1CS system"
        return Sr1csAdapter._convert(cs_ref, with_assignment=False)

    @staticmethod
    def r1cs_to_sr1cs_with_assignment(cs_ref) -> ConstraintSystemRef:
        """Conversion carrying the witness: s = (a_val - b_val)^2 (ref :191-265)."""
        return Sr1csAdapter._convert(cs_ref, with_assignment=True)
