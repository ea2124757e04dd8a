"""Predicates and per-predicate constraint storage (GR1CS).

The port's own copy of the JAX package's `relations/predicate.py`.

Mirrors relations/src/gr1cs/predicate/{mod.rs, polynomial_constraint.rs}:
a GR1CS constraint system holds one `PredicateConstraintSystem` per registered
predicate label; each stores its argument LCs column-major (`argument_lcs[i]`
is the list of variables feeding the i-th predicate argument, one entry per
constraint — predicate/mod.rs:81-94). The only built-in predicate kind is the
sparse multivariate polynomial predicate (R1CS: x0*x1 - x2; SR1CS: x0^2 - x1).
"""

from __future__ import annotations

from ..fields.host import Fp
from .error import ArityMismatch

R1CS_PREDICATE_LABEL = "R1CS"
SR1CS_PREDICATE_LABEL = "SR1CS"


class PolynomialPredicate:
    """Sparse multivariate polynomial L(x_0..x_{arity-1}).

    ``terms`` is a list of (coeff, [(var_idx, power), ...]) — the same shape
    as the reference constructor (polynomial_constraint.rs:30-38).
    """

    __slots__ = ("arity", "terms", "field")

    def __init__(self, field: Fp, arity: int, terms):
        self.field = field
        self.arity = arity
        # normalize: coeff mod p, term product sorted by var index
        self.terms = [
            (int(c) % field.p, tuple(sorted((int(v), int(e)) for (v, e) in t)))
            for (c, t) in terms
        ]

    def degree(self) -> int:
        return max((sum(e for (_, e) in t) for (_, t) in self.terms), default=0)

    def eval(self, variables) -> int:
        p = self.field.p
        acc = 0
        for c, t in self.terms:
            prod = c
            for v, e in t:
                prod = prod * pow(variables[v], e, p) % p
            acc += prod
        return acc % p

    def is_satisfied(self, variables) -> bool:
        return self.eval(variables) == 0

    def __eq__(self, other):
        return (
            isinstance(other, PolynomialPredicate)
            and self.arity == other.arity
            and sorted(self.terms) == sorted(other.terms)
        )

    def __repr__(self):
        return f"PolynomialPredicate(arity={self.arity}, terms={self.terms})"


# `Predicate` in the reference is a one-variant enum wrapping
# PolynomialPredicate (predicate/mod.rs:20-25); in Python the class itself
# plays that role. Alias for API parity:
Predicate = PolynomialPredicate


def new_r1cs_predicate(field: Fp) -> PolynomialPredicate:
    """x0 * x1 - x2 (predicate/mod.rs:115-121)."""
    return PolynomialPredicate(
        field, 3, [(1, [(0, 1), (1, 1)]), (field.p - 1, [(2, 1)])]
    )


def new_sr1cs_predicate(field: Fp) -> PolynomialPredicate:
    """x0^2 - x1 (predicate/mod.rs:123-128)."""
    return PolynomialPredicate(field, 2, [(1, [(0, 2)]), (field.p - 1, [(1, 1)])])


class PredicateConstraintSystem:
    """Column-major storage of constraints for one predicate."""

    __slots__ = ("argument_lcs", "num_constraints", "predicate")

    def __init__(self, predicate: PolynomialPredicate):
        self.predicate = predicate
        self.argument_lcs: list[list[int]] = [[] for _ in range(predicate.arity)]
        self.num_constraints = 0

    @classmethod
    def new_polynomial_predicate_cs(cls, field: Fp, arity: int, terms):
        return cls(PolynomialPredicate(field, arity, terms))

    @classmethod
    def new_r1cs(cls, field: Fp):
        return cls(new_r1cs_predicate(field))

    @classmethod
    def new_sr1cs(cls, field: Fp):
        return cls(new_sr1cs_predicate(field))

    def get_arity(self) -> int:
        return self.predicate.arity

    def get_predicate(self):
        return self.predicate

    def enforce_constraint(self, constraint_vars) -> None:
        """Push one Variable per argument (predicate/mod.rs:156-174)."""
        arity = 0
        for var, arg_col in zip(constraint_vars, self.argument_lcs):
            arity += 1
            arg_col.append(var)
        if arity != self.get_arity():
            raise ArityMismatch(
                f"expected {self.get_arity()} LCs, got {arity}"
            )
        self.num_constraints += 1

    def enforce_constraints_batch(self, columns: list[list[int]]) -> None:
        """Batch append: one list of variables per argument."""
        if len(columns) != self.get_arity():
            raise ArityMismatch(
                f"expected {self.get_arity()} columns, got {len(columns)}"
            )
        n = len(columns[0])
        for col, arg_col in zip(columns, self.argument_lcs):
            if len(col) != n:
                raise ArityMismatch("ragged batch columns")
            arg_col.extend(col)
        self.num_constraints += n

    def iter_constraints(self):
        """Row-major view: one [var per argument] list per constraint."""
        for i in range(self.num_constraints):
            yield [col[i] for col in self.argument_lcs]

    def which_constraint_is_unsatisfied(self, cs) -> int | None:
        """Index of first failing row, else None (predicate/mod.rs:185-204)."""
        field = self.predicate.field
        for i, constraint in enumerate(self.iter_constraints()):
            values = []
            for v in constraint:
                val = cs.assigned_value(v)
                if val is None:
                    # un-cached symbolic LC: evaluate its row directly
                    val = cs.eval_lc_of_variable(v)
                values.append(val)
            if not self.predicate.is_satisfied(values):
                return i
        return None

    def to_matrices(self, cs) -> list[list[list[tuple[int, int]]]]:
        """One sparse matrix per predicate argument (predicate/mod.rs:207-217)."""
        matrices: list[list[list[tuple[int, int]]]] = [
            [] for _ in range(self.get_arity())
        ]
        for constraint in self.iter_constraints():
            for arg_i, var in enumerate(constraint):
                lc = cs.get_lc(var)
                matrices[arg_i].append(cs.make_row(lc))
        return matrices
