"""Circuits: reference fixtures + benchmark circuits.

The port's own copy of the JAX package's `models/circuits.py`: every
circuit synthesizes through the port's relations layer.
Circuit1/Circuit2 mirror the reference's golden-matrix fixtures
(relations/src/gr1cs/tests/circuit1.rs:28-61 and circuit2.rs:21-43).
MulChainCircuit is the a*b=c chain of the benchmark configurations (1-5);
RandomLcCircuit is the synthesis-throughput bench shape
(relations/examples/bench.rs:85-109).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from ..relations import (
    ConstraintSystemRef,
    PredicateConstraintSystem,
    ns,
)
from ..relations import variable as V


@dataclass
class Circuit1:
    """5 instance + 8 witness vars, 3 custom polynomial predicates."""

    x1: int
    x2: int
    x3: int
    x4: int
    x5: int
    w1: int
    w2: int
    w3: int
    w4: int
    w5: int
    w6: int
    w7: int
    w8: int

    def generate_constraints(self, cs: ConstraintSystemRef) -> None:
        field = cs.field
        with ns(cs, "Input variables"):
            x1 = cs.new_input_variable(lambda: self.x1)
            x2 = cs.new_input_variable(lambda: self.x2)
            x3 = cs.new_input_variable(lambda: self.x3)
            x4 = cs.new_input_variable(lambda: self.x4)
            x5 = cs.new_input_variable(lambda: self.x5)
        with ns(cs, "Witness variables"):
            w1 = cs.new_witness_variable(lambda: self.w1)
            w2 = cs.new_witness_variable(lambda: self.w2)
            w3 = cs.new_witness_variable(lambda: self.w3)
            w4 = cs.new_witness_variable(lambda: self.w4)
            w5 = cs.new_witness_variable(lambda: self.w5)
            w6 = cs.new_witness_variable(lambda: self.w6)
            _w7 = cs.new_witness_variable(lambda: self.w7)
            w8 = cs.new_witness_variable(lambda: self.w8)

        one = 1
        three = 3
        seven = 7
        minus_one = field.p - 1
        # A(v0..v3) = v0*v1 + 3*v2^2 - v3
        predicate_a = PredicateConstraintSystem.new_polynomial_predicate_cs(
            field, 4, [(one, [(0, 1), (1, 1)]), (three, [(2, 2)]), (minus_one, [(3, 1)])]
        )
        # B(v0..v2) = 7*v1 + v0^3 - v2
        predicate_b = PredicateConstraintSystem.new_polynomial_predicate_cs(
            field, 3, [(seven, [(1, 1)]), (one, [(0, 3)]), (minus_one, [(2, 1)])]
        )
        # C(v0..v2) = v0*v1 - v2
        predicate_c = PredicateConstraintSystem.new_polynomial_predicate_cs(
            field, 3, [(one, [(0, 1), (1, 1)]), (minus_one, [(2, 1)])]
        )
        cs.register_predicate("poly-predicate-A", predicate_a)
        cs.register_predicate("poly-predicate-B", predicate_b)
        cs.register_predicate("poly-predicate-C", predicate_c)

        with ns(cs, "Predicate A constraints"):
            cs.enforce_constraint_arity_4(
                "poly-predicate-A", cs.lc(x1), cs.lc(x2), cs.lc(x3), cs.lc(w4)
            )
        with ns(cs, "Predicate B constraints"):
            cs.enforce_constraint_arity_3(
                "poly-predicate-B", cs.lc(x4), cs.lc(w1), cs.lc(w5)
            )
            cs.enforce_constraint_arity_3(
                "poly-predicate-B", cs.lc(w5), cs.lc(w6), cs.lc(w8)
            )
        with ns(cs, "Predicate C constraints"):
            cs.enforce_constraint_arity_3(
                "poly-predicate-C", cs.lc(w2), cs.lc(w3), cs.lc(w6)
            )
            cs.enforce_constraint_arity_3(
                "poly-predicate-C", cs.lc(w5, w4), cs.lc(w8), cs.lc(x5)
            )


@dataclass
class Circuit2:
    """Legacy R1CS circuit with symbolic `new_lc`s (circuit2.rs)."""

    a: int
    b: int
    c: int

    def generate_constraints(self, cs: ConstraintSystemRef) -> None:
        two = 2
        a = cs.new_input_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_witness_variable(lambda: self.c)
        cs.enforce_r1cs_constraint(cs.lc(a), cs.lc_terms((two, b)), cs.lc(c))
        d = cs.new_lc(cs.lc(a, b))
        cs.enforce_r1cs_constraint(cs.lc(a), cs.lc(d), cs.lc(d))
        e = cs.new_lc(cs.lc(d, d))
        cs.enforce_r1cs_constraint(cs.lc(V.ONE), cs.lc(e), cs.lc(e))


@dataclass
class DummyCircuit:
    """a*b=c repeated — the shape Groth16 repos use for benches
    (sr1cs/mod.rs:268-331)."""

    a: int | None
    b: int | None
    num_variables: int
    num_constraints: int

    def generate_constraints(self, cs: ConstraintSystemRef) -> None:
        a = cs.new_witness_variable(lambda: self._req(self.a))
        b = cs.new_witness_variable(lambda: self._req(self.b))
        c = cs.new_input_variable(
            lambda: self._req(self.a) * self._req(self.b) % cs.field.p
        )
        for _ in range(self.num_variables - 3):
            cs.new_witness_variable(lambda: self._req(self.a))
        for _ in range(self.num_constraints - 1):
            cs.enforce_r1cs_constraint(cs.lc(a), cs.lc(b), cs.lc(c))
        cs.enforce_r1cs_constraint(cs.lc(), cs.lc(), cs.lc())

    @staticmethod
    def _req(v):
        from ..relations.error import AssignmentMissing

        if v is None:
            raise AssignmentMissing("DummyCircuit value missing")
        return v


@dataclass
class MulChainCircuit:
    """The a*b=c chain of n constraints of the benchmark configurations.

    w_0 = seed (instance), w_{i+1} = w_i * m_i with witness multipliers m_i;
    final product is an instance output. Synthesizes via the *batch* API when
    `batch=True` (the columnar path) or per-constraint closures when
    False — both must produce identical systems (tested).
    """

    seed: int
    n: int
    batch: bool = True

    def generate_constraints(self, cs: ConstraintSystemRef) -> None:
        field = cs.field
        p = field.p
        n = self.n
        setup = cs.is_in_setup_mode()

        # witness chain values (vectorized witness solving on host)
        if not setup:
            vals = [self.seed % p]
            mults = []
            x = self.seed % p
            for i in range(n):
                m = (i * 2654435761 + 12345) % p  # deterministic multipliers
                mults.append(m)
                x = x * m % p
                vals.append(x)
        else:
            vals, mults = [], []

        x0 = cs.new_input_variable((lambda: self.seed % p) if not setup else None)
        if self.batch:
            m_vars = cs.new_witness_variables(mults, count=n)
            c_vars = cs.new_witness_variables(vals[1:] if vals else [], count=n)
            a_vars = np.concatenate(
                [np.array([x0], dtype=np.uint64), c_vars[:-1]]
            )
            cs.enforce_r1cs_constraints_batch_vars(a_vars, m_vars, c_vars)
        else:
            m_vars = [
                cs.new_witness_variable((lambda i=i: mults[i]) if not setup else None)
                for i in range(n)
            ]
            c_vars = [
                cs.new_witness_variable(
                    (lambda i=i: vals[i + 1]) if not setup else None
                )
                for i in range(n)
            ]
            prev = x0
            for i in range(n):
                cs.enforce_r1cs_constraint(
                    cs.lc(prev), cs.lc(m_vars[i]), cs.lc(c_vars[i])
                )
                prev = c_vars[i]


@dataclass
class RandomLcCircuit:
    """Synthesis-throughput bench: n constraints whose LCs have up to
    `terms_per_lc` random terms (relations/examples/bench.rs:13, :85-109)."""

    n: int
    terms_per_lc: int = 10
    seed: int = 0

    def generate_constraints(self, cs: ConstraintSystemRef) -> None:
        rng = random.Random(self.seed)
        p = cs.field.p
        num_vars = max(64, self.n // 4)
        w = cs.new_witness_variables([1] * num_vars, count=num_vars)
        for _ in range(self.n):
            lcs = []
            for _arg in range(3):
                k = rng.randrange(1, self.terms_per_lc + 1)
                terms = [
                    (rng.randrange(1, p), int(w[rng.randrange(num_vars)]))
                    for _ in range(k)
                ]
                lcs.append(cs.lc_terms(*terms))
            cs.enforce_r1cs_constraint(*lcs)
