"""Instance outlining strategies (relations/src/gr1cs/instance_outliner.rs).

The port's own copy of the JAX package's `relations/instance_outliner.py`.

Verifier-succinctness rewrite (Polymath / Garuda / Pari): replace instance
variables with fresh witnesses everywhere, then a pluggable `func` adds the
binding equality constraints. Driven from `ConstraintSystem.finalize`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import variable as V
from .predicate import R1CS_PREDICATE_LABEL, SR1CS_PREDICATE_LABEL


@dataclass
class InstanceOutliner:
    pred_label: str
    func: Callable  # (cs, instance_to_witness_map: list[Variable]) -> None


def outline_r1cs(cs, instance_witness_map) -> None:
    """R1CS binding: one*one = One, then one*w_i = x_i (ref :41-61)."""
    one = instance_witness_map[0]
    cs.enforce_r1cs_constraint(cs.lc(one), cs.lc(one), cs.lc(V.ONE))
    for instance, witness in enumerate(instance_witness_map):
        if instance == 0:
            continue
        cs.enforce_r1cs_constraint(
            cs.lc(one), cs.lc(witness), cs.lc(V.instance(instance))
        )


def outline_sr1cs(cs, instance_witness_map) -> None:
    """SR1CS binding: (x_i - w_i)^2 = 0 (ref :64-81)."""
    for instance, witness in enumerate(instance_witness_map):
        cs.enforce_sr1cs_constraint(
            cs.lc_diff(V.instance(instance), witness), cs.lc()
        )


def r1cs_outliner() -> InstanceOutliner:
    return InstanceOutliner(R1CS_PREDICATE_LABEL, outline_r1cs)


def sr1cs_outliner() -> InstanceOutliner:
    return InstanceOutliner(SR1CS_PREDICATE_LABEL, outline_sr1cs)
