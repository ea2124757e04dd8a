"""Variable assignments (relations/src/gr1cs/assignment.rs).

The port's own copy of the JAX package's `relations/assignment.py`.

Three dense value vectors: instance (index 0 = ONE), witness, and a cache of
evaluated LC values. Values are canonical ints in [0, p).
"""

from __future__ import annotations

from . import variable as V


class Assignments:
    __slots__ = ("field", "instance_assignment", "witness_assignment", "lc_assignment")

    def __init__(self, field):
        self.field = field
        self.instance_assignment: list[int] = [1]  # index 0 = ONE
        self.witness_assignment: list[int] = []
        self.lc_assignment: list[int] = [0]  # LC 0 = the zero LC

    def assigned_value(self, v: int) -> int | None:
        """Dispatch on variable kind (assignment.rs:26-35)."""
        k = v >> V.TAG_SHIFT
        i = v & V.PAYLOAD_MASK
        if k == V.KIND_ZERO:
            return 0
        if k == V.KIND_ONE:
            return 1
        if k == V.KIND_INSTANCE:
            return self.instance_assignment[i] if i < len(self.instance_assignment) else None
        if k == V.KIND_WITNESS:
            return self.witness_assignment[i] if i < len(self.witness_assignment) else None
        return self.lc_assignment[i] if i < len(self.lc_assignment) else None

    def eval_lc(self, lc_index: int, lc_map, interner) -> int | None:
        """Sparse dot of one LcMap row with the assignment (assignment.rs:40-52)."""
        vars_, coeff_ids = lc_map.get(lc_index)
        p = self.field.p
        values = interner.values
        acc = 0
        for v, cid in zip(vars_, coeff_ids):
            av = self.assigned_value(v)
            if av is None:
                return None
            acc += values[cid] * av
        return acc % p
