"""Coefficient interner: dedups LC coefficients into small integer ids.

The port's own copy of the JAX package's `relations/field_interner.py`.

Mirrors the reference FieldInterner (relations/src/gr1cs/field_interner.rs:
17-69): slot 0 = ONE and slot 1 = -ONE are pre-interned and fast-pathed. The
interner is what makes columnar NumPy storage of LCs possible: coefficient
*ids* (uint32) live in arrays; the handful of distinct 254-bit values live in
a Python-side table, converted to device limb arrays once at handoff.
"""

from __future__ import annotations

from ..fields.host import Fp

ONE_ID = 0
MINUS_ONE_ID = 1


class FieldInterner:
    __slots__ = ("field", "_ids", "values")

    def __init__(self, field: Fp):
        self.field = field
        one, minus_one = 1, field.p - 1
        self.values: list[int] = [one, minus_one]
        self._ids: dict[int, int] = {one: ONE_ID, minus_one: MINUS_ONE_ID}

    def get_or_intern(self, value: int) -> int:
        if value == 1:
            return ONE_ID
        i = self._ids.get(value)
        if i is None:
            i = len(self.values)
            self._ids[value] = i
            self.values.append(value)
        return i

    def value(self, interned_id: int) -> int:
        return self.values[interned_id]

    def __len__(self):
        return len(self.values)
