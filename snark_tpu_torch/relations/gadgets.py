"""Gadget helpers for circuit authoring (an ark-r1cs-std-lite seed).

The port's own copy of the JAX package's `relations/gadgets.py`.

The reference's constraint system is consumed by a gadget library
(`ark-r1cs-std`, SURVEY.md §1 L4 "sits above"). This module seeds the same
role for this framework: allocation helpers and the most common R1CS
gadgets over a `ConstraintSystemRef`. Values are canonical field ints; all
gadgets work in both setup and prove modes (value closures are skipped in
setup, matching constraint_system.rs:598).
"""

from __future__ import annotations

from . import variable as V
from .constraint_system_ref import ConstraintSystemRef
from .error import AssignmentMissing, DivisionByZero
from .linear_combination import LinearCombination


class FpVar:
    """A field variable handle with operator sugar that emits constraints.

    Wraps (cs, variable, value). `value` is None in setup mode.
    """

    __slots__ = ("cs", "var", "value")

    def __init__(self, cs: ConstraintSystemRef, var: int, value: int | None):
        self.cs = cs
        self.var = var
        self.value = value

    # ----- allocation ---------------------------------------------------
    @staticmethod
    def new_input(cs: ConstraintSystemRef, value=None) -> "FpVar":
        setup = cs.is_in_setup_mode()
        v = cs.new_input_variable(None if setup else value)
        return FpVar(cs, v, None if setup else int(value) % cs.field.p)

    @staticmethod
    def new_witness(cs: ConstraintSystemRef, value=None) -> "FpVar":
        setup = cs.is_in_setup_mode()
        v = cs.new_witness_variable(None if setup else value)
        return FpVar(cs, v, None if setup else int(value) % cs.field.p)

    @staticmethod
    def constant(cs: ConstraintSystemRef, value: int) -> "FpVar":
        """The constant value·ONE (no new variable)."""
        return FpVar(cs, V.ONE, int(value) % cs.field.p)

    # ----- helpers ------------------------------------------------------
    def _val(self):
        if self.value is None:
            return None
        return self.value

    def lc(self) -> LinearCombination:
        if self.var == V.ONE and self.value is not None:
            return self.cs.lc_terms((self.value, V.ONE))
        return self.cs.lc(self.var)

    # ----- gadgets ------------------------------------------------------
    def __add__(self, other: "FpVar") -> "FpVar":
        """Addition is free: allocate the sum as a witness + one R1CS row
        1·(a+b) = s (kept linear so LC inlining can eliminate it)."""
        cs, f = self.cs, self.cs.field
        val = (
            None
            if self.value is None or other.value is None
            else f.add(self.value, other.value)
        )
        s = FpVar.new_witness(cs, val if val is not None else None)
        cs.enforce_r1cs_constraint(
            self.lc() + other.lc(), cs.lc(V.ONE), cs.lc(s.var)
        )
        return s

    def __mul__(self, other: "FpVar") -> "FpVar":
        cs, f = self.cs, self.cs.field
        val = (
            None
            if self.value is None or other.value is None
            else f.mul(self.value, other.value)
        )
        out = FpVar.new_witness(cs, val if val is not None else None)
        cs.enforce_r1cs_constraint(self.lc(), other.lc(), cs.lc(out.var))
        return out

    def square(self) -> "FpVar":
        return self * self

    def inverse(self) -> "FpVar":
        """out with self·out = 1 (unsatisfiable if self == 0)."""
        cs, f = self.cs, self.cs.field
        if self.value is not None and self.value == 0:
            raise DivisionByZero("inverse of zero wire")
        val = None if self.value is None else f.inv(self.value)
        out = FpVar.new_witness(cs, val)
        cs.enforce_r1cs_constraint(self.lc(), cs.lc(out.var), cs.lc(V.ONE))
        return out

    def enforce_equal(self, other: "FpVar") -> None:
        cs = self.cs
        cs.enforce_r1cs_constraint(
            self.lc() - other.lc(), cs.lc(V.ONE), cs.lc()
        )

    def enforce_bool(self) -> None:
        """b·(b-1) = 0."""
        cs = self.cs
        cs.enforce_r1cs_constraint(
            self.lc(), self.lc() - V.ONE, cs.lc()
        )

    def select(self, b: "FpVar", other: "FpVar") -> "FpVar":
        """b ? self : other for boolean b: out = other + b·(self - other)."""
        cs, f = self.cs, self.cs.field
        val = None
        if None not in (b.value, self.value, other.value):
            val = self.value if b.value == 1 else other.value
        out = FpVar.new_witness(cs, val)
        # b·(self - other) = out - other
        cs.enforce_r1cs_constraint(
            b.lc(), self.lc() - other.lc(), cs.lc(out.var) - other.lc()
        )
        return out

    def is_zero(self) -> "FpVar":
        """Boolean wire z = (self == 0), via the standard inv-trick:
        z = 1 - self·inv, self·z = 0 (inv arbitrary when self == 0)."""
        cs, f = self.cs, self.cs.field
        sval = self.value
        inv_val = None
        z_val = None
        if sval is not None:
            z_val = 1 if sval == 0 else 0
            inv_val = 0 if sval == 0 else f.inv(sval)
        inv = FpVar.new_witness(cs, inv_val)
        z = FpVar.new_witness(cs, z_val)
        one = cs.lc(V.ONE)
        cs.enforce_r1cs_constraint(
            self.lc(), cs.lc(inv.var), one - z.lc()
        )
        cs.enforce_r1cs_constraint(self.lc(), z.lc(), cs.lc())
        return z

    def to_bits(self, num_bits: int) -> list["FpVar"]:
        """Little-endian boolean decomposition with a packing constraint."""
        cs, f = self.cs, self.cs.field
        bits = []
        for i in range(num_bits):
            bval = None if self.value is None else (self.value >> i) & 1
            b = FpVar.new_witness(cs, bval)
            b.enforce_bool()
            bits.append(b)
        packing = LinearCombination(
            f, [(b.var, (1 << i) % f.p) for i, b in enumerate(bits)]
        )
        packing.compactify()
        cs.enforce_r1cs_constraint(packing, cs.lc(V.ONE), self.lc())
        return bits
