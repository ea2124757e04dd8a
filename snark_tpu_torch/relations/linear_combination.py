"""Linear combinations: sorted (coeff, variable) term lists with merge algebra.

The port's own copy of the JAX package's `relations/linear_combination.py`.

Semantics mirror the reference LinearCombination (relations/src/utils/
linear_combination.rs): terms are kept sorted by variable; `compactify` sorts
and merges duplicate variables (:53-82); addition/subtraction of two LCs is a
sorted merge (`op_impl`, :296-336); scalar multiply scales coefficients in
place. Coefficients are canonical ints in [0, p) for the field carried by the
LC.
"""

from __future__ import annotations

from bisect import bisect_left

from ..fields.host import Fp


class LinearCombination:
    """A sorted list of (variable, coeff) terms over a prime field.

    Note the internal storage order is (var, coeff) so bisect keys on var;
    the reference stores (coeff, var) tuples sorted by var — same order.
    """

    __slots__ = ("field", "terms")

    def __init__(self, field: Fp, terms: list[tuple[int, int]] | None = None):
        self.field = field
        self.terms = terms if terms is not None else []  # [(var, coeff)]

    # --- constructors (lc! / lc_diff! macro equivalents, :20-38) --------
    @classmethod
    def zero(cls, field: Fp) -> "LinearCombination":
        return cls(field)

    @classmethod
    def sum_vars(cls, field: Fp, variables) -> "LinearCombination":
        lc = cls(field, [(v, 1) for v in variables])
        lc.compactify()
        return lc

    @classmethod
    def from_terms(cls, field: Fp, coeff_vars) -> "LinearCombination":
        """From (coeff, var) pairs — the lc![(c, v), ...] form."""
        lc = cls(field, [(v, c % field.p) for (c, v) in coeff_vars])
        lc.compactify()
        return lc

    @classmethod
    def diff_vars(cls, field: Fp, a: int, b: int) -> "LinearCombination":
        if a == b:
            return cls(field)
        lc = cls(field, [(a, 1), (b, field.p - 1)])
        lc.terms.sort()
        return lc

    # --- core ------------------------------------------------------------
    def compactify(self) -> None:
        """Sort by variable and merge duplicate variables (ref :53-82)."""
        t = self.terms
        if len(t) <= 1:
            return
        t.sort(key=lambda e: e[0])
        out = []
        add = self.field.add
        cur_v, cur_c = t[0]
        for v, c in t[1:]:
            if v == cur_v:
                cur_c = add(cur_c, c)
            else:
                out.append((cur_v, cur_c))
                cur_v, cur_c = v, c
        out.append((cur_v, cur_c))
        self.terms = out

    def __len__(self):
        return len(self.terms)

    def __iter__(self):
        """Yields (coeff, var) pairs, matching the reference tuple order."""
        return ((c, v) for (v, c) in self.terms)

    def is_empty(self) -> bool:
        return not self.terms

    def copy(self) -> "LinearCombination":
        return LinearCombination(self.field, list(self.terms))

    def negate_in_place(self) -> None:
        p = self.field.p
        self.terms = [(v, p - c if c else 0) for (v, c) in self.terms]

    # --- term insertion (AddAssign<(F, Variable)>, ref :203-211) ---------
    def add_term(self, coeff: int, var: int) -> "LinearCombination":
        coeff = coeff % self.field.p
        t = self.terms
        i = bisect_left(t, var, key=lambda e: e[0]) if len(t) >= 6 else None
        if i is None:
            i = 0
            while i < len(t) and t[i][0] < var:
                i += 1
        if i < len(t) and t[i][0] == var:
            t[i] = (var, self.field.add(t[i][1], coeff))
        else:
            t.insert(i, (var, coeff))
        return self

    # --- operator algebra -------------------------------------------------
    def _merge(self, other: "LinearCombination", push_fn, combine_fn):
        """Sorted merge of two LCs (ref op_impl :296-336)."""
        a, b = self.terms, other.terms
        out = []
        i = j = 0
        while i < len(a) and j < len(b):
            va, ca = a[i]
            vb, cb = b[j]
            if va < vb:
                out.append((va, ca))
                i += 1
            elif va > vb:
                out.append((vb, push_fn(cb)))
                j += 1
            else:
                out.append((va, combine_fn(ca, cb)))
                i += 1
                j += 1
        out.extend(a[i:])
        for v, c in b[j:]:
            out.append((v, push_fn(c)))
        return LinearCombination(self.field, out)

    def _coerce(self, other) -> "LinearCombination":
        f = self.field
        if isinstance(other, LinearCombination):
            return other
        if isinstance(other, int):  # a Variable handle
            if other == 0:
                return LinearCombination(f)
            return LinearCombination(f, [(other, 1)])
        if isinstance(other, tuple):  # (coeff, var)
            c, v = other
            c = int(c) % f.p
            if c == 0 or v == 0:
                return LinearCombination(f)
            return LinearCombination(f, [(v, c)])
        raise TypeError(f"cannot coerce {other!r} to LinearCombination")

    def __add__(self, other):
        o = self._coerce(other)
        if o.is_empty():
            return self.copy()
        if self.is_empty():
            return o.copy()
        return self._merge(o, lambda c: c, self.field.add)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o.is_empty():
            return self.copy()
        if self.is_empty():
            r = o.copy()
            r.negate_in_place()
            return r
        return self._merge(o, self.field.neg, self.field.sub)

    def __neg__(self):
        r = self.copy()
        r.negate_in_place()
        return r

    def __mul__(self, scalar: int):
        s = int(scalar) % self.field.p
        mul = self.field.mul
        return LinearCombination(self.field, [(v, mul(c, s)) for (v, c) in self.terms])

    __rmul__ = __mul__

    def add_scaled(self, mul_coeff: int, other: "LinearCombination"):
        """self + mul_coeff * other (the (F, LC) scaled-add form, ref :491-568)."""
        mul_coeff = int(mul_coeff) % self.field.p
        f = self.field
        if other.is_empty():
            return self.copy()
        if self.is_empty():
            return other * mul_coeff
        return self._merge(
            other,
            lambda c: f.mul(mul_coeff, c),
            lambda a, b: f.add(a, f.mul(mul_coeff, b)),
        )

    def __eq__(self, other):
        return (
            isinstance(other, LinearCombination)
            and self.terms == other.terms
        )

    def __repr__(self):
        from . import variable as V

        return " + ".join(f"{c}*{V.describe(v)}" for (v, c) in self.terms) or "0"
