"""Host-side elliptic curve arithmetic (the oracle mirror of ops/curve.py).

Pure-Python affine short-Weierstrass y^2 = x^3 + b over an abstract field,
instantiated for G1 (Fq ints) and G2 (Fq2 tuples). Used for test oracles,
generator tables at setup time, and the pairing's point manipulation.
Points: (x, y) tuples or None for the identity.
"""

from __future__ import annotations

from ..fields.host import Fp
from ..fields.params import CurveParams
from ..fields.towers import Fq2


class _HostFieldInt:
    """Adapter: Fp descriptor -> generic field-ops interface."""

    def __init__(self, f: Fp):
        self.f = f
        self.zero = 0
        self.one = 1

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def mul(self, a, b):
        return self.f.mul(a, b)

    def square(self, a):
        return self.f.square(a)

    def neg(self, a):
        return self.f.neg(a)

    def inv(self, a):
        return self.f.inv(a)

    def is_zero(self, a):
        return a == 0

    def eq(self, a, b):
        return a == b


class _HostFieldFq2:
    def __init__(self, fq2: Fq2):
        self.f = fq2
        self.zero = fq2.zero
        self.one = fq2.one

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def mul(self, a, b):
        return self.f.mul(a, b)

    def square(self, a):
        return self.f.square(a)

    def neg(self, a):
        return self.f.neg(a)

    def inv(self, a):
        return self.f.inv(a)

    def is_zero(self, a):
        return self.f.is_zero(a)

    def eq(self, a, b):
        return a == b


class HostCurve:
    """Affine group law over one short-Weierstrass curve y^2 = x^3 + b."""

    def __init__(self, F, b, generator):
        self.F = F
        self.b = b
        self.generator = generator

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        F = self.F
        return F.eq(F.square(y), F.add(F.mul(F.square(x), x), self.b))

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.F.neg(pt[1]))

    def add(self, p, q):
        F = self.F
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if F.eq(x1, x2):
            if F.eq(y1, F.neg(y2)):
                return None
            return self.double(p)
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.square(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p):
        if p is None:
            return None
        F = self.F
        x, y = p
        if F.is_zero(y):
            return None
        three_x2 = F.add(F.add(F.square(x), F.square(x)), F.square(x))
        lam = F.mul(three_x2, F.inv(F.add(y, y)))
        x3 = F.sub(F.square(lam), F.add(x, x))
        y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
        return (x3, y3)

    def scalar_mul(self, pt, k: int):
        if k < 0:
            return self.scalar_mul(self.neg(pt), -k)
        r = None
        q = pt
        while k:
            if k & 1:
                r = self.add(r, q)
            q = self.double(q)
            k >>= 1
        return r

    def msm(self, points, scalars):
        """Naive host MSM oracle."""
        acc = None
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.scalar_mul(p, s))
        return acc


def host_g1(curve: CurveParams) -> HostCurve:
    f = _HostFieldInt(Fp(curve.fq))
    return HostCurve(f, curve.b % curve.fq.modulus, curve.g1_generator)


def host_g2(curve: CurveParams) -> HostCurve:
    fq2 = Fq2(curve.fq.modulus)
    f = _HostFieldFq2(fq2)
    return HostCurve(f, curve.b2, curve.g2_generator)
