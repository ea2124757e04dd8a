"""Host-side extension-field towers Fq2 / Fq6 / Fq12 for pairing computation.

Tower shape (both BN254 and BLS12-381, matching arkworks' `ark-ec` tower):
    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi)         (xi = 9+u for BN254, 1+u for BLS12-381)
    Fq12 = Fq6[w] / (w^2 - v)

Elements are nested tuples of ints: Fq2 = (c0, c1), Fq6 = (Fq2, Fq2, Fq2),
Fq12 = (Fq6, Fq6). Pure-Python: the pairing is O(1) work per verification and
runs on the host. It mirrors arkworks' `ark-ff` tower fields.
"""

from __future__ import annotations

from .params import CurveParams


class Fq2:
    __slots__ = ("p", "zero", "one")

    def __init__(self, p: int):
        self.p = p
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def neg(self, a):
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p)

    def mul(self, a, b):
        # (a0 + a1 u)(b0 + b1 u) with u^2 = -1 (Karatsuba)
        p = self.p
        t0 = a[0] * b[0] % p
        t1 = a[1] * b[1] % p
        t2 = (a[0] + a[1]) * (b[0] + b[1]) % p
        return ((t0 - t1) % p, (t2 - t0 - t1) % p)

    def square(self, a):
        p = self.p
        t0 = (a[0] + a[1]) * (a[0] - a[1]) % p  # a0^2 - a1^2
        t1 = 2 * a[0] * a[1] % p
        return (t0, t1)

    def mul_scalar(self, a, k: int):
        p = self.p
        return (a[0] * k % p, a[1] * k % p)

    def conj(self, a):
        return (a[0], (-a[1]) % self.p)

    def inv(self, a):
        p = self.p
        norm = (a[0] * a[0] + a[1] * a[1]) % p
        ninv = pow(norm, -1, p)
        return (a[0] * ninv % p, (-a[1]) * ninv % p)

    def pow(self, a, e: int):
        r = self.one
        b = a
        while e:
            if e & 1:
                r = self.mul(r, b)
            b = self.square(b)
            e >>= 1
        return r

    def is_zero(self, a):
        return a[0] == 0 and a[1] == 0

    def frobenius(self, a):
        """a^p = conj(a) since u^p = -u (p = 3 mod 4)."""
        return self.conj(a)


class Fq6:
    """Fq6 = Fq2[v]/(v^3 - xi)."""

    __slots__ = ("fq2", "xi", "zero", "one", "frob_c1", "frob_c2")

    def __init__(self, fq2: Fq2, xi):
        self.fq2 = fq2
        self.xi = xi
        self.zero = (fq2.zero, fq2.zero, fq2.zero)
        self.one = (fq2.one, fq2.zero, fq2.zero)
        # Frobenius coefficients: v^(p^k) = frob_c1[k] * v; (v^2)^(p^k) = frob_c2[k] v^2
        p = fq2.p
        self.frob_c1 = [fq2.pow(xi, (p**k - 1) // 3) for k in range(6)]
        self.frob_c2 = [fq2.pow(xi, (2 * (p**k - 1)) // 3) for k in range(6)]

    def mul_by_xi(self, a):
        return self.fq2.mul(a, self.xi)

    def add(self, a, b):
        f = self.fq2
        return (f.add(a[0], b[0]), f.add(a[1], b[1]), f.add(a[2], b[2]))

    def sub(self, a, b):
        f = self.fq2
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]), f.sub(a[2], b[2]))

    def neg(self, a):
        f = self.fq2
        return (f.neg(a[0]), f.neg(a[1]), f.neg(a[2]))

    def mul(self, a, b):
        # Toom/Karatsuba-style (CH-SQR3 variant), v^3 = xi
        f = self.fq2
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        t2 = f.mul(a2, b2)
        c0 = f.add(t0, self.mul_by_xi(f.sub(f.mul(f.add(a1, a2), f.add(b1, b2)), f.add(t1, t2))))
        c1 = f.add(f.sub(f.mul(f.add(a0, a1), f.add(b0, b1)), f.add(t0, t1)), self.mul_by_xi(t2))
        c2 = f.add(f.sub(f.mul(f.add(a0, a2), f.add(b0, b2)), f.add(t0, t2)), t1)
        return (c0, c1, c2)

    def square(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
        return (self.mul_by_xi(a[2]), a[0], a[1])

    def mul_scalar_fq2(self, a, k):
        f = self.fq2
        return (f.mul(a[0], k), f.mul(a[1], k), f.mul(a[2], k))

    def inv(self, a):
        f = self.fq2
        a0, a1, a2 = a
        t0 = f.sub(f.square(a0), self.mul_by_xi(f.mul(a1, a2)))
        t1 = f.sub(self.mul_by_xi(f.square(a2)), f.mul(a0, a1))
        t2 = f.sub(f.square(a1), f.mul(a0, a2))
        norm = f.add(f.mul(a0, t0), self.mul_by_xi(f.add(f.mul(a2, t1), f.mul(a1, t2))))
        ninv = f.inv(norm)
        return (f.mul(t0, ninv), f.mul(t1, ninv), f.mul(t2, ninv))

    def frobenius(self, a, power: int = 1):
        f = self.fq2
        k = power % 6
        c0 = a[0]
        c1, c2 = a[1], a[2]
        for _ in range(k):
            c0 = f.frobenius(c0)
            c1 = f.frobenius(c1)
            c2 = f.frobenius(c2)
        return (c0, f.mul(c1, self.frob_c1[k]), f.mul(c2, self.frob_c2[k]))

    def is_zero(self, a):
        return all(self.fq2.is_zero(c) for c in a)


class Fq12:
    """Fq12 = Fq6[w]/(w^2 - v)."""

    __slots__ = ("fq6", "fq2", "zero", "one", "frob_c1")

    def __init__(self, fq6: Fq6):
        self.fq6 = fq6
        self.fq2 = fq6.fq2
        self.zero = (fq6.zero, fq6.zero)
        self.one = (fq6.one, fq6.zero)
        # w^(p^k) = frob_c1[k] * w  with frob_c1[k] = xi^((p^k - 1)/6) in Fq2
        p = self.fq2.p
        self.frob_c1 = [self.fq2.pow(fq6.xi, (p**k - 1) // 6) for k in range(12)]

    def add(self, a, b):
        s = self.fq6
        return (s.add(a[0], b[0]), s.add(a[1], b[1]))

    def sub(self, a, b):
        s = self.fq6
        return (s.sub(a[0], b[0]), s.sub(a[1], b[1]))

    def neg(self, a):
        s = self.fq6
        return (s.neg(a[0]), s.neg(a[1]))

    def mul(self, a, b):
        s = self.fq6
        t0 = s.mul(a[0], b[0])
        t1 = s.mul(a[1], b[1])
        c0 = s.add(t0, s.mul_by_v(t1))
        c1 = s.sub(s.mul(s.add(a[0], a[1]), s.add(b[0], b[1])), s.add(t0, t1))
        return (c0, c1)

    def square(self, a):
        # Complex squaring: c0 = (a0+a1)(a0+v*a1) - a0a1 - v*a0a1; c1 = 2a0a1
        s = self.fq6
        t = s.mul(a[0], a[1])
        c0 = s.sub(
            s.mul(s.add(a[0], a[1]), s.add(a[0], s.mul_by_v(a[1]))),
            s.add(t, s.mul_by_v(t)),
        )
        c1 = s.add(t, t)
        return (c0, c1)

    def inv(self, a):
        s = self.fq6
        norm = s.sub(s.square(a[0]), s.mul_by_v(s.square(a[1])))
        ninv = s.inv(norm)
        return (s.mul(a[0], ninv), s.neg(s.mul(a[1], ninv)))

    def conj(self, a):
        """Conjugation a0 - a1 w = a^(p^6); inverse for cyclotomic elements."""
        return (a[0], self.fq6.neg(a[1]))

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        r = self.one
        b = a
        while e:
            if e & 1:
                r = self.mul(r, b)
            b = self.square(b)
            e >>= 1
        return r

    def frobenius(self, a, power: int = 1):
        k = power % 12
        s = self.fq6
        c0 = s.frobenius(a[0], k)
        c1 = s.frobenius(a[1], k)
        # scale c1's Fq2 coefficients by frob_c1[k]
        c1 = s.mul_scalar_fq2(c1, self.frob_c1[k])
        return (c0, c1)

    def is_one(self, a):
        return a[0] == self.fq6.one and self.fq6.is_zero(a[1])


def make_tower(curve: CurveParams):
    fq2 = Fq2(curve.fq.modulus)
    fq6 = Fq6(fq2, curve.xi)
    fq12 = Fq12(fq6)
    return fq2, fq6, fq12


# ---------------------------------------------------------------------------
# sparse / cyclotomic extensions (production pairing support)
# ---------------------------------------------------------------------------


def _fq6_mul_by_01(s: Fq6, a, c0, c1):
    """a · (c0 + c1 v) with c0, c1 in Fq2 (5 Fq2 muls)."""
    f = s.fq2
    a0, a1, a2 = a
    t0 = f.mul(a0, c0)
    t1 = f.mul(a1, c1)
    out0 = f.add(t0, s.mul_by_xi(f.sub(f.mul(f.add(a1, a2), c1), t1)))
    out1 = f.sub(f.mul(f.add(a0, a1), f.add(c0, c1)), f.add(t0, t1))
    out2 = f.add(f.sub(f.mul(f.add(a0, a2), c0), t0), t1)
    return (out0, out1, out2)


def _fq6_mul_by_1(s: Fq6, a, c1):
    """a · (c1 v)."""
    f = s.fq2
    a0, a1, a2 = a
    return (s.mul_by_xi(f.mul(a2, c1)), f.mul(a0, c1), f.mul(a1, c1))


def fq12_mul_by_034(F: Fq12, f, c0, c3, c4):
    """f · (c0 + c3 w + c4 v w) — the D-twist line shape (arkworks
    mul_by_034). c0, c3, c4 in Fq2."""
    s = F.fq6
    f2 = F.fq2
    f0, f1 = f
    t0 = s.mul_scalar_fq2(f0, c0)
    t1 = _fq6_mul_by_01(s, f1, c3, c4)
    o1 = _fq6_mul_by_01(s, s.add(f0, f1), f2.add(c0, c3), c4)
    return (s.add(t0, s.mul_by_v(t1)), s.sub(o1, s.add(t0, t1)))


def fq12_mul_by_014(F: Fq12, f, c0, c1, c4):
    """f · ((c0 + c1 v) + c4 v w) — the M-twist line shape (arkworks
    mul_by_014). c0, c1, c4 in Fq2."""
    s = F.fq6
    f2 = F.fq2
    f0, f1 = f
    t0 = _fq6_mul_by_01(s, f0, c0, c1)
    t1 = _fq6_mul_by_1(s, f1, c4)
    o1 = _fq6_mul_by_01(s, s.add(f0, f1), c0, f2.add(c1, c4))
    return (s.add(t0, s.mul_by_v(t1)), s.sub(o1, s.add(t0, t1)))


def _fp4_square(f2: Fq2, xi, a, b):
    """(a + b y)² in Fq4 = Fq2[y]/(y² - ξ) -> (c0, c1)."""
    t0 = f2.square(a)
    t1 = f2.square(b)
    c0 = f2.add(f2.mul(t1, xi), t0)
    c1 = f2.sub(f2.sub(f2.square(f2.add(a, b)), t0), t1)
    return c0, c1


def fq12_cyclotomic_square(F: Fq12, f):
    """Granger–Scott squaring, valid for f in the cyclotomic subgroup
    (f^(p^6+1)·... = 1 after the easy part of the final exponentiation).
    ~3 Fq4 squarings instead of a full Fq12 square."""
    f2 = F.fq2
    xi = F.fq6.xi
    (z0, z4, z3), (z2, z1, z5) = f
    t0, t1 = _fp4_square(f2, xi, z0, z1)
    z0 = f2.sub(t0, z0)
    z0 = f2.add(f2.add(z0, z0), t0)
    z1 = f2.add(t1, z1)
    z1 = f2.add(f2.add(z1, z1), t1)
    t0, t1 = _fp4_square(f2, xi, z2, z3)
    t2, t3 = _fp4_square(f2, xi, z4, z5)
    z4 = f2.sub(t0, z4)
    z4 = f2.add(f2.add(z4, z4), t0)
    z5 = f2.add(t1, z5)
    z5 = f2.add(f2.add(z5, z5), t1)
    t0 = f2.mul(t3, xi)
    z2 = f2.add(t0, z2)
    z2 = f2.add(f2.add(z2, z2), t0)
    z3 = f2.sub(t2, z3)
    z3 = f2.add(f2.add(z3, z3), t2)
    return ((z0, z4, z3), (z2, z1, z5))
