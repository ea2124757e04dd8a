"""Host prime-field arithmetic on canonical Python ints in ``[0, p)``.

The port's own copy of the scalar part of the JAX package's
`fields/host.py`, for the host curve, the pairing and the point codecs.
"""

from __future__ import annotations

from .params import FieldParams


class Fp:
    """A prime-field descriptor: ops over canonical int representatives."""

    __slots__ = ("params", "p", "one", "zero", "minus_one")

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = params.modulus
        self.zero = 0
        self.one = 1
        self.minus_one = self.p - 1

    # --- scalar ops ----------------------------------------------------
    def add(self, a: int, b: int) -> int:
        c = a + b
        return c - self.p if c >= self.p else c

    def sub(self, a: int, b: int) -> int:
        c = a - b
        return c + self.p if c < 0 else c

    def neg(self, a: int) -> int:
        return self.p - a if a else 0

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def square(self, a: int) -> int:
        return a * a % self.p

    def double(self, a: int) -> int:
        c = a << 1
        return c - self.p if c >= self.p else c

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("inverse of zero in prime field")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e % (self.p - 1) if e < 0 else e, self.p)

    def rand(self, rng) -> int:
        """Uniform field element by rejection sampling on num_bits: the same
        draws from the same `random.Random` as the JAX package's."""
        nbits = self.params.num_bits
        while True:
            x = int(rng.getrandbits(nbits))
            if x < self.p:
                return x

    def legendre(self, a: int) -> int:
        """1 if QR, -1 if QNR, 0 if zero."""
        if a == 0:
            return 0
        r = pow(a, (self.p - 1) >> 1, self.p)
        return 1 if r == 1 else -1

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks; returns a root or None if QNR."""
        p = self.p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) >> 2, p)
        # Tonelli-Shanks for p = 1 mod 4
        s = self.params.two_adicity
        q = (p - 1) >> s
        z = pow(self.params.generator, q, p)  # generator of the 2-Sylow subgroup
        m, c, t, r = s, z, pow(a, q, p), pow(a, (q + 1) >> 1, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def __repr__(self):
        return f"Fp({self.params.name})"

