"""Host prime-field arithmetic on canonical Python ints in ``[0, p)``.

The port's own copy of the JAX package's `fields/host.py`: the field
descriptor `Fp` (scalar ops, and the batch codecs to and from the JAX
package's device limb arrays, (N, L) uint32 of little-endian base-2^16
limbs, plain or Montgomery at R = 2^(16·L), which are its public format)
and `FpElem`, operator sugar for circuit code. The port's own device
format (`fields/limbs.py`) is 32-bit words; these arrays are for interop.
"""

from __future__ import annotations

import numpy as np

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

    def from_int(self, x: int) -> int:
        return x % self.p

    def elem(self, x: int) -> "FpElem":
        return FpElem(self, x % self.p)

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

    # --- batch limb codecs (the JAX package's device layout) ------------
    def to_limbs_array(self, xs) -> np.ndarray:
        """[int] -> (N, L) uint32 little-endian base-2^16 limb array."""
        L = self.params.num_limbs
        nbytes = 2 * L
        buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
        return np.frombuffer(buf, dtype="<u2").reshape(len(xs), L).astype(np.uint32)

    def from_limbs_array(self, arr) -> list[int]:
        """(..., L) limb array -> flat list of ints (the low 16 bits of
        each limb lane)."""
        L = self.params.num_limbs
        raw = np.asarray(arr, dtype=np.uint64).reshape(-1, L).astype("<u2").tobytes()
        nbytes = 2 * L
        return [int.from_bytes(raw[i : i + nbytes], "little") for i in range(0, len(raw), nbytes)]

    def to_mont_limbs_array(self, xs) -> np.ndarray:
        """[int] -> (N, L) Montgomery-form limb array."""
        r, p = self.params.r, self.p
        return self.to_limbs_array([x * r % p for x in xs])

    def from_mont_limbs_array(self, arr) -> list[int]:
        rinv = pow(self.params.r, -1, self.p)
        return [x * rinv % self.p for x in self.from_limbs_array(arr)]

    def __repr__(self):
        return f"Fp({self.params.name})"


class FpElem:
    """Operator sugar over (field, int) for circuit-authoring code."""

    __slots__ = ("f", "v")

    def __init__(self, f: Fp, v: int):
        self.f, self.v = f, v

    def _coerce(self, o) -> int:
        if isinstance(o, FpElem):
            return o.v
        return int(o) % self.f.p

    def __add__(self, o):
        return FpElem(self.f, self.f.add(self.v, self._coerce(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return FpElem(self.f, self.f.sub(self.v, self._coerce(o)))

    def __rsub__(self, o):
        return FpElem(self.f, self.f.sub(self._coerce(o), self.v))

    def __mul__(self, o):
        return FpElem(self.f, self.f.mul(self.v, self._coerce(o)))

    __rmul__ = __mul__

    def __neg__(self):
        return FpElem(self.f, self.f.neg(self.v))

    def __truediv__(self, o):
        return FpElem(self.f, self.f.mul(self.v, self.f.inv(self._coerce(o))))

    def __pow__(self, e: int):
        return FpElem(self.f, self.f.pow(self.v, e))

    def inverse(self):
        return FpElem(self.f, self.f.inv(self.v))

    def __eq__(self, o):
        return self.v == self._coerce(o)

    def __hash__(self):
        return hash(self.v)

    def __int__(self):
        return self.v

    def __repr__(self):
        return f"FpElem({self.v})"

