"""Pairings for BN254 (optimal ate) and BLS12-381 (ate), host-side.

The port's own copy of the JAX package's host pairing, in place of ark-ec's
pairing engines. Verification is O(1) pairings per proof, so it stays
host-side Python; the prover never pairs.

Design: instead of twist-specialized sparse line arithmetic, G2 points are
*untwisted* into E(Fq12) and a generic affine Miller loop runs over Fq12.
This is slower than a production pairing but transparently correct, and the
pairing value is identical no matter the addition chain — bit-exactness is
preserved. The untwist embeddings (X, Y) -> (x·w^±2, y·w^±3) follow from
solving c_y^2 = c_x^3 = b/b' in Fq12 (D-type: BN254, b' = b/xi; M-type:
BLS12-381, b' = b·xi).

Final exponentiation: easy part ((p^6-1)(p^2+1)) via conjugation/Frobenius,
hard part (p^4 - p^2 + 1)/r by plain square-and-multiply — same value as
the curve-specific chains arkworks uses.
"""

from __future__ import annotations

import functools

from ..fields.params import CurveParams
from ..fields.towers import (
    fq12_cyclotomic_square,
    fq12_mul_by_014,
    fq12_mul_by_034,
    make_tower,
)


class _Fq12Field:
    """Adapter: Fq12 tower -> the generic field-ops interface of HostCurve."""

    def __init__(self, fq12):
        self.f = fq12
        self.zero = fq12.zero
        self.one = fq12.one

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
        return a == self.f.zero

    def eq(self, a, b):
        return a == b


class Pairing:
    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.fq2, self.fq6, self.fq12 = make_tower(curve)
        self.p = curve.fq.modulus
        self.r = curve.fr.modulus
        self.F = _Fq12Field(self.fq12)
        self.is_bn = curve.name == "bn254"
        if self.is_bn:
            self.loop_count = 6 * curve.x + 2
        else:
            self.loop_count = abs(curve.x)
        # untwist constants: D-type (BN254) uses w^2, w^3; M-type (BLS12-381)
        # uses w^-2, w^-3.
        w = (self.fq6.zero, self.fq6.one)  # the Fq12 generator w
        w2 = self.fq12.square(w)
        w3 = self.fq12.mul(w2, w)
        if self.is_bn:
            self.cx, self.cy = w2, w3
        else:
            self.cx, self.cy = self.fq12.inv(w2), self.fq12.inv(w3)

        # ----- production-path constants --------------------------------
        p = self.p
        f2 = self.fq2
        # b' of the twist curve y^2 = x^3 + b2 (the G2 curve constants)
        self.twist_b = tuple(v % p for v in curve.b2)
        self.half = pow(2, -1, p)
        # twist Frobenius: pi(x, y) = (conj(x)·FX, conj(y)·FY) on the twist
        self.frob_tx = f2.pow(curve.xi, (p - 1) // 3)
        self.frob_ty = f2.pow(curve.xi, (p - 1) // 2)
        # hard-part exponent (p^4 - p^2 + 1)/r in base-p digits for the
        # 4-way Shamir exponentiation (derived numerically — bit-exact by
        # construction, no hand-copied addition chain to trust)
        e = (p**4 - p**2 + 1) // self.r
        digs = []
        for _ in range(4):
            digs.append(e % p)
            e //= p
        assert e == 0
        self.hard_digits = digs
        self.hard_bits = max(d.bit_length() for d in digs)

    # ----- embeddings ---------------------------------------------------
    def embed_fq(self, a: int):
        """Fq -> Fq12 (constant coefficient)."""
        z2 = (a % self.p, 0)
        c0 = (z2, self.fq2.zero, self.fq2.zero)
        return (c0, self.fq6.zero)

    def embed_fq2(self, a):
        c0 = (a, self.fq2.zero, self.fq2.zero)
        return (c0, self.fq6.zero)

    def embed_g1(self, pt):
        """Affine G1 (ints) -> E(Fq12) affine."""
        if pt is None:
            return None
        return (self.embed_fq(pt[0]), self.embed_fq(pt[1]))

    def untwist_g2(self, pt):
        """Affine G2 on the twist (Fq2 coords) -> E(Fq12) affine."""
        if pt is None:
            return None
        x = self.fq12.mul(self.embed_fq2(pt[0]), self.cx)
        y = self.fq12.mul(self.embed_fq2(pt[1]), self.cy)
        return (x, y)

    def frobenius_point(self, pt):
        """π(X, Y) = (X^p, Y^p) on E(Fq12)."""
        if pt is None:
            return None
        return (self.fq12.frobenius(pt[0], 1), self.fq12.frobenius(pt[1], 1))

    # ----- Miller loop ---------------------------------------------------
    def _line(self, T, Q, P):
        """Evaluate at P the line through T and Q (tangent if T == Q).

        Returns (line_value, T + Q). All points affine in E(Fq12).
        """
        f = self.fq12
        xT, yT = T
        xP, yP = P
        if T == Q:
            # tangent: lam = 3 xT^2 / (2 yT)
            x2 = f.square(xT)
            num = f.add(f.add(x2, x2), x2)
            den = f.add(yT, yT)
        else:
            xQ, yQ = Q
            if xT == xQ:
                # vertical line: x - xT
                return f.sub(xP, xT), None
            num = f.sub(Q[1], yT)
            den = f.sub(Q[0], xT)
        lam = f.mul(num, f.inv(den))
        # l(P) = yP - yT - lam (xP - xT)
        val = f.sub(f.sub(yP, yT), f.mul(lam, f.sub(xP, xT)))
        # sum point
        if T == Q:
            xR = f.sub(f.square(lam), f.add(xT, xT))
        else:
            xR = f.sub(f.sub(f.square(lam), xT), Q[0])
        yR = f.sub(f.mul(lam, f.sub(xT, xR)), yT)
        return val, (xR, yR)

    # ----- production Miller loop (twist coordinates, sparse lines) ------
    def _dbl_step(self, T):
        """Projective doubling on the twist + line coefficients
        (Costello–Lange–Naehrig homogeneous formulas, the shape arkworks'
        bn/bls12 g2 doubling_step uses). T = (X, Y, Z) over Fq2."""
        f2 = self.fq2
        x, y, z = T
        a = f2.mul_scalar(f2.mul(x, y), self.half)
        b = f2.square(y)
        c = f2.square(z)
        c3 = f2.add(f2.add(c, c), c)
        e = f2.mul(self.twist_b, c3)
        f_ = f2.add(f2.add(e, e), e)
        g = f2.mul_scalar(f2.add(b, f_), self.half)
        h = f2.sub(f2.square(f2.add(y, z)), f2.add(b, c))
        i = f2.sub(e, b)
        j = f2.square(x)
        e2 = f2.square(e)
        X3 = f2.mul(a, f2.sub(b, f_))
        Y3 = f2.sub(f2.square(g), f2.add(f2.add(e2, e2), e2))
        Z3 = f2.mul(b, h)
        j3 = f2.add(f2.add(j, j), j)
        if self.is_bn:  # D-twist line (positions 0, 3, 4)
            coeffs = (f2.neg(h), j3, i)
        else:  # M-twist line (positions 0, 1, 4)
            coeffs = (i, j3, f2.neg(h))
        return (X3, Y3, Z3), coeffs

    def _add_step(self, T, Q):
        """Mixed addition T += Q (Q affine on the twist) + line coeffs."""
        f2 = self.fq2
        x, y, z = T
        xq, yq = Q
        theta = f2.sub(y, f2.mul(yq, z))
        lam = f2.sub(x, f2.mul(xq, z))
        c = f2.square(theta)
        d = f2.square(lam)
        e = f2.mul(lam, d)
        f_ = f2.mul(z, c)
        g = f2.mul(x, d)
        h = f2.sub(f2.add(e, f_), f2.add(g, g))
        X3 = f2.mul(lam, h)
        Y3 = f2.sub(f2.mul(theta, f2.sub(g, h)), f2.mul(e, y))
        Z3 = f2.mul(z, e)
        j = f2.sub(f2.mul(theta, xq), f2.mul(lam, yq))
        if self.is_bn:
            coeffs = (lam, f2.neg(theta), j)
        else:
            coeffs = (j, f2.neg(theta), lam)
        return (X3, Y3, Z3), coeffs

    def _ell(self, f, coeffs, p_g1):
        """Multiply f by the line evaluated at P (sparse mul)."""
        f2 = self.fq2
        xp, yp = p_g1
        c0, c1, c2 = coeffs
        if self.is_bn:
            return fq12_mul_by_034(
                self.fq12, f,
                f2.mul_scalar(c0, yp), f2.mul_scalar(c1, xp), c2,
            )
        return fq12_mul_by_014(
            self.fq12, f,
            c0, f2.mul_scalar(c1, xp), f2.mul_scalar(c2, yp),
        )

    def _frob_twist(self, q):
        """pi(x, y) on the twist: (conj(x)·FX, conj(y)·FY)."""
        f2 = self.fq2
        return (
            f2.mul(f2.conj(q[0]), self.frob_tx),
            f2.mul(f2.conj(q[1]), self.frob_ty),
        )

    def miller_loop(self, p_g1, q_g2):
        """f_{loop,Q}(P), production path: the G2 chain stays in Fq2 twist
        coordinates (projective, inversion-free) and every line is a
        sparse Fq12 multiplication. Bit-exact vs the generic untwisted
        loop (tested: same pairing output)."""
        if p_g1 is None or q_g2 is None:
            return self.fq12.one
        f12 = self.fq12
        f2 = self.fq2
        T = (q_g2[0], q_g2[1], f2.one)
        f = f12.one
        for bit in bin(self.loop_count)[3:]:
            f = f12.square(f)
            T, coeffs = self._dbl_step(T)
            f = self._ell(f, coeffs, p_g1)
            if bit == "1":
                T, coeffs = self._add_step(T, q_g2)
                f = self._ell(f, coeffs, p_g1)
        if self.is_bn:
            # optimal ate extra lines: Q1 = pi(Q), Q2 = -pi^2(Q)
            q1 = self._frob_twist(q_g2)
            q2 = self._frob_twist(q1)
            q2 = (q2[0], f2.neg(q2[1]))
            T, coeffs = self._add_step(T, q1)
            f = self._ell(f, coeffs, p_g1)
            T, coeffs = self._add_step(T, q2)
            f = self._ell(f, coeffs, p_g1)
        elif self.curve.x < 0:
            f = f12.conj(f)
        return f

    def miller_loop_generic(self, p_g1, q_g2):
        """Reference implementation: untwisted affine loop over E(Fq12) —
        transparently correct, used as the production path's oracle."""
        if p_g1 is None or q_g2 is None:
            return self.fq12.one
        f12 = self.fq12
        P = self.embed_g1(p_g1)
        Q = self.untwist_g2(q_g2)
        f = f12.one
        T = Q
        bits = bin(self.loop_count)[3:]  # skip leading 1
        for bit in bits:
            val, T = self._line(T, T, P)
            f = f12.mul(f12.square(f), val)
            if T is None:
                T = None  # cannot happen mid-loop for prime-order inputs
            if bit == "1":
                val, T = self._line(T, Q, P)
                f = f12.mul(f, val)
        if self.is_bn:
            # optimal ate extra lines: Q1 = π(Q), Q2 = -π^2(Q)
            Q1 = self.frobenius_point(Q)
            Q2 = self.frobenius_point(Q1)
            Q2 = (Q2[0], f12.neg(Q2[1]))
            val, T = self._line(T, Q1, P)
            f = f12.mul(f, val)
            val, T = self._line(T, Q2, P)
            f = f12.mul(f, val)
        else:
            if self.curve.x < 0:
                f = f12.conj(f)  # unitary inverse; exact after final exp
        return f

    # ----- final exponentiation ------------------------------------------
    def final_exponentiation(self, f):
        """Easy part via conj/Frobenius, then the hard part
        (p^4 - p^2 + 1)/r as a 4-way Shamir exponentiation over its
        base-p digits: f^e = Π_k (f^(p^k))^(e_k) with the f^(p^k) from
        Frobenius maps, one joint ladder of cyclotomic squarings and a
        15-entry subset-product table. ~3-4x fewer Fq12 ops than generic
        square-and-multiply, with the exponent digits derived numerically
        (no transcribed addition chain)."""
        f12 = self.fq12
        # easy part: f^(p^6 - 1) then ^(p^2 + 1); result is cyclotomic
        f = f12.mul(f12.conj(f), f12.inv(f))
        f = f12.mul(f12.frobenius(f, 2), f)
        # bases g_k = f^(p^k)
        gs = [f]
        for k in range(1, 4):
            gs.append(f12.frobenius(f, k))
        # subset products table[S] = Π_{k in S} g_k
        table = [f12.one] * 16
        for s in range(1, 16):
            low = s & (-s)
            k = low.bit_length() - 1
            table[s] = f12.mul(table[s ^ low], gs[k]) if s ^ low else gs[k]
        acc = f12.one
        digs = self.hard_digits
        for i in range(self.hard_bits - 1, -1, -1):
            acc = fq12_cyclotomic_square(f12, acc)
            s = (
                ((digs[0] >> i) & 1)
                | (((digs[1] >> i) & 1) << 1)
                | (((digs[2] >> i) & 1) << 2)
                | (((digs[3] >> i) & 1) << 3)
            )
            if s:
                acc = f12.mul(acc, table[s])
        return acc

    def final_exponentiation_generic(self, f):
        """Reference path: plain square-and-multiply over the full hard
        exponent (the production path's oracle)."""
        f12 = self.fq12
        p = self.p
        f = f12.mul(f12.conj(f), f12.inv(f))
        f = f12.mul(f12.frobenius(f, 2), f)
        e = (p**4 - p**2 + 1) // self.r
        return f12.pow(f, e)

    def pairing(self, p_g1, q_g2):
        return self.final_exponentiation(self.miller_loop(p_g1, q_g2))

    def pairing_generic(self, p_g1, q_g2):
        return self.final_exponentiation_generic(
            self.miller_loop_generic(p_g1, q_g2)
        )

    def multi_pairing(self, pairs):
        """Π e(P_i, Q_i) with a single shared final exponentiation."""
        f = self.fq12.one
        for p_g1, q_g2 in pairs:
            f = self.fq12.mul(f, self.miller_loop(p_g1, q_g2))
        return self.final_exponentiation(f)


@functools.lru_cache(maxsize=None)
def get_pairing(curve: CurveParams) -> Pairing:
    return Pairing(curve)
