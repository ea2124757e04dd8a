"""Canonical (de)serialization — arkworks `ark-serialize` byte layout.

Mirrors the CanonicalSerialize/CanonicalDeserialize surface the reference
requires of its keys and proofs (arkworks snark/src/lib.rs:25-36):

  * Fp: little-endian bytes of the canonical representative,
    ceil(modulus_bits / 8) bytes (32 for 254/255-bit fields, 48 for BLS Fq).
  * Fq2: c0 ‖ c1.
  * Short-Weierstrass affine points, compressed: the x-coordinate with two
    flag bits OR'd into the top of the final byte — PointAtInfinity = 1<<6,
    YIsNegative = 1<<7 (ark-serialize SWFlags). "Negative" means
    y > -y, i.e. y > (p-1)/2; for Fq2 the comparison is lexicographic on
    (c1, c0) (arkworks QuadExtField ordering).
  * Uncompressed: x ‖ y with the infinity flag on y's final byte.
  * Vec<T>: u64 little-endian length prefix, then the items.

Compressed G2 deserialization needs sqrt in Fq2 (complex method over the
base-field Tonelli-Shanks).
"""

from __future__ import annotations

import struct

from ..fields.host import Fp
from ..fields.params import CurveParams, FieldParams
from ..fields.towers import Fq2

INFINITY_FLAG = 1 << 6
NEGATIVE_FLAG = 1 << 7


# ----- field elements ------------------------------------------------------


def serialize_fp(params: FieldParams, x: int) -> bytes:
    return int(x % params.modulus).to_bytes(params.num_bytes, "little")


def deserialize_fp(params: FieldParams, data: bytes, offset: int = 0):
    nb = params.num_bytes
    v = int.from_bytes(data[offset : offset + nb], "little")
    return v, offset + nb


def serialize_fq2(params: FieldParams, a: tuple[int, int]) -> bytes:
    return serialize_fp(params, a[0]) + serialize_fp(params, a[1])


def deserialize_fq2(params: FieldParams, data: bytes, offset: int = 0):
    c0, offset = deserialize_fp(params, data, offset)
    c1, offset = deserialize_fp(params, data, offset)
    return (c0, c1), offset


def _is_negative_fp(p: int, y: int) -> bool:
    return y > p - y  # y > -y


def _is_negative_fq2(p: int, y: tuple[int, int]) -> bool:
    # lexicographic on (c1, c0): compare the extension coefficient first
    ny = ((p - y[0]) % p, (p - y[1]) % p)
    return (y[1], y[0]) > (ny[1], ny[0])


# ----- G1 ------------------------------------------------------------------


def serialize_g1(curve: CurveParams, pt, compress: bool = True) -> bytes:
    params = curve.fq
    p = params.modulus
    if compress:
        if pt is None:
            raw = bytearray(serialize_fp(params, 0))
            raw[-1] |= INFINITY_FLAG
            return bytes(raw)
        x, y = pt
        raw = bytearray(serialize_fp(params, x))
        if _is_negative_fp(p, y):
            raw[-1] |= NEGATIVE_FLAG
        return bytes(raw)
    if pt is None:
        raw = bytearray(serialize_fp(params, 0) * 2)
        raw[-1] |= INFINITY_FLAG
        return bytes(raw)
    x, y = pt
    return serialize_fp(params, x) + serialize_fp(params, y)


def deserialize_g1(curve: CurveParams, data: bytes, offset: int = 0,
                   compress: bool = True, validate: bool = True):
    params = curve.fq
    f = Fp(params)
    nb = params.num_bytes
    if compress:
        raw = bytearray(data[offset : offset + nb])
        offset += nb
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        x = int.from_bytes(raw, "little")
        if flags & INFINITY_FLAG:
            return None, offset
        rhs = (x * x % f.p * x + curve.b) % f.p
        y = f.sqrt(rhs)
        if y is None:
            raise ValueError("x not on curve")
        if _is_negative_fp(f.p, y) != bool(flags & NEGATIVE_FLAG):
            y = f.p - y
        return (x, y), offset
    raw_x = data[offset : offset + nb]
    raw_y = bytearray(data[offset + nb : offset + 2 * nb])
    offset += 2 * nb
    flags = raw_y[-1] & 0xC0
    raw_y[-1] &= 0x3F
    if flags & INFINITY_FLAG:
        return None, offset
    x = int.from_bytes(raw_x, "little")
    y = int.from_bytes(bytes(raw_y), "little")
    if validate:
        assert y * y % f.p == (x * x % f.p * x + curve.b) % f.p, "not on curve"
    return (x, y), offset


# ----- G2 ------------------------------------------------------------------


def _sqrt_fq2(curve: CurveParams, a: tuple[int, int]):
    """Square root in Fq2 = Fq[u]/(u^2+1) by the complex method."""
    f = Fp(curve.fq)
    p = f.p
    fq2 = Fq2(p)
    a0, a1 = a
    if a1 == 0:
        r = f.sqrt(a0)
        if r is not None:
            return (r, 0)
        r = f.sqrt((-a0) % p)  # sqrt(-a0) * u since u^2 = -1
        if r is None:
            return None
        return (0, r)
    norm = (a0 * a0 + a1 * a1) % p
    alpha = f.sqrt(norm)
    if alpha is None:
        return None
    inv2 = f.inv(2)
    delta = (a0 + alpha) * inv2 % p
    x0 = f.sqrt(delta)
    if x0 is None:
        delta = (a0 - alpha) * inv2 % p
        x0 = f.sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * f.inv(2 * x0 % p) % p
    cand = (x0, x1)
    if fq2.square(cand) != (a0 % p, a1 % p):
        return None
    return cand


def serialize_g2(curve: CurveParams, pt, compress: bool = True) -> bytes:
    params = curve.fq
    p = params.modulus
    if compress:
        if pt is None:
            raw = bytearray(serialize_fq2(params, (0, 0)))
            raw[-1] |= INFINITY_FLAG
            return bytes(raw)
        x, y = pt
        raw = bytearray(serialize_fq2(params, x))
        if _is_negative_fq2(p, y):
            raw[-1] |= NEGATIVE_FLAG
        return bytes(raw)
    if pt is None:
        raw = bytearray(serialize_fq2(params, (0, 0)) * 2)
        raw[-1] |= INFINITY_FLAG
        return bytes(raw)
    x, y = pt
    return serialize_fq2(params, x) + serialize_fq2(params, y)


def deserialize_g2(curve: CurveParams, data: bytes, offset: int = 0,
                   compress: bool = True, validate: bool = True):
    params = curve.fq
    p = params.modulus
    nb = 2 * params.num_bytes
    fq2 = Fq2(p)
    if compress:
        raw = bytearray(data[offset : offset + nb])
        offset += nb
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        if flags & INFINITY_FLAG:
            return None, offset
        c0 = int.from_bytes(raw[: params.num_bytes], "little")
        c1 = int.from_bytes(raw[params.num_bytes :], "little")
        x = (c0, c1)
        rhs = fq2.add(fq2.mul(fq2.square(x), x), curve.b2)
        y = _sqrt_fq2(curve, rhs)
        if y is None:
            raise ValueError("x not on curve (G2)")
        if _is_negative_fq2(p, y) != bool(flags & NEGATIVE_FLAG):
            y = fq2.neg(y)
        return (x, y), offset
    raw = data[offset : offset + 2 * nb]
    offset += 2 * nb
    x, _ = deserialize_fq2(params, raw, 0)
    raw_y = bytearray(raw[nb:])
    flags = raw_y[-1] & 0xC0
    raw_y[-1] &= 0x3F
    if flags & INFINITY_FLAG:
        return None, offset
    y0 = int.from_bytes(raw_y[: params.num_bytes], "little")
    y1 = int.from_bytes(raw_y[params.num_bytes :], "little")
    y = (y0, y1)
    if validate:
        assert fq2.square(y) == fq2.add(fq2.mul(fq2.square(x), x), curve.b2)
    return (x, y), offset


# ----- containers ----------------------------------------------------------


def serialize_vec(items: list[bytes]) -> bytes:
    return struct.pack("<Q", len(items)) + b"".join(items)


def read_len(data: bytes, offset: int) -> tuple[int, int]:
    (n,) = struct.unpack_from("<Q", data, offset)
    return n, offset + 8


# ----- proof / keys --------------------------------------------------------


def serialize_proof(proof, curve: CurveParams, compress: bool = True) -> bytes:
    return (
        serialize_g1(curve, proof.a, compress)
        + serialize_g2(curve, proof.b, compress)
        + serialize_g1(curve, proof.c, compress)
    )


def deserialize_proof(data: bytes, curve: CurveParams, compress: bool = True):
    from ..groth16.groth16 import Proof

    a, off = deserialize_g1(curve, data, 0, compress)
    b, off = deserialize_g2(curve, data, off, compress)
    c, off = deserialize_g1(curve, data, off, compress)
    return Proof(a=a, b=b, c=c)


def serialize_vk(vk, compress: bool = True) -> bytes:
    curve = vk.curve
    out = (
        serialize_g1(curve, vk.alpha_g1, compress)
        + serialize_g2(curve, vk.beta_g2, compress)
        + serialize_g2(curve, vk.gamma_g2, compress)
        + serialize_g2(curve, vk.delta_g2, compress)
        + serialize_vec([serialize_g1(curve, pt, compress) for pt in vk.gamma_abc_g1])
    )
    return out


def deserialize_vk(data: bytes, curve: CurveParams, compress: bool = True):
    from ..groth16.groth16 import VerifyingKey

    alpha_g1, off = deserialize_g1(curve, data, 0, compress)
    beta_g2, off = deserialize_g2(curve, data, off, compress)
    gamma_g2, off = deserialize_g2(curve, data, off, compress)
    delta_g2, off = deserialize_g2(curve, data, off, compress)
    n, off = read_len(data, off)
    gamma_abc = []
    for _ in range(n):
        pt, off = deserialize_g1(curve, data, off, compress)
        gamma_abc.append(pt)
    return VerifyingKey(
        curve=curve,
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        gamma_abc_g1=gamma_abc,
    )


# ----- predicates ----------------------------------------------------------
