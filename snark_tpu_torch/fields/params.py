"""Field and curve parameters for BN254 and BLS12-381.

The port's own copy of the JAX package's `fields/params.py`. Every derived
constant (Montgomery constants, two-adic roots of unity) is computed from
the moduli at import time, so there is nothing to transcribe.

Conventions (they match arkworks for bit-exact interop):
  * ``TWO_ADIC_ROOT_OF_UNITY = GENERATOR ** ((p - 1) >> two_adicity) mod p``
    with arkworks' generators (5 for BN254 Fr, 7 for BLS12-381 Fr, 3 for
    BN254 Fq, 2 for BLS12-381 Fq).
  * ``FieldParams.r`` is R = 2**(16 * num_limbs), the Montgomery radix of
    the reference's 16-bit-limb keys (its CSR coefficients). For BN254 this
    equals 2**256, the radix of the port's 8 x u32 limbs (`fields/limbs.py`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _two_adicity(n: int) -> int:
    """Largest s with 2^s | n."""
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s


@dataclass(frozen=True)
class FieldParams:
    """A prime field p together with derived Montgomery / FFT constants."""

    name: str
    modulus: int
    generator: int  # multiplicative generator of F_p^* (arkworks convention)

    # Derived (filled in __post_init__ via object.__setattr__):
    num_limbs: int = field(init=False)
    num_bits: int = field(init=False)
    num_bytes: int = field(init=False)  # serialized size (arkworks: ceil(bits/8))
    two_adicity: int = field(init=False)
    two_adic_root_of_unity: int = field(init=False)
    r: int = field(init=False)  # Montgomery R = 2^(16*num_limbs)
    r2: int = field(init=False)  # R^2 mod p
    n_prime: int = field(init=False)  # -p^{-1} mod R
    inv_2: int = field(init=False)  # 1/2 mod p

    def __post_init__(self):
        p = self.modulus
        nbits = p.bit_length()
        nlimbs = -(-nbits // LIMB_BITS)
        object.__setattr__(self, "num_bits", nbits)
        object.__setattr__(self, "num_bytes", -(-nbits // 8))
        object.__setattr__(self, "num_limbs", nlimbs)
        s = _two_adicity(p - 1)
        object.__setattr__(self, "two_adicity", s)
        object.__setattr__(
            self, "two_adic_root_of_unity", pow(self.generator, (p - 1) >> s, p)
        )
        r = 1 << (LIMB_BITS * nlimbs)
        object.__setattr__(self, "r", r)
        object.__setattr__(self, "r2", (r * r) % p)
        object.__setattr__(self, "n_prime", (-pow(p, -1, r)) % r)
        object.__setattr__(self, "inv_2", pow(2, -1, p))

    # ----- scalar (host) helpers ---------------------------------------
    def to_limbs(self, x: int) -> list[int]:
        """Little-endian base-2^16 limbs of ``x`` (length ``num_limbs``)."""
        return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.num_limbs)]

    def from_limbs(self, limbs) -> int:
        acc = 0
        for i, l in enumerate(limbs):
            acc |= int(l) << (LIMB_BITS * i)
        return acc

    def to_mont(self, x: int) -> int:
        return (x * self.r) % self.modulus

    def from_mont(self, x: int) -> int:
        return (x * pow(self.r, -1, self.modulus)) % self.modulus

    def root_of_unity(self, n: int) -> int:
        """n-th root of unity matching arkworks Radix2EvaluationDomain.

        arkworks: ``group_gen = TWO_ADIC_ROOT_OF_UNITY ^ (2^(s - log2(n)))``.
        """
        assert n & (n - 1) == 0, "domain size must be a power of two"
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, "no 2^k root of unity of this order"
        return pow(
            self.two_adic_root_of_unity, 1 << (self.two_adicity - log_n), self.modulus
        )


@dataclass(frozen=True)
class CurveParams:
    """A pairing-friendly curve family (G1 over Fq, G2 over Fq2, scalars Fr)."""

    name: str
    fq: FieldParams
    fr: FieldParams
    b: int  # G1: y^2 = x^3 + b
    b2: tuple[int, int]  # G2: y^2 = x^3 + b2 (in Fq2 = Fq[u]/(u^2 + 1))
    g1_generator: tuple[int, int]
    g2_generator: tuple[tuple[int, int], tuple[int, int]]
    # Fq6 = Fq2[v]/(v^3 - xi); xi in Fq2:
    xi: tuple[int, int]
    # Pairing loop parameter:
    x: int  # curve family parameter (BN: t param; BLS: x, may be negative)
    cofactor_g1: int = 1


# ---------------------------------------------------------------------------
# BN254 (a.k.a. alt_bn128; arkworks `ark-bn254`)
# ---------------------------------------------------------------------------

BN254_FR = FieldParams(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
)

BN254_FQ = FieldParams(
    name="bn254_fq",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
)

BN254 = CurveParams(
    name="bn254",
    fq=BN254_FQ,
    fr=BN254_FR,
    b=3,
    # b2 = 3 / (9 + u) in Fq2
    b2=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    g1_generator=(1, 2),
    g2_generator=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
    xi=(9, 1),
    x=4965661367192848881,  # BN parameter; ate loop count is 6x+2
)


# ---------------------------------------------------------------------------
# BLS12-381 (arkworks `ark-bls12-381` / `ark-test-curves` bls12_381)
# ---------------------------------------------------------------------------

BLS12_381_FR = FieldParams(
    name="bls12_381_fr",
    modulus=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
)

BLS12_381_FQ = FieldParams(
    name="bls12_381_fq",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
)

BLS12_381 = CurveParams(
    name="bls12_381",
    fq=BLS12_381_FQ,
    fr=BLS12_381_FR,
    b=4,
    b2=(4, 4),  # 4 * (1 + u)
    g1_generator=(
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    ),
    g2_generator=(
        (
            352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
        ),
        (
            1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
        ),
    ),
    xi=(1, 1),
    x=-0xD201000000010000,
    cofactor_g1=0x396C8C005555E1568C00AAAB0000AAAB,
)


CURVES = {"bn254": BN254, "bls12_381": BLS12_381}
FIELDS = {
    f.name: f for f in (BN254_FR, BN254_FQ, BLS12_381_FR, BLS12_381_FQ)
}


@functools.lru_cache(maxsize=None)
def get_field(name: str) -> FieldParams:
    return FIELDS[name]


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> CurveParams:
    return CURVES[name]
