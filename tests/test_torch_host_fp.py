"""The port's host field surface (`snark_tpu_torch/fields/host.py`: `Fp`'s
`from_int`, `elem` and limb-array codecs, and `FpElem`) against the JAX
package's `snark_tpu/fields/host.py`, on both scalar fields, on values made
from numpy seeds. The limb arrays are the JAX package's public device
format, (N, L) uint32 base-2^16 limbs, so dtypes and shapes must match as
well as the values. Exact.
"""

import numpy as np
import pytest

from snark_tpu.fields import host as ref_host
from snark_tpu.fields.params import get_field as ref_field
from snark_tpu_torch.fields import FpElem, get_field
from snark_tpu_torch.fields.host import Fp

FIELDS = ("bn254_fr", "bls12_381_fr")


def _values(p: int, seed: int, n: int = 40) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**63, size=(n, 5), dtype=np.int64)
    vals = [sum(int(w) << (63 * i) for i, w in enumerate(row)) % p for row in words]
    return [0, 1, 2, p - 1, p - 2] + vals


def _pair(name: str):
    return Fp(get_field(name)), ref_host.Fp(ref_field(name))


def _same_array(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FIELDS)
def test_limb_codecs_equal_reference(name):
    """to/from_limbs_array, to/from_mont_limbs_array, from_int and elem."""
    f, rf = _pair(name)
    p = f.p
    xs = _values(p, seed=len(name))
    _same_array(f.to_limbs_array(xs), rf.to_limbs_array(xs))
    _same_array(f.to_mont_limbs_array(xs), rf.to_mont_limbs_array(xs))
    _same_array(f.to_limbs_array([]), rf.to_limbs_array([]))
    limbs = rf.to_limbs_array(xs)
    mont = rf.to_mont_limbs_array(xs)
    assert f.from_limbs_array(limbs) == rf.from_limbs_array(limbs) == xs
    assert f.from_mont_limbs_array(mont) == rf.from_mont_limbs_array(mont) == xs
    # (..., L) arrays, and lanes wider than 16 bits: the low 16 bits count
    wide = limbs.astype(np.uint64).reshape(5, -1, limbs.shape[1]) | np.uint64(0xABCD0000)
    assert f.from_limbs_array(wide) == rf.from_limbs_array(wide)
    big = [-1, -p, 3 * p + 5, 2**400 + 7] + xs
    assert [f.from_int(x) for x in big] == [rf.from_int(x) for x in big]
    assert [int(f.elem(x)) for x in big] == [int(rf.elem(x)) for x in big]


def test_fpelem_equals_reference():
    """FpElem's operators, both sides of each, on both fields."""
    for name in FIELDS:
        f, rf = _pair(name)
        xs = _values(f.p, seed=7)
        ys = _values(f.p, seed=8)[::-1]
        for x, y in zip(xs, ys):
            a, b = f.elem(x), f.elem(y)
            ra, rb = rf.elem(x), rf.elem(y)
            assert isinstance(a, FpElem)
            pairs = [
                (a + b, ra + rb), (a - b, ra - rb), (a * b, ra * rb), (-a, -ra),
                (a + 5, ra + 5), (5 + a, 5 + ra), (7 - a, 7 - ra), (3 * a, 3 * ra),
                (a ** 5, ra ** 5), (a ** -3 if x else a, ra ** -3 if x else ra),
                (a + b * y - x, ra + rb * y - x),
            ]
            if y:
                pairs += [(a / b, ra / rb), (b.inverse(), rb.inverse()), (a / y, ra / y)]
            for got, want in pairs:
                assert isinstance(got, FpElem)
                assert int(got) == int(want) and repr(got) == repr(want)
                assert got == int(want) and hash(got) == hash(want)
        with pytest.raises(ZeroDivisionError):
            f.elem(0).inverse()
