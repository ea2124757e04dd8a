"""The standalone Montgomery products K9 (`mont_mul16`) and K10
(`mont_mul16_limb_major`) of `snark_tpu_torch/ops/mont16.py`, through
their CPU path (the plain version), against the JAX package's Pallas
products in interpret mode: `ops/pallas_field.py` `make_mont_mul` (K9's
counterpart) and `scripts/pallas_field_v2.py` `make_mont_mul_v2` (K10's),
and against `DeviceField.mul` of both packages.

Tolerance: exact. All compute the canonical a·b·2^-256 mod p on (N, 16)
16-bit limbs, so the limbs must be equal. Inputs come from a numpy seed,
with the edges 0, 1, p − 1, 2^240 − 1 (fifteen limbs of 0xFFFF) and
p − 2^16.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.device import get_device_field as j_get_device_field
from snark_tpu.fields.host import Fp as JFp
from snark_tpu.ops.pallas_field import make_mont_mul

from snark_tpu_torch.fields.device import get_device_field
from snark_tpu_torch.fields.limbs import BLS_FR, FR
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import mont16 as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from pallas_field_v2 import make_mont_mul_v2  # noqa: E402


def operands(jparams, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, 16) uint32 Montgomery limbs of a and b, edges first."""
    f = JFp(jparams)
    p = f.p
    rng = np.random.RandomState(seed)
    edges = [0, 1, p - 1, (1 << 240) - 1, p - (1 << 16)]
    vals = edges + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - len(edges))]
    other = vals[::-1][:3] + vals[3:-3][::-1] + vals[-3:]
    return f.to_mont_limbs_array(vals), f.to_mont_limbs_array(other)


def port(arr: np.ndarray) -> torch.Tensor:
    return M.limbs16_tensor(arr, "cpu")


def test_plain_matches_make_mont_mul():
    a, b = operands(J_BN254.fr, 256, 1)
    want = np.asarray(make_mont_mul(J_BN254.fr, tile=256, interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    got = M.mont_mul16(port(a), port(b), FR)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    f = JFp(J_BN254.fr)
    assert f.from_mont_limbs_array(want) == [
        f.mul(x, y)
        for x, y in zip(f.from_mont_limbs_array(a), f.from_mont_limbs_array(b))
    ]


def test_plain_matches_make_mont_mul_v2():
    a, b = operands(J_BN254.fr, 256, 2)
    want = np.asarray(make_mont_mul_v2(J_BN254.fr, tile=256, interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    got = M.mont_mul16_limb_major(port(a), port(b), FR)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize(
    "fields", [(J_BN254.fr, BN254.fr, FR), (J_BLS12_381.fr, BLS12_381.fr, BLS_FR)],
    ids=["bn254_fr", "bls12_381_fr"],
)
def test_wrappers_match_device_field(fields):
    """Both wrappers' CPU path, the port's and the reference's
    `DeviceField.mul`, limb for limb."""
    jp, tp, field = fields
    a, b = operands(jp, 64, 3)
    want = np.asarray(j_get_device_field(jp).mul(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = port(a), port(b)
    for got in (
        M.mont_mul16(ta, tb, field),
        M.mont_mul16_limb_major(ta, tb, field),
        get_device_field(tp, "cpu").mul(ta, tb),
    ):
        assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_wrappers_refuse_bad_inputs_and_constants_match():
    a = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        M.mont_mul16(a, torch.zeros((4, 8), dtype=torch.int32), FR)
    with pytest.raises(ValueError):
        M.mont_mul16_limb_major(a, a.to(torch.int64), FR)
    with pytest.raises(ValueError):
        M.mont_mul16(a, torch.zeros((5, 16), dtype=torch.int32), FR)
    # K10's full N' = −p^-1 mod 2^256 in csrc/field16_kernels.cuh
    with open(os.path.join(ROOT, "snark_tpu_torch", "csrc", "field16_kernels.cuh")) as fh:
        src = fh.read()
    for name, field in (("kFrNp", FR), ("kBlsFrNp", BLS_FR)):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", src).group(1)
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
        assert sum(w << (32 * i) for i, w in enumerate(words)) == field.n_prime
