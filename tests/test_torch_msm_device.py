"""Port MSM with the device Horner combine (`PlaneMsm.msm`: the bucket
scan, the folds, then K5 and K2 on one lane) against the JAX package's
`PlaneMsm.msm` (interpret mode, projective scan: SNARK_TPU_MSM_AFFINE=0)
and the host sum: signed digits here, unsigned in
`test_torch_msm_device_unsigned.py` (one JAX plan per file keeps each file
short).

c = 4 keeps the JAX plans small: signed and unsigned both have 64 windows.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.host import Fp
from snark_tpu.ops.curve_host import host_g1
from snark_tpu.ops.msm import scalars_to_digits, scalars_to_digits_signed
from snark_tpu.ops.msm_plane import get_plane_msm
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host, unpack_points_host

from snark_tpu_torch.fields.limbs import FR
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops.msm import signed_digits, unsigned_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm

R = J_BN254.fr.modulus
NBITS = J_BN254.fr.num_bits
C_BITS, N, TILE = 4, 256, 512


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def check_device_msm(signed: bool) -> None:
    """The port's device-combine MSM equals the JAX one and the host sum
    on 256 points with identity rows and edge scalars. The caller pins
    SNARK_TPU_MSM_AFFINE=0."""
    hc = host_g1(J_BN254)
    rng = random.Random(7 + signed)
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(15)] + [None]
    pts = [pool[i % 16] for i in range(N)]
    scalars = [rng.randrange(R) for _ in range(N)]
    scalars[:4] = [0, 1, R - 1, sum(8 << (4 * w) for w in range(63))]
    agg = [0] * 16
    for i, s in enumerate(scalars):
        agg[i % 16] = (agg[i % 16] + s) % R
    want = hc.msm(pool[:15], agg[:15])

    table = pack_rows_u8_host(get_plane_curve(J_BN254), pts)
    jdig = (scalars_to_digits_signed if signed else scalars_to_digits)(
        Fp(J_BN254.fr).to_limbs_array(scalars), C_BITS, NBITS
    )
    jplan = get_plane_msm(J_BN254, C_BITS, interpret=True, signed=signed, tile=TILE)
    X, Y, Z = jplan.msm(jnp.asarray(table), jdig)
    jgot = unpack_points_host(get_plane_curve(J_BN254), *(np.asarray(a) for a in (X, Y, Z)))[0]

    std = FR.tensor(scalars, "cpu", mont=False)
    digits = (signed_digits if signed else unsigned_digits)(std, C_BITS, NBITS)
    plan = PlaneMsm(C_BITS, NBITS, "g1", signed=signed)
    assert plan.W == jplan.W == 64
    got = plan.msm(torch.as_tensor(table), digits)
    assert tuple(got.shape) == (3, 1, 8)
    assert C.limbs_to_points(got[None], "g1")[0] == jgot == want


def test_device_msm_signed_matches_jax(monkeypatch):
    monkeypatch.setenv("SNARK_TPU_MSM_AFFINE", "0")
    check_device_msm(signed=True)
