"""Port kernels of the device Horner combine, K5 (`point_double`) and K2
without a mask (`point_add`), against the JAX package's `make_point_double`
and `make_point_add` (interpret mode), for G1 and G2.

Points are compared after normalisation to affine host points. The whole
device-combine MSM is compared in `tests/test_torch_msm_device.py`.
"""

import random

import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.pallas_curve import (
    get_plane_curve,
    make_point_add,
    make_point_double,
    pack_points_host,
    unpack_points_host,
)

from snark_tpu_torch.ops import curve as C

HOSTS = {"g1": host_g1(J_BN254), "g2": host_g2(J_BN254)}
R = J_BN254.fr.modulus
LANES = 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def points(hc, seed):
    """LANES points: random multiples, the identity, the generator and
    its negation."""
    rng = random.Random(seed)
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(LANES - 3)]
    return pts + [None, hc.generator, hc.neg(hc.generator)]


def jax_apply(kernel, group, *pts):
    pc = get_plane_curve(J_BN254)
    planes = [p for pt in pts for p in pack_points_host(pc, pt, group)]
    out = kernel(*planes)
    return unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_double_matches_jax(group):
    """Three chained doublings, identity lane included."""
    hc = HOSTS[group]
    P = points(hc, 1)
    dbl = make_point_double(J_BN254, tile=LANES, interpret=True, group=group)
    want = P
    got = C.points_to_limbs(P, group, "cpu")
    for _ in range(3):
        want = jax_apply(dbl, group, want)
        got = C.point_double(got, group)
        assert C.limbs_to_points(got, group) == want
    assert want[-3] is None
    assert want == [hc.double(hc.double(hc.double(p))) for p in P]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_matches_jax(group):
    """The complete add without a mask: P + Q, P + P, P + (−P), identity
    operands."""
    hc = HOSTS[group]
    P = points(hc, 2)
    Q = points(hc, 3)
    Q[:4] = [P[0], hc.neg(P[1]), None, P[3]]
    P[3] = None
    add = make_point_add(J_BN254, tile=LANES, interpret=True, group=group)
    want = jax_apply(add, group, P, Q)
    got = C.point_add(C.points_to_limbs(P, group, "cpu"), C.points_to_limbs(Q, group, "cpu"), group)
    assert C.limbs_to_points(got, group) == want
    assert want == [hc.add(a, b) for a, b in zip(P, Q)]
