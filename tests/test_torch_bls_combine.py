"""Port kernels of the device Horner combine on BLS12-381, K5
(`point_double`) and K2 without a mask (`point_add`), against the JAX
package's `make_point_double` and `make_point_add` (interpret mode), and
the BLS12-381 MSM with the device combine (`PlaneMsm.msm`) against the host
sum.

Points are compared after normalisation to affine host points. Tracing one
JAX G2 kernel takes 15-20 s on JAX-CPU, so G2 has one test: K5 against
`make_point_double`, K2 unmasked against the host curve (the masked K2 in
G2, the same complete add, is held against JAX `make_masked_add` in
`tests/test_torch_bls_curve.py`).
"""

import random

import numpy as np
import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.pallas_curve import (
    get_plane_curve,
    make_point_add,
    make_point_double,
    pack_points_host,
    unpack_points_host,
)

from snark_tpu_torch.fields.limbs import BLS_FR
from snark_tpu_torch.fields.params import BLS12_381
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops.msm import signed_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm

HOSTS = {"g1": host_g1(J_BLS), "g2": host_g2(J_BLS)}
R = J_BLS.fr.modulus
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
    pc = get_plane_curve(J_BLS)
    planes = [p for pt in pts for p in pack_points_host(pc, pt, group)]
    out = kernel(*planes)
    return unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)


def check_double(group):
    """Three chained doublings, identity lane included."""
    hc = HOSTS[group]
    P = points(hc, 1)
    dbl = make_point_double(J_BLS, tile=LANES, interpret=True, group=group)
    want = P
    got = C.points_to_limbs(P, group, "cpu", BLS12_381)
    for _ in range(3):
        want = jax_apply(dbl, group, want)
        got = C.point_double(got, group, BLS12_381)
        assert C.limbs_to_points(got, group, BLS12_381) == want
    assert want[-3] is None
    assert want == [hc.double(hc.double(hc.double(p))) for p in P]


def check_add(group, jax_too: bool = True):
    """The complete add without a mask: P + Q, P + P, P + (−P), identity
    operands; against JAX `make_point_add` and the host curve."""
    hc = HOSTS[group]
    P = points(hc, 2)
    Q = points(hc, 3)
    Q[:4] = [P[0], hc.neg(P[1]), None, P[3]]
    P[3] = None
    want = [hc.add(a, b) for a, b in zip(P, Q)]
    if jax_too:
        add = make_point_add(J_BLS, tile=LANES, interpret=True, group=group)
        assert jax_apply(add, group, P, Q) == want
    p = C.points_to_limbs(P, group, "cpu", BLS12_381)
    q = C.points_to_limbs(Q, group, "cpu", BLS12_381)
    got = C.point_add(p, q, group, BLS12_381)
    assert C.limbs_to_points(got, group, BLS12_381) == want


def test_bls_point_double_matches_jax_g1():
    check_double("g1")


def test_bls_point_add_matches_jax_g1():
    check_add("g1")


def test_bls_combine_kernels_match_jax_g2():
    check_double("g2")
    check_add("g2", jax_too=False)


def test_bls_device_combine_msm():
    """G1, n = 1024, signed c = 8 (W = 32 windows, c + 1 = 9 combine
    steps each): the whole MSM on the plain path, finished by the device
    combine, equals the host sum; identity rows and P, −P in the pool."""
    hc = HOSTS["g1"]
    rng = random.Random(5)
    n, c = 1024, 8
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(5)]
    pool = base + [hc.neg(base[0]), None, base[1]]
    pts = [pool[i % 8] for i in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[:3] = [0, 1, R - 1]
    agg = {}
    for s, p in zip(scalars, pts):
        if p is not None:
            agg[p] = (agg.get(p, 0) + s) % R
    plan = PlaneMsm(c, BLS12_381.fr.num_bits, "g1", curve=BLS12_381)
    table = torch.as_tensor(C.pack_rows_u8(pts, "g1", BLS12_381))
    digits = signed_digits(BLS_FR.tensor(scalars, "cpu", mont=False), c, BLS12_381.fr.num_bits)
    got = plan.msm(table, digits)
    assert C.limbs_to_points(got[None], "g1", BLS12_381)[0] == hc.msm(list(agg), list(agg.values()))
