"""Port bucket MSM (`snark_tpu_torch/ops/msm_plane.py`) and signed digits
(`ops/msm.py`) against the JAX package's `PlaneMsm` (signed, interpret
mode, projective scan: SNARK_TPU_MSM_AFFINE=0) and the host oracle.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.host import Fp
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.msm import scalars_to_digits_signed
from snark_tpu.ops.msm_plane import get_plane_msm
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host

from snark_tpu_torch.fields.limbs import FR
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops.msm import pick_window_plane_signed, signed_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm

R = J_BN254.fr.modulus
NBITS = J_BN254.fr.num_bits


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_projective_msm(monkeypatch):
    """The JAX MSM as oracle runs its projective scan."""
    monkeypatch.setenv("SNARK_TPU_MSM_AFFINE", "0")


def edge_scalars(c, n, seed):
    rng = random.Random(seed)
    s = [rng.randrange(R) for _ in range(n)]
    half_pat = sum((1 << (c - 1)) << (c * w) for w in range(NBITS // c))
    s[:5] = [0, 1, R - 1, half_pat % R, (1 << (c - 1)) + 1]
    return s


def port_digits(scalars, c):
    return signed_digits(FR.tensor(scalars, "cpu", mont=False), c, NBITS)


@pytest.mark.parametrize("c", [9, 11, 14])
def test_signed_digits_match_jax(c):
    scalars = edge_scalars(c, 256, c)
    want = scalars_to_digits_signed(Fp(J_BN254.fr).to_limbs_array(scalars), c, NBITS)
    got = port_digits(scalars, c)
    assert np.array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= 1 << (c - 1)


def test_window_pick():
    from snark_tpu.ops.msm_plane import pick_window_plane_signed as jax_pick

    for n in (2048, 1 << 16, 524162, 1 << 22):
        assert pick_window_plane_signed(n) == jax_pick(n)


@pytest.mark.parametrize("c", [9, 14])
def test_sort_keys_match_jax(c, jax_projective_msm):
    scalars = edge_scalars(c, 512, 20 + c)
    d = port_digits(scalars, c)
    jplan = get_plane_msm(J_BN254, c, interpret=True, signed=True)
    jkeys, jpay = jplan.sort_keys(jnp.asarray(d.numpy().T))
    keys, pay = PlaneMsm(c).sort_keys(d.t().contiguous())
    assert np.array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    assert np.array_equal(pay.numpy().view(np.uint32), np.asarray(jpay))


def pool_table(hc, n, seed, group="g1", pool=30, identities=2):
    rng = random.Random(seed)
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(pool)]
    pts += [None] * identities
    return (pts * (-(-n // len(pts))))[:n]


def test_msm_matches_jax(jax_projective_msm):
    """Fixture-sized window (c = 9), 512 points with identity rows and edge
    scalars: the port's MSM equals the JAX plane MSM and the host sum."""
    hc = host_g1(J_BN254)
    c, n = 9, 512
    pts = pool_table(hc, n, 9)
    scalars = edge_scalars(c, n, 10)
    table = pack_rows_u8_host(get_plane_curve(J_BN254), pts)
    want = None
    for s, pt in zip(scalars, pts):
        if pt is not None:
            want = hc.add(want, hc.scalar_mul(pt, s))
    jplan = get_plane_msm(J_BN254, c, interpret=True, signed=True)
    jdigits = scalars_to_digits_signed(Fp(J_BN254.fr).to_limbs_array(scalars), c, NBITS)
    assert jplan.msm_host(jnp.asarray(table), jdigits, hc) == want
    got = PlaneMsm(c).msm(torch.as_tensor(table), port_digits(scalars, c), hc)
    assert got == want


def test_msm_g2_matches_host():
    hc = host_g2(J_BN254)
    c, n = 9, 256
    pts = pool_table(hc, n, 11, "g2", pool=14)
    scalars = edge_scalars(c, n, 12)
    agg = {}
    for s, pt in zip(scalars, pts):
        if pt is not None:
            agg[pt] = (agg.get(pt, 0) + s) % R
    want = hc.msm(list(agg), list(agg.values()))
    table = torch.as_tensor(C.pack_rows_u8(pts, "g2"))
    assert PlaneMsm(c, group="g2").msm(table, port_digits(scalars, c), hc) == want


def test_msm_clustered_spill(jax_projective_msm):
    """Half the scalars ~44-bit (the MulChain witness pattern that puts ~5%
    of N into single boundary-window buckets): the rank-split spill runs,
    and the result equals the JAX plane MSM's and the host sum."""
    hc = host_g1(J_BN254)
    rng = random.Random(23)
    c, n = 9, 2048
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(32)]
    pts = pool * (n // 32)
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(R) for i in range(n)]
    agg = [0] * 32
    for i, s in enumerate(scalars):
        agg[i % 32] = (agg[i % 32] + s) % R
    want = hc.msm(pool, agg)

    plan = PlaneMsm(c)
    digits = port_digits(scalars, c)
    _, _, length = plan._buckets(digits.t().contiguous())
    assert plan.spill_plan(length, n)[1] is not None  # the spill path runs
    table = pack_rows_u8_host(get_plane_curve(J_BN254), pts)
    assert plan.msm(torch.as_tensor(table), digits, hc) == want
    jplan = get_plane_msm(J_BN254, c, interpret=True, signed=True)
    assert jplan.msm_host(jnp.asarray(table), digits.numpy(), hc) == want
