"""The port's BLS12-381 plane MSM (`ops/msm_plane.py` `PlaneMsm` with
`curve=BLS12_381`) and 255-bit signed digits (`ops/msm.py`): digits and
sort keys against the JAX package's `PlaneMsm`, sums against the host and
the committed arkworks vector.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.fields.host import Fp
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.msm import scalars_to_digits_signed
from snark_tpu.ops.msm_plane import get_plane_msm
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host

from snark_tpu_torch.fields.limbs import BLS_FR
from snark_tpu_torch.fields.params import BLS12_381 as BLS
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops.msm import num_windows_signed, signed_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm

R = J_BLS.fr.modulus
NBITS = J_BLS.fr.num_bits  # 255
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def edge_scalars(c, n, seed):
    rng = random.Random(seed)
    s = [rng.randrange(R) for _ in range(n)]
    half_pat = sum((1 << (c - 1)) << (c * w) for w in range(NBITS // c))
    s[:5] = [0, 1, R - 1, half_pat % R, (1 << (c - 1)) + 1]
    return s


def port_digits(scalars, c):
    return signed_digits(BLS_FR.tensor(scalars, "cpu", mont=False), c, NBITS)


@pytest.mark.parametrize("c", [4, 9, 16])
def test_bls_digits_and_keys_match_jax(c, monkeypatch):
    """255-bit scalars (c = 4 of a small circuit, c = 16 of the 2^20
    prove): the port's signed digits, window count and sort keys are the
    JAX package's (its projective plan: SNARK_TPU_MSM_AFFINE=0)."""
    monkeypatch.setenv("SNARK_TPU_MSM_AFFINE", "0")
    scalars = edge_scalars(c, 256, c)
    want = scalars_to_digits_signed(Fp(J_BLS.fr).to_limbs_array(scalars), c, NBITS)
    got = port_digits(scalars, c)
    assert np.array_equal(got.numpy(), want)
    plan = PlaneMsm(c, NBITS, curve=BLS)
    assert got.shape[1] == num_windows_signed(c, NBITS) == plan.W
    jkeys, jpay = get_plane_msm(J_BLS, c, NBITS, interpret=True, signed=True).sort_keys(
        jnp.asarray(want.T)
    )
    keys, pay = plan.sort_keys(got.t().contiguous())
    assert np.array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    assert np.array_equal(pay.numpy().view(np.uint32), np.asarray(jpay))


def test_bls_msm_g1_clustered_spill():
    """G1, c = 9, 2048 points over a pool with identity rows, half the
    scalars ~44-bit (the MulChain witness pattern): the rank-split spill
    runs and the sum equals the host's. (The JAX plane MSM over BLS12-381
    takes about 30 s to trace on JAX-CPU, so the host sum is the oracle
    here; K1, K2, the digits and the sort keys are held against JAX.)"""
    hc = host_g1(J_BLS)
    rng = random.Random(23)
    c, n = 9, 2048
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(30)] + [None, None]
    pts = pool * (n // 32)
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(R) for i in range(n)]
    scalars[:3] = [0, 1, R - 1]
    agg = [0] * 30
    for i, s in enumerate(scalars):
        if i % 32 < 30:
            agg[i % 32] = (agg[i % 32] + s) % R
    plan = PlaneMsm(c, NBITS, curve=BLS)
    digits = port_digits(scalars, c)
    _, _, length = plan._buckets(digits.t().contiguous())
    assert plan.spill_plan(length, n // plan.nb)[1] is not None  # the spill path runs
    table = torch.as_tensor(pack_rows_u8_host(get_plane_curve(J_BLS), pts))
    assert plan.msm_host(table, digits, hc) == hc.msm(pool[:30], agg)


def test_bls_msm_g2_and_vector():
    """G2 (c = 5, a clustered scalar set) against the host sum, and G1 on
    `tests/vectors/curve_bls12_381.json`: bases (i + 1)·G, its scalars, its
    result."""
    hc = host_g2(J_BLS)
    rng = random.Random(11)
    c, n = 5, 128
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(14)]
    pts = [pool[i % 14] for i in range(n)]
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(R) for i in range(n)]
    agg = [0] * 14
    for i, s in enumerate(scalars):
        agg[i % 14] = (agg[i % 14] + s) % R
    table = torch.as_tensor(C.pack_rows_u8(pts, "g2", BLS))
    plan = PlaneMsm(c, NBITS, "g2", curve=BLS)
    assert plan.msm_host(table, port_digits(scalars, c), hc) == hc.msm(pool, agg)

    with open(os.path.join(VECTORS, "curve_bls12_381.json")) as f:
        v = json.load(f)
    g1 = host_g1(J_BLS)
    vs = [int(s) for s in v["msm_scalars"]]
    bases = [g1.scalar_mul(g1.generator, i + 1) for i in range(len(vs))]
    table = torch.as_tensor(C.pack_rows_u8(bases, "g1", BLS))
    got = PlaneMsm(4, NBITS, curve=BLS).msm_host(table, port_digits(vs, 4), g1)
    assert [str(x) for x in got] == v["msm_result"]
