"""Port curve kernels K1 (`bucket_madd_rows`) and K2 (`masked_add`) and
the u8-row codecs (`snark_tpu_torch/ops/curve.py`) against the JAX
package's Pallas curve kernels (interpret mode) and host oracle.

Points are compared after normalisation to affine host points.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.curve_host import host_g1 as j_host_g1
from snark_tpu.ops.curve_host import host_g2 as j_host_g2
from snark_tpu.ops.pallas_curve import (
    get_plane_curve,
    make_masked_add,
    make_masked_mixed_add_rows,
    pack_points_host,
    pack_rows_u8_host,
    rows_pad_width,
    unpack_points_host,
)

from snark_tpu_torch.ops import curve as C

HOSTS = {"g1": j_host_g1(J_BN254), "g2": j_host_g2(J_BN254)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def complete_cases(hc, n, seed):
    """P, Q with identity operands, P + (−P) and P + P among random pairs
    (the cases of tests/test_pallas_curve_msm.py)."""
    rng = random.Random(seed)
    P = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(6)]
    Q = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(6)]
    P += [None, P[0], P[1], None]
    Q += [P[2], hc.neg(P[0]), P[1], None]
    P += [hc.generator] * (n - len(P))
    Q += [hc.double(hc.generator)] * (n - len(Q))
    return P, Q


def jax_masked_add(group, P, Q, mask):
    pc = get_plane_curve(J_BN254)
    madd = make_masked_add(J_BN254, tile=len(P), interpret=True, group=group)
    out = madd(
        *pack_points_host(pc, P, group),
        *pack_points_host(pc, Q, group),
        jnp.asarray(np.asarray(mask, np.float32)[None, :]),
    )
    return unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_masked_add_complete_matches_jax(group):
    hc = HOSTS[group]
    P, Q = complete_cases(hc, 128, 1)
    mask = [k % 3 != 1 for k in range(128)]
    mask[:10] = [True] * 10
    got = C.limbs_to_points(
        C.masked_add(C.points_to_limbs(P, group, "cpu"), C.points_to_limbs(Q, group, "cpu"),
                     torch.as_tensor(mask), group),
        group,
    )
    assert got == jax_masked_add(group, P, Q, mask)
    assert got == [hc.add(a, b) if m else a for a, b, m in zip(P, Q, mask)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_masked_add_doubling_chain(group):
    """P + P through the complete formula, repeatedly: [2^k]P."""
    hc = HOSTS[group]
    P = [hc.scalar_mul(hc.generator, k + 3) for k in range(16)]
    t = C.points_to_limbs(P, group, "cpu")
    mask = torch.ones(16, dtype=torch.bool)
    for _ in range(3):
        t = C.masked_add(t, t, mask, group)
    assert C.limbs_to_points(t, group) == [hc.scalar_mul(p, 8) for p in P]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bucket_madd_rows_matches_jax(group):
    """One K1 step per lane against the JAX rows kernel on the same
    gathered rows, signs and masks (identity accumulators and rows, the
    inverse and the doubling included)."""
    hc = HOSTS[group]
    n = 128
    P, Q = complete_cases(hc, n, 2)
    rng = np.random.RandomState(3)
    sign = rng.rand(n) < 0.5
    active = rng.rand(n) < 0.8
    active[:10] = True
    sign[:10] = False
    pc = get_plane_curve(J_BN254)
    rows = pack_rows_u8_host(pc, Q, group)
    assert np.array_equal(rows, C.pack_rows_u8(Q, group))

    kern = make_masked_mixed_add_rows(J_BN254, tile=n, interpret=True, group=group)
    w = rows_pad_width(J_BN254, group)
    rows_p = np.pad(rows, ((0, 0), (0, w - rows.shape[1])))
    planes = np.stack([active, sign]).astype(np.float32)
    out = kern(*pack_points_host(pc, P, group), jnp.asarray(rows_p), jnp.asarray(planes))
    want = unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)

    perm = torch.as_tensor(np.arange(n) | (sign.astype(np.int64) << 31)).to(torch.int32)
    got = C.bucket_madd_rows(
        C.points_to_limbs(P, group, "cpu"), torch.as_tensor(rows), perm,
        torch.zeros(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
        torch.as_tensor(active.astype(np.int32)), 0, 1, group,
    )
    got = C.limbs_to_points(got, group)
    assert got == want
    Qs = [hc.neg(q) if s else q for q, s in zip(Q, sign)]
    assert got == [hc.add(a, b) if m else a for a, b, m in zip(P, Qs, active)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bucket_madd_rows_runs(group):
    """K1 over runs of several rows per lane, windowed by i0 / k_steps:
    two launches of k steps equal one of 2k."""
    hc = HOSTS[group]
    rng = random.Random(4)
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(7)] + [None]
    lanes, depth = 24, 6
    table = torch.as_tensor(C.pack_rows_u8(pool, group))
    idx = np.array([rng.randrange(8) for _ in range(lanes * depth)])
    neg = np.array([rng.random() < 0.3 for _ in range(lanes * depth)])
    perm = torch.as_tensor(idx | (neg.astype(np.int64) << 31)).to(torch.int32)
    length = torch.as_tensor([rng.randrange(depth + 1) for _ in range(lanes)], dtype=torch.int32)
    start = torch.arange(lanes, dtype=torch.int32) * depth
    base = torch.zeros(lanes, dtype=torch.int32)
    acc0 = C.identity(lanes, group, "cpu")
    one = C.bucket_madd_rows(acc0, table, perm, base, start, length, 0, depth, group)
    half = C.bucket_madd_rows(acc0, table, perm, base, start, length, 0, 3, group)
    two = C.bucket_madd_rows(half, table, perm, base, start, length, 3, 3, group)
    assert torch.equal(one, two)
    want = []
    for l in range(lanes):
        acc = None
        for i in range(int(length[l])):
            j = l * depth + i
            pt = pool[idx[j]]
            acc = hc.add(acc, hc.neg(pt) if neg[j] else pt)
        want.append(acc)
    assert C.limbs_to_points(one, group) == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_row_codecs_match_jax(group):
    """Rows are wide-Montgomery (R = 2^272) bytes: the port's codec writes
    the JAX codec's bytes and reads back the points; K1's in-kernel
    decode (a multiply by 2^240) turns them into R = 2^256 limbs."""
    hc = HOSTS[group]
    pts = [hc.scalar_mul(hc.generator, k * 7919 + 1) for k in range(12)] + [None]
    pc = get_plane_curve(J_BN254)
    rows = C.pack_rows_u8(pts, group)
    assert np.array_equal(rows, pack_rows_u8_host(pc, pts, group))
    assert C.rows_to_points(rows, group) == pts
    # adding each row once to the identity gives back the point itself
    n = len(pts)
    got = C.bucket_madd_rows(
        C.identity(n, group, "cpu"), torch.as_tensor(rows),
        torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32), 0, 1, group,
    )
    assert C.limbs_to_points(got, group) == pts


def test_wrappers_reject_bad_inputs():
    acc = C.identity(4, "g1", "cpu")
    with pytest.raises(ValueError):
        C.masked_add(acc, acc, torch.ones(4, dtype=torch.int32), "g1")
    with pytest.raises(ValueError):
        C.masked_add(acc, C.identity(4, "g2", "cpu"), torch.ones(4, dtype=torch.bool), "g1")
    with pytest.raises(ValueError):
        C.bucket_madd_rows(acc, torch.zeros((4, 137), dtype=torch.uint8),
                           torch.zeros(4, dtype=torch.int32), *[torch.zeros(4, dtype=torch.int32)] * 3,
                           0, 1, "g1")
