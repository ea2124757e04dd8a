"""The port's BLS12-381 curve kernels K1 (`bucket_madd_rows`) and K2
(`masked_add`) and the u8-row codec at R8 = 50 (`ops/curve.py` with
`curve=BLS12_381`) against the JAX package's Pallas curve kernels
(interpret mode), its row packer, the host oracle and the committed
arkworks vector.

Points are compared after normalisation to affine host points.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS
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

from snark_tpu_torch.fields.params import BLS12_381
from snark_tpu_torch.ops import curve as C

HOSTS = {"g1": j_host_g1(J_BLS), "g2": j_host_g2(J_BLS)}
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
BLS = BLS12_381


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def complete_cases(hc, n, seed):
    """P, Q with identity operands, P + (−P) and P + P among random pairs."""
    rng = random.Random(seed)
    P = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(6)]
    Q = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(6)]
    P += [None, P[0], P[1], None]
    Q += [P[2], hc.neg(P[0]), P[1], None]
    P += [hc.generator] * (n - len(P))
    Q += [hc.double(hc.generator)] * (n - len(Q))
    return P, Q


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_rows_match_jax_packer(group):
    """Rows are 2·K·50 + 1 bytes of x·2^400 mod q: the port's packer writes
    the JAX packer's bytes, reads back the points, and K1's decode (one
    multiply by 2^368) gives them back as 12-limb R = 2^384 points."""
    hc = HOSTS[group]
    pts = [hc.scalar_mul(hc.generator, k * 7919 + 1) for k in range(12)] + [None]
    rows = C.pack_rows_u8(pts, group, BLS)
    assert rows.shape == (13, 2 * C.GROUPS[group] * 50 + 1) == (13, C.row_bytes(group, BLS))
    assert np.array_equal(rows, pack_rows_u8_host(get_plane_curve(J_BLS), pts, group))
    assert C.rows_to_points(rows, group, BLS) == pts
    assert np.all(rows[:, 48:50] == 0)  # the top two digits of a component
    n = len(pts)
    got = C.bucket_madd_rows(
        C.identity(n, group, "cpu", BLS), torch.as_tensor(rows),
        torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32), 0, 1, group, BLS,
    )
    assert got.shape == (n, 3, C.GROUPS[group], 12)
    assert C.limbs_to_points(got, group, BLS) == pts


def check_k1_against_jax(group, n=16):
    """K1, one step per lane with signs and masks, against
    `make_masked_mixed_add_rows` (interpret mode) and the host oracle, with
    identity, P + (−P) and P + P lanes."""
    hc = HOSTS[group]
    P, Q = complete_cases(hc, n, 2)
    rng = np.random.RandomState(3)
    sign = rng.rand(n) < 0.5
    active = rng.rand(n) < 0.8
    active[:10] = True
    sign[:10] = False
    pc = get_plane_curve(J_BLS)
    rows = pack_rows_u8_host(pc, Q, group)
    kern = make_masked_mixed_add_rows(J_BLS, tile=n, interpret=True, group=group)
    w = rows_pad_width(J_BLS, group)
    rows_p = np.pad(rows, ((0, 0), (0, w - rows.shape[1])))
    planes = np.stack([active, sign]).astype(np.float32)
    out = kern(*pack_points_host(pc, P, group), jnp.asarray(rows_p), jnp.asarray(planes))
    want = unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)
    perm = torch.as_tensor(np.arange(n) | (sign.astype(np.int64) << 31)).to(torch.int32)
    got = C.bucket_madd_rows(
        C.points_to_limbs(P, group, "cpu", BLS), torch.as_tensor(rows), perm,
        torch.zeros(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
        torch.as_tensor(active.astype(np.int32)), 0, 1, group, BLS,
    )
    got = C.limbs_to_points(got, group, BLS)
    assert got == want
    Qs = [hc.neg(q) if s else q for q, s in zip(Q, sign)]
    assert got == [hc.add(a, b) if m else a for a, b, m in zip(P, Qs, active)]


def check_k2_against_jax(group, n=16):
    """K2 against `make_masked_add` (interpret mode) and the host oracle."""
    hc = HOSTS[group]
    P, Q = complete_cases(hc, n, 4)
    mask = [k % 3 != 1 for k in range(n)]
    mask[:10] = [True] * 10
    pc = get_plane_curve(J_BLS)
    madd = make_masked_add(J_BLS, tile=n, interpret=True, group=group)
    out = madd(
        *pack_points_host(pc, P, group), *pack_points_host(pc, Q, group),
        jnp.asarray(np.asarray(mask, np.float32)[None, :]),
    )
    want = unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)
    got = C.limbs_to_points(
        C.masked_add(C.points_to_limbs(P, group, "cpu", BLS), C.points_to_limbs(Q, group, "cpu", BLS),
                     torch.as_tensor(mask), group, BLS),
        group, BLS,
    )
    assert got == want == [hc.add(a, b) if m else a for a, b, m in zip(P, Q, mask)]


def test_bls_k1_k2_g1_match_jax():
    check_k1_against_jax("g1")
    check_k2_against_jax("g1")


def test_bls_k2_g2_match_jax():
    """(K1 in G2 against JAX is `tests/test_torch_bls_scan_g2.py`: each
    G2 kernel takes about 20 s to trace in interpret mode.)"""
    check_k2_against_jax("g2")


def test_bls_curve_vector_runs():
    """`tests/vectors/curve_bls12_381.json` (arkworks): K1 runs over rows of
    the committed multiples [1, 2, 7, 12345, r − 1]·G, windowed by
    i0 / k_steps, give their sums in G1 and G2; the identity row is skipped
    and a negative payload subtracts."""
    with open(os.path.join(VECTORS, "curve_bls12_381.json")) as f:
        v = json.load(f)
    r = BLS.fr.modulus
    for group, key in (("g1", "g1_scalar_muls"), ("g2", "g2_scalar_muls")):
        hc = HOSTS[group]
        ks = [int(k) for k in v[key]]
        if group == "g1":
            pts = [tuple(int(c) for c in v[key][str(k)]) for k in ks]
        else:
            pts = [tuple(tuple(int(c) for c in xy) for xy in v[key][str(k)]) for k in ks]
        assert pts == [hc.scalar_mul(hc.generator, k) for k in ks]
        table = torch.as_tensor(C.pack_rows_u8(pts + [None], group, BLS))
        # lane 0 adds every row and the identity; lane 1 subtracts 7·G from 12345·G
        runs = [0, 1, 2, 3, 4, 5, 3, 2 | (1 << 31)]
        perm = torch.as_tensor(np.array(runs, np.int64)).to(torch.int32)
        start = torch.tensor([0, 6], dtype=torch.int32)
        length = torch.tensor([6, 2], dtype=torch.int32)
        base = torch.zeros(2, dtype=torch.int32)
        acc0 = C.identity(2, group, "cpu", BLS)
        half = C.bucket_madd_rows(acc0, table, perm, base, start, length, 0, 3, group, BLS)
        got = C.bucket_madd_rows(half, table, perm, base, start, length, 3, 3, group, BLS)
        total = sum(ks) % r
        want = [hc.scalar_mul(hc.generator, total) if total else None,
                hc.scalar_mul(hc.generator, 12345 - 7)]
        assert C.limbs_to_points(got, group, BLS) == want
