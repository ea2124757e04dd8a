"""Port batch-affine bucket accumulation (`snark_tpu_torch/ops/msm_affine.py`):
K6 (`affine_phase1`), K8 (`affine_phase3`) and the batch inverse (K7)
against the JAX package's phase kernels and `batch_inverse_planes` (JAX-CPU,
the kernels' emu path), and whole affine MSMs against the host oracle.

The kernels are compared at level 0 of a signed MSM on 128 pairs that hold
every class: add, double, P + (−P), identity on either side or both, and
the sign bytes turning a double into an inverse pair and back. K8's rows
must equal the JAX rows byte for byte, which shows they are canonical.

A whole JAX affine MSM takes about a minute to compile on JAX-CPU, so the
whole MSMs here are held against the host oracle: the JAX package's own
tests (`tests/test_msm_affine.py`) hold its affine MSM against the same.
JAX refuses G2 affine on the CPU, so G2 is held against the host only.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.msm_affine import _get_kernels, batch_inverse_planes
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host, rows_pad_width

from snark_tpu_torch.fields.limbs import FQ, FR
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops import msm_affine as A
from snark_tpu_torch.ops.msm import signed_digits, unsigned_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm

R = J_BN254.fr.modulus
Q = J_BN254.fq.modulus
HG1, HG2 = host_g1(J_BN254), host_g2(J_BN254)
PAIRS = 128


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def level0_pairs():
    """(points (2M,), sign bytes (2M,)) covering every class of pair."""
    hc = HG1
    rng = random.Random(3)
    P = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(16)]
    pts, sgn = [], []

    def pair(a, b, sa=0, sb=0):
        pts.extend([a, b])
        sgn.extend([sa, sb])

    for i in range(16):
        p, q = P[i], P[(i + 1) % 16]
        pair(p, q)  # add
        pair(p, p)  # double
        pair(p, hc.neg(p))  # inverse: identity
        pair(p, None)  # copy left
        pair(None, q)  # copy right
        pair(p, p, 0, 1)  # the sign makes an inverse pair
        pair(p, hc.neg(p), 0, 1)  # the sign makes a double
        pair(None, None, 1, 1)  # both identity
    assert len(pts) == 2 * PAIRS
    return pts, np.asarray(sgn, np.uint8)


def wide_values(planes) -> list[int]:
    """(R8, M) digit planes of x·2^272 (lazy) -> canonical values x."""
    d = np.asarray(planes).astype(np.int64)
    r_inv = pow(1 << 272, -1, Q)
    return [sum(int(v) << (8 * i) for i, v in enumerate(d[:, j])) * r_inv % Q for j in range(d.shape[1])]


@pytest.fixture(scope="module")
def cases():
    """The JAX side, run once: phase 1, the batch inverse and phase 3 of
    the JAX package on the level-0 pairs."""
    pts, sgn = level0_pairs()
    rows = C.pack_rows_u8(pts, "g1")
    assert np.array_equal(rows, pack_rows_u8_host(get_plane_curve(J_BN254), pts))
    rw = rows_pad_width(J_BN254, "g1")
    padded = np.zeros((2 * PAIRS, rw), np.uint8)
    padded[:, : rows.shape[1]] = rows
    blk = jnp.asarray(padded.reshape(PAIRS, 2 * rw))
    sg = jnp.asarray(sgn.reshape(PAIRS, 2).T.astype(np.float32))
    phase1, phase3, tree = _get_kernels(J_BN254, 256, None, "g1", True)
    den, preds = phase1(blk, sg)
    inverse = jax.jit(lambda d: batch_inverse_planes(get_plane_curve(J_BN254), "g1", d, tree, 256))
    dinv = inverse(den)
    out = np.asarray(phase3(blk, sg, dinv, preds)).astype(np.uint8)
    return {
        "rows": torch.as_tensor(rows),
        "sgn": torch.as_tensor(sgn),
        "den": wide_values(den),
        "preds": np.asarray(preds),
        "dinv": wide_values(dinv),
        "out": out[:, : rows.shape[1]],
    }


def test_phase1_matches_jax(cases):
    den, cls = A.affine_phase1(cases["rows"], cases["sgn"], "g1")
    assert FQ.decode(den) == cases["den"]
    dead, copy_l, copy_r, dbl = cases["preds"]
    c = cls.numpy()
    assert np.array_equal(c == A.DEAD, dead == 1)
    assert np.array_equal(c == A.COPY_L, copy_l == 1)
    assert np.array_equal(c == A.COPY_R, copy_r == 1)
    assert np.array_equal(c == A.DOUBLE, dbl == 1)
    assert set(c.tolist()) == {A.ADD, A.DOUBLE, A.DEAD, A.COPY_L, A.COPY_R}
    # lanes that compute nothing divide by one, never by zero
    one = FQ.decode(den[c >= A.DEAD])
    assert one == [1] * len(one)


def test_batch_inverse_matches_jax(cases):
    den, _ = A.affine_phase1(cases["rows"], cases["sgn"], "g1")
    dinv = FQ.decode(A.batch_inverse(den, "g1"))
    assert dinv == cases["dinv"]
    assert all(d * i % Q == 1 for d, i in zip(cases["den"], dinv))


def test_phase3_rows_match_jax(cases):
    """Byte for byte: the port writes canonical rows in the key's form."""
    rows, sgn = cases["rows"], cases["sgn"]
    den, cls = A.affine_phase1(rows, sgn, "g1")
    out = A.affine_phase3(rows, sgn, A.batch_inverse(den, "g1"), cls, "g1")
    assert np.array_equal(out.numpy(), cases["out"])
    # canonical: the two top bytes of every component are zero and every
    # value is below q
    D = C.row_digits()
    comps = out[:, :-1].reshape(PAIRS, 2, D).numpy()
    assert not comps[:, :, 32:].any()
    assert all(int.from_bytes(v.tobytes(), "little") < Q for v in comps.reshape(-1, D))
    # the rows decode to the pairwise sums
    pts, s = level0_pairs()
    pts = [HG1.neg(p) if f else p for p, f in zip(pts, s)]
    want = [HG1.add(pts[2 * j], pts[2 * j + 1]) for j in range(PAIRS)]
    assert C.rows_to_points(out.numpy(), "g1") == want


def host_msm(hc, pts, scalars):
    """Σ s_i·P_i, one scalar multiplication per distinct point."""
    agg = {}
    for s, p in zip(scalars, pts):
        if p is not None:
            agg[p] = (agg.get(p, 0) + s) % R
    return hc.msm(list(agg), list(agg.values()))


def test_affine_msm_g1_unsigned_degenerates():
    """n = 2048, c = 8 unsigned (mean 8 per bucket: the gate's edge,
    B0 = 4): duplicated bases (doubles at both levels), identity rows, P
    and −P, a clustered scalar; the device combine finishes it."""
    hc = HG1
    rng = random.Random(11)
    n, c = 2048, 8
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(7)]
    pool = base + [hc.neg(p) for p in base[:7]] + [None, None]
    pts = [pool[i % 16] for i in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[:3] = [0, 1, R - 1]
    shared = rng.randrange(R)
    for i in range(0, n, 8):
        scalars[i] = shared
    plan = PlaneMsm(c, group="g1", signed=False, affine=True)
    assert plan.uses_affine(n)
    table = torch.as_tensor(C.pack_rows_u8(pts, "g1"))
    digits = unsigned_digits(FR.tensor(scalars, "cpu", mont=False), c, 254)
    got = C.limbs_to_points(plan.msm(table, digits)[None], "g1")[0]
    assert got == host_msm(hc, pts, scalars)


def test_affine_msm_g2_signed():
    """G2, signed c = 5 (cb = 4: n = 256 is 16 per bucket, B0 = 4), with
    identity rows and inverse pairs in the pool."""
    hc = HG2
    rng = random.Random(13)
    n, c = 256, 5
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(3)]
    pool = base + [hc.neg(p) for p in base] + [None, base[0]]
    pts = [pool[i % 8] for i in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[:2] = [0, R - 1]
    plan = PlaneMsm(c, group="g2", signed=True, affine=True)
    assert plan.uses_affine(n)
    table = torch.as_tensor(C.pack_rows_u8(pts, "g2"))
    digits = signed_digits(FR.tensor(scalars, "cpu", mont=False), c, 254)
    assert plan.msm_host(table, digits, hc) == host_msm(hc, pts, scalars)
