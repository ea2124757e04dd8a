"""Port batch-affine bucket accumulation on BLS12-381
(`snark_tpu_torch/ops/msm_affine.py` with `curve=BLS12_381`): K6
(`affine_phase1`), K8 (`affine_phase3`) and the batch inverse (K7) in G1
against the JAX package's phase kernels and `batch_inverse_planes` (JAX-CPU,
the kernels' emu path); the Fq and Fq2 inverse (K7, mode 1) against the host
field; whole affine MSMs in G1 and G2 against the host sum.

The kernels are compared at level 0 of a signed MSM on 128 pairs that hold
every class: add, double, P + (−P), identity on either side or both, and
the sign bytes turning a double into an inverse pair and back. K8's rows
(R8 = 50 bytes a component, 101 a G1 row) must equal the JAX rows byte for
byte, which shows they are canonical.

JAX refuses G2 affine on the CPU, and a whole JAX affine MSM takes about a
minute to compile there, so the whole MSMs are held against the host sum:
clustered pools (duplicated points, P and −P, identity rows) reach every
pair class at level 0, which each MSM test checks.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.fields.towers import Fq2 as HostFq2
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.msm_affine import _get_kernels, batch_inverse_planes
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host, rows_pad_width

from snark_tpu_torch.fields.limbs import BLS_FQ, BLS_FR
from snark_tpu_torch.fields.params import BLS12_381
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops import msm_affine as A
from snark_tpu_torch.ops.msm import signed_digits, unsigned_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm

R = J_BLS.fr.modulus
Q = J_BLS.fq.modulus
HG1, HG2 = host_g1(J_BLS), host_g2(J_BLS)
D = C.row_digits(BLS12_381)  # 50
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
    """(R8, M) digit planes of x·2^400 (lazy) -> canonical values x."""
    d = np.asarray(planes).astype(np.int64)
    r_inv = pow(1 << (8 * D), -1, Q)
    return [sum(int(v) << (8 * i) for i, v in enumerate(d[:, j])) * r_inv % Q for j in range(d.shape[1])]


@pytest.fixture(scope="module")
def cases(affine_env_off):
    """The JAX side, run once: phase 1, the batch inverse and phase 3 of
    the JAX package on the level-0 pairs."""
    pts, sgn = level0_pairs()
    rows = C.pack_rows_u8(pts, "g1", BLS12_381)
    assert rows.shape == (2 * PAIRS, 2 * D + 1)
    assert np.array_equal(rows, pack_rows_u8_host(get_plane_curve(J_BLS), pts))
    rw = rows_pad_width(J_BLS, "g1")
    padded = np.zeros((2 * PAIRS, rw), np.uint8)
    padded[:, : rows.shape[1]] = rows
    blk = jnp.asarray(padded.reshape(PAIRS, 2 * rw))
    sg = jnp.asarray(sgn.reshape(PAIRS, 2).T.astype(np.float32))
    phase1, phase3, tree = _get_kernels(J_BLS, 256, None, "g1", True)
    den, preds = phase1(blk, sg)
    pc = get_plane_curve(J_BLS)
    dinv = jax.jit(lambda d: batch_inverse_planes(pc, "g1", d, tree, 256))(den)
    out = np.asarray(phase3(blk, sg, dinv, preds)).astype(np.uint8)
    return {
        "rows": torch.as_tensor(rows),
        "sgn": torch.as_tensor(sgn),
        "den": wide_values(den),
        "preds": np.asarray(preds),
        "dinv": wide_values(dinv),
        "out": out[:, : rows.shape[1]],
    }


@pytest.fixture(scope="module")
def affine_env_off():
    """The JAX kernels are built with the scan/affine switch pinned off:
    another test file may leave SNARK_TPU_MSM_AFFINE set in the process."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SNARK_TPU_MSM_AFFINE", "0")
    yield mp
    mp.undo()


def test_bls_phase1_matches_jax(cases):
    den, cls = A.affine_phase1(cases["rows"], cases["sgn"], "g1", BLS12_381)
    assert den.shape == (PAIRS, 1, 12)
    assert BLS_FQ.decode(den) == cases["den"]
    dead, copy_l, copy_r, dbl = cases["preds"]
    c = cls.numpy()
    assert np.array_equal(c == A.DEAD, dead == 1)
    assert np.array_equal(c == A.COPY_L, copy_l == 1)
    assert np.array_equal(c == A.COPY_R, copy_r == 1)
    assert np.array_equal(c == A.DOUBLE, dbl == 1)
    assert set(c.tolist()) == {A.ADD, A.DOUBLE, A.DEAD, A.COPY_L, A.COPY_R}
    # lanes that compute nothing divide by one, never by zero
    one = BLS_FQ.decode(den[c >= A.DEAD])
    assert one == [1] * len(one)


def test_bls_inverse_matches_jax_and_host(cases):
    """The batch inverse (K7 both modes) against JAX; the root inverse in
    Fq and Fq2 against the host field, 0 included (it maps to 0)."""
    den, _ = A.affine_phase1(cases["rows"], cases["sgn"], "g1", BLS12_381)
    dinv = BLS_FQ.decode(A.batch_inverse(den, "g1", BLS12_381))
    assert dinv == cases["dinv"]
    assert all(d * i % Q == 1 for d, i in zip(cases["den"], dinv))
    rng = random.Random(17)
    xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(5)]
    got = A.affine_inverse(BLS_FQ.tensor(xs, "cpu")[:, None], "g1", BLS12_381)
    assert BLS_FQ.decode(got) == [pow(x, -1, Q) if x else 0 for x in xs]
    f2 = HostFq2(Q)
    ys = [(0, 0), (1, 0), (0, 1)] + [(rng.randrange(Q), rng.randrange(Q)) for _ in range(5)]
    flat = [v for y in ys for v in y]
    got = A.affine_inverse(BLS_FQ.tensor(flat, "cpu").reshape(-1, 2, 12), "g2", BLS12_381)
    vals = BLS_FQ.decode(got)
    inv = [(vals[2 * i], vals[2 * i + 1]) for i in range(len(ys))]
    assert inv[0] == (0, 0)
    assert inv[1:] == [f2.inv(y) for y in ys[1:]]
    assert all(f2.mul(y, i) == (1, 0) for y, i in zip(ys[1:], inv[1:]))


def test_bls_phase3_rows_match_jax(cases):
    """Byte for byte: the port writes canonical rows in the key's form."""
    rows, sgn = cases["rows"], cases["sgn"]
    den, cls = A.affine_phase1(rows, sgn, "g1", BLS12_381)
    out = A.affine_phase3(rows, sgn, A.batch_inverse(den, "g1", BLS12_381), cls, "g1", BLS12_381)
    assert np.array_equal(out.numpy(), cases["out"])
    # canonical: the two top bytes of every component are zero and every
    # value is below q
    comps = out[:, :-1].reshape(PAIRS, 2, D).numpy()
    assert not comps[:, :, 48:].any()
    assert all(int.from_bytes(v.tobytes(), "little") < Q for v in comps.reshape(-1, D))
    # the rows decode to the pairwise sums
    pts, s = level0_pairs()
    pts = [HG1.neg(p) if f else p for p, f in zip(pts, s)]
    want = [HG1.add(pts[2 * j], pts[2 * j + 1]) for j in range(PAIRS)]
    assert C.rows_to_points(out.numpy(), "g1", BLS12_381) == want


def host_msm(hc, pts, scalars):
    """Σ s_i·P_i, one scalar multiplication per distinct point."""
    agg = {}
    for s, p in zip(scalars, pts):
        if p is not None:
            agg[p] = (agg.get(p, 0) + s) % R
    return hc.msm(list(agg), list(agg.values()))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_affine_msm_matches_host(group):
    """G1: n = 512, unsigned c = 6 (mean 8 per bucket, the gate's edge,
    B0 = 4). G2: n = 256, signed c = 5 (cb = 4, 16 per bucket, B0 = 4).
    The pools repeat a few points with their negations and identity rows,
    and every eighth scalar is shared, so level 0 holds every class of
    pair. (The device combine on BLS12-381 is held in
    `tests/test_torch_bls_combine.py`.)"""
    hc = HG1 if group == "g1" else HG2
    rng = random.Random(11)
    n, c, signed = (512, 6, False) if group == "g1" else (256, 5, True)
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(3)]
    pool = base + [hc.neg(p) for p in base] + [None, base[0]]
    pts = [pool[i % 8] for i in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[:3] = [0, 1, R - 1]
    shared = rng.randrange(R)
    for i in range(0, n, 8):
        scalars[i] = shared
    plan = PlaneMsm(c, BLS12_381.fr.num_bits, group, signed=signed, affine=True, curve=BLS12_381)
    assert plan.uses_affine(n)
    table = torch.as_tensor(C.pack_rows_u8(pts, group, BLS12_381))
    std = BLS_FR.tensor(scalars, "cpu", mont=False)
    digits = (signed_digits if signed else unsigned_digits)(std, c, BLS12_381.fr.num_bits)
    perm, start, length = plan._buckets(digits.t().contiguous())
    rows, sgn, _, _, _ = A.AffineAccum(plan).blocks(table, perm, start, length, n, n // plan.nb)
    _, cls = A.affine_phase1(rows, sgn, group, BLS12_381)
    assert set(cls.tolist()) == {A.ADD, A.DOUBLE, A.DEAD, A.COPY_L, A.COPY_R}
    assert plan.msm_host(table, digits, hc) == host_msm(hc, pts, scalars)
