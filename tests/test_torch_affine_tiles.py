"""The function the tiled K6 (`affine_phase1`) and K8 (`affine_phase3`)
kernels are held to on the card, pinned at the tiles' edge shapes: the
plain versions (`snark_tpu_torch/ops/msm_affine.py`) against the JAX
package's `phase1_kernel` and `phase3_kernel` (JAX-CPU, their emu path) in
BN254 G1, and against host additions in BN254 G2 and BLS12-381 G1 and G2.

A block of the card's kernels takes 128 consecutive pairs; the shapes here
are one pair, 129 pairs (a full tile holding all five classes and a ragged
tile of one), and an odd level-1 input without sign bytes. The JAX phase 3
takes the port's inverses as its digit planes, so no JAX batch inverse is
compiled (`tests/test_torch_affine.py` holds the two inverses equal). JAX
refuses G2 affine on the CPU, and a BLS12-381 compile of the phase kernels
takes longer than such a test should, so those are held against the host.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.msm_affine import _get_kernels
from snark_tpu.ops.pallas_curve import rows_pad_width

from snark_tpu_torch.fields.limbs import fields_of, from_words
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops import msm_affine as A
from snark_tpu_torch.ops.curve_host import host_g1, host_g2

TILE = 128  # pairs a block of the card's K6 and K8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def affine_env_off():
    """The JAX kernels are built with the scan/affine switch pinned off:
    another test file may leave SNARK_TPU_MSM_AFFINE set in the process."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SNARK_TPU_MSM_AFFINE", "0")
    yield mp
    mp.undo()


def host_of(curve, group):
    return host_g1(curve) if group == "g1" else host_g2(curve)


def edge_pairs(hc, r: int, m: int, signed: bool, seed: int):
    """m pairs as (points (2m,), sign bytes (2m,) or None). Signed, every
    8 pairs hold each class: add, double, P + (−P), copy left, copy right,
    a sign that makes a double an inverse pair and one that makes an
    inverse pair a double, and two identities. Unsigned (a level-1 input),
    the six kinds without signs."""
    rng = random.Random(seed)
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(5)]
    kinds = [
        lambda p, q: (p, q, 0, 0),
        lambda p, q: (p, p, 0, 0),
        lambda p, q: (p, hc.neg(p), 0, 0),
        lambda p, q: (p, None, 0, 0),
        lambda p, q: (None, q, 0, 0),
        lambda p, q: (None, None, 0, 0),
    ]
    if signed:
        kinds[5:5] = [lambda p, q: (p, p, 0, 1), lambda p, q: (p, hc.neg(p), 1, 0)]
        kinds[-1] = lambda p, q: (None, None, 1, 1)
    pts, sgn = [], []
    for j in range(m):
        a, b, sa, sb = kinds[j % len(kinds)](base[j % 5], base[(j + 1) % 5])
        pts += [a, b]
        sgn += [sa, sb]
    return pts, (np.asarray(sgn, np.uint8) if signed else None)


def plain_level(pts, sgn, group, curve):
    """Plain K6, the batch inverse and plain K8 on the CPU -> (rows, den,
    dinv, cls, out)."""
    rows = torch.as_tensor(C.pack_rows_u8(pts, group, curve))
    s = None if sgn is None else torch.as_tensor(sgn)
    den, cls = A.affine_phase1_plain(rows, s, group, curve)
    dinv = A.batch_inverse(den, group, curve)
    out = A.affine_phase3_plain(rows, s, dinv, cls, group, curve)
    return rows, den, dinv, cls, out


def want_sums(hc, pts, sgn):
    if sgn is not None:
        pts = [hc.neg(p) if f else p for p, f in zip(pts, sgn)]
    return [hc.add(pts[2 * j], pts[2 * j + 1]) for j in range(len(pts) // 2)]


def want_classes(hc, pts, sgn):
    if sgn is not None:
        pts = [hc.neg(p) if f else p for p, f in zip(pts, sgn)]
    out = []
    for a, b in zip(pts[0::2], pts[1::2]):
        if a is None:
            out.append(A.COPY_R if b is not None else A.DEAD)
        elif b is None:
            out.append(A.COPY_L)
        elif a[0] != b[0]:
            out.append(A.ADD)
        else:
            out.append(A.DOUBLE if a == b else A.DEAD)
    return out


def wide_planes(values, q: int, digits: int) -> np.ndarray:
    """Canonical x -> the JAX (digits, M) f32 planes of x·2^(8·digits)."""
    w = [v * (1 << (8 * digits)) % q for v in values]
    return np.asarray([[(x >> (8 * i)) & 0xFF for x in w] for i in range(digits)], np.float32)


def wide_values(planes, q: int, digits: int) -> list[int]:
    d = np.asarray(planes).astype(np.int64)
    r_inv = pow(1 << (8 * digits), -1, q)
    return [sum(int(v) << (8 * i) for i, v in enumerate(d[:, j])) * r_inv % q
            for j in range(d.shape[1])]


@pytest.mark.parametrize("m,signed", [(1, True), (TILE + 1, True), (63, False)],
                         ids=["one_pair", "tile_plus_one", "level1_odd"])
def test_plain_phases_match_jax(affine_env_off, m, signed):
    """BN254 G1: den, the classes and K8's rows byte for byte against the
    JAX phase kernels, and the rows against host additions."""
    hc = host_g1(BN254)
    q, D = BN254.fq.modulus, C.row_digits(BN254)
    fq = fields_of(BN254)[1]
    pts, sgn = edge_pairs(hc, BN254.fr.modulus, m, signed, seed=m)
    rows, den, dinv, cls, out = plain_level(pts, sgn, "g1", BN254)
    if m == TILE + 1:
        assert set(cls[:TILE].tolist()) == {A.ADD, A.DOUBLE, A.DEAD, A.COPY_L, A.COPY_R}
    assert cls.tolist() == want_classes(hc, pts, sgn)

    rw = rows_pad_width(J_BN254, "g1")
    padded = np.zeros((2 * m, rw), np.uint8)
    padded[:, : rows.shape[1]] = rows.numpy()
    blk = jnp.asarray(padded.reshape(m, 2 * rw))
    s = np.zeros(2 * m, np.uint8) if sgn is None else sgn
    sg = jnp.asarray(s.reshape(m, 2).T.astype(np.float32))
    phase1, phase3, _ = _get_kernels(J_BN254, 256, None, "g1", True)
    jden, preds = phase1(blk, sg)
    assert fq.decode(den) == wide_values(jden, q, D)
    dead, copy_l, copy_r, dbl = np.asarray(preds)
    c = cls.numpy()
    for kind, pred in ((A.DEAD, dead), (A.COPY_L, copy_l), (A.COPY_R, copy_r), (A.DOUBLE, dbl)):
        assert np.array_equal(c == kind, pred == 1)
    jdinv = jnp.asarray(wide_planes(fq.decode(dinv), q, D))
    jout = np.asarray(phase3(blk, sg, jdinv, preds)).astype(np.uint8)
    assert np.array_equal(out.numpy(), jout[:, : rows.shape[1]])
    assert C.rows_to_points(out.numpy(), "g1", BN254) == want_sums(hc, pts, sgn)


@pytest.mark.parametrize("curve,groups", [(BN254, ("g2",)), (BLS12_381, ("g1", "g2"))],
                         ids=["bn254_g2", "bls12_381"])
def test_plain_phases_match_host(curve, groups):
    """G2 and BLS12-381 at one pair, 129 pairs with sign bytes and 63
    without: the classes, den · dinv = 1, and K8's rows equal to host
    additions and canonical (a component's two top bytes zero, its value
    below q)."""
    q, D = curve.fq.modulus, C.row_digits(curve)
    fq = fields_of(curve)[1]
    for group in groups:
        hc = host_of(curve, group)
        K = C.GROUPS[group]
        for m, signed in ((1, True), (TILE + 1, True), (63, False)):
            pts, sgn = edge_pairs(hc, curve.fr.modulus, m, signed, seed=m + K)
            rows, den, dinv, cls, out = plain_level(pts, sgn, group, curve)
            assert cls.tolist() == want_classes(hc, pts, sgn)
            prod = A.affine_tree_mul_plain(den, dinv, group, curve)
            assert torch.equal(prod, from_words(A._field_one(K, fq, "cpu")).expand_as(prod))
            assert out.shape == (m, C.row_bytes(group, curve))
            comps = out[:, :-1].reshape(m, 2 * K, D).numpy()
            assert not comps[:, :, D - 2:].any()
            assert all(int.from_bytes(v.tobytes(), "little") < q for v in comps.reshape(-1, D))
            assert C.rows_to_points(out.numpy(), group, curve) == want_sums(hc, pts, sgn)
