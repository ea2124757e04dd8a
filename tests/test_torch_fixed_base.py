"""The port's fixed-base walk (`ops/fixed_base.py`, K1's plain version)
and affine codec (`ops/affine_codec.py`, K7's) against the JAX package's
host packings over host scalar multiplications, in G1 and G2 on both
curves, at the scalars 0, 1, r − 1 and random ones: the u8 rows equal
`pack_rows_u8_host`, the legacy query equals `pack_affine_host`. The
codec also takes points with Z = 0 lanes and Z ≠ 1, and the BN254 G1 walk
runs beside the JAX `PlaneFixedBase.rows_and_query` (interpret mode, about
20 s; G2's would take longer), over several chunks of lanes.
"""

import random

import numpy as np
import pytest
import torch

from snark_tpu.fields.params import BLS12_381 as J_BLS, BN254 as J_BN254
from snark_tpu.ops.curve import get_g1_ops, get_g2_ops
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host
from snark_tpu_torch.fields.limbs import fields_of
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import affine_codec as AC
from snark_tpu_torch.ops import fixed_base as FB
from snark_tpu_torch.ops.curve import points_to_limbs
from snark_tpu_torch.ops.fixed_base import FixedBase

CURVES = {"bn254": (J_BN254, BN254), "bls12_381": (J_BLS, BLS12_381)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def edge_scalars(r: int, n: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    return [0, 1, r - 1, 2, r - 2] + [rng.randrange(r) for _ in range(n - 5)]


def host_reference(jax_curve, group, points):
    """The JAX package's packings of host affine points."""
    ops = get_g1_ops(jax_curve) if group == "g1" else get_g2_ops(jax_curve)
    return (pack_rows_u8_host(get_plane_curve(jax_curve), points, group),
            np.asarray(ops.pack_affine_host(points)))


@pytest.mark.parametrize("name", list(CURVES))
def test_walk_and_codec_equal_host(name):
    jax_curve, curve = CURVES[name]
    fr = fields_of(curve)[0]
    scalars = edge_scalars(fr.p, 12, 1)
    std = fr.tensor(scalars, "cpu", mont=False)
    for group in ("g1", "g2"):
        hc = host_g1(jax_curve) if group == "g1" else host_g2(jax_curve)
        want_rows, want_query = host_reference(
            jax_curve, group, [hc.scalar_mul(hc.generator, s) for s in scalars])
        rows, query = AC.convert(FixedBase(curve, group, "cpu").walk(std), group, curve)
        assert np.array_equal(rows.numpy(), want_rows), group
        assert query.dtype == want_query.dtype and np.array_equal(query, want_query), group


def test_codec_zero_and_unnormalised_z():
    """Projective inputs (λx, λy, λ) with random λ (an Fq2 λ in G2) and
    identity lanes (0, λ, 0), next to each other and at the ends."""
    rng = random.Random(4)
    for jax_curve, curve in CURVES.values():
        fq = fields_of(curve)[1]
        r = curve.fr.modulus
        for group in ("g1", "g2"):
            hc = host_g1(jax_curve) if group == "g1" else host_g2(jax_curve)
            pts = [None, None] + [hc.scalar_mul(hc.generator, rng.randrange(1, r))
                                  for _ in range(9)] + [None]
            pts[6] = None
            K = 1 if group == "g1" else 2
            P = points_to_limbs(pts, group, "cpu", curve)  # Z = 1, the identity (0, 1, 0)
            lam = fq.tensor([rng.randrange(1, fq.p) for _ in range(len(pts) * K)], "cpu")
            lam = lam.reshape(len(pts), K, -1)
            P = torch.stack([AC.affine_tree_mul(P[:, c].contiguous(), lam, group, curve=curve)
                             for c in range(3)], dim=1)
            assert not bool((P[:, 2] == points_to_limbs(pts, group, "cpu", curve)[:, 2]).all())
            rows, query = AC.convert(P, group, curve)
            want_rows, want_query = host_reference(jax_curve, group, pts)
            assert np.array_equal(rows.numpy(), want_rows)
            assert np.array_equal(query, want_query)
            assert AC.query_to_points(AC.projective_query(P), group, curve) == pts


def test_legacy_walk_equals_walk():
    """The reference's legacy chain (complete additions from the identity,
    identity rows included) gives the same points as the K1 walk, in
    other projective coordinates (BN254; the legacy chain's coordinates on
    both curves are held against the JAX keys in test_torch_setup.py)."""
    fr = fields_of(BN254)[0]
    std = fr.tensor(edge_scalars(fr.p, 8, 2), "cpu", mont=False)
    for group in ("g1", "g2"):
        fb = FixedBase(BN254, group, "cpu")
        legacy, walk = fb.walk_legacy(std), fb.walk(std)
        assert not torch.equal(legacy, walk)
        assert torch.equal(AC.convert(legacy, group, BN254)[0], AC.convert(walk, group, BN254)[0])


def test_bn254_g1_equals_jax_plane_fixed_base(monkeypatch):
    """The port's walk in chunks of 10 lanes (24 = 10 + 10 + 4: one K1
    launch a chunk, the outputs concatenated), the JAX one in 32."""
    from snark_tpu.ops.fixed_base_plane import PlaneFixedBase

    scalars = edge_scalars(J_BN254.fr.modulus, 24, 17)
    want_rows, want_query = PlaneFixedBase(J_BN254, "g1", chunk=32).rows_and_query(scalars)
    monkeypatch.setattr(FB, "CHUNK", 10)
    std = fields_of(BN254)[0].tensor(scalars, "cpu", mont=False)
    rows, query = AC.convert(FixedBase(BN254, "g1", "cpu").walk(std), "g1", BN254)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(query, np.asarray(want_query))
