"""K11 (`masked_mixed_add`, `snark_tpu_torch/ops/curve.py`) through its CPU
path (the plain version) against the JAX package's
`ops/pallas_curve.py` `make_masked_mixed_add` in interpret mode, and the
host curve, on both curves in G1 and G2.

The reference takes wide-Montgomery f32 digit planes (R = 2^272 for BN254
Fq, 2^400 for BLS12-381 Fq); the inputs are converted at the boundary from
the same host points, and the outputs compared as affine host points after
normalisation. Tolerance: exact. The cases are complete: P the identity,
P = Q (a doubling), P = −Q (the identity comes out), mask 0; the mask is
clear wherever Q would be the identity, as the reference requires.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.curve_host import host_g1 as j_host_g1
from snark_tpu.ops.curve_host import host_g2 as j_host_g2
from snark_tpu.ops.pallas_curve import (
    get_plane_curve,
    make_masked_mixed_add,
    pack_points_host,
    unpack_points_host,
)

from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import curve as C

CURVES = {"bn254": (J_BN254, BN254), "bls12_381": (J_BLS12_381, BLS12_381)}
N = 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def cases(hc, seed):
    """P, Q (Q never the identity) and the mask, complete cases first."""
    rng = np.random.RandomState(seed)
    pts = [hc.scalar_mul(hc.generator, int(rng.randint(1, 2**62))) for _ in range(8)]
    P = [None, pts[0], pts[1], pts[2]] + [pts[int(i)] for i in rng.randint(0, 8, N - 4)]
    Q = [pts[3], pts[0], hc.neg(pts[1]), pts[4]] + [pts[int(i)] for i in rng.randint(0, 8, N - 4)]
    mask = [True, True, True, False] + list(rng.rand(N - 4) < 0.75)
    return P, Q, mask


def port_madd(P, Q, mask, group, curve):
    q = C.points_to_limbs(Q, group, "cpu", curve)
    out = C.masked_mixed_add(
        C.points_to_limbs(P, group, "cpu", curve), q[:, 0].contiguous(), q[:, 1].contiguous(),
        torch.as_tensor(mask), group, curve,
    )
    return C.limbs_to_points(out, group, curve)


@pytest.mark.parametrize(
    "curve,group", [("bn254", "g1"), ("bn254", "g2"), ("bls12_381", "g1"), ("bls12_381", "g2")],
    ids=["bn254-g1", "bn254-g2", "bls12_381-g1", "bls12_381-g2"],
)
def test_masked_mixed_add_matches_jax(curve, group):
    jc, tc = CURVES[curve]
    hc = (j_host_g1 if group == "g1" else j_host_g2)(jc)
    P, Q, mask = cases(hc, 5)
    pc = get_plane_curve(jc)
    X2, Y2, _ = pack_points_host(pc, Q, group)
    madd = make_masked_mixed_add(jc, tile=N, interpret=True, group=group)
    out = madd(*pack_points_host(pc, P, group), X2, Y2,
               jnp.asarray(np.asarray(mask, np.float32)[None, :]))
    want = unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)
    got = port_madd(P, Q, mask, group, tc)
    assert got == want
    assert got == [hc.add(a, b) if m else a for a, b, m in zip(P, Q, mask)]


def test_equals_k1_step_and_refuses_bad_inputs():
    """K11 on Q decoded from u8 rows (`decode_rows`) equals one K1 step on
    the same rows (BLS12-381 G2); bad shapes and types raise."""
    hc = j_host_g2(J_BLS12_381)
    P, Q, mask = cases(hc, 6)
    rows = torch.as_tensor(C.pack_rows_u8(Q, "g2", BLS12_381))
    x2, y2 = C.decode_rows(rows, "g2", BLS12_381)
    p = C.points_to_limbs(P, "g2", "cpu", BLS12_381)
    lanes = torch.arange(N, dtype=torch.int32)
    k1 = C.bucket_madd_rows(
        p, rows, lanes, torch.zeros(N, dtype=torch.int32), lanes,
        torch.as_tensor(mask).to(torch.int32), 0, 1, "g2", BLS12_381,
    )
    assert torch.equal(C.masked_mixed_add(p, x2, y2, torch.as_tensor(mask), "g2", BLS12_381), k1)
    p = C.identity(4, "g1", "cpu")
    x = torch.zeros((4, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        C.masked_mixed_add(p, x, x[:3], torch.ones(4, dtype=torch.bool), "g1")
    with pytest.raises(ValueError):
        C.masked_mixed_add(p, x, x, torch.ones(4, dtype=torch.int32), "g1")
    with pytest.raises(ValueError):
        C.masked_mixed_add(p, x.to(torch.int64), x, torch.ones(4, dtype=torch.bool), "g1")
