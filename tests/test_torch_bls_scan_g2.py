"""The port's BLS12-381 G2 bucket-scan step, K1 `bucket_madd_rows` over
Fq2 with 12-limb Fq, against the JAX package's `make_masked_mixed_add_rows`
(interpret mode) and the host oracle. Apart from `test_torch_bls_curve.py`
because tracing the JAX G2 kernel alone takes about 20 s.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.ops.curve_host import host_g2 as j_host_g2
from snark_tpu.ops.pallas_curve import (
    get_plane_curve,
    make_masked_mixed_add_rows,
    pack_points_host,
    pack_rows_u8_host,
    rows_pad_width,
    unpack_points_host,
)

from snark_tpu_torch.fields.params import BLS12_381 as BLS
from snark_tpu_torch.ops import curve as C


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_bls_k1_g2_matches_jax():
    """One K1 step per lane, with signs, masks, identity accumulators and
    rows, P + (−P) and P + P lanes."""
    hc = j_host_g2(J_BLS)
    n = 16
    rng = random.Random(2)
    P = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(6)]
    Q = [hc.scalar_mul(hc.generator, rng.randrange(1, 1 << 64)) for _ in range(6)]
    P += [None, P[0], P[1], None]
    Q += [P[2], hc.neg(P[0]), P[1], None]
    P += [hc.generator] * (n - len(P))
    Q += [hc.double(hc.generator)] * (n - len(Q))
    nrng = np.random.RandomState(3)
    sign = nrng.rand(n) < 0.5
    active = nrng.rand(n) < 0.8
    active[:10] = True
    sign[:10] = False
    pc = get_plane_curve(J_BLS)
    rows = pack_rows_u8_host(pc, Q, "g2")
    assert np.array_equal(rows, C.pack_rows_u8(Q, "g2", BLS))
    kern = make_masked_mixed_add_rows(J_BLS, tile=n, interpret=True, group="g2")
    w = rows_pad_width(J_BLS, "g2")
    rows_p = np.pad(rows, ((0, 0), (0, w - rows.shape[1])))
    planes = np.stack([active, sign]).astype(np.float32)
    out = kern(*pack_points_host(pc, P, "g2"), jnp.asarray(rows_p), jnp.asarray(planes))
    want = unpack_points_host(pc, *(np.asarray(o) for o in out), group="g2")
    perm = torch.as_tensor(np.arange(n) | (sign.astype(np.int64) << 31)).to(torch.int32)
    got = C.bucket_madd_rows(
        C.points_to_limbs(P, "g2", "cpu", BLS), torch.as_tensor(rows), perm,
        torch.zeros(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
        torch.as_tensor(active.astype(np.int32)), 0, 1, "g2", BLS,
    )
    got = C.limbs_to_points(got, "g2", BLS)
    assert got == want
    Qs = [hc.neg(q) if s else q for q, s in zip(Q, sign)]
    assert got == [hc.add(a, b) if m else a for a, b, m in zip(P, Qs, active)]
