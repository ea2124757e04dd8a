"""The port's distributed MSM (`parallel/plane_dist.py` `DistPlaneMsm`) on
its window-block path, against the JAX package, on the CPU.

Each world of ranks is spawned by `parallel/launch.py` `run_ranks` on
gloo, every rank running the plain versions of the kernels on its row
block; the JAX oracle runs in this process. G1 has the reference's shape
(`tests/test_plane_dist.py`): 512 BN254 points tiled from a pool of 16, at
c = 8 (W = 32, so two and four ranks exchange bucket accumulators by window
block, sum them and fold their block with `fold_block`), held against the
JAX `PlaneMsm.window_sums`; G2 takes the same path at c = 4 (W = 64) on 128
points from a pool of 8, held against the host MSM (a JAX G2 plane MSM
compiles for about 80 s, and the plain G2 folds cost three times G1's a
lane). The totals path is in `test_torch_dist_totals.py` (each JAX oracle
compiles for about 18 s).
"""

import concurrent.futures
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.host import Fp
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.ops.msm import scalars_to_digits_signed
from snark_tpu.ops.msm_plane import get_plane_msm
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_rows_u8_host, unpack_points_host
from snark_tpu_torch.ops.curve import limbs_to_points
from snark_tpu_torch.ops.msm_plane import PlaneMsm
from snark_tpu_torch.parallel import plane_dist as PD
from snark_tpu_torch.parallel.launch import run_each, run_ranks

R = J_BN254.fr.modulus
NBITS = J_BN254.fr.num_bits
CASES = {"g1": (8, 512, 16), "g2": (4, 128, 8)}  # c, points, pool
HOSTS = {"g1": host_g1(J_BN254), "g2": host_g2(J_BN254)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    """Per group: the u8 table, the pool, the scalars, the signed digits."""
    rng = random.Random(11)
    out = {}
    for g, (c, n, size) in CASES.items():
        hc = HOSTS[g]
        pool = [hc.scalar_mul(hc.generator, k + 1) for k in range(size)]
        scalars = [rng.randrange(R) for _ in range(n)]
        digits = np.asarray(scalars_to_digits_signed(Fp(J_BN254.fr).to_limbs_array(scalars), c,
                                                     NBITS)).astype(np.int32)
        table = pack_rows_u8_host(get_plane_curve(J_BN254), [pool[i % size] for i in range(n)], g)
        out[g] = table, pool, scalars, digits
    return out


@pytest.fixture(scope="module")
def worlds(inputs):
    """{ranks: the future of every rank's window sums of both groups}: the
    worlds of two and four ranks, started together in the background so
    that they run while the JAX oracle compiles."""
    calls = [(PD.dist_window_sums, (inputs[g][0], inputs[g][3], c, g, "bn254", "cpu"))
             for g, (c, _, _) in CASES.items()]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        yield {r: ex.submit(run_ranks, run_each, r, "cpu", *calls, timeout_s=240) for r in (2, 4)}


@pytest.fixture(scope="module")
def jax_g1_sums(inputs):
    """The JAX `PlaneMsm.window_sums` in G1 (interpret mode, projective
    scan), as host affine points."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SNARK_TPU_MSM_AFFINE", "0")
        table, _, _, digits = inputs["g1"]
        plan = get_plane_msm(J_BN254, CASES["g1"][0], tile=32, interpret=True, signed=True)
        tX, tY, tZ = (np.asarray(t)[:, : plan.W]
                      for t in plan.window_sums(jnp.asarray(table), digits))
        return unpack_points_host(plan.pc, tX, tY, tZ)


def host_msm(g, pool, scalars):
    """The host MSM of the tiled table, one term a pool point."""
    agg = [0] * len(pool)
    for i, s in enumerate(scalars):
        agg[i % len(pool)] = (agg[i % len(pool)] + s) % R
    return HOSTS[g].msm(pool, agg)


@pytest.mark.parametrize("size", [2, 4])
def test_dist_msm_block_path(size, worlds, inputs, jax_g1_sums):
    """Every rank holds the same window totals, by the block path; in G1
    they equal the JAX plane MSM's (as affine points); in both groups their
    Horner combine equals the host MSM."""
    results = worlds[size].result()
    for k, (g, (c, _, _)) in enumerate(CASES.items()):
        sums, block = results[0][k]
        assert block and PlaneMsm(c).W % size == 0
        for res in results[1:]:
            assert torch.equal(res[k][0], sums)
        if g == "g1":
            assert limbs_to_points(sums) == jax_g1_sums
        _, pool, scalars, _ = inputs[g]
        assert PlaneMsm(c, group=g).combine_host(sums, HOSTS[g]) == host_msm(g, pool, scalars)
