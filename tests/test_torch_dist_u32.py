"""The port's legacy distributed MSM and NTT (`parallel/dist_msm.py`
`sharded_msm`, `parallel/dist_ntt.py` `DistNttPlan`) at two and four gloo
ranks on the CPU, against the JAX package's single-device legacy MSM and
NTT plan (`snark_tpu/ops/msm.py` `msm_host_combine`, `ops/ntt.py`
`get_ntt_plan`), not its `DistNttPlan`, whose `shard_map` can SIGSEGV in
full-suite order (`tests/test_parallel.py`; the reference holds its
`DistNttPlan` equal to `get_ntt_plan` there).

Both worlds are spawned at once by `parallel/launch.py` `run_ranks`
(`run_each`: the MSM, then the transforms, in one world) while the JAX
oracles run in this process. The MSM: 32 BN254 G1 points, c = 4, each rank
its contiguous block. The NTT: n1 = n2 = 4 (n = 16), each rank its block of
the natural order; fft and coset_fft against the reference's, ifft and
coset_ifft as round trips.

Tolerance: none: every rank's MSM total equals the host MSM and the
reference's after normalization (the sum of rank partials is another
projective representative than the one-device sum); the transforms'
shards, concatenated in rank order, equal the reference's limb for limb.
"""

import concurrent.futures
import importlib
import random

import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254

from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.ops.curve_u32 import get_g1_ops
from snark_tpu_torch.ops.ntt_u32 import get_ntt_plan
from snark_tpu_torch.parallel import dist_msm as DM
from snark_tpu_torch.parallel import dist_ntt as DN
from snark_tpu_torch.parallel.launch import run_each, run_ranks

from test_torch_msm_u32 import C, msm_case

JM = importlib.import_module("snark_tpu.ops.msm")
JN = importlib.import_module("snark_tpu.ops.ntt")
N1 = N2 = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    hc, ops, jops, pts, scalars, _, digits = msm_case(BN254, J_BN254, "g1", 3)
    rng = random.Random(8)
    vals = [rng.randrange(BN254.fr.modulus) for _ in range(N1 * N2)]
    coeffs = get_ntt_plan(BN254.fr, N1 * N2, device="cpu").df.array(vals).numpy()
    return {"hc": hc, "jops": jops, "pts": pts, "scalars": scalars, "digits": digits,
            "points": ops.to_numpy(ops.pack_affine_host(pts)), "vals": vals, "coeffs": coeffs}


@pytest.fixture(scope="module")
def worlds(case):
    calls = [(DM.dist_sharded_msm, (case["points"], case["digits"], C, "g1", "bn254", "cpu")),
             (DN.dist_legacy_transforms, (case["coeffs"], N1, N2, "bn254", "cpu"))]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        yield {r: ex.submit(run_ranks, run_each, r, "cpu", *calls, timeout_s=240) for r in (2, 4)}


@pytest.fixture(scope="module")
def oracle(case, worlds):
    """The reference's one-device MSM and transforms (computed while the
    worlds run)."""
    jops, hc = case["jops"], case["hc"]
    total = JM.msm_host_combine(jops, hc, jops.pack_affine_host(case["pts"]), case["digits"], C)
    plan = JN.get_ntt_plan(J_BN254.fr, N1 * N2)
    x = plan.df.array(case["vals"])
    return total, {"fft": np.asarray(plan.fft(x)), "coset_fft": np.asarray(plan.coset_fft(x))}


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_msm_and_dist_ntt(ranks, case, worlds, oracle):
    """Every rank's `sharded_msm` total is the host MSM and the reference's;
    `DistNttPlan.fft` and `coset_fft`, shards in rank order, equal the
    reference's one-device plan limb for limb, and `ifft` and `coset_ifft`
    give the coefficients back."""
    total, ntt = oracle
    results = worlds[ranks].result()
    assert len(results) == ranks
    ops = get_g1_ops(BN254, "cpu")
    want = case["hc"].msm(case["pts"], case["scalars"])
    assert want == total
    for msm_total, _ in results:
        assert msm_total.shape == (3, ops.K) and msm_total.dtype == np.uint32
        assert ops.to_affine_host(msm_total[None]) == [want]
    shards = {k: np.concatenate([res[1][k] for res in results]) for k in results[0][1]}
    for name in ("fft", "coset_fft"):
        assert np.array_equal(shards[name].view(np.uint32), ntt[name].astype(np.uint32)), name
    assert np.array_equal(shards["ifft"], case["coeffs"])
    assert np.array_equal(shards["coset_ifft"], case["coeffs"])
