"""The port's legacy MSM (`snark_tpu_torch/ops/msm_u32.py`) in BN254 G2
against the JAX package's `snark_tpu/ops/msm.py`, on the CPU (the plain
versions of K2 and K18), at N = 32 points, c = 4.

Tolerance: none. `MsmPlan.window_sums` equals the reference's limb for
limb, `msm_host_combine` the reference's and the host MSM, `msm` the host
MSM after normalization (the reference's jitted G2 window sums compile
for about 29 s, its whole G2 `msm` for 38 s more, so only the sums run).
"""

import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254

from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.ops import msm_u32 as MU

from test_torch_msm_u32 import C, check_sums_and_host_combine


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_msm_bn254_g2():
    """Window sums limb for limb, `msm_host_combine` equal to the
    reference's and the host MSM, `msm` equal to the host MSM."""
    (_, ops, _, pts, _, limbs, _), want = check_sums_and_host_combine(BN254, J_BN254, "g2", 2)
    got = MU.msm(ops, ops.pack_affine_host(pts), limbs, BN254.fr.num_bits, c=C)
    assert ops.to_affine_host(got[None]) == [want]
