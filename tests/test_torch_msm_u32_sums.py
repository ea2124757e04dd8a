"""The port's legacy MSM window sums and `msm_host_combine`
(`snark_tpu_torch/ops/msm_u32.py`) in G1 of BN254 and BLS12-381 against
the JAX package's `snark_tpu/ops/msm.py`, on the CPU (the plain versions of
K2), at N = 32 points, c = 4.

Tolerance: none. `MsmPlan.window_sums` equals the reference's limb for
limb, `msm_host_combine` the reference's and the host MSM (the
reference's whole `msm` is compiled for BN254 G1 alone, in
`tests/test_torch_msm_u32.py`: it takes about 20 s a group).
"""

import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254

from snark_tpu_torch.fields.params import BLS12_381, BN254

from test_torch_msm_u32 import check_sums_and_host_combine


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_window_sums_bn254_g1():
    """BN254 G1: window sums limb for limb, `msm_host_combine` equal to the
    reference's and the host MSM (the points and digits as the reference's
    numpy arrays)."""
    check_sums_and_host_combine(BN254, J_BN254, "g1", 1)


def test_window_sums_bls12_381_g1():
    """BLS12-381 G1: as BN254."""
    check_sums_and_host_combine(BLS12_381, J_BLS12_381, "g1", 2)
