"""The port's legacy NTT plan (`snark_tpu_torch/ops/ntt_u32.py`) against
the JAX package's `snark_tpu/ops/ntt.py` at n = 64 and 2^10, on the CPU
(K3's and K4's plain versions; n = 8 in `tests/test_torch_ntt_u32.py`).

Tolerance: none (limb for limb). Each size runs two of the reference's
four transforms (its jitted transforms compile for 5-10 s each at these
sizes); the port's round trips cover the other two, which n = 8 holds
against the reference.
"""

import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254

from snark_tpu_torch.fields.params import BLS12_381, BN254

from test_torch_ntt_u32 import check_transforms


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_ntt_1024_bn254():
    """BN254 Fr at 2^10: fft and ifft equal the reference's; the round
    trips give the input back."""
    check_transforms(BN254.fr, J_BN254.fr, 1 << 10, ("fft", "ifft"), seed=1)


def test_ntt_64_bls12_381():
    """BLS12-381 Fr at 64: coset_fft and coset_ifft equal the reference's;
    the round trips give the input back."""
    check_transforms(BLS12_381.fr, J_BLS12_381.fr, 64, ("coset_fft", "coset_ifft"), seed=2)
