"""Port MSM with the device Horner combine against the JAX package's
`PlaneMsm.msm`, unsigned digits (the signed case and the shared check are
in `test_torch_msm_device.py`).
"""

import pytest
import torch

from test_torch_msm_device import check_device_msm


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_device_msm_unsigned_matches_jax(monkeypatch):
    monkeypatch.setenv("SNARK_TPU_MSM_AFFINE", "0")
    check_device_msm(signed=False)
