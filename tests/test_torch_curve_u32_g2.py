"""The port's legacy G2 curve ops (`snark_tpu_torch/ops/curve_u32.py`
`G2CurveOps`, `get_g2_ops`) against the JAX package's
`snark_tpu/ops/curve.py` `get_g2_ops`, on the CPU (the plain versions of
K2 and K5), on BN254: the checks of `tests/test_torch_curve_u32.py`
`check_group`. BLS12-381 is in `tests/test_torch_curve_u32_g2_bls.py`
(the reference's jitted G2 add and double take about 22 s to compile for
each curve, so one file a curve keeps each file near 40 s alone).
Tolerance: none (limb for limb, and equal to the host curve
after normalization).
"""

import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops import curve as JC

from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.ops import curve_u32 as CU
from snark_tpu_torch.ops.curve_host import host_g2

from test_torch_curve_u32 import check_group


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("curve,jcurve", [(BN254, J_BN254)], ids=["bn254"])
def test_g2_ops_match_reference(curve, jcurve):
    """G2 over Fq2: pack, add (every pair, doublings, inverses, the
    identity), double, neg, select, is_identity, scalar_mul_const and the
    numpy converters equal the reference's, limb for limb, and the host
    curve; one ops object per curve and device."""
    ops = CU.get_g2_ops(curve, "cpu")
    assert ops.K == 2 * curve.fq.num_limbs and ops is CU.get_g2_ops(curve, "cpu")
    check_group(ops, JC.get_g2_ops(jcurve), host_g2(curve), 2)
