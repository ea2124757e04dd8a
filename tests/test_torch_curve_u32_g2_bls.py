"""The port's legacy G2 curve ops (`snark_tpu_torch/ops/curve_u32.py`
`G2CurveOps`, `get_g2_ops`) against the JAX package's
`snark_tpu/ops/curve.py` `get_g2_ops`, on the CPU (the plain versions of
K2 and K5), on BLS12-381: the checks of `tests/test_torch_curve_u32.py`
`check_group`. BN254 is in `tests/test_torch_curve_u32_g2.py`.
Tolerance: none (limb for limb, and equal to the host curve
after normalization).
"""

import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.ops import curve as JC

from snark_tpu_torch.fields.params import BLS12_381
from snark_tpu_torch.ops import curve_u32 as CU
from snark_tpu_torch.ops.curve_host import host_g2

from test_torch_curve_u32 import check_group


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("curve,jcurve", [(BLS12_381, J_BLS12_381)], ids=["bls12_381"])
def test_g2_ops_match_reference(curve, jcurve):
    """G2 over Fq2: pack, add (every pair, doublings, inverses, the
    identity), double, neg, select, is_identity, scalar_mul_const and the
    numpy converters equal the reference's, limb for limb, and the host
    curve; one ops object per curve and device."""
    ops = CU.get_g2_ops(curve, "cpu")
    assert ops.K == 2 * curve.fq.num_limbs and ops is CU.get_g2_ops(curve, "cpu")
    check_group(ops, JC.get_g2_ops(jcurve), host_g2(curve), 2)
