"""`snark_tpu_torch/bench_field.py` on the CPU: every line of the field
micro-benchmark through the plain versions, against the host oracle and
the JAX package's `DeviceField`.

Tolerance: exact. Each line computes the canonical chained product, so its
16-bit limbs must equal the oracle's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.device import get_device_field as j_get_device_field

from snark_tpu_torch import bench_field as BF
from snark_tpu_torch.fields.params import BLS12_381, BN254


@pytest.mark.parametrize("field", [BN254.fr, BLS12_381.fr], ids=["bn254_fr", "bls12_381_fr"])
def test_all_lines_equal_the_oracle(field):
    res = BF.run(log_n=8, device="cpu", field=field)
    assert res["correct"] and res["device"] == "cpu" and res["n"] == 256
    assert [rec["impl"] for rec in res["lines"]] == list(BF.IMPLS)
    for rec in res["lines"]:
        assert rec["correct"], rec
        assert rec["ms_per_mul_batch"] is None  # a CPU run times nothing


def test_oracle_and_inputs_match_jax_device_field():
    """The script's pairs, tiled, chained 4 and 8 deep through the JAX
    `DeviceField.mul`, equal the oracle."""
    a, b = BF.inputs(BN254.fr, 9)
    assert a.shape == (512, 16) and np.array_equal(a[:256], a[256:])
    df = j_get_device_field(J_BN254.fr)
    x = jnp.asarray(a[:256])
    for depth in range(1, 9):
        x = df.mul(x, jnp.asarray(b[:256]))
        if depth in (4, 8):
            assert np.array_equal(np.asarray(x), BF.oracle(BN254.fr, depth))


def test_run_refuses_bad_arguments():
    with pytest.raises(ValueError):
        BF.run(log_n=7, device="cpu")
    with pytest.raises(ValueError):
        BF.run(log_n=8, impls=("pallas9",), device="cpu")
    with pytest.raises(ValueError):
        BF.run(log_n=8, field=BN254.fq, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            BF.main(["8", "u32"])
