"""The port's legacy witness map (`snark_tpu_torch/groth16/qap.py`
`WitnessMapPlan`) against the JAX package's `snark_tpu/groth16/qap.py`
`WitnessMapPlan`, on the CPU (K3's and K4's plain versions), in BN254 Fr at
a domain of 16.

Tolerance: none: the matvec rows and the h coefficients (natural order,
Montgomery form) compare limb for limb. The reference's jitted h pipeline
compiles for about 18 s.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.groth16.qap import PaddedCsr as JPaddedCsr
from snark_tpu.groth16.qap import WitnessMapPlan as JWitnessMapPlan

from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.groth16 import PaddedCsr, WitnessMapPlan

N = 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def test_witness_map_matches_reference():
    """`matvec` of a padded CSR matrix (rows of 0 to 3 entries, the
    reference's arrays carried over by `PaddedCsr.from_reference`) and
    `h_from_evals` of random evaluations equal the reference's limb for
    limb; the last h coefficient of a satisfied system's evaluations is
    zero."""
    rng = random.Random(6)
    r = BN254.fr.modulus
    plan, jplan = WitnessMapPlan(BN254.fr, N, "cpu"), JWitnessMapPlan(J_BN254.fr, N)
    rows = [[(rng.randrange(r), rng.randrange(9)) for _ in range(i % 4)] for i in range(12)]
    jmat = JPaddedCsr.from_rows(rows, J_BN254.fr, 12)
    mat = PaddedCsr.from_reference(np.asarray(jmat.cols), np.asarray(jmat.coeffs), "cpu")
    z = [rng.randrange(r) for _ in range(9)]
    zm, jzm = plan.df.array(z), jplan.df.array(z)
    assert np.array_equal(_np(zm), _np(jzm))
    assert np.array_equal(_np(plan.matvec(mat, zm)), _np(jplan.matvec(jmat, jzm)))
    evals = [plan.df.array([rng.randrange(r) for _ in range(N)]) for _ in range(3)]
    got = plan.h_from_evals(*evals)
    want = jplan.h_from_evals(*(jnp.asarray(_np(e)) for e in evals))
    assert got.shape == (N, plan.df.L) and np.array_equal(_np(got), _np(want))
    # a·b = c on the domain: A·B − C is divisible by Z_H, so h = (A·B −
    # C)/Z_H has degree at most n − 2
    a, b = evals[0], evals[1]
    h = plan.df.to_host_ints(plan.h_from_evals(a, b, plan.df.mul(a, b)))
    assert h[N - 1] == 0 and any(h)
