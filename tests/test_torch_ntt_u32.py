"""The port's legacy NTT plan (`snark_tpu_torch/ops/ntt_u32.py` `NttPlan`,
`get_ntt_plan`) and the host instance map of `groth16/qap.py`
(`lagrange_coeffs_at`, `evaluate_variable_polys_at_tau`) against the JAX
package's `snark_tpu/ops/ntt.py` and `groth16/qap.py`, on the CPU, where
the transforms run K3's and K4's plain versions through `ntt_rows`; and
the legacy API under SNARK_TPU_FIELD_IMPL=f32, in a subprocess.

Tolerance: none: canonical Montgomery limbs compare limb for limb, host
values integer for integer. n = 8 here on both scalar fields (the
reference compiles its four transforms for 9-11 s at n = 8 and 32-38 s at
2^10); n = 64 and 2^10 in `tests/test_torch_ntt_u32_large.py`, the
witness map in `tests/test_torch_witness_map.py`.
"""

import importlib
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields import Fp as JFp

from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import qap as Q
from snark_tpu_torch.ops.ntt_u32 import get_ntt_plan

JN = importlib.import_module("snark_tpu.ops.ntt")
JQ = importlib.import_module("snark_tpu.groth16.qap")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [(BN254.fr, J_BN254.fr), (BLS12_381.fr, J_BLS12_381.fr)]


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


def check_transforms(params, jparams, n: int, names, seed: int = 0, batch: int = 1):
    """The port's and the reference's transforms `names` on the same
    Montgomery vectors (one in `batch` rows for the port), limb for limb;
    every port round trip gives its input back."""
    rng = random.Random(seed)
    plan, jplan = get_ntt_plan(params, n, device="cpu"), JN.get_ntt_plan(jparams, n)
    vals = [rng.randrange(params.modulus) for _ in range(n * batch)]
    x = plan.df.array(vals).reshape(batch, n, -1)
    jx = jplan.df.array(vals[:n])
    assert np.array_equal(_np(x[0]), _np(jx))
    for name in names:
        got = getattr(plan, name)(x)
        assert got.shape == x.shape
        assert np.array_equal(_np(got[0]), _np(getattr(jplan, name)(jx))), (params.name, n, name)
        for b in range(1, batch):  # every row of a batch is its own transform
            assert torch.equal(got[b], getattr(plan, name)(x[b]))
    assert torch.equal(plan.ifft(plan.fft(x)), x)
    assert torch.equal(plan.coset_ifft(plan.coset_fft(x)), x)
    assert plan.z_on_coset() == jplan.z_on_coset()


@pytest.mark.parametrize("params,jparams", FIELDS, ids=["bn254_fr", "bls12_381_fr"])
def test_ntt_n8_matches_reference(params, jparams):
    """n = 8: fft, ifft, coset_fft and coset_ifft equal the reference's
    limb for limb, on a batch of three rows; the round trips and
    z_on_coset."""
    check_transforms(params, jparams, 8, ("fft", "ifft", "coset_fft", "coset_ifft"), batch=3)


def test_instance_map_matches_reference():
    """`batch_inverse`, `lagrange_coeffs_at` (τ off and on the domain) and
    `evaluate_variable_polys_at_tau` (a two-constraint system with an
    input-consistency row) equal the reference's."""
    rng = random.Random(4)
    for params, jparams in FIELDS:
        p = params.modulus
        xs = [rng.randrange(1, p) for _ in range(9)]
        assert Q.batch_inverse(Q.Fp(params), xs) == JQ.batch_inverse(JFp(jparams), xs)
        for n in (8, 32):
            tau = rng.randrange(p)
            assert Q.lagrange_coeffs_at(params, n, tau) == JQ.lagrange_coeffs_at(jparams, n, tau)
            on = params.root_of_unity(n) ** 3 % p
            assert Q.lagrange_coeffs_at(params, n, on) == [int(j == 3) for j in range(n)]
        mats = [[[(3, 1), (5, 2)], [(1, 0)]], [[(1, 2)], [(7, 3)]], [[(1, 3)], [(2, 1), (1, 2)]]]
        tau = rng.randrange(p)
        assert Q.evaluate_variable_polys_at_tau(params, mats, 2, 2, 4, tau) == \
            tuple(JQ.evaluate_variable_polys_at_tau(jparams, mats, 2, 2, 4, tau))


F32_SCRIPT = r"""
import os, random
import numpy as np
import torch
torch.set_num_threads(2)
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.curve import get_g1_ops as j_g1
from snark_tpu_torch.fields.device_f32 import DeviceFieldF32
from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.ops import curve_u32 as CU
from snark_tpu_torch.ops.curve_host import host_g1
from snark_tpu_torch.ops.msm_u32 import msm
from snark_tpu_torch.fields.device import limbs16_encode

ops, jops = CU.get_g1_ops(BN254, "cpu"), j_g1(J_BN254)
assert isinstance(ops.df, DeviceFieldF32) and ops.K == 32
hc = host_g1(BN254)
pts = [hc.scalar_mul(hc.generator, k) for k in (1, 2, 5)] + [None]
p = ops.pack_affine_host(pts)
assert p.dtype == torch.float32
assert np.array_equal(p.numpy(), np.asarray(jops.pack_affine_host(pts)))
s = ops.add(p, torch.roll(p, 1, 0))
assert ops.to_affine_host(s) == [hc.add(a, b) for a, b in zip(pts, pts[-1:] + pts[:-1])]
assert ops.to_affine_host(ops.double(p)) == [hc.double(q) for q in pts]
assert ops.to_numpy(s).dtype == np.float32
rng = random.Random(0)
base = [hc.scalar_mul(hc.generator, k + 1) for k in range(8)]
sc = [rng.randrange(BN254.fr.modulus) for _ in range(8)]
acc = msm(ops, ops.pack_affine_host(base), limbs16_encode(sc, BN254.fr), 254, c=4)
assert ops.to_affine_host(acc[None])[0] == hc.msm(base, sc)
from snark_tpu_torch.ops.ntt_u32 import get_ntt_plan
plan = get_ntt_plan(BN254.fr, 16, device="cpu")
coeffs = [rng.randrange(BN254.fr.modulus) for _ in range(16)]
ev = plan.fft(plan.df.array(coeffs))
assert ev.dtype == torch.float32
w, p = BN254.fr.root_of_unity(16), BN254.fr.modulus
assert plan.df.to_host_ints(ev) == [sum(c * pow(w, i * j, p) for j, c in enumerate(coeffs)) % p
                                    for i in range(16)]
assert plan.df.to_host_ints(plan.coset_ifft(plan.coset_fft(plan.df.array(coeffs)))) == coeffs
print("F32-LEGACY-OK")
"""


def test_f32_layout_subprocess():
    """Under SNARK_TPU_FIELD_IMPL=f32 (in a subprocess, as
    `tests/test_f32_integration.py` runs the reference): the legacy curve
    ops and the NTT plan take the f32 digit field; the packed points equal
    the reference's f32 digits; add, double, an MSM and the transforms
    equal the host (a jitted f32 add of the reference compiles for about
    20 s)."""
    env = dict(os.environ, SNARK_TPU_FIELD_IMPL="f32", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", F32_SCRIPT], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert "F32-LEGACY-OK" in out.stdout, out.stdout + out.stderr
