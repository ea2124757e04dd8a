"""The port's legacy Pippenger MSM (`snark_tpu_torch/ops/msm_u32.py`) and
its digit helpers (`ops/msm.py`) against the JAX package's
`snark_tpu/ops/msm.py`, on the CPU (the plain versions of K2 and K18), in
BN254 G1 at N = 32 points, c = 4; the window sums and `msm_host_combine`
in G1 of both curves are in `tests/test_torch_msm_u32_sums.py`, BN254 G2 in
`tests/test_torch_msm_u32_g2.py` (each file under 45 s with a cold JAX
cache).

Tolerance: none. The window sums and the MSM's projective point equal the
reference's limb for limb (the same complete additions in the same order:
a stable sort, the same bucket steps, scans and Horner), and every result
equals the host MSM after normalization; digits equal the reference's
integer for integer. `pick_window` reads SNARK_TPU_MSM_WINDOW, pinned here
with `monkeypatch`. The reference's jitted MSM and window sums compile for
about 18 and 11 s.
"""

import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields import Fp as JFp
from snark_tpu.ops import curve as JC

from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.ops import msm_u32 as MU
from snark_tpu_torch.ops.curve_host import host_g1, host_g2
from snark_tpu_torch.ops.curve_u32 import get_g1_ops, get_g2_ops

# the modules, not the `msm` functions both packages export beside them
JM = importlib.import_module("snark_tpu.ops.msm")
M = importlib.import_module("snark_tpu_torch.ops.msm")
N, C = 32, 4


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


def msm_case(curve, jcurve, group: str, seed: int):
    """N random points (small multiples of the generator), N scalars
    (one zero, one r − 1), the ops of both packages, the limbs and digits."""
    hc = host_g1(curve) if group == "g1" else host_g2(curve)
    ops = (get_g1_ops if group == "g1" else get_g2_ops)(curve, "cpu")
    jops = (JC.get_g1_ops if group == "g1" else JC.get_g2_ops)(jcurve)
    rng = random.Random(seed)
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, 2**30)) for _ in range(N - 1)] + [None]
    r = curve.fr.modulus
    scalars = [rng.randrange(r) for _ in range(N - 2)] + [0, r - 1]
    limbs = JFp(jcurve.fr).to_limbs_array(scalars)
    digits = JM.scalars_to_digits(limbs, C, curve.fr.num_bits)
    return hc, ops, jops, pts, scalars, limbs, digits


def check_sums_and_host_combine(curve, jcurve, group: str, seed: int):
    """Window sums limb for limb and `msm_host_combine` equal to the
    reference's and the host MSM -> (the case, the host MSM)."""
    case = msm_case(curve, jcurve, group, seed)
    hc, ops, jops, pts, scalars, limbs, digits = case
    want = hc.msm(pts, scalars)
    P, jP = ops.pack_affine_host(pts), jops.pack_affine_host(pts)
    sums = MU.get_msm_plan(ops, C).window_sums(P, digits)
    jsums = JM.get_msm_plan(jops, C).window_sums(jP, jnp.asarray(digits))
    assert sums.shape == jsums.shape == (-(-curve.fr.num_bits // C), 3, ops.K)
    assert np.array_equal(_np(sums), _np(jsums))
    got = MU.msm_host_combine(ops, hc, ops.to_numpy(P), digits, C)
    assert got == JM.msm_host_combine(jops, hc, jP, digits, C) == want
    return case, want


def test_msm_bn254_g1_matches_reference():
    """BN254 G1: `msm` equals the reference's limb for limb and the host
    MSM; `msm_device_digits` (digits already a tensor) on 31 points, padded
    to 32 with an identity point and zero digits, equals the host MSM (the
    window sums and `msm_host_combine`: `tests/test_torch_msm_u32_sums.py`)."""
    hc, ops, jops, pts, scalars, limbs, digits = msm_case(BN254, J_BN254, "g1", 1)
    want = hc.msm(pts, scalars)
    got = MU.msm(ops, ops.pack_affine_host(pts), limbs, BN254.fr.num_bits, c=C)
    ref = JM.msm(jops, jops.pack_affine_host(pts), limbs, BN254.fr.num_bits, c=C)
    assert np.array_equal(_np(got), _np(ref))
    assert ops.to_affine_host(got[None]) == [want]
    short = MU.msm_device_digits(ops, ops.pack_affine_host(pts[:-1]),
                                 torch.as_tensor(digits[:-1].astype(np.int32)), C)
    assert ops.to_affine_host(short[None]) == [want]


def test_digits_and_window(monkeypatch):
    """`pick_window` (with and without SNARK_TPU_MSM_WINDOW), `scalars_to_digits`,
    `scalars_to_digits_signed` and `digits_from_limbs_device` equal the
    reference's on random, zero, r − 1 and all-ones-limb scalars."""
    monkeypatch.delenv("SNARK_TPU_MSM_WINDOW", raising=False)
    sizes = (1, 4, 32, 33, 2047, 2048, 1 << 20, 1 << 24)
    assert [M.pick_window(n) for n in sizes] == [JM.pick_window(n) for n in sizes]
    monkeypatch.setenv("SNARK_TPU_MSM_WINDOW", "9")
    assert [M.pick_window(n) for n in sizes] == [JM.pick_window(n) for n in sizes]
    assert M.pick_window(1 << 20) == 9
    rng = random.Random(7)
    r = BN254.fr.modulus
    scalars = [rng.randrange(r) for _ in range(60)] + [0, 1, r - 1, (1 << 240) - 1]
    limbs = JFp(J_BN254.fr).to_limbs_array(scalars)
    for c in (1, 4, 7, 8, 13, 16):
        assert np.array_equal(M.scalars_to_digits(limbs, c, 254), JM.scalars_to_digits(limbs, c, 254))
        assert np.array_equal(M.scalars_to_digits_signed(limbs, c, 254),
                              JM.scalars_to_digits_signed(limbs, c, 254)), c
    for c in (1, 2, 4, 8, 16):
        got = M.digits_from_limbs_device(torch.as_tensor(limbs.astype(np.int32)), c, 254)
        assert np.array_equal(got.numpy(), np.asarray(JM.digits_from_limbs_device(
            jnp.asarray(limbs), c, 254)).astype(np.int64)), c
    with pytest.raises(ValueError):
        M.digits_from_limbs_device(torch.as_tensor(limbs.astype(np.int32)), 3, 254)


def test_fixed_base_plan_matches_reference():
    """`FixedBasePlan` (c = 4): the table equals the reference's `make_table`
    limb for limb, and the product [s_i]·G equals the reference's limb for
    limb and the host scalar multiplications; it runs the setup's legacy
    chain (`ops/fixed_base.py` `table_walk`)."""
    hc, ops, jops = host_g1(BN254), get_g1_ops(BN254, "cpu"), JC.get_g1_ops(J_BN254)
    plan, jplan = MU.FixedBasePlan(ops, 4), JM.FixedBasePlan(jops, 4)
    table = plan.make_table(hc.generator, hc, 254, ops.pack_affine_host)
    jtable = jplan.make_table(hc.generator, hc, 254, jops.pack_affine_host)
    assert table.shape == (64, 16, 3, ops.K) and np.array_equal(_np(table), _np(jtable))
    rng = random.Random(5)
    r = BN254.fr.modulus
    scalars = [rng.randrange(r) for _ in range(6)] + [0, r - 1]
    digits = JM.scalars_to_digits(JFp(J_BN254.fr).to_limbs_array(scalars), 4, 254)
    got = plan(table, digits)
    assert np.array_equal(_np(got), _np(jplan(jtable, digits)))
    assert ops.to_affine_host(got) == [hc.scalar_mul(hc.generator, s) for s in scalars]
