"""The port's legacy device curve API (`snark_tpu_torch/ops/curve_u32.py`:
`CurveOps`, `DeviceFq2`, `get_g1_ops`) against the JAX package's
`snark_tpu/ops/curve.py`, on the CPU, where the port's group operations
run the plain versions of K2 `point_add` and K5 `point_double`; G2 is in
`tests/test_torch_curve_u32_g2.py` and `test_torch_curve_u32_g2_bls.py`, which share `check_group`, and the
f32 layout in `tests/test_torch_ntt_u32.py`.

Tolerance: none. Both sides hold canonical Montgomery limbs in the same
layout (16-bit limbs, R = 2^(16·num_limbs)), so packed points, sums,
doublings, negations, selections and every `DeviceFq2` result compare limb
for limb (the same complete formulas give the same projective
coordinates); group elements are also compared with the host curve after
normalization. The JAX side runs jitted on one batch shape a group (its
eager `_impl` bodies compile every primitive on first use, which took
longer); its `scalar_mul_const` chain runs on its jitted add and double.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops import curve as JC

from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import curve_u32 as CU
from snark_tpu_torch.ops.curve_host import host_g1

CURVES = [(BN254, J_BN254), (BLS12_381, J_BLS12_381)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """A JAX array or a port tensor as uint32 numpy limbs."""
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _points(hc, seed: int):
    """Multiples of the generator, one repeated, the identity, and the
    negation of the first: sums meet doublings, inverses and the identity."""
    rng = random.Random(seed)
    pts = [hc.scalar_mul(hc.generator, k) for k in (1, 2, 7, rng.getrandbits(100))]
    return pts + [pts[1], None, hc.neg(pts[0])]


def _ref_scalar_mul(jax_ops, jp, e: int):
    """The reference's `scalar_mul_const` chain on its jitted add and double
    (its unrolled `_impl` chain, without a compile for each e)."""
    if e == 0:
        return jax_ops.identity_like(jp.shape[:-2])
    r = jp
    for bit in bin(e)[3:]:
        r = jax_ops.double(r)
        if bit == "1":
            r = jax_ops.add(r, jp)
    return r


def check_group(port_ops, jax_ops, hc, seed: int) -> None:
    pts = _points(hc, seed)
    p = port_ops.pack_affine_host(pts)
    jp = jax_ops.pack_affine_host(pts)
    assert np.array_equal(_np(p), _np(jp))
    q = torch.roll(p, 1, 0)
    jq = jnp.roll(jp, 1, axis=0)
    rolled = pts[-1:] + pts[:-1]
    # add: every pair, doublings (equal operands), inverses, the identity
    s = port_ops.add(p, q)
    assert np.array_equal(_np(s), _np(jax_ops.add(jp, jq)))
    assert port_ops.to_affine_host(s) == [hc.add(a, b) for a, b in zip(pts, rolled)]
    assert port_ops.to_affine_host(port_ops.add(p, p)) == [hc.double(a) for a in pts]
    d = port_ops.double(p)
    assert np.array_equal(_np(d), _np(jax_ops.double(jp)))
    assert port_ops.to_affine_host(d) == [hc.double(a) for a in pts]
    n = port_ops.neg_impl(p)
    assert np.array_equal(_np(n), _np(jax.jit(jax_ops.neg_impl)(jp)))
    assert port_ops.to_affine_host(port_ops.add(p, n)) == [None] * len(pts)
    mask = np.arange(len(pts)) % 2 == 0
    sel = port_ops.select(torch.as_tensor(mask), p, q)
    assert np.array_equal(_np(sel), _np(jax_ops.select(jnp.asarray(mask), jp, jq)))
    assert port_ops.is_identity(p).tolist() == np.asarray(jax_ops.is_identity(jp)).tolist()
    assert port_ops.is_identity(port_ops.identity_like((2,))).tolist() == [True, True]
    # scalar_mul_const: the reference's chain, limb for limb
    for e in (0, 1, 6, 2**20 + 5):
        got = port_ops.scalar_mul_const(p, e)
        assert np.array_equal(_np(got), _np(_ref_scalar_mul(jax_ops, jp, e))), e
    assert port_ops.to_affine_host(port_ops.scalar_mul_const(p[:1], 2**64 + 7)) == [
        hc.scalar_mul(pts[0], 2**64 + 7)]
    # the reference's numpy arrays: the same layout, checked
    arr = port_ops.to_numpy(s)
    assert arr.dtype == np.uint32 and np.array_equal(arr, _np(jax_ops.add(jp, jq)))
    assert torch.equal(port_ops.from_numpy(arr), s)
    with pytest.raises(ValueError):
        port_ops.from_numpy(arr[..., :-1])
    with pytest.raises(ValueError):
        port_ops.from_numpy(arr.astype(np.int64))


@pytest.mark.parametrize("curve,jcurve", CURVES, ids=["bn254", "bls12_381"])
def test_g1_ops_match_reference(curve, jcurve):
    """G1: pack, add (every pair, doublings, inverses, the identity),
    double, neg, select, is_identity, scalar_mul_const and the numpy
    converters equal the reference's, limb for limb, and the host curve."""
    check_group(CU.get_g1_ops(curve, "cpu"), JC.get_g1_ops(jcurve), host_g1(curve), 1)


def test_device_fq2_matches_reference():
    """`DeviceFq2` on the port's `DeviceField`: add, sub, neg, double, mul,
    square, inv, const, ZERO, ONE_MONT, is_zero, eq, select equal the
    reference's on both curves, limb for limb."""
    rng = random.Random(3)
    for curve, jcurve in CURVES:
        port = CU.get_g2_ops(curve, "cpu").fq2
        ref = JC.get_g2_ops(jcurve).fq2
        q = curve.fq.modulus
        vals = [(rng.randrange(q), rng.randrange(q)) for _ in range(6)] + [(0, 0), (1, 0)]
        a = torch.cat([port.const(x0, x1)[None] for x0, x1 in vals])
        ja = jnp.concatenate([ref.const(x0, x1, jcurve)[None] for x0, x1 in vals])
        assert np.array_equal(_np(a), _np(ja))
        b, jb = torch.roll(a, 1, 0), jnp.roll(ja, 1, axis=0)
        for name in ("add_impl", "sub_impl", "mul_impl"):
            assert np.array_equal(_np(getattr(port, name)(a, b)),
                                  _np(jax.jit(getattr(ref, name))(ja, jb))), (curve.name, name)
        for name in ("neg_impl", "double_impl", "square_impl", "inv_impl"):
            assert np.array_equal(_np(getattr(port, name)(a)),
                                  _np(jax.jit(getattr(ref, name))(ja))), (curve.name, name)
        assert np.array_equal(_np(port.ZERO), _np(ref.ZERO))
        assert np.array_equal(_np(port.ONE_MONT), _np(ref.ONE_MONT))
        assert port.is_zero(a).tolist() == np.asarray(ref.is_zero(ja)).tolist()
        assert port.eq(a, b).tolist() == np.asarray(ref.eq(ja, jb)).tolist()
        mask = np.arange(len(vals)) % 3 == 0
        assert np.array_equal(_np(port.select(torch.as_tensor(mask), a, b)),
                              _np(ref.select(jnp.asarray(mask), ja, jb)))
