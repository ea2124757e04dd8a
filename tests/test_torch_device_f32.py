"""The port's `DeviceFieldF32` (`snark_tpu_torch/fields/device_f32.py`)
against the JAX package's `fields/device_f32.py`, op for op, on BN254 Fr
(R8 = 32 digits) and BLS12-381 Fq (R8 = 48).

Tolerance: exact. Every intermediate of both is an integer below 2^24,
held exactly in float32, so the digits must be equal, digit for digit.
Inputs come from a numpy seed, with the edges 0, 1 and p − 1.

The reference's ops are called through their `_impl` bodies, eagerly:
jitting each f32 product graph takes about 6 s of compile on the CPU for
BLS12-381 Fq, and after the first eager product the others cost
milliseconds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.device_f32 import get_device_field_f32 as j_get
from snark_tpu.fields.host import Fp as JFp

from snark_tpu_torch.fields.device_f32 import get_device_field_f32
from snark_tpu_torch.fields.params import BLS12_381, BN254

FIELDS = {
    "bn254_fr": (J_BN254.fr, BN254.fr),
    "bls12_381_fq": (J_BLS12_381.fq, BLS12_381.fq),
}


def sample(p: int, n: int, seed: int) -> list[int]:
    rng = np.random.RandomState(seed)
    nbytes = (p.bit_length() + 7) // 8
    return [0, 1, p - 1] + [
        int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n - 3)
    ]


def fields(name):
    jp, tp = FIELDS[name]
    return j_get(jp), get_device_field_f32(tp, "cpu"), JFp(jp)


def same(jax_out, torch_out) -> bool:
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    return want.dtype == got.dtype and np.array_equal(want, got)


@pytest.mark.parametrize("name", list(FIELDS))
def test_ring_ops_match_jax(name):
    jf, tf, hf = fields(name)
    xs, ys = sample(hf.p, 16, 4), sample(hf.p, 16, 5)[::-1]
    ja, jb = jf.array(xs), jf.array(ys)
    ta, tb = tf.array(xs), tf.array(ys)
    assert same(ja, ta) and same(jb, tb)
    assert same(jf.const(xs[5], mont=False), tf.const(xs[5], mont=False))
    for op in ("add_impl", "sub_impl", "mul_impl"):
        assert same(getattr(jf, op)(ja, jb), getattr(tf, op)(ta, tb)), op
    for op in ("neg_impl", "double_impl", "square_impl", "to_mont_impl", "from_mont_impl"):
        assert same(getattr(jf, op)(ja), getattr(tf, op)(ta)), op
    assert tf.to_host_ints(tf.mul(ta, tb)) == [hf.mul(x, y) for x, y in zip(xs, ys)]
    assert tf.to_host_ints(ta) == jf.to_host_ints(ja) == xs
    limbs = tf.digits_to_limbs_np(ta)
    assert np.array_equal(limbs, jf.digits_to_limbs_np(np.asarray(ja)))
    assert np.array_equal(tf._limbs_to_digits_np(limbs), jf._limbs_to_digits_np(limbs))


@pytest.mark.parametrize("name", list(FIELDS))
def test_pow_inv_predicates_match_jax(name):
    """Exponents of up to 16 bits against JAX's unrolled ladder; the
    inverse and longer exponents against the host field (the reference runs
    them as a jitted loop of f32 products, minutes of compile on the CPU)."""
    jf, tf, hf = fields(name)
    xs = sample(hf.p, 16, 6)  # the shape of the ring test: eager JAX reuses its compiles
    ja, ta = jf.array(xs), tf.array(xs)
    for e in (0, 1, 6, 0xFFFF):
        assert same(jf._pow_impl(ja, e), tf.pow_const(ta, e)), e
    e = (1 << 17) + 5
    assert tf.to_host_ints(tf.pow_const(ta, e)) == [hf.pow(x, e) for x in xs]
    assert tf.to_host_ints(tf.inv(ta)) == [hf.inv(x) if x else 0 for x in xs]
    jb, tb = jf.array(xs[::-1]), tf.array(xs[::-1])
    assert np.array_equal(np.asarray(jf.is_zero(ja)), tf.is_zero(ta).numpy())
    assert np.array_equal(np.asarray(jf.eq(ja, jb)), tf.eq(ta, tb).numpy())
    mask = np.arange(16) % 2 == 0
    assert same(jf.select(jnp.asarray(mask), ja, jb), tf.select(torch.as_tensor(mask), ta, tb))
    js, ts = jf.array(xs, mont=False), tf.array(xs, mont=False)
    for c in (1, 2, 4, 8, 16):
        want = np.asarray(jf.window_digits(js, c, hf.params.num_bits))
        assert np.array_equal(want.astype(np.int64), tf.window_digits(ts, c, hf.params.num_bits).numpy()), c


def test_sub_borrow_ripple_matches_jax():
    """The borrow ripple of
    tests/test_fields_device_f32.py::test_f32_sub_borrow_ripple: b just
    above a in the low digits, with long zero runs above."""
    jf, tf, hf = fields("bn254_fr")
    cases = [(0, 1), (1, 2), (1 << 128, (1 << 128) + 1), (hf.p - 1, 1), (256, 257)]
    xs = [a % hf.p for a, _ in cases]
    ys = [b % hf.p for _, b in cases]
    ja, jb = jf.array(xs, mont=False), jf.array(ys, mont=False)
    ta, tb = tf.array(xs, mont=False), tf.array(ys, mont=False)
    d = tf.sub(ta, tb)
    assert same(jf.sub_impl(ja, jb), d)
    assert tf.to_host_ints(d, mont=False) == [hf.sub(x, y) for x, y in zip(xs, ys)]
    assert same(jf.add_impl(jb, ja), tf.add(tb, ta))
