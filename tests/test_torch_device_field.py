"""The port's `DeviceField` (`snark_tpu_torch/fields/device.py`) against the
JAX package's `fields/device.py`, op for op, on BN254 Fr (16 limbs) and
BLS12-381 Fq (24 limbs).

Tolerance: exact. Both hold canonical 16-bit limbs in Montgomery form with
R = 2^(16·L), so every output must equal the reference's limb for limb.
Inputs come from a numpy seed, with the edges 0, 1, p − 1 and values whose
limbs are all 0xFFFF below p's top limb.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.device import get_device_field as j_get_device_field
from snark_tpu.fields.host import Fp as JFp

from snark_tpu_torch.fields.device import get_device_field
from snark_tpu_torch.fields.params import BLS12_381, BN254

FIELDS = {
    "bn254_fr": (J_BN254.fr, BN254.fr),
    "bls12_381_fq": (J_BLS12_381.fq, BLS12_381.fq),
}


def sample(p: int, n: int, seed: int) -> list[int]:
    """n values below p: the edges, then uniform ones from a numpy seed."""
    rng = np.random.RandomState(seed)
    top = p.bit_length() // 16 * 16
    edges = [0, 1, p - 1, (1 << top) - 1, p - (1 << 16)]
    nbytes = (p.bit_length() + 7) // 8
    rand = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n - len(edges))]
    return edges + rand


def fields(name):
    jp, tp = FIELDS[name]
    return j_get_device_field(jp), get_device_field(tp, "cpu"), JFp(jp)


def same(jax_out, torch_out) -> bool:
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    return got.dtype == np.int32 and np.array_equal(want.astype(np.int64), got.astype(np.int64))


@pytest.mark.parametrize("name", list(FIELDS))
def test_ring_ops_match_jax(name):
    jf, tf, hf = fields(name)
    p = hf.p
    xs, ys = sample(p, 24, 1), sample(p, 24, 2)[::-1]
    ja, jb = jf.array(xs), jf.array(ys)
    ta, tb = tf.array(xs), tf.array(ys)
    assert same(ja, ta) and same(jb, tb)
    assert same(jf.array(xs, mont=False), tf.array(xs, mont=False))
    assert same(jf.const(xs[7]), tf.const(xs[7]))
    for op in ("add", "sub", "mul"):
        assert same(getattr(jf, op)(ja, jb), getattr(tf, op)(ta, tb)), op
    for op in ("neg", "double", "square", "to_mont", "from_mont"):
        assert same(getattr(jf, op)(ja), getattr(tf, op)(ta)), op
    c = xs[9]
    assert same(jf.mul_const(ja, jf.const(c)), tf.mul_const(ta, tf.const(c)))
    # batched shapes broadcast as the reference's do
    assert same(jf.mul(ja.reshape(4, 6, -1), jb[:6]), tf.mul(ta.reshape(4, 6, -1), tb[:6]))
    assert tf.to_host_ints(tf.mul(ta, tb)) == [hf.mul(x, y) for x, y in zip(xs, ys)]
    assert tf.to_host_ints(ta) == jf.to_host_ints(ja) == xs
    assert tf.to_host_ints(tf.array(xs, mont=False), mont=False) == xs


@pytest.mark.parametrize("name", list(FIELDS))
def test_pow_inv_predicates_match_jax(name):
    jf, tf, hf = fields(name)
    xs = sample(hf.p, 10, 3)
    ja, ta = jf.array(xs), tf.array(xs)
    assert same(jf.inv(ja), tf.inv(ta))  # inv(0) = 0
    for e in (0, 1, 5, 0xFFFF, (1 << 17) + 3):
        assert same(jf.pow_const(ja, e), tf.pow_const(ta, e)), e
    assert np.array_equal(np.asarray(jf.is_zero(ja)), tf.is_zero(ta).numpy())
    jb, tb = jf.array(xs[::-1]), tf.array(xs[::-1])
    assert np.array_equal(np.asarray(jf.eq(ja, jb)), tf.eq(ta, tb).numpy())
    mask = np.arange(10) % 3 == 0
    assert same(jf.select(jnp.asarray(mask), ja, jb), tf.select(torch.as_tensor(mask), ta, tb))
    js, ts = jf.array(xs, mont=False), tf.array(xs, mont=False)
    for c in (1, 2, 4, 8, 16):
        bits = hf.params.num_bits
        assert same(jf.window_digits(js, c, bits), tf.window_digits(ts, c, bits)), c


def test_carry_worst_case_matches_jax():
    """Long carry ripples (limbs of 0xFFFF), the case of
    tests/test_fields_device.py::test_device_carry_worst_case."""
    jf, tf, hf = fields("bn254_fr")
    v1 = (1 << 240) - 1  # 15 limbs of 0xFFFF
    a_vals, b_vals = [v1, v1, hf.p - 1], [1, v1, hf.p - 1]
    ja, jb = jf.array(a_vals, mont=False), jf.array(b_vals, mont=False)
    ta, tb = tf.array(a_vals, mont=False), tf.array(b_vals, mont=False)
    s, d = tf.add(ta, tb), tf.sub(tb, ta)
    assert same(jf.add(ja, jb), s) and same(jf.sub(jb, ja), d)
    assert tf.to_host_ints(s, mont=False) == [hf.add(a, b) for a, b in zip(a_vals, b_vals)]
    assert tf.to_host_ints(d, mont=False) == [hf.sub(b, a) for a, b in zip(a_vals, b_vals)]
    assert same(jf.mul(ja, jb), tf.mul(ta, tb))
