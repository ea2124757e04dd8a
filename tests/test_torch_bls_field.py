"""The port's BLS12-381 field cores (`fields/limbs.py`: Fr in 8 u32 limbs,
Fq in 12; `csrc/field.cuh`, `csrc/curve.cuh`) against the JAX package's
field core and the committed arkworks vector.

Inputs come from numpy seeds and go through both packages; results are
compared exactly as integers mod p.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.fields.host import Fp
from snark_tpu.ops.pallas_field_v3 import make_mont_mul_v3

from snark_tpu_torch.fields.limbs import (
    BLS_FQ,
    BLS_FR,
    add_plain,
    mont_mul_plain,
    pack16_to_u32,
    sub_plain,
)
from snark_tpu_torch.fields.params import BLS12_381

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "snark_tpu_torch", "csrc")
VECTORS = os.path.join(ROOT, "tests", "vectors")
FIELDS = {"fr": (J_BLS.fr, BLS_FR), "fq": (J_BLS.fq, BLS_FQ)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rand_vals(p, n, seed):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n)]


@pytest.mark.parametrize("name", list(FIELDS))
def test_bls_core_matches_jax(name):
    """Montgomery products against `make_mont_mul_v3` (interpret mode) and
    the integers, edge values among random ones; add and sub across the
    wrap-around."""
    params, field = FIELDS[name]
    p = params.modulus
    assert field.limbs == {"fr": 8, "fq": 12}[name]
    av = [0, 1, p - 1, p - 1, 1, (1 << (p.bit_length() - 1)) % p, (p - 1) // 2]
    bv = [5, 1, p - 1, 1, p - 1, (1 << (p.bit_length() - 1)) % p, 2]
    av += rand_vals(p, 128 - len(av), 1)
    bv += rand_vals(p, 128 - len(bv), 2)
    a, b = field.tensor(av, "cpu"), field.tensor(bv, "cpu")
    got = field.decode(mont_mul_plain(a, b, field))
    f = Fp(params)
    mm = make_mont_mul_v3(params, tile=128, interpret=True)
    jax_out = mm(jnp.asarray(f.to_mont_limbs_array(av)), jnp.asarray(f.to_mont_limbs_array(bv)))
    assert got == f.from_mont_limbs_array(np.asarray(jax_out))
    assert got == [x * y % p for x, y in zip(av, bv)]
    assert field.decode(add_plain(a, b, field)) == [(x + y) % p for x, y in zip(av, bv)]
    assert field.decode(sub_plain(a, b, field)) == [(x - y) % p for x, y in zip(av, bv)]
    # canonical limbs, never lazy representatives
    assert all(v < p for v in field.decode(mont_mul_plain(a, b, field), mont=False))


def test_bls_fr_vector_and_csr_repack():
    """`tests/vectors/fields_bls12_381_fr.json` (arkworks): products, sums and
    the two-adic root; and the reference's 16-bit-limb CSR coefficients
    (R = 2^256, as the port's 8 limbs) repack without a change of value."""
    with open(os.path.join(VECTORS, "fields_bls12_381_fr.json")) as fh:
        v = json.load(fh)
    p = int(v["modulus"])
    assert p == BLS_FR.p == BLS12_381.fr.modulus and BLS_FR.r == BLS12_381.fr.r == 1 << 256
    assert BLS12_381.fr.two_adic_root_of_unity == int(v["two_adic_root_of_unity"])
    assert BLS12_381.fr.root_of_unity(256) == int(v["root_of_unity_256"])
    x = BLS_FR.tensor([int(s) for s in v["x"]], "cpu")
    y = BLS_FR.tensor([int(s) for s in v["y"]], "cpu")
    assert [str(s) for s in BLS_FR.decode(mont_mul_plain(x, y, BLS_FR))] == v["mul"]
    assert [str(s) for s in BLS_FR.decode(add_plain(x, y, BLS_FR))] == v["add"]
    inv = BLS_FR.tensor([int(s) for s in v["inv_x"]], "cpu")
    assert BLS_FR.decode(mont_mul_plain(x, inv, BLS_FR)) == [1] * len(v["x"])
    vals = rand_vals(p, 32, 8)
    packed = pack16_to_u32(Fp(J_BLS.fr).to_mont_limbs_array(vals))
    assert np.array_equal(packed, BLS_FR.encode(vals))


def _cuda_arrays():
    src = "".join(open(os.path.join(CSRC, n)).read() for n in sorted(os.listdir(CSRC)))

    def value(name, n_words, offset=0):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
        return sum(w << (32 * i) for i, w in enumerate(words[offset : offset + n_words]))

    def n0(struct, pattern="kN0 = (0x[0-9a-f]+)u"):
        block = src[src.index("struct " + struct + " {") :]
        return int(re.search(pattern, block).group(1), 0)

    return value, n0


def test_bls_cuda_constants_match_params():
    """The BLS12-381 constants of the CUDA core and row codec."""
    value, n0 = _cuda_arrays()
    r, q = BLS12_381.fr.modulus, BLS12_381.fq.modulus
    assert value("kBlsFrP", 8) == r and value("kBlsFqP", 12) == q
    assert n0("BlsFrParams") == BLS_FR.n0 and n0("BlsFqParams") == BLS_FQ.n0
    # the Fermat exponent of the affine tree's inverse, and its bit length
    assert value("kBlsQMinus2", 12) == q - 2
    assert n0("BlsFqParams", r"kPm2Bits = (\d+);") == (q - 2).bit_length()
    assert value("kBlsFqP2", 12) == 2 * q  # the lazy bound of Fq
    assert value("kBlsMontToRow", 12) == (1 << 400) % q
    assert value("kBlsOneMont", 12) == BLS_FQ.one
    # 3b = 12 in G1 and 12 (1 + u) in G2, by additions in the kernels
    assert n0("CurveConsts<BlsFqParams>", r"kB3G1 = (\d+);") == 3 * BLS12_381.b
    assert [3 * v for v in BLS12_381.b2] == [3 * BLS12_381.b] * 2
    with open(os.path.join(CSRC, "curve.cuh")) as fh:
        block = fh.read().split("struct CurveConsts<BlsFqParams> {")[1].split("};")[0]
    assert "kB3G2Small = true;" in block
