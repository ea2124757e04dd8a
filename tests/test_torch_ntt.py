"""Port scalar-field kernels K3 (`ntt_stage`), K4 (`field_ew`) and the
h pipeline (`snark_tpu_torch/ops/ntt.py`) against the JAX package's plane
NTT (`ops/ntt_plane.py`, interpret mode), its `WitnessMapPlan`, and the
committed NTT vector. Values are compared exactly as integers mod r.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.host import Fp
from snark_tpu.groth16.qap import WitnessMapPlan
from snark_tpu.ops.ntt_plane import get_plane_ntt

from snark_tpu_torch.fields.limbs import FR
from snark_tpu_torch.ops import ntt as N

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
P = J_BN254.fr.modulus


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rand(n, seed):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def test_ntt_vector():
    with open(os.path.join(VECTORS, "ntt_bn254_fr.json")) as f:
        v = json.load(f)
    plan = N.NttPlan(v["n"], "cpu")
    coeffs = [int(s) for s in v["coeffs"]]
    evals = plan.fft(FR.tensor(coeffs, "cpu"))
    assert [str(x) for x in FR.decode(evals)] == v["evals_natural_order"]
    assert FR.decode(plan.ifft(evals)) == coeffs


def port_h_bitrev(n, av, bv, cv):
    plan = N.NttPlan(n, "cpu")
    h_mont = plan.h_from_evals(*(FR.tensor(v, "cpu") for v in (av, bv, cv)))
    return FR.decode(N.from_mont(h_mont), mont=False)


def test_h_pipeline_matches_plane_ntt():
    """h = (A·B − C)/Z_H from domain evaluations: the port's bit-reversed,
    canonical h equals the JAX plane NTT's `h_from_evals` followed by
    `to_std_canonical`."""
    n = 64
    av, bv, cv = rand(n, 1), rand(n, 2), rand(n, 3)
    pn = get_plane_ntt(J_BN254.fr, n, interpret=True)
    pf = pn.pf
    h_planes = pn.h_from_evals(*(jnp.asarray(pf.pack_np(v)) for v in (av, bv, cv)))
    jax_bitrev = pf.unpack_np(np.asarray(pn.to_std_canonical(h_planes)), mont=False)
    assert port_h_bitrev(n, av, bv, cv) == jax_bitrev


def test_h_pipeline_matches_witness_map():
    """The same h against `WitnessMapPlan.h_from_evals`, which returns h
    in natural coefficient order."""
    n = 64
    av, bv, cv = rand(n, 1), rand(n, 2), rand(n, 3)
    f = Fp(J_BN254.fr)
    wm = WitnessMapPlan(J_BN254.fr, n)
    h_nat = wm.h_from_evals(*(wm.df.array(v) for v in (av, bv, cv)))
    natural = f.from_mont_limbs_array(np.asarray(h_nat))
    rev = N.bit_reverse_indices(n)
    assert port_h_bitrev(n, av, bv, cv) == [natural[r] for r in rev]


@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
def test_ntt_stage_matches_jax(dif):
    """One butterfly stage of each kind against the JAX stage kernels."""
    n, s = 256, 3
    half = 1 << s
    xv, twv = rand(n, 4), rand(n // 2, 5)
    pn = get_plane_ntt(J_BN254.fr, n, interpret=True)
    pf = pn.pf
    x = jnp.asarray(pf.pack_np(xv))
    lo, hi = pn._stage_split(x, half)
    stride = n >> (s + 1)
    tw_stage = [twv[j * stride] for j in range(half)]
    tw = jnp.tile(jnp.asarray(pf.pack_np(tw_stage)), (1, n // (2 * half)))
    o0, o1 = (pn.k.dif if dif else pn.k.dit)(lo, hi, tw)
    want = pf.unpack_np(np.asarray(pn._stage_join(o0, o1, half)))
    got = N.ntt_stage(FR.tensor(xv, "cpu"), FR.tensor(twv, "cpu"), s, stride, dif)
    assert FR.decode(got) == want


def test_field_ew_matches_jax():
    """K4's modes against the JAX vector kernels: vmul, the Hadamard with
    1/Z_H, and the conversions in (remont) and out (tostd) of Montgomery
    form."""
    n = 128
    av, bv, cv = rand(n, 6), rand(n, 7), rand(n, 8)
    pn = get_plane_ntt(J_BN254.fr, n, interpret=True)
    pf, k = pn.pf, pn.k
    A, B, Cp = (jnp.asarray(pf.pack_np(v)) for v in (av, bv, cv))
    a, b, c = (FR.tensor(v, "cpu") for v in (av, bv, cv))
    assert FR.decode(N.field_ew("mul", a, b)) == pf.unpack_np(np.asarray(k.vmul(A, B)[0]))
    assert FR.decode(N.field_ew("add", a, b)) == [(x + y) % P for x, y in zip(av, bv)]
    zinv = pow((pow(J_BN254.fr.generator, n, P) - 1) % P, -1, P)
    had = N.field_ew("hadamard", a, b, c, FR.const(zinv, "cpu"))
    assert FR.decode(had) == pf.unpack_np(np.asarray(pn.hadamard(A, B, Cp)[0]))
    assert FR.decode(N.from_mont(a), mont=False) == pf.unpack_np(
        np.asarray(pn.to_std_canonical(A)), mont=False
    )
    assert FR.decode(N.to_mont(FR.tensor(av, "cpu", mont=False))) == av
    assert FR.decode(N.field_ew("mul", a, FR.const(5, "cpu"))) == [x * 5 % P for x in av]


def test_dif_sum_growth_no_underflow():
    """The reference's DIF regression input (values whose stored form is
    extreme, imbalanced by index mod 4) through the port's DIF: the port
    reduces every sum, so no stage can wrap; equal to the JAX plane DIF
    with its normalising stages and to a host mirror."""
    n = 512
    pn = get_plane_ntt(J_BN254.fr, n, interpret=True)
    pf = pn.pf
    r_inv = pow(pf.r_eff, -1, P)
    rng = random.Random(8)
    vals = []
    for i in range(n):
        target = rng.randrange(P - 5, P) if (i % 4) in (2, 3) else rng.randrange(0, 5)
        vals.append(target * r_inv % P)
    jax_out = pf.unpack_np(np.asarray(pn._dif(jnp.asarray(pf.pack_np(vals)), pn.inv_tw)))
    plan = N.NttPlan(n, "cpu")
    got = FR.decode(plan.dif(FR.tensor(vals, "cpu"), plan.inv_tw))
    assert got == jax_out
    # the port's stored values are the extremes here (value · 2^256 mod r)
    port_vals = [rng.randrange(P - 5, P) if (i % 4) in (2, 3) else rng.randrange(0, 5) for i in range(n)]
    stored = [v * pow(FR.r, -1, P) % P for v in port_vals]
    got2 = FR.decode(plan.dif(FR.tensor(stored, "cpu"), plan.inv_tw))
    omega_inv = pow(J_BN254.fr.root_of_unity(n), -1, P)
    h = list(stored)
    for s in range(n.bit_length() - 2, -1, -1):
        half = 1 << s
        w = pow(omega_inv, n >> (s + 1), P)
        out = list(h)
        for base in range(0, n, 2 * half):
            tw = 1
            for t in range(half):
                lo, hi = h[base + t], h[base + half + t]
                out[base + t] = (lo + hi) % P
                out[base + half + t] = (lo - hi) * tw % P
                tw = tw * w % P
        h = out
    assert got2 == h


def test_hadamard_large_value_fold():
    """The reference's Hadamard regression feeds C as a large lazy value;
    the port's C is always canonical, so its extreme is C = r − 1 against
    A·B = 0, where the subtraction borrows the most."""
    n = 64
    pn = get_plane_ntt(J_BN254.fr, n, interpret=True)
    pf = pn.pf
    av = [0] * 16 + rand(n - 16, 12)
    bv = rand(n, 13)
    cv = [P - 1 - (i % 3) for i in range(n)]
    zinv = pow((pow(J_BN254.fr.generator, n, P) - 1) % P, -1, P)
    want = [(x * y - z) % P * zinv % P for x, y, z in zip(av, bv, cv)]
    jax_out = pf.unpack_np(np.asarray(pn.hadamard(*(jnp.asarray(pf.pack_np(v)) for v in (av, bv, cv)))[0]))
    got = N.field_ew("hadamard", *(FR.tensor(v, "cpu") for v in (av, bv, cv)), FR.const(zinv, "cpu"))
    assert FR.decode(got) == jax_out == want
