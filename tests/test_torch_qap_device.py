"""The port's device QAP (`snark_tpu_torch/groth16/qap_device.py`) against
the JAX package's host path (`groth16/qap.py` `lagrange_coeffs_at`,
`evaluate_variable_polys_at_tau`), value for value, on both curves.

The inputs are the COO arrays the JAX synthesis gives for RandomLcCircuit
(columns of many entries) and MulChain, at τ = 0, 1, p − 1 (1 and −1 lie
on the domain: the indicator) and a random τ.
"""

import random

import numpy as np
import pytest
import torch

from snark_tpu.fields.host import Fp
from snark_tpu.fields.params import BLS12_381 as J_BLS, BN254 as J_BN254
from snark_tpu.groth16.qap import evaluate_variable_polys_at_tau, lagrange_coeffs_at
from snark_tpu.models import MulChainCircuit, RandomLcCircuit
from snark_tpu.relations import R1CS_PREDICATE_LABEL, OptimizationGoal, SynthesisMode, new_ref
from snark_tpu_torch.fields.limbs import fields_of
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import qap_device as Q

CURVES = {"bn254": (J_BN254, BN254), "bls12_381": (J_BLS, BLS12_381)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def taus(p: int) -> list[int]:
    return [0, 1, p - 1, random.Random(11).randrange(2, p)]


def test_powers_and_batch_inverse():
    """powers_device at the edge bases and scales, lengths across the
    doublings; the batch inverse of edge and random values; both curves."""
    rng = random.Random(3)
    for _, curve in CURVES.values():
        fr = fields_of(curve)[0]
        p = fr.p
        for base in (0, 1, p - 1, rng.randrange(2, p)):
            for n in (1, 2, 5, 37):
                scale = rng.randrange(p)
                got = fr.decode(Q.powers_device(fr, base, n, "cpu", scale=scale))
                assert got == [scale * pow(base, j, p) % p for j in range(n)]
        for n in (1, 2, 7, 64):
            xs = [1, p - 1] + [rng.randrange(1, p) for _ in range(n - 2)] if n > 1 else [p - 1]
            inv = fr.decode(Q.batch_inverse(fr.tensor(xs, "cpu"), fr))
            assert inv == [pow(x, -1, p) for x in xs]
        with pytest.raises(ZeroDivisionError):
            Q.batch_inverse(fr.tensor([3, 0, 5], "cpu"), fr)


def test_lagrange_equals_host():
    for jax_curve, curve in CURVES.values():
        fr = fields_of(curve)[0]
        for n in (2, 16, 64):
            for tau in taus(fr.p):
                got = fr.decode(Q.lagrange_coeffs_device(fr, n, tau, "cpu"))
                assert got == lagrange_coeffs_at(jax_curve.fr, n, tau), (n, tau)


def _synthesis(circuit, params):
    cs = new_ref(Fp(params))
    cs.set_optimization_goal(OptimizationGoal.Constraints)
    cs.set_mode(SynthesisMode.setup())
    circuit.generate_constraints(cs)
    cs.finalize()
    return cs


@pytest.mark.parametrize("name", list(CURVES))
def test_uvw_and_combine_equal_host(name):
    """u, v, w and Z(τ) from the COO arrays equal the host path on the
    same circuit's matrices; the combine equals the host formulas."""
    jax_curve, curve = CURVES[name]
    fr = fields_of(curve)[0]
    p = fr.p
    rng = random.Random(7)
    for circuit in (RandomLcCircuit(n=120, terms_per_lc=10, seed=2), MulChainCircuit(seed=4, n=37)):
        cs = _synthesis(circuit, jax_curve.fr)
        inner = cs.inner
        coo = inner.to_coo_arrays(R1CS_PREDICATE_LABEL)
        matrices = cs.to_matrices()[R1CS_PREDICATE_LABEL]
        nc, ni = cs.num_constraints(), inner.num_instance_variables
        m = ni + inner.num_witness_variables
        if isinstance(circuit, RandomLcCircuit):  # columns of many entries
            assert np.bincount(np.concatenate([c[1] for c in coo])).max() >= 8
        for tau in taus(p):
            want = evaluate_variable_polys_at_tau(jax_curve.fr, matrices, nc, ni, m, tau)
            got = Q.evaluate_uvw_device(fr, coo, inner.field_interner.values, nc, ni, m, tau,
                                        "cpu")
            assert [fr.decode(x) for x in got[:3]] == list(want[:3]), tau
            assert got[3] == want[3]
        u, v, w = (fr.tensor(x, "cpu") for x in want[:3])
        alpha, beta, gamma, delta = (rng.randrange(1, p) for _ in range(4))
        gi, di = pow(gamma, -1, p), pow(delta, -1, p)
        gabc, l_m = Q.combine_uvw_device(fr, u, v, w, beta, alpha, gi, di, ni)
        s = [(beta * a + alpha * b + c) % p for a, b, c in zip(*want[:3])]
        assert fr.decode(gabc) == [x * gi % p for x in s[:ni]]
        assert fr.decode(l_m) == [x * di % p for x in s[ni:]]


def test_segment_sums_exact():
    """Column sums over segments of 1 to 300 entries, values at p − 1, equal
    the integers mod p."""
    fr = fields_of(BN254)[0]
    p = fr.p
    rng = np.random.default_rng(5)
    seg = np.sort(np.concatenate([np.full(300, 3), rng.integers(0, 40, 500), [39]]))
    vals = [p - 1 if i % 3 else int(rng.integers(0, 2**62)) for i in range(len(seg))]
    got = fr.decode(Q.segment_sums(fr, fr.tensor(vals, "cpu"), seg, 41))
    want = [0] * 41
    for s, v in zip(seg, vals):
        want[s] = (want[s] + v) % p
    assert got == want
