"""The port's Groth16 setup against keys the JAX package's setup wrote.

Each committed fixture key (`tests/vectors/torch_pk_*.npz`: BN254
MulChain(4, 1023), BN254 and BLS12-381 MulChain(7, 12)) came from the JAX
`circuit_specific_setup(circuit, random.Random(0))`. The port's setup of
the same circuit from the same rng must give every array of that file bit
for bit, the legacy query arrays the file holds included (the 12-constraint
keys' vectors take the reference's legacy fixed-base path, whose query
arrays are projective; the 1023 key was written with SNARK_TPU_SETUP_QUERY=0
and holds only h_query and l_query, the two vectors below 2048 points).
A live JAX setup takes minutes on the CPU even at n = 8, so the committed
files are the oracle. The port's setup synthesizes each circuit with its
own relations layer; that synthesis is held against the JAX synthesis, and
the port's own BLS12-381 key proves the committed proof through `prove`.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import Groth16, synthesize_matrices
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.snark import serialize as tser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
# fixture -> (curve, seed, n)
FIXTURES = {
    "torch_pk_bn254_mulchain1023.npz": (BN254, 4, 1023),
    "torch_pk_bn254_mulchain12.npz": (BN254, 7, 12),
    "torch_pk_bls12_381_mulchain12.npz": (BLS12_381, 7, 12),
}
_KEYS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port_setup(fixture: str):
    """The port's key for a fixture's circuit, synthesized by the port,
    from random.Random(0), made once per test process."""
    if fixture not in _KEYS:
        curve, seed, n = FIXTURES[fixture]
        g16 = Groth16(curve, device="cpu")
        pk, vk = g16.circuit_specific_setup(MulChainCircuit(seed=seed, n=n), random.Random(0))
        _KEYS[fixture] = (g16, pk, vk)
    return _KEYS[fixture]


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_setup_equals_jax_key(fixture, tmp_path):
    """Saved, the port's key holds every array of the JAX-written file,
    equal in dtype, shape and value."""
    _, pk, _ = port_setup(fixture)
    path = str(tmp_path / "pk.npz")
    pk.save(path)
    with np.load(os.path.join(VECTORS, fixture)) as want, np.load(path) as got:
        assert set(want.files) <= set(got.files)
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == want[name].shape, name
            assert np.array_equal(got[name], want[name]), name


def test_coo_arrays_equal_jax_synthesis():
    """The port's setup synthesis (`synthesize_matrices`) equals
    the JAX synthesis the JAX setup runs: to_coo_arrays, interner values
    and the counts, array for array, on both curves, with both of
    MulChain's synthesis paths."""
    from snark_tpu.fields.host import Fp
    from snark_tpu.fields.params import BLS12_381 as J_BLS, BN254 as J_BN254
    from snark_tpu.models import MulChainCircuit as JaxMulChain
    from snark_tpu.relations import (
        R1CS_PREDICATE_LABEL,
        OptimizationGoal,
        SynthesisMode,
        new_ref,
    )

    for jax_curve, curve in ((J_BN254, BN254), (J_BLS, BLS12_381)):
        for seed, n in ((4, 1023), (7, 12), (3, 1)):
            cs = new_ref(Fp(jax_curve.fr))
            cs.set_optimization_goal(OptimizationGoal.Constraints)
            cs.set_mode(SynthesisMode.setup())
            JaxMulChain(seed=seed, n=n).generate_constraints(cs)
            cs.finalize()
            want = cs.inner.to_coo_arrays(R1CS_PREDICATE_LABEL)
            for batch in (True, False):
                got, values, nc, ni, m = synthesize_matrices(
                    MulChainCircuit(seed=seed, n=n, batch=batch), curve)
                assert values == list(cs.inner.field_interner.values)
                assert (nc, ni, m) == (cs.num_constraints(), cs.num_instance_variables,
                                       cs.num_instance_variables + cs.num_witness_variables)
                for g, w in zip(got, want):
                    for a, b in zip(g, w):
                        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_own_bls_key_proves_committed_proof():
    """The port's BLS12-381 key proves, at the committed (r, s), the JAX
    package's committed proof, and the proof verifies."""
    g16, pk, vk = port_setup("torch_pk_bls12_381_mulchain12.npz")
    with open(os.path.join(VECTORS, "torch_proof_bls12_381_mulchain12.json")) as f:
        want = json.load(f)
    proof = g16.prove(pk, MulChainCircuit(seed=7, n=12), r=int(want["r"]), s=int(want["s"]))
    assert tser.serialize_proof(proof, BLS12_381).hex() == want["proof_bytes_hex"]
    assert g16.verify(vk, want["public_input"], proof)
