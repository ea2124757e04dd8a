"""The Groth16 entry points on synthesized circuits, end to end.

`circuit_specific_setup`, `prove` and `pk_from_bytes` take any
`ConstraintSynthesizer`: they synthesize it with the port's relations
layer, as the reference's do. The committed vector
`tests/vectors/proof_bn254.json` is the JAX package's MulChain(11, 8) key
from random.Random(42405) and its proof at a fixed (r, s): the port's setup
and `prove` give its vk and proof bytes. A circuit with symbolic LCs
(Circuit2) sets up, proves and verifies, and its key goes through the
arkworks bytes and back; on it, `prove` draws r, then s, from its rng,
and refuses to run with no randomness at all unless told to.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from snark_tpu_torch.fields.host import Fp
from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.groth16 import Groth16, synthesize_matrices
from snark_tpu_torch.models import Circuit2, MulChainCircuit
from snark_tpu_torch.snark import serialize as ser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_setup_and_prove_give_proof_vector():
    """Setup of MulChain(11, 8) from random.Random(42405), on the
    per-constraint synthesis path, gives the vector's vk bytes; `prove` at
    its (r, s), on the batch path, gives its proof bytes, and it verifies.
    Both paths synthesize the same matrices."""
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        v = json.load(f)
    g16 = Groth16(BN254, device="cpu")
    loop, batch = (MulChainCircuit(seed=11, n=8, batch=b) for b in (False, True))
    for a, b in zip(synthesize_matrices(loop, BN254)[0], synthesize_matrices(batch, BN254)[0]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    pk, vk = g16.circuit_specific_setup(loop, random.Random(int(v["setup_seed"])))
    assert "synthesize" in g16.last_setup.stage_ms
    assert ser.serialize_vk(vk).hex() == v["vk_bytes_hex"]
    proof = g16.prove(pk, batch, r=int(v["r"]), s=int(v["s"]))
    assert ser.serialize_proof(proof, BN254).hex() == v["proof_bytes_hex"]
    assert g16.verify(vk, [11], proof) and not g16.verify(vk, [12], proof)


def test_any_circuit_and_prove_randomness():
    """Circuit2 (an instance, two witnesses, symbolic LCs that finalize
    inlines) sets up; `prove` with no rng and no (r, s) raises ValueError,
    deterministic=True proves with r = s = 0, an rng gives r, then s, as
    Fp.rand draws them, and each proof verifies with [a] alone.
    `pk_from_bytes` of the key's bytes, synthesizing the circuit again,
    rebuilds the same matrices and the same bytes."""
    g16 = Groth16(BN254, device="cpu")
    circuit = Circuit2(a=1, b=1, c=2)
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(0))
    assert (pk.num_instance, pk.num_witness, pk.num_constraints) == (2, 2, 3)
    with pytest.raises(ValueError, match="zero-knowledge"):
        g16.prove(pk, circuit)
    zero = g16.prove(pk, circuit, deterministic=True)
    assert zero.a == g16.hg1.add(vk.alpha_g1, g16.last_run.sums["A"])
    draws = random.Random(1)
    fr = Fp(BN254.fr)
    r, s = fr.rand(draws), fr.rand(draws)
    drawn = g16.prove(pk, circuit, random.Random(1))
    assert list(g16.last_run.stage_ms)[0] == "synthesize"
    assert drawn == g16.prove(pk, circuit, r=r, s=s) != zero
    assert g16.verify(vk, [1], zero) and g16.verify(vk, [1], drawn)
    assert not g16.verify(vk, [2], drawn)
    data = g16.pk_to_bytes(pk)
    back = g16.pk_from_bytes(data, circuit)
    for m in ("mat_a", "mat_b", "mat_c"):
        assert torch.equal(getattr(back, m).cols, getattr(pk, m).cols)
        assert torch.equal(getattr(back, m).coeffs, getattr(pk, m).coeffs)
    assert g16.pk_to_bytes(back) == data
