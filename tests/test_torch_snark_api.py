"""The port's SNARK trait layer against the JAX package's.

The predicate codec (`snark/serialize.py` `serialize_predicate`,
`deserialize_predicate`, `_canon_sparse_terms`), the universal-setup
adapter (`snark/universal.py`: `universal_setup`, `index` and its
`NeedLargerBound`) and `Groth16.verify_with_processed_vk`, on the same
inputs through both packages. The JAX side runs on JAX-CPU.
"""

import json
import os
import random

import pytest

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.host import Fp as J_Fp
from snark_tpu.groth16 import Groth16 as J_Groth16
from snark_tpu.models import MulChainCircuit as J_MulChain
from snark_tpu.relations.predicate import PolynomialPredicate as J_Predicate
from snark_tpu.snark import serialize as jser
from snark_tpu.snark.api import NeedLargerBound as J_NeedLargerBound
from snark_tpu.snark.universal import ComputationBound as J_Bound
from snark_tpu.snark.universal import UniversalGroth16 as J_Universal
from snark_tpu_torch.fields import BN254, Fp
from snark_tpu_torch.groth16 import Groth16, PreparedVerifyingKey
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.relations.predicate import PolynomialPredicate
from snark_tpu_torch.snark import (
    ComputationBound,
    NeedLargerBound,
    PublicParameters,
    UniversalGroth16,
)
from snark_tpu_torch.snark import serialize as ser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


def seeded_terms(seed: int, p: int):
    """Terms of a 5-ary polynomial with duplicate terms, duplicate
    variables inside a term, zero powers, zero coefficients and
    coefficients that cancel mod p."""
    rng = random.Random(seed)
    terms = []
    for _ in range(24):
        t = [(rng.randrange(5), rng.choice((0, 1, 1, 2, 3))) for _ in range(rng.randrange(4))]
        terms.append((rng.choice((0, 1, p - 1, rng.randrange(p), p + 3)), t))
    terms += [(5, [(1, 1), (2, 2)]), (p - 5, [(2, 2), (1, 1)]), (7, [(0, 1), (0, 2), (3, 0)])]
    return terms


def test_predicate_codec_matches_jax_and_round_trips():
    """serialize_predicate gives the JAX bytes, the canonical terms fold
    as the JAX ones, and the bytes decode to a predicate that encodes to
    the same bytes and evaluates as the original."""
    params = BN254.fr
    p = params.modulus
    for seed in range(4):
        terms = seeded_terms(seed, p)
        pred = PolynomialPredicate(Fp(params), 5, terms)
        jpred = J_Predicate(J_Fp(J_BN254.fr), 5, terms)
        canon = ser._canon_sparse_terms(p, pred.terms)
        assert canon == jser._canon_sparse_terms(p, jpred.terms)
        assert all(c != 0 and all(e for _, e in t) for c, t in canon)
        assert len(canon) < len(terms)
        data = ser.serialize_predicate(params, pred)
        assert data == jser.serialize_predicate(J_BN254.fr, jpred)
        back, end = ser.deserialize_predicate(params, data + b"tail")
        assert end == len(data) and back.arity == 5
        assert ser.serialize_predicate(params, back) == data
        xs = [random.Random(seed + 9).randrange(p) for _ in range(5)]
        assert back.eval(xs) == pred.eval(xs)


def test_universal_setup_matches_jax():
    """universal_setup draws the seed as the JAX adapter does (128 bits of
    the given Random), under the given bound."""
    u, ju = UniversalGroth16(BN254, device="cpu"), J_Universal(J_BN254)
    for seed, bound in ((0, 1 << 10), (5, 32), (11, 4)):
        pp = u.universal_setup(ComputationBound(bound), random.Random(seed))
        jpp = ju.universal_setup(J_Bound(bound), random.Random(seed))
        assert isinstance(pp, PublicParameters)
        assert (pp.bound.max_constraints, pp.seed) == (jpp.bound.max_constraints, jpp.seed)
    assert ComputationBound().max_constraints == J_Bound().max_constraints


def test_need_larger_bound_matches_jax(monkeypatch):
    """A circuit just over and one far over the bound raise NeedLargerBound
    with the JAX adapter's bound, and neither package starts a setup."""
    u, ju = UniversalGroth16(BN254, device="cpu"), J_Universal(J_BN254)

    def no_setup(*args, **kwargs):
        raise AssertionError("index set up a circuit over its bound")

    monkeypatch.setattr(u._g16, "circuit_specific_setup", no_setup)
    monkeypatch.setattr(ju._g16, "circuit_specific_setup", no_setup)
    pp = u.universal_setup(ComputationBound(8), random.Random(3))
    jpp = ju.universal_setup(J_Bound(8), random.Random(3))
    for n in (9, 100):
        with pytest.raises(NeedLargerBound) as got:
            u.index(pp, MulChainCircuit(seed=3, n=n, batch=False))
        with pytest.raises(J_NeedLargerBound) as want:
            ju.index(jpp, J_MulChain(seed=3, n=n, batch=False))
        assert got.value.bound.max_constraints == want.value.bound.max_constraints
        assert got.value.bound == ComputationBound(want.value.bound.max_constraints)
    assert got.value.bound.max_constraints == 128


def test_index_is_setup_from_the_seed():
    """index within the bound equals circuit_specific_setup from
    random.Random(pp.seed) (vk bytes, same every time), and its key proves
    a proof that verify and verify_with_processed_vk accept."""
    u = UniversalGroth16(BN254, device="cpu")
    pp = u.universal_setup(ComputationBound(32), random.Random(0))
    circuit = MulChainCircuit(seed=3, n=8, batch=False)
    pk, vk = u.index(pp, circuit)
    _, vk2 = u.circuit_specific_setup(circuit, random.Random(pp.seed))
    assert ser.serialize_vk(vk) == ser.serialize_vk(vk2)
    proof = u.prove(pk, circuit, r=1, s=2)
    pvk = u.process_vk(vk)
    assert u.verify(vk, [3], proof)
    assert u.verify_with_processed_vk(pvk, [3], proof)
    assert not u.verify_with_processed_vk(pvk, [4], proof)


def test_verify_with_processed_vk_matches_jax():
    """On the committed vector's vk and proof, the port's
    verify_with_processed_vk agrees with the JAX one: true for [11], false
    for [12]. A public input of the wrong length raises ValueError in the
    port (the JAX package asserts it)."""
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        v = json.load(f)
    vk_bytes, proof_bytes = bytes.fromhex(v["vk_bytes_hex"]), bytes.fromhex(v["proof_bytes_hex"])
    g16, jg16 = Groth16(BN254, device="cpu"), J_Groth16(J_BN254)
    vk, proof = ser.deserialize_vk(vk_bytes, BN254), ser.deserialize_proof(proof_bytes, BN254)
    jvk = jser.deserialize_vk(vk_bytes, J_BN254)
    jproof = jser.deserialize_proof(proof_bytes, J_BN254)
    pvk, jpvk = g16.process_vk(vk), jg16.process_vk(jvk)
    assert isinstance(pvk, PreparedVerifyingKey)
    for public in ([11], [12]):
        got = g16.verify_with_processed_vk(pvk, public, proof)
        assert got == jg16.verify_with_processed_vk(jpvk, public, jproof) == (public == [11])
    assert g16.verify(vk, [11], proof)
    for wrong in ([], [11, 0]):
        with pytest.raises(ValueError, match="length"):
            g16.verify_with_processed_vk(pvk, wrong, proof)
