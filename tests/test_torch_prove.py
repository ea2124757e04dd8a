"""Whole-prove parity of the port against the JAX package.

The committed fixture (`tests/vectors/torch_pk_bn254_mulchain1023.npz`
and `torch_proof_bn254_mulchain1023.json`) is a JAX-package proving key
for MulChain(seed=4, n=1023): m = 2048 variables, the smallest circuit
that takes the plane path, domain 2048. `generate_fixture` wrote both
files once; the default suite only reads them.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from snark_tpu_torch.fields.limbs import FR
from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.groth16 import Groth16 as TorchGroth16
from snark_tpu_torch.groth16 import ProvingKey as TorchProvingKey
from snark_tpu_torch.groth16 import synthesize_matrices, synthesize_witness
from snark_tpu_torch.models import MulChainCircuit as TorchMulChain
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops.ntt import bit_reverse_indices
from snark_tpu_torch.snark import serialize as tser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
FIXTURE_PK = os.path.join(VECTORS, "torch_pk_bn254_mulchain1023.npz")
FIXTURE_PROOF = os.path.join(VECTORS, "torch_proof_bn254_mulchain1023.json")
FIXTURE_SEED, FIXTURE_N = 4, 1023
FIXTURE_R, FIXTURE_S = 123456789, 987654321


def _jax_fixture_proof(pk):
    """Prove the fixture circuit through the JAX package at (r, s); the
    caller pins SNARK_TPU_MSM_AFFINE=0."""
    from snark_tpu.fields import BN254
    from snark_tpu.groth16 import Groth16
    from snark_tpu.models import MulChainCircuit

    g16 = Groth16(BN254)
    circuit = MulChainCircuit(seed=FIXTURE_SEED, n=FIXTURE_N)
    return g16, g16.prove(pk, circuit, r=FIXTURE_R, s=FIXTURE_S)


def generate_fixture(out_dir: str = VECTORS) -> None:
    """Write the fixture key and proof with the JAX package (JAX-CPU:
    about 6 minutes). Run once by hand:
    `SNARK_TPU_SETUP_QUERY=0 SNARK_TPU_MSM_AFFINE=0 JAX_PLATFORMS=cpu python -c
    "from tests.test_torch_prove import generate_fixture as g; g()"`."""
    assert os.environ.get("SNARK_TPU_SETUP_QUERY") == "0", (
        "set SNARK_TPU_SETUP_QUERY=0 so the unused query arrays stay out"
    )
    assert os.environ.get("SNARK_TPU_MSM_AFFINE", "0") == "0"
    from snark_tpu.fields import BN254
    from snark_tpu.groth16 import Groth16
    from snark_tpu.models import MulChainCircuit
    from snark_tpu.snark import serialize as ser

    g16 = Groth16(BN254)
    circuit = MulChainCircuit(seed=FIXTURE_SEED, n=FIXTURE_N)
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(0))
    pk_path = os.path.join(out_dir, os.path.basename(FIXTURE_PK))
    pk.save(pk_path)
    _, proof = _jax_fixture_proof(pk)
    assert g16.verify(vk, [FIXTURE_SEED], proof)
    with open(os.path.join(out_dir, os.path.basename(FIXTURE_PROOF)), "w") as f:
        json.dump(
            {
                "curve": "bn254",
                "circuit": f"mulchain seed={FIXTURE_SEED} n={FIXTURE_N}",
                "setup_rng": "random.Random(0)",
                "public_input": [FIXTURE_SEED],
                "r": str(FIXTURE_R),
                "s": str(FIXTURE_S),
                "proof_bytes_hex": ser.serialize_proof(proof, BN254).hex(),
            },
            f,
            indent=1,
        )


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

TABLES = ("a_tbl", "b_g1_tbl", "b_g2_tbl", "h_tbl", "l_tbl")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pk():
    from snark_tpu.groth16.groth16 import ProvingKey

    return ProvingKey.load(FIXTURE_PK)


@pytest.fixture(scope="module")
def port_pk():
    return TorchProvingKey.load(FIXTURE_PK, device="cpu")


def committed_proof():
    with open(FIXTURE_PROOF) as f:
        return json.load(f)


def vk_tuple(vk):
    return (vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2, vk.gamma_abc_g1)


def test_loader_matches_jax_key(jax_pk, port_pk):
    """Same sizes, vk and (beta, delta), same CSR columns and coefficient
    values, and table rows that decode to the same points."""
    from snark_tpu.fields.host import Fp
    from snark_tpu.fields import BN254 as J_BN254
    from snark_tpu.ops.pallas_curve import get_plane_curve

    assert vk_tuple(port_pk.vk) == vk_tuple(jax_pk.vk)
    assert (port_pk.beta_g1, port_pk.delta_g1) == (jax_pk.beta_g1, jax_pk.delta_g1)
    for attr in ("num_instance", "num_witness", "num_constraints", "domain_size"):
        assert getattr(port_pk, attr) == getattr(jax_pk, attr)
    fr = Fp(J_BN254.fr)
    for name in ("mat_a", "mat_b", "mat_c"):
        pm, jm = getattr(port_pk, name), getattr(jax_pk, name)
        assert np.array_equal(pm.cols.numpy(), np.asarray(jm.cols))
        assert FR.decode(pm.coeffs) == fr.from_mont_limbs_array(np.asarray(jm.coeffs))
    pf = get_plane_curve(J_BN254).pf
    for name in TABLES:
        group = "g2" if name == "b_g2_tbl" else "g1"
        rows = np.asarray(getattr(jax_pk, name))
        assert np.array_equal(getattr(port_pk, name).numpy(), rows)
        sample = rows[:48]
        K = 2 if group == "g2" else 1
        comps = [pf.unpack_np(sample[:, 34 * c : 34 * c + 34].T) for c in range(2 * K)]
        jax_pts = [
            None if f == 0
            else ((comps[0][i], comps[1][i]) if K == 1
                  else ((comps[0][i], comps[1][i]), (comps[2][i], comps[3][i])))
            for i, f in enumerate(sample[:, -1])
        ]
        # the port reads rows through K1's decode: identity + row
        n = len(sample)
        got = C.bucket_madd_rows(
            C.identity(n, group, "cpu"), torch.as_tensor(sample.copy()),
            torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
            torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32), 0, 1, group,
        )
        assert C.limbs_to_points(got, group) == jax_pts == C.rows_to_points(sample, group)


def test_h_table_bit_reversed(jax_pk, port_pk):
    """h_tbl row k holds the h query point of coefficient bitrev(k); the
    row of coefficient n − 1 is the identity."""
    from snark_tpu.fields import BN254 as J_BN254
    from snark_tpu.ops.curve import get_g1_ops

    n = port_pk.domain_size
    h_query = get_g1_ops(J_BN254).to_affine_host(port_pk.query("h_query"))
    assert len(h_query) == n - 1
    rows = C.rows_to_points(port_pk.h_tbl.numpy(), "g1")
    rev = bit_reverse_indices(n)
    assert rows == [h_query[r] if r < n - 1 else None for r in rev]


def test_missing_query_raises(port_pk):
    with pytest.raises(ValueError, match="SNARK_TPU_SETUP_QUERY=0"):
        port_pk.query("a_query")
    with pytest.raises(KeyError):
        port_pk.query("nope")


def test_mulchain_assignment_matches_jax(port_pk):
    """The port's prove-mode synthesis of the fixture circuit gives the JAX
    synthesis's full assignment, and its setup-mode synthesis the columns
    of the JAX key's matrices."""
    from snark_tpu.fields.host import Fp
    from snark_tpu.fields import BN254 as J_BN254
    from snark_tpu.models import MulChainCircuit
    from snark_tpu.relations import SynthesisMode, new_ref

    cs = new_ref(Fp(J_BN254.fr))
    cs.set_mode(SynthesisMode.prove(construct_matrices=False, generate_lc_assignments=False))
    MulChainCircuit(seed=FIXTURE_SEED, n=FIXTURE_N).generate_constraints(cs)
    port = TorchMulChain(seed=FIXTURE_SEED, n=FIXTURE_N)
    assert synthesize_witness(port, BN254) == list(cs.full_assignment())
    coo, values, nc, _, _ = synthesize_matrices(port, BN254)
    for (indptr, col, cid), mat in zip(coo, (port_pk.mat_a, port_pk.mat_b, port_pk.mat_c)):
        assert np.array_equal(indptr, np.arange(nc + 1)) and (cid == 0).all()
        assert np.array_equal(col.reshape(-1, 1), mat.cols.numpy())


def test_prove_fixture_cpu(port_pk):
    """The port's plain path proves the fixture, synthesized by the port
    (`prove(pk, circuit, r, s)`), to the JAX package's committed proof, bit
    for bit, and the proof verifies."""
    want = committed_proof()
    g16 = TorchGroth16(device="cpu")
    circuit = TorchMulChain(seed=FIXTURE_SEED, n=FIXTURE_N)
    proof = g16.prove(port_pk, circuit, r=int(want["r"]), s=int(want["s"]))
    assert list(g16.last_run.stage_ms)[:2] == ["synthesize", "upload"]
    assert tser.serialize_proof(proof, BN254).hex() == want["proof_bytes_hex"]
    assert g16.verify(port_pk.vk, want["public_input"], proof)
    assert not g16.verify(port_pk.vk, [FIXTURE_SEED + 1], proof)


def test_default_device_needs_a_card():
    """Entry points default to CUDA and raise without a card; they never
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchGroth16()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchProvingKey.load(FIXTURE_PK)


@pytest.mark.slow
def test_fixture_proof_matches_jax_prove(jax_pk, monkeypatch):
    """Re-prove the fixture through the JAX package: its proof is the
    committed one."""
    from snark_tpu.fields import BN254 as J_BN254
    from snark_tpu.snark import serialize as ser

    monkeypatch.setenv("SNARK_TPU_MSM_AFFINE", "0")
    g16, proof = _jax_fixture_proof(jax_pk)
    want = committed_proof()
    assert ser.serialize_proof(proof, J_BN254).hex() == want["proof_bytes_hex"]
    assert g16.verify(jax_pk.vk, want["public_input"], proof)
