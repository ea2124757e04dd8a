"""Whole-prove parity of the port against the JAX package on small
circuits, on both curves, and the committed BN254 proof vector.

The fixtures `tests/vectors/torch_pk_{bn254,bls12_381}_mulchain12.npz` are
JAX-package proving keys for MulChain(seed=7, n=12): 12 constraints, domain
16, m = 26 variables. The reference proves such a circuit on its legacy
path (m < 2048); the port runs its plane path at every size, and the
proof is the same value. `torch_proof_*_mulchain12.json` hold the JAX
package's proofs at a fixed (r, s). `generate_fixture` wrote all four files
once; the default suite only reads them.
"""

import json
import os
import random

import pytest
import torch

from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import Groth16 as TorchGroth16
from snark_tpu_torch.groth16 import ProvingKey as TorchProvingKey
from snark_tpu_torch.groth16.groth16 import Proof as TorchProof
from snark_tpu_torch.models import MulChainCircuit as TorchMulChain
from snark_tpu_torch.snark import serialize as tser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
CURVES = {"bn254": BN254, "bls12_381": BLS12_381}
SEED, N = 7, 12
R, S = 123456789, 987654321


def fixture_paths(name: str) -> tuple[str, str]:
    return (
        os.path.join(VECTORS, f"torch_pk_{name}_mulchain{N}.npz"),
        os.path.join(VECTORS, f"torch_proof_{name}_mulchain{N}.json"),
    )


def generate_fixture(out_dir: str = VECTORS) -> None:
    """Write both fixtures with the JAX package on JAX-CPU (BLS12-381:
    about a minute of setup and two of prove). Run once by hand:
    `SNARK_TPU_MSM_AFFINE=0 JAX_PLATFORMS=cpu python -c
    "from tests.test_torch_bls_prove import generate_fixture as g; g()"`.
    The keys keep their query arrays: the reference proves a circuit this
    small from them."""
    assert os.environ.get("SNARK_TPU_MSM_AFFINE", "0") == "0"
    from snark_tpu.fields import BLS12_381 as J_BLS, BN254 as J_BN254
    from snark_tpu.groth16 import Groth16
    from snark_tpu.models import MulChainCircuit
    from snark_tpu.snark import serialize as ser

    for name, curve in (("bn254", J_BN254), ("bls12_381", J_BLS)):
        pk_path, proof_path = (os.path.join(out_dir, os.path.basename(p)) for p in fixture_paths(name))
        g16 = Groth16(curve)
        circuit = MulChainCircuit(seed=SEED, n=N)
        pk, vk = g16.circuit_specific_setup(circuit, random.Random(0))
        pk.save(pk_path)
        proof = g16.prove(pk, circuit, r=R, s=S)
        assert g16.verify(vk, [SEED], proof)
        with open(proof_path, "w") as f:
            json.dump(
                {
                    "curve": name,
                    "circuit": f"mulchain seed={SEED} n={N}",
                    "setup_rng": "random.Random(0)",
                    "public_input": [SEED],
                    "r": str(R),
                    "s": str(S),
                    "proof_bytes_hex": ser.serialize_proof(proof, curve).hex(),
                },
                f,
                indent=1,
            )


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CURVES))
def test_prove_small_fixture_cpu(name):
    """m = 26: the port's plane path proves the JAX fixture, from the
    port's synthesis of the circuit, to the committed JAX proof, bit for
    bit, and the proof verifies."""
    curve = CURVES[name]
    pk_path, proof_path = fixture_paths(name)
    with open(proof_path) as f:
        want = json.load(f)
    pk = TorchProvingKey.load(pk_path, device="cpu")
    assert pk.num_instance + pk.num_witness == 26 and pk.domain_size == 16
    g16 = TorchGroth16(curve, device="cpu")
    proof = g16.prove(pk, TorchMulChain(seed=SEED, n=N), r=int(want["r"]), s=int(want["s"]))
    assert tser.serialize_proof(proof, curve).hex() == want["proof_bytes_hex"]
    assert g16.verify(pk.vk, want["public_input"], proof)
    assert not g16.verify(pk.vk, [SEED + 1], proof)


def test_committed_vector_proof_bn254():
    """The port's verify and codecs on `tests/vectors/proof_bn254.json`
    (as `tests/test_vectors.py` holds the JAX package to it)."""
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        v = json.load(f)
    vk_bytes = bytes.fromhex(v["vk_bytes_hex"])
    proof_bytes = bytes.fromhex(v["proof_bytes_hex"])
    vk = tser.deserialize_vk(vk_bytes, BN254)
    proof = tser.deserialize_proof(proof_bytes, BN254)
    g16 = TorchGroth16(BN254, device="cpu")
    assert g16.verify(vk, [11], proof)
    assert not g16.verify(vk, [12], proof)
    assert not g16.verify(vk, [11], TorchProof(a=proof.c, b=proof.b, c=proof.a))
    # byte round trip
    assert tser.serialize_proof(proof, BN254).hex() == v["proof_bytes_hex"]
    assert tser.serialize_vk(vk).hex() == v["vk_bytes_hex"]


def test_bls_affine_msm_refused():
    """`affine_msm=True` is not refused on BLS12-381: such a prover proves
    the m = 26 fixture to the committed JAX proof, and the proof verifies.
    The affine tree does not engage at this size (it needs n >= 8·2^cb, 64
    points at the small circuits' window c = 4, and the largest MSM here
    has 26), so every MSM takes the scan, as the reference's would; the
    tree itself is held in `tests/test_torch_bls_affine.py`."""
    pk_path, proof_path = fixture_paths("bls12_381")
    with open(proof_path) as f:
        want = json.load(f)
    pk = TorchProvingKey.load(pk_path, device="cpu")
    g16 = TorchGroth16(BLS12_381, device="cpu", affine_msm=True)
    proof = g16.prove(pk, TorchMulChain(seed=SEED, n=N), r=int(want["r"]), s=int(want["s"]))
    assert tser.serialize_proof(proof, BLS12_381).hex() == want["proof_bytes_hex"]
    assert g16.verify(pk.vk, want["public_input"], proof)
    assert g16.last_run.affine == dict.fromkeys(("A", "B", "B1", "L", "H"), False)
