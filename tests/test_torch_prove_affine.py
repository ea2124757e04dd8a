"""The port's prover with the batch-affine MSM (`Groth16(affine_msm=True)`)
against the JAX package's committed proof of the fixture
(`tests/vectors/torch_proof_bn254_mulchain1023.json`; see
`tests/test_torch_prove.py`).

Groth16 proofs are deterministic given the key, the witness and (r, s), so
the affine accumulation must give the very proof the scan gives. The
fixture's MulChain witness is the real clustered kind: its MSMs put many
elements into single buckets, which exercises the affine tree's doubles,
inverse pairs and copies and the block scan's spill.
"""

import json
import os

import pytest
import torch

from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.groth16 import Groth16, ProvingKey
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.snark import serialize as ser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_prove_fixture_affine_cpu():
    with open(os.path.join(VECTORS, "torch_proof_bn254_mulchain1023.json")) as f:
        want = json.load(f)
    pk = ProvingKey.load(os.path.join(VECTORS, "torch_pk_bn254_mulchain1023.npz"), device="cpu")
    g16 = Groth16(device="cpu", affine_msm=True)
    proof = g16.prove(pk, MulChainCircuit(seed=4, n=1023), r=int(want["r"]), s=int(want["s"]))
    # A, B, B1 and H have 2048 elements for 2^8 buckets: the affine gate's
    # edge; L has fewer and takes the scan
    engaged = {key: plan.uses_affine(2048) for key, plan in g16._msm.items()}
    assert engaged == {(9, "g1"): True, (9, "g2"): True}
    assert ser.serialize_proof(proof, BN254).hex() == want["proof_bytes_hex"]
    assert g16.verify(pk.vk, want["public_input"], proof)
