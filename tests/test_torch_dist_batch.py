"""The port's batched prover with its batch split over the dp axis of a
mesh of ranks (`parallel/batch.py` `BatchProver(g16, pk, mesh, "dp")`), its
h pipeline alone (`h_core`) and its `lite` core, on the CPU.

The key is MulChain(11, 8)'s from random.Random(42405), the JAX-written
key of `tests/vectors/proof_bn254.json`, saved once; each rank of a gloo
world of four (`parallel/launch.py` `run_ranks`) loads it. The batch is two
proofs on a (dp, tp) = (2, 2) mesh, so each dp coordinate proves one and
two ranks prove each. On CPU tensors K18's plain Horner combine takes 1.5-2
s a combine at W = 64, c = 4 (five a proof), which sets the batch's size.
"""

import json
import os
import random

import pytest
import torch

from snark_tpu_torch.fields import BN254
from snark_tpu_torch.groth16 import Groth16, synthesize_witness
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.ops.curve import limbs_to_points
from snark_tpu_torch.ops.msm import pick_window_plane_signed, signed_digits
from snark_tpu_torch.parallel import BatchProver
from snark_tpu_torch.parallel import batch as PB
from snark_tpu_torch.parallel.launch import run_ranks

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
SEEDS = (11, 12)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def key(tmp_path_factory):
    """The port's CPU prover, the key (saved once), the circuits and their
    (r, s), the vector's first."""
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        vector = json.load(f)
    g16 = Groth16(BN254, device="cpu")
    pk, _ = g16.circuit_specific_setup(MulChainCircuit(seed=11, n=8, batch=False),
                                       random.Random(int(vector["setup_seed"])))
    path = str(tmp_path_factory.mktemp("batch_key") / "pk.npz")
    pk.save(path)
    rs = [(int(vector["r"]), int(vector["s"])), (3 << 200, 5 << 100)]
    return g16, pk, path, [MulChainCircuit(seed=s, n=8) for s in SEEDS], rs


def test_dp_batch_prover(key):
    """The batch of two on a (2, 2) mesh: every rank returns every proof,
    each equal to the one-device prove at its (r, s); the ranks of one dp
    coordinate prove the same share; `h_core` gives each proof's h digits.
    Without a mesh, a lite core computes the A and B sums alone (equal to
    the one-device prove's), and a lite prover refuses prove_batch."""
    g16, pk, path, circuits, rs = key
    results = run_ranks(PB.batch_from_file, 4, "cpu", path, circuits, rs, (2, 2), ("dp", "tp"),
                        "dp", "cpu", True, timeout_s=240)
    c = pick_window_plane_signed(pk.num_instance + pk.num_witness)
    singles, h_digits = [], []
    for circuit, (r, s) in zip(circuits, rs):
        singles.append(g16.prove(pk, circuit, r=r, s=s))
        h_digits.append(signed_digits(g16.last_run.h_std, c, BN254.fr.num_bits))
    for out in results:
        assert out["proofs"] == singles and out["backend"] == "gloo"
        assert out["share"] == [out["coords"]["dp"]]
        assert list(out["stage_ms"]) == ["synthesize", "device", "readback", "assemble",
                                         "gather"]
        for j, b in enumerate(out["share"]):
            assert torch.equal(out["h_core"][j], h_digits[b])
    g16.prove(pk, circuits[0], r=rs[0][0], s=rs[0][1])
    lite = BatchProver(g16, pk, lite=True)
    g1, g2 = lite.core([synthesize_witness(circuits[0], BN254)])
    assert (g1.shape[:2], g2.shape[0]) == ((1, 1), 1)
    assert limbs_to_points(g1[0]) == [g16.last_run.sums["A"]]
    assert limbs_to_points(g2, "g2") == [g16.last_run.sums["B"]]
    with pytest.raises(ValueError, match="lite"):
        lite.prove_batch(circuits, rs=rs)
