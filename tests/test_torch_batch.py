"""The port's batched prover (`parallel/batch.py` `BatchProver`) and its
configuration runner (`run_configs.py`) on the CPU.

On CPU tensors every kernel of the batch's device core runs its plain
version, K18's plain Horner combine included. The committed vector
`tests/vectors/proof_bn254.json` is the JAX package's MulChain(11, 8) key
from random.Random(42405) and its proof at a fixed (r, s): a batch whose
first circuit is that one gives its proof bytes, and every proof of the
batch equals the single prover's at the same (r, s). The zero-knowledge
guard is held against the JAX `prove_batch` on a JAX-loaded key.
"""

import json
import os
import random

import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.groth16 import Groth16 as J_Groth16
from snark_tpu.groth16 import ProvingKey as J_ProvingKey
from snark_tpu.parallel import BatchProver as J_BatchProver
from snark_tpu_torch import _native
from snark_tpu_torch import run_configs as RC
from snark_tpu_torch.fields import BN254, Fp
from snark_tpu_torch.groth16 import Groth16, ProvingKey, assemble_proof
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.ops.curve import identity
from snark_tpu_torch.parallel import BatchProver
from snark_tpu_torch.snark import serialize as ser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
SEEDS = (11, 12, 13)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vector():
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def batch(vector):
    """MulChain(11, 8)'s key from random.Random(42405) on the CPU, and one
    batch of seeds 11, 12, 13 (the vector's (r, s) first), with the K18
    launches the batch counted (none: CPU tensors take the plain combine)."""
    g16 = Groth16(BN254, device="cpu")
    pk, vk = g16.circuit_specific_setup(MulChainCircuit(seed=11, n=8, batch=False),
                                        random.Random(int(vector["setup_seed"])))
    rs = [(int(vector["r"]), int(vector["s"])), (1, 2), (3 << 200, 5 << 100)]
    circuits = [MulChainCircuit(seed=s, n=8) for s in SEEDS]
    bp = BatchProver(g16, pk)
    _native.reset_launches()
    proofs = bp.prove_batch(circuits, rs=rs)
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    return g16, pk, vk, circuits, rs, bp, proofs, launches


def test_batch_gives_proof_vector(batch, vector):
    """The first proof of the batch is the JAX-written proof of seed 11;
    the batch's stages are timed and no kernel launched on the CPU."""
    g16, pk, vk, circuits, rs, bp, proofs, launches = batch
    assert ser.serialize_vk(vk).hex() == vector["vk_bytes_hex"]
    assert ser.serialize_proof(proofs[0], BN254).hex() == vector["proof_bytes_hex"]
    assert list(bp.last_run.stage_ms) == ["synthesize", "device", "readback", "assemble"]
    assert list(bp.last_run.device_ms) == ["upload", "matvec", "h", "digits", "window_sums",
                                           "combine"]
    assert launches == {}


def test_batch_equals_single_prove(batch, monkeypatch):
    """Every proof equals `prove` at its (r, s) and verifies with [seed]
    alone. With an rng, each proof's r, then s, is drawn in order, as the
    JAX prove_batch draws them; deterministic=True takes r = s = 0 (both
    checked with the device core replaced by identity sums, so the proofs
    are assemble_proof's on them)."""
    g16, pk, vk, circuits, rs, bp, proofs, _ = batch
    pvk = g16.process_vk(vk)
    for seed, circuit, (r, s), proof in zip(SEEDS, circuits, rs, proofs):
        assert proof == g16.prove(pk, circuit, r=r, s=s)
        assert g16.verify_with_processed_vk(pvk, [seed], proof)
        assert not g16.verify_with_processed_vk(pvk, [seed + 1], proof)
    assert len(set(map(repr, proofs))) == 3

    def identity_sums(z, out_g1, out_g2, tick):
        out_g1.copy_(identity(4, "g1", "cpu", BN254))
        out_g2.copy_(identity(1, "g2", "cpu", BN254)[0])

    monkeypatch.setattr(bp, "_one_proof", identity_sums)
    fr, draws = Fp(BN254.fr), random.Random(8)
    want = [(fr.rand(draws), fr.rand(draws)) for _ in circuits]
    for got, (r, s) in zip(bp.prove_batch(circuits, rng=random.Random(8)), want):
        assert got == assemble_proof(g16, pk, None, None, None, None, None, r, s)
    (zero,) = bp.prove_batch(circuits[:1], deterministic=True)
    assert zero == assemble_proof(g16, pk, None, None, None, None, None, 0, 0)


def test_zero_knowledge_guard_as_jax():
    """prove_batch with no rng, no rs and no deterministic raises the JAX
    prove_batch's ValueError, on both packages' loads of one committed
    JAX key."""
    path = os.path.join(VECTORS, "torch_pk_bn254_mulchain12.npz")
    with pytest.raises(ValueError, match="zero-knowledge") as want:
        J_BatchProver(J_Groth16(J_BN254), J_ProvingKey.load(path), mesh=None).prove_batch([])
    bp = BatchProver(Groth16(BN254, device="cpu"), ProvingKey.load(path, device="cpu"))
    with pytest.raises(ValueError, match="zero-knowledge") as got:
        bp.prove_batch([MulChainCircuit(seed=7, n=12)])
    assert str(got.value) == str(want.value)
    assert bp.last_run is None


def test_key_assignment_mismatch_raises():
    """A circuit whose assignment is not the key's size, a key of another
    curve and a wrong count of (r, s) pairs raise before any device work."""
    path = os.path.join(VECTORS, "torch_pk_bn254_mulchain12.npz")
    pk = ProvingKey.load(path, device="cpu")
    bp = BatchProver(Groth16(BN254, device="cpu"), pk)
    with pytest.raises(ValueError, match="assignment has 24 values, the key 26"):
        bp.prove_batch([MulChainCircuit(seed=7, n=12), MulChainCircuit(seed=7, n=11)],
                       rs=[(1, 2), (3, 4)])
    with pytest.raises(ValueError, match="pairs"):
        bp.prove_batch([MulChainCircuit(seed=7, n=12)], rs=[(1, 2), (3, 4)])
    from snark_tpu_torch.fields import BLS12_381

    with pytest.raises(ValueError, match="bn254 key for a bls12_381 prover"):
        BatchProver(Groth16(BLS12_381, device="cpu"), pk)
    assert bp.last_run is None


def test_run_configs_config1_and_refusals(capsys):
    """Configuration 1 synthesizes and satisfies the 2^10 chain; asking
    for a configuration the runner does not have exits with its reason
    before any runs (configuration 4, refused until the distributed slice,
    runs in `tests/test_torch_dryrun.py`)."""
    rec = RC.config1()
    assert rec["config"] == 1 and rec["satisfied"] is True and rec["constraints"] == 1 << 10
    assert RC.main(["1"]) == 0
    assert json.loads(capsys.readouterr().out)["satisfied"] is True
    with pytest.raises(SystemExit) as exit_6:
        RC.main(["1", "6"])
    assert exit_6.value.code == 2
    err = capsys.readouterr()
    assert "no configuration [6]" in err.err and err.out == ""
