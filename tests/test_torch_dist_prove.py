"""The port's distributed prover (`parallel/plane_dist.py`
`DistPlaneProver`) on the CPU against the JAX-written proof, and
configuration 4 of `run_configs`.

The committed vector `tests/vectors/proof_bn254.json` is the JAX package's
MulChain(11, 8) key from random.Random(42405) (domain 16) and its proof at
a fixed (r, s). The port sets the key up from the same seed, saves it once,
and every rank of a gloo world (`parallel/launch.py` `run_ranks`) loads it
on the CPU: the six-step split of the domain is n1 = n2 = 4 on two and on
four ranks, and c = 4 gives W = 64 windows, so both rank counts take the
MSM's window-block path.
"""

import json
import os
import random

import pytest
import torch

from snark_tpu_torch.fields import BN254
from snark_tpu_torch.groth16 import Groth16
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch import run_configs as RC
from snark_tpu_torch.parallel import plane_dist as PD
from snark_tpu_torch.parallel.launch import run_ranks
from snark_tpu_torch.snark import serialize as ser

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def key(tmp_path_factory):
    """The vector, the port's CPU prover, the key (saved once), the
    vector's circuit and (r, s)."""
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        vector = json.load(f)
    g16 = Groth16(BN254, device="cpu")
    pk, vk = g16.circuit_specific_setup(MulChainCircuit(seed=11, n=8, batch=False),
                                        random.Random(int(vector["setup_seed"])))
    path = str(tmp_path_factory.mktemp("dist_key") / "pk.npz")
    pk.save(path)
    return vector, g16, pk, vk, path, [MulChainCircuit(seed=11, n=8)], [(int(vector["r"]),
                                                                          int(vector["s"]))]


@pytest.mark.parametrize("ranks", [2, 4])
def test_dist_prove_gives_proof_vector(ranks, key):
    """Every rank's proof has the JAX-written proof bytes, equals the
    port's one-device prove and verifies; the exchanges moved bytes, the
    stages were timed, and no kernel launched on CPU tensors."""
    vector, g16, pk, vk, path, circuits, rs = key
    results = run_ranks(PD.prove_from_file, ranks, "cpu", path, circuits[0], "cpu", "tp", None,
                        *rs[0], timeout_s=240)
    single = g16.prove(pk, circuits[0], r=rs[0][0], s=rs[0][1])
    for out in results:
        assert ser.serialize_proof(out["proof"], BN254).hex() == vector["proof_bytes_hex"]
        assert out["proof"] == single
        assert (out["ranks"], out["backend"], out["n1"], out["n2"]) == (ranks, "gloo", 4, 4)
        assert out["block_path"] and out["launches"] == {}
        assert out["sent_bytes"]["all_to_all"] > 0 and out["sent_bytes"]["all_gather"] > 0
        assert {"matvec", "h", "accumulate", "exchange", "fold", "gather", "combine"} <= set(
            out["stage_ms"])
    assert g16.verify(vk, [11], single)


def test_run_configs_config4(capsys):
    """Configuration 4 runs (it was refused until this slice): at 2^8 in a
    world of two gloo ranks, the distributed window sums (block path) and
    transform equal those of a world of one, and its line has the
    reference's fields."""
    assert RC.main(["4", "--config4-log-n", "8", "--ranks", "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["config"] == 4 and rec["equal"] is True and rec["block_path"] is True
    assert (rec["n"], rec["devices"], rec["ranks"], rec["backend"], rec["cards"]) == (
        256, 2, 2, "gloo", 0)
    assert rec["backend_1dev"] == "gloo"
    for k in ("window_bits", "msm_1dev_s", "msm_ndev_s", "msm_scaling_eff", "ntt_1dev_s",
              "ntt_ndev_s", "ntt_scaling_eff"):
        assert rec[k] > 0, k
