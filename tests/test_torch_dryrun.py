"""The port's multichip dry run (`snark_tpu_torch/dryrun.py`) and the
launcher of its worlds of ranks (`parallel/launch.py` `run_ranks`) on the
CPU.

`dryrun_multichip(2, "cpu", log_n=6, full=True)` sets up MulChain(5, 62)
(domain 64) and MulChain(5, 8) from random.Random(0), proves the first on
two gloo ranks with `DistPlaneProver` at r = 3, s = 4 and verifies every
rank's proof with public input [5], then runs the lite core of a
`BatchProver` on a (dp, tp) = (1, 2) mesh. The launcher must raise, and
not hang, when a rank raises.
"""

import time

import pytest
import torch

from snark_tpu_torch import dryrun
from snark_tpu_torch.parallel import plane_dist as PD
from snark_tpu_torch.parallel.launch import run_ranks


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_cpu(capsys):
    rec = dryrun.dryrun_multichip(2, "cpu", log_n=6, full=True)
    assert rec["verified"] is True and rec["backend"] == "gloo" and rec["ranks"] == 2
    for r in rec["per_rank"]:
        assert (r["prove"]["n1"], r["prove"]["n2"]) == (8, 8)
        assert r["batch"] == {"dp": 1, "tp": 2, "proofs": 2, "share": [0, 1], "core": "lite",
                              "g1": [2, 1, 3, 1, 8], "g2": [2, 3, 2, 8]}
    assert "every proof verified" in capsys.readouterr().out
    assert dryrun.dp_tp(8) == (2, 4) and dryrun.dp_tp(2) == (1, 2) and dryrun.dp_tp(3) == (3, 1)


def test_launcher_raises_when_a_rank_raises():
    """A rank that raises (here: a six-step split that two ranks cannot
    take) makes run_ranks raise with its traceback, promptly."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="must both split over 2 ranks"):
        run_ranks(PD.dist_transforms, 2, "cpu", [[1] * 9] * 3, 3, 3, "bn254", "cpu",
                  timeout_s=120)
    assert time.monotonic() - t0 < 60
