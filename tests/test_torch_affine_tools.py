"""The port's batch-affine profilers run to their end on the CPU at tiny
sizes (`--device cpu`, the kernels' plain versions): `profile_affine_stages`
and `profile_affine_front`, their JSON lines with the expected keys and
every `equal` flag true (`bench_affine_msm`: `tests/test_torch_bench_affine_msm.py`).
"""

import json

import pytest
import torch

from snark_tpu_torch import profile_affine_front, profile_affine_stages

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the suite runs files side by side on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_profile_affine_stages(capsys):
    """Level 0 at 2^7, c = 3: the gathers, K6, one K7 product, the batch
    inverse (host and device clocks), K8, the whole accumulation; K6 and
    K8 equal their plain versions."""
    assert profile_affine_stages.main(CPU + ["--log-n", "7", "--window", "3", "--iters", "1"]) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    for k in ("gather_ms", "blocks_ms", "phase1_ms", "tree_mul_ms", "phase3_ms",
              "accumulate_ms"):
        assert rec[k] > 0, k
    assert rec["batch_inverse"]["device_ms"] > 0 and rec["batch_inverse"]["host_ms"] > 0
    assert rec["pairs"] * 2 == rec["slots"] and rec["B0"] == 4
    assert rec["equal"] is True and rec["nvidia_smi"] is None


def test_profile_affine_front(capsys):
    assert profile_affine_front.main(CPU + ["--log-n", "7", "--window", "3", "--iters", "1"]) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    for k in ("sort_ms", "front_ms", "tail_ms", "window_sums_ms"):
        assert rec[k] > 0, k
    assert rec["slots"] == rec["TB"] * rec["B0"]
    assert rec["equal"] is True and rec["affine_engaged"] is True
