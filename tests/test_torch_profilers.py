"""The port's profilers run to their end on the CPU at tiny sizes: each
`main` on the kernels' plain versions (`--device cpu`), its JSON lines
carrying the expected keys, null `nvidia_smi` (no card), and every
`correct` or `equal` flag true: `profile_setup` and `profile_prover_msms`
here, `profile_msm` and `profile_scan_parts` in
`tests/test_torch_profile_scan.py`, the batch-affine ones in
`tests/test_torch_affine_tools.py` (each file well inside 45 s). Timings on the CPU are host-clock
numbers and are only checked to be positive.
"""

import json

import pytest
import torch

from snark_tpu_torch import profile_prover_msms, profile_setup

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


def check(rec: dict, tool: str, keys) -> None:
    assert rec["tool"] == tool and rec["device"] == "cpu" and rec["nvidia_smi"] is None
    missing = set(keys) - set(rec)
    assert not missing, missing
    for k in keys:
        if k.endswith("_ms") and not isinstance(rec[k], dict):
            assert rec[k] > 0, k


def test_profile_setup(capsys):
    """cProfile of a BN254 configuration-3-shaped setup at 2^7: the table,
    then the record with the setup's own stages."""
    assert profile_setup.main(CPU + ["--log-n", "7", "--curve", "bn", "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("TOTAL setup:") and "cumulative" in out
    (rec,) = json_lines(out)
    check(rec, "profile_setup", ["total_s", "stage_ms", "sync_wait_s", "top"])
    assert rec["constraints"] == 64 and len(rec["top"]) == 5
    assert {"synthesize", "vk", "total"} <= set(rec["stage_ms"])


def test_profile_prover_msms(capsys, monkeypatch):
    """Two of the four shapes (PROF_CONFIGS), windows capped at 3, each
    against the pool oracle; PROF_TILES repeats each shape a tile."""
    monkeypatch.setenv("PROF_CONFIGS", "g1u10,g2s11")
    monkeypatch.setenv("PROF_TILES", "256")
    assert profile_prover_msms.main(CPU + ["--log-n", "6", "--iters", "1",
                                           "--max-window", "3"]) == 0
    recs = json_lines(capsys.readouterr().out)
    assert [r["config"] for r in recs] == ["g1u10", "g2s11"]
    for rec in recs:
        check(rec, "profile_prover_msms", ["ms", "adds", "m_adds_per_s", "W", "c"])
        assert rec["correct"] is True and rec["c"] == 3 and rec["tile"] == 256
