"""The port's remaining tools run to their end on the CPU at tiny sizes
(`--device cpu`): `bench_scan_overlap`, `bench_gather`, `bench_synth` and
`run_suite`, their lines with the expected keys and every `correct` or
`equal` flag true.
"""

import json

import pytest
import torch

from snark_tpu_torch import bench_gather, bench_scan_overlap, bench_synth, run_suite

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


def test_bench_scan_overlap(capsys):
    """nogather, dep, dep_torch, pipe; the three that gather agree."""
    assert bench_scan_overlap.main(CPU + ["--lanes", "128", "--log-table", "9", "--steps", "3",
                                          "--iters", "1"]) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    for v in ("nogather", "dep", "dep_torch", "pipe"):
        assert rec[f"{v}_ms_per_step"] > 0, v
    assert "gather_tax_pipe_ms" in rec and rec["equal"] is True and rec["steps"] == 3


def test_bench_gather(capsys):
    """The four row cases at one m, and the lane-axis case."""
    assert bench_gather.main(CPU + ["--log-table", "10", "--log-m", "6", "--iters", "1"]) == 0
    recs = json_lines(capsys.readouterr().out)
    assert [r["kind"] for r in recs] == ["u8x72", "u8x8", "u8x144", "f32x18", "lane_f32x34"]
    for rec in recs:
        assert rec["direct_ms"] > 0 and rec["t_hi_ms"] > 0 and "ns_per_row" in rec


def test_bench_synth(capsys):
    assert bench_synth.main(["10"] + CPU) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    res = rec["results"]
    for k in ("native_synth_s", "native_witness_eval_s", "native_inline_s",
              "python_batch_chain_s", "nnz", "witness_eval_checksum"):
        assert k in res, k
    assert rec["correct"] is True and rec["metric"] == "gr1cs_synthesis_2e10"


def test_run_suite(tmp_path, capsys):
    """A passing and a failing file, each in its own process: the summary
    names the failing one and the exit code is 1; the passing one alone
    gives 0."""
    (tmp_path / "test_ok.py").write_text("def test_ok():\n    assert True\n")
    (tmp_path / "test_bad.py").write_text("def test_bad():\n    assert False\n")
    files = [str(tmp_path / "test_ok.py"), str(tmp_path / "test_bad.py")]
    assert run_suite.main(CPU + ["--files", *files, "-p", "no:cacheprovider"]) == 1
    out = capsys.readouterr().out
    summary = json_lines(out)[-1]
    assert summary["files"] == 2 and summary["green"] is False
    assert len(summary["failed"]) == 1 and summary["failed"][0].endswith("test_bad.py")
    assert "[ok  ]" in out and "[FAIL]" in out
    assert run_suite.main(CPU + ["--files", files[0], "-p", "no:cacheprovider"]) == 0
