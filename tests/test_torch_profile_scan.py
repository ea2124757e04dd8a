"""`profile_msm` and `profile_scan_parts` run to their end on the CPU at
tiny sizes (`--device cpu`, the kernels' plain versions), their JSON lines
with the expected keys and their `correct` and `equal` flags true. The
checks are `tests/test_torch_profilers.py`'s.
"""

from snark_tpu_torch import profile_msm, profile_scan_parts

from test_torch_profilers import CPU, _torch_threads, check, json_lines  # noqa: F401


def test_profile_msm(capsys):
    assert profile_msm.main(CPU + ["--log-n", "6", "--window", "6", "--iters", "1"]) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    check(rec, "profile_msm", ["sort_ms", "window_sums_ms", "combine_ms", "max_len",
                               "mean_len", "per_step_ms"])
    assert rec["correct"] is True and rec["max_len"] >= rec["mean_len"] > 0


def test_profile_scan_parts(capsys):
    """The shipped scan, K1's main launch, the torch gather in scan order
    and K1 on pre-gathered rows; K1 over perm = iota gives K1's sums."""
    assert profile_scan_parts.main(CPU + ["--log-n", "6", "--window", "4", "--iters", "1"]) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    check(rec, "profile_scan_parts", ["scan_ms", "k1_ms", "gather_ms", "k1_iota_ms",
                                      "steps", "rows"])
    assert rec["equal"] is True and rec["steps"] > 0
