"""`bench_affine_msm` runs to its end on the CPU at a tiny size
(`--device cpu`, the kernels' plain versions): both accumulations against
the pool oracle, the G2 affine check and the speedup line, every `correct`
flag true. A file of its own so that each file stays well inside 45 s.
"""

from snark_tpu_torch import bench_affine_msm

from test_torch_affine_tools import CPU, _torch_threads, json_lines  # noqa: F401


def test_bench_affine_msm(capsys, monkeypatch):
    """Both modes against the pool oracle on clustered scalars, the G2
    affine check, the speedup line."""
    monkeypatch.setenv("BENCH_CLUSTER", "1")
    assert bench_affine_msm.main(CPU + ["--log-n", "7", "--window", "3", "--iters", "1",
                                        "--g2-log-n", "6", "--g2-window", "3"]) == 0
    recs = json_lines(capsys.readouterr().out)
    assert len(recs) == 4
    affine, proj, g2, last = recs
    assert affine["affine"]["correct"] and affine["affine"]["engaged"]
    assert proj["projective"]["correct"] and proj["projective"]["ms"] is None
    assert g2["g2_affine_correct"] is True
    assert last["correct"] is True and last["speedup"] > 0 and last["cluster"] is True
