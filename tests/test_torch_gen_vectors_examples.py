"""`snark_tpu_torch/gen_vectors.py` and the port's three examples
(`snark_tpu_torch/examples/`).

gen_vectors, run on the CPU into a temporary directory, must write files
equal byte for byte to the committed `tests/vectors/*.json`, which the JAX
package's `scripts/gen_vectors.py` wrote, and must refuse to write into
`tests/vectors/`. Each example must print what the repository's
`examples/*.py` prints, run in this process, with the numbers that are
times (and the line numbers of each package's own `trace.py`) masked.
"""

import hashlib
import os
import re
import runpy
import sys

import pytest
import torch

from snark_tpu_torch import gen_vectors
from snark_tpu_torch.examples import bench_synthesis, non_satisfiable, satisfiable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors")
NAMES = ("fields_bn254_fr.json", "fields_bls12_381_fr.json", "ntt_bn254_fr.json",
         "curve_bn254.json", "curve_bls12_381.json", "pairing_bn254.json", "proof_bn254.json")
NUMBER = re.compile(r"\d[\d,]*\.?\d*")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the suite runs files side by side on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _digest() -> dict:
    out = {}
    for name in sorted(os.listdir(VECTORS)):
        with open(os.path.join(VECTORS, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_gen_vectors_equals_committed(tmp_path, capsys):
    before = _digest()
    assert gen_vectors.main([str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "out")) == sorted(NAMES)
    for name in NAMES:
        with open(tmp_path / "out" / name, "rb") as got, \
                open(os.path.join(VECTORS, name), "rb") as want:
            assert got.read() == want.read(), name
    assert _digest() == before
    assert '"tool": "gen_vectors"' in capsys.readouterr().out


def test_gen_vectors_refuses_the_committed_directory():
    before = _digest()
    for target in (VECTORS, os.path.join(VECTORS, "sub"), os.path.join(ROOT, "tests", ".",
                                                                      "vectors")):
        with pytest.raises(ValueError, match="committed vectors"):
            gen_vectors.main([target, "--device", "cpu"])
    assert _digest() == before and not os.path.exists(os.path.join(VECTORS, "sub"))


def _reference(name: str):
    return runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"))["main"]


def _masked(text: str) -> list[str]:
    text = re.sub(r"trace\.py:\d+", "trace.py:N", text)
    return [re.sub(r"\d+\.\d+ ms", "T ms", line) for line in text.strip().splitlines()]


def test_examples_print_as_reference(capsys, monkeypatch):
    """satisfiable (the timer tree of finalize, which the script turns on,
    the counts, the verdict) and non_satisfiable (the verdict and
    `which_is_unsatisfied`'s namespace trace); the JAX package's timers
    print only where the script turns them on."""
    for ours, name, timers in ((satisfiable.main, "satisfiable", "1"),
                               (non_satisfiable.main, "non_satisfiable", "0")):
        monkeypatch.setenv("SNARK_TPU_TIMERS", timers)
        _reference(name)()
        want = capsys.readouterr().out
        ours()
        got = capsys.readouterr().out
        assert _masked(got) == _masked(want), name
    assert "Error originated in constraint:\n  0: x^3 + x + 5 == y at trace.py:" in got
    assert "satisfied: False" in got


def test_bench_synthesis_prints_as_reference(capsys, monkeypatch):
    """The four lines, numbers masked, at 2^9 constraints."""
    monkeypatch.setattr(sys, "argv", ["bench_synthesis.py", "9"])
    _reference("bench_synthesis")()
    want = capsys.readouterr().out
    bench_synthesis.main(["9"])
    got = capsys.readouterr().out
    strip = lambda t: [NUMBER.sub("N", line) for line in t.strip().splitlines()]  # noqa: E731
    assert strip(got) == strip(want) and len(strip(got)) == 4
