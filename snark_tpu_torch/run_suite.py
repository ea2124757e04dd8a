"""The port's tests, one pytest process a file.

    python -m snark_tpu_torch.run_suite [--device cpu|cuda] [--files GLOB ...] [PYTEST_ARGS ...]

The counterpart of the repository's `scripts/run_suite.py`, its
process-isolated runner: each test file runs in a pytest process of its
own (so one file's crash or compile state cannot reach the next), with a
per-file time limit of SUITE_TIMEOUT seconds (1200). The default pytest
arguments are the script's `-m "not slow"`; any others replace them.

    --device cpu   (or no card): `tests/test_torch_*.py`, the port held
                   against the JAX package on the CPU, as the suite runs
    --device cuda  (the default): `tests/test_torch_gpu.py`, the tests
                   marked `gpu`, with `-m gpu --noconftest -p
                   no:cacheprovider` (the repository's `tests/conftest.py`
                   imports JAX, which the card's machine does not have)

`--files` replaces the files with globs relative to the repository.
Prints a line a file ([ok] or [FAIL], seconds, pytest's last line), then
one JSON line: files, failed, green, wall_s. Exits 0 when every file's
process exits 0 or 5 (no test selected by the marker).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_FILES = ("tests/test_torch_*.py",)
GPU_FILES = ("tests/test_torch_gpu.py",)
GPU_ARGS = ("-m", "gpu", "--noconftest", "-p", "no:cacheprovider")


def run_files(files: list[str], extra: list[str], timeout: int) -> dict:
    failed, t_suite = [], time.time()
    for rel in files:
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", rel, "-q", *extra],
                cwd=REPO, timeout=timeout, capture_output=True, text=True,
            )
            rc = proc.returncode
            note = ((proc.stdout or "").strip().splitlines()[-1:] or [""])[0][:120]
        except subprocess.TimeoutExpired:
            rc, note = -9, f"TIMEOUT after {timeout}s"
        ok = rc in (0, 5)  # 5: no test selected by the marker
        print(f"[{'ok' if ok else 'FAIL':4s}] {rel:42s} {time.time() - t0:7.1f}s  {note}",
              flush=True)
        if not ok:
            failed.append(rel)
    return {"files": len(files), "failed": failed, "green": not failed,
            "wall_s": time.time() - t_suite}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's tests, one pytest process a file.")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--files", nargs="+", default=None)
    a, extra = ap.parse_known_args(argv)
    cuda = a.device.startswith("cuda")
    if cuda:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass --device cpu to run the CPU suite)")
    patterns = a.files or (GPU_FILES if cuda else CPU_FILES)
    files = sorted({os.path.relpath(f, REPO) for p in patterns
                    for f in glob.glob(os.path.join(REPO, p))})
    if not files:
        raise SystemExit(f"run_suite: no test file matches {patterns}")
    extra = extra or (list(GPU_ARGS) if cuda else ["-m", "not slow"])
    summary = run_files(files, extra, int(os.environ.get("SUITE_TIMEOUT", "1200")))
    print(json.dumps({"tool": "run_suite", "device": a.device, **summary}), flush=True)
    return 0 if summary["green"] else 1


if __name__ == "__main__":
    sys.exit(main())
