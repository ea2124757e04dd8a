"""Build and bind the port's CUDA kernels.

All sources under `csrc/` are compiled by one `nvcc` call into one shared
library with a plain C interface, bound with `ctypes`. The library lands in
`_build/<hash of the sources>/`, so an edit to any source rebuilds it and an
unchanged tree reuses it. Nothing here runs at import: the first kernel
launch builds.

Every pointer and the stream travel as `ctypes.c_void_p`, every count as
`ctypes.c_int`. Each C entry point returns `cudaGetLastError()` after its
launch, and `check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libsnark_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # group, acc_in, acc_out, table, row_bytes, perm, lane_base, start,
    # length, lanes, i0, k_steps, stream
    "snark_bucket_madd_rows": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    # group, p, q, mask, out, lanes, stream
    "snark_masked_add": [_I, _P, _P, _P, _P, _I, _P],
    # x, y, tw, n, log_half, tw_stride, dif, stream
    "snark_ntt_stage": [_P, _P, _P, _I, _I, _I, _I, _P],
    # mode, out, a, b, c, d, n, b_bcast, stream
    "snark_field_ew": [_I, _P, _P, _P, _P, _P, _I, _I, _P],
}

# Launch counts, one per kernel instance (the curve kernels per group):
# each wrapper adds one where it launches.
LAUNCHES = {
    "bucket_madd_rows_g1": 0,
    "bucket_madd_rows_g2": 0,
    "masked_add_g1": 0,
    "masked_add_g2": 0,
    "ntt_stage": 0,
    "field_ew": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class BuildResult:
    """Where the library is, how long its build took and what ptxas said."""

    def __init__(self, path: str, seconds: float, log: str, built: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.built = built


def build() -> BuildResult:
    """Compile every source with one nvcc call, unless this tree's library
    already exists. Writes to a temporary name and renames, so a process
    that dies mid-build leaves no half-written library behind."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    if os.path.isfile(lib):
        log = open(log_path).read() if os.path.isfile(log_path) else ""
        return BuildResult(lib, 0.0, log, built=False)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cus = [s for s in sources() if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    seconds = time.time() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log, built=True)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build().path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(kernel: str, counter: str, *args) -> None:
    """Call `snark_<kernel>` on the current stream, add one to
    LAUNCHES[counter] and raise if the launch was refused."""
    fn = getattr(_library(), "snark_" + kernel)
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[counter] += 1
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch")


def require_cuda(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
