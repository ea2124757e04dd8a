"""Build and bind the port's CUDA kernels.

Each `.cu` source under `csrc/` is compiled by its own `nvcc` process, all
started together, and one more `nvcc` call links the objects into one
shared library with a plain C interface, bound with `ctypes`. The library
lands in `_build/<hash of the sources>/`, so an edit to any source rebuilds
it and an unchanged tree reuses it. Nothing here runs at import: the first kernel
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # curve, group, acc_in, acc_out, table, row_bytes, perm, lane_base,
    # start, length, lanes, i0, k_steps, stream
    "snark_bucket_madd_rows": [_I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    # K1's parts (csrc/madd_parts.cu): curve, group, part, then as
    # snark_bucket_madd_rows
    "snark_bucket_madd_rows_part": [_I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    # curve, group, p, q, mask, out, lanes, stream
    "snark_masked_add": [_I, _I, _P, _P, _P, _P, _I, _P],
    # curve, x, y, tw, n, s0, k, log_g, tw_log, dif, had_b, had_c, had_d,
    # scale, stream
    "snark_ntt_pass": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # curve, mode, out, a, b, c, d, n, b_bcast, stream
    "snark_field_ew": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # curve, group, p, out, lanes, stream
    "snark_point_double": [_I, _I, _P, _P, _I, _P],
    # curve, group, sums, out, windows, c, stream
    "snark_horner_combine": [_I, _I, _P, _P, _I, _I, _P],
    # K18's latency probe: curve, in, out, cycles, n, mode, stream
    "snark_chain_latency": [_I, _P, _P, _P, _I, _I, _P],
    # curve, group, rows, row_bytes, sgn, den, cls, pairs, stream
    "snark_affine_phase1": [_I, _I, _P, _I, _P, _P, _P, _I, _P],
    # curve, group, mode, a, b, out, n, stream
    "snark_affine_tree_mul": [_I, _I, _I, _P, _P, _P, _I, _P],
    # curve, group, phase (0 up, 1 top, 2 down), den, out, workspace,
    # workspace elements, n, stream
    "snark_affine_batch_inverse": [_I, _I, _I, _P, _P, _P, _I, _I, _P],
    # curve, group, rows, row_bytes, sgn, dinv, cls, out, pairs, stream
    "snark_affine_phase3": [_I, _I, _P, _I, _P, _P, _P, _P, _I, _P],
    # curve, group, p, x2, y2, mask, out, lanes, stream
    "snark_masked_mixed_add": [_I, _I, _P, _P, _P, _P, _P, _I, _P],
    # curve (of the scalar field), a, b, out, n, threads per block, stream
    "snark_mont_mul16": [_I, _P, _P, _P, _I, _I, _P],
    "snark_mont_mul16_limb_major": [_I, _P, _P, _P, _I, _I, _P],
    # the roofline kernels (csrc/vpu_peak.cu), over no field:
    # a, b, out, elements, reps, threads per block, stream
    "snark_fma_chain": [_P, _P, _P, _I, _I, _I, _P],
    # in, out, lanes, reps, threads, stream
    "snark_sweep_chain": [_P, _P, _I, _I, _I, _P],
    # a, b, out, lanes, reps, threads, stream
    "snark_conv_chain": [_P, _P, _P, _I, _I, _I, _P],
    "snark_mont_mul_chain": [_P, _P, _P, _I, _I, _I, _P],
    # the decomposition kernels (csrc/mul_parts.cu): a, b, out, band
    # fragments, lanes, kind, grid, block, shared bytes, reps, stream
    "snark_reduce_parts_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, b, out, lanes, kind, grid, block, shared bytes, reps, stream
    "snark_bisect_chain": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # K16 (0) or K17 (1), kind, shared bytes -> resident blocks an SM
    "snark_parts_occupancy": [_I, _I, _I],
}

# The curve code every entry point takes first (csrc/field.cuh), and the
# kernels each curve has instances of (every kernel, on both curves). An
# entry point returns NOT_PORTED for a curve it has no instance for; the
# wrappers refuse such a call before it reaches the library
# (`require_ported`). The roofline kernels K12-K15 and the decomposition
# kernels K16-K17 take no curve: K12-K14 work on plain floats, K15-K17 are
# compiled for BN254 Fq alone (`_FREE_KERNELS`). K16 counts its launches
# per kind and block width, K17 per kind. K1's parts (`bucket_madd_rows_part`)
# have BN254 G1 instances alone and count their launches per part
# (`_PART_KERNELS`).
CURVE_CODES = {"bn254": 0, "bls12_381": 1}
NOT_PORTED = -1
_KERNELS = frozenset({
    "bucket_madd_rows", "masked_add", "point_double", "ntt_pass", "field_ew",
    "affine_phase1", "affine_tree_mul", "affine_phase3", "affine_batch_inverse",
    "masked_mixed_add",
    "mont_mul16", "mont_mul16_limb_major", "horner_combine", "chain_latency",
})
# kernels over one field of the curve (a scalar field; the base field for
# K18's latency probe): one counter per curve, not per group
_SCALAR_KERNELS = ("ntt_pass", "field_ew", "mont_mul16", "mont_mul16_limb_major",
                   "chain_latency")
_PORTED = {"bn254": _KERNELS | {"bucket_madd_rows_part"}, "bls12_381": _KERNELS}
MADD_PARTS = ("nosub", "halfmul", "nodecode")  # K1's parts, by their code 1, 2, 3
_PART_KERNELS = tuple(f"bucket_madd_rows_part_{part}" for part in MADD_PARTS)
_FREE_KERNELS = (
    "fma_chain", "sweep_chain", "conv_chain", "mont_mul_chain",
    *(f"reduce_parts_chain_{kind}_{T}" for kind in "ABC" for T in (512, 2048)),
    *(f"bisect_chain_{kind}" for kind in ("conv0", "conv1", "conv3", "conv9", "sweep9", "convreg")),
)


def counter_name(kernel: str, curve: str, group: str | None = None) -> str:
    """The launch counter of one kernel instance: `bucket_madd_rows_g1`,
    `ntt_pass` for BN254 (the names of the first slices), and the curve
    between kernel and group for the others (`bucket_madd_rows_bls12_381_g1`,
    `ntt_pass_bls12_381`)."""
    parts = [kernel] + ([] if curve == "bn254" else [curve]) + ([group] if group else [])
    return "_".join(parts)


def require_ported(kernel: str, curve: str) -> None:
    """Raise for a kernel that has no instance for this curve (a curve
    outside `CURVE_CODES`, or a kernel not in its `_PORTED` set): no other
    curve's arithmetic runs in its place."""
    if kernel not in _PORTED.get(curve, ()):
        raise NotImplementedError(
            f"{kernel} has no {curve} instance yet (ported for {curve}: "
            f"{', '.join(sorted(_PORTED.get(curve, ()))) or 'none'})"
        )


def _counters() -> dict:
    """Launch counts, one per kernel instance (the curve kernels per group,
    the curve-free kernels by name alone, K1's parts per part): each
    wrapper adds one where it launches. `point_add` is K2 launched without
    a mask by its own wrapper."""
    out = dict.fromkeys(_FREE_KERNELS + _PART_KERNELS, 0)
    for curve, kernels in _PORTED.items():
        for k in sorted(kernels & _KERNELS):
            if k in _SCALAR_KERNELS:
                out[counter_name(k, curve)] = 0
                continue
            for g in ("g1", "g2"):
                out[counter_name(k, curve, g)] = 0
                if k == "masked_add":
                    out[counter_name("point_add", curve, g)] = 0
    return out


LAUNCHES = _counters()


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
    """Compile every source, unless this tree's library already exists:
    one `nvcc -c` per `.cu`, all running at once, then one link. Writes to
    a temporary name and renames, so a process that dies mid-build leaves
    no half-written library behind."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    if os.path.isfile(lib):
        log = open(log_path).read() if os.path.isfile(log_path) else ""
        return BuildResult(lib, 0.0, log, built=False)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.time()
    jobs = []
    for cu in (s for s in sources() if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(cu)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu]
        proc = subprocess.Popen(
            cmd, cwd=CSRC, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((obj, proc))
    try:
        log, failed = "", ""
        for obj, proc in jobs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:  # only the failing sources' output
                failed += f"{os.path.basename(obj).split('.')[0]}.cu: exit {proc.returncode}\n{out}"
        if failed:
            raise RuntimeError(f"nvcc failed:\n{failed}")
        tmp = f"{lib}.{tag}"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp]
        proc = subprocess.run(link + [o for o, _ in jobs], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    finally:
        for obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.time() - t0
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
    """Call `snark_<kernel>` on the current stream (args begin with the
    curve code, but for the curve-free kernels), add one to
    LAUNCHES[counter] and raise if the launch was refused."""
    fn = getattr(_library(), "snark_" + kernel)
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[counter] += 1
    if code == NOT_PORTED:
        raise NotImplementedError(f"{kernel}: the library has no instance for curve code {args[0]}")
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch")


def require_aligned(*tensors: torch.Tensor) -> None:
    """Kernels that move 16 bytes at a time take 16-byte aligned data."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"data at {t.data_ptr():#x} is not 16-byte aligned")


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
