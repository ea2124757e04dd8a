"""ctypes bridge to the native LC engine (`csrc/lc_engine.cpp`).

The port's own copy of the JAX package's `relations/native.py`. The engine
is host C++: it is compiled with g++ on first use into
`_build/lc_engine-<hash of the source and flags>/`, so an edit to the
source rebuilds it and an unchanged tree reuses it. A failed build raises
with the compiler's output; nothing falls back to the Python pass in its
place (`ConstraintSystem.inline_all_lcs_python` is the plain version, for
systems below the native threshold). The engine supports moduli up to 256
bits (every scalar field; the relations layer only ever inlines over Fr).
The port's copy of the engine holds its inline pass and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "lc_engine.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LIB_NAME = "lc_engine.so"

_LOCK = threading.Lock()  # guards _LIB
_BUILD_LOCK = threading.Lock()  # one build at a time in this process
_LIB = None


class EngineBuild:
    """Where the engine's library is, and how long its build took (0 and
    built=False when this tree's library already existed)."""

    def __init__(self, path: str, seconds: float, built: bool):
        self.path = path
        self.seconds = seconds
        self.built = built


def source_hash() -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> EngineBuild:
    """Compile the engine unless this tree's library exists. Writes to a
    temporary name (this process's) and renames, so a process that dies
    mid-build leaves no half-written library behind; threads of one
    process build one at a time. Raises RuntimeError with g++'s output."""
    with _BUILD_LOCK:
        return _build()


def _build() -> EngineBuild:
    out_dir = os.path.join(BUILD_DIR, f"lc_engine-{source_hash()}")
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return EngineBuild(lib, 0.0, built=False)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SRC]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the LC engine's build did not run ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"the LC engine's build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return EngineBuild(lib, time.time() - t0, built=True)


def get_lib() -> ctypes.CDLL:
    """The engine's library, built on first use; raises if it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build().path)
        lib.lc_field_ctx_size.restype = ctypes.c_size_t
        lib.lc_field_ctx_size.argtypes = []
        lib.lc_inline_run.restype = ctypes.c_void_p
        lib.lc_inline_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.lc_inline_nnz.restype = ctypes.c_int64
        lib.lc_inline_nnz.argtypes = [ctypes.c_void_p]
        lib.lc_inline_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.lc_inline_fetch.restype = None
        lib.lc_inline_free.argtypes = [ctypes.c_void_p]
        lib.lc_inline_free.restype = None
        lib.lc_field_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.lc_field_init.restype = None
        _LIB = lib
        return _LIB


def _to_u64x4(values: list[int]) -> np.ndarray:
    out = np.zeros((len(values), 4), dtype=np.uint64)
    for i, v in enumerate(values):
        for j in range(4):
            out[i, j] = (v >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return out


def _from_u64x4(arr: np.ndarray) -> list[int]:
    a = np.asarray(arr, dtype=np.uint64).reshape(-1, 4)
    return [
        int(a[i, 0]) | (int(a[i, 1]) << 64) | (int(a[i, 2]) << 128)
        | (int(a[i, 3]) << 192)
        for i in range(a.shape[0])
    ]


class NativeInliner:
    """Holds a field context; runs the native inline pass over CSR arrays."""

    def __init__(self, modulus: int):
        if modulus.bit_length() > 256:
            raise ValueError("the native engine supports moduli of at most 256 bits")
        self.lib = get_lib()
        self.modulus = modulus
        self._ctx = ctypes.create_string_buffer(self.lib.lc_field_ctx_size())
        self.lib.lc_field_init(self._ctx, _to_u64x4([modulus]).ctypes.data)

    def inline(self, offsets: np.ndarray, vars_: np.ndarray,
               coeff_ids: np.ndarray, values: list[int]):
        """-> (new_offsets int64, new_vars u64, new_coeff_values list[int])."""
        n = len(offsets) - 1
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        vars_ = np.ascontiguousarray(vars_, dtype=np.uint64)
        coeff_ids = np.ascontiguousarray(coeff_ids, dtype=np.uint32)
        vals = _to_u64x4(values)
        handle = self.lib.lc_inline_run(
            self._ctx, n, offsets.ctypes.data, vars_.ctypes.data,
            coeff_ids.ctypes.data, vals.shape[0], vals.ctypes.data,
        )
        if not handle:
            raise RuntimeError("native inline failed")
        try:
            nnz = self.lib.lc_inline_nnz(handle)
            out_off = np.zeros(n + 1, dtype=np.int64)
            out_vars = np.zeros(nnz, dtype=np.uint64)
            out_coeffs = np.zeros((nnz, 4), dtype=np.uint64)
            self.lib.lc_inline_fetch(
                self._ctx, handle, out_off.ctypes.data,
                out_vars.ctypes.data, out_coeffs.ctypes.data,
            )
        finally:
            self.lib.lc_inline_free(handle)
        return out_off, out_vars, _from_u64x4(out_coeffs)


_INLINERS: dict[int, NativeInliner] = {}


def get_inliner(modulus: int) -> NativeInliner:
    if modulus not in _INLINERS:
        _INLINERS[modulus] = NativeInliner(modulus)
    return _INLINERS[modulus]
