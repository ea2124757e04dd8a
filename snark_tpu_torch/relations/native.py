"""ctypes bridge to the native LC engine (`csrc/lc_engine.cpp`).

The port's own copy of the JAX package's `relations/native.py`. The engine
is host C++: it is compiled with g++ on first use into
`_build/lc_engine-<hash of the source and flags>/`, so an edit to the
source rebuilds it and an unchanged tree reuses it. A failed build raises
with the compiler's output; nothing falls back to the Python pass in its
place (`ConstraintSystem.inline_all_lcs_python` is the plain version, for
systems below the native threshold). The engine supports moduli up to 256
bits (every scalar field; the relations layer only ever inlines over Fr).
The engine holds the inline pass (`NativeInliner`), the batched row
evaluator (`NativeEvaluator`) and the seeded random-LC synthesizer
(`NativeSynthesizer`, the bench.rs workload), each as the JAX package's.
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
        lib.lc_synth_random.restype = ctypes.c_void_p
        lib.lc_synth_random.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        for name in ("lc_synth_num_lcs", "lc_synth_nnz", "lc_synth_num_values"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.lc_synth_fetch.argtypes = [ctypes.c_void_p] * 6
        lib.lc_synth_fetch.restype = None
        lib.lc_synth_free.argtypes = [ctypes.c_void_p]
        lib.lc_synth_free.restype = None
        lib.lc_eval_rows.restype = None
        lib.lc_eval_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
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


def _csr(offsets, vars_, coeff_ids, num_values: int):
    """The CSR arrays as the engine reads them; raises ValueError on arrays
    that would send it outside a buffer: offsets that do not rise from 0 to
    at most nnz, ids past the value table, an LC reference to a row that
    is not an earlier one."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    vars_ = np.ascontiguousarray(vars_, dtype=np.uint64)
    coeff_ids = np.ascontiguousarray(coeff_ids, dtype=np.uint32)
    n = len(offsets) - 1
    if n < 0 or offsets[0] != 0 or (np.diff(offsets) < 0).any():
        raise ValueError("offsets must rise from 0")
    nnz = int(offsets[-1])
    if nnz > min(len(vars_), len(coeff_ids)):
        raise ValueError(f"offsets end at {nnz}, past the {len(vars_)} vars / "
                         f"{len(coeff_ids)} ids")
    if nnz and int(coeff_ids[:nnz].max()) >= num_values:
        raise ValueError(f"a coefficient id past the {num_values}-value table")
    tags = vars_[:nnz] >> np.uint64(61)
    lc = tags == 4
    if lc.any():
        rows = np.repeat(np.arange(n, dtype=np.uint64), np.diff(offsets))
        if (vars_[:nnz][lc] & np.uint64((1 << 61) - 1) >= rows[lc]).any():
            raise ValueError("an LC reference to a row that is not an earlier one")
    return offsets, vars_, coeff_ids


class _FieldEngine:
    """The engine's library and a field context for `modulus`."""

    def __init__(self, modulus: int):
        if modulus.bit_length() > 256:
            raise ValueError("the native engine supports moduli of at most 256 bits")
        self.lib = get_lib()
        self.modulus = modulus
        self._ctx = ctypes.create_string_buffer(self.lib.lc_field_ctx_size())
        self.lib.lc_field_init(self._ctx, _to_u64x4([modulus]).ctypes.data)


class NativeInliner(_FieldEngine):
    """Holds a field context; runs the native inline pass over CSR arrays."""

    def _run(self, offsets, vars_, coeff_ids, vals: np.ndarray):
        n = len(offsets) - 1
        offsets, vars_, coeff_ids = _csr(offsets, vars_, coeff_ids, vals.shape[0])
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
        return out_off, out_vars, out_coeffs

    def inline(self, offsets: np.ndarray, vars_: np.ndarray,
               coeff_ids: np.ndarray, values: list[int]):
        """-> (new_offsets int64, new_vars u64, new_coeff_values list[int])."""
        out_off, out_vars, out_coeffs = self._run(offsets, vars_, coeff_ids, _to_u64x4(values))
        return out_off, out_vars, _from_u64x4(out_coeffs)

    def inline_raw(self, offsets, vars_, coeff_ids, values_u64x4):
        """Like inline(), but the coefficients in and out stay (m, 4) u64
        arrays: no Python int round trips (they dominate at 2^23)."""
        return self._run(offsets, vars_, coeff_ids,
                         np.ascontiguousarray(values_u64x4, dtype=np.uint64))


_INLINERS: dict[int, NativeInliner] = {}


def get_inliner(modulus: int) -> NativeInliner:
    if modulus not in _INLINERS:
        _INLINERS[modulus] = NativeInliner(modulus)
    return _INLINERS[modulus]


class NativeSynthesizer(_FieldEngine):
    """Native random-LC synthesis (the bench.rs workload,
    relations/examples/bench.rs:85-109): generates, interns and stores
    n × 3 random LCs in C++ and returns columnar CSR arrays in the LcMap and
    interner layout. A seeded splitmix64 stream: the same arguments give
    the same arrays as the JAX package's engine."""

    def synthesize(self, n: int, terms: int, seed: int, num_vars: int,
                   lc_base: int = 1, id_base: int = 2):
        """-> (offsets (num_lcs + 1,) int64, vars (nnz,) u64, coeff_ids
        (nnz,) u32, values (num_values, 4) u64 canonical, arg_vars (3n,)
        u64). lc_base and id_base start the LC handles and interner ids past
        the caller's LC0 and its pre-interned {1, −1}."""
        h = self.lib.lc_synth_random(self._ctx, n, terms, seed, num_vars, lc_base, id_base)
        if not h:
            raise RuntimeError("native synthesis failed")
        try:
            num_lcs = self.lib.lc_synth_num_lcs(h)
            nnz = self.lib.lc_synth_nnz(h)
            offsets = np.zeros(num_lcs + 1, dtype=np.int64)
            vars_ = np.zeros(nnz, dtype=np.uint64)
            coeff_ids = np.zeros(nnz, dtype=np.uint32)
            values = np.zeros((self.lib.lc_synth_num_values(h), 4), dtype=np.uint64)
            arg_vars = np.zeros(3 * n, dtype=np.uint64)
            self.lib.lc_synth_fetch(
                h, offsets.ctypes.data, vars_.ctypes.data, coeff_ids.ctypes.data,
                values.ctypes.data, arg_vars.ctypes.data,
            )
        finally:
            self.lib.lc_synth_free(h)
        return offsets, vars_, coeff_ids, values, arg_vars


class NativeEvaluator(_FieldEngine):
    """Batched LC evaluation against an assignment (ark-relations'
    eval_lc, assignment.rs:40-52, over every row at once): 4×64-bit CIOS
    Montgomery dot products, on all host cores from 4096 rows."""

    def eval_rows(
        self,
        offsets: np.ndarray,  # (n + 1,) int64 CSR row offsets
        vars_: np.ndarray,  # (nnz,) u64 packed Variable tags
        coeff_ids: np.ndarray,  # (nnz,) u32 interner slots
        values_u64x4: np.ndarray,  # (num_values, 4) canonical interner table
        assignment_u64x4: np.ndarray,  # (num_cols, 4) canonical values
        var_to_col: np.ndarray,  # (nnz,) int64 column of each entry (−1: Zero)
    ) -> np.ndarray:
        """-> (n, 4) u64 canonical value of each row. Raises ValueError on
        arrays that would send the engine outside a buffer."""
        n = offsets.shape[0] - 1
        values = np.ascontiguousarray(values_u64x4, dtype=np.uint64).reshape(-1, 4)
        assignment = np.ascontiguousarray(assignment_u64x4, dtype=np.uint64).reshape(-1, 4)
        offsets, vars_, coeff_ids = _csr(offsets, vars_, coeff_ids, values.shape[0])
        var_to_col = np.ascontiguousarray(var_to_col, dtype=np.int64)
        nnz = int(offsets[-1])
        if len(var_to_col) < nnz or (nnz and int(var_to_col[:nnz].max()) >= assignment.shape[0]):
            raise ValueError(f"var_to_col: {nnz} columns below {assignment.shape[0]} wanted")
        out = np.zeros((n, 4), dtype=np.uint64)
        self.lib.lc_eval_rows(
            self._ctx, n, offsets.ctypes.data, vars_.ctypes.data, coeff_ids.ctypes.data,
            values.shape[0], values.ctypes.data, assignment.shape[0], assignment.ctypes.data,
            var_to_col.ctypes.data, out.ctypes.data,
        )
        return out


def get_evaluator(modulus: int) -> NativeEvaluator:
    return NativeEvaluator(modulus)
