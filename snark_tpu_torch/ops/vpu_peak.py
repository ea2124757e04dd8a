"""The roofline kernels K12-K15 and their plain PyTorch versions: the four
chains of `scripts/bench_vpu_peak.py`, on (R8, lanes) float32 digit planes
with R8 = 34 (BN254 Fq with two extra digits, the script's planes).

- K12 `fma_chain` (the script's `fma_run`): acc <- acc·b + a, `reps` times
  from acc = a, elementwise.
- K13 `sweep_chain` (`sweep_run`): z <- sweep(z) + 1, `reps` times; a sweep
  moves each row's base-256 carry to the row above (`plane_field_v3._sweep`).
- K14 `conv_chain` (`conv_run`): t = mul_acc(A, B), the (2R8, lanes) digit
  convolution, then A <- t[0:R8]·1e-7, `reps` times; the output is t.
- K15 `mont_mul_chain` (`mm_run`): A <- mont_mul(A, B) with the carry column
  and plus_p = 2p, `reps` times, on lazy digits of BN254 Fq
  (`PlaneFieldV3(BN254.fq, 2)`, its scalar-constant reduction).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (`csrc/vpu_peak.cu`), and a failed build or launch
raises. K12 fuses its multiply-add into one rounding where the plain
version rounds twice, and K14 sums with FMAs; K13 and K15 are exact, digit
for digit. Each kernel counts its launches under its own name; K15 is
compiled for BN254 Fq alone, as `ROWS` is fixed.
"""

from __future__ import annotations

import torch

from .. import _native
from ..fields.params import BN254
from .plane_field_v3 import _CARRY_ROWS as CARRY_ROWS
from .plane_field_v3 import PlaneFieldV3, _sweep, get_plane_field_v3

ROWS = 34  # R8 of the instantiated kernels
EXTRA_DIGITS = 2
DEFAULT_THREADS = 256
MAX_THREADS = 256  # the kernels' launch bound (K15 needs up to 255 registers)
CONV_SCALE = 1e-7  # the feedback scale of the conv chain


def plane_field() -> PlaneFieldV3:
    """The planes' field, BN254 Fq with R8 = 2L + 2 = ROWS."""
    return get_plane_field_v3(BN254.fq, EXTRA_DIGITS)


def _check(name: str, t: torch.Tensor) -> int:
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != ROWS:
        raise ValueError(f"{name}: want float32 ({ROWS}, lanes), got {t.dtype} {tuple(t.shape)}")
    return t.shape[1]


def _check_pair(a: torch.Tensor, b: torch.Tensor, reps: int) -> int:
    lanes = _check("a", a)
    _check("b", b)
    if a.shape != b.shape:
        raise ValueError(f"a and b differ in shape: {tuple(a.shape)}, {tuple(b.shape)}")
    if reps < 0:
        raise ValueError(f"reps >= 0, got {reps}")
    return lanes


def _threads(threads: int) -> int:
    if threads <= 0 or threads > MAX_THREADS or threads % 32:
        raise ValueError(f"threads: a multiple of 32 up to {MAX_THREADS}, got {threads}")
    return int(threads)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fma_chain_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of K12 (the product and the sum each rounded)."""
    acc = a.clone()
    for _ in range(reps):
        acc = acc * b + a
    return acc


def sweep_chain_plain(z: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of K13."""
    z = z.clone()
    for _ in range(reps):
        z = _sweep(z) + 1.0
    return z


def conv_chain_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of K14: the last product, (2R8, lanes)."""
    pf = plane_field()
    A, t = a, None
    for _ in range(reps):
        t = pf.mul_acc(A, b)
        A = t[: pf.R8] * CONV_SCALE
    return t


def mont_mul_chain_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of K15."""
    pf = plane_field()
    A = a.clone()
    for _ in range(reps):
        A = pf.mont_mul(A, b, pf.CARRY_SCALE, plus_p=pf.P2_COL)
    return A


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fma_chain(
    a: torch.Tensor, b: torch.Tensor, reps: int, threads: int = DEFAULT_THREADS
) -> torch.Tensor:
    """K12: acc <- acc·b + a, reps times from acc = a (one rounding a
    step on the card)."""
    _check_pair(a, b, reps)
    threads = _threads(threads)
    if a.device.type == "cpu":
        return fma_chain_plain(a, b, reps)
    _native.require_cuda(a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("fma_chain reads float4 vectors: a and b must be 16-byte aligned")
    out = torch.empty_like(a)
    _native.launch("fma_chain", "fma_chain", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   a.numel(), int(reps), threads)
    return out


def sweep_chain(z: torch.Tensor, reps: int, threads: int = DEFAULT_THREADS) -> torch.Tensor:
    """K13: z <- sweep(z) + 1, reps times."""
    lanes = _check("z", z)
    if reps < 0:
        raise ValueError(f"reps >= 0, got {reps}")
    threads = _threads(threads)
    if z.device.type == "cpu":
        return sweep_chain_plain(z, reps)
    _native.require_cuda(z)
    out = torch.empty_like(z)
    _native.launch("sweep_chain", "sweep_chain", z.data_ptr(), out.data_ptr(), lanes,
                   int(reps), threads)
    return out


def conv_chain(
    a: torch.Tensor, b: torch.Tensor, reps: int, threads: int = DEFAULT_THREADS
) -> torch.Tensor:
    """K14: the (2R8, lanes) product of the last of reps rounds of
    t = mul_acc(A, b), A <- t[0:R8]·1e-7 (reps >= 1)."""
    lanes = _check_pair(a, b, reps)
    if reps < 1:
        raise ValueError(f"conv_chain: reps >= 1, got {reps}")
    threads = _threads(threads)
    if a.device.type == "cpu":
        return conv_chain_plain(a, b, reps)
    _native.require_cuda(a, b)
    out = torch.empty((2 * ROWS, lanes), dtype=torch.float32, device=a.device)
    _native.launch("conv_chain", "conv_chain", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   lanes, int(reps), threads)
    return out


def mont_mul_chain(
    a: torch.Tensor, b: torch.Tensor, reps: int, threads: int = DEFAULT_THREADS
) -> torch.Tensor:
    """K15: A <- mont_mul(A, b) (carry column, plus_p = 2p), reps times from
    A = a, on lazy digit planes of BN254 Fq."""
    lanes = _check_pair(a, b, reps)
    threads = _threads(threads)
    if a.device.type == "cpu":
        return mont_mul_chain_plain(a, b, reps)
    _native.require_cuda(a, b)
    out = torch.empty_like(a)
    _native.launch("mont_mul_chain", "mont_mul_chain", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), lanes, int(reps), threads)
    return out


# ---------------------------------------------------------------------------
# work counts (for bounds): FP32 instructions and bytes of one call
# ---------------------------------------------------------------------------


def fma_ops(lanes: int, reps: int) -> int:
    return reps * ROWS * lanes


def sweep_ops(lanes: int, reps: int) -> int:
    """A sweep is a multiply, a floor and an FMA per row and R8 − 1 carry
    adds; then R8 adds of 1."""
    return reps * (5 * ROWS - 1) * lanes


def conv_ops(lanes: int, reps: int) -> int:
    """R8² FMAs of the product and R8 multiplies of the feedback a rep."""
    return reps * (ROWS * ROWS + ROWS) * lanes


def mont_mul_ops() -> int:
    """FP32 instructions of one product as K15 runs it: the R8² product,
    nine sweeps, the N' convolution truncated to R8 rows, the p convolution
    on the rows that reach the carry or the high half (zero digits skipped),
    the carry (12 FMAs and a rounding) and the additions of the carry and
    of 2p's nonzero digits."""
    pf = plane_field()
    R8 = pf.R8
    low = R8 - CARRY_ROWS  # rows below it are never read
    np_terms = sum(R8 - i for i, d in enumerate(pf.NP_DIGITS) if d)
    p_terms = sum(sum(1 for j in range(R8) if i + j >= low) for i, d in enumerate(pf.P_DIGITS) if d)
    sweeps = 9 * (4 * R8 - 1)
    return (R8 * R8 + sweeps + np_terms + p_terms + CARRY_ROWS + 1 + 1
            + int((pf.P2_COL != 0).sum()))
