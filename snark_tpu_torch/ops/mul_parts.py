"""The decomposition kernels K16 and K17 and their plain PyTorch versions:
the Pallas kernels of `scripts/bench_reduce_parts.py` and
`scripts/bench_bisect_mul.py`, on (R8, lanes) float32 digit planes with
R8 = 34 (BN254 Fq with two extra digits, the scripts' planes), `reps` deep
(the scripts' REPS = 8).

- K16 `reduce_parts_chain(a, b, kind, T)` (`make_run(kind, T).run`): the
  Montgomery product cut into its parts.
  - A: A <- mont_mul(A, B) with the carry column and plus_p = 2p, its
    constant multiplies as products by the band matrices `M_NP`, `M_P`
    (the reference's band backend; on the card, tensor-core products).
  - B: t = mul_acc(A, B), x = sweep3(t[:R8]), x = sweep3(x),
    A = sweep3(x + 2p): the elementwise skeleton, not a product.
  - C: A <- mont_mul(A, B) with the constant multiplies as scalar
    multiply-adds (the script's `reduce_vpu`, which multiplies zero digits
    and rows nothing reads; its sums are exact integers, so its digits are
    those of `PlaneFieldV3`'s scalar-constant `reduce`, which the plain
    version calls); the digits equal A's.
- K17 `bisect_chain(a, b, kind)` (`make_run(kind).run`), T = 512: conv0
  (mul_acc, then A = t[:R8]·1e-7), conv1 (mul_acc, one sweep), conv3
  (mul_acc, sweep3), conv9 (mul_acc, sweep3 three times), sweep9 (nine
  sweeps, then +1, no product), convreg (the product summed as values,
  then sweep3).

The plain versions follow the scripts' kernels step for step, on the
port's `PlaneFieldV3` (`ops/plane_field_v3.py`) where the scripts call the
JAX package's (`snark_tpu/ops/pallas_field_v3.py`).

T, the TPU block width, becomes on the card the lanes a block of 256
threads covers, T / 256 lanes to a thread, with K16 A's band fragments
loaded once a block (`csrc/mul_parts.cu`); lanes must be a multiple of T.
It changes nothing in the values. On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches its kernel, and a failed build
or launch raises. Every kind equals its plain version digit for digit and
bit for bit: the integer kinds stay below 2^24, and conv0 and conv1, which
do not, round each product and sum in the plain version's order. Each
kernel counts its launches by kind (K16 also by T).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _native
from .plane_field_v3 import _col, _sweep, sweep3
from .vpu_peak import CARRY_ROWS, ROWS, _check_pair, mont_mul_ops, plane_field

REPS = 8  # the scripts' REPS
PARTS_KINDS = ("A", "B", "C")
PARTS_T = (512, 2048)  # the block widths scripts/bench_reduce_parts.py runs
BISECT_KINDS = ("conv0", "conv1", "conv3", "conv9", "sweep9", "convreg")
BISECT_T = 512
CONV_SCALE = 1e-7  # conv0's feedback scale
# K16 A's band products: mma.m16n8k16 tiles, k = R8 padded to 48, M_NP's
# rows to 48, M_P's to 80
K_PAD = 48
NP_ROWS_PAD = 48
P_ROWS_PAD = 80


def _check_kind(kind: str, kinds: tuple) -> int:
    if kind not in kinds:
        raise ValueError(f"kind: one of {kinds}, got {kind!r}")
    return kinds.index(kind)


def _check_tiling(lanes: int, T: int) -> None:
    if lanes % T:
        raise ValueError(f"lanes ({lanes}) must be a multiple of T ({T})")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def reduce_parts_chain_plain(
    a: torch.Tensor, b: torch.Tensor, kind: str, T: int, reps: int = REPS
) -> torch.Tensor:
    """Plain version of K16 (T changes nothing in the values)."""
    _check_kind(kind, PARTS_KINDS)
    pf = plane_field()
    A = a.clone()
    for _ in range(reps):
        if kind == "A":
            A = pf.mont_mul(A, b, pf.CARRY_SCALE, plus_p=pf.P2_COL, m_np=pf.M_NP, m_p=pf.M_P)
        elif kind == "B":
            t = pf.mul_acc(A, b)
            x = sweep3(sweep3(t[: pf.R8]))
            A = sweep3(x + _col(pf.P2_COL, x))
        else:
            A = pf.mont_mul(A, b, pf.CARRY_SCALE, plus_p=pf.P2_COL)
    return A


def bisect_chain_plain(a: torch.Tensor, b: torch.Tensor, kind: str, reps: int = REPS) -> torch.Tensor:
    """Plain version of K17. convreg computes conv3's function (its
    product's sums are exact integers, so summing them as values gives the
    same digits); the two differ in how the kernel sums."""
    _check_kind(kind, BISECT_KINDS)
    pf = plane_field()
    A = a.clone()
    for _ in range(reps):
        if kind == "sweep9":
            for _ in range(9):
                A = _sweep(A)
            A = A + 1.0
            continue
        t = pf.mul_acc(A, b)[: pf.R8]
        if kind == "conv0":
            A = t * CONV_SCALE
        elif kind == "conv1":
            A = _sweep(t)
        elif kind == "conv9":
            A = sweep3(sweep3(sweep3(t)))
        else:
            A = sweep3(t)
    return A


# ---------------------------------------------------------------------------
# K16 A's band fragments
# ---------------------------------------------------------------------------


def band_fragments() -> np.ndarray:
    """M_NP padded to (48, 48) and M_P to (80, 48), as the A fragments of
    `mma.sync.m16n8k16` with bf16 factors: (24, 32, 4) uint32, tile (mt, kt)
    of M_NP at index 3·mt + kt, M_P's after M_NP's 9. Lane L = 4g + q holds,
    each register a pair of bf16 with the lower column in the low half,
    rows 16·mt + g and + 8, columns 16·kt + 2q, + 1, + 8, + 9, in the order
    (g, 2q), (g + 8, 2q), (g, 2q + 8), (g + 8, 2q + 8) (the PTX ISA's
    fragment layout). Every entry is a digit <= 255, so bf16 holds it
    exactly."""
    pf = plane_field()
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    tiles = []
    for M, rows in ((pf.M_NP, NP_ROWS_PAD), (pf.M_P, P_ROWS_PAD)):
        padded = np.zeros((rows, K_PAD), np.float32)
        padded[: M.shape[0], : M.shape[1]] = M
        bits = padded.view(np.uint32) >> 16
        assert np.array_equal(bits << 16, padded.view(np.uint32)), "band entry not bf16-exact"
        for mt in range(rows // 16):
            for kt in range(K_PAD // 16):
                r, c = 16 * mt + g, 16 * kt + 2 * q

                def pair(r, c):
                    return bits[r, c] | (bits[r, c + 1] << 16)

                tiles.append(np.stack([pair(r, c), pair(r + 8, c), pair(r, c + 8),
                                       pair(r + 8, c + 8)], axis=1))
    return np.stack(tiles).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _fragments_on(device: str) -> torch.Tensor:
    return torch.from_numpy(band_fragments().view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def reduce_parts_chain(
    a: torch.Tensor, b: torch.Tensor, kind: str, T: int, reps: int = REPS
) -> torch.Tensor:
    """K16: `reps` rounds of variant `kind` from A = a, at block width T."""
    lanes = _check_pair(a, b, reps)
    code = _check_kind(kind, PARTS_KINDS)
    if T not in PARTS_T:
        raise ValueError(f"T: one of {PARTS_T}, got {T}")
    _check_tiling(lanes, T)
    if a.device.type == "cpu":
        return reduce_parts_chain_plain(a, b, kind, T, reps)
    _native.require_cuda(a, b)
    out = torch.empty_like(a)
    frags = _fragments_on(str(a.device))
    _native.launch("reduce_parts_chain", f"reduce_parts_chain_{kind}_{T}", a.data_ptr(),
                   b.data_ptr(), out.data_ptr(), frags.data_ptr(), lanes, code, T, int(reps))
    return out


def bisect_chain(a: torch.Tensor, b: torch.Tensor, kind: str, reps: int = REPS) -> torch.Tensor:
    """K17: `reps` rounds of variant `kind` from A = a, at block width 512."""
    lanes = _check_pair(a, b, reps)
    code = _check_kind(kind, BISECT_KINDS)
    _check_tiling(lanes, BISECT_T)
    if a.device.type == "cpu":
        return bisect_chain_plain(a, b, kind, reps)
    _native.require_cuda(a, b)
    out = torch.empty_like(a)
    _native.launch("bisect_chain", f"bisect_chain_{kind}", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), lanes, code, BISECT_T, int(reps))
    return out


# ---------------------------------------------------------------------------
# work counts (for bounds): per lane and rep
# ---------------------------------------------------------------------------

SWEEP_OPS = 4 * ROWS - 1  # a multiply, a floor and an FMA a row, R8 - 1 carry adds
LOW_PRODUCT = ROWS * (ROWS + 1) // 2  # the terms of t[:R8], all that K17 and K16 B read


def _p2_adds() -> int:
    return int((plane_field().P2_COL != 0).sum())


def parts_ops(kind: str) -> int:
    """FP32 instructions of one K16 step. C: K15's product (`mont_mul_ops`).
    A: the R8² product, nine sweeps, the rows of m·p added to t that reach
    the carry or the high half, the carry (12 FMAs and a rounding), its
    addition and 2p's nonzero digits; the band products are tensor-core
    work (`parts_mma_macs`), the bf16 conversions are not counted. B: the
    low half of the product (the high half is never read), nine sweeps and
    2p's nonzero digits."""
    if kind == "C":
        return mont_mul_ops()
    if kind == "B":
        return LOW_PRODUCT + 9 * SWEEP_OPS + _p2_adds()
    mp_rows = 2 * ROWS - (ROWS - CARRY_ROWS)
    return ROWS * ROWS + 9 * SWEEP_OPS + mp_rows + CARRY_ROWS + 1 + 1 + _p2_adds()


def parts_mma_macs(kind: str) -> int:
    """Useful bf16 multiply-adds of one K16 step, unpadded: M_NP (R8, R8)
    and M_P (2R8, R8) times a column of R8 digits; 0 but for A."""
    return 3 * ROWS * ROWS if kind == "A" else 0


def bisect_ops(kind: str) -> int:
    """FP32 instructions of one K17 step: the low half of the product
    (R8(R8+1)/2 terms; the high half is never read), one FMA a term, or a
    multiply and an add for conv0 and conv1, and the sweeps; conv0's R8
    multiplies, sweep9's R8 additions of 1."""
    return {
        "conv0": 2 * LOW_PRODUCT + ROWS,
        "conv1": 2 * LOW_PRODUCT + SWEEP_OPS,
        "conv3": LOW_PRODUCT + 3 * SWEEP_OPS,
        "conv9": LOW_PRODUCT + 9 * SWEEP_OPS,
        "sweep9": 9 * SWEEP_OPS + ROWS,
        "convreg": LOW_PRODUCT + 3 * SWEEP_OPS,
    }[kind]
