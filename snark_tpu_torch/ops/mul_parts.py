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

T, the scripts' TPU block width, sets nothing on the card: it names the
line (K16's launch counters are by kind and T) and lanes must be a
multiple of it, as the scripts' grid needs. The launch geometry is
`launch_geometry`'s, the same at either T: one lane a thread, a tile of
128 lanes a block (K16 A and C: 256); K16 A, C and K17 sweep9 run one
block a tile, every other kind a grid of the blocks the card keeps
resident, each walking its tiles and fetching the next tile's digit rows
into shared memory (16-byte cp.async) while it computes the current one
(each form where it measured faster). The kernels' launch bounds
keep at least 16 warps an SM resident (K16 C: 8, at up to 255 registers
a thread; `csrc/mul_parts.cu` says why). It changes nothing in the values. On a
CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel, and a failed build or launch raises. Every kind
equals its plain version digit for digit and bit for bit: the integer
kinds stay below 2^24, and conv0 and conv1, which do not, round each
product and sum in the plain version's order. The kernels' sweeps floor
with a round-down FFMA and an FADD, exact for |z| <= 2^30, where every
value the integer kinds sweep lies; conv1 keeps floorf (`csrc/plane_v3.cuh`).
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
# launch geometry (csrc/mul_parts.cu): a block and the blocks an SM its
# launch bounds keep resident, for K16 A, K16 C and every other kind; the
# SMs of an H100 SXM
BAND_THREADS, BAND_BLOCKS_PER_SM = 256, 2
SCALAR_THREADS, SCALAR_BLOCKS_PER_SM = 256, 1
LANE_THREADS, LANE_BLOCKS_PER_SM = 128, 4
H100_SMS = 132
# the kinds whose blocks walk their tiles with a tile buffer of shared
# memory, 2·ROWS floats a thread; the others take one tile a block
WALKING_KINDS = ("B", "conv0", "conv1", "conv3", "conv9", "convreg")
# K16 A's shared memory: the band fragments (24 tiles of 32 lanes x 16
# bytes), a warp's staging area (32 lanes x 20 words of bf16 pairs, 16 C
# rows x 40 floats), then a column of ROWS floats a thread for t's high
# half; C and sweep9 take none
BAND_FRAG_BYTES = 24 * 32 * 16
WARP_STAGE_BYTES = 32 * 20 * 4 + 16 * 40 * 4


def _check_kind(kind: str, kinds: tuple) -> int:
    if kind not in kinds:
        raise ValueError(f"kind: one of {kinds}, got {kind!r}")
    return kinds.index(kind)


def _check_tiling(lanes: int, T: int) -> None:
    if lanes <= 0 or lanes % T:
        raise ValueError(f"lanes ({lanes}) must be a positive multiple of T ({T})")


def launch_geometry(kind: str, lanes: int, T: int, sms: int = H100_SMS) -> dict:
    """The launch of K16 (kind A, B, C) or K17 (conv0 ... convreg) on
    `lanes` lanes on a card of `sms` SMs: {"grid", "block", "smem",
    "tiles"}. Thread i of tile j takes lane j·block + i. K16 A, C and K17
    sweep9: one block a tile. The kinds of WALKING_KINDS: as many blocks as
    the card keeps resident (`sms` times the blocks an SM), at most one a
    tile, block k walking tiles k, k + grid, ... with a tile buffer of
    shared memory. So every lane once, and at the benches' 131,072 lanes
    every SM busy. T only checks the lanes (a positive multiple of it)."""
    _check_kind(kind, PARTS_KINDS + BISECT_KINDS)
    _check_tiling(lanes, T)
    block, per_sm = {"A": (BAND_THREADS, BAND_BLOCKS_PER_SM),
                     "C": (SCALAR_THREADS, SCALAR_BLOCKS_PER_SM)}.get(
                         kind, (LANE_THREADS, LANE_BLOCKS_PER_SM))
    tiles = lanes // block
    if kind in WALKING_KINDS:
        return {"grid": min(tiles, sms * per_sm), "block": block, "smem": 2 * ROWS * block * 4,
                "tiles": tiles}
    smem = BAND_FRAG_BYTES + block // 32 * WARP_STAGE_BYTES + ROWS * block * 4 if kind == "A" else 0
    return {"grid": tiles, "block": block, "smem": smem, "tiles": tiles}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The kernels copy rows in 16-byte chunks (cp.async)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel inputs must start 16-byte aligned")


def resident_warps(kind: str) -> int:
    """Warps of `kind`'s kernel that the card keeps resident on one SM at
    its launch geometry (the CUDA runtime's occupancy calculator over the
    built kernel's registers and shared memory); needs a card."""
    geo = launch_geometry(kind, LANE_THREADS * BAND_THREADS, PARTS_T[0] if kind in PARTS_KINDS
                          else BISECT_T)
    kernel = 0 if kind in PARTS_KINDS else 1
    code = PARTS_KINDS.index(kind) if kernel == 0 else BISECT_KINDS.index(kind)
    blocks = _native._library().snark_parts_occupancy(kernel, code, geo["smem"])
    if blocks < 0:
        raise RuntimeError(f"occupancy of {kind}: CUDA error {-blocks}")
    return blocks * geo["block"] // 32


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
    """K16: `reps` rounds of variant `kind` from A = a, on the line of
    block width T."""
    lanes = _check_pair(a, b, reps)
    code = _check_kind(kind, PARTS_KINDS)
    if T not in PARTS_T:
        raise ValueError(f"T: one of {PARTS_T}, got {T}")
    _check_tiling(lanes, T)
    if a.device.type == "cpu":
        return reduce_parts_chain_plain(a, b, kind, T, reps)
    _native.require_cuda(a, b)
    _check_aligned(a, b)
    geo = launch_geometry(kind, lanes, T, _sm_count(a.device.index))
    out = torch.empty_like(a)
    frags = _fragments_on(str(a.device))
    _native.launch("reduce_parts_chain", f"reduce_parts_chain_{kind}_{T}", a.data_ptr(),
                   b.data_ptr(), out.data_ptr(), frags.data_ptr(), lanes, code, geo["grid"],
                   geo["block"], geo["smem"], int(reps))
    return out


def bisect_chain(a: torch.Tensor, b: torch.Tensor, kind: str, reps: int = REPS) -> torch.Tensor:
    """K17: `reps` rounds of variant `kind` from A = a (the scripts' T =
    512 divides the lanes)."""
    lanes = _check_pair(a, b, reps)
    code = _check_kind(kind, BISECT_KINDS)
    _check_tiling(lanes, BISECT_T)
    if a.device.type == "cpu":
        return bisect_chain_plain(a, b, kind, reps)
    _native.require_cuda(a, b)
    _check_aligned(a, b)
    geo = launch_geometry(kind, lanes, BISECT_T, _sm_count(a.device.index))
    out = torch.empty_like(a)
    _native.launch("bisect_chain", f"bisect_chain_{kind}", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), lanes, code, geo["grid"], geo["block"], geo["smem"], int(reps))
    return out


# ---------------------------------------------------------------------------
# work counts (for bounds): per lane and rep
# ---------------------------------------------------------------------------

# a row: a floor (a multiply and FRND, or a round-down FFMA and an FADD) and
# an FMA; R8 - 1 carry adds
SWEEP_OPS = 4 * ROWS - 1
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
