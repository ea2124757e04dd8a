"""K16 and K17 on the card, as far as the CPU can check them: the sweeps'
round-down floor (`csrc/plane_v3.cuh` `floor256<true>`) emulated exactly,
the largest value each kind sweeps against that floor's range, and the
launch geometry that `ops/mul_parts.py` computes for the kernels
(`csrc/mul_parts.cu`).

The floor is c = fma_rd(z, 2^-8, 1.5·2^23) − 1.5·2^23: one FFMA rounding
toward −∞, then an exact FADD. Its emulation takes the exact sum in
float64 (exact for every float32 z with |z| >= 2), rounds it down to the
float32 grid and subtracts 1.5·2^23. The floor is exact for
|z| <= 2^30; every kind that takes it sweeps values below 2^23, and conv1,
which keeps floorf, leaves 2^30.
"""

import os
import re

import numpy as np
import pytest
import torch

from snark_tpu_torch import bench_vpu_peak as BV
from snark_tpu_torch.ops import mul_parts as MP
from snark_tpu_torch.ops import plane_field_v3 as T
from snark_tpu_torch.ops import vpu_peak as V

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "snark_tpu_torch", "csrc")
MAGIC = 1.5 * 2.0**23
RD_RANGE = 2.0**30  # |z| up to which the round-down floor is exact
SWEPT_BOUND = 2.0**23  # what the source note promises of the kinds on the new floor
RD_KINDS = ("A", "B", "C", "conv3", "conv9", "sweep9", "convreg")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def floor_rd(z: np.ndarray) -> np.ndarray:
    """The kernel's round-down floor of z / 256, emulated exactly."""
    s = z.astype(np.float64) / 256.0 + MAGIC
    f = s.astype(np.float32)  # to nearest, then one step down where that rounded up
    f = np.where(f.astype(np.float64) > s, np.nextafter(f, np.float32(-np.inf)), f)
    return (f.astype(np.float64) - MAGIC).astype(np.float32)


def floor_ref(z: np.ndarray) -> np.ndarray:
    return torch.floor(torch.from_numpy(z.astype(np.float32)) * (1.0 / 256.0)).numpy()


def test_round_down_floor_is_exact_within_its_range():
    """The source's floor is the FFMA and FADD emulated here; it equals
    torch.floor(z·2^-8) on every integer in [−2^24, 2^24], on float32 values
    up to ±2^30, and not beyond."""
    src = open(os.path.join(CSRC, "plane_v3.cuh")).read()
    assert "__fadd_rn(__fmaf_rd(z, 1.0f / 256.0f, 12582912.0f), -12582912.0f)" in src
    assert 12582912.0 == MAGIC
    step = 1 << 22
    for lo in range(-(1 << 24), 1 << 24, step):
        z = np.arange(lo, lo + step + 1, dtype=np.float32)
        assert np.array_equal(floor_rd(z), floor_ref(z)), lo
    rng = np.random.default_rng(3)
    z = (rng.uniform(1.0, 30.0, 1 << 16) * rng.choice([-1.0, 1.0], 1 << 16))
    z = np.exp2(z).astype(np.float32)
    z = np.concatenate([z, np.float32([RD_RANGE, -RD_RANGE, RD_RANGE - 64, -RD_RANGE + 128])])
    assert float(np.abs(z).max()) <= RD_RANGE
    assert np.array_equal(floor_rd(z), floor_ref(z))
    beyond = np.float32([RD_RANGE + 256, -RD_RANGE - 128, 2.0**31 + 768])
    assert not np.any(floor_rd(beyond) == floor_ref(beyond))


def swept_max(monkeypatch, run) -> float:
    """The largest |value| that enters a sweep while `run()` computes."""
    seen = [0.0]
    inner = T._sweep

    def spy(z):
        seen[0] = max(seen[0], float(z.abs().max()))
        return inner(z)

    monkeypatch.setattr(T, "_sweep", spy)
    monkeypatch.setattr(MP, "_sweep", spy)
    run()
    monkeypatch.undo()
    return seen[0]


def test_swept_values_stay_in_the_floors_range(monkeypatch):
    """Every kind's plain version on the bench's inputs with A lazy (digits
    up to 510) and on all-maximal digits (A 510, B 255): the kinds on the
    round-down floor sweep values below 2^23, inside its range; conv1
    leaves it; conv0 sweeps nothing."""
    lanes = 512
    pf = V.plane_field()
    am, bm = BV.mont_inputs(lanes, "cpu")
    lazy = am + torch.from_numpy(pf.P2_COL)
    assert float(lazy.max()) <= 510
    full = (torch.full_like(am, 510.0), torch.full_like(bm, 255.0))
    seen = {}
    for name, (a, b) in (("lazy", (lazy, bm)), ("maximal", full)):
        for kind in MP.PARTS_KINDS:
            seen[kind, name] = swept_max(
                monkeypatch, lambda: MP.reduce_parts_chain_plain(a, b, kind, 512))
        for kind in MP.BISECT_KINDS:
            seen[kind, name] = swept_max(monkeypatch, lambda: MP.bisect_chain_plain(a, b, kind))
    for (kind, name), top in seen.items():
        if kind in RD_KINDS:
            assert 0 < top < SWEPT_BOUND <= RD_RANGE, (kind, name, top)
        elif kind == "conv1":
            assert top > RD_RANGE, (kind, name, top)
        else:
            assert top == 0.0, (kind, name, top)
    # t[33] of all-maximal digits enters the first sweep of every product
    for kind in ("A", "B", "C", "conv3", "conv9", "convreg"):
        assert seen[kind, "maximal"] >= MP.ROWS * 510 * 255, kind


def covered(geo: dict) -> np.ndarray:
    """How often each lane is taken: block b walks tiles b, b + grid, ...;
    thread i of tile j takes lane j·block + i."""
    hits = np.zeros(geo["tiles"] * geo["block"], np.int64)
    thread = np.arange(geo["block"])
    for blk in range(geo["grid"]):
        for tile in range(blk, geo["tiles"], geo["grid"]):
            hits[tile * geo["block"] + thread] += 1
    return hits


def test_launch_geometry_covers_every_lane_once():
    """At the bench's 131,072 lanes, at 4,096 and at the smallest legal
    count (T), for every kind and T the kernels run: each lane taken once
    (K16 A, C and sweep9 one block a tile; the walking kinds as many blocks
    as the card keeps resident, each walking its tiles), a grid of at least 132 blocks
    at the bench's lanes on 132 SMs; lanes that are not a positive
    multiple of T are refused; the blocks each kind's launch bounds keep
    resident (16 warps an SM, K16 C 8) fit an H100 SM's shared memory,
    which is what the source lays out."""
    runs = [(k, t) for k in MP.PARTS_KINDS for t in MP.PARTS_T]
    runs += [(k, MP.BISECT_T) for k in MP.BISECT_KINDS]
    for kind, t in runs:
        for lanes in (BV.LANES, 4096, t):
            geo = MP.launch_geometry(kind, lanes, t)
            assert geo["tiles"] * geo["block"] == lanes, (kind, t, lanes)
            assert np.all(covered(geo) == 1), (kind, t, lanes)
            per_sm = {"A": MP.BAND_BLOCKS_PER_SM, "C": MP.SCALAR_BLOCKS_PER_SM}.get(
                kind, MP.LANE_BLOCKS_PER_SM)
            assert per_sm * geo["block"] // 32 == (8 if kind == "C" else 16)
            resident = MP.H100_SMS * per_sm
            walks = kind in MP.WALKING_KINDS
            assert geo["grid"] == (min(geo["tiles"], resident) if walks else geo["tiles"])
            assert geo["smem"] == (2 * MP.ROWS * geo["block"] * 4 if walks else
                                   88064 if kind == "A" else 0)
            assert per_sm * (geo["smem"] + 1024) <= 228 * 1024
        assert MP.launch_geometry(kind, BV.LANES, t)["grid"] >= MP.H100_SMS
        for bad in (0, -t, t // 2, 4096 + t // 2, 3 * t + 128):
            with pytest.raises(ValueError):
                MP.launch_geometry(kind, bad, t)
    with pytest.raises(ValueError):
        MP.launch_geometry("D", 4096, 512)
    # the source's layout: staged pairs, strides, fragments
    src = open(os.path.join(CSRC, "mul_parts.cu")).read()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (c["kLaneThreads"], c["kLaneMinBlocks"]) == (MP.LANE_THREADS, MP.LANE_BLOCKS_PER_SM)
    assert (c["kBandThreads"], c["kBandMinBlocks"]) == (MP.BAND_THREADS, MP.BAND_BLOCKS_PER_SM)
    assert (c["kScalarThreads"], c["kScalarMinBlocks"]) == (MP.SCALAR_THREADS,
                                                          MP.SCALAR_BLOCKS_PER_SM)
    assert MP.WARP_STAGE_BYTES == 32 * c["kPairStride"] * 4 + 16 * c["kCStride"] * 4
    assert MP.BAND_FRAG_BYTES == MP.band_fragments().nbytes
    assert MP.launch_geometry("A", 4096, 512)["smem"] == 88064
    # a smaller card: fewer blocks, each walking more tiles, still every lane once
    geo = MP.launch_geometry("conv3", BV.LANES, 512, sms=7)
    assert geo["grid"] == 28 and np.all(covered(geo) == 1)


def test_smoke_pair_times_the_decomposition_lines_and_compares_builds():
    """`smoke_pair` runs the K16 and K17 bench phases and sums up, over its
    four turns (other, this, this, other), each bench line's ms and each
    K12-K17 instance's registers, spills, SASS and FRND counts, with
    `build_same` true where an instance's registers and opcode counts are
    the same in both trees."""
    from snark_tpu_torch import smoke_pair as SP

    assert {"bench_reduce_parts", "bench_bisect_mul"} <= set(SP.PHASES)
    k13, k16a = f"sweep_chain_kernel<{V.ROWS}>", "reduce_parts_chain_kernel<0>"

    def turn(registers, frnd, ms):
        return [
            {"phase": "build",
             "ptxas": {k13: {"registers": 48, "spill_stores": 0},
                       k16a: {"registers": registers, "spill_stores": 0}},
             "sass": {k13: {"FFMA": 40, "FRND.FLOOR": 34}, k16a: {"FFMA": 9, "FRND": frnd}}},
            {"phase": "bench_reduce_parts",
             "lines": [{"kernel": "reduce_parts_chain_A_512", "ms": ms}],
             "kernels": [{"name": "reduce_parts_chain_A_512", "ms": ms + 0.001}]},
        ]

    runs = [turn(177, 307, 0.2), turn(128, 1, 0.15), turn(128, 1, 0.151), turn(177, 307, 0.199)]
    out = SP.summary(runs)
    assert out["bench_line_ms"]["reduce_parts_chain_A_512"] == [0.2, 0.15, 0.151, 0.199]
    assert out["kernel_ms"]["reduce_parts_chain_A_512"] == [0.201, 0.151, 0.152, 0.2]
    assert out["build_same"] == {k13: True, k16a: False}
    assert [b["frnd"] for b in out["build"][k16a]] == [307, 1, 1, 307]
    assert out["build"][k13][1] == {"registers": 48, "spill_stores": 0, "sass": 74, "frnd": 34}
