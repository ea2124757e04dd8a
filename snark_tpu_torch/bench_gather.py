"""The cost of a row gather by torch indexing on one card.

    python -m snark_tpu_torch.bench_gather [--log-table T] [--log-m M ...] [--iters K]
                                           [--device cuda|cpu]

The counterpart of the repository's `scripts/bench_gather.py`. Like the
script, it chains k dependent gathers (each link gathers m rows of a
2^T-row table, T = 21, adds row 0 into an accumulator and feeds the first
column of the rows it got into the next link's indices, so no link can be
skipped or reordered) and fits the slope between k = 4 and k = 16: the
cost of one link (`ms_per_gather`, `ns_per_row`). The script's chains run
inside one jit; the port's are eager torch ops, so a link is its gather
and four small element-wise launches, and the slope counts them all.
Beside it, `direct_ms` times one gather alone (`table[idx]`, the mean of K
after a warm-up, between CUDA events) and `direct_gbps` is the bytes it
writes over that time. The script's cases: u8 rows of 72, 8 and 144
bytes and f32 rows of 18 words, at m = 2^17 and 2^20; then a lane-axis
gather on a (34, 2^T) f32 plane table at m = 2^17 (`lane_f32x34`, gathering
columns). One JSON line a case, with the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from . import toolkit as T

CASES = ((72, torch.uint8, "u8x72"), (8, torch.uint8, "u8x8"), (144, torch.uint8, "u8x144"),
         (18, torch.float32, "f32x18"))
K_LO, K_HI = 4, 16


def row_chain(table, idx0, k: int):
    n_table, width = table.shape
    idx, acc = idx0, torch.zeros(width, dtype=torch.int32, device=table.device)
    for _ in range(k):
        rows = table[idx]
        acc = acc + rows[0].to(torch.int32)
        idx = (idx + rows[:, 0].to(torch.int64)) % n_table
    return acc


def lane_chain(table, idx0, k: int):
    planes, n_table = table.shape
    idx, acc = idx0, torch.zeros(planes, dtype=torch.float32, device=table.device)
    for _ in range(k):
        cols = table[:, idx]
        acc = acc + cols[:, 0]
        idx = (idx + cols[0].to(torch.int64)) % n_table
    return acc


def case(kind: str, chain, table, idx0, gather, m: int, nbytes_row: int, dev, iters: int):
    t_lo = T.time_ms(lambda: chain(table, idx0, K_LO), dev, iters)
    t_hi = T.time_ms(lambda: chain(table, idx0, K_HI), dev, iters)
    slope = (t_hi - t_lo) / (K_HI - K_LO)
    direct = T.time_ms(gather, dev, iters)
    return {"tool": "bench_gather", "kind": kind, "m": m, "ms_per_gather": slope,
            "ns_per_row": slope / m * 1e6, "t_lo_ms": t_lo, "t_hi_ms": t_hi,
            "direct_ms": direct, "direct_gbps": m * nbytes_row / (direct * 1e-3) / 1e9}


def run(log_table: int, log_ms, iters: int, device) -> list[dict]:
    dev = T.resolve(device)
    card = T.card(dev)
    n_table = 1 << log_table
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for width, dtype, kind in CASES:
        table = (torch.arange(n_table * width, dtype=torch.int64, device=dev)
                 .reshape(n_table, width).to(torch.uint8).to(dtype))
        for logm in log_ms:
            m = 1 << logm
            idx0 = torch.randint(0, n_table, (m,), generator=gen, device=dev)
            esize = torch.tensor([], dtype=dtype).element_size()
            out.append(T.emit({**case(kind, row_chain, table, idx0, lambda: table[idx0], m,
                                      width * esize, dev, iters), **card}))
        del table
    planes = 34
    table = torch.ones((planes, n_table), dtype=torch.float32, device=dev)
    m = 1 << min(17, log_table)
    idx0 = torch.randint(0, n_table, (m,), generator=gen, device=dev)
    out.append(T.emit({**case(f"lane_f32x{planes}", lane_chain, table, idx0,
                              lambda: table[:, idx0], m, 4 * planes, dev, iters), **card}))
    return out


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("--log-table", type=int, default=21)
    ap.add_argument("--log-m", type=int, nargs="+", default=[17, 20])
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    run(a.log_table, a.log_m, a.iters, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
