"""Configuration 4's per-shard device work, timed on one card.

    python -m snark_tpu_torch.config4_shards [--log-n 24] [--ndev 8]
        [--c 13] [--iters 2] [--device cuda]

The counterpart of `scripts/run_config4_shards.py`: the work one of ndev
cards does in a 2^log-n distributed prove, timed on this card alone.

* The shard MSM: `PlaneMsm.window_sums` (signed digits at window c) of
  2^(log-n − log2 ndev) points, a table that tiles a pool of 64 distinct
  points (`bench.make_inputs`, scalars from seed 11), timed over `iters`
  runs after a warm one; the warm run's window sums, combined on the card
  (K18), must equal the pool oracle Σ_j pool_j·(Σ_{i ≡ j mod 64} s_i).
* The six-step NTT's local stage: n1/ndev rows of length n2 (n1 = 2^⌊log-n
  / 2⌋, n2 = 2^log-n / n1) through `ops/ntt.py` `ntt_rows` (K3), on a
  vector that tiles 512 random values, timed the same way; its first row
  must equal `ntt_rows_plain` of that row.

Prints one JSON line: the shard sizes, `msm_shard_s`,
`msm_shard_adds_per_s` (the reference's count: W·n_shard + 2·cb·W·2^cb),
`msm_correct`, `ntt_shard_s`, `ntt_correct`, and the bytes a card would
all-gather (its (W, 3, K, L) window totals).
"""

from __future__ import annotations

import argparse
import json
import random
import time

import torch

from .bench import make_inputs
from .fields.limbs import FR
from .fields.params import BN254
from .ops.curve import limbs_to_points
from .ops.msm_plane import PlaneMsm
from .ops.ntt import NttPlan, ntt_rows, ntt_rows_plain


def _timed(fn, iters: int, dev: torch.device):
    out = fn()  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) / iters


def run(log_n: int = 24, ndev: int = 8, c: int = 13, iters: int = 2, device="cuda") -> dict:
    if ndev < 1 or ndev & (ndev - 1) or (1 << log_n) < 64 * ndev:
        raise ValueError(f"ndev = {ndev} must be a power of two dividing 2^{log_n} / 64")
    dev = torch.device(device)
    n_shard = (1 << log_n) // ndev
    inp = make_inputs(n_shard.bit_length() - 1, signed=True, c=c, device=dev, seed=11)
    plan = PlaneMsm(c, BN254.fr.num_bits, "g1", signed=True)
    sums, t_msm = _timed(lambda: plan.window_sums(inp.table, inp.digits), iters, dev)
    got = limbs_to_points(plan.combine(sums).cpu()[None])[0]

    log_n1 = log_n // 2
    n1, n2 = 1 << log_n1, 1 << (log_n - log_n1)
    rows = n1 // ndev
    if rows < 1:
        raise ValueError(f"n1 = {n1} rows do not split over {ndev} cards")
    rng = random.Random(11)
    vals = FR.tensor([rng.randrange(FR.p) for _ in range(512)], dev)
    x = vals.repeat(-(-rows * n2 // 512), 1)[: rows * n2].contiguous()
    tw = NttPlan(n2, dev).fwd_tw
    y, t_ntt = _timed(lambda: ntt_rows(x, n2, tw), iters, dev)
    ntt_ok = torch.equal(y[:n2], ntt_rows_plain(x[:n2], n2, tw))

    adds = plan.W * n_shard + 2 * plan.cb * plan.W * plan.nb
    return {
        "config": 4, "desc": f"2^{log_n} prove shards on one card, {ndev} cards modelled",
        "n_total": 1 << log_n, "ndev_modeled": ndev, "shard_points": n_shard, "c": c,
        "num_windows": plan.W, "msm_shard_s": t_msm, "msm_shard_adds_per_s": adds / t_msm,
        "msm_correct": got == inp.want, "ntt_local_rows": rows, "ntt_local_len": n2,
        "ntt_shard_s": t_ntt, "ntt_correct": bool(ntt_ok),
        "gather_bytes_per_card": sums.numel() * sums.element_size(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=24)
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--c", type=int, default=13)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.log_n, args.ndev, args.c, args.iters, args.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["msm_correct"] and rec["ntt_correct"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
