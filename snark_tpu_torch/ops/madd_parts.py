"""K1's parts: the bucket scan's kernel K1 (`bucket_madd_rows`) with one
part of its step's body changed, and their plain PyTorch versions, for
BN254 G1 alone: the counterparts of the bodies that
`scripts/bench_madd_parts.py` (`:73-100`) swaps into the JAX package's rows
kernel, `snark_tpu/ops/pallas_curve.py` `make_masked_mixed_add_rows`.

Each part is K1's step acc <- f(acc, Q) on a lane's next row: Q = (x2, y2)
decoded, its sign applied, rows whose flag is 0 skipped, as in K1. With
P = (X1, Y1, Z1) the accumulator, a = X1·x2, b = Y1·y2, d = y2·Z1,
e = x2·Z1, m4 = (X1 + Y1)(x2 + y2), i = b3·Z1, j = b3·(e + X1):

- full: RCB15 Alg 8, the shipped K1 (`ops/curve.py` `bucket_madd_rows`);
- nosub: Alg 8's 13 products without its add/sub glue,
  (a·b − d·j, b·i + j·a, i·d + a·m4) (the script's `body_nosub`, `:73`);
- halfmul: 6 of them, (a·b − m4·i, b + i, a + i) (`body_halfmul`, `:88`);
- nodecode: Alg 8 of P and Q′ = (Z1, Y1): the row's flag is read, its
  coordinates are not decoded and its sign is ignored (`body_nodecode`,
  `:98`).

Only `full` is a group law. The others are wrong by design, as the
script's are, and give its formulas value for value: the script's bodies
run as written only under SNARK_TPU_MSM_BATCHED=0 (by default the JAX G1
rows kernel takes `_madd_mixed_body_batched_g1`, which never calls the
swapped body). On the card, the three are instances of K1's kernel with
its part argument (`csrc/madd_parts.cu`); on a CPU tensor the wrapper runs
the plain version, on a CUDA tensor it launches the kernel, and a failed
build or launch raises. Each part counts its launches
(`bucket_madd_rows_part_<part>`); `full` counts as K1.
"""

from __future__ import annotations

import torch

from .. import _native
from ..fields.params import BN254, CurveParams
from . import curve as C

PARTS = ("full",) + _native.MADD_PARTS
# Montgomery products of one step (each product by 3b is additions) and the
# row components it decodes
PRODUCTS = {"full": 11, "nosub": 11, "halfmul": 5, "nodecode": 11}
DECODES = {"full": 2, "nosub": 2, "halfmul": 2, "nodecode": 0}


def _check_part(part: str) -> int:
    if part not in PARTS:
        raise ValueError(f"part: one of {PARTS}, got {part!r}")
    return PARTS.index(part)


# ---------------------------------------------------------------------------
# plain versions (int64 words; see ops/curve.py _PlainCurve)
# ---------------------------------------------------------------------------


def _nosub(pc, P, qx, qy):
    X1, Y1, Z1 = P[:, 0], P[:, 1], P[:, 2]
    a, b, d, e, m4 = pc.mul_many(
        [(X1, qx), (Y1, qy), (qy, Z1), (qx, Z1), (pc.add(X1, Y1), pc.add(qx, qy))]
    )
    i, j = pc.mul_many([(pc.b3, Z1), (pc.b3, pc.add(e, X1))])
    m = pc.mul_many([(a, b), (d, j), (b, i), (j, a), (i, d), (a, m4)])
    return torch.stack([pc.sub(m[0], m[1]), pc.add(m[2], m[3]), pc.add(m[4], m[5])], dim=1)


def _halfmul(pc, P, qx, qy):
    X1, Y1, Z1 = P[:, 0], P[:, 1], P[:, 2]
    a, b, m4, i = pc.mul_many(
        [(X1, qx), (Y1, qy), (pc.add(X1, Y1), pc.add(qx, qy)), (pc.b3, Z1)]
    )
    ab, m4i = pc.mul_many([(a, b), (m4, i)])
    return torch.stack([pc.sub(ab, m4i), pc.add(b, i), pc.add(a, i)], dim=1)


def _nodecode(pc, P, qx, qy):
    return pc.madd(P, P[:, 2], P[:, 1])


_BODIES = {"nosub": _nosub, "halfmul": _halfmul, "nodecode": _nodecode}


def _step(part: str):
    """K1's step with body `part` (scan_rows_plain's `step`); nodecode
    decodes no row."""
    body = _BODIES[part]
    if part == "nodecode":
        return lambda pc, P, rows, pay: body(pc, P, None, None)
    return lambda pc, P, rows, pay: body(pc, P, *pc.signed_rows(rows, pay))


def masked_madd_part_plain(
    part: str, p, x2, y2, mask, group: str = "g1", curve: CurveParams = BN254
) -> torch.Tensor:
    """mask ? f(p, (x2, y2)) : p per lane, f the step of body `part` on an
    affine Q as given (K11's operands; `full` is K11's plain version)."""
    _check_part(part)
    if part == "full":
        return C.masked_mixed_add_plain(p, x2, y2, mask, group, curve)
    pc = C._PlainCurve(group, p.device, curve)
    out = C._words(p).clone()
    lanes = torch.nonzero(mask).flatten()
    if lanes.numel():
        P = out[lanes]
        qx, qy = C._words(x2[lanes]), C._words(y2[lanes])
        out[lanes] = _BODIES[part](pc, P, qx, qy)
    return C.from_words(out)


def bucket_madd_rows_part_plain(
    part: str, acc, table, perm, lane_base, start, length, i0: int, k_steps: int,
    group: str = "g1", curve: CurveParams = BN254,
) -> torch.Tensor:
    """Plain version of K1 with body `part`, driven as K1's."""
    _check_part(part)
    if part == "full":
        return C.bucket_madd_rows_plain(
            acc, table, perm, lane_base, start, length, i0, k_steps, group, curve
        )
    return C.scan_rows_plain(
        acc, table, perm, lane_base, start, length, i0, k_steps, group, curve, _step(part)
    )


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def bucket_madd_rows_part(
    part: str,
    acc: torch.Tensor,
    table: torch.Tensor,
    perm: torch.Tensor,
    lane_base: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    i0: int,
    k_steps: int,
    group: str = "g1",
    curve: CurveParams = BN254,
) -> torch.Tensor:
    """K1 with body `part`, arguments and result as `bucket_madd_rows`
    (which `full` calls)."""
    code = _check_part(part)
    if part == "full":
        return C.bucket_madd_rows(
            acc, table, perm, lane_base, start, length, i0, k_steps, group, curve
        )
    _native.require_ported("bucket_madd_rows_part", curve.name)
    if group != "g1":
        raise NotImplementedError(f"bucket_madd_rows_part has no {group} instance (G1 alone)")
    lanes = C.check_scan(acc, table, perm, lane_base, start, length, group, curve)
    if acc.device.type == "cpu":
        return bucket_madd_rows_part_plain(
            part, acc, table, perm, lane_base, start, length, i0, k_steps, group, curve
        )
    _native.require_cuda(acc, table, perm, lane_base, start, length)
    out = torch.empty_like(acc)
    _native.launch(
        "bucket_madd_rows_part", f"bucket_madd_rows_part_{part}",
        _native.CURVE_CODES[curve.name], C.GROUPS[group], code,
        acc.data_ptr(), out.data_ptr(), table.data_ptr(), table.shape[1], perm.data_ptr(),
        lane_base.data_ptr(), start.data_ptr(), length.data_ptr(), lanes, int(i0), int(k_steps),
    )
    return out
