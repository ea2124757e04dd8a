"""Projective points to the proving key's two affine forms, on K19 and K7.

Counterpart of the JAX package's `ops/plane_affine.py`
(`PlaneAffineCodec`). The setup's fixed-base walk (`ops/fixed_base.py`)
leaves (N, 3, K, L) projective limbs (`ops/curve.py`); the key wants
  * u8 rows (N, 2·K·D + 1): X ‖ Y, each component the D bytes of
    x·2^(8·D) mod q (canonical wide Montgomery), then the flag byte, as
    the reference's `pack_rows_u8_host` writes them; and, when asked,
  * the legacy query array (N, 3, K·2L) uint32 of its `pack_affine_host`:
    affine Montgomery limbs at R = 2^(32·L) (the port's R: 2^256 for
    BN254 Fq, 2^384 for BLS12-381 Fq), each u32 word split into two 16-bit
    limbs, Z = 1 and the identity (0, 1, 0).

Z⁻¹ comes from the batch inversion of `ops/msm_affine.py` (K19,
Montgomery's trick in three launches; in G2 over Fq2). A zero Z (the
identity, half of a MulChain `a_tbl`) would zero every inverse of its
block, so those lanes invert one in its place and are written as identity
rows: X = 0, Y = one, flag 0. X·Z⁻¹, Y·Z⁻¹ and
the product by 2^(8·D) are K7 products too (mode 0), and K7 stores every
value reduced, so the bytes are canonical. The rest is torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import fields_of, pack16_to_u32, split_u32_to16, u32_tensor
from ..fields.params import BN254, CurveParams
from .curve import GROUPS, limbs_to_points, points_to_limbs, row_digits
from .msm_affine import affine_tree_mul, batch_inverse


def _one(group: str, curve: CurveParams, device) -> torch.Tensor:
    """(K, L) limbs of the coordinate field's one (Montgomery)."""
    fq = fields_of(curve)[1]
    one = torch.zeros((GROUPS[group], fq.limbs), dtype=torch.int32, device=device)
    one[0] = fq.const(1, device)
    return one


def to_affine(P: torch.Tensor, group: str, curve: CurveParams = BN254):
    """(N, 3, K, L) projective limbs -> (x, y, live): affine x and y
    (N, K, L) Montgomery limbs, the identity as (0, 1), and live (N,) bool,
    false where Z = 0."""
    Z = P[:, 2]
    live = Z.flatten(1).ne(0).any(1)
    one = _one(group, curve, P.device)
    zinv = batch_inverse(torch.where(live[:, None, None], Z, one).contiguous(), group, curve)
    x = affine_tree_mul(P[:, 0].contiguous(), zinv, group, curve=curve)
    y = affine_tree_mul(P[:, 1].contiguous(), zinv, group, curve=curve)
    keep = live[:, None, None]
    return torch.where(keep, x, 0), torch.where(keep, y, one), live


def encode_rows(x: torch.Tensor, y: torch.Tensor, live: torch.Tensor,
                curve: CurveParams = BN254) -> torch.Tensor:
    """Affine limbs (N, K, L) and live flags -> (N, 2·K·D + 1) uint8 rows:
    each base-field component times 2^(8·D) (one K7 product over Fq), its
    4·L little-endian bytes and two zero bytes."""
    N, K, L = x.shape
    fq, D = fields_of(curve)[1], row_digits(curve)
    comps = torch.cat([x, y], dim=1).reshape(-1, 1, L)
    radix = fq.const((1 << (8 * D)) % fq.p, x.device, mont=False)
    wide = affine_tree_mul(comps, radix.expand_as(comps).contiguous(), "g1", curve=curve)
    body = wide.reshape(N, 2 * K, L).view(torch.uint8)
    pad = torch.zeros((N, 2 * K, D - 4 * L), dtype=torch.uint8, device=x.device)
    return torch.cat([torch.cat([body, pad], dim=2).reshape(N, -1),
                      live.to(torch.uint8)[:, None]], dim=1)


def projective_query(P: torch.Tensor) -> np.ndarray:
    """(N, 3, K, L) projective limbs -> the legacy (N, 3, K·2L) uint32
    array of the same coordinates (the reference's legacy fixed-base path
    stores its projective output so)."""
    N = P.shape[0]
    return split_u32_to16(P.cpu().numpy()).reshape(N, 3, -1)


def affine_query(x: torch.Tensor, y: torch.Tensor, live: torch.Tensor, group: str,
                 curve: CurveParams = BN254) -> np.ndarray:
    """Affine limbs -> the legacy (N, 3, K·2L) query: (x, y, 1), the
    identity (0, 1, 0)."""
    z = torch.where(live[:, None, None], _one(group, curve, x.device), 0)
    return projective_query(torch.stack([x, y, z], dim=1))


def convert(P: torch.Tensor, group: str, curve: CurveParams = BN254, want_query: bool = True):
    """(N, 3, K, L) projective limbs -> (u8 rows on P's device, the legacy
    affine query as a host array or None)."""
    x, y, live = to_affine(P, group, curve)
    rows = encode_rows(x, y, live, curve)
    return rows, (affine_query(x, y, live, group, curve) if want_query else None)


def points_to_query(points, group: str, curve: CurveParams = BN254) -> np.ndarray:
    """Host affine points (None = identity) -> the legacy (N, 3, K·2L)
    query, as the reference's `pack_affine_host`."""
    return projective_query(points_to_limbs(points, group, "cpu", curve))


def query_to_points(query: np.ndarray, group: str, curve: CurveParams = BN254) -> list:
    """A legacy (N, 3, K·2L) query (projective or affine) -> host affine
    points."""
    N, K = query.shape[0], GROUPS[group]
    words = pack16_to_u32(query).reshape(N, 3, K, -1)
    return limbs_to_points(u32_tensor(words, "cpu"), group, curve)
