"""Pippenger window choice and signed window digits, as torch ops.

Counterpart of the JAX package's `ops/msm.py` (`scalars_to_digits_signed`,
`signed_digits_from_u8_planes`) and the window picks of
`ops/msm_plane.py`.
"""

from __future__ import annotations

import math

import torch

from ..fields.limbs import LIMBS


def pick_window_plane(n: int) -> int:
    """~log2(n) − 6 clamped to [8, 16], capped so that the W·2^c bucket
    accumulators of the reference's layout fit 2 GB (kept as the reference
    has it, so both packages cut the same windows)."""
    c = int(max(8, min(16, math.floor(math.log2(max(n, 256))) - 6)))
    while c > 8:
        W = -(-256 // c)
        if W * (1 << c) * 3 * 40 * 4 <= 2e9:
            break
        c -= 1
    return c


def pick_window_plane_signed(n: int) -> int:
    """Signed digits: one more window bit at the same bucket count."""
    return min(16, pick_window_plane(n) + 1)


def num_windows_signed(c: int, num_bits: int) -> int:
    w_u = -(-num_bits // c)
    b_top = num_bits - (w_u - 1) * c
    return w_u + 1 if b_top >= c else w_u


def signed_digits(std: torch.Tensor, c: int, num_bits: int) -> torch.Tensor:
    """(N, 8) int32 standard-form limbs (canonical) -> (N, W) int32
    balanced window digits in (−2^(c−1), 2^(c−1)], the last window
    non-negative; bit-identical to the reference's
    `scalars_to_digits_signed`."""
    if std.dtype != torch.int32 or std.dim() != 2 or std.shape[1] != LIMBS:
        raise ValueError(f"want int32 (N, 8), got {std.dtype} {tuple(std.shape)}")
    w = std.to(torch.int64) & 0xFFFFFFFF
    w = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)  # room for a straddle
    w_u = -(-num_bits // c)
    W = num_windows_signed(c, num_bits)
    mask = (1 << c) - 1
    cols = []
    for j in range(w_u):
        a, r = divmod(c * j, 32)
        v = w[:, a] >> r
        if r + c > 32:
            v = v | (w[:, a + 1] << (32 - r))
        cols.append(v & mask)
    if W > w_u:
        cols.append(torch.zeros_like(cols[0]))
    half = 1 << (c - 1)
    carry = torch.zeros_like(cols[0])
    out = []
    for j in range(W - 1):
        v = cols[j] + carry
        carry = (v > half).to(torch.int64)
        out.append(v - (carry << c))
    out.append(cols[W - 1] + carry)
    return torch.stack(out, dim=1).to(torch.int32)
