"""Pippenger window choice and window digits, as torch ops.

Counterpart of the JAX package's `ops/msm.py` (`pick_window`,
`scalars_to_digits`, `scalars_to_digits_signed`, `digits_from_limbs_device`,
`signed_digits_from_u8_planes`) and the window picks of
`ops/msm_plane.py`. `scalars_to_digits` and `scalars_to_digits_signed`
are the reference's host functions on (N, L) 16-bit limb arrays, numpy in
and out; `unsigned_digits` and `signed_digits` compute the same digits
from the kernels' 32-bit words on the device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


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


PLANE_MIN_POINTS = 2048  # where the reference's prover starts to take its plane MSM


def pick_window_small(n: int) -> int:
    """The window of the reference's legacy MSM, which its prover takes below
    2048 variables: ~log2(n) − 6 clamped to [4, 16], and 4 up to 32 points."""
    return 4 if n <= 32 else int(max(4, min(16, math.floor(math.log2(n)) - 6)))


def pick_window(n: int) -> int:
    """The legacy MSM's window (`snark_tpu/ops/msm.py:35-49`):
    `pick_window_small`, capped by SNARK_TPU_MSM_WINDOW where it is set."""
    c = pick_window_small(n)
    cap = int(os.environ.get("SNARK_TPU_MSM_WINDOW", "0"))
    return min(c, cap) if cap else c


def scalars_to_digits(scalars, c: int, num_bits: int) -> np.ndarray:
    """(N, L) 16-bit-limb standard-form scalars (uint32 lanes) -> (N, W)
    uint32 window digits, W = ceil(num_bits / c) (host; `:52-70`)."""
    arr = np.asarray(scalars, dtype=np.uint32)
    n, L = arr.shape
    bits = np.unpackbits(arr.astype("<u2").view(np.uint8).reshape(n, 2 * L), axis=1,
                         bitorder="little")
    W = -(-num_bits // c)
    digits = np.zeros((n, W), dtype=np.uint32)
    for w in range(W):
        seg = bits[:, w * c : min((w + 1) * c, bits.shape[1])]
        digits[:, w] = seg @ (1 << np.arange(seg.shape[1], dtype=np.uint32)).astype(np.uint32)
    return digits


def scalars_to_digits_signed(scalars, c: int, num_bits: int) -> np.ndarray:
    """(N, L) 16-bit-limb scalars -> (N, W) int32 balanced digits in
    (−2^(c−1), 2^(c−1)], the last window non-negative, with a carry window
    where the top unsigned window spans all c bits (host; `:73-99`)."""
    d = scalars_to_digits(scalars, c, num_bits).astype(np.int64)
    n, w_u = d.shape
    if num_bits - (w_u - 1) * c >= c:
        d = np.concatenate([d, np.zeros((n, 1), np.int64)], axis=1)
    W = d.shape[1]
    half = 1 << (c - 1)
    carry = np.zeros(n, np.int64)
    for w in range(W - 1):
        v = d[:, w] + carry
        carry = (v > half).astype(np.int64)
        d[:, w] = v - (carry << c)
    d[:, W - 1] += carry
    return d.astype(np.int32)


def digits_from_limbs_device(limbs: torch.Tensor, c: int, num_bits: int) -> torch.Tensor:
    """(N, L) int32 standard-form 16-bit limbs on the device -> (N, W)
    int32 window digits, for c dividing 16 (`:101-116`)."""
    if 16 % c:
        raise ValueError(f"device digit extraction needs c | 16, got c = {c}")
    n, L = limbs.shape
    mask = (1 << c) - 1
    parts = [(limbs >> (c * k)) & mask for k in range(16 // c)]
    return torch.stack(parts, dim=-1).reshape(n, L * (16 // c))[:, : -(-num_bits // c)]


def pick_window_plane_signed(n: int) -> int:
    """Signed digits: one more window bit at the same bucket count. Below
    2048 points the port's plane MSM takes the legacy path's window, so that
    its W·2^(c−1) bucket lanes stay near n (the plane pick, c = 9, gives
    7,424 lanes for the 26 points of a 12-constraint circuit)."""
    if n < PLANE_MIN_POINTS:
        return pick_window_small(n)
    return min(16, pick_window_plane(n) + 1)


def num_windows_signed(c: int, num_bits: int) -> int:
    w_u = -(-num_bits // c)
    b_top = num_bits - (w_u - 1) * c
    return w_u + 1 if b_top >= c else w_u


def _check_std(std: torch.Tensor, num_bits: int) -> None:
    if std.dtype != torch.int32 or std.dim() != 2 or 32 * std.shape[1] < num_bits:
        raise ValueError(f"want int32 (N, L) of {num_bits} bits, got {std.dtype} {tuple(std.shape)}")


def _windows(std: torch.Tensor, c: int, count: int) -> list[torch.Tensor]:
    """(N, L) int32 limbs -> `count` int64 columns of c-bit windows."""
    w = std.to(torch.int64) & 0xFFFFFFFF
    w = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)  # room for a straddle
    mask = (1 << c) - 1
    cols = []
    for j in range(count):
        a, r = divmod(c * j, 32)
        v = w[:, a] >> r
        if r + c > 32:
            v = v | (w[:, a + 1] << (32 - r))
        cols.append(v & mask)
    return cols


def unsigned_digits(std: torch.Tensor, c: int, num_bits: int) -> torch.Tensor:
    """(N, L) int32 standard-form limbs (canonical) -> (N, W) int32 window
    digits in [0, 2^c), W = ceil(num_bits / c); equal to the reference's
    `scalars_to_digits`."""
    _check_std(std, num_bits)
    return torch.stack(_windows(std, c, -(-num_bits // c)), dim=1).to(torch.int32)


def signed_digits(std: torch.Tensor, c: int, num_bits: int) -> torch.Tensor:
    """(N, L) int32 standard-form limbs (canonical) -> (N, W) int32
    balanced window digits in (−2^(c−1), 2^(c−1)], the last window
    non-negative; bit-identical to the reference's
    `scalars_to_digits_signed` (num_bits 254 for BN254 Fr, 255 for
    BLS12-381 Fr)."""
    _check_std(std, num_bits)
    w_u = -(-num_bits // c)
    W = num_windows_signed(c, num_bits)
    cols = _windows(std, c, w_u)
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
