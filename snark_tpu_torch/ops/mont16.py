"""Standalone Montgomery products over 16-bit limbs: K9 (`mont_mul16`) and
K10 (`mont_mul16_limb_major`), and their plain PyTorch version.

Both compute a·b·R^-1 mod p over a scalar field (BN254 Fr or BLS12-381 Fr,
R = 2^256) on the JAX package's element layout: (N, 16) int32 tensors of
16-bit limbs (the reference's uint32 limbs, each below 2^16), canonical in
and out, so arrays of the reference carry across unchanged.

- K9 is the counterpart of `snark_tpu/ops/pallas_field.py` `make_mont_mul`
  (`pallas_call` at :266): it reads the row-major (N, 16) arrays as they
  are, one thread an element.
- K10 is the counterpart of `scripts/pallas_field_v2.py` `make_mont_mul_v2`
  (`pallas_call` at :128): the wrapper transposes to limb-major (16, N) and
  back with torch, as the reference converts to digit planes outside its
  kernel, and the kernel reads coalesced rows.

`field` is the port's `Field` of the scalar field (`fields/limbs.py`
`FR`, `BLS_FR`). On a CPU tensor the wrappers run `mont_mul16_plain`; on a
CUDA tensor they launch the kernel, and a failed build or launch raises.
The sources are `csrc/field16_kernels.cuh` and `csrc/field16.cu`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _native
from ..fields.limbs import Field, mont_mul_words
from .ntt import _curve_of

DEFAULT_THREADS = 256


def limbs16(field: Field) -> int:
    """16-bit limbs per element: twice the u32 words (the two radixes must
    be one R)."""
    if field.params.num_limbs != 2 * field.limbs:
        raise ValueError(f"{field.params.name}: R = 2^(16·L16) differs from 2^(32·L)")
    return 2 * field.limbs


def _check(a: torch.Tensor, b: torch.Tensor, field: Field) -> int:
    L16 = limbs16(field)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != L16:
            raise ValueError(f"{name}: want int32 (n, {L16}), got {t.dtype} {tuple(t.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"a and b differ in shape: {tuple(a.shape)}, {tuple(b.shape)}")
    return a.shape[0]


def pack_words(x16: torch.Tensor) -> torch.Tensor:
    """(..., 2L) 16-bit limbs -> (..., L) int64 32-bit words."""
    x = x16.to(torch.int64)
    return x[..., 0::2] | (x[..., 1::2] << 16)


def unpack_words(w: torch.Tensor) -> torch.Tensor:
    """(..., L) int64 words -> (..., 2L) int32 16-bit limbs."""
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2).to(torch.int32)


def mont_mul16_plain(a: torch.Tensor, b: torch.Tensor, field: Field) -> torch.Tensor:
    """Plain version of K9 and K10: the port's word product
    (`fields/limbs.py` `mont_mul_words`) on the packed limbs."""
    _check(a, b, field)
    return unpack_words(mont_mul_words(pack_words(a), pack_words(b), field))


def _launch(kernel: str, field: Field, a, b, out, n: int, threads: int) -> None:
    curve = _curve_of(field)
    _native.launch(
        kernel, _native.counter_name(kernel, curve), _native.CURVE_CODES[curve],
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(threads),
    )


def mont_mul16(
    a: torch.Tensor, b: torch.Tensor, field: Field, threads: int = DEFAULT_THREADS
) -> torch.Tensor:
    """K9: a·b·R^-1 mod p on (n, 16) 16-bit limbs, row-major."""
    n = _check(a, b, field)
    if a.device.type == "cpu":
        return mont_mul16_plain(a, b, field)
    _native.require_cuda(a, b)
    out = torch.empty_like(a)
    _launch("mont_mul16", field, a, b, out, n, threads)
    return out


def mont_mul16_limb_major(
    a: torch.Tensor, b: torch.Tensor, field: Field, threads: int = DEFAULT_THREADS
) -> torch.Tensor:
    """K10: the same product, the kernel on limb-major (16, n) copies."""
    n = _check(a, b, field)
    if a.device.type == "cpu":
        return mont_mul16_plain(a, b, field)
    _native.require_cuda(a, b)
    at, bt = a.t().contiguous(), b.t().contiguous()
    out = torch.empty_like(at)
    _launch("mont_mul16_limb_major", field, at, bt, out, n, threads)
    return out.t().contiguous()


def limbs16_tensor(arr16: np.ndarray, device) -> torch.Tensor:
    """(N, 16) uint32 16-bit limbs (the reference's arrays) -> int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr16, dtype=np.uint32).astype(np.int32)).to(device)
