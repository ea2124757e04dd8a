"""The reference's legacy device curve API, on the port's kernels.

Counterpart of `snark_tpu/ops/curve.py:32-321` (`DeviceFq2`,
`_CurveOpsBase`, `CurveOps`, `G2CurveOps`, `get_g1_ops`, `get_g2_ops`).
Points keep the reference's layout: (..., 3, K) projective X, Y, Z in
Montgomery form, K = num_limbs 16-bit limbs in int32 lanes for G1 over Fq
and 2·num_limbs for G2 over Fq2 (c0 ‖ c1 on the last axis), or, under
SNARK_TPU_FIELD_IMPL=f32, twice as many float32 base-256 digits
(`fields.field_impl`). The layout's R = 2^(16·num_limbs) equals the
kernels' 2^(32·L), so `to_kernel` and `from_kernel` only pack and unpack
the limbs into the kernels' (lanes, 3, K, L) 32-bit words
(`fields/device.py`, `device_f32.py` `to_words`, `from_words`):

* `add_impl` (RCB15 Alg. 7, `:127-169`) is K2 `point_add`
  (`ops/curve.py`), `double_impl` (Alg. 9, `:171-193`) K5
  `point_double`, and `scalar_mul_const` the reference's double-and-add
  chain on K5 and K2;
* `select`, `neg_impl`, `is_identity`, `identity_like` and `IDENTITY` are
  torch ops on the field layer, `pack_affine_host` and `to_affine_host`
  run on the host.

On CPU tensors the wrappers run their kernels' plain versions; on a CUDA
tensor they launch the kernel or raise. `DeviceFq2` is torch ops on the
port's `DeviceField` (or `DeviceFieldF32`), digit for digit the
reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import field_impl, get_compute_field
from ..fields.host import Fp
from ..fields.params import CurveParams
from ..fields.towers import Fq2 as HostFq2
from .curve import point_add, point_double


class DeviceFq2:
    """Fq2 = Fq[u]/(u^2+1) over flattened (..., 2K) coordinate tensors, on
    a base device field (`DeviceField` or `DeviceFieldF32`)."""

    def __init__(self, base):
        self.base = base
        self.L = base.L
        self.K = 2 * base.L
        zero = base.const(0)
        self.ZERO = torch.cat([zero, zero])
        self.ONE_MONT = torch.cat([base.const(1), zero])

    def _split(self, a):
        return a[..., : self.L], a[..., self.L :]

    def _join(self, c0, c1):
        return torch.cat([c0, c1], dim=-1)

    def add_impl(self, a, b):
        f = self.base
        (a0, a1), (b0, b1) = self._split(a), self._split(b)
        return self._join(f.add(a0, b0), f.add(a1, b1))

    def sub_impl(self, a, b):
        f = self.base
        (a0, a1), (b0, b1) = self._split(a), self._split(b)
        return self._join(f.sub(a0, b0), f.sub(a1, b1))

    def neg_impl(self, a):
        a0, a1 = self._split(a)
        return self._join(self.base.neg(a0), self.base.neg(a1))

    def double_impl(self, a):
        return self.add_impl(a, a)

    def mul_impl(self, a, b):
        """Karatsuba over u^2 = −1: 3 base products."""
        f = self.base
        (a0, a1), (b0, b1) = self._split(a), self._split(b)
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        t2 = f.mul(f.add(a0, a1), f.add(b0, b1))
        return self._join(f.sub(t0, t1), f.sub(t2, f.add(t0, t1)))

    def square_impl(self, a):
        f = self.base
        a0, a1 = self._split(a)
        c0 = f.mul(f.add(a0, a1), f.sub(a0, a1))
        return self._join(c0, f.double(f.mul(a0, a1)))

    def inv_impl(self, a):
        f = self.base
        a0, a1 = self._split(a)
        ninv = f.inv(f.add(f.mul(a0, a0), f.mul(a1, a1)))
        return self._join(f.mul(a0, ninv), f.neg(f.mul(a1, ninv)))

    neg = neg_impl  # the name the base fields give it, which the curve ops call

    def is_zero(self, a):
        return torch.all(a == 0, dim=-1)

    def eq(self, a, b):
        return torch.all(a == b, dim=-1)

    def select(self, mask, a, b):
        return torch.where(mask[..., None], a, b)

    def const(self, c0: int, c1: int, params=None) -> torch.Tensor:
        return torch.cat([self.base.const(c0), self.base.const(c1)])


class _CurveOpsBase:
    """Complete-formula curve ops over a device field `F` (the base field
    for G1, `DeviceFq2` for G2) on one device, in the reference's point
    layout; the group operations run on the port's kernels."""

    def __init__(self, F, b3_const: torch.Tensor, one: torch.Tensor, df, group: str,
                 curve: CurveParams):
        self.F = F
        self.df = df  # the base field's layout (16-bit limbs or f32 digits)
        self.B3 = b3_const  # 3b in Montgomery form, (K,)
        self.K = b3_const.shape[-1]
        self.group = group
        self.curve = curve
        self.device = b3_const.device
        self.kc = 1 if group == "g1" else 2  # base-field components a coordinate
        self.IDENTITY = torch.stack([torch.zeros_like(one), one, torch.zeros_like(one)])
        self.add = self.add_impl
        self.double = self.double_impl

    # ----- the reference's arrays and the kernels' words -------------------
    def from_numpy(self, arr) -> torch.Tensor:
        """The reference's (..., 3, K) point array (uint32 16-bit limbs, or
        float32 digits under f32; numpy) -> the same layout as a tensor on
        this device (uint32 held as int32). A tensor passes through. Under
        f32 a (..., 3, K/2) uint32 limb array, the layout the port's keys
        hold their query arrays in whatever the field layout
        (`ProvingKey.query`), is split into its digits."""
        if isinstance(arr, torch.Tensor):
            return arr
        a = np.asarray(arr)
        want = np.float32 if self.IDENTITY.dtype == torch.float32 else np.uint32
        if want == np.float32 and a.dtype == np.uint32 and a.shape[-2:] == (3, self.K // 2):
            a = np.stack([a & 0xFF, a >> 8], axis=-1).reshape(a.shape[:-1] + (self.K,))
            a = a.astype(np.float32)
        if a.dtype != want or a.ndim < 2 or a.shape[-2:] != (3, self.K):
            raise ValueError(f"want {np.dtype(want)} (..., 3, {self.K}) points, got {a.dtype} "
                             f"{a.shape}")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def to_numpy(self, pts: torch.Tensor) -> np.ndarray:
        """(..., 3, K) points -> the reference's numpy array (uint32 limbs,
        or float32 digits)."""
        a = pts.detach().cpu().contiguous().numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a

    def to_kernel(self, pts: torch.Tensor) -> torch.Tensor:
        """(..., 3, K) points -> (lanes, 3, kc, L) int32 words, the kernels'
        layout (lanes the product of the batch shape)."""
        pts = self.from_numpy(pts)
        w = self.df.to_words(pts.reshape(-1, 3, self.kc, self.K // self.kc))
        return w.contiguous()

    def from_kernel(self, words: torch.Tensor, batch_shape) -> torch.Tensor:
        """(lanes, 3, kc, L) words -> (*batch_shape, 3, K) points."""
        return self.df.from_words(words).reshape(tuple(batch_shape) + (3, self.K))

    def _lanes(self, fn, *pts):
        pts = torch.broadcast_tensors(*(self.from_numpy(p) for p in pts))
        batch = pts[0].shape[:-2]
        if pts[0].numel() == 0:
            return pts[0].clone()
        out = fn(*(self.to_kernel(p) for p in pts), self.group, self.curve)
        return self.from_kernel(out, batch)

    # ----- group operations -----------------------------------------------
    def identity_like(self, batch_shape) -> torch.Tensor:
        return self.IDENTITY.expand(tuple(batch_shape) + (3, self.K))

    def add_impl(self, p, q) -> torch.Tensor:
        """Complete addition (RCB15 Alg. 7, a = 0), every input pair: K2
        `point_add` over the broadcast batch."""
        return self._lanes(point_add, p, q)

    def double_impl(self, p) -> torch.Tensor:
        """Complete doubling (RCB15 Alg. 9, a = 0): K5 `point_double`."""
        return self._lanes(point_double, p)

    def neg_impl(self, p) -> torch.Tensor:
        p = self.from_numpy(p)
        return torch.stack([p[..., 0, :], self.F.neg(p[..., 1, :]), p[..., 2, :]], dim=-2)

    def select(self, mask, p, q) -> torch.Tensor:
        """mask (...,) -> where(mask, p, q) over (..., 3, K) points."""
        return torch.where(mask[..., None, None], self.from_numpy(p), self.from_numpy(q))

    def is_identity(self, p) -> torch.Tensor:
        return self.F.is_zero(self.from_numpy(p)[..., 2, :])

    def scalar_mul_const(self, p, e: int) -> torch.Tensor:
        """[e]P for a host-known scalar: the reference's double-and-add, one
        K5 launch a bit and one K2 launch a set bit below the top one."""
        p = self.from_numpy(p)
        if e == 0:
            return self.identity_like(p.shape[:-2])
        w = self.to_kernel(p)
        r = w
        for bit in bin(e)[3:]:
            r = point_double(r, self.group, self.curve)
            if bit == "1":
                r = point_add(r, w, self.group, self.curve)
        return self.from_kernel(r, p.shape[:-2])


def _legacy_field(curve: CurveParams, device):
    return get_compute_field(curve.fq, device, field_impl())


class CurveOps(_CurveOpsBase):
    """G1 ops over the base field."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        df = _legacy_field(curve, device)
        super().__init__(df, df.const(3 * curve.b), df.const(1), df, "g1", curve)

    def pack_affine_host(self, points) -> torch.Tensor:
        """Host affine (x, y) ints (None = identity) -> (N, 3, K)
        projective Montgomery points on this device."""
        df = self.df
        xs = [0 if pt is None else pt[0] for pt in points]
        ys = [1 if pt is None else pt[1] for pt in points]
        zs = [0 if pt is None else 1 for pt in points]
        return torch.stack([df.array(xs), df.array(ys), df.array(zs)], dim=1)

    def to_affine_host(self, pts) -> list:
        """(..., 3, K) points -> host affine ints (None = identity)."""
        f = Fp(self.curve.fq)
        arr = self.from_numpy(pts).reshape(-1, 3, self.K)
        X, Y, Z = (self.df.to_host_ints(arr[:, i]) for i in range(3))
        out = []
        for x, y, z in zip(X, Y, Z):
            if z == 0:
                out.append(None)
            else:
                zi = f.inv(z)
                out.append((x * zi % f.p, y * zi % f.p))
        return out


class G2CurveOps(_CurveOpsBase):
    """G2 ops over Fq2 (flattened coordinate pairs)."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        df = _legacy_field(curve, device)
        self.fq2 = DeviceFq2(df)
        q = curve.fq.modulus
        b3 = self.fq2.const(3 * curve.b2[0] % q, 3 * curve.b2[1] % q)
        super().__init__(self.fq2, b3, self.fq2.ONE_MONT, df, "g2", curve)

    def pack_affine_host(self, points) -> torch.Tensor:
        """Host affine ((x0, x1), (y0, y1)) (None = identity) -> (N, 3, 2K)."""
        df = self.df

        def pair(idx, c, absent):
            return [absent if pt is None else pt[idx][c] for pt in points]

        def coord(a, b):
            return torch.cat([df.array(a), df.array(b)], dim=1)

        X = coord(pair(0, 0, 0), pair(0, 1, 0))
        Y = coord(pair(1, 0, 1), pair(1, 1, 0))
        Z = coord([0 if pt is None else 1 for pt in points], [0] * len(points))
        return torch.stack([X, Y, Z], dim=1)

    def to_affine_host(self, pts) -> list:
        fq2 = HostFq2(self.curve.fq.modulus)
        Kb = self.K // 2
        arr = self.from_numpy(pts).reshape(-1, 3, self.K)
        coords = [[self.df.to_host_ints(arr[:, ci, h * Kb : (h + 1) * Kb]) for h in (0, 1)]
                  for ci in range(3)]
        out = []
        for i in range(arr.shape[0]):
            x, y, z = ((coords[ci][0][i], coords[ci][1][i]) for ci in range(3))
            if fq2.is_zero(z):
                out.append(None)
            else:
                zi = fq2.inv(z)
                out.append((fq2.mul(x, zi), fq2.mul(y, zi)))
        return out


@functools.lru_cache(maxsize=None)
def _ops(cls, curve: CurveParams, device: str, impl: str):
    return cls(curve, device)


def get_g1_ops(curve: CurveParams, device="cuda") -> CurveOps:
    """One `CurveOps` per curve, device and field layout."""
    return _ops(CurveOps, curve, str(torch.device(device)), field_impl())


def get_g2_ops(curve: CurveParams, device="cuda") -> G2CurveOps:
    return _ops(G2CurveOps, curve, str(torch.device(device)), field_impl())
