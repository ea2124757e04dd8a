"""Fixed-base MSM [s_i]·G for the setup's query vectors, on K1.

Counterpart of the JAX package's `ops/fixed_base_plane.py`
(`PlaneFixedBase`) and of its legacy `ops/msm.py` `FixedBasePlan`, which
its setup takes for vectors shorter than 2048.

The generator table has W·256 rows, W = ceil(num_bits / 8): row w·256 + d
holds d·2^(8w)·G in the key's u8 row format (`ops/curve.py`), row d = 0
the identity row. It is built on the host once per curve and group and
cached. With c = 8 and no sign, the digits of a scalar are the bytes of
its standard form (`ops/msm.py` unsigned_digits), and
[s]G = Σ_w row(w·256 + digit_w). The walk is one K1 (`bucket_madd_rows`)
launch a chunk of lanes: lane l reads perm[l·W + w] = w·256 + digit[l, w]
from lane_base l·W, start 0, length W, all W steps in the launch, from
identity accumulators. The payloads are unsigned (bit 31 never set) and
K1 skips the identity rows.

The reference's legacy path adds, from the identity, the table's points
as projective (x, y, 1) (the identity (0, 1, 0)) with the complete
addition, one window at a time, identity rows included. Its projective
output is what a key of such a vector stores as its query array, so
`walk_legacy` runs the same chain (`table_walk`, which the legacy
`FixedBasePlan` of `ops/msm_u32.py` runs too), one K2 `point_add` launch
a window.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.limbs import fields_of
from ..fields.params import BN254, CurveParams
from . import affine_codec
from .curve import bucket_madd_rows, decode_rows, identity, pack_rows_u8, point_add
from .curve_host import host_g1, host_g2
from .msm import unsigned_digits

C = 8  # window bits: a digit is a byte of the scalar
PLANE_MIN = 1 << 11  # the reference's SNARK_TPU_SETUP_PLANE_MIN: below, its legacy path
CHUNK = 1 << 20  # lanes a K1 launch (2^20 BLS12-381 G2 accumulators: 302 MB)


def table_walk(pts: torch.Tensor, digits: torch.Tensor, c: int, group: str,
               curve: CurveParams = BN254, add=point_add) -> torch.Tensor:
    """The reference's legacy fixed-base product (`snark_tpu/ops/msm.py`
    `FixedBasePlan._impl`, `:378-389`): from the identity, acc +
    pts[w·2^c + digits[:, w]] for w = 0..W − 1, one complete addition (K2
    `point_add`, or `add`) a window. pts (W·2^c, 3, K, L) projective limbs,
    table entry d of window w at row w·2^c + d; digits (N, W) -> (N, 3, K,
    L). `FixedBase.walk_legacy` and the legacy `FixedBasePlan` run it."""
    d = digits.to(device=pts.device, dtype=torch.int64)
    acc = identity(d.shape[0], group, pts.device, curve)
    for w in range(d.shape[1]):
        acc = add(acc, pts[(w << c) + d[:, w]], group, curve)
    return acc


def num_windows(curve: CurveParams) -> int:
    return -(-curve.fr.num_bits // C)


@functools.lru_cache(maxsize=None)
def generator_rows(curve: CurveParams, group: str) -> np.ndarray:
    """(W·256, row_bytes) uint8: row w·256 + d holds d·2^(8w)·G, built on
    the host (W·255 affine additions and 8·W doublings)."""
    hc = host_g1(curve) if group == "g1" else host_g2(curve)
    pts, g = [], hc.generator
    for _ in range(num_windows(curve)):
        acc = None
        pts.append(None)
        for _ in range((1 << C) - 1):
            acc = hc.add(acc, g)
            pts.append(acc)
        for _ in range(C):
            g = hc.double(g)
    return pack_rows_u8(pts, group, curve)


class FixedBase:
    """[s_i]·G for the generator G of one group, on one device."""

    def __init__(self, curve: CurveParams = BN254, group: str = "g1", device="cuda"):
        self.curve, self.group, self.device = curve, group, torch.device(device)
        self.W = num_windows(curve)
        self._table = None

    @property
    def table(self) -> torch.Tensor:
        if self._table is None:
            self._table = torch.as_tensor(generator_rows(self.curve, self.group),
                                          device=self.device)
        return self._table

    def digits(self, std: torch.Tensor) -> torch.Tensor:
        """(N, L) standard-form scalars -> (N, W) window digits."""
        return unsigned_digits(std, C, self.curve.fr.num_bits)

    def walk_operands(self, std: torch.Tensor):
        """K1's operands for the walk of (N, L) standard-form scalars ->
        (acc, perm, lane_base, start, length): identity accumulators and
        one run of W table rows a lane."""
        N, dev = std.shape[0], std.device
        window = torch.arange(self.W, dtype=torch.int32, device=dev) << C
        perm = (self.digits(std) + window).reshape(-1).contiguous()
        lane_base = torch.arange(N, dtype=torch.int32, device=dev) * self.W
        start = torch.zeros(N, dtype=torch.int32, device=dev)
        length = torch.full((N,), self.W, dtype=torch.int32, device=dev)
        return identity(N, self.group, dev, self.curve), perm, lane_base, start, length

    def walk(self, std: torch.Tensor) -> torch.Tensor:
        """[s_i]·G -> (N, 3, K, L) projective limbs: one K1 launch a chunk."""
        outs = []
        for lo in range(0, std.shape[0], CHUNK):
            acc, perm, lane_base, start, length = self.walk_operands(std[lo : lo + CHUNK])
            outs.append(bucket_madd_rows(acc, self.table, perm, lane_base, start, length, 0,
                                         self.W, self.group, self.curve))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def walk_legacy(self, std: torch.Tensor) -> torch.Tensor:
        """The reference's legacy chain (`table_walk`) over the generator
        table's points as projective (x, y, 1), the identity (0, 1, 0) ->
        (N, 3, K, L) projective limbs."""
        fq = fields_of(self.curve)[1]
        x, y = decode_rows(self.table, self.group, self.curve)  # the identity decodes to (0, 1)
        z = torch.zeros_like(x)
        z[:, 0] = torch.where((self.table[:, -1] != 0)[:, None], fq.const(1, x.device), 0)
        pts = torch.stack([x, y, z], dim=1)
        return table_walk(pts, self.digits(std), C, self.group, self.curve)

    def points(self, std: torch.Tensor) -> torch.Tensor:
        """[s_i]·G -> (N, 3, K, L) projective limbs: vectors shorter than
        PLANE_MIN take the reference's legacy chain, longer ones the K1
        walk."""
        return self.walk_legacy(std) if std.shape[0] < PLANE_MIN else self.walk(std)

    def encode(self, P: torch.Tensor, want_query: bool = True):
        """`points`' output -> (u8 rows on the device, the legacy query as
        a host array or None): a legacy chain's query is its projective
        output, always made; the walk's is affine."""
        if P.shape[0] < PLANE_MIN:
            rows, _ = affine_codec.convert(P, self.group, self.curve, want_query=False)
            return rows, affine_codec.projective_query(P)
        return affine_codec.convert(P, self.group, self.curve, want_query)
