"""The reference's legacy MSM over one mesh axis, on the port's kernels.

Counterpart of `snark_tpu/parallel/dist_msm.py:22-56` (`sharded_msm`).
Where the reference runs one program over the mesh under `shard_map`, each
rank here holds its own contiguous block of the points and their digits
(`parallel/plane_dist.py` shards the same way), runs the legacy
`MsmPlan.__call__` on it (K2 bucket steps and scans, one K18 combine),
all-gathers the (3, K) partials (`Mesh.all_gather`) and folds them from
the identity in rank order with K2 `point_add`, one launch a partial, as
the reference folds them; every rank returns the same total.
"""

from __future__ import annotations

import numpy as np

from ..fields.params import get_curve
from ..ops.curve import identity, point_add
from ..ops.curve_u32 import _CurveOpsBase, get_g1_ops, get_g2_ops
from ..ops.msm import pick_window
from ..ops.msm_u32 import MsmPlan
from .mesh import Mesh, local_mesh


def sharded_msm(ops: _CurveOpsBase, mesh: Mesh, axis: str, points, digits,
                c: int | None = None):
    """Σ s_i·P_i over the axis. points (N/ndev, 3, K) and digits
    (N/ndev, W) are this rank's shard (in the reference's point layout, on
    this rank's device or numpy) -> the (3, K) total, the same on every
    rank of the axis."""
    pts = ops.from_numpy(points)
    c = c or pick_window(max(pts.shape[0], 2))
    local = MsmPlan(ops, c).msm_words(pts, digits)  # (3, kc, L)
    acc = identity(1, ops.group, local.device, ops.curve)
    for part in mesh.all_gather(local, axis):
        acc = point_add(acc, part[None], ops.group, ops.curve)
    return ops.from_kernel(acc, ())


def dist_sharded_msm(points: np.ndarray, digits: np.ndarray, c: int, group: str = "g1",
                     curve: str = "bn254", device="cuda", axis: str = "shard") -> np.ndarray:
    """One rank's part of `sharded_msm` over a 1-D mesh of the world, every
    rank given the whole reference-layout (N, 3, K) points and (N, W)
    digits -> the total as the reference's (3, K) numpy array."""
    mesh = local_mesh(axis, device=device)
    cv = get_curve(curve)
    ops = (get_g1_ops if group == "g1" else get_g2_ops)(cv, mesh.device)
    per = points.shape[0] // mesh.size(axis)
    i = mesh.index(axis)
    block = slice(i * per, (i + 1) * per)
    return ops.to_numpy(sharded_msm(ops, mesh, axis, points[block], digits[block], c))
