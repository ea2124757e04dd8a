"""Proving across many proofs and many ranks: batched proving under one key
(`BatchProver`, its batch split over a mesh axis where one is given) and
distributed proving over `torch.distributed` (`parallel/plane_dist.py`:
`DistPlaneMsm`, `DistPlaneNtt`, `DistPlaneProver`), and the reference's
legacy distributed MSM and NTT (`sharded_msm`, `DistNttPlan`), on meshes
of ranks (`parallel/mesh.py`) that `parallel/launch.py` `run_ranks`
starts.
"""

from .batch import BatchProver, BatchRun
from .dist_msm import sharded_msm
from .dist_ntt import DistNttPlan
from .mesh import Mesh, local_mesh, make_mesh
from .plane_dist import DistPlaneMsm, DistPlaneNtt, DistPlaneProver

__all__ = ["BatchProver", "BatchRun", "DistNttPlan", "DistPlaneMsm", "DistPlaneNtt",
           "DistPlaneProver", "Mesh", "local_mesh", "make_mesh", "sharded_msm"]
