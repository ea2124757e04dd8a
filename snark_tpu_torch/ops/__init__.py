"""The port's device operations: the kernel wrappers (`curve`, `ntt`,
`msm_plane`, ...) and, under the reference's names, its legacy device API
(`snark_tpu/ops/__init__.py`): the NTT plan, the curve ops and the
Pippenger and fixed-base MSMs of `ntt_u32`, `curve_u32` and `msm_u32`,
which run on the port's kernels in the reference's point and element
layout."""

from . import curve_host
from .curve_u32 import CurveOps, DeviceFq2, G2CurveOps, get_g1_ops, get_g2_ops
from .msm import pick_window, scalars_to_digits
from .msm_u32 import FixedBasePlan, MsmPlan, get_msm_plan, msm
from .ntt_u32 import NttPlan, get_ntt_plan

__all__ = [
    "CurveOps",
    "DeviceFq2",
    "FixedBasePlan",
    "G2CurveOps",
    "MsmPlan",
    "NttPlan",
    "curve_host",
    "get_g1_ops",
    "get_g2_ops",
    "get_msm_plan",
    "get_ntt_plan",
    "msm",
    "pick_window",
    "scalars_to_digits",
]
