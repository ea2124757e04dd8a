"""K18 `horner_combine`, the MSM's Horner combine in one launch: its plain
version against the chain of plain K5 and K2 (limb for limb), against the
host Horner (`PlaneMsm.combine_host`) and against the JAX package's device
combine (`PlaneMsm._combine_impl`, interpret mode), on the edge totals of
`ops/curve.py` `horner_cases`. The kernel itself runs on the card only
(`tests/test_torch_gpu.py::test_horner_combine_matches_plain`).

W = 4 windows and c = 3 for the JAX combine, W = 3 and c = 2 elsewhere,
keep the plain chains short; compiling the JAX G2 combine takes most of
the file's time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.msm_plane import get_plane_msm
from snark_tpu.ops.pallas_curve import get_plane_curve, pack_points_host, unpack_points_host

from snark_tpu_torch.bench import host_curve
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops.msm_plane import PlaneMsm

W, C_BITS = 4, 3  # the JAX combine's
W_PLAIN, C_PLAIN = 3, 2
CURVE_GROUPS = [(BN254, "g1"), (BN254, "g2"), (BLS12_381, "g1"), (BLS12_381, "g2")]
TILE = 32  # the JAX plan's lanes, as tests/test_torch_combine.py


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_plain_equals_kernel_chain():
    """horner_combine_plain is the chain of plain K5 and K2, limb for limb,
    on both curves and groups, and the CPU wrapper takes it."""
    for curve, group in CURVE_GROUPS:
        cases = C.horner_cases(W_PLAIN, C_PLAIN, group, "cpu", curve, seed=1)
        for name, sums, c in cases:
            got = C.horner_combine_plain(sums, c, group, curve)
            assert tuple(got.shape) == (3, C.GROUPS[group], C.limbs_of(curve))
            chain = C.horner_chain(sums, c, group, curve, C.point_double_plain, C.point_add_plain)
            assert torch.equal(got, chain), (curve.name, group, name)
        name, sums, c = cases[-1]
        assert torch.equal(C.horner_combine(sums, c, group, curve), got)


def test_device_combine_equals_host_horner(monkeypatch):
    """`PlaneMsm.combine` on CPU totals (K18's plain version) equals the host
    Horner after normalisation, and never reaches K5 or K2."""

    def refuse(*args, **kwargs):
        raise AssertionError("the combine ran a per-operation kernel")

    monkeypatch.setattr(C, "point_double_plain", refuse)  # what K5 and K2 take on the CPU
    monkeypatch.setattr(C, "point_add_plain", refuse)
    for curve, group in CURVE_GROUPS:
        hc = host_curve(group, curve)
        for name, sums, c in C.horner_cases(W_PLAIN, C_PLAIN, group, "cpu", curve, seed=2):
            if name == "edge_limbs":  # not curve points: no host Horner
                continue
            plan = PlaneMsm(c, c * sums.shape[0], group, signed=False, curve=curve)
            assert plan.W == sums.shape[0]
            got = C.limbs_to_points(plan.combine(sums)[None], group, curve)[0]
            assert got == plan.combine_host(sums, hc), (curve.name, group, name)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_equals_jax_combine(group):
    """horner_combine_plain equals the JAX package's device combine
    (`_combine_impl`: a fori_loop of make_point_double and make_point_add,
    interpret mode) on the same totals, after normalisation."""
    pc = get_plane_curve(J_BN254)
    jplan = get_plane_msm(J_BN254, C_BITS, interpret=True, group=group, tile=TILE)
    hc = host_curve(group, BN254)
    for name, sums, c in C.horner_cases(W, C_BITS, group, "cpu", BN254, seed=3):
        if name == "edge_limbs" or (sums.shape[0], c) != (W, C_BITS):
            continue  # the JAX plan takes curve points at one (W, c)
        pts = C.limbs_to_points(sums, group, BN254)
        planes = [jnp.asarray(p) for p in pack_points_host(pc, pts, group)]
        out = jplan._combine(*planes, W)
        want = unpack_points_host(pc, *(np.asarray(o) for o in out), group=group)[0]
        got = C.limbs_to_points(C.horner_combine_plain(sums, c, group)[None], group)[0]
        assert got == want, name
        assert want == PlaneMsm(c, c * W, group, signed=False).combine_host(sums, hc)
