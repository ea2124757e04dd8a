"""The reference's legacy distributed NTT, on the port's six-step NTT.

Counterpart of `snark_tpu/parallel/dist_ntt.py:36-160` (`DistNttPlan`):
`fft`, `ifft`, `coset_fft` and `coset_ifft` of n = n1·n2 over one mesh
axis, each rank holding its contiguous block of the natural-order vector
(n/ndev, L16) in the legacy API's layout (16-bit limbs, or f32 digits
under SNARK_TPU_FIELD_IMPL=f32). The shard semantics are those of
`parallel/plane_dist.py` `DistPlaneNtt`, so each call converts the shard to
the kernels' words and runs it (three `Mesh.all_to_all` transposes around
K3 `ntt_rows` launches and K4's twiddles); the coset scale and unscale
are one K4 product each on the rank's shard of g^±i.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import field_impl, get_compute_field
from ..fields.limbs import field_of
from ..fields.params import FieldParams, get_curve
from ..ops.ntt import field_ew
from .mesh import Mesh, local_mesh
from .plane_dist import DistPlaneNtt


class DistNttPlan:
    """NTT of size n = n1·n2 over a 1-D mesh axis (both multiples of the
    axis size)."""

    def __init__(self, params: FieldParams, n1: int, n2: int, mesh: Mesh, axis: str):
        self.params = params
        self.n1, self.n2, self.n = n1, n2, n1 * n2
        self.mesh, self.axis = mesh, axis
        self.df = get_compute_field(params, mesh.device, field_impl())
        self.field = field_of(params)
        self.plan = DistPlaneNtt(n1, n2, mesh, axis, self.field)

    def _apply(self, fn, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.mesh.device)
        return self.df.from_words(fn(self.df.to_words(x).contiguous()))

    def fft(self, coeffs) -> torch.Tensor:
        """This rank's shard of the coefficients -> its shard of the
        natural-order evaluations."""
        return self._apply(self.plan.fft, coeffs)

    def ifft(self, evals) -> torch.Tensor:
        return self._apply(self.plan.ifft, evals)

    def coset_fft(self, coeffs) -> torch.Tensor:
        """Evaluations over g·H (the Groth16 h path)."""
        f = self.field
        return self._apply(
            lambda w: self.plan.fft(field_ew("mul", w, self.plan.coset_scale, field=f)), coeffs)

    def coset_ifft(self, evals) -> torch.Tensor:
        f = self.field
        return self._apply(
            lambda w: field_ew("mul", self.plan.ifft(w), self.plan.coset_unscale, field=f), evals)


def dist_legacy_transforms(coeffs: np.ndarray, n1: int, n2: int, curve: str = "bn254",
                           device="cuda", axis: str = "x") -> dict:
    """One rank's part of `DistNttPlan` over a 1-D mesh of the world, every
    rank given the whole (n1·n2, L16) Montgomery vector in the legacy
    layout -> this rank's shards (numpy) of fft, ifft(fft), coset_fft and
    coset_ifft(coset_fft)."""
    mesh = local_mesh(axis, device=device)
    dplan = DistNttPlan(get_curve(curve).fr, n1, n2, mesh, axis)
    nl = dplan.n // mesh.size(axis)
    i = mesh.index(axis)
    x = torch.as_tensor(coeffs[i * nl : (i + 1) * nl])
    ev, cev = dplan.fft(x), dplan.coset_fft(x)
    out = {"fft": ev, "ifft": dplan.ifft(ev), "coset_fft": cev, "coset_ifft": dplan.coset_ifft(cev)}
    return {k: v.cpu().numpy() for k, v in out.items()}
