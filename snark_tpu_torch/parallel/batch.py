"""Batched proving: many proofs of one circuit shape under one proving key.

The port's counterpart of the JAX package's `parallel/batch.py`
`BatchProver`. Each proof's device core is the reference's `_one_proof`
with `_h_digits`:

1. upload z, Montgomery conversion and the three padded-CSR matvecs (K4)
   and h = (A·B − C)/Z_H by `NttPlan.h_std` (K3 passes): `Groth16.witness_h`,
   as the single prove runs them;
2. signed c-bit digits of z and h and the five MSMs' tables:
   `Groth16.msm_terms`;
3. the five MSMs A, B (G2), B1, L, H, each `PlaneMsm.window_sums` (K1 scan,
   K2 folds) followed by `PlaneMsm.combine` (one K18 launch): the Horner
   combine stays on the device, as in the reference, and the projective
   results of the whole batch go into one device tensor a group.

The batch is read back once, its points made affine on the host and each
proof assembled there (`assemble_proof`). The reference stacks the whole
batch's digits into one (B, M, W) tensor; here each proof makes its own
inside its step, so the device holds one proof's z, digits and h at a time
beside the key.

With a mesh (`parallel/mesh.py`), the batch is split over one of its axes,
the reference's shard_map over "dp": the rank of coordinate i proves the
i-th contiguous share of B/size proofs on its device (B a multiple of the
axis size), assembles them, and the proofs are all-gathered, so every rank
returns the whole batch in order. Ranks that differ only on other axes
prove the same share. `h_core` is the reference's dp-sharded h pipeline
alone, and `lite` makes the device core compute the A and B MSMs alone, as
the reference's does for its multichip dry run.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import _native
from ..fields.host import Fp
from ..groth16.groth16 import (
    Groth16,
    Proof,
    ProvingKey,
    _stage_clock,
    assemble_proof,
    synthesize_witness,
)
from ..ops.curve import GROUPS, limbs_of, limbs_to_points
from ..ops.msm import pick_window_plane_signed, signed_digits
from .mesh import Mesh, make_mesh

LITE_TERMS = ("A", "B")


@dataclass
class BatchRun:
    """What the last batch left behind, in milliseconds of wall time, each
    interval ending in a device synchronise. `stage_ms`: "synthesize"
    (this rank's witnesses, on the host), "device" (every proof's device
    core), "readback" (the MSM results to the host, made affine),
    "assemble", and with a mesh "gather" (the proofs of every rank).
    `device_ms`: the device stage split over the proofs into "upload" (z
    encoded on the host and copied), "matvec", "h", "digits",
    "window_sums" (K1 and K2, five MSMs a proof) and "combine" (K18, five
    launches a proof)."""

    stage_ms: dict
    device_ms: dict


class BatchProver:
    """prove_batch(circuits) -> [Proof] under one ProvingKey, on the
    prover's device (with a mesh, the rank's: the key's tables on it too).
    Signed digits for all five MSMs, as the single prover."""

    def __init__(self, g16: Groth16, pk: ProvingKey, mesh: Mesh | None = None,
                 axis: str = "dp", lite: bool = False):
        if pk.vk.curve is not g16.curve:
            raise ValueError(f"a {pk.vk.curve.name} key for a {g16.curve.name} prover")
        if mesh is not None and g16.device != mesh.device:
            raise ValueError(f"the prover is on {g16.device}, the rank on {mesh.device}")
        self.g16 = g16
        self.pk = pk
        self.mesh = mesh
        self.axis = axis
        self.lite = lite
        self.last_run: BatchRun | None = None

    def share(self, batch: int) -> range:
        """The proofs of a batch this rank proves: all without a mesh."""
        if self.mesh is None:
            return range(batch)
        size = self.mesh.size(self.axis)
        if batch % size:
            raise ValueError(f"a batch of {batch} does not split over the {size} ranks of "
                             f"axis {self.axis!r}")
        per = batch // size
        i = self.mesh.index(self.axis)
        return range(i * per, (i + 1) * per)

    def _one_proof(self, z: list[int], out_g1: torch.Tensor, out_g2: torch.Tensor, tick) -> None:
        """The device core of one proof: the A, B1, L, H sums (A alone when
        lite) into out_g1 (k, 3, 1, L) and the B sum into out_g2 (3, 2, L),
        projective."""
        g16 = self.g16
        if self.lite:
            z_std, h_std = g16.fr.tensor(z, g16.device, mont=False), None
            tick("upload")
        else:
            z_std, h_std = g16.witness_h(self.pk, z, tick)
        terms = g16.msm_terms(self.pk, z_std, h_std)
        if self.lite:
            terms = [t for t in terms if t[0] in LITE_TERMS]
        tick("digits")
        g1_rows = iter(out_g1)
        for _name, plan, tbl, digits in terms:
            sums = plan.window_sums(tbl, digits.contiguous())
            tick("window_sums")
            (out_g2 if plan.group == "g2" else next(g1_rows)).copy_(plan.combine(sums))
            tick("combine")

    def core(self, zs: list[list[int]], tick=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The device core of this rank's share of a batch of assignments
        -> (G1 sums (share, k, 3, 1, L): A, B1, L, H, or A alone when
        lite; B sums (share, 3, 2, L)), projective, on the device."""
        g16 = self.g16
        tick = tick or _stage_clock(g16.device, {})
        share = self.share(len(zs))
        L = limbs_of(g16.curve)
        k = 1 if self.lite else 4
        out_g1 = torch.empty((len(share), k, 3, GROUPS["g1"], L), dtype=torch.int32,
                             device=g16.device)
        out_g2 = torch.empty((len(share), 3, GROUPS["g2"], L), dtype=torch.int32,
                             device=g16.device)
        for j, b in enumerate(share):
            self._one_proof(zs[b], out_g1[j], out_g2[j], tick)
        return out_g1, out_g2

    def h_core(self, zs: list[list[int]]) -> torch.Tensor:
        """The matvec and h pipeline alone for this rank's share of a batch
        of assignments -> (share, n, W) int32 signed digits of h, in the
        key's bit-reversed order (those the H MSM takes)."""
        g16, pk = self.g16, self.pk
        c = pick_window_plane_signed(pk.num_instance + pk.num_witness)
        tick = _stage_clock(g16.device, {})
        return torch.stack([
            signed_digits(g16.witness_h(pk, zs[b], tick)[1], c, g16.curve.fr.num_bits)
            for b in self.share(len(zs))
        ])

    def prove_batch(self, circuits, rng: random.Random | None = None, rs=None,
                    deterministic: bool = False) -> list[Proof]:
        """Synthesize each witness of this rank's share on the host, prove
        them on the device, assemble (A, B, C) per proof on the host; with
        a mesh, gather every rank's proofs.

        Like Groth16.prove, refuses to emit r = s = 0 proofs (no
        zero-knowledge) silently: pass `rng`, explicit `rs` pairs (one per
        circuit), or opt in with `deterministic=True`. With an rng, each
        proof's (r, s) is drawn in order, r first, for the whole batch."""
        g16, pk = self.g16, self.pk
        if self.lite:
            raise ValueError("a lite BatchProver computes the A and B MSMs alone; "
                             "prove_batch needs all five")
        if rng is None and rs is None and not deterministic:
            raise ValueError(
                "prove_batch() without rng or rs produces proofs with ZERO "
                "zero-knowledge; pass rng=secure_rng(), explicit rs pairs, "
                "or deterministic=True to opt in"
            )
        B = len(circuits)
        share = self.share(B)
        stage_ms = {}
        tick = _stage_clock(g16.device, stage_ms)
        m = pk.num_instance + pk.num_witness
        zs = [None] * B
        for b in share:
            zs[b] = synthesize_witness(circuits[b], g16.curve)
            if len(zs[b]) != m:
                raise ValueError(f"assignment has {len(zs[b])} values, the key {m}")
        if rs is None:
            fr = Fp(g16.curve.fr)
            rs = [(fr.rand(rng), fr.rand(rng)) if rng is not None else (0, 0) for _ in range(B)]
        if len(rs) != B:
            raise ValueError(f"{len(rs)} (r, s) pairs for {B} circuits")
        tick("synthesize")

        device_ms = {}
        out_g1, out_g2 = self.core(zs, _stage_clock(g16.device, device_ms))
        tick("device")

        n = len(share)
        L = limbs_of(g16.curve)
        g1 = limbs_to_points(out_g1.cpu().reshape(n * 4, 3, GROUPS["g1"], L), "g1", g16.curve)
        g2 = limbs_to_points(out_g2.cpu(), "g2", g16.curve)
        tick("readback")

        proofs = []
        for j, b in enumerate(share):
            a, b1, l_sum, h = g1[4 * j : 4 * j + 4]
            proofs.append(assemble_proof(g16, pk, a, g2[j], b1, l_sum, h, *rs[b]))
        tick("assemble")
        if self.mesh is not None:
            proofs = [p for part in self.mesh.all_gather_object(proofs, self.axis) for p in part]
            tick("gather")
        self.last_run = BatchRun(stage_ms, device_ms)
        return proofs


def batch_from_file(path: str, circuits, rs, shape: tuple[int, ...], axis_names: tuple[str, ...],
                    axis: str = "dp", device="cuda", h_core: bool = False) -> dict:
    """One rank's `BatchProver.prove_batch` of `circuits` at the (r, s)
    pairs `rs`, the batch split over `axis` of a mesh of the given shape,
    under the key saved at `path` (loaded on the rank's device). -> the
    whole batch's proofs, this rank's share, the stage times, the launch
    counts and the peak device memory (CUDA) of the batch, the backend; with
    `h_core`, this rank's share of the h digits (`BatchProver.h_core`, on
    the CPU)."""
    mesh = make_mesh(shape, axis_names, device)
    pk = ProvingKey.load(path, device=mesh.device)
    bp = BatchProver(Groth16(pk.vk.curve, device=mesh.device), pk, mesh, axis)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _native.reset_launches()
    proofs = bp.prove_batch(circuits, rs=rs)
    out = {
        "rank": dist.get_rank(), "coords": {k: int(v) for k, v in mesh.coords.items()},
        "backend": mesh.backend, "share": list(bp.share(len(circuits))), "proofs": proofs,
        "stage_ms": bp.last_run.stage_ms, "device_ms": bp.last_run.device_ms,
        "launches": {k: v for k, v in _native.LAUNCHES.items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated(mesh.device) if cuda else None,
        "sent_bytes": dict(mesh.sent_bytes),
    }
    if h_core:
        zs = [synthesize_witness(c, pk.vk.curve) if b in bp.share(len(circuits)) else None
              for b, c in enumerate(circuits)]
        out["h_core"] = bp.h_core(zs).cpu()
    return out
