"""Batched proving: many proofs of one circuit shape under one proving key.

The port's counterpart of the JAX package's `parallel/batch.py`
`BatchProver` on one device. Each proof's device core is the reference's
`_one_proof` with `_h_digits`:

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
beside the key. The reference's mesh, `lite` and `h_core` serve its
multichip dry run and are not part of this module.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

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


@dataclass
class BatchRun:
    """What the last batch left behind, in milliseconds of wall time, each
    interval ending in a device synchronise. `stage_ms`: "synthesize"
    (every witness, on the host), "device" (every proof's device core),
    "readback" (the batch's MSM results to the host, made affine) and
    "assemble". `device_ms`: the device stage split over the batch's
    proofs into "upload" (z encoded on the host and copied), "matvec",
    "h", "digits", "window_sums" (K1 and K2, five MSMs a proof) and
    "combine" (K18, five launches a proof)."""

    stage_ms: dict
    device_ms: dict


class BatchProver:
    """prove_batch(circuits) -> [Proof] under one ProvingKey, on the
    prover's device. Signed digits for all five MSMs, as the single
    prover."""

    def __init__(self, g16: Groth16, pk: ProvingKey):
        if pk.vk.curve is not g16.curve:
            raise ValueError(f"a {pk.vk.curve.name} key for a {g16.curve.name} prover")
        self.g16 = g16
        self.pk = pk
        self.last_run: BatchRun | None = None

    def _one_proof(self, z: list[int], out_g1: torch.Tensor, out_g2: torch.Tensor, tick) -> None:
        """The device core of one proof: the A, B1, L, H sums into out_g1
        (4, 3, 1, L) and the B sum into out_g2 (3, 2, L), projective."""
        g16 = self.g16
        z_std, h_std = g16.witness_h(self.pk, z, tick)
        terms = g16.msm_terms(self.pk, z_std, h_std)
        tick("digits")
        g1_rows = iter(out_g1)
        for _name, plan, tbl, digits in terms:
            sums = plan.window_sums(tbl, digits.contiguous())
            tick("window_sums")
            (out_g2 if plan.group == "g2" else next(g1_rows)).copy_(plan.combine(sums))
            tick("combine")

    def prove_batch(self, circuits, rng: random.Random | None = None, rs=None,
                    deterministic: bool = False) -> list[Proof]:
        """Synthesize each witness on the host, prove the batch on the
        device, assemble (A, B, C) per proof on the host.

        Like Groth16.prove, refuses to emit r = s = 0 proofs (no
        zero-knowledge) silently: pass `rng`, explicit `rs` pairs (one per
        circuit), or opt in with `deterministic=True`. With an rng, each
        proof's (r, s) is drawn in order after synthesis, r first."""
        g16, pk = self.g16, self.pk
        if rng is None and rs is None and not deterministic:
            raise ValueError(
                "prove_batch() without rng or rs produces proofs with ZERO "
                "zero-knowledge; pass rng=secure_rng(), explicit rs pairs, "
                "or deterministic=True to opt in"
            )
        stage_ms = {}
        tick = _stage_clock(g16.device, stage_ms)
        m = pk.num_instance + pk.num_witness
        zs = []
        for circuit in circuits:
            z = synthesize_witness(circuit, g16.curve)
            if len(z) != m:
                raise ValueError(f"assignment has {len(z)} values, the key {m}")
            zs.append(z)
        B = len(zs)
        if rs is None:
            fr = Fp(g16.curve.fr)
            rs = [(fr.rand(rng), fr.rand(rng)) if rng is not None else (0, 0) for _ in range(B)]
        if len(rs) != B:
            raise ValueError(f"{len(rs)} (r, s) pairs for {B} circuits")
        tick("synthesize")

        L = limbs_of(g16.curve)
        out_g1 = torch.empty((B, 4, 3, GROUPS["g1"], L), dtype=torch.int32, device=g16.device)
        out_g2 = torch.empty((B, 3, GROUPS["g2"], L), dtype=torch.int32, device=g16.device)
        device_ms = {}
        device_tick = _stage_clock(g16.device, device_ms)
        for i, z in enumerate(zs):
            self._one_proof(z, out_g1[i], out_g2[i], device_tick)
        tick("device")

        g1 = limbs_to_points(out_g1.cpu().reshape(B * 4, 3, GROUPS["g1"], L), "g1", g16.curve)
        g2 = limbs_to_points(out_g2.cpu(), "g2", g16.curve)
        tick("readback")

        proofs = []
        for i, (r, s) in enumerate(rs):
            a, b1, l_sum, h = g1[4 * i : 4 * i + 4]
            proofs.append(assemble_proof(g16, pk, a, g2[i], b1, l_sum, h, r, s))
        tick("assemble")
        self.last_run = BatchRun(stage_ms, device_ms)
        return proofs
