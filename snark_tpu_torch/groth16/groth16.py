"""Groth16 prove and verify over BN254 and BLS12-381 on one CUDA device.

Counterpart of the JAX package's `groth16/groth16.py`: `ProvingKey.load`
reads the npz files that the JAX package's `ProvingKey.save` writes, and
`Groth16.prove_from_assignment` is `_prove_from_assignment` on its plane
branch. The reference takes that branch from m = 2048 variables and a
legacy XLA path below; the port runs the plane path at every size, and the
proof is the same, since the five MSM sums are group elements whatever
path computes them:

1. witness upload, Montgomery conversion (K4), three padded-CSR matvecs;
2. evaluation padding (instance rows on the A side, zeros);
3. h = (A·B − C)/Z_H on the coset (K3 passes of several stages, with
   K4's products inside them), bit-reversed order, canonical standard form;
4. signed c-bit window digits of z and h;
5. five bucket MSMs (K1 scan, K2 folds): A, B1, L, H in G1 and B in G2,
   each finished by a host Horner combine; with `affine_msm=True` the
   buckets of an MSM with at least 8 elements per bucket are accumulated
   by the batch-affine tree (K6-K8, `ops/msm_affine.py`) instead, as the
   reference does under SNARK_TPU_MSM_AFFINE=1;
6. `assemble_proof` on the host. `verify` pairs on the host.

Proofs follow the arkworks conventions (eprint 2016/260):
  A = α + Σ z_i u_i(τ) + r δ
  B = β + Σ z_i v_i(τ) + s δ
  C = (Σ_witness z_i (β u_i + α v_i + w_i) + h(τ) Z(τ)) / δ + s A + r B1 − r s δ
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..fields.limbs import fields_of
from ..fields.params import BLS12_381, BN254, CurveParams, get_curve
from ..ops.curve import row_bytes
from ..ops.curve_host import host_g1, host_g2
from ..ops.msm import pick_window_plane_signed, signed_digits
from ..ops.msm_plane import PlaneMsm
from ..ops.ntt import NttPlan, to_mont
from .pairing import get_pairing
from .qap import PaddedCsr, matvec

PORTED_CURVES = (BN254, BLS12_381)
QUERY_NAMES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def resolve_device(device) -> torch.device:
    """The port runs on CUDA unless the caller names the CPU; a CUDA device
    without a card is an error, never a quiet fall back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions")
    return dev


@dataclass
class VerifyingKey:
    curve: CurveParams
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list  # one affine G1 point per instance variable


@dataclass
class PreparedVerifyingKey:
    vk: VerifyingKey
    alpha_beta: Any
    gamma_g2_neg: tuple
    delta_g2_neg: tuple


@dataclass
class Proof:
    a: tuple  # G1 affine
    b: tuple  # G2 affine
    c: tuple  # G1 affine


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    # u8 row tables in the reference's layout (see ops/curve.py), on device
    a_tbl: torch.Tensor
    b_g1_tbl: torch.Tensor
    b_g2_tbl: torch.Tensor
    h_tbl: torch.Tensor  # bit-reversed coefficient order
    l_tbl: torch.Tensor
    mat_a: PaddedCsr
    mat_b: PaddedCsr
    mat_c: PaddedCsr
    num_instance: int
    num_witness: int
    num_constraints: int
    domain_size: int
    # the file, for the legacy projective query arrays (read when asked for)
    path: str | None = None

    @staticmethod
    def load(path: str, device="cuda") -> "ProvingKey":
        """Read an npz written by the JAX package's `ProvingKey.save`."""
        from ..snark import serialize as ser

        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            curve = get_curve(str(z["curve"]))
            if curve not in PORTED_CURVES:
                raise ValueError(f"no port for {curve.name} keys")
            vk = ser.deserialize_vk(z["vk"].tobytes(), curve)
            beta_g1, _ = ser.deserialize_g1(curve, z["beta_g1"].tobytes())
            delta_g1, _ = ser.deserialize_g1(curve, z["delta_g1"].tobytes())
            sizes = [int(v) for v in z["sizes"]]

            def tbl(name):
                rows = z[name]
                rb = row_bytes("g2" if name == "b_g2_tbl" else "g1", curve)
                if rows.shape[1:] != (rb,):
                    raise ValueError(f"{name}: rows of {rows.shape[1:]} bytes, want {rb}")
                return torch.as_tensor(rows, device=dev)

            def csr(prefix):
                return PaddedCsr.from_reference(
                    z[prefix + "_cols"], z[prefix + "_coeffs"], dev
                )

            return ProvingKey(
                vk=vk,
                beta_g1=beta_g1,
                delta_g1=delta_g1,
                a_tbl=tbl("a_tbl"),
                b_g1_tbl=tbl("b_g1_tbl"),
                b_g2_tbl=tbl("b_g2_tbl"),
                h_tbl=tbl("h_tbl"),
                l_tbl=tbl("l_tbl"),
                mat_a=csr("mat_a"),
                mat_b=csr("mat_b"),
                mat_c=csr("mat_c"),
                num_instance=sizes[0],
                num_witness=sizes[1],
                num_constraints=sizes[2],
                domain_size=sizes[3],
                path=path,
            )

    def query(self, name: str) -> np.ndarray:
        """A legacy (N, 3, K·16) query array. Keys saved with
        SNARK_TPU_SETUP_QUERY=0 lack some of them."""
        if name not in QUERY_NAMES:
            raise KeyError(name)
        with np.load(self.path, allow_pickle=False) as z:
            if name not in z.files:
                raise ValueError(
                    f"{self.path} has no {name}: the key was saved without its"
                    " query arrays (SNARK_TPU_SETUP_QUERY=0); only the u8 row"
                    " tables and the matrices are in the file"
                )
            return z[name]


def assemble_proof(g16, pk, A_sum, B_sum, B1_sum, L_sum, H_sum, r, s) -> Proof:
    """Host tail of the prover: fold the five MSM results into (A, B, C)."""
    g1, g2 = g16.hg1, g16.hg2
    p = g16.curve.fr.modulus
    vk = pk.vk
    A = g1.add(g1.add(vk.alpha_g1, A_sum), g1.scalar_mul(pk.delta_g1, r))
    B = g2.add(g2.add(vk.beta_g2, B_sum), g2.scalar_mul(vk.delta_g2, s))
    B1 = g1.add(g1.add(pk.beta_g1, B1_sum), g1.scalar_mul(pk.delta_g1, s))
    C = g1.add(L_sum, H_sum)
    C = g1.add(C, g1.scalar_mul(A, s))
    C = g1.add(C, g1.scalar_mul(B1, r))
    C = g1.add(C, g1.neg(g1.scalar_mul(pk.delta_g1, r * s % p)))
    return Proof(a=A, b=B, c=C)


@dataclass
class ProveRun:
    """What the last prove left behind for inspection: stage wall times
    (milliseconds, each ending in a device synchronise), the five MSM
    sums, h (canonical standard form, bit-reversed order) and, per MSM,
    whether the batch-affine tree accumulated its buckets."""

    stage_ms: dict
    sums: dict
    h_std: torch.Tensor
    affine: dict


class Groth16:
    """Groth16 over BN254 or BLS12-381 on one device (`"cuda"` by default).
    The MSMs accumulate their buckets with the scan, or with the
    batch-affine tree where it applies when `affine_msm` is set (off by
    default, as in the reference)."""

    def __init__(self, curve: CurveParams = BN254, device="cuda", affine_msm: bool = False):
        if curve not in PORTED_CURVES:
            raise ValueError(f"no port for {curve.name}")
        self.curve = curve
        self.fr = fields_of(curve)[0]
        self.device = resolve_device(device)
        self.affine_msm = affine_msm
        self.hg1 = host_g1(curve)
        self.hg2 = host_g2(curve)
        self.pairing = get_pairing(curve)
        self._ntt: dict[int, NttPlan] = {}
        self._msm: dict[tuple, PlaneMsm] = {}
        self.last_run: ProveRun | None = None

    def ntt_plan(self, n: int) -> NttPlan:
        if n not in self._ntt:
            self._ntt[n] = NttPlan(n, self.device, self.fr)
        return self._ntt[n]

    def msm_plan(self, c: int, group: str) -> PlaneMsm:
        key = (c, group)
        if key not in self._msm:
            self._msm[key] = PlaneMsm(
                c, self.curve.fr.num_bits, group, signed=True, affine=self.affine_msm,
                curve=self.curve,
            )
        return self._msm[key]

    # ----- the stages of the prover ------------------------------------------
    def witness_evals(self, pk: ProvingKey, z_std: torch.Tensor):
        """Stages 1-2: -> (a, b, c) Montgomery evaluations on the domain."""
        n, ni, nc = pk.domain_size, pk.num_instance, pk.num_constraints
        fr = self.fr
        z_mont = to_mont(z_std, fr)
        rows = [matvec(mat, z_mont, fr) for mat in (pk.mat_a, pk.mat_b, pk.mat_c)]
        zeros = torch.zeros((n - nc, fr.limbs), dtype=torch.int32, device=z_std.device)
        a = torch.cat([rows[0], z_mont[:ni], zeros[ni:]])
        b = torch.cat([rows[1], zeros])
        c = torch.cat([rows[2], zeros])
        return a, b, c

    def h_coefficients(self, pk: ProvingKey, a, b, c) -> torch.Tensor:
        """Stage 3: -> h, canonical standard form, bit-reversed order."""
        return self.ntt_plan(pk.domain_size).h_std(a, b, c)

    def msm_sums(self, pk: ProvingKey, z_std: torch.Tensor, h_std: torch.Tensor, tick):
        """Stages 4-5: the five MSMs -> (affine host points, whether each
        took the batch-affine tree)."""
        nbits = self.curve.fr.num_bits
        c = pick_window_plane_signed(z_std.shape[0])
        z_digits = signed_digits(z_std, c, nbits)
        h_digits = signed_digits(h_std, c, nbits)
        tick("digits")
        g1, g2 = self.msm_plan(c, "g1"), self.msm_plan(c, "g2")
        ni = pk.num_instance
        sums, affine = {}, {}
        for name, plan, tbl, digits, hc in (
            ("A", g1, pk.a_tbl, z_digits, self.hg1),
            ("B", g2, pk.b_g2_tbl, z_digits, self.hg2),
            ("B1", g1, pk.b_g1_tbl, z_digits, self.hg1),
            ("L", g1, pk.l_tbl, z_digits[ni:], self.hg1),
            ("H", g1, pk.h_tbl, h_digits, self.hg1),
        ):
            sums[name] = plan.msm_host(tbl, digits.contiguous(), hc)
            affine[name] = plan.uses_affine(digits.shape[0])
            tick(f"msm {name}")
        return sums, affine

    def prove_from_assignment(self, pk: ProvingKey, z: list[int], r: int, s: int) -> Proof:
        """Prove from the full assignment z (ONE first, instance, witness)
        with the given randomness (r, s)."""
        m = pk.num_instance + pk.num_witness
        if len(z) != m:
            raise ValueError(f"assignment has {len(z)} values, the key {m}")
        if pk.vk.curve is not self.curve:
            raise ValueError(f"a {pk.vk.curve.name} key for a {self.curve.name} prover")
        stage_ms = {}
        t = [time.perf_counter()]
        on_cuda = self.device.type == "cuda"

        def tick(label):
            if on_cuda:
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            stage_ms[label] = (now - t[0]) * 1e3
            t[0] = now

        z_std = self.fr.tensor(z, self.device, mont=False)
        tick("upload")
        a, b, c = self.witness_evals(pk, z_std)
        tick("matvec")
        h_std = self.h_coefficients(pk, a, b, c)
        tick("h")
        sums, affine = self.msm_sums(pk, z_std, h_std, tick)
        proof = assemble_proof(
            self, pk, sums["A"], sums["B"], sums["B1"], sums["L"], sums["H"], r, s
        )
        tick("assemble")
        self.last_run = ProveRun(stage_ms, sums, h_std, affine)
        return proof

    # ----- verify (host pairing) ---------------------------------------------
    def process_vk(self, vk: VerifyingKey) -> PreparedVerifyingKey:
        return PreparedVerifyingKey(
            vk=vk,
            alpha_beta=self.pairing.pairing(vk.alpha_g1, vk.beta_g2),
            gamma_g2_neg=self.hg2.neg(vk.gamma_g2),
            delta_g2_neg=self.hg2.neg(vk.delta_g2),
        )

    def verify(self, vk: VerifyingKey, public_input: list[int], proof: Proof) -> bool:
        """public_input without the leading ONE."""
        pvk = self.process_vk(vk)
        if len(public_input) != len(vk.gamma_abc_g1) - 1:
            raise ValueError("public input length does not match the key")
        g1 = self.hg1
        acc = vk.gamma_abc_g1[0]
        for x, pt in zip(public_input, vk.gamma_abc_g1[1:]):
            acc = g1.add(acc, g1.scalar_mul(pt, x % self.curve.fr.modulus))
        lhs = self.pairing.multi_pairing(
            [(proof.a, proof.b), (acc, pvk.gamma_g2_neg), (proof.c, pvk.delta_g2_neg)]
        )
        return lhs == pvk.alpha_beta
