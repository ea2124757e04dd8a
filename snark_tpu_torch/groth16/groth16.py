"""Groth16 setup, prove and verify over BN254 and BLS12-381 on one CUDA
device.

Counterpart of the JAX package's `groth16/groth16.py`: `ProvingKey.save`
and `ProvingKey.load` write and read its npz files, `pk_to_bytes` and
`pk_from_bytes` its arkworks key bytes, `circuit_specific_setup` is its
setup (the device QAP on K4, the fixed-base walk on K1 and the affine
codec on K7; the same key from the same rng), `Groth16.prove` is its
`prove` (the witness synthesized on the host by the port's relations
layer), and `Groth16.prove_from_assignment` is `_prove_from_assignment`
on its plane branch. The reference takes that branch from m = 2048
variables and a legacy XLA path below; the port runs the plane path at
every size, and the proof is the same, since the five MSM sums are group
elements whatever path computes them:

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

import random
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..fields.host import Fp
from ..fields.limbs import fields_of
from ..fields.params import BLS12_381, BN254, CurveParams, get_curve
from ..ops.affine_codec import points_to_query, query_to_points
from ..ops.curve import pack_rows_u8, row_bytes, rows_to_points
from ..ops.curve_host import host_g1, host_g2
from ..ops.fixed_base import FixedBase
from ..ops.msm import pick_window_plane_signed, signed_digits
from ..ops.msm_plane import PlaneMsm
from ..ops.ntt import NttPlan, bit_reverse_indices, from_mont, to_mont
from ..relations import R1CS_PREDICATE_LABEL, OptimizationGoal, SynthesisMode, new_ref
from .pairing import get_pairing
from .qap import PaddedCsr, domain_size_for, matvec
from .qap_device import combine_uvw_device, evaluate_uvw_device, powers_device

PORTED_CURVES = (BN254, BLS12_381)
# the key's five query vectors in the arkworks key's order, and their
# groups: vector X has the u8 table X_tbl and the legacy query X_query
VECTORS = (("a", "g1"), ("b_g1", "g1"), ("b_g2", "g2"), ("h", "g1"), ("l", "g1"))
QUERY_NAMES = tuple(f"{stem}_query" for stem, _ in VECTORS)


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
    # the file the key was read from, and the legacy query arrays in it
    # (read when asked for)
    path: str | None = None
    file_queries: frozenset = frozenset()
    # legacy (N, 3, K·2L) uint32 query arrays held on the host, by name
    # (`QUERY_NAMES`), where the setup made them
    queries: dict = field(default_factory=dict)

    @staticmethod
    def load(path: str, device="cuda") -> "ProvingKey":
        """Read an npz written by `save` or by the JAX package's
        `ProvingKey.save`."""
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
                file_queries=frozenset(QUERY_NAMES).intersection(z.files),
            )

    def query_names(self) -> list[str]:
        """The legacy query arrays this key has: those it holds, or those
        in its file. Keys saved with SNARK_TPU_SETUP_QUERY=0 (the
        reference) or from a setup with want_query=False lack some."""
        return [name for name in QUERY_NAMES if name in self.queries or name in self.file_queries]

    def query(self, name: str) -> np.ndarray:
        """A legacy (N, 3, K·2L) uint32 query array."""
        if name not in QUERY_NAMES:
            raise KeyError(name)
        if name in self.queries:
            return self.queries[name]
        if name not in self.file_queries:
            raise ValueError(
                f"the key has no {name}: it was made without its query arrays"
                " (want_query=False, or the reference's SNARK_TPU_SETUP_QUERY=0);"
                " only the u8 row tables and the matrices are in it"
            )
        with np.load(self.path, allow_pickle=False) as z:
            return z[name]

    def save(self, path: str) -> None:
        """Write what the JAX package's `ProvingKey.save` writes, under the
        same names, dtypes and shapes (`np.savez_compressed`): the vk and
        beta_g1, delta_g1 in the arkworks byte layout, the query arrays the
        key has, the five u8 tables, the three matrices in the reference's
        CSR form, and the sizes."""
        from ..snark import serialize as ser

        curve = self.vk.curve
        mats = {}
        for name in ("mat_a", "mat_b", "mat_c"):
            mats[name + "_cols"], mats[name + "_coeffs"] = getattr(self, name).to_reference()
        np.savez_compressed(
            path,
            vk=np.frombuffer(ser.serialize_vk(self.vk), dtype=np.uint8),
            curve=curve.name,
            beta_g1=np.frombuffer(ser.serialize_g1(curve, self.beta_g1), dtype=np.uint8),
            delta_g1=np.frombuffer(ser.serialize_g1(curve, self.delta_g1), dtype=np.uint8),
            **{name: self.query(name) for name in self.query_names()},
            **{f"{stem}_tbl": getattr(self, f"{stem}_tbl").cpu().numpy() for stem, _ in VECTORS},
            **mats,
            sizes=np.asarray(
                [self.num_instance, self.num_witness, self.num_constraints, self.domain_size],
                dtype=np.int64,
            ),
        )


@dataclass
class SetupRun:
    """What the last setup left behind for inspection: stage wall times
    (milliseconds, each ending in a device synchronise) and the query
    vectors' scalars read back from the device QAP (canonical standard
    form): "a" (u), "b" (v), "h" (coefficient order) and "l"."""

    stage_ms: dict
    scalars: dict


def _stage_clock(device: torch.device, stage_ms: dict):
    """-> tick(label): the wall time since the last tick, ending in a
    device synchronise, added to stage_ms[label]."""
    t = [time.perf_counter()]

    def tick(label):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stage_ms[label] = stage_ms.get(label, 0.0) + (now - t[0]) * 1e3
        t[0] = now

    return tick


def synthesize_matrices(circuit, curve: CurveParams):
    """Setup-mode synthesis of a `ConstraintSynthesizer` over the curve's
    scalar field, as the reference's setup runs it
    (OptimizationGoal.Constraints, then finalize) -> (the R1CS matrices as
    `to_coo_arrays` gives them, the interner's values, the number of
    constraints, of instance variables and of variables)."""
    cs = new_ref(Fp(curve.fr))
    cs.set_optimization_goal(OptimizationGoal.Constraints)
    cs.set_mode(SynthesisMode.setup())
    circuit.generate_constraints(cs)
    cs.finalize()
    inner = cs.inner
    return (inner.to_coo_arrays(R1CS_PREDICATE_LABEL), list(inner.field_interner.values),
            inner.num_constraints(), inner.num_instance_variables, inner.num_variables())


def synthesize_witness(circuit, curve: CurveParams) -> list[int]:
    """Prove-mode synthesis, as the reference's prove runs it (no matrices,
    no LC assignments) -> the full assignment z (ONE, instance, witness)."""
    cs = new_ref(Fp(curve.fr))
    cs.set_mode(SynthesisMode.prove(construct_matrices=False, generate_lc_assignments=False))
    circuit.generate_constraints(cs)
    return cs.full_assignment()


def prove_randomness(curve: CurveParams, rng: random.Random | None, r: int | None,
                     s: int | None, deterministic: bool) -> tuple[int, int]:
    """(r, s) of a prove, as the reference's `prove` takes them: r, then s,
    drawn from rng where they are not given. Without an rng and without
    (r, s) the proof would have no zero knowledge (r = s = 0), so that
    raises unless the caller passes deterministic=True."""
    if rng is None and r is None and s is None and not deterministic:
        raise ValueError(
            "prove() without an rng (or explicit r/s) produces a proof "
            "with ZERO zero-knowledge; pass rng=secure_rng(), explicit "
            "r/s, or deterministic=True to opt in"
        )
    host_fr = Fp(curve.fr)
    if r is None:
        r = host_fr.rand(rng) if rng is not None else 0
    if s is None:
        s = host_fr.rand(rng) if rng is not None else 0
    return r, s


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
    (milliseconds, each ending in a device synchronise; `prove` adds the
    host synthesis of the witness as "synthesize"), the five MSM
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
        self.last_setup: SetupRun | None = None

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

    def witness_h(self, pk: ProvingKey, z: list[int], tick):
        """Stages 1-3 from the assignment z: the upload, the three matvecs
        (`witness_evals`) and h (`h_coefficients`). -> (z_std, h_std)"""
        z_std = self.fr.tensor(z, self.device, mont=False)
        tick("upload")
        a, b, c = self.witness_evals(pk, z_std)
        tick("matvec")
        h_std = self.h_coefficients(pk, a, b, c)
        tick("h")
        return z_std, h_std

    def msm_terms(self, pk: ProvingKey, z_std: torch.Tensor, h_std: torch.Tensor | None):
        """The five MSMs of a proof, the signed c-bit digits of z and h
        made: [(name, plan, table, digits)] for A, B (G2), B1, L (z past
        the instance) and H (left out when h_std is None)."""
        nbits = self.curve.fr.num_bits
        c = pick_window_plane_signed(z_std.shape[0])
        z_digits = signed_digits(z_std, c, nbits)
        g1, g2 = self.msm_plan(c, "g1"), self.msm_plan(c, "g2")
        ni = pk.num_instance
        terms = [
            ("A", g1, pk.a_tbl, z_digits),
            ("B", g2, pk.b_g2_tbl, z_digits),
            ("B1", g1, pk.b_g1_tbl, z_digits),
            ("L", g1, pk.l_tbl, z_digits[ni:]),
        ]
        if h_std is not None:
            terms.append(("H", g1, pk.h_tbl, signed_digits(h_std, c, nbits)))
        return terms

    def msm_sums(self, pk: ProvingKey, z_std: torch.Tensor, h_std: torch.Tensor, tick):
        """Stages 4-5: the five MSMs, each combined on the host -> (affine
        host points, whether each took the batch-affine tree)."""
        terms = self.msm_terms(pk, z_std, h_std)
        tick("digits")
        sums, affine = {}, {}
        for name, plan, tbl, digits in terms:
            host_curve = self.hg2 if plan.group == "g2" else self.hg1
            sums[name] = plan.msm_host(tbl, digits.contiguous(), host_curve)
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
        tick = _stage_clock(self.device, stage_ms)
        z_std, h_std = self.witness_h(pk, z, tick)
        sums, affine = self.msm_sums(pk, z_std, h_std, tick)
        proof = assemble_proof(
            self, pk, sums["A"], sums["B"], sums["B1"], sums["L"], sums["H"], r, s
        )
        tick("assemble")
        self.last_run = ProveRun(stage_ms, sums, h_std, affine)
        return proof

    def prove(self, pk: ProvingKey, circuit, rng: random.Random | None = None,
              r: int | None = None, s: int | None = None,
              deterministic: bool = False) -> Proof:
        """Synthesize the witness of a `ConstraintSynthesizer` and prove,
        as the reference's `prove`: r, then s, drawn from rng where they
        are not given. Without an rng and without (r, s) the proof would
        have no zero knowledge (r = s = 0), so that raises unless the
        caller passes deterministic=True. Synthesis runs with
        construct_matrices=False: the key already holds the matrices."""
        r, s = prove_randomness(self.curve, rng, r, s, deterministic)
        t0 = time.perf_counter()
        z = synthesize_witness(circuit, self.curve)
        synthesize_ms = (time.perf_counter() - t0) * 1e3
        proof = self.prove_from_assignment(pk, z, r, s)
        self.last_run.stage_ms = {"synthesize": synthesize_ms, **self.last_run.stage_ms}
        return proof

    # ----- setup ---------------------------------------------------------------
    def circuit_specific_setup(self, circuit, rng: random.Random, want_query: bool = True):
        """-> (ProvingKey, VerifyingKey) for any `ConstraintSynthesizer`,
        the reference's `circuit_specific_setup` with its key layout: the
        circuit synthesized in setup mode (`synthesize_matrices`); the
        toxic waste α, β, γ, δ, τ drawn in that order from rng as the
        reference draws them; u, v, w at τ by the device QAP (K4); the
        five query vectors through the fixed-base walk (K1) and the affine
        codec (K7):
        a_tbl from u, b_g1_tbl and b_g2_tbl from v, l_tbl from
        (βu + αv + w)/δ over the witness columns, h_tbl from τ^j·Z(τ)/δ
        for j < n − 1 in bit-reversed order (row k holds coefficient
        bitrev(k), the identity row where bitrev(k) = n − 1);
        gamma_abc_g1 from (βu + αv + w)/γ over the instance columns, and
        the vk, beta_g1, delta_g1 by host scalar multiplications. The
        matrices come from the synthesis's COO arrays. want_query=False is
        the reference's SNARK_TPU_SETUP_QUERY=0: the vectors of 2048 or
        more points then leave out their legacy query arrays."""
        fr, dev = self.fr, self.device
        p = self.curve.fr.modulus
        stage_ms = {}
        tick = _stage_clock(dev, stage_ms)
        coo, values, nc, ni, m = synthesize_matrices(circuit, self.curve)
        tick("synthesize")
        n = domain_size_for(nc, ni)
        host_fr = Fp(self.curve.fr)
        alpha, beta, gamma, delta, tau = (host_fr.rand(rng) for _ in range(5))
        gamma_inv, delta_inv = pow(gamma, -1, p), pow(delta, -1, p)
        fixed = {g: FixedBase(self.curve, g, dev) for g in ("g1", "g2")}
        for fb in fixed.values():
            fb.table  # noqa: B018  (built on the host once per curve and group)
        tick("tables")

        u, v, w, z_tau = evaluate_uvw_device(fr, coo, values, nc, ni, m, tau, dev)
        gabc_m, l_m = combine_uvw_device(fr, u, v, w, beta, alpha, gamma_inv, delta_inv, ni)
        h_m = powers_device(fr, tau, n - 1, dev, scale=z_tau * delta_inv % p)
        scalars = {name: from_mont(x, fr) for name, x in (("a", u), ("b", v), ("h", h_m),
                                                         ("l", l_m))}
        tick("qap")

        tables, queries = {}, {}
        for stem, group in VECTORS:
            P = fixed[group].points(scalars[stem[0]])  # "a", "b", "h", "l"
            tick(f"walk {stem}")
            tables[f"{stem}_tbl"], q = fixed[group].encode(P, want_query)
            if q is not None:
                queries[f"{stem}_query"] = q
            tick(f"codec {stem}")
        # h_tbl row k holds coefficient bitrev(k); coefficient n - 1 has no
        # point (row n - 1 of the padded rows: the identity)
        ident = torch.as_tensor(pack_rows_u8([None], "g1", self.curve), device=dev)
        rev = torch.as_tensor(bit_reverse_indices(n), device=dev)
        tables["h_tbl"] = torch.cat([tables["h_tbl"], ident])[rev]

        g1, g2 = self.hg1, self.hg2
        vk = VerifyingKey(
            curve=self.curve,
            alpha_g1=g1.scalar_mul(g1.generator, alpha),
            beta_g2=g2.scalar_mul(g2.generator, beta),
            gamma_g2=g2.scalar_mul(g2.generator, gamma),
            delta_g2=g2.scalar_mul(g2.generator, delta),
            gamma_abc_g1=[g1.scalar_mul(g1.generator, s) for s in fr.decode(gabc_m)],
        )
        mat_a, mat_b, mat_c = (PaddedCsr.from_coo(c, values, fr, nc, dev) for c in coo)
        pk = ProvingKey(
            vk=vk,
            beta_g1=g1.scalar_mul(g1.generator, beta),
            delta_g1=g1.scalar_mul(g1.generator, delta),
            **tables,
            mat_a=mat_a,
            mat_b=mat_b,
            mat_c=mat_c,
            num_instance=ni,
            num_witness=m - ni,
            num_constraints=nc,
            domain_size=n,
            queries=queries,
        )
        tick("vk")
        stage_ms["total"] = sum(stage_ms.values())
        self.last_setup = SetupRun(stage_ms, scalars)
        return pk, vk

    # the CircuitSpecificSetupSNARK::setup default
    setup = circuit_specific_setup

    # ----- the proving key's canonical bytes -----------------------------------
    def query_points(self, pk: ProvingKey) -> list[list]:
        """The five queries as host affine points, in the arkworks key's
        order (a, b_g1, b_g2, h, l): from the legacy query arrays where the
        key has them, else from the u8 rows (h in coefficient order)."""
        have = pk.query_names()
        rev = bit_reverse_indices(pk.domain_size)
        out = []
        for stem, group in VECTORS:
            if f"{stem}_query" in have:
                out.append(query_to_points(pk.query(f"{stem}_query"), group, self.curve))
                continue
            rows = getattr(pk, f"{stem}_tbl").cpu().numpy()
            if stem == "h":
                rows = rows[rev[: pk.domain_size - 1]]
            out.append(rows_to_points(rows, group, self.curve))
        return out

    def pk_to_bytes(self, pk: ProvingKey, compress: bool = True) -> bytes:
        """The arkworks ProvingKey bytes: vk ‖ beta_g1 ‖ delta_g1 ‖ the five
        affine query Vecs."""
        from ..snark import serialize as ser

        return ser.serialize_pk_points(pk.vk, pk.beta_g1, pk.delta_g1, *self.query_points(pk),
                                       compress)

    def pk_from_bytes(self, data: bytes, circuit, compress: bool = True) -> ProvingKey:
        """A ProvingKey on this prover's device from arkworks bytes. The
        bytes carry the points alone; the matrices come from the circuit,
        synthesized in setup mode as the setup does, and the queries are
        held as the legacy affine arrays (Z = 1), as the reference rebuilds
        them."""
        from ..snark import serialize as ser

        vk, beta_g1, delta_g1, pts = ser.deserialize_pk_points(data, self.curve, compress)
        coo, values, nc, ni, m = synthesize_matrices(circuit, self.curve)
        n = domain_size_for(nc, ni)
        if len(pts[3]) != n - 1 or len(pts[0]) != m:
            raise ValueError(f"the bytes hold {len(pts[0])} and {len(pts[3])} points, the"
                             f" circuit needs {m} and {n - 1}")
        rev = bit_reverse_indices(n)
        tables, queries = {}, {}
        for (stem, group), q in zip(VECTORS, pts):
            queries[f"{stem}_query"] = points_to_query(q, group, self.curve)
            rows = [q[j] if j < n - 1 else None for j in rev] if stem == "h" else q
            tables[f"{stem}_tbl"] = torch.as_tensor(pack_rows_u8(rows, group, self.curve),
                                                    device=self.device)
        mat_a, mat_b, mat_c = (PaddedCsr.from_coo(c, values, self.fr, nc, self.device)
                               for c in coo)
        return ProvingKey(
            vk=vk, beta_g1=beta_g1, delta_g1=delta_g1, **tables,
            mat_a=mat_a, mat_b=mat_b, mat_c=mat_c,
            num_instance=ni, num_witness=m - ni, num_constraints=nc, domain_size=n,
            queries=queries,
        )

    # ----- verify (host pairing) ---------------------------------------------
    def process_vk(self, vk: VerifyingKey) -> PreparedVerifyingKey:
        """Precompute the pairing terms (SNARK::process_vk)."""
        return PreparedVerifyingKey(
            vk=vk,
            alpha_beta=self.pairing.pairing(vk.alpha_g1, vk.beta_g2),
            gamma_g2_neg=self.hg2.neg(vk.gamma_g2),
            delta_g2_neg=self.hg2.neg(vk.delta_g2),
        )

    def verify_with_processed_vk(self, pvk: PreparedVerifyingKey, public_input: list[int],
                                 proof: Proof) -> bool:
        """public_input without the leading ONE. A public input of the wrong
        length raises ValueError; the reference asserts it, and `python -O`
        would drop that check."""
        vk = pvk.vk
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

    def verify(self, vk: VerifyingKey, public_input: list[int], proof: Proof) -> bool:
        """process_vk, then verify_with_processed_vk (the SNARK default)."""
        return self.verify_with_processed_vk(self.process_vk(vk), public_input, proof)
