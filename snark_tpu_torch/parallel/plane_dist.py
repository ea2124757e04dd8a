"""Distributed proving over one axis of a mesh of ranks.

Counterpart of the JAX package's `parallel/plane_dist.py`. Where the
reference runs one program over a device mesh under `shard_map`, every rank
here is a process that holds its own shard on its own device, runs the
one-device kernels on it, and meets the other ranks of the axis only in
`Mesh.all_to_all` and `Mesh.all_gather` (`parallel/mesh.py`):

* `DistPlaneMsm`: the table's rows and their digits are split into
  contiguous row blocks, one a rank. Each rank sorts and scans its block
  into bucket accumulators (K1); where the axis size divides the window
  count W, the accumulators are exchanged by window block (all_to_all: a
  rank keeps W/ndev windows of every source), the sources summed (K2) and
  the block folded (`PlaneMsm.fold_block`, K2), and the W/ndev totals
  all-gathered; otherwise each rank folds all W windows of its block and
  the totals of every rank are gathered and summed (K2). Every rank ends
  with the (W, 3, K, L) window totals.
* `DistPlaneNtt`: the six-step transform of n = n1·n2 over rows of the
  natural-order vector: three all_to_all transposes around two batched
  local transforms (`ops/ntt.py` `ntt_rows`, K3) and the step-3 twiddle
  (K4), with the Groth16 h pipeline on top (coset scale, Hadamard step,
  unscale: K4).
* `DistPlaneProver`: the whole Groth16 prove. Each rank computes the
  matvec rows of its own block of the domain, so the h pipeline's input
  needs no exchange; h comes out in natural order, sharded like the
  natural-order H table; the five MSMs are `DistPlaneMsm`s; every rank
  combines the gathered totals on the host (Horner) and assembles the same
  proof.

`prove_from_file` is one rank's prove from a saved key, the worker that
`parallel/launch.py` `run_ranks` spawns for the dry run, the smoke and the
tests.
"""

from __future__ import annotations

import random
import time

import torch
import torch.distributed as dist

from .. import _native
from ..fields.limbs import FR, Field, fields_of
from ..fields.params import BN254, CurveParams, get_curve
from ..groth16.groth16 import (
    Groth16,
    Proof,
    ProvingKey,
    _stage_clock,
    assemble_proof,
    prove_randomness,
    synthesize_witness,
)
from ..groth16.qap import matvec
from ..ops.curve import GROUPS, masked_add, pack_rows_u8
from ..ops.msm import pick_window_plane_signed, signed_digits
from ..ops.msm_plane import PlaneMsm
from ..ops.ntt import _powers, bit_reverse_indices, field_ew, ntt_rows, to_mont
from .mesh import Mesh, local_mesh


def _no_tick(_label: str) -> None:
    pass


def _sum_points(parts: list[torch.Tensor], group: str, curve: CurveParams) -> torch.Tensor:
    """parts[0] + parts[1] + ... lane by lane (K2), in order."""
    acc = parts[0]
    every = torch.ones(acc.shape[0], dtype=torch.bool, device=acc.device)
    for p in parts[1:]:
        acc = masked_add(acc, p.contiguous(), every, group, curve)
    return acc


# ---------------------------------------------------------------------------
# distributed MSM
# ---------------------------------------------------------------------------


class DistPlaneMsm:
    """Row-sharded signed-digit bucket MSM over one mesh axis: each rank
    holds its contiguous block of the table's rows and of their digits."""

    def __init__(self, c: int, mesh: Mesh, axis: str, num_bits: int | None = None,
                 group: str = "g1", curve: CurveParams = BN254):
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.size(axis)
        self.plan = PlaneMsm(c, curve.fr.num_bits if num_bits is None else num_bits, group,
                             signed=True, curve=curve)
        self.block_path = self.plan.W % self.ndev == 0 and self.ndev > 1

    def shard_table(self, rows) -> torch.Tensor:
        """A whole (N, ...) array (numpy or tensor, N a multiple of the axis
        size) -> this rank's contiguous row block, on its device. Tables and
        digits are sharded alike."""
        n = rows.shape[0]
        if n % self.ndev:
            raise ValueError(f"{n} rows do not split over {self.ndev} ranks")
        per = n // self.ndev
        i = self.mesh.index(self.axis)
        return torch.as_tensor(rows[i * per : (i + 1) * per]).to(self.mesh.device)

    def window_sums(self, table: torch.Tensor, digits: torch.Tensor, tick=_no_tick):
        """This rank's rows (N/ndev, row_bytes) and their digits (N/ndev, W)
        -> the (W, 3, K, L) window totals of the whole MSM, on every rank.
        tick(label) ends the stages "accumulate", "exchange", "fold",
        "gather"."""
        plan, mesh, axis = self.plan, self.mesh, self.axis
        if not self.block_path:
            sums = plan.window_sums(table, digits)
            tick("accumulate")
            parts = mesh.all_gather(sums, axis)
            tick("gather")
            sums = _sum_points(parts, plan.group, plan.curve)
            tick("fold")
            return sums
        if digits.shape[1] != plan.W or table.shape[0] != digits.shape[0]:
            raise ValueError(f"table {tuple(table.shape)} and digits {tuple(digits.shape)}")
        acc = plan.accumulate(table, digits.t().contiguous())
        tick("accumulate")
        wpd = plan.W // self.ndev
        # source s's accumulators of this rank's windows, s in rank order
        ex = mesh.all_to_all(acc, axis).view(self.ndev, wpd * plan.nb, *acc.shape[1:])
        tick("exchange")
        acc = _sum_points(list(ex), plan.group, plan.curve)
        totals = plan.fold_block(acc, mesh.index(axis) * wpd, wpd)
        tick("fold")
        sums = torch.cat(mesh.all_gather(totals, axis))
        tick("gather")
        return sums

    def combine_host(self, sums: torch.Tensor, host_curve):
        """Host Horner combine of the gathered totals -> affine point."""
        return self.plan.combine_host(sums, host_curve)

    def msm_host(self, table: torch.Tensor, digits: torch.Tensor, host_curve):
        return self.combine_host(self.window_sums(table, digits), host_curve)


# ---------------------------------------------------------------------------
# distributed NTT: six steps
# ---------------------------------------------------------------------------


class DistPlaneNtt:
    """Six-step NTT of n = n1·n2 over a scalar field, both n1 and n2
    multiples of the axis size. A shard is this rank's contiguous block of
    the natural-order vector (n/ndev, L), Montgomery form: the input viewed
    as (n2, n1) row-major and split by rows j2, the output viewed as
    (n1, n2) and split by rows k1. With x[j2·n1 + j1] and
    X[k1·n2 + k2] = Σ x[j]·ω^(jk), ω^(jk) = ω_n2^(j2·k2) · ω^(j1·k2) ·
    ω_n1^(j1·k1): a transpose, length-n2 transforms over j2, the twiddle
    T[j1, k2] = ω^(j1·k2) (this rank's rows j1 of it, held on its device
    alone), a transpose, length-n1 transforms over j1, a transpose."""

    def __init__(self, n1: int, n2: int, mesh: Mesh, axis: str, field: Field = FR):
        d = self.ndev = mesh.size(axis)
        if n1 % d or n2 % d:
            raise ValueError(f"n1 = {n1} and n2 = {n2} must both split over {d} ranks")
        self.n1, self.n2, self.n = n1, n2, n1 * n2
        self.mesh, self.axis, self.field = mesh, axis, field
        f, p, dev = field, field.p, mesh.device
        i = mesh.index(axis)
        params = f.params
        w = params.root_of_unity(self.n)
        w_inv = pow(w, -1, p)
        w1, w2 = pow(w, n2, p), pow(w, n1, p)  # the n1-th and n2-th roots
        tw = lambda root, m: f.tensor(_powers(root, m // 2, p), dev)  # noqa: E731
        # by inverse: False, True
        self.tw1 = (tw(w1, n1), tw(pow(w1, -1, p), n1))
        self.tw2 = (tw(w2, n2), tw(pow(w2, -1, p), n2))
        self.inv_m = {n1: f.const(pow(n1, -1, p), dev), n2: f.const(pow(n2, -1, p), dev)}
        rows = range(i * n1 // d, (i + 1) * n1 // d)
        self.twmat = tuple(
            f.tensor([v for j1 in rows for v in _powers(pow(root, j1, p), n2, p)], dev)
            for root in (w, w_inv)
        )
        # coset vectors of this rank's shard of the natural order
        nl = self.n // d
        g = params.generator
        g_inv = pow(g, -1, p)
        self.coset_scale = f.tensor(_powers(g, nl, p, pow(g, i * nl, p)), dev)
        unscale = _powers(g_inv, nl, p, pow(g_inv, i * nl, p))
        self.coset_unscale = f.tensor(unscale, dev)
        # x R · u · R^-1 = x u: the unscale by a standard-form table leaves
        # the canonical standard form
        self.coset_unscale_std = f.tensor(unscale, dev, mont=False)
        self.z_coset_inv = f.const(pow((pow(g, self.n, p) - 1) % p, -1, p), dev)

    def _transpose(self, x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
        """(rows/ndev · cols, L) lanes (r, c) row-major, split by rows ->
        (cols/ndev · rows, L) lanes (c, r), split by cols."""
        d, L = self.ndev, self.field.limbs
        x = x.view(rows // d, d, cols // d, L).transpose(0, 1)
        x = self.mesh.all_to_all(x, self.axis)  # (source, rows/d, cols/d, L)
        return x.view(rows, cols // d, L).transpose(0, 1).reshape(rows * cols // d, L)

    def _run(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        f, n1, n2 = self.field, self.n1, self.n2
        if x.shape != (self.n // self.ndev, f.limbs):
            raise ValueError(f"a shard is ({self.n // self.ndev}, {f.limbs}), got {tuple(x.shape)}")
        x = self._transpose(x, n2, n1)
        x = ntt_rows(x, n2, self.tw2[inverse], self.inv_m[n2] if inverse else None, f)
        x = field_ew("mul", x, self.twmat[inverse], field=f)
        x = self._transpose(x, n1, n2)
        x = ntt_rows(x, n1, self.tw1[inverse], self.inv_m[n1] if inverse else None, f)
        return self._transpose(x, n2, n1)

    def fft(self, x: torch.Tensor) -> torch.Tensor:
        """Natural-order coefficients -> natural-order evaluations."""
        return self._run(x, False)

    def ifft(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, True)

    def _h(self, a_ev, b_ev, c_ev, unscale: torch.Tensor) -> torch.Tensor:
        f = self.field

        def to_coset(x):
            return self.fft(field_ew("mul", self.ifft(x), self.coset_scale, field=f))

        h_ev = field_ew("hadamard", to_coset(a_ev), to_coset(b_ev), to_coset(c_ev),
                        self.z_coset_inv, field=f)
        return field_ew("mul", self.ifft(h_ev), unscale, field=f)

    def h_from_evals(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """Shards of the domain evaluations of A·z, B·z, C·z (Montgomery) ->
        this rank's shard of h = (A·B − C)/Z_H in natural coefficient
        order, Montgomery form."""
        return self._h(a_ev, b_ev, c_ev, self.coset_unscale)

    def h_std(self, a_ev, b_ev, c_ev) -> torch.Tensor:
        """As `h_from_evals`, in canonical standard form: what the prover
        takes."""
        return self._h(a_ev, b_ev, c_ev, self.coset_unscale_std)


# ---------------------------------------------------------------------------
# the distributed prover
# ---------------------------------------------------------------------------


class DistPlaneProver:
    """Groth16 prove with the matvec, the h pipeline and the five MSMs
    distributed over one mesh axis; `g16` is a prover on this rank's
    device. The key may sit on the CPU (`ProvingKey.load(path, "cpu")`):
    each rank moves only its row blocks to its device.

    Stage map:
      matvec     the CSR rows of this rank's block of the domain (z on every rank)
      h          DistPlaneNtt's six steps, 7 transforms of 3 all_to_all each
      five MSMs  DistPlaneMsm over identity-padded row blocks of the tables
      assembly   the host: Horner of the gathered totals, `assemble_proof`
    """

    def __init__(self, g16: Groth16, pk: ProvingKey, mesh: Mesh, axis: str = "tp",
                 c: int | None = None):
        if g16.device != mesh.device:
            raise ValueError(f"the prover is on {g16.device}, the rank on {mesh.device}")
        if pk.vk.curve is not g16.curve:
            raise ValueError(f"a {pk.vk.curve.name} key for a {g16.curve.name} prover")
        self.g16, self.pk, self.mesh, self.axis = g16, pk, mesh, axis
        d = self.ndev = mesh.size(axis)
        i = mesh.index(axis)
        curve, dev = g16.curve, mesh.device
        self.m = pk.num_instance + pk.num_witness
        self.c = pick_window_plane_signed(self.m) if c is None else c
        n = pk.domain_size
        if n % d:
            raise ValueError(f"domain {n} does not split over {d} ranks")
        # six-step split: n1·n2 = n, both multiples of d, near-square
        n1 = 1 << ((n.bit_length() - 1) // 2)
        while n1 % d or (n // n1) % d:
            n1 *= 2
        if n1 >= n:
            raise ValueError(f"domain {n} is too small for {d} ranks")
        self.dntt = DistPlaneNtt(n1, n // n1, mesh, axis, g16.fr)
        self.msm = {g: DistPlaneMsm(self.c, mesh, axis, group=g, curve=curve) for g in GROUPS}
        self.W = self.msm["g1"].plan.W

        def block(tbl, group):  # rows [i·per, (i + 1)·per), identity rows past the end
            per = -(-tbl.shape[0] // d)
            rows = tbl[i * per : (i + 1) * per].to(dev)
            pad = torch.as_tensor(pack_rows_u8([None] * (per - rows.shape[0]), group, curve),
                                  device=dev)
            return torch.cat([rows, pad]), per

        self.a_tbl, self.per_z = block(pk.a_tbl, "g1")
        self.b1_tbl, _ = block(pk.b_g1_tbl, "g1")
        self.b2_tbl, _ = block(pk.b_g2_tbl, "g2")
        self.l_tbl, self.per_l = block(pk.l_tbl, "g1")
        # natural-order H rows of this rank's block: the key's row k holds
        # coefficient bitrev(k) (coefficient n − 1 the identity row)
        nl = n // d
        self.lo, self.hi = i * nl, (i + 1) * nl
        rev = torch.as_tensor(bit_reverse_indices(n)[self.lo : self.hi], device=pk.h_tbl.device)
        self.h_tbl = pk.h_tbl[rev].to(dev)
        nc = pk.num_constraints
        self.mats = (
            None if self.lo >= nc
            else [mat.row_block(self.lo, min(self.hi, nc), dev) for mat in (pk.mat_a, pk.mat_b,
                                                                            pk.mat_c)]
        )
        self.last_run: dict | None = None

    def witness_evals(self, z_mont: torch.Tensor):
        """-> (a, b, c): this rank's shards of the domain evaluations. Rows
        past num_constraints hold the instance (in A) or zeros."""
        pk, fr = self.pk, self.g16.fr
        nc, ni, lo, hi = pk.num_constraints, pk.num_instance, self.lo, self.hi
        rows = [matvec(mat, z_mont, fr) for mat in self.mats] if self.mats else [None] * 3
        a0, a1 = max(lo, nc), min(hi, nc + ni)
        out = []
        for k, part in enumerate(rows):
            parts = [] if part is None else [part]
            if k == 0 and a0 < a1:
                parts.append(z_mont[a0 - nc : a1 - nc])
            done = sum(t.shape[0] for t in parts)
            parts.append(torch.zeros((hi - lo - done, fr.limbs), dtype=torch.int32,
                                     device=z_mont.device))
            out.append(torch.cat(parts))
        return out

    def _digits(self, std: torch.Tensor, per: int) -> torch.Tensor:
        """Signed digits of this rank's block of `per` rows of std (zero
        rows past its end)."""
        i = self.mesh.index(self.axis)
        rows = std[i * per : (i + 1) * per]
        pad = torch.zeros((per - rows.shape[0], std.shape[1]), dtype=std.dtype, device=std.device)
        return signed_digits(torch.cat([rows, pad]), self.c, self.g16.curve.fr.num_bits)

    def prove(self, circuit, rng: random.Random | None = None, r: int | None = None,
              s: int | None = None, deterministic: bool = False) -> Proof:
        """Synthesize the witness (on every rank) and prove, r and s as
        `Groth16.prove` draws them; every rank returns the same proof.
        `last_run` keeps the stage times (milliseconds, each ending in a
        device synchronise) and the bytes this rank sent in each kind of
        collective."""
        g16, pk, mesh = self.g16, self.pk, self.mesh
        r, s = prove_randomness(g16.curve, rng, r, s, deterministic)
        stage_ms = {}
        sent0 = dict(mesh.sent_bytes)
        tick = _stage_clock(mesh.device, stage_ms)
        z = synthesize_witness(circuit, g16.curve)
        if len(z) != self.m:
            raise ValueError(f"assignment has {len(z)} values, the key {self.m}")
        tick("synthesize")
        fr = g16.fr
        z_std = fr.tensor(z, mesh.device, mont=False)
        tick("upload")
        a, b, c = self.witness_evals(to_mont(z_std, fr))
        tick("matvec")
        h = self.dntt.h_std(a, b, c)
        tick("h")
        zd = self._digits(z_std, self.per_z)
        ld = self._digits(z_std[pk.num_instance :], self.per_l)
        hd = signed_digits(h, self.c, g16.curve.fr.num_bits)
        tick("digits")
        g1, g2 = self.msm["g1"], self.msm["g2"]
        terms = (("A", g1, self.a_tbl, zd), ("B", g2, self.b2_tbl, zd),
                 ("B1", g1, self.b1_tbl, zd), ("L", g1, self.l_tbl, ld),
                 ("H", g1, self.h_tbl, hd))
        sums = {name: msm.window_sums(tbl, digits, tick) for name, msm, tbl, digits in terms}
        pts = {name: msm.combine_host(sums[name], g16.hg2 if msm is g2 else g16.hg1)
               for name, msm, _, _ in terms}
        tick("combine")
        proof = assemble_proof(g16, pk, pts["A"], pts["B"], pts["B1"], pts["L"], pts["H"], r, s)
        tick("assemble")
        self.last_run = {"stage_ms": stage_ms,
                         "sent_bytes": {k: v - sent0[k] for k, v in mesh.sent_bytes.items()}}
        return proof


def prove_from_file(path: str, circuit, device="cuda", axis: str = "tp", seed: int | None = None,
                    r: int | None = None, s: int | None = None, warm: bool = False) -> dict:
    """One rank's distributed prove of `circuit` from the key saved at
    `path` (loaded on the CPU, each rank moving its blocks to its device),
    on a 1-D mesh over the world; (r, s) drawn from random.Random(seed) or
    given. With `warm`, a first prove runs untimed. -> the proof, the timed
    prove's stage times and bytes sent, the launch counts of the timed
    prove, the peak device memory (CUDA), the backend and the rank."""
    t0 = time.perf_counter()
    mesh = local_mesh(axis, device=device)
    pk = ProvingKey.load(path, device="cpu")
    load_ms = (time.perf_counter() - t0) * 1e3
    g16 = Groth16(pk.vk.curve, device=mesh.device)
    t0 = time.perf_counter()
    prover = DistPlaneProver(g16, pk, mesh, axis)
    init_ms = (time.perf_counter() - t0) * 1e3

    def run():
        return prover.prove(circuit, None if seed is None else random.Random(seed), r, s)

    if warm:
        run()
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _native.reset_launches()
    proof = run()
    return {
        "rank": dist.get_rank(), "ranks": mesh.size(axis), "backend": mesh.backend,
        "device": str(mesh.device), "proof": proof, "n1": prover.dntt.n1, "n2": prover.dntt.n2,
        "c": prover.c, "block_path": prover.msm["g1"].block_path,
        "load_ms": load_ms, "init_ms": init_ms, **prover.last_run,
        "launches": {k: v for k, v in _native.LAUNCHES.items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated(mesh.device) if cuda else None,
    }


def dist_window_sums(rows, digits, c: int, group: str = "g1", curve: str = "bn254",
                     device="cuda", axis: str = "tp"):
    """One rank's part of a `DistPlaneMsm` over a 1-D mesh of the world,
    every rank given the whole (N, row_bytes) table and (N, W) signed
    digits -> (the (W, 3, K, L) window totals on the CPU, whether the
    block path ran)."""
    mesh = local_mesh(axis, device=device)
    dm = DistPlaneMsm(c, mesh, axis, group=group, curve=get_curve(curve))
    sums = dm.window_sums(dm.shard_table(rows), dm.shard_table(digits))
    return sums.cpu(), dm.block_path


def dist_transforms(values: list, n1: int, n2: int, curve: str = "bn254", device="cuda",
                    axis: str = "sp") -> dict:
    """One rank's part of `DistPlaneNtt` over a 1-D mesh of the world, every
    rank given three whole vectors of n1·n2 field values (a, b, c) ->
    this rank's shards (CPU, Montgomery form but "h_std") of fft(a),
    ifft(fft(a)), h_from_evals(a, b, c) and h_std(a, b, c)."""
    mesh = local_mesh(axis, device=device)
    f = fields_of(get_curve(curve))[0]
    dn = DistPlaneNtt(n1, n2, mesh, axis, f)
    nl = dn.n // dn.ndev
    i = mesh.index(axis)
    a, b, c = (f.tensor(v[i * nl : (i + 1) * nl], mesh.device) for v in values)
    ev = dn.fft(a)
    return {"fft": ev.cpu(), "ifft": dn.ifft(ev).cpu(), "h": dn.h_from_evals(a, b, c).cpu(),
            "h_std": dn.h_std(a, b, c).cpu()}
