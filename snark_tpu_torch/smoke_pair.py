"""Time two trees of the port on one card, in turns.

    python -m snark_tpu_torch.smoke_pair OTHER_TREE [PHASES]

Runs phases of `chip_smoke.py` from another checkout of the repository
(OTHER_TREE, say an unpacked `git archive` of the parent commit) and from
this one, each run a process of its own, in the order other, this, this,
other: both trees meet the same card, clocks and neighbours, and a drift
over the call shows as a difference between the two runs of one tree.
PHASES is a comma-separated subset of kernels, prove_full,
prove_full_affine, setup_full, prove_setup, msm_bench, kernels_bls,
prove_full_bls, prove_full_affine_bls, setup_full_bls, prove_setup_bls,
msm_bench_bls, bench_madd_parts, bench_reduce_parts, bench_bisect_mul
(default: all of them; prove_full_affine is the prove with
`affine_msm=True`; a tree whose chip_smoke.py has no setup phases skips
those). Each run builds its tree's kernels first (both trees' builds run
together before the first turn), calls that tree's own phase functions and
prints their JSON lines; this process tags every line with its tree and
turn and prints at the end one JSON line `{"pair": ...}`: for each kernel
row, ms in the four turns (K3's also a transform, the h pipeline and one
stage); the batch-affine tree's inverse times of the kernels lines; for
each msm_bench record, adds/s and its `stage_ms.combine`; each prove's
seconds and its `h` and `msm *` stages; the setups' stages; the K1 scans
of bench_madd_parts; the K16 and K17 bench lines' ms (`bench_line_ms`);
and, from each turn's build line, the registers, spill stores, static SASS
instructions and FRND count of every K12-K17 instance (`build`), with
`build_same`: whether an instance's registers and SASS opcode counts are
the same in both trees. Every number is measured on the card by the phase
that prints it. Exits non-zero if a run fails. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PHASES = ("kernels", "prove_full", "prove_full_affine", "setup_full", "prove_setup", "msm_bench",
          "kernels_bls", "prove_full_bls", "prove_full_affine_bls", "setup_full_bls",
          "prove_setup_bls", "msm_bench_bls", "bench_madd_parts", "bench_reduce_parts",
          "bench_bisect_mul")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in each tree with that tree's chip_smoke.py: the phase functions and
# their arguments are those both trees have. A tree from before the
# relations layer, whose MulChainCircuit writes its assignment by hand
# (`MulChainCircuit.assignment`), proves from that assignment; a later tree
# synthesizes the witness. The setups are MulChain(FULL_SEED) from
# random.Random(FULL_SEED) in either tree (not configuration 3). The
# hand-written branch goes once no tree that is still compared lacks
# synthesis.
RUNNER = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as S
from snark_tpu_torch import bench as B
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.models import MulChainCircuit

phases = set(sys.argv[1].split(","))
device = torch.device("cuda")
smi = S.nvidia_smi_line()


def line(name, t0, **info):
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3), **info}), flush=True)


t0 = time.time()
build = S.phase_build()
roofline = S.VPU_KERNELS + S.PARTS_KERNELS  # K12-K17: their instances' ptxas and SASS
line("build", t0, nvcc_seconds=build["nvcc_seconds"], nvidia_smi=smi,
     ptxas={k: v for k, v in build["ptxas"].items()
            if k.split("<")[0].removesuffix("_kernel") in roofline},
     sass={k: v for k, v in build["sass"].items()
           if k.split("<")[0].removesuffix("_kernel") in roofline}
     if isinstance(build["sass"], dict) else build["sass"])
by_hand = hasattr(MulChainCircuit, "assignment")
for curve, n_full, sfx in ((BN254, S.FULL_N, ""), (BLS12_381, S.FULL_N_BLS, "_bls")):
    circuit = MulChainCircuit(seed=S.FULL_SEED, n=n_full)
    if by_hand:
        z = circuit.assignment(curve.fr.modulus)
    else:
        from snark_tpu_torch.groth16 import synthesize_witness
        z = synthesize_witness(circuit, curve)
    pooled = {}
    if phases & {"kernels" + sfx, "prove_full" + sfx, "prove_full_affine" + sfx,
                 "msm_bench" + sfx}:
        key = S.SyntheticKey(n_full, seed=1, device=device, curve=curve)
        inputs = {g: B.make_inputs(S.BENCH_LOG_N[g], signed=True, c=S.BENCH_C, group=g,
                                   device=device, curve=curve) for g in ("g1", "g2")}
        if "kernels" + sfx in phases:
            t0 = time.time()
            rows = S.phase_kernels(key, key.fr.tensor(z, device, mont=False), device)
            torch.cuda.empty_cache()
            msm_rows, extra = S.phase_kernels_msm(inputs, device)
            line("kernels" + sfx, t0, kernels=rows + msm_rows, **extra)
        if "prove_full" + sfx in phases:
            t0 = time.time()
            info, _, _ = S.phase_prove_full(key, z, device)
            pooled = info["stage_ms"]
            line("prove_full" + sfx, t0, **info)
        if "prove_full_affine" + sfx in phases:
            t0 = time.time()
            info, _, _ = S.phase_prove_full(key, z, device, affine_msm=True)
            line("prove_full_affine" + sfx, t0, **info)
        if "msm_bench" + sfx in phases:
            t0 = time.time()
            info, _ = S.phase_msm_bench(inputs, smi, unsigned=not sfx)
            line("msm_bench" + sfx, t0, **info)
        del key, inputs
        torch.cuda.empty_cache()
    # the setup phases, in a tree whose chip_smoke.py has them
    if phases & {"setup_full" + sfx, "prove_setup" + sfx} and hasattr(S, "phase_setup_full"):
        t0 = time.time()
        info, pk, vk, _ = S.phase_setup_full(curve, n_full, device, smi)
        line("setup_full" + sfx, t0, **info)
        if "prove_setup" + sfx in phases:
            t0 = time.time()
            args = (pk, vk, curve, z, device) if by_hand else (pk, vk, curve, device)
            info = S.phase_prove_setup(*args, pooled, save_dir=None)
            line("prove_setup" + sfx, t0, **(info[0] if isinstance(info, tuple) else info))
        del pk, vk
        torch.cuda.empty_cache()
if "bench_madd_parts" in phases:
    t0 = time.time()
    info, rows = S.phase_bench_madd_parts(smi, device, build["sass"])
    line("bench_madd_parts", t0, kernels=rows, **info)
if "bench_reduce_parts" in phases:
    t0 = time.time()
    info, rows = S.phase_bench_reduce_parts(smi, device, build["sass"])
    line("bench_reduce_parts", t0, kernels=rows, **info)
if "bench_bisect_mul" in phases:
    t0 = time.time()
    info, rows = S.phase_bench_bisect_mul(smi, device)
    line("bench_bisect_mul", t0, kernels=rows, **info)
"""


def run_tree(tree: str, phases: str, tag: dict) -> list[dict]:
    """One run of RUNNER in `tree`: its JSON lines, each tagged."""
    proc = subprocess.run([sys.executable, "-c", RUNNER, phases], cwd=tree, capture_output=True,
                          text=True)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"smoke_pair: the run in {tree} failed ({proc.returncode})")
    out = []
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            rec = {**json.loads(text), **tag}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def build_both(trees: list[str]) -> None:
    """Both trees' kernels, built at once before the first turn."""
    code = "import sys; sys.path.insert(0, '.'); from snark_tpu_torch import _native; _native.build()"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=t) for t in trees]
    if any(p.wait() for p in procs):
        raise SystemExit("smoke_pair: a build failed")


def summary(runs: list[list[dict]]) -> dict:
    """The numbers to compare, each a list over the four turns."""
    out: dict = {"kernel_ms": {}, "affine_tree_ms": {}, "msm_adds_per_s": {},
                 "msm_combine_ms": {}, "prove_s": {}, "prove_stage_ms": {}, "k1_scan_ms": {},
                 "setup_stage_ms": {}, "bench_line_ms": {}, "build": {}}
    opcodes: dict = {}

    def put(table, name, turn, v):
        table.setdefault(name, [None] * len(runs))[turn] = v

    for turn, recs in enumerate(runs):
        for rec in recs:
            phase = rec.get("phase")
            for row in rec.get("kernels", []):
                put(out["kernel_ms"], row["name"], turn, row["ms"])
                for extra in ("transform_ms", "h_ms", "ntt_stage_ms"):  # K3's pass kernel
                    if extra in row:
                        put(out["kernel_ms"], f"{row['name']} {extra}", turn, row[extra])
            for key, v in rec.items():  # the kernels lines' batch-affine tree
                if key.startswith(("batch_inverse", "root_inverse", "k7_tree")):
                    put(out["affine_tree_ms"], key, turn, v["sum_ms"] if isinstance(v, dict) else v)
            if phase and phase.startswith(("prove_full", "prove_setup")):
                if "prove_seconds" in rec:
                    put(out["prove_s"], phase, turn, rec["prove_seconds"])
                for stage, ms in rec["stage_ms"].items():
                    if stage.startswith("msm") or stage == "h":
                        put(out["prove_stage_ms"], f"{phase} {stage}", turn, ms)
            if phase == "build" and "ptxas" in rec:
                sass = rec["sass"] if isinstance(rec["sass"], dict) else {}
                for name, p in rec["ptxas"].items():
                    ops = sass.get(name, {})
                    put(out["build"], name, turn, {
                        "registers": p.get("registers"), "spill_stores": p.get("spill_stores"),
                        "sass": sum(ops.values()) if ops else None,
                        "frnd": sum(n for op, n in ops.items() if op.startswith("FRND"))})
                    put(opcodes, name, turn, (p.get("registers"), ops))
            if phase in ("bench_reduce_parts", "bench_bisect_mul"):
                for line in rec["lines"]:
                    put(out["bench_line_ms"], line["kernel"], turn, line["ms"])
            if phase == "bench_madd_parts":
                for part, ms in rec["scan_ms"].items():
                    put(out["k1_scan_ms"], part, turn, ms)
                for line in rec["lines"]:
                    if line.get("ms") is not None:
                        put(out["k1_scan_ms"], f"call {line['line']}", turn, line["ms"])
            if "msm_bench" in rec:
                d = rec["msm_bench"]["detail"]
                name = f"{d['curve']} c{d['window_bits']} signed={d['signed_digits']} affine={d['affine']}"
                put(out["msm_adds_per_s"], name, turn, rec["msm_bench"]["value"])
                put(out["msm_combine_ms"], name, turn, d["stage_ms"]["combine"])
            if phase and phase.startswith("setup_full"):
                for stage, ms in rec["stage_ms"].items():
                    put(out["setup_stage_ms"], f"{phase} {stage}", turn, ms)
    # turn 0 is the other tree, turn 1 this one
    out["build_same"] = {name: turns[0] == turns[1] for name, turns in opcodes.items()}
    return out


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    phases = argv[2] if len(argv) > 2 else ",".join(PHASES)
    unknown = set(phases.split(",")) - set(PHASES)
    if unknown:
        raise SystemExit(f"smoke_pair: unknown phases {sorted(unknown)}")
    t0 = time.time()
    build_both([other, HERE])
    order = [("other", other), ("this", HERE), ("this", HERE), ("other", other)]
    runs = [run_tree(tree, phases, {"tree": name, "turn": turn})
            for turn, (name, tree) in enumerate(order)]
    print(json.dumps({"pair": {"order": [name for name, _ in order], "phases": phases,
                               "seconds": round(time.time() - t0, 1), **summary(runs)}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
