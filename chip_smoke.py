#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`snark_tpu_torch`) on one card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds as it ends:

0. device: the card's name; `nvidia-smi` name and power limit.
1. build: one nvcc process per source, all at once, that build every
   kernel (registers and spills per kernel and per called function, from
   ptxas); the static SASS opcodes of K12-K17 and of every instance of K1,
   K2, K6 and K8 (`cuobjdump -sass`, where the toolkit has it), and for K1, K2
   and the called product (`mont_mul_call`) a summary: registers, spill
   stores, instructions, carry adds beside multiply-adds (`curve_kernels`).
1b. synthesis: the relations layer on the host. The LC engine's g++ build
   (`relations/native.py`, into `_build/lc_engine-<hash>/`) and its
   seconds; a symbolic-LC chain of SYNTH_CHAIN_LCS LCs finalized through
   the native engine and through the Python pass, whose LC stores and
   `to_coo_arrays` must be equal, with both times (and the engine's
   finalize split into its inline and outline stages); the host time of
   synthesizing MulChain(7, 2^20 − 64) over BLS12-381 Fr in setup mode
   (finalize and the COO arrays included) and in prove mode.
   setup: the synthetic key of prove_full (its matrices and full
   assignment from the port's synthesis of the circuit) and the MSM
   bench's inputs.
2. kernels: K1-K4 against their plain PyTorch versions on the card, at the
   shapes of the 2^18 prove below, and K18 (`horner_combine`, the whole
   Horner combine in one launch), K5 (`point_double`), K2 without a mask
   (`point_add`), K6-K8 (the batch-affine tree) at the shapes of the MSM
   bench below (K18 on the bench MSM's 20 window totals at c = 13 and on
   the edge totals of `ops/curve.py` horner_cases; K5 and K2 on one lane,
   and as the Horner chain K18 replaced, which must equal K18: no path
   runs them any more, so their rows report 0 launches on the main path,
   `on_path` false and that chain's counts as `chain_launches`; level 0 of
   the affine tree at 2^20 points for G1, 2^18 for G2: K6's and K8's rows
   add the level's pairs (`level0_pairs`) and their static SASS opcodes
   (`sass_ops`: LDG, STG, LDS, STS, LDGSTS, IMAD); the level's batch
   inverse is K19 (`affine_batch_inverse`: three launches a call, no other
   kernel, equal to its plain version at the level's width and at the
   edges of its indexing, den·dinv = 1; its row adds `bound_with_root_ms`,
   the bound plus the root inverse's latency, and the ptxas of its three
   kernels), and the line adds the former batch inverse, K7 over the
   level's whole product tree (`k7_tree`: each launch between two CUDA
   events, summed by level and in all, the root inverse, the whole tree;
   it must equal K19's dinv) beside the batch inverse's host and device
   times), exact equality;
   K18's row adds its launches in one whole MSM (K18 once, K5 and K2
   unmasked never) and its latency bound (`latency_bound_ms`,
   `horner_bound_ms`, on the product latency K18's latency probe measures
   on the card, `chain_latency`); each kernel's
   time (CUDA events, warmed up), its plain version's time and its bound;
   the kernel line adds each kernel's ptxas registers and spills. K3 is the
   pass kernel (`ntt_pass`, k stages a launch): every pass of the plan's
   split, DIT and DIF, with and without the Hadamard prologue and the scale
   epilogue, equal to the plain passes, the fused h (`NttPlan.h_std`) equal
   to the unfused plain pipeline (`h_plain`); its row's ms and bound are a
   pass's (the mean over a transform), bound by operations with the bytes
   bound beside it, and it adds each pass's time, a transform's and the h
   pipeline's (CUDA events over 10 runs) and one stage's (`ntt_stage`), and
   the ptxas of the DIF instance (`ptxas_dif`). In BN254 it also holds K3
   as the six-step NTT's batched row transforms (`ops/ntt.py` `ntt_rows`:
   rows bit-reversed, then stages [0, log m) over the whole shard with
   tw_log = log m − 1) against `ntt_rows_plain` (the same passes through
   `ntt_pass_plain`), forward and inverse with its 1/m scale, at the
   shards dist_prove and config4 give it (2^18 elements at one rank and
   2^17 at two, m = 512) and the dry run's (2^9 at two, m = 32): the row's
   `ntt_rows`, each with its time and the plain version's. The same
   phase holds K9 and K10 (the standalone 16-bit-limb products) at 2^20
   elements of BN254 Fr, the shape of bench_field below, and K11 (the
   masked mixed add) in G1 and G2 at the lane count of the 2^18 prove's
   scan, Q decoded from the key's table rows. K11 has no caller in either
   package, so this phase is its path: the first steps of that scan run
   step by step through K11 (one launch a step, the launch count of its
   row) and must equal K1 over the same steps. K1, K2, K11 and K5 also
   run on operands made of edge limb patterns (0, 1, p − 1, all-ones
   limbs; rows whose components run up to R − 1) at EDGE_LANES lanes, in
   G1 and G2, equal to their plain versions exactly (`edge_operands` of
   the K1, K2 and K11 rows).
3. prove_fixture: proves the committed MulChain(4, 1023) key
   (`tests/vectors/torch_pk_bn254_mulchain1023.npz`) at its committed
   (r, s) through `prove(pk, circuit, r, s)`, which synthesizes the
   witness; the proof must equal the JAX package's committed proof bit for
   bit and pass the host pairing check.
4. prove_full: MulChain(seed=4, n = 2^18 − 64) (domain 2^18, m = 524162),
   proved through `prove(pk, circuit, r, s)` (its line adds the host
   synthesis, `synthesize_ms`),
   against a synthetic key made here from a seed: the MulChain matrices
   and tables that tile a pool of 64 distinct points. Every MSM sum is
   checked exactly against the host pool oracle, h against
   h(x)·Z_H(x) = a(x)·b(x) − c(x) at a random x, and the proof against
   `assemble_proof` on the oracle sums; the h stage must have launched K3
   seven times a transform's passes. Launch counts of this prove go into
   the kernel line for K1-K4.
5. prove_full_affine: the same prove with `affine_msm=True`; its proof must
   equal prove_full's. The synthetic key has no setup behind it, so its
   proofs cannot pass the pairing check: the fixture is proved again with
   `affine_msm=True`, must equal the JAX proof and must verify.
5b. setup_full: the Groth16 setup of MulChain(FULL_SEED, FULL_N) on the
   card, `circuit_specific_setup(circuit, random.Random(FULL_SEED))` with
   want_query=False: the circuit's synthesis (`synthesize_ms`), the device QAP
   (K4), each query's fixed-base walk (one K1 launch) and affine codec (K19
   batch inverse, K7 products). Its line: stage wall times (the generator
   tables on the host, the QAP, each query's walk and codec, the vk,
   total), peak device memory (also less what the smoke held before the
   setup), the launches (K1's, K4's, K7's and K19's go into
   the kernel line as `setup_launches`). Checks: SETUP_SAMPLES rows of
   each table, decoded, equal the host scalar multiplication of the
   generator by that row's scalar, read back from the device QAP and
   equal to the host formula on the replayed toxic waste (`MulChainQap`);
   gamma_abc likewise; a_tbl's identity rows are where u = 0, h_tbl's one
   identity row where bitrev(k) = n − 1; WALK_CHECK_LANES lanes of
   a_tbl's walk (live lanes, 64 identity lanes among them) through K1
   equal its plain version on the card.
5c. prove_setup: `prove(pk, circuit, random.Random(2024))` from that key
   passes the host pairing check; its stage times beside prove_full's
   (pooled tables); the key saved to a temporary directory and loaded on
   the card proves the same proof from the same rng.
5c'. dist_prove: the distributed prove (`parallel/plane_dist.py`
   `DistPlaneProver`, `prove_from_file`) of that circuit from the saved key,
   loaded by every rank on the CPU, at random.Random(2024), in a world of
   one rank (NCCL) and of two ranks (gloo, both on the one card, their
   exchanges staged through the host), spawned by `parallel/launch.py`
   `run_ranks`, each after a warm prove. Every rank's proof must equal
   prove_setup's and verify, and every rank must have launched K1-K4. Per
   rank: stage times (each ending in a synchronise; the window sums split
   into accumulate, exchange, fold, gather), the bytes sent by all_to_all
   and all_gather, peak device memory, K1-K4's launches (rank 0's go into
   the kernel line as `dist_launches` from the two-rank world and
   `dist_one_rank_launches` from the one-rank world).
5d. batch_config5: the reference's configuration 5 (`scripts/run_configs.py`
   config5, one-card mode) through `snark_tpu_torch.run_configs`: the key of
   MulChain(0, 2^18 − 64, batch=True) set up from random.Random(0), the
   (r, s) pairs drawn from random.Random(1) (a warm pair, then one a
   proof), a warm prove, then BATCH_PROOFS proves of MulChain(s, ...), each
   witness synthesized on a one-thread executor while the previous one is
   proved; then, after a warm batch of one, the same circuits and pairs
   through `BatchProver.prove_batch` (`run_configs.config5_batch`, the
   path of `--batch-prover`: each MSM's window sums, then its Horner
   combine on the card: one K18 launch). Every batch proof
   must equal the loop's, the first four must verify, K18 must have
   launched 5 a proof in the batch, and K1-K4 must have launched there.
   Its line: both modes' wall seconds and proofs/s, the batch's stage
   times (synthesize, device, readback, assemble) and its device stage's
   split (upload, matvec, h, digits, window sums, combine), peak device memory
   (also less what the smoke held before), the batch's launches (K18's go
   into the kernel line as `batch_launches`).
5d'. batch_dp: `BatchProver` with its batch split over "dp" of a (dp, tp)
   = (2, 1) mesh of two ranks on the card (gloo), over the first
   BATCH_DP_PROOFS circuits and (r, s) pairs of batch_config5 under its key
   (saved without its query arrays, loaded by each rank on the card): every
   rank returns every proof, each equal to the one-device batch's, and
   K18 launched 5 times a proof of its share (rank 0's counts go into the
   kernel line as `batch_dp_launches`).
5e. configs: configurations 1 and 2 through `snark_tpu_torch.run_configs`
   (2: BN254 2^16 − 64, setup from random.Random(0), warm prove
   random.Random(5), prove random.Random(1), verify with [7]); 2 must
   verify.
5f. config4: `run_configs` configuration 4 at 2^CONFIG4_LOG_N:
   `DistPlaneMsm.window_sums` and `DistPlaneNtt.fft` timed in a world of
   one rank (NCCL) and in a world of two (gloo), the results equal; its
   line.
5g. dryrun: `dryrun.dryrun_multichip(2, "cuda")` (log_n 10): the
   distributed prove of MulChain(5, 2^10 − 2) verifies on both ranks, then
   the dp-sharded h pipeline of a lite `BatchProver`.
5h. legacy_u32: the reference's legacy device API on the card (`ops/curve_u32.py`,
   `msm_u32.py`, `ntt_u32.py`, `groth16/qap.py` WitnessMapPlan), its path
   driven once between a reset and a
   read of the counts: CurveOps and G2CurveOps add (K2 `point_add`) and
   double (K5) at LEGACY_LANES lanes on both curves, scalar_mul_const; the
   legacy `msm` at 2^20 BN254 G1 points (c = 14) and 2^18 G2 (c = 12), the
   MSM bench's pool tiled (K2 `masked_add` bucket steps and suffix scans,
   one K18); FixedBasePlan (K2) on 2^12 scalars; NttPlan's four transforms
   at 2^10 and 2^20 (K3 through `ntt_rows`, K4); and the reference's
   small-circuit prove of MulChain(9, 1022) (m = 2046) on both curves
   composed from the legacy API (WitnessMapPlan h, five `msm_host_combine`s
   over the key's query arrays). Every kernel of LEGACY_GATE must have
   launched; the counts go
   into the kernel line as `legacy_launches` (K2, K3, K4, K5, K18). Then,
   outside the count: each output exact against its plain version on the
   card, the MSMs against the pool oracle, samples against the host, the
   small sums and h equal to the plane prove's, their proof verified;
   times (CUDA
   events); `sharded_msm` and `DistNttPlan` (`parallel/dist_msm.py`,
   `dist_ntt.py`) in a world of one rank (NCCL) and of two (gloo) equal to
   the pool oracle and the one-device legacy plan.
5i. config4_e2e, config4_shards: `snark_tpu_torch.config4_e2e` at 2^16
   (setup, cold and warm prove, verify; its stage lines, peak device
   memory, host RSS) and `snark_tpu_torch.config4_shards` at 2^20 over 8
   modelled cards (a 2^17-point shard MSM against the pool oracle, 128
   local rows of 1024 through `ntt_rows` against the plain version).
6. msm_bench: `snark_tpu_torch.bench` on BN254 G1 at 2^20 points, signed
   c = 13, with the scan and with the batch-affine tree; G2 at 2^18 both
   ways; G1 unsigned c = 12 with the scan; every result equal to the pool
   oracle. Launch counts of this phase go into the kernel line for K6-K8
   and K18.
7. setup_bls, kernels_bls: the BN254 data is freed, the synthetic
   BLS12-381 key of prove_full_bls and the BLS12-381 MSM bench's inputs
   are made, and the BLS12-381 instances of K1-K4 (K1 and K2 in G1 and G2
   over the 12-limb Fq, K3 and K4 over BLS12-381 Fr) are held against their
   plain versions at the shapes of that prove, those of K18, K5, K2
   without a mask and K6-K8 at the shapes of msm_bench_bls, and K9-K11 as in
   phase 2 (K9, K10 over BLS12-381 Fr; K11 at the 2^20 prove's 294,912
   lanes; the edge operands through the 12-limb product).
8. prove_fixture_bls: proves the committed BLS12-381 MulChain(7, 12) key
   (`tests/vectors/torch_pk_bls12_381_mulchain12.npz`, m = 26) at its
   committed (r, s); the proof must equal the JAX package's committed
   proof bit for bit and pass the host pairing check.
9. prove_full_bls: MulChain(seed=4, n = 2^20 − 64) over BLS12-381 (domain
   2^20, m = 2097026, the reference's configuration 3) against a synthetic
   BLS12-381 key made as prove_full's, with the same checks. Launch counts
   of this prove go into the kernel line for the BLS12-381 instances of
   K1-K4.
10. prove_full_bls_affine: the same prove with `affine_msm=True` (the
   reference's configuration 3 under SNARK_TPU_MSM_AFFINE=1), with the same
   checks; the affine tree must have engaged in all five MSMs and the proof
   must equal prove_full_bls's.
10b. setup_full_bls, prove_setup_bls: the synthetic BLS12-381 key freed,
   the reference's configuration 3 as `scripts/run_configs.py` runs it:
   MulChain(seed=7, n = 2^20 − 64, batch=True), `circuit_specific_setup`
   from random.Random(0) with the default want_query=True (the five legacy
   query arrays; their sampled rows must hold the tables' points, and the
   line gives their bytes), a warm `prove` from random.Random(5), the
   timed `prove` from random.Random(1), and `verify(vk, [7], proof)`; the
   checks of 5b on the replayed toxic waste, and no save round trip. Both
   lines carry `config: 3` and `synthesize_ms`.
11. msm_bench_bls: `snark_tpu_torch.bench` on BLS12-381 G1 at 2^20 points
   and G2 at 2^18, signed c = 13, with the scan and with the batch-affine
   tree, every result equal to the pool oracle. Launch counts of this
   phase go into the kernel line for the BLS12-381 instances of K6-K8 and
   K18.
12. bench_field: `snark_tpu_torch.bench_field.run` at 2^20 elements of
   BN254 Fr and of BLS12-381 Fr, all five lines (the torch `DeviceField`
   and `DeviceFieldF32` products, K10, K9, K4 mode 0), each line's ms per
   mul-batch, M muls/s and peak memory, every output equal to the host
   oracle. Its launch counts go into the kernel line for K9 and K10.
13. bench_vpu_peak: `snark_tpu_torch.bench_vpu_peak.run` at the script's
   shapes (R8 = 34 planes of BN254 Fq on 131,072 lanes; the madd line's
   81,920 lanes through K1), its five lines each checked against the plain
   version on the card and the host references. Its launch counts go into
   the kernel line for K12-K15 (K1's stays the prove's); then K12-K15 are
   held against their plain versions at the lines' shapes: K13 and K15
   exactly, K12 within rtol 1e-4, K14 within rtol 1e-5 at depth 4 and
   within rtol 1e-4 plus 8·2^-149 at the line's depth 8, where every
   value is subnormal (the row records the largest).
14. bench_reduce_parts: `snark_tpu_torch.bench_reduce_parts.run` at the
   script's shapes (the same planes; variants A, B, C at T = 512 and A, C
   at T = 2048, 8 deep), every line correct: equal to its plain version,
   A and C equal to each other, to K15's plain chain and to a·b^8 on the
   host, B's values mod R to the host recurrence. Its launch counts go into
   the kernel line for K16, one row a line, each held against its plain
   version exactly; K16 A's SASS must hold HMMA (its band products on the
   tensor cores), where the toolkit has cuobjdump. Each row carries its
   launch geometry (`ops/mul_parts.py` `launch_geometry` on this card's
   SMs; a grid that leaves an SM idle fails), its resident warps an SM
   (the runtime's occupancy), its instance's registers and spill stores
   (ptxas) and its static FRND count.
15. bench_bisect_mul: `snark_tpu_torch.bench_bisect_mul.run` at the
   script's shapes (T = 512, 8 deep), its six lines correct: equal to
   their plain versions bit for bit and to host references. Its launch
   counts go into the kernel line for K17, one row a kind, each held
   against its plain version exactly, with the same geometry, warps,
   registers and FRND count as phase 14's rows.
16. bench_madd_parts: K1's parts (nosub, halfmul, nodecode; BN254 G1) each
   held against its plain version on the card over the scan's first
   MIXED_SCAN_STEPS steps at the bench's 81,920 lanes, exactly, and against
   those steps run through the part's plain body on `scan_step_operands`;
   each part's whole `window_sums` against the plain pipeline on the CPU
   at 2^12 points (c = 8: c = 13's 81,920 lanes would hold the plain folds
   for most of a minute a part), exactly; then
   `snark_tpu_torch.bench_madd_parts.run` at 2^20 points, signed c = 13,
   `full` equal to the pool oracle. Its launch counts go into the kernel
   line, one row a part, with the time of each part's whole main scan
   beside the shipped K1's.

17. tools: the reference's remaining entry point, profilers, scripts and
   examples on the port. `snark_tpu_torch.entry` on the card (the prover's
   device core on the MulChain(5, 8) key): its five sums equal, as affine
   points, those of the same entry run on the CPU (the plain versions).
   Then each tool's `main` at a reduced size (TOOL_ARGS: profile_setup,
   profile_msm, profile_scan_parts, profile_affine_stages,
   profile_affine_front, profile_prover_msms, bench_affine_msm,
   bench_scan_overlap, bench_gather, bench_synth at 2^16, run_suite on one
   GPU test file, gen_vectors into a temporary directory, whose files
   must equal the committed `tests/vectors/*.json`) and the three examples
   (bench_synthesis at 2^14): one line a tool with its seconds, its exit
   code and its JSON records; any `correct`, `equal` or
   `g2_affine_correct` that is false, or a non-zero exit, fails the phase.

The last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed; any failure exits non-zero. No card: exit 1, no result.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_PK = os.path.join(HERE, "tests", "vectors", "torch_pk_bn254_mulchain1023.npz")
FIXTURE_PROOF = os.path.join(HERE, "tests", "vectors", "torch_proof_bn254_mulchain1023.json")
FIXTURE_PK_BLS = os.path.join(HERE, "tests", "vectors", "torch_pk_bls12_381_mulchain12.npz")
FIXTURE_PROOF_BLS = os.path.join(HERE, "tests", "vectors", "torch_proof_bls12_381_mulchain12.json")
FULL_N = (1 << 18) - 64  # constraints: domain 2^18, m = 524162
FULL_N_BLS = (1 << 20) - 64  # constraints: domain 2^20, m = 2097026
FULL_SEED = 4
POOL = 64
# H100 SXM peaks (published): 3.35e12 bytes/s of HBM; 32-bit integer
# multiply-adds at 64 per SM per clock (CUDA programming guide, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost = 1.6727e13 per second.
PEAK_BYTES = 3.35e12
PEAK_IMAD = 132 * 64 * 1.98e9
# K18's latency bound (horner_bound_ms) takes the latency of one product
# from the card: LATENCY_STEPS dependent steps of K18's latency probe
# (csrc/curve_kernels.cuh chain_latency_kernel) on one thread, timed with
# the SM clock, in each mode: the product's multiply-add pair, and the
# base field's product.
LATENCY_STEPS = 4096



# The multiply-adds each kernel's bound counts come from
# snark_tpu_torch/ops/curve.py: imad_per_mul (one CIOS product),
# imad_per_decode (one 16-bit row decode step) and op_imads (a curve
# operation, 3b by additions where it is small).
# K5 and K2 without a mask: the prove does not call them since K18 took
# over the combine; their rows report 0 launches on the main path and the
# legacy path's (legacy_u32) as `legacy_launches`, which must not be 0
OFF_PATH = ("point_double_", "point_add_")
MIXED_SCAN_STEPS = 4  # scan steps run through K11 in the kernels phases
EDGE_LANES, EDGE_STEPS = 4096, 8  # the kernels phases' edge-operand checks
BENCH_FIELD_LOG_N = 20
BENCH_LOG_N = {"g1": 20, "g2": 18}  # the msm_bench sizes
BENCH_C = 13
VPU_KERNELS = ("fma_chain", "sweep_chain", "conv_chain", "mont_mul_chain")
PARTS_KERNELS = ("reduce_parts_chain", "bisect_chain")
K1_BN254_G1 = "bucket_madd_rows_kernel<Fp<FqParams>"  # its instances: the body, 0-3
# the curve kernels and the called product whose SASS the build line counts
# (and K6 and K8, whose rows carry their memory and multiply-add opcodes)
SASS_CURVE_KERNELS = ("bucket_madd_rows", "masked_add", "mont_mul_call", "affine_phase1",
                      "affine_phase3")
SASS_ROW_OPS = ("LDG", "STG", "LDS", "STS", "LDGSTS", "IMAD")  # K6's and K8's rows
SETUP_SAMPLES = 64  # rows of each table the setup phases check on the host
WALK_CHECK_LANES = 4096  # lanes of a_tbl's walk held against K1's plain version (64 identity)
SETUP_KERNELS = ("bucket_madd_rows", "field_ew", "affine_tree_mul",
                 "affine_batch_inverse")  # K1, K4, K7, K19
SYNTH_CHAIN_LCS = 1 << 16  # LCs of the synthesis phase's chain
BATCH_LOG_N, BATCH_PROOFS = 18, 32  # configuration 5 in batch_config5
DIST_RANKS = (1, 2)  # dist_prove's worlds: NCCL at one rank, gloo at two on the one card
DIST_TIMEOUT_S = 300  # a world of ranks that takes longer is ended and fails its phase
BATCH_DP_MESH, BATCH_DP_PROOFS = (2, 1), 4  # batch_dp's (dp, tp) mesh and proofs
CONFIG4_LOG_N = 18
# (log2 of a rank's shard, row length m) that the distributed paths give
# `ntt_rows`: dist_prove and config4 at 2^18 on one rank and on two, the
# dry run at 2^10 on two
NTT_ROWS_SHAPES = ((18, 512), (17, 512), (9, 32))
# the legacy device API (phase legacy_u32): CurveOps lanes, the legacy MSM's
# log2 points a group (c = pick_window(n): 14 and 12), the NttPlan sizes,
# FixedBasePlan's scalars, the small-circuit composition's MulChain length
# (m = 2046, the largest below 2048 variables), and the worlds' MSM (log2
# points, c) and six-step NTT (n1, n2)
LEGACY_LANES = 1 << 12
LEGACY_MSM_LOG_N = {"g1": 20, "g2": 18}
LEGACY_NTT_LOG_N = (10, 20)
LEGACY_FIXED_BASE_N = 1 << 12
SMALL_N = 1022
LEGACY_DIST_MSM_LOG_N, LEGACY_DIST_C = 14, 8
LEGACY_DIST_NTT = (256, 256)
# the kernels the legacy path must launch; the kernel rows of these kernels
# carry its counts as `legacy_launches`
LEGACY_GATE = tuple(
    f"{k}{sfx}_{g}" for sfx in ("", "_bls12_381") for k in ("masked_add", "point_add", "point_double")
    for g in ("g1", "g2")) + ("horner_combine_g1", "horner_combine_g2", "ntt_pass", "field_ew",
                               "ntt_pass_bls12_381", "field_ew_bls12_381")
LEGACY_ROW_KERNELS = ("masked_add", "point_add", "point_double", "horner_combine", "ntt_pass",
                      "field_ew")
CONFIG4_E2E_LOG_N = 16
CONFIG4_SHARDS = (20, 8)  # log n, modelled cards
MADD_PARTS_CHECK = (12, 8)  # log n and c of bench_madd_parts' whole-pipeline check
SCRIPT_BODY_LINE = {"nosub": 73, "halfmul": 88, "nodecode": 98}  # scripts/bench_madd_parts.py


def phase_line(name: str, t0: float, **info) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3), **info}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of fn() on the card: one warm-up, then `reps`
    runs between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(imads: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = imads / PEAK_IMAD * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# the synthetic full-width key
# ---------------------------------------------------------------------------


class SyntheticKey:
    """A proving key for MulChain(FULL_SEED, n) over `curve` whose five
    tables tile pools of 64 distinct points, and whose vk points come from
    fixed scalars; its matrices and the full assignment `z` come from the
    port's synthesis of the circuit. It is not the output of a setup (its
    proofs do not verify); it feeds the prover's device path at full width
    with an exact host oracle."""

    def __init__(self, n_constraints: int, seed: int, device, curve=None):
        import numpy as np
        import torch

        from snark_tpu_torch.fields.limbs import fields_of
        from snark_tpu_torch.fields.params import BN254
        from snark_tpu_torch.groth16 import (
            ProvingKey,
            VerifyingKey,
            synthesize_matrices,
            synthesize_witness,
        )
        from snark_tpu_torch.groth16.qap import PaddedCsr, domain_size_for
        from snark_tpu_torch.models import MulChainCircuit
        from snark_tpu_torch.ops.curve import pack_rows_u8
        from snark_tpu_torch.ops.curve_host import host_g1, host_g2

        curve = curve or BN254
        self.curve = curve
        self.fr = fields_of(curve)[0]
        rng = random.Random(seed)
        r = curve.fr.modulus
        g1, g2 = host_g1(curve), host_g2(curve)
        self.g1, self.g2 = g1, g2
        self.circuit = MulChainCircuit(seed=FULL_SEED, n=n_constraints)
        coo, values, nc, ni, m = synthesize_matrices(self.circuit, curve)
        if any(not np.array_equal(indptr, np.arange(nc + 1)) for indptr, _, _ in coo):
            raise AssertionError("MulChain's matrices hold more than one entry a row")
        # the column of each row's one entry, in A, B and C
        self.cols = [col for _, col, _ in coo]
        self.z = synthesize_witness(self.circuit, curve)  # the full assignment
        nw = m - ni
        n = domain_size_for(n_constraints, ni)

        def pool(hc):
            return [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(POOL)]

        self.pools = {name: pool(g2 if name == "b_g2" else g1) for name in ("a", "b_g1", "b_g2", "h", "l")}

        def table(name, rows, identity_row=None):
            group = "g2" if name == "b_g2" else "g1"
            pts = pack_rows_u8(self.pools[name], group, curve)
            tiled = np.tile(pts, (-(-rows // POOL), 1))[:rows].copy()
            if identity_row is not None:
                tiled[identity_row] = pack_rows_u8([None], group, curve)[0]
            return torch.as_tensor(tiled, device=device)

        alpha, beta, gamma, delta = (rng.randrange(1, r) for _ in range(4))
        vk = VerifyingKey(
            curve=curve,
            alpha_g1=g1.scalar_mul(g1.generator, alpha),
            beta_g2=g2.scalar_mul(g2.generator, beta),
            gamma_g2=g2.scalar_mul(g2.generator, gamma),
            delta_g2=g2.scalar_mul(g2.generator, delta),
            gamma_abc_g1=[g1.scalar_mul(g1.generator, rng.randrange(1, r)) for _ in range(ni)],
        )
        mats = [PaddedCsr.from_coo(c, values, self.fr, nc, device) for c in coo]
        self.pk = ProvingKey(
            vk=vk,
            beta_g1=g1.scalar_mul(g1.generator, beta),
            delta_g1=g1.scalar_mul(g1.generator, delta),
            a_tbl=table("a", m),
            b_g1_tbl=table("b_g1", m),
            b_g2_tbl=table("b_g2", m),
            # row k is coefficient bitrev(k); coefficient n-1 (row n-1) has
            # no query point in a real key: the identity row
            h_tbl=table("h", n, identity_row=n - 1),
            l_tbl=table("l", nw),
            mat_a=mats[0],
            mat_b=mats[1],
            mat_c=mats[2],
            num_instance=ni,
            num_witness=nw,
            num_constraints=n_constraints,
            domain_size=n,
        )

    def table_bytes(self) -> int:
        pk = self.pk
        return sum(t.numel() for t in (pk.a_tbl, pk.b_g1_tbl, pk.b_g2_tbl, pk.h_tbl, pk.l_tbl))

    def pool_oracle(self, name: str, scalars: list[int], skip_row: int | None = None):
        """sum_j pool_j · (sum over rows i = j mod 64 of scalars[i])."""
        r = self.curve.fr.modulus
        agg = [0] * POOL
        for i, s in enumerate(scalars):
            if i != skip_row:
                agg[i % POOL] += s
        hc = self.g2 if name == "b_g2" else self.g1
        return hc.msm(self.pools[name], [a % r for a in agg])

    def check_h(self, z: list[int], h_bitrev: list[int], rng: random.Random) -> bool:
        """h(x)·Z_H(x) == a(x)·b(x) − c(x) at a random x, with a, b, c
        interpolated on the host from z and the matrices."""
        from snark_tpu_torch.ops.ntt import bit_reverse_indices

        p = self.curve.fr.modulus
        pk = self.pk
        n, nc, ni = pk.domain_size, pk.num_constraints, pk.num_instance
        evals = [
            [z[c] for c in self.cols[0]] + z[:ni] + [0] * (n - nc - ni),
            [z[c] for c in self.cols[1]] + [0] * (n - nc),
            [z[c] for c in self.cols[2]] + [0] * (n - nc),
        ]
        x = rng.randrange(p)
        omega = self.curve.fr.root_of_unity(n)
        w, ws = 1, []
        for _ in range(n):
            ws.append(w)
            w = w * omega % p
        # L_i(x) = Z_H(x)/n · ω^i / (x − ω^i), with one batched inversion
        d = [(x - wi) % p for wi in ws]
        prefix = [1]
        for v in d:
            prefix.append(prefix[-1] * v % p)
        inv = pow(prefix[-1], -1, p)
        lag = [0] * n
        zx = (pow(x, n, p) - 1) % p
        zn = zx * pow(n, -1, p) % p
        for i in range(n - 1, -1, -1):
            lag[i] = zn * ws[i] % p * (prefix[i] * inv % p) % p
            inv = inv * d[i] % p
        ax, bx, cx = (sum(e * l for e, l in zip(ev, lag)) % p for ev in evals)
        rev = bit_reverse_indices(n)
        coeffs = [0] * n
        for k, v in enumerate(h_bitrev):
            coeffs[rev[k]] = v
        hx = 0
        for v in reversed(coeffs):
            hx = (hx * x + v) % p
        return hx * zx % p == (ax * bx - cx) % p


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def short_name(mangled: str) -> str:
    """`_ZN5snark23bucket_madd_rows_kernelINS_3Fp2INS_11BlsFqParamsEEELi0EEEv...`
    -> `bucket_madd_rows_kernel<Fp2<BlsFqParams>, 0>`; int and bool template
    arguments are kept: `_ZN5snark18sweep_chain_kernelILi34EEE...` ->
    `sweep_chain_kernel<34>`, `_ZN5snark15ntt_pass_kernelINS_8FrParamsELi3ELb1EEEv...`
    -> `ntt_pass_kernel<FrParams, 3, true>`."""
    m = re.match(r"_ZN5snark(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end() : m.end() + int(m.group(1))]
    arg = re.match(r"ILi(\d+)E", mangled[m.end() + int(m.group(1)) :])
    if arg:
        return f"{name}<{arg.group(1)}>"
    params = re.search(r"(BlsFqParams|BlsFrParams|FqParams|FrParams)", mangled)
    if not params:
        return name
    inner = params.group(1)
    if "3Fp2" in mangled:
        inner = f"Fp2<{inner}>"
    elif "2Fp" in mangled:
        inner = f"Fp<{inner}>"
    # int and bool arguments after the field (K1's part; K3's radix and
    # direction), up to the end of the template's arguments
    rest = mangled[params.end() : mangled.find("Ev", params.end()) + 1]
    args = [v if t == "i" else ("false", "true")[int(v)]
            for t, v in re.findall(r"L([ib])(\d+)E", rest)]
    return f"{name}<{', '.join([inner] + args)}>"


def kernel_template(name: str) -> str:
    """A kernel line's name -> its template in the ptxas report:
    `bucket_madd_rows_bls12_381_g2` -> `bucket_madd_rows_kernel<Fp2<BlsFqParams>>`
    (`point_add` is K2 without a mask)."""
    from snark_tpu_torch.ops import madd_parts as KP
    from snark_tpu_torch.ops import mul_parts as MP
    from snark_tpu_torch.ops import vpu_peak as V

    if name.startswith("bucket_madd_rows_part_"):  # BN254 G1 alone
        return f"bucket_madd_rows_kernel<Fp<FqParams>, {KP.PARTS.index(name.rsplit('_', 1)[1])}>"
    for kernel, kinds in zip(PARTS_KERNELS, (MP.PARTS_KINDS, MP.BISECT_KINDS)):
        if name.startswith(kernel + "_"):  # reduce_parts_chain_A_512, bisect_chain_conv0
            return f"{kernel}_kernel<{kinds.index(name[len(kernel) + 1 :].split('_')[0])}>"
    bls = "Bls" if "_bls12_381" in name else ""
    base = name.replace("_bls12_381", "")
    if base in ("sweep_chain", "conv_chain"):
        return f"{base}_kernel<{V.ROWS}>"
    if base in VPU_KERNELS:
        return f"{base}_kernel"
    if base == "ntt_pass":  # the DIT instance of 8 elements a thread (DIF: `ptxas_dif`)
        return f"ntt_pass_kernel<{bls}FrParams, 3, false>"
    if base in ("field_ew", "mont_mul16", "mont_mul16_limb_major"):
        return f"{base}_kernel<{bls}FrParams>"
    base, group = base.rsplit("_", 1)
    base = "masked_add" if base == "point_add" else base
    base = "affine_inverse_up" if base == "affine_batch_inverse" else base  # and top, down
    part = ", 0" if base == "bucket_madd_rows" else ""  # the shipped body
    return f"{base}_kernel<{'Fp2' if group == 'g2' else 'Fp'}<{bls}FqParams>{part}>"


def phase_build() -> dict:
    """Build the library; registers of each kernel and stack and spill
    bytes of each kernel and called function, as ptxas reports them."""
    from snark_tpu_torch import _native

    res = _native.build()
    funcs, name = {}, None
    for line in res.log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            name = short_name(m.group(1))
            funcs.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            funcs[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            funcs[name]["registers"] = int(m.group(1))
    sass = sass_mix(res.path, _native._nvcc())
    return {"nvcc_seconds": round(res.seconds, 3), "built": res.built, "ptxas": funcs,
            "sass": sass, "curve_kernels": curve_kernel_summary(funcs, sass)}


def phase_synthesis() -> dict:
    """The relations layer on the host: the LC engine's g++ build; the
    symbolic-LC chain (SYNTH_CHAIN_LCS LCs, each 2·(the previous) +
    (i + 1)·b, each in a constraint 1·LC = LC) finalized through the
    native engine and through the Python pass, whose LC stores and
    to_coo_arrays must be equal; the host time of synthesizing MulChain(7,
    FULL_N_BLS) over BLS12-381 Fr in setup mode (with finalize and the COO
    arrays) and in prove mode."""
    import numpy as np

    from snark_tpu_torch.fields.host import Fp
    from snark_tpu_torch.fields.params import BLS12_381, BN254
    from snark_tpu_torch.groth16 import synthesize_matrices, synthesize_witness
    from snark_tpu_torch.models import MulChainCircuit
    from snark_tpu_torch.relations import R1CS_PREDICATE_LABEL, native, new_ref
    from snark_tpu_torch.relations import variable as V

    engine = native.build()

    def chain():
        cs = new_ref(Fp(BN254.fr))
        a, b = cs.new_input_variable(2), cs.new_witness_variable(3)
        prev = cs.new_lc(cs.lc(a, b))
        for i in range(SYNTH_CHAIN_LCS - 1):
            prev = cs.new_lc(cs.lc_terms((2, prev), (i + 1, b)))
            cs.enforce_r1cs_constraint(cs.lc(V.ONE), cs.lc(prev), cs.lc(prev))
        return cs

    def store(cs):
        lm, values = cs.inner.lc_map, cs.inner.field_interner.values
        return lm.offsets, lm.vars, [values[c] for c in lm.coeff_ids]

    t = time.time()
    by_engine = chain()
    build_s = time.time() - t
    terms = by_engine.inner.lc_map.total_lc_size()
    if terms < 4096:
        raise AssertionError(f"the chain's {terms} terms are below the engine's threshold")
    by_python = chain()
    t = time.perf_counter()
    by_engine.finalize()
    engine_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    by_python.inner.inline_all_lcs_python()
    python_ms = (time.perf_counter() - t) * 1e3
    if store(by_engine) != store(by_python):
        raise AssertionError("the engine's inlined LCs differ from the Python pass's")
    coo = [m.inner.to_coo_arrays(R1CS_PREDICATE_LABEL) for m in (by_engine, by_python)]
    if not all(x.dtype == y.dtype and np.array_equal(x, y)
               for a, b in zip(*coo) for x, y in zip(a, b)):
        raise AssertionError("the engine's to_coo_arrays differ from the Python pass's")
    if not by_engine.is_satisfied():
        raise AssertionError("the finalized chain is not satisfied")

    circuit = MulChainCircuit(seed=7, n=FULL_N_BLS, batch=True)
    t = time.perf_counter()
    _, _, nc, ni, m = synthesize_matrices(circuit, BLS12_381)
    setup_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    z = synthesize_witness(circuit, BLS12_381)
    prove_ms = (time.perf_counter() - t) * 1e3
    if len(z) != m or (nc, ni) != (FULL_N_BLS, 2):
        raise AssertionError(f"MulChain synthesized {nc} constraints, {ni} instances, {len(z)} values")
    return {
        "engine_build": {"built": engine.built, "seconds": round(engine.seconds, 3),
                         "library": os.path.relpath(engine.path, HERE)},
        "chain": {"lcs": SYNTH_CHAIN_LCS, "terms": terms, "constraints": by_engine.num_constraints(),
                  "build_seconds": round(build_s, 3), "engine_ms": round(engine_ms, 3),
                  "python_ms": round(python_ms, 3), "lc_store_equal": True, "coo_equal": True,
                  "engine_finalize_ms": {k: round(v, 3)
                                         for k, v in by_engine.inner.finalize_ms.items()}},
        "mulchain_bls12_381": {"constraints": nc, "m": m, "setup_mode_ms": round(setup_ms, 3),
                               "prove_mode_ms": round(prove_ms, 3)},
    }


def curve_kernel_summary(ptxas: dict, sass) -> dict:
    """K1 and K2 on both curves and groups (and K1's parts) and the called
    product (`mont_mul_call`, the 12-limb field's and Fq2's): registers and
    spill stores (ptxas), static SASS instructions, the carry adds among
    them (IADD3, IADD3.X) beside the multiply-adds (the IMAD family but
    IMAD.MOV) and the moves (IMAD.MOV). cuobjdump lists the called
    product's SASS within each kernel that calls it."""
    out = {}
    for name, p in ptxas.items():
        if name.split("<")[0].removesuffix("_kernel") not in SASS_CURVE_KERNELS:
            continue
        ops = sass.get(name, {}) if isinstance(sass, dict) else {}
        out[name] = {
            "registers": p.get("registers"), "spill_stores": p.get("spill_stores"),
            "sass": sum(ops.values()) if ops else None,
            "iadd3": sum(n for op, n in ops.items() if op.startswith("IADD3")),
            "imad": sum(n for op, n in ops.items()
                        if op.startswith("IMAD") and not op.startswith("IMAD.MOV")),
            "imad_mov": sum(n for op, n in ops.items() if op.startswith("IMAD.MOV")),
        }
    return out


def sass_row_ops(ops: dict) -> dict:
    """A kernel's static SASS instructions by opcode family (SASS_ROW_OPS;
    IMAD without IMAD.MOV, which is a move) and in all."""
    out = {k: 0 for k in SASS_ROW_OPS}
    for op, n in ops.items():
        head = op.split(".")[0]
        if head in out and not op.startswith("IMAD.MOV"):
            out[head] += n
    out["all"] = sum(ops.values())
    return out


def sass_mix(lib: str, nvcc: str) -> dict | str:
    """Static SASS opcode counts of K12-K17 and of every instance of K1 (the
    shipped body on both curves and groups, and its BN254 G1 parts) and of
    K2 (with the called product, where a kernel calls it) in the built
    library, from `cuobjdump -sass` beside nvcc (a note instead where it is
    missing)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        return f"no cuobjdump beside {nvcc}"
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    mix, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            short = short_name(m.group(1))
            base = short.split("<")[0].removesuffix("_kernel")
            keep = base in VPU_KERNELS + PARTS_KERNELS + SASS_CURVE_KERNELS
            name = short if keep else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            counts = mix.setdefault(name, {})
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in mix.items()}


def kernel_row(name, source, replaces, ms, plain_ms, err, imads, nbytes) -> dict:
    """One entry of the kernels line (its launches are filled in later)."""
    b, by = bound_ms(imads, nbytes)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }


def float_err(a, b, rtol: float, atol: float) -> float:
    """Float kernels and plain versions agree within rtol and atol: the
    largest absolute difference, or fail."""
    import torch

    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        raise AssertionError(f"kernel and plain version differ beyond rtol {rtol}, atol {atol}")
    return float((a - b).abs().max())


def max_abs_err(a, b) -> int:
    """Kernels and plain versions compute exact residues: 0, or fail."""
    import torch

    if torch.equal(a, b):
        return 0
    raise AssertionError("kernel and plain version differ")


def plain_time(fn):
    """-> (fn(), milliseconds) of one run between CUDA events."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def scan_step_operands(tbl, perm, lane_base, start, length, i: int, group: str, curve):
    """Step i of the bucket scan as K11's operands: each lane's i-th row,
    decoded to affine limbs (plain torch ops), the digit's sign folded into
    y, and the mask of lanes whose run reaches step i on a row that is not
    the identity."""
    import torch

    from snark_tpu_torch.fields.limbs import fields_of, sub_plain
    from snark_tpu_torch.ops import curve as C

    idx = (lane_base.to(torch.int64) + start.to(torch.int64) + i).clamp(max=perm.numel() - 1)
    pay = perm[idx].to(torch.int64) & 0xFFFFFFFF
    rows = tbl[pay & 0x7FFFFFFF]
    x2, y2 = C.decode_rows(rows, group, curve)
    neg = (pay >> 31).bool()[:, None, None]
    y2 = torch.where(neg, sub_plain(torch.zeros_like(y2), y2, fields_of(curve)[1]), y2).contiguous()
    mask = (length > i) & (rows[:, C.row_bytes(group, curve) - 1] != 0)
    return x2, y2, mask


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def chain_latency(curve, device) -> dict:
    """SM clock cycles of one dependent step of K18's latency probe, on one
    thread of the card, in the curve's base field: `pair_cycles`, the
    product's multiply-add pair (mad.lo.cc, madc.hi.cc); `product_cycles`,
    one base-field product as K18's lanes run it. The least of two runs
    each."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.fields.limbs import fields_of

    fq = fields_of(curve)[1]
    rng = random.Random(12)
    x = fq.tensor([rng.randrange(fq.p) for _ in range(2)], device)
    out = torch.empty(fq.limbs, dtype=torch.int32, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    res = {}
    for mode, key in enumerate(("pair_cycles", "product_cycles")):
        runs = []
        for _ in range(2):
            _native.launch("chain_latency", _native.counter_name("chain_latency", curve.name),
                           _native.CURVE_CODES[curve.name], x.data_ptr(), out.data_ptr(),
                           cycles.data_ptr(), LATENCY_STEPS, mode)
            runs.append(int(cycles.item()) / LATENCY_STEPS)
        res[key] = min(runs)
    return res


def horner_bound_ms(W: int, c: int, group: str, curve, clock_hz: float, latency: dict) -> dict:
    """K18's latency bound: the Horner chain's c·(W − 1) doublings (the top
    window's c doublings of the identity are not counted) and W adds, each
    two levels of products deep, three where 3b is a product (BN254 G2; in
    G2 an Fq2 product is as deep as one base product), times the least
    latency of one base-field product, at the card's largest SM clock
    (nvidia-smi clocks.max.sm). That latency is the smaller of the product
    measured alone on one lane and its carry chain as csrc/chain.cuh orders
    it, 2N² + 4N − 1 dependent instructions (a fused mad.lo.cc/madc.hi.cc
    pair counted once), each at the measured pair's latency (`latency`,
    chain_latency). With every independent product of a level side by
    side, no schedule of these formulas on this product is shorter."""
    from snark_tpu_torch.ops import curve as C

    L = C.limbs_of(curve)
    levels = 2 + (not C.small_b3(group, curve))
    products = (c * (W - 1) + W) * levels
    chain = 2 * L * L + 4 * L - 1
    each = min(chain * latency["pair_cycles"], latency["product_cycles"])
    return {"ms": products * each / clock_hz * 1e3, "products": products,
            "chain_instructions": chain, **latency, "product_cycles_used": each,
            "clock_hz": clock_hz}


def mixed_scan(acc, tbl, perm, lane_base, start, length, k_steps: int, group: str, curve):
    """The bucket scan's first k_steps run step by step through K11, one
    launch a step: the function of K1 over the same steps."""
    from snark_tpu_torch.ops import curve as C

    for i in range(k_steps):
        x2, y2, mask = scan_step_operands(tbl, perm, lane_base, start, length, i, group, curve)
        acc = C.masked_mixed_add(acc, x2, y2, mask, group, curve)
    return acc


def edge_checks(group: str, curve, device) -> dict:
    """K1, K2, K11 and K5 on operands made of edge limb patterns, not
    curve points (`ops/curve.py` edge_scan, edge_points: 0, 1, p − 1,
    all-ones limbs; rows whose components run up to R − 1), against their
    plain versions on the card, exactly."""
    import numpy as np
    import torch

    from snark_tpu_torch.ops import curve as C

    n, k = EDGE_LANES, EDGE_STEPS
    acc, table, perm, lane_base, start, length = C.edge_scan(n, k, group, device, curve, seed=1)
    max_abs_err(C.bucket_madd_rows(acc, table, perm, lane_base, start, length, 0, k, group, curve),
                C.bucket_madd_rows_plain(acc, table, perm, lane_base, start, length, 0, k, group,
                                         curve))
    p, q = (C.edge_points(n, group, device, curve, seed=s) for s in (2, 3))
    mask = torch.as_tensor(np.random.default_rng(4).random(n) > 0.25, device=device)
    max_abs_err(C.masked_add(p, q, mask, group, curve), C.masked_add_plain(p, q, mask, group, curve))
    x2, y2 = q[:, 0].contiguous(), q[:, 1].contiguous()
    max_abs_err(C.masked_mixed_add(p, x2, y2, mask, group, curve),
                C.masked_mixed_add_plain(p, x2, y2, mask, group, curve))
    max_abs_err(C.point_double(p, group, curve), C.point_double_plain(p, group, curve))
    return {"lanes": n, "steps": k, "equal": True}


def phase_kernels(key: SyntheticKey, z_std, device) -> list[dict]:
    """K1-K4 and K11 of the key's curve against their plain versions at its
    full prove's shapes, and K9, K10 over its scalar field at bench_field's."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops import ntt as N
    from snark_tpu_torch.ops.msm import pick_window_plane_signed, signed_digits
    from snark_tpu_torch.ops.msm_plane import PlaneMsm

    pk, curve, fr = key.pk, key.curve, key.fr
    bls = curve.name != "bn254"
    nbits = curve.fr.num_bits
    fr_mul = C.imad_per_mul(fr.limbs)
    curve_src = "snark_tpu_torch/csrc/" + ("curve_bls.cu" if bls else "curve.cu")
    ntt_src = "snark_tpu_torch/csrc/" + ("ntt_bls.cu" if bls else "ntt.cu")
    c = pick_window_plane_signed(z_std.shape[0])
    digits = signed_digits(z_std, c, nbits)
    rows = []
    for group, tbl in (("g1", pk.a_tbl), ("g2", pk.b_g2_tbl)):
        plan = PlaneMsm(c, nbits, group, curve=curve)
        perm, start, length = plan._buckets(digits.t().contiguous())
        n = digits.shape[0]
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        lane_base = i32(torch.arange(plan.lanes, device=device) // plan.nb * n)
        # the main scan's runs: overflow past the spill cut is left out
        length = i32(plan.spill_plan(length, max(1, n // plan.nb))[0])
        start = i32(start)
        acc0 = C.identity(plan.lanes, group, device, curve)
        steps = int(length.max())

        def k1():
            return C.bucket_madd_rows(
                acc0, tbl, perm, lane_base, start, length, 0, steps, group, curve)

        out = k1()
        ms = cuda_ms(k1)
        ref, pms = plain_time(lambda: C.bucket_madd_rows_plain(
            acc0, tbl, perm, lane_base, start, length, 0, steps, group, curve))
        err = max_abs_err(out, ref)
        del ref
        adds = int(length.sum())  # rows this run adds (identity rows included)
        pt_bytes = out[0].numel() * 4
        # bytes: table, payloads and per-lane runs read once, accumulators
        # read and written once
        rows.append(kernel_row(_native.counter_name("bucket_madd_rows", curve.name, group),
              curve_src, "snark_tpu/ops/pallas_curve.py:754", ms, pms, err,
              adds * C.op_imads("madd_rows", group, curve),
              tbl.numel() + perm.numel() * 4 + plan.lanes * (2 * pt_bytes + 12)))

        # K2 on the scan's output: one suffix-scan step (stride 1)
        q = torch.roll(out.view(plan.W, plan.nb, *out.shape[1:]), -1, dims=1).reshape(out.shape).contiguous()
        mask = torch.as_tensor(plan.scan[0], device=device)

        def k2():
            return C.masked_add(out, q, mask, group, curve)

        o2 = k2()
        ms2 = cuda_ms(k2)
        ref2, pms2 = plain_time(lambda: C.masked_add_plain(out, q, mask, group, curve))
        err2 = max_abs_err(o2, ref2)
        active = int(mask.sum())
        rows.append(kernel_row(_native.counter_name("masked_add", curve.name, group),
              curve_src, "snark_tpu/ops/pallas_curve.py:716", ms2, pms2, err2,
              active * C.op_imads("add", group, curve),
              plan.lanes * (3 * pt_bytes + 1)))
        del out, q, o2, ref2

        # K11 on the scan's first step: each lane's first row, decoded
        x2, y2, mask = scan_step_operands(tbl, perm, lane_base, start, length, 0, group, curve)

        def k11():
            return C.masked_mixed_add(acc0, x2, y2, mask, group, curve)

        o11 = k11()
        ms11 = cuda_ms(k11)
        ref11, pms11 = plain_time(
            lambda: C.masked_mixed_add_plain(acc0, x2, y2, mask, group, curve))
        err11 = max_abs_err(o11, ref11)
        # its path: the first scan steps through K11, equal to K1 over them
        name11 = _native.counter_name("masked_mixed_add", curve.name, group)
        _native.reset_launches()
        stepped = mixed_scan(acc0, tbl, perm, lane_base, start, length, MIXED_SCAN_STEPS,
                             group, curve)
        launches11 = _native.LAUNCHES[name11]
        max_abs_err(stepped, C.bucket_madd_rows(
            acc0, tbl, perm, lane_base, start, length, 0, MIXED_SCAN_STEPS, group, curve))
        active = int(mask.sum())
        el_bytes = pt_bytes // 3
        row = kernel_row(name11, curve_src, "snark_tpu/ops/pallas_curve.py:729", ms11, pms11,
                         err11, active * C.op_imads("madd", group, curve),
                         plan.lanes * (2 * pt_bytes + 1) + active * 2 * el_bytes)
        row["launches"] = launches11
        rows.append(row)
        del o11, ref11, stepped, x2, y2, mask, perm, start, length, lane_base, acc0
        edge = edge_checks(group, curve, device)
        for r in rows[-3:]:  # K1, K2, K11
            r["edge_operands"] = edge
        torch.cuda.empty_cache()

    # K3 (the pass kernel; one stage of it, ntt_stage), K4 at the domain size
    n = pk.domain_size
    rng = random.Random(11)
    x, y, w = (fr.tensor([rng.randrange(fr.p) for _ in range(n)], device) for _ in range(3))
    plan = N.NttPlan(n, device, fr)
    rows.append(ntt_pass_row(plan, x, y, w, curve.name, ntt_src, fr_mul))
    if not bls:
        rows[-1]["ntt_rows"] = ntt_rows_checks(fr, device)

    for mode in ("mul", "add", "hadamard"):
        o4 = N.field_ew(mode, x, y, plan.coset_scale_rev, plan.z_coset_inv, fr)
        max_abs_err(o4, N.field_ew_plain(mode, x, y, plan.coset_scale_rev, plan.z_coset_inv, fr))
    ms4 = cuda_ms(lambda: N.field_ew("mul", x, y, field=fr), reps=10)
    _, pms4 = plain_time(lambda: N.field_ew_plain("mul", x, y, field=fr))
    rows.append(kernel_row(_native.counter_name("field_ew", curve.name), ntt_src,
          "snark_tpu/ops/ntt_plane.py:197", ms4, pms4, 0, n * fr_mul, n * 96))
    del x, y, w, plan
    rows += phase_kernels_field16(fr, device)
    return rows


def ntt_pass_row(plan, x, y, w, curve_name: str, source: str, fr_mul: int) -> dict:
    """K3 at the plan's domain: every pass of its split, DIT and DIF, with
    and without the Hadamard prologue and the scale epilogue, equal to the
    plain passes, and the fused h (`h_std`) equal to the unfused plain
    pipeline; one stage (`ntt_stage`) equal to its plain version. The row's
    ms and bounds are a pass's, the mean over a transform's passes; beside
    them each pass, a whole transform and the h pipeline (CUDA events over
    10 runs), one stage, and the bytes bound."""
    from snark_tpu_torch import _native
    from snark_tpu_torch.ops import ntt as N

    fr, n, log_n = plan.field, plan.n, plan.log_n
    had = (y, w, plan.z_coset_inv)
    for s0, k in plan.passes:
        for dif, tw in ((False, plan.fwd_tw), (True, plan.inv_tw)):
            for h, sc in ((None, None), (had, None), (None, plan.coset_scale_rev),
                          (had, plan.coset_unscale_std)):
                max_abs_err(N.ntt_pass(x, tw, s0, k, dif, hadamard=h, scale=sc, field=fr),
                            N.ntt_pass_plain(x, tw, s0, k, dif, hadamard=h, scale=sc, field=fr))
    max_abs_err(plan.h_std(x, y, w), plan.h_plain(x, y, w))
    s = 9  # one stage, a middle one: half = 512
    for dif in (False, True):
        max_abs_err(N.ntt_stage(x, plan.inv_tw, s, n >> (s + 1), dif, fr),
                    N.ntt_stage_plain(x, plan.inv_tw, s, n >> (s + 1), dif, fr))

    def bounds(imads, nbytes):
        b, by = bound_ms(imads, nbytes)
        return {"bound_ms": b, "bound_by": by, "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3}

    # bytes: the array in and out, and the twiddles the pass's top stage
    # indexes (2^s of the n/2 powers; the lower stages read a subset)
    passes = []
    for s0, k in plan.passes:
        ms = cuda_ms(lambda s0=s0, k=k: N.ntt_pass(x, plan.fwd_tw, s0, k, False, field=fr), reps=10)
        passes.append({"s0": s0, "k": k, "ms": ms, **bounds(
            k * (n // 2) * fr_mul, n * 64 + (1 << (s0 + k - 1)) * 32)})
    transform_ms = cuda_ms(lambda: plan.dit(x, plan.fwd_tw), reps=10)
    t_imads = log_n * (n // 2) * fr_mul
    t_bytes = sum(n * 64 + (1 << (s0 + k - 1)) * 32 for s0, k in plan.passes)
    h_ms = cuda_ms(lambda: plan.h_std(x, y, w), reps=10)
    # 7 transforms; 6 products an element (3 scales, the Hadamard's 2, the
    # unscale); the Hadamard's two more inputs and the 4 scale tables read
    h_bounds = bounds(7 * t_imads + 6 * n * fr_mul, 7 * t_bytes + (2 + 4) * n * 32)
    stage_ms = cuda_ms(lambda: N.ntt_stage(x, plan.inv_tw, s, n >> (s + 1), False, fr), reps=10)
    _, plain_ms = plain_time(lambda: [N.ntt_pass_plain(x, plan.fwd_tw, s0, k, False, field=fr)
                                      for s0, k in plan.passes])
    P = len(plan.passes)
    row = kernel_row(_native.counter_name("ntt_pass", curve_name), source,
                     "snark_tpu/ops/ntt_plane.py:158", transform_ms / P, plain_ms / P, 0,
                     t_imads / P, t_bytes / P)
    row.update(
        bytes_bound_ms=t_bytes / P / PEAK_BYTES * 1e3, passes=passes,
        transform_ms=transform_ms, transform_bound=bounds(t_imads, t_bytes),
        h_ms=h_ms, h_bound=h_bounds,
        ntt_stage_ms=stage_ms, ntt_stage_bound=bounds((n // 2) * fr_mul, n * 64 + (1 << s) * 32),
    )
    return row


def ntt_rows_checks(fr, device) -> list[dict]:
    """K3 through `ntt_rows` at each of NTT_ROWS_SHAPES, forward and inverse
    (the inverse twiddles and the 1/m scale), equal to `ntt_rows_plain` on
    the same shard; each with its time and the plain version's."""
    from snark_tpu_torch.ops import ntt as N

    out = []
    for log_n, m in NTT_ROWS_SHAPES:
        rng = random.Random(log_n)
        x = fr.tensor([rng.randrange(fr.p) for _ in range(1 << log_n)], device)
        plan = N.NttPlan(m, device, fr)
        inv_m = fr.const(pow(m, -1, fr.p), device)
        for inverse, tw, scale in ((False, plan.fwd_tw, None), (True, plan.inv_tw, inv_m)):
            def run(fn=N.ntt_rows, x=x, m=m, tw=tw, scale=scale):
                return fn(x, m, tw, scale, fr)

            want, plain = plain_time(lambda: run(N.ntt_rows_plain))
            out.append({"elements": 1 << log_n, "m": m, "rows": (1 << log_n) // m,
                        "inverse": inverse, "max_abs_err": max_abs_err(run(), want),
                        "ms": cuda_ms(run, reps=10), "plain_ms": plain})
    return out


def phase_kernels_field16(fr, device) -> list[dict]:
    """K9 and K10 at bench_field's shape (2^20 elements of the scalar
    field, its tiled pairs) against their plain version. K10's row times
    the wrapper, its transposes included, as bench_field does; the kernel
    alone on limb-major copies is its `kernel_only_ms`."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch import bench_field as BF
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops import mont16 as M16
    from snark_tpu_torch.ops.ntt import SCALAR_FIELDS

    a, b = (M16.limbs16_tensor(x, device) for x in BF.inputs(fr.params, BENCH_FIELD_LOG_N))
    n = a.shape[0]
    ref, pms = plain_time(lambda: M16.mont_mul16_plain(a, b, fr))
    rows = []
    for kernel, fn, src_line in (
        ("mont_mul16", M16.mont_mul16, "snark_tpu/ops/pallas_field.py:236"),
        ("mont_mul16_limb_major", M16.mont_mul16_limb_major, "scripts/pallas_field_v2.py:69"),
    ):
        err = max_abs_err(fn(a, b, fr), ref)
        row = kernel_row(_native.counter_name(kernel, SCALAR_FIELDS[fr.params.name]),
                         "snark_tpu_torch/csrc/field16.cu", src_line, cuda_ms(lambda: fn(a, b, fr)),
                         pms, err, n * C.imad_per_mul(8), 3 * n * 4 * a.shape[1])
        rows.append(row)
    at, bt = a.t().contiguous(), b.t().contiguous()
    out = torch.empty_like(at)
    rows[-1]["kernel_only_ms"] = cuda_ms(
        lambda: M16._launch("mont_mul16_limb_major", fr, at, bt, out, n, M16.DEFAULT_THREADS))
    max_abs_err(out.t(), ref)
    return rows


def k7_tree_ms(den, dinv, group: str, curve, reps: int = 3) -> dict:
    """K7 over one level's whole product tree: `tree_inverse` on the
    level's den as `batch_inverse` runs it, with CUDA events around each of
    its 3·ceil(log2 M) products and its root inverse, so every launch is
    timed on its real operands (a launch the host fed late also counts
    the stream's wait for it). The result must equal dinv. -> the
    up-sweep's widths, each level's three products summed (`level_ms`),
    the products' sum, the root inverse's, the whole tree between two
    events (its `torch.cat` copies too) and the launches, each time the
    mean of `reps` runs after a warm-up."""
    import torch

    from snark_tpu_torch.fields.limbs import fields_of
    from snark_tpu_torch.ops import msm_affine as A

    one = A.from_words(A._field_one(A.GROUPS[group], fields_of(curve)[1], den.device))

    def timed(fn, marks):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            r = fn(*args)
            b.record()
            marks.append((a, b))
            return r
        return run

    runs = []
    for _ in range(reps + 1):
        muls, roots = [], []
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        inv = A.tree_inverse(
            den, timed(lambda a, b: A.affine_tree_mul(a, b, group, curve=curve), muls),
            timed(lambda r: A.affine_inverse(r, group, curve), roots), one)
        t1.record()
        torch.cuda.synchronize()
        if not torch.equal(inv, dinv):
            raise AssertionError(f"k7_tree {group}: the timed tree's inverses differ")
        runs.append(([a.elapsed_time(b) for a, b in muls],
                     sum(a.elapsed_time(b) for a, b in roots), t0.elapsed_time(t1)))
    runs = runs[1:]
    mul_ms = [sum(r[0][i] for r in runs) / reps for i in range(len(runs[0][0]))]
    n = len(mul_ms) // 3  # the up-sweep's products widest first, then the down-sweep's pairs
    level_ms = [mul_ms[i] + mul_ms[3 * n - 2 * (i + 1)] + mul_ms[3 * n - 2 * i - 1]
                for i in range(n)]
    root_ms = sum(r[1] for r in runs) / reps
    widths, w = [], den.shape[0]
    while w > 1:
        widths.append((w + 1) // 2)
        w = widths[-1]
    return {"widths": widths, "level_ms": level_ms, "mul_sum_ms": sum(mul_ms),
            "root_inverse_ms": root_ms, "sum_ms": sum(mul_ms) + root_ms,
            "tree_ms": sum(r[2] for r in runs) / reps, "launches": len(mul_ms) + 1}


def batch_inverse_row(den, dinv, group: str, curve, source: str, name, mul_imads: int,
                      el_bytes: int, root_ms: float) -> dict:
    """K19 (`affine_batch_inverse`) at a level's width: equal to its plain
    version (on the card) there and at the edges of its indexing (M = 1, 2,
    3, C − 1, C, C + 1, T·C − 1, T·C + 1, 3·T·C + 5, and kTop + 3 block
    products), den·dinv = 1; its time, its plain version's, three launches a
    call. `bound_ms` is the larger of the products' (3(M − 1) products)
    and the bytes' (den read, dinv written); `bound_with_root_ms` adds the
    root inverse's latency (`root_ms`, K7 mode 1 on one element, the same
    `fermat_inv`)."""
    import torch

    from snark_tpu_torch.fields.limbs import fields_of
    from snark_tpu_torch.ops import msm_affine as A

    M, K, L = den.shape
    T, C, top = A.INVERSE_SIZES[(curve.name, group)]
    fq = fields_of(curve)[1]
    one = torch.zeros((1, K, L), dtype=torch.int32, device=den.device)
    one[0, 0] = fq.const(1, den.device)
    if not torch.equal(A.affine_tree_mul(den, dinv, group, curve=curve), one.expand_as(den)):
        raise AssertionError(f"{name('affine_batch_inverse')}: den·dinv is not one")
    ref, pms = plain_time(lambda: A.affine_batch_inverse_plain(den, group, curve))
    err = max_abs_err(dinv, ref)
    del ref
    edges = [1, 2, 3, C - 1, C, C + 1, T * C - 1, T * C + 1, 3 * T * C + 5, (top + 3) * T * C - 11]
    for m in edges:
        part = den[:m].contiguous()
        max_abs_err(A.affine_batch_inverse(part, group, curve),
                    A.affine_batch_inverse_plain(part, group, curve))
    row = kernel_row(name("affine_batch_inverse"), source, "snark_tpu/ops/msm_affine.py:508",
                     cuda_ms(lambda: A.affine_batch_inverse(den, group, curve), reps=10), pms, err,
                     3 * (M - 1) * mul_imads, 2 * M * el_bytes)
    row.update(pairs=M, threads=T, chunk=C, top_threads=top, blocks=-(-M // (T * C)),
               launches_per_call=3, edge_sizes=edges, root_inverse_ms=root_ms,
               bound_with_root_ms=row["bound_ms"] + root_ms)
    return row


def phase_kernels_msm(inputs: dict, device) -> tuple[list[dict], dict]:
    """K18 at the bench MSM's combine (its W = 20 window totals, c = 13) and
    on the edge totals, K5 and K2 without a mask one lane at a time and as
    the Horner chain K18 replaced, K6-K8 at level 0 of the bench MSM's
    affine tree, on the bench inputs' curve, against their plain versions.
    -> (kernel rows, extra timings)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.bench import host_curve
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops import msm_affine as A
    from snark_tpu_torch.ops.msm_plane import PlaneMsm

    rows, extra = [], {}
    curve = next(iter(inputs.values())).curve
    bls = curve.name != "bn254"
    curve_src = "snark_tpu_torch/csrc/" + ("curve_bls.cu" if bls else "curve.cu")
    affine_src = "snark_tpu_torch/csrc/" + ("affine_bls.cu" if bls else "affine.cu")
    L = C.limbs_of(curve)
    fq_mul = C.imad_per_mul(L)
    fq_dec = C.imad_per_decode(L)
    latency = chain_latency(curve, device)
    extra[_native.counter_name("chain_latency", curve.name)] = latency
    for group, inp in inputs.items():
        K = C.GROUPS[group]
        m2 = 1 if K == 1 else 3  # base muls per field mul
        el_bytes = K * 4 * L
        pt_bytes = 3 * el_bytes

        def name(kernel):
            return _native.counter_name(kernel, curve.name, group)

        hc = host_curve(group, curve)
        # K18 on the bench MSM's window totals
        scan_plan = PlaneMsm(inp.c, curve.fr.num_bits, group, signed=True, curve=curve)
        sums, c, W = scan_plan.window_sums(inp.table, inp.digits), scan_plan.c, scan_plan.W
        k18 = C.horner_combine(sums, c, group, curve)
        ref, pms = plain_time(lambda: C.horner_combine_plain(sums, c, group, curve))
        err = max_abs_err(k18, ref)
        edge = []
        for case, s, cc in C.horner_cases(W, c, group, device, curve, seed=4):
            max_abs_err(C.horner_combine(s, cc, group, curve),
                        C.horner_combine_plain(s, cc, group, curve))
            edge.append(case)
        # the former combine, through K5 and K2 without a mask
        _native.reset_launches()
        max_abs_err(C.horner_chain(sums, c, group, curve), k18)
        chain_launches = {k: v for k, v in _native.LAUNCHES.items() if v}
        # one whole MSM launches K18 once, and K5 and K2 unmasked never
        _native.reset_launches()
        msm_out = scan_plan.msm(inp.table, inp.digits)
        per_msm = {k: v for k, v in _native.LAUNCHES.items() if v}
        if C.limbs_to_points(msm_out[None], group, curve)[0] != inp.want:
            raise AssertionError(f"{name('horner_combine')}: the MSM differs from the pool oracle")
        if (per_msm.get(name("horner_combine")) != 1 or name("point_double") in per_msm
                or name("point_add") in per_msm):
            raise AssertionError(f"{name('horner_combine')}: the MSM's combine launched {per_msm}")
        row = kernel_row(
            name("horner_combine"), curve_src, "snark_tpu/ops/msm_plane.py:626",
            cuda_ms(lambda: C.horner_combine(sums, c, group, curve), reps=20), pms, err,
            c * W * C.op_imads("dbl", group, curve) + W * C.op_imads("add", group, curve),
            (W + 1) * pt_bytes)
        bound = horner_bound_ms(W, c, group, curve, max_sm_clock_hz(), latency)
        row.update(windows=W, c=c, edge_totals=edge, launches_per_msm=per_msm,
                   latency_bound_ms=bound["ms"], latency_bound=bound)
        rows.append(row)

        p = C.points_to_limbs([inp.want], group, device, curve)
        q = C.points_to_limbs([hc.double(hc.generator)], group, device, curve)
        for kernel, fn, plain, imads, nbytes, src_line in (
            ("point_double", lambda: C.point_double(p, group, curve),
             lambda: C.point_double_plain(p, group, curve), C.op_imads("dbl", group, curve), 2 * pt_bytes,
             "snark_tpu/ops/pallas_curve.py:709"),
            ("point_add", lambda: C.point_add(p, q, group, curve),
             lambda: C.point_add_plain(p, q, group, curve), C.op_imads("add", group, curve), 3 * pt_bytes,
             "snark_tpu/ops/pallas_curve.py:702"),
        ):
            out = fn()
            ref, pms = plain_time(plain)
            row = kernel_row(name(kernel), curve_src, src_line, cuda_ms(fn, reps=20), pms,
                             max_abs_err(out, ref), imads, nbytes)
            # off the path since K18: the main path's count (0) fills
            # `launches`; the former chain's is its own key
            row.update(on_path=False, chain_launches=chain_launches.get(name(kernel), 0))
            rows.append(row)
        del sums, k18, ref, msm_out

        plan = PlaneMsm(inp.c, curve.fr.num_bits, group, signed=True, affine=True, curve=curve)
        n = inp.n
        perm, start, length = plan._buckets(inp.digits.t().contiguous())
        blk_rows, sgn, _, _, B0 = A.AffineAccum(plan).blocks(
            inp.table, perm, start, length, n, max(1, n // plan.nb))
        del perm, start, length
        M = blk_rows.shape[0] // 2
        rb = blk_rows.shape[1]

        den, cls = A.affine_phase1(blk_rows, sgn, group, curve)
        ms = cuda_ms(lambda: A.affine_phase1(blk_rows, sgn, group, curve))
        (pden, pcls), pms = plain_time(lambda: A.affine_phase1_plain(blk_rows, sgn, group, curve))
        err = max(max_abs_err(den, pden), max_abs_err(cls, pcls))
        del pden, pcls
        rows.append(kernel_row(
            name("affine_phase1"), affine_src, "snark_tpu/ops/msm_affine.py:329", ms, pms, err,
            M * 4 * K * fq_dec, M * (2 * rb + 2 + el_bytes + 1)))
        rows[-1]["level0_pairs"] = M

        h = M // 2
        a, b = den[:h], den[h:]
        tm = A.affine_tree_mul(a, b, group, curve=curve)
        ms = cuda_ms(lambda: A.affine_tree_mul(a, b, group, curve=curve))
        ptm, pms = plain_time(lambda: A.affine_tree_mul_plain(a, b, group, curve))
        err = max_abs_err(tm, ptm)
        root = den[:1].contiguous()
        err = max(err, max_abs_err(A.affine_inverse(root, group, curve),
                                   A.affine_inverse_plain(root, group, curve)))
        extra[name("root_inverse_ms")] = cuda_ms(lambda: A.affine_inverse(root, group, curve))
        del tm, ptm
        rows.append(kernel_row(
            name("affine_tree_mul"), affine_src, "snark_tpu/ops/msm_affine.py:358", ms, pms, err,
            h * m2 * fq_mul, 3 * h * el_bytes))

        torch.cuda.synchronize()
        t = time.time()
        _native.reset_launches()
        dinv = A.batch_inverse(den, group, curve)
        torch.cuda.synchronize()
        extra[name("batch_inverse_ms")] = (time.time() - t) * 1e3
        per_call = {k: v for k, v in _native.LAUNCHES.items() if v}
        if per_call != {name("affine_batch_inverse"): 3}:
            raise AssertionError(
                f"{name('affine_batch_inverse')}: a batch inverse launched {per_call}")
        extra[name("batch_inverse_device_ms")] = cuda_ms(lambda: A.batch_inverse(den, group, curve))
        extra[name("k7_tree")] = k7_tree_ms(den, dinv, group, curve)  # equal to dinv
        rows.append(batch_inverse_row(den, dinv, group, curve, affine_src, name, m2 * fq_mul,
                                      el_bytes, extra[name("k7_tree")]["root_inverse_ms"]))
        out = A.affine_phase3(blk_rows, sgn, dinv, cls, group, curve)
        ms = cuda_ms(lambda: A.affine_phase3(blk_rows, sgn, dinv, cls, group, curve))
        ref, pms = plain_time(
            lambda: A.affine_phase3_plain(blk_rows, sgn, dinv, cls, group, curve))
        err = max_abs_err(out, ref)
        counts = torch.bincount(cls.to(torch.int64), minlength=5).tolist()
        computed = counts[A.ADD] + counts[A.DOUBLE]
        extra[name("level0_classes")] = dict(
            zip(("add", "double", "dead", "copy_l", "copy_r"), counts))
        extra[name("level0_pairs")] = M
        # decode 4K steps and encode 2K base muls per pair; λ, λ², λ·(x1 − x3)
        # per computed pair; x1² per double
        muls = M * 2 * K + (3 * computed + counts[A.DOUBLE]) * m2
        rows.append(kernel_row(
            name("affine_phase3"), affine_src, "snark_tpu/ops/msm_affine.py:340", ms, pms, err,
            muls * fq_mul + M * 4 * K * fq_dec, M * (2 * rb + 2 + el_bytes + 1 + rb)))
        rows[-1]["level0_pairs"] = M
        del blk_rows, sgn, den, cls, dinv, out, ref
        torch.cuda.empty_cache()
    return rows, extra


def phase_prove_fixture(device, affine_msm: bool = False, bls: bool = False) -> dict:
    """The committed fixture of BN254 (MulChain(4, 1023), m = 2048) or of
    BLS12-381 (MulChain(7, 12), m = 26), proved from the port's synthesis
    of the circuit (`prove(pk, circuit, r, s)`) at its committed (r, s)."""
    from snark_tpu_torch.fields.params import BLS12_381, BN254
    from snark_tpu_torch.groth16 import Groth16, ProvingKey
    from snark_tpu_torch.models import MulChainCircuit
    from snark_tpu_torch.snark import serialize as ser

    curve, pk_path, proof_path, circuit = (
        (BLS12_381, FIXTURE_PK_BLS, FIXTURE_PROOF_BLS, MulChainCircuit(seed=7, n=12)) if bls
        else (BN254, FIXTURE_PK, FIXTURE_PROOF, MulChainCircuit(seed=4, n=1023))
    )
    with open(proof_path) as f:
        want = json.load(f)
    pk = ProvingKey.load(pk_path, device=device)
    g16 = Groth16(curve, device=device, affine_msm=affine_msm)
    t = time.time()
    proof = g16.prove(pk, circuit, r=int(want["r"]), s=int(want["s"]))
    prove_s = time.time() - t
    got = ser.serialize_proof(proof, curve).hex()
    if got != want["proof_bytes_hex"]:
        raise AssertionError(f"{curve.name} fixture proof differs from the JAX package's: {got}")
    if not g16.verify(pk.vk, want["public_input"], proof):
        raise AssertionError(f"{curve.name} fixture proof does not verify")
    return {"m": pk.num_instance + pk.num_witness, "equal_to_jax_proof": True, "verifies": True,
            "prove_seconds": round(prove_s, 3),
            "synthesize_ms": round(g16.last_run.stage_ms["synthesize"], 3)}


def phase_prove_full(key: SyntheticKey, z: list[int], device, affine_msm: bool = False):
    """Prove key.circuit through `prove(pk, circuit, r, s)`, which
    synthesizes its witness; z, the full assignment, feeds the oracles.
    -> (phase info, launch counts of the prove, the proof)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.groth16 import Groth16, assemble_proof

    pk, fr = key.pk, key.fr
    rng = random.Random(2024)
    r, s = rng.randrange(fr.p), rng.randrange(fr.p)
    g16 = Groth16(key.curve, device=device, affine_msm=affine_msm)
    g16.ntt_plan(pk.domain_size)  # host-built twiddles: set-up, not prove time
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    t = time.time()
    proof = g16.prove(pk, key.circuit, r=r, s=s)
    prove_s = time.time() - t
    launches = dict(_native.LAUNCHES)
    run = g16.last_run
    k3 = launches[_native.counter_name("ntt_pass", key.curve.name)]
    if k3 != 7 * len(g16.ntt_plan(pk.domain_size).passes):
        raise AssertionError(f"the h pipeline launched K3 {k3} times")
    h = fr.decode(run.h_std, mont=False)
    ni = pk.num_instance
    n = pk.domain_size
    want = {
        "A": key.pool_oracle("a", z),
        "B": key.pool_oracle("b_g2", z),
        "B1": key.pool_oracle("b_g1", z),
        "L": key.pool_oracle("l", z[ni:]),
        "H": key.pool_oracle("h", h, skip_row=n - 1),
    }
    for name, pt in want.items():
        if run.sums[name] != pt:
            raise AssertionError(f"MSM {name} differs from the pool oracle")
    if not key.check_h(z, h, rng):
        raise AssertionError("h(x)·Z_H(x) != a(x)·b(x) − c(x)")
    if proof != assemble_proof(g16, pk, want["A"], want["B"], want["B1"], want["L"], want["H"], r, s):
        raise AssertionError("proof differs from assemble_proof on the oracle sums")
    info = {
        "curve": key.curve.name, "constraints": pk.num_constraints,
        "m": ni + pk.num_witness, "domain": n, "table_bytes": key.table_bytes(),
        "prove_seconds": round(prove_s, 3),
        "synthesize_ms": round(run.stage_ms["synthesize"], 3),
        "stage_ms": {k: round(v, 3) for k, v in run.stage_ms.items()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "msm_exact": True, "h_identity": True, "proof_equals_assembly": True,
        "affine_engaged": run.affine,
        "launches": {k: v for k, v in launches.items() if v},
    }
    return info, launches, proof


class MulChainQap:
    """The setup's scalars of a MulChain circuit on the host, from the
    toxic waste replayed from random.Random(setup_seed): u, v, w of a
    column from the synthesized matrices and
    L_j(τ) = (Z(τ)/n)·ω^j/(τ − ω^j), and the l, h and gamma_abc scalars
    from them."""

    def __init__(self, circuit, curve, n: int, setup_seed: int):
        from snark_tpu_torch.fields.host import Fp
        from snark_tpu_torch.groth16 import synthesize_matrices

        rng = random.Random(setup_seed)
        self.alpha, self.beta, self.gamma, self.delta, self.tau = (
            Fp(curve.fr).rand(rng) for _ in range(5))
        self.p, self.n = curve.fr.modulus, n
        self.omega = curve.fr.root_of_unity(n)
        self.z_tau = (pow(self.tau, n, self.p) - 1) % self.p
        coo, _, self.nc, self.ni, _ = synthesize_matrices(circuit, curve)
        self.cols = [col for _, col, _ in coo]  # one entry a row, coefficient 1

    def lagrange(self, j: int) -> int:
        p, w = self.p, pow(self.omega, j, self.p)
        return self.z_tau * pow(self.n, -1, p) % p * w % p * pow((self.tau - w) % p, -1, p) % p

    def uvw(self, i: int) -> list[int]:
        import numpy as np

        out = []
        for k, c in enumerate(self.cols):
            s = sum(self.lagrange(int(j)) for j in np.nonzero(c == i)[0])
            if k == 0 and i < self.ni:  # input-consistency row
                s += self.lagrange(self.nc + i)
            out.append(s % self.p)
        return out

    def combined(self, i: int, inv: int) -> int:
        u, v, w = self.uvw(i)
        return (self.beta * u + self.alpha * v + w) * inv % self.p

    def h(self, j: int) -> int:
        p = self.p
        return pow(self.tau, j, p) * self.z_tau % p * pow(self.delta, -1, p) % p


def setup_config(n_constraints: int, config3: bool) -> dict:
    """The circuit and the setup of a setup phase: the reference's
    configuration 3 (`scripts/run_configs.py` config3: MulChain(7, n,
    batch=True), the setup from random.Random(0) with the default
    want_query=True, a warm prove from random.Random(5), the timed prove
    from random.Random(1), verify with [7]), or MulChain(FULL_SEED, n) set
    up from random.Random(FULL_SEED) with want_query=False and proved from
    random.Random(2024)."""
    from snark_tpu_torch.models import MulChainCircuit

    if config3:
        return {"circuit": MulChainCircuit(seed=7, n=n_constraints, batch=True), "setup_seed": 0,
                "want_query": True, "warm_seed": 5, "prove_seed": 1, "public": [7], "config": 3}
    return {"circuit": MulChainCircuit(seed=FULL_SEED, n=n_constraints), "setup_seed": FULL_SEED,
            "want_query": False, "warm_seed": None, "prove_seed": 2024, "public": [FULL_SEED],
            "config": None}


def samples(size: int, rng: random.Random) -> list[int]:
    """SETUP_SAMPLES indices below size: the ends and random ones."""
    return sorted({0, 1, size - 1} | {rng.randrange(size) for _ in range(SETUP_SAMPLES - 3)})


def phase_setup_full(curve, n_constraints: int, device, smi: str, config3: bool = False):
    """The setup on the card of the circuit of `setup_config`
    (`circuit_specific_setup(circuit, rng)`, which synthesizes it): the
    reference's configuration 3 with `config3`, else MulChain(FULL_SEED,
    n_constraints) from random.Random(FULL_SEED), want_query=False. Checks: for
    SETUP_SAMPLES rows of each table, the scalar read back from the device
    QAP equals the host formula on the replayed toxic waste and the decoded
    row equals the host scalar multiplication of the generator by it;
    gamma_abc likewise; a_tbl's identity rows lie exactly where u = 0, and
    h_tbl's one identity row where bitrev(k) = n − 1; WALK_CHECK_LANES
    lanes of a_tbl's walk (live ones, 64 identity lanes among them)
    through K1 equal its plain version on the card; with want_query, the
    sampled rows of each legacy query array hold the table rows' points.
    -> (phase info, key, vk, the setup's launch counts)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.groth16 import Groth16
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops.affine_codec import query_to_points
    from snark_tpu_torch.ops.fixed_base import FixedBase
    from snark_tpu_torch.ops.ntt import bit_reverse_indices

    cfg = setup_config(n_constraints, config3)
    circuit = cfg["circuit"]
    g16 = Groth16(curve, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what the smoke holds already
    _native.reset_launches()
    t = time.time()
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(cfg["setup_seed"]),
                                        want_query=cfg["want_query"])
    setup_s = time.time() - t
    launches = dict(_native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    run, fr = g16.last_setup, g16.fr
    n, ni = pk.domain_size, pk.num_instance
    m = ni + pk.num_witness
    host = MulChainQap(circuit, curve, n, cfg["setup_seed"])
    p = host.p
    delta_inv, gamma_inv = pow(host.delta, -1, p), pow(host.gamma, -1, p)
    rev = bit_reverse_indices(n)

    def read(name, i):
        return fr.decode(run.scalars[name][i : i + 1], mont=False)[0]

    def check(table, group, idxs, scalar_of):
        """scalar_of(k) -> (index into the QAP's vector or None, host scalar)."""
        hc = g16.hg1 if group == "g1" else g16.hg2
        rows = getattr(pk, table)[torch.as_tensor(idxs, device=device)].cpu().numpy()
        for k, pt in zip(idxs, C.rows_to_points(rows, group, curve)):
            (name, at), want = scalar_of(k)
            if name is not None and read(name, at) != want:
                raise AssertionError(f"{table} row {k}: the device QAP's scalar differs")
            if pt != hc.scalar_mul(hc.generator, want):
                raise AssertionError(f"{table} row {k} differs from the host point")

    srng = random.Random(5)
    for table, group in (("a_tbl", "g1"), ("b_g1_tbl", "g1"), ("b_g2_tbl", "g2")):
        k = 0 if table == "a_tbl" else 1
        check(table, group, samples(m, srng),
              lambda i, k=k: (("ab"[k], i), host.uvw(i)[k]))
    check("l_tbl", "g1", samples(m - ni, srng),
          lambda i: (("l", i), host.combined(ni + i, delta_inv)))
    check("h_tbl", "g1", samples(n, srng),
          lambda k: (("h", int(rev[k])), host.h(int(rev[k]))) if rev[k] < n - 1 else ((None, 0), 0))
    for i, pt in enumerate(vk.gamma_abc_g1):
        if pt != g16.hg1.scalar_mul(g16.hg1.generator, host.combined(i, gamma_inv)):
            raise AssertionError(f"gamma_abc_g1[{i}] differs from the host point")
    zero_u = run.scalars["a"].eq(0).all(1)
    if not torch.equal(zero_u, pk.a_tbl[:, -1] == 0):
        raise AssertionError("a_tbl's identity rows are not where u = 0")
    h_ident = torch.nonzero(pk.h_tbl[:, -1] == 0).flatten().tolist()
    if h_ident != [int(k) for k in range(n) if rev[k] == n - 1]:
        raise AssertionError(f"h_tbl's identity rows are {h_ident}")
    queries = sorted(f"{t}_query" for t in ("a", "b_g1", "b_g2", "h", "l"))
    if cfg["want_query"] and sorted(pk.queries) != queries:
        raise AssertionError(f"the key holds the query arrays {sorted(pk.queries)}")
    for name, q in pk.queries.items():  # query j is table row j; h's is row rev[j]
        stem, group = name[: -len("_query")], "g2" if name == "b_g2_query" else "g1"
        js = samples(q.shape[0], srng)
        ks = [int(rev[j]) for j in js] if stem == "h" else js
        rows = getattr(pk, f"{stem}_tbl")[torch.as_tensor(ks, device=device)].cpu().numpy()
        if query_to_points(q[js], group, curve) != C.rows_to_points(rows, group, curve):
            raise AssertionError(f"{name}'s sampled points differ from {stem}_tbl's rows")

    # live lanes (u ≠ 0: ONE, the seed and the x columns) with 64 identity
    # lanes (the m columns) scattered among them
    live_at, dead_at = torch.nonzero(~zero_u).flatten(), torch.nonzero(zero_u).flatten()
    n_live = min(WALK_CHECK_LANES - 64, live_at.numel())
    lanes = torch.cat([live_at[:n_live], dead_at[: WALK_CHECK_LANES - n_live]])
    lanes = lanes[torch.randperm(lanes.numel(), generator=torch.Generator().manual_seed(6))
                  .to(device)]
    fb = FixedBase(curve, "g1", device)
    ops = fb.walk_operands(run.scalars["a"][lanes].contiguous())

    def walk_chunk():
        return C.bucket_madd_rows(*ops[:1], fb.table, *ops[1:], 0, fb.W, "g1", curve)

    got = walk_chunk()
    want, plain_ms = plain_time(
        lambda: C.bucket_madd_rows_plain(*ops[:1], fb.table, *ops[1:], 0, fb.W, "g1", curve))
    walk = {"lanes": lanes.numel(), "live_lanes": n_live, "steps": fb.W, "max_abs_err": max_abs_err(got, want),
            "ms": cuda_ms(walk_chunk), "plain_ms": plain_ms,
            "a_walk_ms": cuda_ms(lambda: fb.walk(run.scalars["a"]))}
    tables = ("a_tbl", "b_g1_tbl", "b_g2_tbl", "h_tbl", "l_tbl")
    info = {
        "curve": curve.name, "config": cfg["config"], "circuit_seed": circuit.seed,
        "setup_rng": f"random.Random({cfg['setup_seed']})", "want_query": cfg["want_query"],
        "constraints": n_constraints, "m": m, "domain": n,
        "nvidia_smi": smi, "setup_seconds": round(setup_s, 3),
        "synthesize_ms": round(run.stage_ms["synthesize"], 3),
        "stage_ms": {k: round(v, 3) for k, v in run.stage_ms.items()},
        "query_bytes": sum(q.nbytes for q in pk.queries.values()),
        "query_arrays": {k: list(q.shape) for k, q in pk.queries.items()},
        "max_memory_allocated": peak, "held_before": held, "setup_peak_bytes": peak - held,
        "table_bytes": sum(getattr(pk, t).numel() for t in tables),
        "setup_launches": {k: v for k, v in launches.items() if v},
        "sampled_rows": SETUP_SAMPLES, "sampled_equal": True,
        "a_identity_rows": int(zero_u.sum()), "h_identity_rows": h_ident, "walk_check": walk,
    }
    return info, pk, vk, launches


def phase_prove_setup(pk, vk, curve, device, pooled: dict, save_dir: str | None,
                      config3: bool = False):
    """Prove the setup's circuit from its key through `prove(pk, circuit,
    rng)` as `setup_config` says (configuration 3: a warm prove from
    random.Random(5), then the timed prove from random.Random(1)); the host
    pairing check must pass with the circuit's public input. Its stage
    times beside `pooled`, those of prove_full on the synthetic key of
    pooled tables. With `save_dir`, the key goes there (`ProvingKey.save`,
    as `pk.npz`, kept for dist_prove), is read back on the card
    (`ProvingKey.load`) and must prove the same proof from the same rng.
    -> (phase info, the proof)."""
    import torch

    from snark_tpu_torch.groth16 import Groth16, ProvingKey

    cfg = setup_config(pk.num_constraints, config3)
    circuit = cfg["circuit"]
    g16 = Groth16(curve, device=device)
    g16.ntt_plan(pk.domain_size)
    info = {"curve": curve.name, "config": cfg["config"]}
    if cfg["warm_seed"] is not None:
        t = time.time()
        g16.prove(pk, circuit, random.Random(cfg["warm_seed"]))
        info["warm_prove_seconds"] = round(time.time() - t, 3)
        info["warm_stage_ms"] = {k: round(v, 3) for k, v in g16.last_run.stage_ms.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the key, and what the smoke holds already
    t = time.time()
    proof = g16.prove(pk, circuit, random.Random(cfg["prove_seed"]))
    prove_s = time.time() - t
    stages = g16.last_run.stage_ms
    t = time.time()
    if not g16.verify(vk, cfg["public"], proof):
        raise AssertionError(f"the {curve.name} proof from the setup's key does not verify")
    info.update({
        "prove_rng": f"random.Random({cfg['prove_seed']})", "public_input": cfg["public"],
        "prove_seconds": round(prove_s, 3), "verifies": True,
        "verify_seconds": round(time.time() - t, 3),
        "synthesize_ms": round(stages["synthesize"], 3),
        "stage_ms": {k: round(v, 3) for k, v in stages.items()},
        "pooled_stage_ms": pooled,
        "max_memory_allocated": torch.cuda.max_memory_allocated(), "held_before": held,
        "prove_peak_bytes": torch.cuda.max_memory_allocated() - held,
    })
    if save_dir is not None:
        path = os.path.join(save_dir, "pk.npz")
        t = time.time()
        pk.save(path)
        save_s, size = time.time() - t, os.path.getsize(path)
        t = time.time()
        loaded = ProvingKey.load(path, device=device)
        load_s = time.time() - t
        if g16.prove(loaded, circuit, random.Random(cfg["prove_seed"])) != proof:
            raise AssertionError("the reloaded key proves another proof")
        info["save_round_trip"] = {"equal_proof": True, "file_bytes": size,
                                   "save_seconds": round(save_s, 3),
                                   "load_seconds": round(load_s, 3)}
    return info, proof


def phase_batch_config5(device, smi: str):
    """The reference's configuration 5 at BATCH_PROOFS proofs of MulChain(s,
    2^BATCH_LOG_N − 64, batch=True) through `run_configs` (`config5_setup`:
    the key of circuit 0 from random.Random(0), the (r, s) pairs from
    random.Random(1); `config5_loop`: a warm prove, then the proves with the
    witness prefetch; `config5_batch`: a warm batch of one, then the same
    circuits and pairs through `BatchProver.prove_batch`; each sets the
    launch counters and the peak memory to 0 after its warm run). Every
    batch proof must equal the loop's at its index, the first four must
    verify, and K18 must have launched 5 a proof in the batch. -> (phase
    info, the batch's launch counts, the configuration's run, the batch's
    proofs)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch import run_configs as RC

    run = RC.config5_setup(BATCH_PROOFS, BATCH_LOG_N, device)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # the key, and what the smoke holds already
    loop_proofs, loop_s = RC.config5_loop(run)
    loop_peak = torch.cuda.max_memory_allocated()
    B = BATCH_PROOFS
    proofs, batch_s, bp = RC.config5_batch(run)
    launches = dict(_native.LAUNCHES)
    batch_peak = torch.cuda.max_memory_allocated()
    k18 = {g: launches[_native.counter_name("horner_combine", "bn254", g)] for g in ("g1", "g2")}
    if k18 != {"g1": 4 * B, "g2": B}:
        raise AssertionError(f"the batch of {B} launched K18 {k18} times")
    path = [_native.counter_name(k, "bn254", g) for k in ("bucket_madd_rows", "masked_add")
            for g in ("g1", "g2")] + ["ntt_pass", "field_ew"]
    if not all(launches[k] for k in path):
        raise AssertionError(f"the batch launched none of {[k for k in path if not launches[k]]}")
    differ = [i for i, (a, b) in enumerate(zip(proofs, loop_proofs)) if a != b]
    if len(proofs) != len(loop_proofs) or differ:
        raise AssertionError(f"BatchProver's proofs {differ} differ from the loop's")
    t = time.time()
    if not RC.verify_sample(run, proofs):
        raise AssertionError("a sampled configuration-5 proof does not verify")
    info = {
        "config": 5, "curve": "bn254", "constraints": (1 << BATCH_LOG_N) - 64,
        "m": run.pk.num_instance + run.pk.num_witness, "domain": run.pk.domain_size,
        "nvidia_smi": smi, "setup_seconds": round(run.setup_s, 3),
        "loop": {"proofs": B, "wall_s": round(loop_s, 3),
                 "proofs_per_s": round(B / loop_s, 4),
                 "max_memory_allocated": loop_peak, "peak_bytes": loop_peak - held},
        "batch_prover": {"proofs": B, "wall_s": round(batch_s, 3),
                         "proofs_per_s": round(B / batch_s, 4),
                         "stage_ms": {k: round(v, 3) for k, v in bp.last_run.stage_ms.items()},
                         "device_ms": {k: round(v, 3) for k, v in bp.last_run.device_ms.items()},
                         "max_memory_allocated": batch_peak, "peak_bytes": batch_peak - held},
        "held_before": held, "k18_launches": k18, "proofs_equal": True,
        "verified_sample": 4, "verify_seconds": round(time.time() - t, 3),
        "launches": {k: v for k, v in launches.items() if v},
    }
    return info, launches, run, proofs


def path_launches(launches: dict) -> dict:
    """The BN254 K1-K4 counts of a run: the kernels of the prove's path."""
    from snark_tpu_torch import _native

    names = [_native.counter_name(k, "bn254", g) for k in ("bucket_madd_rows", "masked_add")
             for g in ("g1", "g2")] + ["ntt_pass", "field_ew"]
    return {k: launches.get(k, 0) for k in names}


def phase_dist_prove(key_path: str, vk, single, smi: str) -> tuple[dict, dict]:
    """The distributed prove (`DistPlaneProver`) of setup_full's key, saved
    by prove_setup and loaded by every rank on the CPU, of its circuit from
    random.Random(2024), in a world of each of DIST_RANKS ranks on the card
    (`run_ranks`: NCCL at one rank; gloo at two, both on the one card, the
    exchanges staged through the host), after a warm prove. Gate: every
    rank's proof equals prove_setup's and verifies, and every rank launched
    K1-K4. Per rank: the stage times (each ending in a synchronise; the
    window sums split into accumulate, exchange, fold, gather), the bytes
    it sent in each kind of collective, its peak device memory and its
    launches. -> (phase info, {ranks: the launches of rank 0 of that world})."""
    from snark_tpu_torch.fields.params import BN254
    from snark_tpu_torch.groth16 import Groth16
    from snark_tpu_torch.parallel.launch import run_ranks
    from snark_tpu_torch.parallel.plane_dist import prove_from_file

    cfg = setup_config(FULL_N, False)
    g16 = Groth16(BN254, device="cpu")
    pvk = g16.process_vk(vk)
    worlds, launches = [], {}
    for ranks in DIST_RANKS:
        t = time.time()
        res = run_ranks(prove_from_file, ranks, "cuda", key_path, cfg["circuit"], "cuda", "tp",
                        cfg["prove_seed"], None, None, True, timeout_s=DIST_TIMEOUT_S)
        wall = time.time() - t
        for out in res:
            if out["proof"] != single:
                raise AssertionError(f"rank {out['rank']} of {ranks} proves another proof")
            if not g16.verify_with_processed_vk(pvk, cfg["public"], out["proof"]):
                raise AssertionError(f"rank {out['rank']} of {ranks}: the proof does not verify")
            missing = [k for k, v in path_launches(out["launches"]).items() if not v]
            if missing:
                raise AssertionError(f"rank {out['rank']} of {ranks} did not launch {missing}")
        launches[ranks] = res[0]["launches"]
        worlds.append({
            "ranks": ranks, "backend": res[0]["backend"], "wall_s": round(wall, 3),
            "n1": res[0]["n1"], "n2": res[0]["n2"], "c": res[0]["c"],
            "block_path": res[0]["block_path"], "equal_to_single": True, "verifies": True,
            "per_rank": [{
                "rank": out["rank"], "device": out["device"],
                "stage_ms": {k: round(v, 3) for k, v in out["stage_ms"].items()},
                "total_ms": round(sum(out["stage_ms"].values()), 3),
                "sent_bytes": out["sent_bytes"], "load_ms": round(out["load_ms"], 3),
                "init_ms": round(out["init_ms"], 3),
                "max_memory_allocated": out["max_memory_allocated"],
                "launches": path_launches(out["launches"]),
            } for out in res],
        })
    return {"nvidia_smi": smi, "circuit": f"MulChain({FULL_SEED}, {FULL_N})",
            "prove_rng": f"random.Random({cfg['prove_seed']})", "worlds": worlds}, launches


def phase_batch_dp(run, batch_proofs: list, key_dir: str, smi: str) -> tuple[dict, dict]:
    """`BatchProver` on a (dp, tp) = BATCH_DP_MESH mesh of two ranks on the
    card over the first BATCH_DP_PROOFS circuits and (r, s) pairs of
    batch_config5, under its key (saved without its query arrays, loaded
    by each rank on the card). Gate: every rank returns every proof, each
    equal to the one-device batch's; K18 launched 5 times a proof of a
    rank's share. -> (phase info, rank 0's launches)."""
    import dataclasses

    from snark_tpu_torch import _native
    from snark_tpu_torch.parallel.batch import batch_from_file
    from snark_tpu_torch.parallel.launch import run_ranks

    path = os.path.join(key_dir, "pk_config5.npz")
    t = time.time()
    dataclasses.replace(run.pk, queries={}, file_queries=frozenset(), path=None).save(path)
    save_s = time.time() - t
    B = BATCH_DP_PROOFS
    ranks = BATCH_DP_MESH[0] * BATCH_DP_MESH[1]
    t = time.time()
    res = run_ranks(batch_from_file, ranks, "cuda", path, run.circuits[:B], run.rs[:B],
                    BATCH_DP_MESH, ("dp", "tp"), "dp", "cuda", False, timeout_s=DIST_TIMEOUT_S)
    wall = time.time() - t
    k18 = [_native.counter_name("horner_combine", "bn254", g) for g in ("g1", "g2")]
    for out in res:
        if out["proofs"] != batch_proofs[:B]:
            raise AssertionError(f"rank {out['rank']}'s batch differs from the one-device batch")
        share = len(out["share"])
        if [out["launches"].get(k, 0) for k in k18] != [4 * share, share]:
            raise AssertionError(f"rank {out['rank']} launched K18 {out['launches']}")
    return {"nvidia_smi": smi, "mesh": dict(zip(("dp", "tp"), BATCH_DP_MESH)), "proofs": B,
            "backend": res[0]["backend"], "key_save_seconds": round(save_s, 3),
            "wall_s": round(wall, 3), "equal_to_batch_config5": True,
            "per_rank": [{
                "rank": out["rank"], "share": out["share"],
                "stage_ms": {k: round(v, 3) for k, v in out["stage_ms"].items()},
                "device_ms": {k: round(v, 3) for k, v in out["device_ms"].items()},
                "sent_bytes": out["sent_bytes"],
                "max_memory_allocated": out["max_memory_allocated"],
                "k18_launches": {k: out["launches"].get(k, 0) for k in k18},
            } for out in res]}, res[0]["launches"]


def phase_config4(smi: str) -> dict:
    """`run_configs` configuration 4 at CONFIG4_LOG_N in a world of one rank
    (NCCL) and a world of two on the card (gloo): its line, whose results
    must be equal."""
    from snark_tpu_torch import run_configs as RC

    rec = RC.config4(CONFIG4_LOG_N, 2, "cuda")
    if rec["equal"] is not True or (rec["backend_1dev"], rec["backend"]) != ("nccl", "gloo"):
        raise AssertionError(f"configuration 4: {rec}")
    return {"nvidia_smi": smi, **rec}


def phase_dryrun(smi: str) -> dict:
    """`dryrun_multichip(2, "cuda")` at its default log_n of 10: the
    distributed prove on two ranks verifies on every rank, then the
    dp-sharded h pipeline."""
    from snark_tpu_torch.dryrun import dryrun_multichip

    rec = dryrun_multichip(2, "cuda")
    if rec["verified"] is not True:
        raise AssertionError(f"the dry run: {rec}")
    return {"nvidia_smi": smi, **rec}


# ---------------------------------------------------------------------------
# the legacy device API and configuration 4's single-card modules
# ---------------------------------------------------------------------------


def random_words(field, n: int, seed: int):
    """(n, L) int32 canonical words below the field's p, drawn with numpy:
    any canonical value is some element's Montgomery form."""
    import numpy as np

    from snark_tpu_torch.fields.limbs import u32_tensor

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, (n, field.limbs), dtype=np.uint64)
    w[:, -1] = rng.integers(0, field.p >> (32 * (field.limbs - 1)), n)
    return u32_tensor(w.astype(np.uint32), "cpu")


def legacy_pool_case(curve, group: str, log_n: int, seed: int, device):
    """The legacy MSM's inputs at 2^log_n points: the MSM bench's pool of 64
    distinct points tiled, packed in the legacy layout on the card; uniform
    scalars below r as 16-bit limbs (numpy, drawn with numpy); the exact
    oracle Σ_j pool_j·(Σ_{i ≡ j mod 64} s_i). -> (ops, points, limbs,
    oracle)."""
    import numpy as np

    from snark_tpu_torch.bench import host_curve
    from snark_tpu_torch.ops.curve_u32 import get_g1_ops, get_g2_ops

    ops = (get_g1_ops if group == "g1" else get_g2_ops)(curve, device)
    hc = host_curve(group, curve)
    pool = [hc.scalar_mul(hc.generator, k + 1) for k in range(POOL)]
    n = 1 << log_n
    points = ops.pack_affine_host(pool).repeat(n // POOL, 1, 1)
    L, r = curve.fr.num_limbs, curve.fr.modulus
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, (n, L), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, r >> (16 * (L - 1)), n)
    sums = limbs.reshape(n // POOL, POOL, L).sum(axis=0)
    agg = [sum(int(v) << (16 * k) for k, v in enumerate(row)) % r for row in sums]
    return ops, points, limbs.astype(np.uint32), hc.msm(pool, agg)


def legacy_curve_case(curve, group: str, device):
    """LEGACY_LANES lanes of the legacy layout: 62 distinct multiples of the
    generator, the identity and the negation of the first, tiled; q is p
    rolled by one lane (sums meet doublings, inverses, the identity).
    -> (ops, p, q, the host points of the first 64 lanes)."""
    import torch

    from snark_tpu_torch.bench import host_curve
    from snark_tpu_torch.ops.curve_u32 import get_g1_ops, get_g2_ops

    ops = (get_g1_ops if group == "g1" else get_g2_ops)(curve, device)
    hc = host_curve(group, curve)
    pts = [hc.scalar_mul(hc.generator, 3 * k + 1) for k in range(62)]
    pts += [None, hc.neg(pts[0])]
    p = ops.pack_affine_host(pts).repeat(LEGACY_LANES // 64, 1, 1)
    return ops, p, torch.roll(p, 1, 0).contiguous(), pts


def phase_legacy_u32(smi: str, device) -> tuple[dict, dict]:
    """The legacy device API (`ops/curve_u32.py`, `msm_u32.py`,
    `ntt_u32.py`, `WitnessMapPlan`) on the card. The path,
    driven once between a reset and a read of the launch counts: CurveOps
    add (K2 `point_add`) and double (K5) at LEGACY_LANES lanes in both groups
    of both curves and scalar_mul_const; the legacy `msm` (K2 `masked_add`
    bucket steps and scans, one K18) at LEGACY_MSM_LOG_N points of BN254 G1
    and G2 (c = pick_window(n)); `FixedBasePlan` (K2 `point_add`) on
    LEGACY_FIXED_BASE_N scalars; `NttPlan`'s four transforms (K3 through
    `ntt_rows`, K4) at each of LEGACY_NTT_LOG_N; the reference's
    small-circuit prove of MulChain(9, SMALL_N) (m = 2046, the largest
    below 2048 variables) on both curves, composed from the legacy API by
    `tests/test_torch_prove_small.py` `legacy_sums` (WitnessMapPlan h on
    K4 and K3, five `msm_host_combine`s on K2). Gate: each of LEGACY_GATE
    launched. Then, outside the count: every output against its plain
    version on the card (exact) or the oracle (the MSMs' pool, host
    points), their times (CUDA events), the small sums and h equal to the
    plane prove's and their proof verified, and
    `sharded_msm` and `DistNttPlan` in a world of one rank (NCCL) and of two
    (gloo) against the one-device legacy API. -> (phase info, the path's
    launches)."""
    import numpy as np
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch.bench import host_curve
    from snark_tpu_torch.fields.limbs import FR
    from snark_tpu_torch.fields.params import BLS12_381, BN254
    from snark_tpu_torch.groth16 import Groth16, assemble_proof
    from snark_tpu_torch.groth16.groth16 import synthesize_witness
    from snark_tpu_torch.models import MulChainCircuit
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops import msm_u32 as MU
    from snark_tpu_torch.ops import ntt as N
    from snark_tpu_torch.ops.fixed_base import table_walk
    from snark_tpu_torch.ops.msm import pick_window, scalars_to_digits
    from snark_tpu_torch.ops.ntt_u32 import get_ntt_plan
    from snark_tpu_torch.parallel import dist_msm as DM
    from snark_tpu_torch.parallel import dist_ntt as DN
    from snark_tpu_torch.parallel.launch import run_each, run_ranks

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_prove_small import legacy_sums

    info = {"nvidia_smi": smi}
    # inputs, made before the counts
    curves = [(cv, g) for cv in (BN254, BLS12_381) for g in ("g1", "g2")]
    cases = {(cv.name, g): legacy_curve_case(cv, g, device) for cv, g in curves}
    msms = {g: legacy_pool_case(BN254, g, LEGACY_MSM_LOG_N[g], 20 + i, device)
            for i, g in enumerate(LEGACY_MSM_LOG_N)}
    plans = {log_n: get_ntt_plan(BN254.fr, 1 << log_n, device=device) for log_n in LEGACY_NTT_LOG_N}
    xs = {log_n: plans[log_n].df.from_words(random_words(FR, 1 << log_n, log_n)).to(device)
          for log_n in LEGACY_NTT_LOG_N}
    g1 = cases[("bn254", "g1")][0]
    fb = MU.FixedBasePlan(g1, 8)
    hc1 = host_curve("g1", BN254)
    fb_table = fb.make_table(hc1.generator, hc1, BN254.fr.num_bits, g1.pack_affine_host)
    fb_limbs = msms["g1"][2][:LEGACY_FIXED_BASE_N]
    fb_digits = scalars_to_digits(fb_limbs, 8, BN254.fr.num_bits)
    small = []
    for curve in (BN254, BLS12_381):
        g16 = Groth16(curve, device=device)
        circuit = MulChainCircuit(seed=9, n=SMALL_N, batch=True)
        pk, vk = g16.circuit_specific_setup(circuit, random.Random(9))
        small.append((curve, g16, circuit, pk, vk, synthesize_witness(circuit, curve)))
    torch.cuda.synchronize()

    # the path, counted
    _native.reset_launches()
    t = time.time()
    curve_out = {k: (ops.add(p, q), ops.double(p)) for k, (ops, p, q, _) in cases.items()}
    smc = g1.scalar_mul_const(cases[("bn254", "g1")][1][:1], (1 << 200) + 12345)
    msm_out, msm_run = {}, {}
    for g, (ops, pts, limbs, _) in msms.items():
        before = dict(_native.LAUNCHES)
        torch.cuda.synchronize()
        t_msm = time.time()
        msm_out[g] = MU.msm(ops, pts, limbs, BN254.fr.num_bits)
        torch.cuda.synchronize()
        msm_run[g] = {"s": round(time.time() - t_msm, 3), "launches": {
            k: v - before.get(k, 0) for k, v in _native.LAUNCHES.items() if v != before.get(k, 0)}}
    ntt_out = {log_n: {name: getattr(plans[log_n], name)(xs[log_n])
                       for name in ("fft", "ifft", "coset_fft", "coset_ifft")}
               for log_n in LEGACY_NTT_LOG_N}
    fb_out = fb(fb_table, fb_digits)
    small_out, small_s = [], []
    for _, g16, _, pk, _, z in small:
        torch.cuda.synchronize()
        t_small = time.time()
        small_out.append(legacy_sums(g16, pk, z))
        small_s.append(round(time.time() - t_small, 3))
    torch.cuda.synchronize()
    info["path_s"] = round(time.time() - t, 3)
    legacy = {k: v for k, v in _native.LAUNCHES.items() if v}
    missing = [k for k in LEGACY_GATE if not legacy.get(k)]
    if missing:
        raise AssertionError(f"legacy_u32: the path did not launch {missing}: {legacy}")

    # against the plain versions and the oracles, outside the count
    curve_rows = []
    for (cname, group), (ops, p, q, pts) in cases.items():
        cv = BN254 if cname == "bn254" else BLS12_381
        s, d = curve_out[(cname, group)]
        pw, qw = ops.to_kernel(p), ops.to_kernel(q)
        (add_plain, add_pms) = plain_time(lambda: C.point_add_plain(pw, qw, group, cv))
        (dbl_plain, dbl_pms) = plain_time(lambda: C.point_double_plain(pw, group, cv))
        err = max(max_abs_err(s, ops.from_kernel(add_plain, (LEGACY_LANES,))),
                  max_abs_err(d, ops.from_kernel(dbl_plain, (LEGACY_LANES,))))
        hc = host_curve(group, cv)
        if ops.to_affine_host(s[:64]) != [hc.add(a, b) for a, b in zip(pts, pts[-1:] + pts[:-1])]:
            raise AssertionError(f"legacy_u32 {cname} {group}: add differs from the host")
        if ops.to_affine_host(d[:64]) != [hc.double(a) for a in pts]:
            raise AssertionError(f"legacy_u32 {cname} {group}: double differs from the host")
        curve_rows.append({"curve": cname, "group": group, "lanes": LEGACY_LANES,
                           "max_abs_err": err, "add_ms": cuda_ms(lambda: ops.add(p, q), reps=10),
                           "add_plain_ms": add_pms,
                           "double_ms": cuda_ms(lambda: ops.double(p), reps=10),
                           "double_plain_ms": dbl_pms})
    info["curve_ops"] = curve_rows
    if g1.to_affine_host(smc) != [hc1.scalar_mul(hc1.generator, (1 << 200) + 12345)]:
        raise AssertionError("legacy_u32: scalar_mul_const differs from the host")

    msm_rows = []
    for g, (ops, pts, limbs, want) in msms.items():
        if ops.to_affine_host(msm_out[g][None]) != [want]:
            raise AssertionError(f"legacy_u32: the legacy msm in BN254 {g} differs from the pool")
        n = pts.shape[0]
        c = pick_window(n)
        wc = MU.memory_aware_window_chunk(n, ops.K)
        W = -(-BN254.fr.num_bits // c)
        # one run, in the path above: its top window holds 2 of c bits, so
        # its few buckets take about n/3 points each, and the bucket loop
        # as many K2 steps (the reference's while loop runs as long)
        msm_rows.append({"group": g, "points": n, "c": c, "windows": W,
                         "window_chunk": wc if wc < W else None, "equal_to_pool_oracle": True,
                         "s": msm_run[g]["s"], "launches_per_msm": msm_run[g]["launches"]})
    info["msm"] = msm_rows

    ntt_rows = []
    for log_n in LEGACY_NTT_LOG_N:
        plan, x = plans[log_n], xs[log_n]
        n = 1 << log_n
        xw = plan.df.to_words(x).contiguous()
        want = {
            "fft": lambda: N.ntt_rows_plain(xw, n, plan.fwd_tw),
            "ifft": lambda: N.ntt_rows_plain(xw, n, plan.inv_tw, plan.n_inv),
            "coset_fft": lambda: N.ntt_rows_plain(
                N.field_ew_plain("mul", xw, plan.coset_scale), n, plan.fwd_tw),
            "coset_ifft": lambda: N.field_ew_plain(
                "mul", N.ntt_rows_plain(xw, n, plan.inv_tw), plan.coset_unscale_n),
        }
        for name, fn in want.items():
            ref, pms = plain_time(fn)
            err = max_abs_err(plan.df.to_words(ntt_out[log_n][name]), ref)
            ntt_rows.append({"n": n, "transform": name, "max_abs_err": err, "plain_ms": pms,
                             "ms": cuda_ms(lambda: getattr(plan, name)(x), reps=5)})
    info["ntt"] = ntt_rows

    pts = g1.to_kernel(fb_table.reshape(-1, 3, g1.K))
    d = torch.as_tensor(fb_digits.astype(np.int64), device=device)
    ref, pms = plain_time(lambda: table_walk(pts, d, 8, "g1", BN254, add=C.point_add_plain))
    err = max_abs_err(g1.to_kernel(fb_out), ref)
    scalars = [sum(int(v) << (16 * k) for k, v in enumerate(row)) for row in fb_limbs[:16]]
    if g1.to_affine_host(fb_out[:16]) != [hc1.scalar_mul(hc1.generator, s) for s in scalars]:
        raise AssertionError("legacy_u32: FixedBasePlan differs from the host")
    info["fixed_base"] = {"scalars": LEGACY_FIXED_BASE_N, "c": 8, "max_abs_err": err,
                          "ms": cuda_ms(lambda: fb(fb_table, fb_digits), reps=3), "plain_ms": pms}

    small_rows = []
    for (curve, g16, circuit, pk, vk, _), (sums, h), secs in zip(small, small_out, small_s):
        plane = g16.prove(pk, circuit, r=11, s=12)
        run = g16.last_run
        if run.sums != sums or not torch.equal(run.h_std, h):
            raise AssertionError(
                f"legacy_u32: the {curve.name} legacy sums differ from the plane's")
        proof = assemble_proof(g16, pk, sums["A"], sums["B"], sums["B1"], sums["L"], sums["H"],
                               11, 12)
        if proof != plane or not g16.verify(vk, [9], proof):
            raise AssertionError(f"legacy_u32: the {curve.name} legacy proof does not verify")
        small_rows.append({"curve": curve.name, "circuit": f"MulChain(9, {SMALL_N})",
                           "m": pk.num_instance + pk.num_witness, "legacy_s": secs,
                           "equal_to_plane": True, "verified": True,
                           "plane_stage_ms": {k: round(v, 3) for k, v in run.stage_ms.items()}})
    info["small_prove"] = small_rows

    # sharded_msm and DistNttPlan in a world of one rank and of two
    dops, dpts, dlimbs, dwant = legacy_pool_case(BN254, "g1", LEGACY_DIST_MSM_LOG_N, 30, "cpu")
    ddigits = scalars_to_digits(dlimbs, LEGACY_DIST_C, BN254.fr.num_bits)
    n1, n2 = LEGACY_DIST_NTT
    dplan = get_ntt_plan(BN254.fr, n1 * n2, device=device)
    dx = dplan.df.from_words(random_words(FR, n1 * n2, 31))
    dist_want = {k: getattr(dplan, k)(dx.to(device)).cpu() for k in ("fft", "coset_fft")}
    worlds = []
    for ranks in (1, 2):
        t = time.time()
        res = run_ranks(run_each, ranks, "cuda",
                        (DM.dist_sharded_msm, (dops.to_numpy(dpts), ddigits, LEGACY_DIST_C, "g1",
                                               "bn254", "cuda")),
                        (DN.dist_legacy_transforms, (dx.numpy(), n1, n2, "bn254", "cuda")),
                        timeout_s=DIST_TIMEOUT_S)
        for total, _ in res:
            if dops.to_affine_host(total[None]) != [dwant]:
                raise AssertionError(f"legacy_u32: sharded_msm at {ranks} ranks differs")
        shards = {k: torch.as_tensor(np.concatenate([r[1][k] for r in res])) for k in res[0][1]}
        for k, v in dist_want.items():
            max_abs_err(shards[k], v)
        max_abs_err(shards["ifft"], dx)
        max_abs_err(shards["coset_ifft"], dx)
        worlds.append({"ranks": ranks, "wall_s": round(time.time() - t, 3), "equal": True})
    info["dist"] = {"msm_points": 1 << LEGACY_DIST_MSM_LOG_N, "c": LEGACY_DIST_C,
                    "ntt": {"n1": n1, "n2": n2}, "worlds": worlds}
    info["launches"] = legacy
    return info, legacy


def phase_config4_e2e(smi: str) -> dict:
    """`snark_tpu_torch.config4_e2e` at CONFIG4_E2E_LOG_N: the setup, the cold
    and the warm prove and the verify of MulChain(4, 2^log_n − 64); its stage
    lines and its record. Gate: the proof verifies."""
    from snark_tpu_torch import config4_e2e

    lines = []
    rec = config4_e2e.run(CONFIG4_E2E_LOG_N, device="cuda", emit=lines.append)
    if rec.get("verified") is not True:
        raise AssertionError(f"config4_e2e: {rec}")
    return {"nvidia_smi": smi, "stages": lines, **rec}


def phase_config4_shards(smi: str) -> dict:
    """`snark_tpu_torch.config4_shards` at CONFIG4_SHARDS (log n, modelled
    cards): the shard MSM against the pool oracle, the local NTT stage's
    first row against its plain version."""
    from snark_tpu_torch import config4_shards

    rec = config4_shards.run(*CONFIG4_SHARDS, device="cuda")
    if not (rec["msm_correct"] and rec["ntt_correct"]):
        raise AssertionError(f"config4_shards: {rec}")
    return {"nvidia_smi": smi, **rec}


def phase_configs(device) -> dict:
    """Configurations 1 and 2 through `run_configs` (2: BN254 2^16 − 64,
    the setup from random.Random(0), a warm prove from random.Random(5), the
    prove from random.Random(1)); configuration 2's proof must verify."""
    from snark_tpu_torch import run_configs as RC

    c1, c2 = RC.config1(), RC.config2(device)
    if c1["satisfied"] is not True or c2["verified"] is not True:
        raise AssertionError(f"configurations 1, 2: {c1}, {c2}")
    return {"config1": c1, "config2": c2}


def phase_msm_bench(inputs: dict, smi: str, unsigned: bool = True) -> tuple[dict, dict]:
    """`snark_tpu_torch.bench` runs on the inputs' curve, each exact against
    the pool oracle: G1 and G2 signed, scan and affine, and (`unsigned`) G1
    unsigned with the scan. -> (phase info, launch counts of the whole
    phase)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch import bench as B

    runs = [("g1", True, False), ("g1", True, True), ("g2", True, False), ("g2", True, True)]
    runs += [("g1", False, False)] if unsigned else []
    total = dict.fromkeys(_native.LAUNCHES, 0)
    out = []
    for group, signed, affine in runs:
        inp = inputs[group] if signed else B.make_inputs(
            BENCH_LOG_N[group], signed=False, group=group, device=inputs[group].table.device,
            curve=inputs[group].curve)
        _native.reset_launches()
        rec = B.run(inp, affine=affine, iters=2)
        launches = {k: v for k, v in _native.LAUNCHES.items() if v}
        for k, v in launches.items():
            total[k] += v
        d = rec["detail"]
        if not d["correct"]:
            raise AssertionError(
                f"msm_bench {d['curve']} signed={signed} affine={affine}: wrong result")
        if affine and not d["affine_engaged"]:
            raise AssertionError("msm_bench: the affine tree did not engage")
        d["launches"] = launches
        d["nvidia_smi"] = smi
        out.append(rec)
        print(json.dumps({"msm_bench": rec}), flush=True)
        del inp
        torch.cuda.empty_cache()
    return {"runs": len(out), "all_correct": True}, total


def phase_bench_field(smi: str) -> tuple[dict, dict]:
    """bench_field's five lines at 2^20 on both scalar fields, each exact
    against the host oracle. -> (phase info, launch counts per field)."""
    from snark_tpu_torch import _native
    from snark_tpu_torch import bench_field as BF
    from snark_tpu_torch.fields.params import BLS12_381, BN254

    info, launches = {"nvidia_smi": smi}, {}
    for params in (BN254.fr, BLS12_381.fr):
        _native.reset_launches()
        res = BF.run(BENCH_FIELD_LOG_N, field=params)
        launches.update({k: v for k, v in _native.LAUNCHES.items() if v})
        if not res["correct"]:
            bad = [(r["impl"], r["threads"]) for r in res["lines"] if not r["correct"]]
            raise AssertionError(f"bench_field {params.name}: lines differ from the oracle: {bad}")
        info[params.name] = res
    return info, launches


def phase_bench_vpu_peak(smi: str, device) -> tuple[dict, list[dict]]:
    """bench_vpu_peak's five lines at the script's shapes, every line
    correct; then K12-K15 against their plain versions at the lines' shapes,
    each row's launches from the bench run. -> (phase info, kernel rows)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch import bench_vpu_peak as BV
    from snark_tpu_torch.ops import vpu_peak as V

    _native.reset_launches()
    res = BV.run()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    if not res["correct"]:
        bad = [rec["line"] for rec in res["lines"] if not rec["correct"]]
        raise AssertionError(f"bench_vpu_peak: lines not correct: {bad}")
    lines = {rec["line"]: rec for rec in res["lines"]}
    a, b = (torch.from_numpy(x).to(device) for x in BV.float_inputs(BV.LANES, BV.SEED))
    am, bm = BV.mont_inputs(BV.LANES, device)
    R = BV.REPS
    conv4 = BV.CONV_CHECK_REPS
    src = "snark_tpu_torch/csrc/vpu_peak.cu"
    rows = []
    for line, kernel, fn, plain, tol, replaces in (
        ("fma", "fma_chain", lambda: V.fma_chain(a, b, R["fma"]),
         lambda: V.fma_chain_plain(a, b, R["fma"]), (BV.FMA_RTOL, 0.0),
         "scripts/bench_vpu_peak.py:75"),
        ("sweep", "sweep_chain", lambda: V.sweep_chain(a, R["sweep"]),
         lambda: V.sweep_chain_plain(a, R["sweep"]), None, "scripts/bench_vpu_peak.py:100"),
        ("conv", "conv_chain", lambda: V.conv_chain(a, b, R["conv"]),
         lambda: V.conv_chain_plain(a, b, R["conv"]), (BV.CONV_RTOL_DEEP, BV.CONV_ATOL_DEEP),
         "scripts/bench_vpu_peak.py:128"),
        ("mont_mul", "mont_mul_chain", lambda: V.mont_mul_chain(am, bm, R["mont_mul"]),
         lambda: V.mont_mul_chain_plain(am, bm, R["mont_mul"]), None,
         "scripts/bench_vpu_peak.py:159"),
    ):
        out = fn()
        ref, pms = plain_time(plain)
        err = max_abs_err(out, ref) if tol is None else float_err(out, ref, *tol)
        rec = lines[line]
        row = {
            "name": kernel, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(kernel, 0), "max_abs_err": err, "ms": cuda_ms(fn),
            "plain_ms": pms, "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "reps": rec["reps"], "lanes": rec["lanes"],
            "tolerance": "exact" if tol is None else {"rtol": tol[0], "atol": tol[1]},
        }
        if line == "conv":  # depth 8 all subnormal; depth 4 every value still normal
            row["max_abs_value"] = float(ref.abs().max())
            row["max_abs_err_depth4"] = float_err(
                V.conv_chain(a, b, conv4), V.conv_chain_plain(a, b, conv4), BV.CONV_RTOL, 0.0)
        rows.append(row)
        del out, ref
    info = {"nvidia_smi": smi, "lanes": res["lanes"], "madd_lanes": res["madd_lanes"],
            "threads": res["threads"], "lines": res["lines"], "launches": launches}
    return info, rows


def bench_rows(res: dict, launches: dict, fns: dict, source: str, replaces: str,
               build: dict | None = None) -> list[dict]:
    """One kernel row for each line of a decomposition bench: the kernel
    (fns[line] = (kernel call, plain call)) against its plain version,
    exactly, at the line's shape; launches from the bench run. Each row
    also carries its launch geometry at the line's lanes on this card
    (which must fill every SM), the warps an SM keeps resident (the CUDA
    runtime's occupancy) and, from the build line, its instance's
    registers, spill stores and static FRND count."""
    import torch

    from snark_tpu_torch.ops import mul_parts as MP

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = (build or {}).get("ptxas", {})
    sass = (build or {}).get("sass")
    rows = []
    for rec in res["lines"]:
        fn, plain = fns[rec["line"]]
        out = fn()
        ref, pms = plain_time(plain)
        kind = rec.get("kind", rec["line"])
        geo = MP.launch_geometry(kind, rec["lanes"], rec.get("T", MP.BISECT_T), sms)
        if geo["grid"] < min(sms, geo["tiles"]):
            raise AssertionError(f"{rec['kernel']}: a grid of {geo['grid']} blocks on {sms} SMs")
        template = kernel_template(rec["kernel"])
        ops = sass.get(template, {}) if isinstance(sass, dict) else {}
        rows.append({
            "name": rec["kernel"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(rec["kernel"], 0), "max_abs_err": max_abs_err(out, ref),
            "ms": cuda_ms(fn), "plain_ms": pms, "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "reps": rec["reps"],
            "lanes": rec["lanes"], "tolerance": "exact", "geometry": geo,
            "warps_per_sm": MP.resident_warps(kind),
            "registers": ptxas.get(template, {}).get("registers"),
            "spill_stores": ptxas.get(template, {}).get("spill_stores"),
            "frnd": sum(n for op, n in ops.items() if op.startswith("FRND")) if ops else None,
        })
        del out, ref
    return rows


def phase_bench_reduce_parts(smi: str, device, sass, ptxas=None) -> tuple[dict, list[dict]]:
    """bench_reduce_parts' five lines at the script's shapes, every line
    correct, K16 A equal to C; K16 A's SASS holds HMMA; then K16 against its
    plain version at each line's shape (`bench_rows`; `ptxas` is the build
    line's). -> (phase info, kernel rows)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch import bench_reduce_parts as BR
    from snark_tpu_torch import bench_vpu_peak as BV
    from snark_tpu_torch.ops import mul_parts as MP

    _native.reset_launches()
    res = BR.run()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    if not res["correct"]:
        bad = [rec["line"] for rec in res["lines"] if not rec["correct"]]
        raise AssertionError(f"bench_reduce_parts: lines not correct: {bad}")
    hmma = None
    if isinstance(sass, dict):
        ops = sass.get(f"reduce_parts_chain_kernel<{MP.PARTS_KINDS.index('A')}>", {})
        hmma = sum(n for op, n in ops.items() if op.startswith("HMMA"))
        if not hmma:
            raise AssertionError("K16 A: no HMMA in its SASS")
    am, bm = BV.mont_inputs(BR.LANES, device)
    fns = {rec["line"]: (lambda k=rec["kind"], T=rec["T"]: MP.reduce_parts_chain(am, bm, k, T),
                         lambda k=rec["kind"], T=rec["T"]: MP.reduce_parts_chain_plain(am, bm, k, T))
           for rec in res["lines"]}
    a_equals_c = torch.equal(MP.reduce_parts_chain(am, bm, "A", 512),
                             MP.reduce_parts_chain(am, bm, "C", 512))
    if not a_equals_c:
        raise AssertionError("K16 A differs from K16 C")
    rows = bench_rows(res, launches, fns, "snark_tpu_torch/csrc/mul_parts.cu",
                      "scripts/bench_reduce_parts.py:100", {"sass": sass, "ptxas": ptxas or {}})
    info = {"nvidia_smi": smi, "lanes": res["lanes"], "lines": res["lines"], "launches": launches,
            "a_equals_c": a_equals_c, "hmma_in_sass": hmma}
    return info, rows


def phase_bench_bisect_mul(smi: str, device, sass=None, ptxas=None) -> tuple[dict, list[dict]]:
    """bench_bisect_mul's six lines at the script's shapes, every line
    correct; then K17 against its plain version at each line's shape
    (`bench_rows`; `sass` and `ptxas` are the build line's).
    -> (phase info, kernel rows)."""
    from snark_tpu_torch import _native
    from snark_tpu_torch import bench_bisect_mul as BB
    from snark_tpu_torch import bench_vpu_peak as BV
    from snark_tpu_torch.ops import mul_parts as MP

    _native.reset_launches()
    res = BB.run()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    if not res["correct"]:
        bad = [rec["line"] for rec in res["lines"] if not rec["correct"]]
        raise AssertionError(f"bench_bisect_mul: lines not correct: {bad}")
    am, bm = BV.mont_inputs(BB.LANES, device)
    fns = {k: (lambda k=k: MP.bisect_chain(am, bm, k), lambda k=k: MP.bisect_chain_plain(am, bm, k))
           for k in MP.BISECT_KINDS}
    rows = bench_rows(res, launches, fns, "snark_tpu_torch/csrc/mul_parts.cu",
                      "scripts/bench_bisect_mul.py:98", {"sass": sass, "ptxas": ptxas or {}})
    return {"nvidia_smi": smi, "lanes": res["lanes"], "lines": res["lines"],
            "launches": launches}, rows


def phase_bench_madd_parts(smi: str, device, sass) -> tuple[dict, list[dict]]:
    """K1's parts against their plain versions: over the scan's first
    MIXED_SCAN_STEPS steps at the bench's lanes (and those steps run through
    the part's plain body, step by step), and as whole window sums at a
    small size against the plain pipeline on the CPU; then the bench at its
    full size, `full` correct. -> (phase info, kernel rows, one a part)."""
    import torch

    from snark_tpu_torch import _native
    from snark_tpu_torch import bench as B
    from snark_tpu_torch import bench_madd_parts as BM
    from snark_tpu_torch.ops import curve as C
    from snark_tpu_torch.ops import madd_parts as KP
    from snark_tpu_torch.ops.msm_plane import PlaneMsm

    inp = B.make_inputs(BENCH_LOG_N["g1"], signed=True, c=BM.C_WINDOW, device=device)
    plan = PlaneMsm(BM.C_WINDOW, 254, "g1")
    n = inp.n
    perm, start, length = plan._buckets(inp.digits.t().contiguous())
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    lane_base = i32(torch.arange(plan.lanes, device=device) // plan.nb * n)
    length = i32(plan.spill_plan(length, max(1, n // plan.nb))[0])  # the main scan's runs
    start = i32(start)
    acc0 = C.identity(plan.lanes, "g1", device)
    steps, k = int(length.max()), MIXED_SCAN_STEPS
    adds = int(length.clamp(max=k).sum())  # rows the first k steps add (no identity rows)
    scan_adds = int(length.sum())
    steps_ms = {"full": cuda_ms(lambda: C.bucket_madd_rows(
        acc0, inp.table, perm, lane_base, start, length, 0, k))}
    scan_ms = {"full": cuda_ms(lambda: C.bucket_madd_rows(
        acc0, inp.table, perm, lane_base, start, length, 0, steps))}
    rows = []
    for code, part in enumerate(KP.PARTS):
        if part == "full":
            continue

        def k1(part=part, k_steps=k):
            return KP.bucket_madd_rows_part(
                part, acc0, inp.table, perm, lane_base, start, length, 0, k_steps)

        out = k1()
        ref, pms = plain_time(lambda: KP.bucket_madd_rows_part_plain(
            part, acc0, inp.table, perm, lane_base, start, length, 0, k))
        err = max_abs_err(out, ref)
        stepped = acc0
        for i in range(k):
            x2, y2, mask = scan_step_operands(inp.table, perm, lane_base, start, length, i,
                                              "g1", C.BN254)
            stepped = KP.masked_madd_part_plain(part, stepped, x2, y2, mask)
        max_abs_err(out, stepped)
        steps_ms[part] = cuda_ms(k1)
        scan_ms[part] = cuda_ms(lambda: k1(k_steps=steps))
        b, by = BM.scan_bound(part, adds, plan.lanes)
        template = f"{K1_BN254_G1}, {code}>"
        ops = sass.get(template, {}) if isinstance(sass, dict) else {}
        rows.append({
            "name": BM.kernel_of(part), "route": "cuda",
            "source": "snark_tpu_torch/csrc/madd_parts.cu",
            "replaces": f"scripts/bench_madd_parts.py:{SCRIPT_BODY_LINE[part]}",
            "launches": None, "max_abs_err": err, "ms": steps_ms[part], "plain_ms": pms,
            "bound_ms": b, "bound_by": by, "library_ms": None, "steps": k,
            "lanes": plan.lanes, "tolerance": "exact", "equals_stepped_plain_body": True,
            "scan_ms": scan_ms[part], "scan_bound_ms": BM.scan_bound(part, scan_adds, plan.lanes)[0],
            "sass_instructions": sum(ops.values()) if ops else None,
        })
        del out, ref, stepped
    full_ops = sass.get(f"{K1_BN254_G1}, 0>", {}) if isinstance(sass, dict) else {}
    del acc0, perm, start, length, lane_base
    torch.cuda.empty_cache()

    # each part's whole window sums against the plain pipeline (CPU)
    log_small, c_small = MADD_PARTS_CHECK
    small = B.make_inputs(log_small, signed=True, c=c_small, device="cpu")
    for part in KP.PARTS:
        got = PlaneMsm(c_small, 254, "g1", part=part).window_sums(
            small.table.to(device), small.digits.to(device))
        max_abs_err(got.cpu(), PlaneMsm(c_small, 254, "g1", part=part).window_sums(
            small.table, small.digits))

    # the main path: the bench at its full size
    _native.reset_launches()
    res = BM.run(inputs=inp)
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    if not res["correct"]:
        raise AssertionError("bench_madd_parts: the full line differs from the pool oracle")
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    for rec in res["lines"]:
        print(BM.format_line(rec), flush=True)
    info = {"nvidia_smi": smi, "lines": res["lines"], "launches": launches,
            "steps_ms": steps_ms, "scan_ms": scan_ms, "scan_adds": scan_adds, "steps": steps,
            "window_sums_equal_plain_pipeline": {"log_n": log_small, "c": c_small},
            "k1_full_sass_instructions": sum(full_ops.values()) if full_ops else None}
    return info, rows


# each tool's arguments in the tools phase: reduced sizes, about 10 s each
TOOL_ARGS = (
    ("profile_setup", ["--log-n", "12", "--curve", "bls", "--top", "10"]),
    ("profile_msm", ["--log-n", "16", "--iters", "3"]),
    ("profile_scan_parts", ["--log-n", "16", "--iters", "3"]),
    ("profile_affine_stages", ["--log-n", "16", "--iters", "3"]),
    ("profile_affine_front", ["--log-n", "16", "--iters", "3"]),
    ("profile_prover_msms", ["--log-n", "12", "--iters", "3"]),
    ("bench_affine_msm", ["--log-n", "16", "--iters", "2", "--g2-log-n", "12"]),
    ("bench_scan_overlap", ["--log-table", "18", "--steps", "16"]),
    ("bench_gather", ["--log-table", "18", "--log-m", "14"]),
    ("bench_synth", ["16"]),
)
TOOL_FLAGS = ("correct", "equal", "g2_affine_correct")
EXAMPLE_SYNTH_LOG_N = 14
GEN_VECTORS_FILES = 7  # the committed tests/vectors/*.json the scripts write


def run_tool(name: str, fn, expect: str = "") -> dict:
    """fn() with its standard output captured -> {"tool", "seconds", "rc",
    "records": its JSON lines}; raises on a non-zero exit, a false
    correctness flag or an output without `expect`."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    out = buf.getvalue()
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    line = {"tool": name, "seconds": round(time.time() - t0, 3), "rc": rc, "records": records}
    bad = [f for r in records for f in TOOL_FLAGS if r.get(f) is False]
    if rc not in (0, None) or bad or expect not in out:
        raise AssertionError(f"tool {name}: exit {rc}, false flags {bad}\n{out[-4000:]}")
    print(json.dumps(line), flush=True)
    return line


def phase_tools(smi: str) -> dict:
    """The entry on the card against the CPU, the tools and the examples."""
    import importlib
    import shutil

    from snark_tpu_torch import entry as E
    from snark_tpu_torch import gen_vectors, run_suite
    from snark_tpu_torch.examples import bench_synthesis, non_satisfiable, satisfiable

    t0 = time.time()
    fn, args = E.entry()
    card_sums = E.sums(*fn(*args))
    t_card = time.time() - t0
    fn_cpu, args_cpu = E.entry("cpu")
    if args_cpu != args or E.sums(*fn_cpu(*args_cpu)) != card_sums:
        raise AssertionError("entry: the card's five sums differ from the CPU's")
    info = {"entry": {"equal": True, "card_s": round(t_card, 3),
                      "seconds": round(time.time() - t0, 3)}, "nvidia_smi": smi, "tools": {}}
    print(json.dumps({"tool": "entry", **info["entry"]}), flush=True)
    for name, argv in TOOL_ARGS:
        mod = importlib.import_module(f"snark_tpu_torch.{name}")
        info["tools"][name] = run_tool(name, lambda: mod.main(argv))["seconds"]
    info["tools"]["run_suite"] = run_tool("run_suite", lambda: run_suite.main([
        "--device", "cuda", "--files", "tests/test_torch_gpu.py", "-m", "gpu", "--noconftest",
        "-p", "no:cacheprovider", "-k", "field_ew"]))["seconds"]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_vectors_")
    try:
        line = run_tool("gen_vectors", lambda: gen_vectors.main([out_dir]))
        info["tools"]["gen_vectors"] = line["seconds"]
        files = line["records"][0]["files"]
        if sorted(os.listdir(out_dir)) != files or len(files) != GEN_VECTORS_FILES:
            raise AssertionError(f"gen_vectors wrote {sorted(os.listdir(out_dir))}")
        for fname in files:
            with open(os.path.join(out_dir, fname), "rb") as got, \
                    open(os.path.join(HERE, "tests", "vectors", fname), "rb") as want:
                if got.read() != want.read():
                    raise AssertionError(f"gen_vectors: {fname} differs from the committed file")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for name, fn, expect in (
        ("satisfiable", satisfiable.main, "satisfied:   True"),
        ("non_satisfiable", non_satisfiable.main,
         "Error originated in constraint:\n  0: x^3 + x + 5 == y at "),
        ("bench_synthesis", lambda: bench_synthesis.main([str(EXAMPLE_SYNTH_LOG_N)]),
         "native-engine random-LC"),
    ):
        info["tools"][f"examples.{name}"] = run_tool(f"examples.{name}", fn, expect)["seconds"]
    return info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import snark_tpu_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda")
    t0 = time.time()
    smi = nvidia_smi_line()
    phase_line("device", t0, kind=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print(smi, flush=True)

    t0 = time.time()
    build = phase_build()
    phase_line("build", t0, **build)

    t0 = time.time()
    phase_line("synthesis", t0, **phase_synthesis())

    from snark_tpu_torch import bench as B
    from snark_tpu_torch.fields.params import BLS12_381

    t0 = time.time()
    key = SyntheticKey(FULL_N, seed=1, device=device)
    z = key.z
    z_std = key.fr.tensor(z, device, mont=False)
    inputs = {g: B.make_inputs(BENCH_LOG_N[g], signed=True, c=BENCH_C, group=g, device=device)
              for g in ("g1", "g2")}
    phase_line("setup", t0, constraints=FULL_N, m=len(z), domain=key.pk.domain_size,
               bench_points=BENCH_LOG_N)

    t0 = time.time()
    rows = phase_kernels(key, z_std, device)
    msm_rows, extra = phase_kernels_msm(inputs, device)
    phase_line("kernels", t0, all_equal=True, kernels=rows + msm_rows, **extra)

    t0 = time.time()
    phase_line("prove_fixture", t0, **phase_prove_fixture(device))

    t0 = time.time()
    info, launches, proof = phase_prove_full(key, z, device)
    phase_line("prove_full", t0, **info)

    t0 = time.time()
    info_a, _, proof_a = phase_prove_full(key, z, device, affine_msm=True)
    if proof_a != proof:
        raise AssertionError("the affine prove's proof differs from prove_full's")
    fixture_a = phase_prove_fixture(device, affine_msm=True)
    phase_line("prove_full_affine", t0, equals_prove_full=True, fixture=fixture_a, **info_a)

    t0 = time.time()
    info_s, pk_s, vk_s, setup_launches = phase_setup_full(key.curve, FULL_N, device, smi)
    phase_line("setup_full", t0, **info_s)
    key_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    t0 = time.time()
    info_ps, single = phase_prove_setup(pk_s, vk_s, key.curve, device, info["stage_ms"],
                                        save_dir=key_dir.name)
    phase_line("prove_setup", t0, **info_ps)
    del pk_s
    torch.cuda.empty_cache()

    t0 = time.time()
    info_d, dist_launches = phase_dist_prove(os.path.join(key_dir.name, "pk.npz"), vk_s, single,
                                             smi)
    phase_line("dist_prove", t0, **info_d)
    del vk_s

    t0 = time.time()
    info_c5, batch_launches, run_c5, proofs_c5 = phase_batch_config5(device, smi)
    phase_line("batch_config5", t0, **info_c5)
    torch.cuda.empty_cache()

    t0 = time.time()
    info_bd, batch_dp_launches = phase_batch_dp(run_c5, proofs_c5, key_dir.name, smi)
    phase_line("batch_dp", t0, **info_bd)
    del run_c5, proofs_c5
    key_dir.cleanup()
    torch.cuda.empty_cache()

    t0 = time.time()
    phase_line("configs", t0, **phase_configs(device))
    torch.cuda.empty_cache()

    t0 = time.time()
    phase_line("config4", t0, **phase_config4(smi))

    t0 = time.time()
    phase_line("dryrun", t0, **phase_dryrun(smi))

    t0 = time.time()
    info_l, legacy_launches = phase_legacy_u32(smi, device)
    phase_line("legacy_u32", t0, **info_l)
    torch.cuda.empty_cache()

    t0 = time.time()
    phase_line("config4_e2e", t0, **phase_config4_e2e(smi))
    torch.cuda.empty_cache()

    t0 = time.time()
    phase_line("config4_shards", t0, **phase_config4_shards(smi))
    torch.cuda.empty_cache()

    t0 = time.time()
    info_b, bench_launches = phase_msm_bench(inputs, smi)
    phase_line("msm_bench", t0, **info_b, launches={k: v for k, v in bench_launches.items() if v})

    # BLS12-381, after the BN254 phases and with their data freed, so that
    # those run on the device memory they always had
    del key, z, z_std, inputs
    torch.cuda.empty_cache()
    t0 = time.time()
    key_bls = SyntheticKey(FULL_N_BLS, seed=1, device=device, curve=BLS12_381)
    z_bls = key_bls.z
    z_std_bls = key_bls.fr.tensor(z_bls, device, mont=False)
    inputs_bls = {g: B.make_inputs(BENCH_LOG_N[g], signed=True, c=BENCH_C, group=g,
                                   device=device, curve=BLS12_381) for g in ("g1", "g2")}
    phase_line("setup_bls", t0, constraints=FULL_N_BLS, m=len(z_bls),
               domain=key_bls.pk.domain_size, table_bytes=key_bls.table_bytes(),
               bench_points=BENCH_LOG_N)

    t0 = time.time()
    bls_rows = phase_kernels(key_bls, z_std_bls, device)
    del z_std_bls
    torch.cuda.empty_cache()
    bls_msm_rows, bls_extra = phase_kernels_msm(inputs_bls, device)
    phase_line("kernels_bls", t0, all_equal=True, kernels=bls_rows + bls_msm_rows, **bls_extra)

    t0 = time.time()
    phase_line("prove_fixture_bls", t0, **phase_prove_fixture(device, bls=True))

    t0 = time.time()
    info_bls, launches_bls, proof_bls = phase_prove_full(key_bls, z_bls, device)
    phase_line("prove_full_bls", t0, nvidia_smi=smi, **info_bls)

    t0 = time.time()
    info_bls_a, _, proof_bls_a = phase_prove_full(key_bls, z_bls, device, affine_msm=True)
    if proof_bls_a != proof_bls:
        raise AssertionError("the BLS12-381 affine prove's proof differs from prove_full_bls's")
    if not all(info_bls_a["affine_engaged"].values()):
        raise AssertionError(f"the affine tree did not engage: {info_bls_a['affine_engaged']}")
    phase_line("prove_full_bls_affine", t0, nvidia_smi=smi, equals_prove_full=True, **info_bls_a)
    del key_bls
    torch.cuda.empty_cache()

    t0 = time.time()
    info_sb, pk_sb, vk_sb, setup_launches_bls = phase_setup_full(BLS12_381, FULL_N_BLS, device,
                                                                 smi, config3=True)
    phase_line("setup_full_bls", t0, **info_sb)
    t0 = time.time()
    phase_line("prove_setup_bls", t0, **phase_prove_setup(
        pk_sb, vk_sb, BLS12_381, device, info_bls["stage_ms"], save_dir=None, config3=True)[0])
    del pk_sb, vk_sb, z_bls
    torch.cuda.empty_cache()

    t0 = time.time()
    info_bb, bench_launches_bls = phase_msm_bench(inputs_bls, smi, unsigned=False)
    phase_line("msm_bench_bls", t0, **info_bb,
               launches={k: v for k, v in bench_launches_bls.items() if v})
    del inputs_bls
    torch.cuda.empty_cache()

    t0 = time.time()
    info_f, field_launches = phase_bench_field(smi)
    phase_line("bench_field", t0, **info_f, launches=field_launches)

    t0 = time.time()
    info_v, vpu_rows = phase_bench_vpu_peak(smi, device)
    phase_line("bench_vpu_peak", t0, **info_v)

    t0 = time.time()
    info_r, parts_rows = phase_bench_reduce_parts(smi, device, build["sass"], build["ptxas"])
    phase_line("bench_reduce_parts", t0, **info_r)

    t0 = time.time()
    info_m, bisect_rows = phase_bench_bisect_mul(smi, device, build["sass"], build["ptxas"])
    phase_line("bench_bisect_mul", t0, **info_m)

    t0 = time.time()
    info_k, madd_rows = phase_bench_madd_parts(smi, device, build["sass"])
    phase_line("bench_madd_parts", t0, **info_k)

    t0 = time.time()
    phase_line("tools", t0, **phase_tools(smi))

    # each row's launches from the run of its path: the prove's, the MSM
    # bench's, bench_field's for K9 and K10 (K11's, K12-K17's and K1's
    # parts' were set in their phases)
    for group, counts, setup in ((rows, launches, setup_launches),
                                 (bls_rows, launches_bls, setup_launches_bls),
                                 (msm_rows, bench_launches, setup_launches),
                                 (bls_msm_rows, bench_launches_bls, setup_launches_bls)):
        for row in group:
            if row["launches"] is None:
                path = field_launches if row["name"].startswith("mont_mul16") else counts
                # K7 since K19: the setup's affine codec is its path
                path = setup if row["name"].startswith("affine_tree_mul") else path
                row["launches"] = path.get(row["name"], 0)
    # K18's launches in configuration 5's batch (BN254), beside the bench's,
    # and a rank's in batch_dp
    for row in msm_rows + bls_msm_rows:
        if row["name"].startswith("horner_combine"):
            row["batch_launches"] = batch_launches.get(row["name"], 0)
            row["batch_dp_launches"] = batch_dp_launches.get(row["name"], 0)
    # K1-K4's launches on rank 0 of the two-rank and the one-rank
    # distributed prove (BN254)
    for row in rows:
        if row["name"] in path_launches({}):
            row["dist_launches"] = dist_launches[2].get(row["name"], 0)
            row["dist_one_rank_launches"] = dist_launches[1].get(row["name"], 0)
    # K1's, K4's, K7's and K19's launches in the setups, beside those of their paths
    for group, counts in ((rows + msm_rows, setup_launches),
                          (bls_rows + bls_msm_rows, setup_launches_bls)):
        for row in group:
            if row["name"].startswith(SETUP_KERNELS):
                row["setup_launches"] = counts.get(row["name"], 0)
                if not row["setup_launches"]:
                    raise AssertionError(f"the setup did not launch {row['name']}")
    # K2, K3, K4, K5 and K18's launches on the legacy path (legacy_u32)
    for row in rows + bls_rows + msm_rows + bls_msm_rows:
        if row["name"].startswith(LEGACY_ROW_KERNELS):
            row["legacy_launches"] = legacy_launches.get(row["name"], 0)
    rows = (rows + bls_rows + msm_rows + bls_msm_rows + vpu_rows + parts_rows + bisect_rows
            + madd_rows)
    for row in rows:
        # K5 and K2 unmasked: off the prove since K18, on the legacy path
        off_path = row.get("on_path") is False and row["name"].startswith(OFF_PATH)
        if off_path and not row["legacy_launches"]:
            raise AssertionError(f"{row['name']} was not launched on the legacy path")
        if row["launches"] == 0 and not off_path:
            raise AssertionError(f"{row['name']} was not launched on the main path")
        if row["name"].startswith("affine_batch_inverse"):  # its three kernels
            row["ptxas"] = {ph: build["ptxas"].get(
                kernel_template(row["name"]).replace("_up_", f"_{ph}_"))
                            for ph in ("up", "top", "down")}
        else:
            row["ptxas"] = build["ptxas"].get(kernel_template(row["name"]))
        if row["name"].startswith(("affine_phase1", "affine_phase3")):
            ops = build["sass"].get(kernel_template(row["name"])) if isinstance(
                build["sass"], dict) else None
            row["sass_ops"] = sass_row_ops(ops) if ops else None
        if row["name"].startswith("ntt_pass"):
            row["ptxas_dif"] = build["ptxas"].get(
                kernel_template(row["name"]).replace("false>", "true>"))
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
