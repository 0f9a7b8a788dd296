#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`hefl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout (it imports the port from
the directory it sits in); it imports nothing of JAX or of `hefl_tpu`.
Phases, each of which fails the run (non-zero exit, no result line) on any
error:

  1. Print the card's name and power limit (nvidia-smi), build the kernels
     from `hefl_tpu_torch/csrc/ntt.cu` with nvcc (timed), and print ptxas's
     registers and spills of every `ntt_kernel` instantiation (the build's
     `-Xptxas -v` report), and K6's, with the SASS opcode counts of K6
     (cuobjdump) that fix MAD64_OPS and the pipe mix of K3's instantiation
     at [440, 3, 4096] (bound()'s two-pipe rate).
  2. For each kernel K1-K4 and K7 (forward NTT, inverse NTT, fused
     encrypt, fused decrypt, fused transcipher): call its wrapper on card
     tensors and require it to be BITWISE equal to its plain PyTorch
     version run on the same card tensors, at N=1024 and at every ring
     size of `cuda_ntt.SUPPORTED_N` (N=256..16384) x NTT_CHECK_ROWS (every
     cluster plan of `cuda_ntt.ntt_plan`; K7 on rows // L upload rows of L
     primes); K5 (both modes) at every ring size x KS_CHECK_PRIMES (every
     cluster plan of its digit stage), and K6, checked at N=1024 too, at
     every ring size x HOIST_CHECK_PRIMES at its plan's split Q and at
     every other. (The timed shapes are phase 12's.)
  3. Drive the main path once through the port's entry points: MedCNN at
     full width (256x256x3, 222,722 parameters, random weights from a seed),
     the `medical` synthetic data, 2 clients of 96 images, 2 local epochs,
     the default CKKS ring; keygen, `secure_fedavg_round` (train, encrypt,
     sum mod p), `decrypt_average`, `evaluate`. The kernel launch counts are
     zeroed just before and read just after; K1, K3 and K4 must have run,
     and the decrypted average must sit within 5e-6 of the same program's
     plaintext FedAvg mean (the repo's encrypted-average yardstick). Then
     the wire files (`utils.serialization`): (ctx, pk), sk and the round's
     ciphertext sum saved, loaded back and decrypted: bitwise the
     in-memory decrypt.
  4. Encrypted-inference serving, linear BSGS (the JAX package's
     bench_inference.py configuration): N=4096, L=3, d=512 features, K=10
     classes, 45 Galois keys. One query through `BsgsLinearScorer.score`
     (hoisted) must decrypt within 0.05 of W x + b with the same argmax, be
     bitwise equal to the "unhoisted" scorer's output (one K6 launch at
     S = 1 a baby step, 22) and to the same
     scorer run on CPU copies of the keys and query (the plain versions),
     and launch exactly 23 K5 and 1 K6 (and at least one K1 and one K2).
     Then 16 queries packed 4 per ciphertext through `score_many`, with the
     same error and argmax checks. Warm latency (median, p95 of 20 calls)
     and queries per second for both.
  5. Encrypted-inference serving, depth-2 MLP BSGS: N=8192, L=5, d=64,
     H=16, K=10, two rescales. `BsgsMlpScorer.score` with the same argmax
     as the plaintext circuit and within MLP_ERR_LIMIT of it (see there),
     at least one K5 launch in its eval-input mode (relinearization),
     exactly 2 K6 (one a layer),
     bitwise equal to the unhoisted scorer (one K6 at S = 1 a baby step: 8
     at L=5, 4 at L=3) and to the same scorer on CPU
     copies; warm latency. Phases 4 and 5 also print one warm score's
     device time by kernel (torch.profiler).
  6. The hybrid-HE uplink round (the `hhe-smoke` preset's path at full
     width): MedCNN, synthetic `medical` data, 8 clients of 48 images, 1
     local epoch, `--pack-bits 8 --pack-clip 0.5` (guard 16, so k = 3: 19
     packed rows per client instead of 55), N=4096, L=3, key seed 0.
     (a) `cli.run` with `--hhe` for one round must launch exactly one K7 and
     one K3 (the pads) and at least one K4, with expansion_hhe <= 1.1;
     (b) the client-side upload (`hhe_encrypt_stack`) launches no kernel;
     (c) on ONE set of trained weights, symmetric encrypt -> provision +
     transcipher -> fold in a permuted order with one duplicate redelivery
     -> `decrypt_average(hhe=True)` is BITWISE the direct packed path's
     (`encrypt_stack_packed` -> sum -> decrypt) in its field sums and its
     decoded average, both within `spec.error_budget` of the plaintext
     mean, no saturation — at clip 0.5 (where one epoch's updates all
     quantize to code 0) and at clip 0.02 (where about half do not). Phase
     times (clip 0.5): train, upload, provision + transcipher, fold,
     decrypt, evaluate; the device time of the upload and of provision +
     transcipher by kernel (torch.profiler).
  7. The experiment driver (`experiment.run_experiment`) on BASELINE.json's
     presets at their full width, data and ring, cut in rounds and local
     epochs only (DRIVER_RUNS): (a) medical-8, 2 rounds of 2 epochs; (b)
     medical-8 round 0 with a round checkpoint, whose restored params must
     equal the saved ones bitwise, then resumed to round 1; (c)
     medical-skew (label skew, FedProx), 1 round of 1 epoch; (d) mnist-enc
     and (e) mnist-plain, 1 round of 1 epoch; (f) cifar-resnet16 at full
     width (ResNet-20, 272,474 parameters, 16 clients x 500 images) with
     the fused training backend, 1 round of 2 epochs; (g) medical-8's round
     0 (2 epochs) under the vmap and the fused backend from one seed, whose
     decrypted global models must agree within 2e-2 (each backend's warm
     round profiled: device busy share and top kernels; then what "auto"
     resolves to on this card, with its probe times); (h) fusion-smoke and
     hhe-smoke (N=256) at their own sizes. Each run's launches must be
     exactly K1 twice in keygen and one K3 over all clients' ciphertexts
     and one K4 a round ([440, 3, 4096] and [55, 3, 4096] for the medical
     presets, [110, 3, 4096] for mnist-enc, [1072, 3, 4096] and
     [67, 3, 4096] for cifar-resnet16; hhe-smoke: one K3 and one K7 at
     [2352, 3, 256], one K4 at [294, 3, 256]), none for the plaintext
     presets; every round's encode overflow 0, metrics finite, accuracy in
     [0, 1]; each round of (a), (f) and (g) decrypts within 5e-6 of the
     plaintext mean of the same trained weights. Each run prints its phase
     times and launches.
  8. Robust and private rounds through `run_experiment` at full width
     (`robust_runs`): (i) medical-8 under a fault schedule (2 clients
     dropped, one NaN- and one +1e15-poisoned, stragglers, a device loss on
     round 1's first attempt) with the norm bound and overflow exclusion,
     2 rounds of 1 epoch: each round's exclusions exactly the schedule's
     and the predicates', 4 surviving, one retry on round 1, the decrypt
     within 5e-6 of the masked plaintext mean; beside its unmasked twin and
     the sanitizer's time; (j) medical-8 with DP-FedAvg under 25 % dropout,
     1 round: the noise floor recalibrated to 6, the decrypt within 5e-6 of
     the masked mean of the sanitized weights, the accountant's epsilon,
     and the noise's moments on the card; (k) chaos-smoke (N=256), 4
     rounds: its rounds equal CHAOS_SMOKE.json's surviving, excluded and
     retries, with its clean twin's accuracy beside it. Launches exactly
     as phase 7's rule: masked rounds encrypt every client's rows.
  9. The durable streaming aggregation service through `run_experiment`
     (`stream_runs`): (l) medical-8 at full width streaming under a cohort
     of 4 of 8, quorum 0.75, a 2 s deadline, one retry and the chaos-smoke
     stream faults, 2 rounds x 1 epoch, fused: each round's stream record
     equals what the schedules give (`host_stream_record`), K3 at [220, 3,
     4096], each decrypt within 5e-6 of the released clients' plaintext
     mean, the stream.* counters the sums over the rounds; (m) (l) with
     tau = 1 and a write-ahead journal: the uninterrupted twin, a crash
     mid-append at round 1's 2nd fold, the recovery: the report's 24-byte
     torn tail and open round 1, the commit sum_sha chain and the final
     parameters bitwise the twin's; the journal's cost, the recovery
     latency, the cost of deterministic algorithms; (n) chaos-smoke's
     streaming twin equals CHAOS_SMOKE.json's stream_check; (o) its
     cohort-only and full-C twins end bitwise equal; (p) hhe-smoke
     journaled, crashed and recovered, the persisted symmetric uploads
     re-transciphered through K7 at [294, 3, 256], the chain bitwise the
     twin's.
  10. The hierarchical fold tree and error feedback through
     `run_experiment` (`hier_ef_runs`), the bitwise comparisons under
     deterministic algorithms: (q) medical-8 at full width, 3 rounds x 1
     epoch, fused, the full cohort (quorum 0.75, a 2 s deadline, one
     retry) through 4 host tiers of 2 hospitals and flat, clean, under a
     duplicate storm and under a regional outage: each round's committed
     sum, stream record and the final parameters bitwise the flat twin's;
     a lossy-uplink twin (a lost, a duplicated and delayed ships, host
     quorum 0.5, a 1 s ship deadline, tier staleness 1): its hosts records
     what the link schedule and the ship policy give
     (`host_hier_record`), its sums the clean flat twin's, its decrypts
     within 5e-6 of the released clients' mean; a dark-uplink twin (one
     uplink a round never delivers, the same tier knobs): its hosts records
     the schedules' (a missed tier, its carry, the next round's stale tier
     fold), its released clients and host_unreachable exclusions the
     schedules', its decrypts within 5e-6 of the mean of the uploads it
     released, the carried tier's among them; (r) the clean twin's round-0
     uploads through a journaled aggregator crashed at each tier crash
     point and recovered bitwise from its tier journals, with each WAL's
     bytes, appends, fsyncs and the recovery latency, and
     `dcn_compare_record`; (s) medical-8 streaming, a cohort of 4 of 8, b = 4
     with error feedback (K3 and K7 at [40, 3, 4096], K4 at [10, 3, 4096]),
     3 rounds, CKKS and hybrid-HE uploads: the residual moves on the
     cohort's rows only, is each upload's quantization error and within
     step/2 where unsaturated, each decrypt within the error budget of the
     quantized carried mean, HHE bitwise CKKS; beside a b = 8 twin (K3 at
     [76, 3, 4096]): the bytes on the wire and the round seconds, and one
     warm upload at each geometry profiled (torch.profiler); (t)
     chaos-smoke's hierarchical twins (N = 256) bitwise their flat twins,
     committing CHAOS_SMOKE.json's hier_check rounds; `ef_packing_record`
     EF_RATIO_READINGS times (its certificates and bytes ratio gated, its
     fold ratio reported).
  11. The rotate-and-sum ladder, the exact final decode and the writers
     (`ladder_runs`): (u) the ladder `LinearScorer` at phase 4's geometry
     and model (N=4096, d=512, K=10, 11 Galois keys): one score's launches
     exactly 11 K5, 11 K2 and 13 K1 (per stage one of each, plus the
     weights and the bias; its forward transforms 11 x
     `ladder_stage_forward_ntts` + 2 per class block), its scores within
     0.05 of W x + b with the BSGS scorer's argmax, bitwise the CPU plain
     versions' score; `score_many` on 4 queries ([40, 3, 4096] K5 calls);
     warm latency of both and of the BSGS score, one score's device time
     by kernel; (v) the ladder `MlpScorer` at phase 5's geometry and model
     (N=8192, L=5, d=64, H=16, K=10): 12 K5 stages at [16, 5, 8192], one
     eval-input K5 at [16, 5, 8192], argmax and MLP_ERR_LIMIT, the
     mlp_compare key-switch counts; `score_many` on 4 ([64, 5, 8192]);
     every K1, K2 and K5 launch of (u)-(v) on a shape phase 2 timed; (w)
     medical-8 cut to 1 round of 1 epoch with exact_final_decode: the
     round's residues decoded by the native CRT bitwise the Python-bignum
     decode, both timed, the exact and the float decode within 5e-6; (x)
     `bench_inference` (3 reps), the BENCH_LOAD writer on the 10**4-client
     trace with its sweep and the BENCH_DCN writer into a temporary
     directory, each exiting 0, then the trend gate over what they wrote.
  12. The headline benchmark and the kernel benchmark (`headline_runs`):
     (y) `bench.run` at the flagship's full width and epochs (MedCNN
     256x256x3, 1600 `medical` images, 2 clients x 10 epochs, N=4096 L=3),
     HEADLINE_ROUNDS rounds, then the cell-6 comparison, the standalone and
     packed HE phases, the cohort and DCN comparisons, its launches counted
     from zero: the decrypted average within 5e-6 of the plaintext mean,
     the packed round within its budget, both comparisons bitwise, every
     phase_roofline row with FLOPs and an mfu in (0, 1], every he_roofline
     row with a utilization and no timing_floor_suspect; (z)
     `bench_ntt.run`: each kernel K1-K7 bitwise against its plain version
     and timed at every shape of bench_ntt's lists (`ms` device time: the
     kernel events of torch.profiler, median over 30 calls, L2 flushed
     before each; `call_ms` the wrapper's call between two CUDA events;
     `plain_ms` the plain version's call; the kernel's lower bound on this
     card; K5's device time by kernel; K6's bound on the lazy count and on
     a per-term Montgomery count and `read_ms`, PyTorch's torch.amax over
     the same key bytes), then the trend gate over both artifacts.
  13. Profiler trace attribution (`trace_runs`, `obs.trace`): (aa)
     medical-8 cut to 1 round of 1 epoch through
     `run_experiment(profile_dir=...)`: rows sgd_core, augment, val,
     encrypt, psum_aggregate, decrypt and evaluate each above 0, every K3
     kernel event in hefl.encrypt and every K4 in hefl.decrypt, as many as
     the round launched, no port kernel unattributed, the rows plus the
     unattributed time the device total within 1 us an op event, the
     device total within 1.02 x the traced wall time; (ab)
     `profile_round.run` at the flagship's full width cut to
     PROFILE_EPOCHS local epochs, traced: its record's keys,
     attribution_source "trace", round_wall_agreement (the round's device
     busy share) in (0, 1.02], its rows logged; (ac) one warm BSGS linear
     score (phase 4's geometry) and one ladder linear score (phase 11
     (u)'s), traced: every port kernel event in a hefl.serve_* row, K5 in
     serve_keyswitch or serve_hoist (the ladder's in serve_rotate), K6 in
     serve_hoist. A trace that drops a kernel event is taken again, up to
     TRACE_TRIES windows.
  14. The driver leftovers (`leftover_runs`): (ad) a reference-layout
     folder (Train/ and Test/, 2 classes, FOLDER_TRAIN + FOLDER_TEST PNGs
     at 256x256 from the `medical` generator) through the CLI's
     `--data-dir DIR --image-size 256 --rounds 1 --epochs 1`: the arrays
     the run loads equal the written ones bitwise, 2 classes, the load's
     seconds an image, the decrypted average within 5e-6 of the round's
     plaintext mean; (ae) the client-fusion "auto" choice in a fresh
     process (the probe, persisted into a temporary directory) and in a
     second one (read back: `autoselect.cache` 1, no probe,
     `auto_persisted`), the resolution and the first training call after
     it timed in each; `he_backend_report`
     reads "cuda", a "plain" pin on the card raises; (af)
     `fidelity_check.run` over 3 seeds at the flagship shape (worst diff
     <= 5e-6, 0 overflows); (ag) `mfu_probe.run` over the full batch
     ladder; (ah) `flagship_acc` at FLAGSHIP_EPOCHS epochs: a separate
     process stopped after the first epoch (`run(chunk_epochs=1)`), resumed
     here, bitwise the unchunked run and the secure round's own result
     (`secure_fedavg_round` under "vmap", both under deterministic
     algorithms). Its seconds are printed.
  15. The quality sweep, the static gate and the pre-flight
     (`results_gate_runs`): (ai) `results.run_preset` on the five
     BASELINE presets at full width, RESULTS_ROUNDS rounds x RESULTS_EPOCHS
     epoch: each record with the JAX script's keys plus power_limit, no
     encode overflow, the card's name and power limit; one K3 and one K4 a
     round of each encrypted preset, no kernel for mnist-plain;
     RESULTS_TORCH.json / .md rendered in a temporary directory; (aj)
     `python -m hefl_tpu_torch.analysis --json --device cuda` in its own
     process: exit 0, the lines certificate, finding, summary, every
     certificate the interval interpreter's (proven intervals), every
     coverage stage run (a medical-8 round on the card, a BSGS and a ladder
     score), the certificate count and the stage seconds printed; eight
     certificates with their range probes traced on the card (FakeTensors
     on CUDA, no launch) equal to the CPU traces string for string,
     refuted points included; each violation fixture through the gate's
     `main` with no `--device` exits 1 on the card under its rule, the
     loop-overflow fixture citing the carried `add`; (ak) the pre-flight
     of medical-8 and hhe-smoke from cold certificate caches, its seconds
     printed; a clean medical-8 run's
     metrics carry analysis.violations = 0, an over-headroom packing (b=16,
     k=16) is refused with AnalysisError by `run_experiment` and with
     "hefl-lint: ..." by the CLI, before any kernel launches.
  16. The client mesh (`mesh_runs`, one process a rank, spawned from
     here): (al) the NCCL world of every card (one rank on a one-card
     machine) and (am) MESH_GLOO_RANKS gloo ranks sharing cuda:0, each
     rank training MESH_PER_RANK clients of the full-width MedCNN round
     (MESH_IMAGES `medical` images, 1 epoch, N=4096 L=3; twice in the same
     ranks, cold then warm) through
     `secure_fedavg_round(mesh=)` under the per-client loop and
     deterministic algorithms, rank 0 decrypting: every rank's ciphertext
     sum the same, and bitwise the one-process round's on the same inputs
     (rank 0 runs it, uncounted), its decrypted average bitwise that
     round's and within 5e-6 of the plaintext mean; each rank's launches
     counted from zero: exactly one K3 over its clients' rows ([110, 3,
     4096]) and K4 once, at the owner; the world size, backend and each
     rank's train, upload, all-reduce and decrypt seconds printed; (an) in
     each world of more than one rank, psum_mod, ring_psum_mod (through
     host copies under gloo) and hierarchical_psum_mod on card tensors
     bitwise the host's sum mod p of every rank's rows, and under gloo
     bitwise the same collectives on CPU copies; (ao) in each world of
     more than one rank, the driver: `run_experiment` on every rank
     (medical-8 cut to MESH_DRIVER_ROUNDS rounds of 1 epoch, MESH_PER_RANK
     clients a rank, the per-client loop, deterministic algorithms; rank
     0 keygens, broadcasts pk, decrypts and replicates the parameters):
     rank 0's history and every rank's parameters bitwise the one-process
     run's on cuda:0 (not counted), only rank 0 writes files, each rank
     one K3 a round over its clients' rows and rank 0 alone K4 a round.
  17. The streaming engines across the client mesh (`stream_mesh_runs`,
     one process a rank): medical-8 at full width (MedCNN, N=4096 L=3, 8
     clients of STREAM_MESH_IMAGES `medical` images, 1 epoch), streaming
     STREAM_MESH_ROUNDS rounds with phase 9's knobs (a cohort of 4 of 8)
     plus a staleness budget of 1 under phase 9's fault schedule, the
     per-client loop and deterministic algorithms, each rank's rows staged
     by `data.RoundPrefetcher` (`fl.stream.round_rows`): (ap) float CKKS
     uploads across the NCCL world of every card and across
     MESH_GLOO_RANKS gloo ranks on cuda:0; (aq) in the gloo world, 4 host
     tiers with b = 4 error feedback, CKKS and hybrid-HE (K7). Each rank's
     launches counted from zero are exactly the predicted ones
     (`_expected_stream_launches`: one K3 a round over its block of the
     cohort's bucket, the HHE server's pads and K7 on every rank, K4 at
     rank 0 a committed round); every rank's committed sums the same and
     rank 0's every round's sum, record and decrypt bitwise the
     one-process engine's on the same inputs (run there, uncounted); each
     rank's train, upload, gather, fold (and transcipher) and decrypt
     seconds printed. (ar) The ct split: the encrypted round of 2 clients
     on `make_mesh_2d(2, 2)` in the gloo world (and of 4 on 2 x 2 across 4
     cards; 2 on 1 x 2 across 2 or 3), each rank one K3 at [56, 3, 4096],
     the sum bitwise the one-process (1-D) round's, the decrypt within
     5e-6 of the plaintext mean. (as) Each gloo rank's card memory for its
     prefetched block of medical-8's arrays against the whole arrays'
     bytes, then with the next round staged and after promotion. (at) The
     journaled streaming `run_experiment` (medical-8 cut to
     MESH_DRIVER_ROUNDS rounds) in the gloo world crashed mid-append in
     round 1 (rank 0 SimulatedCrash, rank 1 PeerRankFailed) and run again:
     rank 0 recovers (24 torn bytes, round 1 open), its history and every
     rank's parameters bitwise the one-process run's; only rank 0 opens
     the journal.
  Phases 3-17 each print their launches by (kernel, rows x N); phases 4-5
     also count the unhoisted twins' one K6 launch a baby step (S = 1).
  18. Check that no `ntt_kernel` instantiation of K1-K4 or K7 that phases
     3-17 launched, and not K6's kernel, spills registers, and that every
     K3, K4, K6 and K7 launch of phases 3-17 fell on a shape phase 12
     timed. Print one JSON line {"kernels": [...]}
     (phase 12's records; launches: the sum over the main-path runs of
     phases 3-17, each counted from zero; every kernel carries one
     "shapes" entry per timed shape with the launches at that shape, K5's
     also its per-kernel "split"; the ranking launches x (ms - bound)
     prices each launch at its own shape)
     and, last, the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from hefl_tpu_torch.bench_ntt import (
    BUTTERFLY_OPS,
    DEC_SHAPES,
    DIGIT_BITS,
    ENC_SHAPES,
    HOIST_SHAPES,
    KS_SHAPES,
    NTT_SHAPES,
    NUM_DIGITS,
    TC_SHAPES,
    decrypt_case,
    encrypt_case,
    max_abs_err,
    ntt_cases,
    rand_residues,
    serving_kernel_cases,
    transcipher_case,
)
from hefl_tpu_torch.utils.roofline import is_port_kernel, log

# Prime counts at which phase 2 holds K5 bitwise at every ring size: every
# cluster plan of its digit stage (cuda_ntt.keyswitch_plan).
KS_CHECK_PRIMES = (1, 2, 3, 5)
# Prime counts at which phase 2 holds K6 bitwise at every ring size and at
# every split Q of cuda_ntt.HOIST_SPLITS (R = 6L: L = 6 runs two chunks of
# K = 32 components), at S = 3 steps and B = 5 ciphertexts.
HOIST_CHECK_PRIMES = (1, 2, 3, 5, 6)
# Row counts at which phase 2 holds K1-K4 and K7 bitwise at every ring size
# (N = 256 to 16384): every cluster plan of cuda_ntt.ntt_plan (8 blocks a
# row up to 16 rows, 4 up to 33, 2 up to 65, 1 from 66 on a 132-SM card;
# one block a row below N = 1024, at least 2 at N = 16384), and the row
# counts of ENC_SHAPES, DEC_SHAPES and TC_SHAPES (chaos-smoke's 21,120 and
# 2,640 rows among them).
NTT_CHECK_ROWS = (1, 3, 5, 6, 10, 18, 30, 54, 57, 120, 165, 201, 228, 330, 456, 660, 882, 1320,
                  2640, 3216, 21120)
ERR_LIMIT = 5e-6
SCORE_ERR_LIMIT = 0.05               # the JAX package's serving tolerance
# The depth-2 MLP at N=8192 carries more noise than the JAX tests' n=512 ring:
# the baby rotations' key-switch noise grows with N and the square doubles
# its relative size (0.174 on the H100 in chip_smoke.py, bitwise the same
# integers as the plain versions). Its check is the repo's serving gate
# (argmax agrees, run_perf_smoke.sh) plus this bound against broken decodes.
MLP_ERR_LIMIT = 0.25


# An ntt_kernel<LOGN, C, kInverse, Src, Dst> instantiation's mangled name.
_NTT_KERNEL = re.compile(r"ntt_kernelILi(\d+)ELi(\d+)ELb([01])E.*?\d+([A-Za-z]+Rows)E"
                         r".*?\d+([A-Za-z]+Store)E")
# The load and store policies of K1-K4's and K7's ntt_kernel instantiations.
NTT_POLICIES = {
    "ntt_forward": ("false", "PlainRows", "PlainStore"),
    "ntt_inverse": ("true", "PlainRows", "PlainStore"),
    "encrypt_fused": ("false", "EncryptRows", "EncryptStore"),
    "decrypt_fused": ("true", "DecryptRows", "PlainStore"),
    "transcipher_fused": ("false", "TranscipherRows", "TranscipherStore"),
}


HOIST_KERNEL = "hoisted_lazy_kernel"


# The instantiation of K3 at the medical presets' [440, 3, 4096] (1,320 rows:
# ntt_plan gives one block a row), whose SASS mix phase 1 prints.
K3_MEDICAL = "ntt_kernel<12, 1, false, EncryptRows, EncryptStore>"
MUL_PIPE = ("IMAD", "IMUL")
ALU_PIPE = ("IADD", "ISETP", "SEL", "LOP", "SHF", "IMNMX", "VIMNMX", "PRMT", "MOV", "IABS",
            "FLO", "POPC", "BMSK", "SGXT", "LEA")


def log_sass(cuda_ntt) -> None:
    """Phase 1: the SASS opcode counts (cuobjdump of the built library) of
    K6's kernel, which fix MAD64_OPS, and the multiply-pipe / ALU-pipe /
    memory / other split of K3's instantiation K3_MEDICAL, the mix behind
    bound()'s two-pipe rate (static counts; its loops are unrolled); "not
    available" without cuobjdump."""
    try:
        tool = shutil.which("cuobjdump") or str(Path(cuda_ntt._nvcc()).parent / "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(cuda_ntt.library_path())], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        log(f"  SASS: not available ({e})")
        return
    funcs, current = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            k = _NTT_KERNEL.search(name)
            current = (HOIST_KERNEL if HOIST_KERNEL in name else ntt_kernel_label(
                int(k.group(1)), int(k.group(2)), "true" if k.group(3) == "1" else "false",
                k.group(4), k.group(5)) if k else None)
        elif current and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                         line)):
            ops = funcs.setdefault(current, {})
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    ops = funcs.get(HOIST_KERNEL, {})
    wide = {k: v for k, v in sorted(ops.items()) if k.startswith(("IMAD", "IADD", "LDG"))}
    log(f"  K6 SASS {HOIST_KERNEL}: {sum(ops.values())} instructions; {json.dumps(wide)}")
    ops = funcs.get(K3_MEDICAL, {})
    split = {"mul": 0, "alu": 0, "memory": 0, "other": 0}
    for op, count in ops.items():
        kind = ("mul" if op.startswith(MUL_PIPE) else "alu" if op.startswith(ALU_PIPE)
                else "memory" if op.startswith(("LD", "ST", "RED", "ATOM")) else "other")
        split[kind] += count
    log(f"  K3 SASS {K3_MEDICAL}: {sum(ops.values())} instructions, by pipe {json.dumps(split)} "
        f"(adds on the multiply pipe: IMAD.IADD; bound()'s count a butterfly: {BUTTERFLY_OPS}); opcodes "
        f"{json.dumps(dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16]))}")


def ntt_kernel_label(logn: int, cluster: int, inverse: str, src: str, dst: str) -> str:
    """An ntt_kernel instantiation as kernel_label writes its profiler name."""
    return f"ntt_kernel<{logn}, {cluster}, {inverse}, {src}, {dst}>"


def ptxas_report(text: str) -> dict:
    """{kernel label: (registers, spill store bytes, spill load bytes)} from
    the build's `-Xptxas -v` report; ntt_kernel instantiations labelled as
    ntt_kernel_label writes them, the other kernels by their name."""
    report, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            if k := _NTT_KERNEL.search(name):
                label = ntt_kernel_label(int(k.group(1)), int(k.group(2)),
                                         "true" if k.group(3) == "1" else "false",
                                         k.group(4), k.group(5))
            else:
                label = k.group(1) if (k := re.search(r"([a-z_]+_kernel)", name)) else name
            report[label] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return report


def log_ptxas_report(report: dict) -> None:
    """Phase 1: registers of every ntt_kernel instantiation by policy pair
    ({"LOGN/C": registers}), and every kernel that spills."""
    by_policy = {}
    for label, (regs, _, _) in sorted(report.items()):
        if label.startswith("ntt_kernel<"):
            logn, cluster, *policy = label[len("ntt_kernel<"):-1].split(", ")
            by_policy.setdefault(", ".join(policy), {})[f"{logn}/{cluster}"] = regs
    for policy, regs in by_policy.items():
        log(f"  ptxas registers, ntt_kernel<LOGN, C, {policy}> by LOGN/C: {json.dumps(regs)}")
    log("  ptxas, other kernels (registers): " + json.dumps(
        {k: v[0] for k, v in sorted(report.items()) if not k.startswith("ntt_kernel<")}))
    spilled = {k: v[1:] for k, v in report.items() if v[1] or v[2]}
    log(f"  ptxas spills (store, load bytes): {json.dumps(spilled) if spilled else 'none'}")
    if not by_policy:
        raise AssertionError("the ptxas report names no ntt_kernel instantiation")


def check_kernels(cuda_ntt, ntt_mod, device) -> None:
    """Phase 2: bitwise checks at N=1024 and at every ring size and cluster
    plan (the timed shapes are phase 12's, `bench_ntt.run`)."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    small = ntt_mod.NTTContext.build(find_ntt_primes(3, 27, 2048), 1024)
    small_cases = ntt_cases(cuda_ntt, small, 8, device, 100) + [
        encrypt_case(cuda_ntt, small, 8, device, 110), decrypt_case(cuda_ntt, small, 8, device, 120),
        transcipher_case(cuda_ntt, small, 8, device, 150)]
    for name, _, shape, kern, plain, *_ in small_cases:
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        log(f"  N=1024 {name} {shape}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{name} at N=1024 differs from its plain version")
    ctxs = {}
    for n in cuda_ntt.SUPPORTED_N:
        for rows in NTT_CHECK_ROWS:
            num_l = 5 if rows % 5 == 0 else 3 if rows % 3 == 0 else 1
            if (n, num_l) not in ctxs:
                ctxs[n, num_l] = ntt_mod.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)
            ctx = ctxs[n, num_l]
            batch = rows // num_l
            m, u, e0, e1 = (rand_residues(ctx, (batch, num_l, n), n + rows + i, device)
                            for i in range(4))
            b, a = (rand_residues(ctx, (num_l, n), n + rows + i, device) for i in (4, 5))
            rng = np.random.default_rng(n + rows)
            w_hi, w_lo = (torch.from_numpy(rng.integers(0, 2**31, (batch, n)).astype(np.int32))
                          .to(device) for _ in range(2))
            for name, got, want in (
                ("ntt_forward", cuda_ntt.ntt_forward(ctx, m), cuda_ntt.ntt_forward_plain(ctx, m)),
                ("ntt_inverse", cuda_ntt.ntt_inverse(ctx, m), cuda_ntt.ntt_inverse_plain(ctx, m)),
                ("encrypt_fused", cuda_ntt.encrypt_fused(ctx, m, u, e0, e1, b, a),
                 cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)),
                ("decrypt_fused", cuda_ntt.decrypt_fused(ctx, u, e1, a),
                 cuda_ntt.decrypt_fused_plain(ctx, u, e1, a)),
                ("transcipher_fused", cuda_ntt.transcipher_fused(ctx, w_hi, w_lo, u, e1),
                 cuda_ntt.transcipher_fused_plain(ctx, w_hi, w_lo, u, e1)),
            ):
                if max_abs_err(got, want) != 0:
                    raise AssertionError(f"{name} on {rows} rows at N={n} differs from its plain "
                                         "version")
    torch.cuda.synchronize()
    log(f"  ntt_forward, ntt_inverse, encrypt_fused, decrypt_fused, transcipher_fused at N in "
        f"{cuda_ntt.SUPPORTED_N} x rows in {NTT_CHECK_ROWS} (cluster sizes "
        f"{[cuda_ntt.ntt_plan(r, 4096) for r in NTT_CHECK_ROWS]}): bitwise equal")
    for name, _, shape, kern, plain, *_ in serving_kernel_cases(cuda_ntt, ntt_mod, 1024, device,
                                                                 300, shapes="small"):
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        log(f"  N=1024 {name} {shape}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{name} at N=1024 differs from its plain version")
    # K5 at every cluster plan of its digit stage: L = 1, 2, 3, 5 give 6, 24,
    # 54 and 150 digit rows a ciphertext (C = 8, 4, 2, 1).
    for n in cuda_ntt.SUPPORTED_N:
        for num_l in KS_CHECK_PRIMES:
            ctx = ntt_mod.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)
            x = rand_residues(ctx, (1, num_l, n), n + num_l, device)
            keys = [rand_residues(ctx, (6 * num_l + 1, num_l, n), n + num_l + i, device)
                    for i in (1, 2)]
            for eval_input in (False, True):
                if max_abs_err(cuda_ntt.keyswitch_fused(ctx, x, *keys, DIGIT_BITS, NUM_DIGITS,
                                                        eval_input),
                               cuda_ntt.keyswitch_fused_plain(ctx, x, *keys, DIGIT_BITS,
                                                              NUM_DIGITS, eval_input)) != 0:
                    raise AssertionError(f"keyswitch_fused (eval_input={eval_input}) at L={num_l}, "
                                         f"N={n} differs from its plain version")
    torch.cuda.synchronize()
    plans = [cuda_ntt.keyswitch_plan(1, find_ntt_primes(num_l, 27, 8192), NUM_DIGITS, DIGIT_BITS,
                                     4096).digit_cluster for num_l in KS_CHECK_PRIMES]
    log(f"  keyswitch_fused, both modes, at N in {cuda_ntt.SUPPORTED_N} x L in {KS_CHECK_PRIMES} "
        f"(digit-stage cluster sizes {plans}): bitwise equal")
    # K6 at every ring size x HOIST_CHECK_PRIMES, at the plan's split and at
    # every split Q (S = 3, B = 5).
    for n in cuda_ntt.SUPPORTED_N:
        for num_l in HOIST_CHECK_PRIMES:
            ctx = ntt_mod.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)
            r = num_l * NUM_DIGITS
            c0 = rand_residues(ctx, (5, num_l, n), n + num_l, device)
            d, bk, ak = (rand_residues(ctx, shape, n + num_l + i, device) for i, shape in (
                (1, (5, r, num_l, n)), (2, (3, r, num_l, n)), (3, (3, r, num_l, n))))
            want = cuda_ntt.hoisted_products_plain(ctx, c0, d, bk, ak)
            for kw in ([{}] + [{"split": q} for q in cuda_ntt.HOIST_SPLITS]):
                plan = cuda_ntt.hoisted_plan(3, 5, r, ctx.p[:, 0], n, **kw)
                if max_abs_err(cuda_ntt.hoisted_products(ctx, c0, d, bk, ak, plan=plan),
                               want) != 0:
                    raise AssertionError(f"hoisted_products ({plan}) at L={num_l}, N={n} "
                                         "differs from its plain version")
    torch.cuda.synchronize()
    log(f"  hoisted_products at N in {cuda_ntt.SUPPORTED_N} x L in {HOIST_CHECK_PRIMES} (S=3, "
        f"B=5), at the plan's split and every split {cuda_ntt.HOIST_SPLITS}: bitwise equal")


def launch_key(name: str, shape) -> tuple:
    """The LAUNCH_ROWS key of a kernel's launch at a timed shape: [B, L, N]
    -> (name, B*L, N); K6's [S, R, B, L, N] -> (name, S*B*L, N)."""
    *lead, b, num_l, n = shape
    steps = lead[0] if name == "hoisted_products" else 1
    return (name, steps * b * num_l, n)


def log_launch_rows(rows: dict) -> None:
    """One line: launches by kernel, then by 'rows x N' of its main input."""
    by_name = {}
    for (name, r, n), count in sorted(rows.items()):
        by_name.setdefault(name, {})[f"{r}x{n}"] = count
    log("  launches by (kernel, rows x N): " + json.dumps(by_name))


def main_path(device) -> tuple[dict, dict]:
    """Phase 3: one encrypted FedAvg round of full-width MedCNN."""
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.fl.fedavg import evaluate
    from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
    from hefl_tpu_torch.models import count_params, create_model

    times = {}
    t = time.perf_counter()
    (x, y), (xt, yt), _ = make_dataset("medical", seed=0, n_train=192, n_test=64)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), 2))
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    xt_d = torch.from_numpy(xt).to(device)
    gen = torch.Generator().manual_seed(0)
    model = create_model("medcnn", gen=gen, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    cfg = TrainConfig(epochs=2, num_classes=2)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t
    if count_params(params) != 222_722:
        raise AssertionError(f"MedCNN has {count_params(params)} params, expected 222,722")

    cuda_ntt.reset_launch_counts()

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    ctx = phase("context_s", CkksContext.create)
    sk, pk = phase("keygen_s", lambda: keygen(ctx, gen, device=device))
    ct_sum, mets, overflow, ref = phase("train_encrypt_aggregate_s", lambda: secure_fedavg_round(
        model, cfg, ctx, pk, params, xs_d, ys_d, gen, with_plain_reference=True))
    spec = PackSpec.for_params(params, ctx.n)
    avg = phase("decrypt_s", lambda: decrypt_average(ctx, sk, ct_sum, 2, spec))
    results = phase("evaluate_s", lambda: evaluate(model, avg, xt_d, yt))
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    wire_round_trip(ctx, sk, pk, ct_sum, device)

    log(f"  main path launches: {counts}")
    for name in ("ntt_forward", "encrypt_fused", "decrypt_fused"):
        if counts[name] < 1:
            raise AssertionError(f"main path did not launch {name}")
    if spec.n_ct != 55 or tuple(ct_sum.c0.shape) != (55, 3, 4096):
        raise AssertionError(f"unexpected ciphertext geometry {tuple(ct_sum.c0.shape)}")
    if int(overflow.sum()) != 0:
        raise AssertionError(f"encode saturated {int(overflow.sum())} weights")
    if tuple(mets.shape) != (2, 2, 4) or not torch.isfinite(mets).all():
        raise AssertionError(f"bad training metrics {mets}")
    err = max((avg[k] - ref[k]).abs().max().item() for k in ref)
    finite = all(torch.isfinite(v).all().item() for v in avg.values())
    log(f"  decrypted average vs plaintext mean: max abs err {err:.3e} (limit {ERR_LIMIT})")
    if not finite or not err <= ERR_LIMIT:
        raise AssertionError(f"decrypted average off the plaintext mean by {err}")
    if not 0.0 <= results["accuracy"] <= 1.0:
        raise AssertionError(f"bad evaluation {results}")
    log(f"  val_loss per client/epoch {mets[:, :, 0].tolist()}; test accuracy "
        f"{results['accuracy']:.4f} f1 {results['f1']:.4f}")
    log("  phase times (s): " + json.dumps(times))
    return counts, shapes


def wire_round_trip(ctx, sk, pk, ct_sum, device) -> None:
    """Phase 3's wire files: (ctx, pk), sk and the round's ciphertext sum
    saved through `utils.serialization` into a temporary directory, loaded
    back, and decrypted on the card: bitwise the in-memory decrypt."""
    import tempfile

    from hefl_tpu_torch.ckks import ops
    from hefl_tpu_torch.ckks.keys import PublicKey, SecretKey
    from hefl_tpu_torch.utils import serialization as ser

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        paths = {k: str(Path(tmp) / f"{k}.npz") for k in ("public", "secret", "ct_sum")}
        ser.save_public_material(paths["public"], ctx, pk)
        ser.save_secret_key(paths["secret"], sk)
        ser.save_ciphertext(paths["ct_sum"], ct_sum)
        sizes = {k: Path(p).stat().st_size for k, p in paths.items()}
        ctx2, pk2 = ser.load_public_material(paths["public"])
        sk2 = ser.load_secret_key(paths["secret"])
        ct2 = ser.load_ciphertext(paths["ct_sum"])
    pk2 = PublicKey(b_mont=pk2.b_mont.to(device), a_mont=pk2.a_mont.to(device))
    sk2 = SecretKey(s_mont=sk2.s_mont.to(device))
    same_keys = torch.equal(pk2.b_mont, pk.b_mont) and torch.equal(pk2.a_mont, pk.a_mont)
    got = ops.decrypt(ctx2, sk2, dataclasses.replace(ct2, c0=ct2.c0.to(device),
                                                     c1=ct2.c1.to(device)))
    want = ops.decrypt(ctx, sk, ct_sum)
    torch.cuda.synchronize()
    log(f"  wire files (bytes) {json.dumps(sizes)}: loaded public key equal {same_keys}, "
        f"decrypt of the loaded sum bitwise the in-memory one {torch.equal(got, want)}")
    if not (same_keys and torch.equal(got, want) and ctx2.ntt.n == ctx.n):
        raise AssertionError("the wire files' round trip does not decrypt bitwise")


def warm_latency(fn, calls: int = 20) -> tuple[float, float]:
    """(median, p95) seconds of `fn` over `calls` warm calls, each ending in
    torch.cuda.synchronize() (host clock)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), float(np.percentile(times, 95))


def device_time_breakdown(label: str, fn, top: int = 8, host_top: int = 0) -> None:
    """Device time of one warm call of `fn` by kernel (torch.profiler with
    CUDA activity, kernel events only), beside its host-clock wall time, and
    the `top` kernels by device time; with `host_top`, also the host ops'
    own time (self CPU time, profiler overhead included) and the `host_top`
    ops that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if is_port_kernel(r[0]))
    log(f"  {label}: wall {wall_ms:.3f} ms (profiled), device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f} % of wall) in {sum(r[2] for r in rows)} kernels; "
        f"the port's CUDA kernels {ours:.3f} ms, PyTorch's own {busy - ours:.3f} ms")
    for key, ms, count in rows[:top]:
        log(f"    {ms:9.4f} ms  x{count:<5d} {key[:90]}")
    if host_top:
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                       if e.self_cpu_time_total > 0), key=lambda r: -r[1])
        log(f"    host ops {sum(r[1] for r in host):.3f} ms in {sum(r[2] for r in host)} calls; "
            f"by self CPU time:")
        for key, ms, count in host[:host_top]:
            log(f"    host {ms:9.4f} ms  x{count:<5d} {key[:90]}")


def same_ciphertext(a, b) -> bool:
    return (torch.equal(a.c0.cpu(), b.c0.cpu()) and torch.equal(a.c1.cpu(), b.c1.cpu())
            and a.scale == b.scale)


def check_scores(label: str, got, want, limit: float = SCORE_ERR_LIMIT) -> None:
    err = float(np.max(np.abs(got - want)))
    agree = bool(np.all(np.argmax(got, -1) == np.argmax(want, -1)))
    log(f"  {label}: max |scores - reference| {err:.3e} (limit {limit}), "
        f"argmax agrees: {agree}")
    if not (np.all(np.isfinite(got)) and err <= limit and agree):
        raise AssertionError(f"{label}: scores off the plaintext reference ({err}, argmax {agree})")


def unhoisted_twin_launches(scorer, ct, steps: int, k6_rows: dict):
    """One score of a scorer in rotation_mode="unhoisted", its launches
    counted from zero: its baby steps run one K6 launch each at S = 1
    (`ops.step_key_products`), `k6_rows` {(S*B*L, N): launches} of them.
    -> (the score, launch counts, launches by shape)."""
    from hefl_tpu_torch.ckks import cuda_ntt

    cuda_ntt.reset_launch_counts()
    out = scorer.score(ct)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    k6 = {key[1:]: c for key, c in shapes.items() if key[0] == "hoisted_products"}
    log(f"  the unhoisted twin's K6 launches at S = 1 by (rows, N): {k6}")
    if counts["hoisted_products"] != steps or k6 != k6_rows:
        raise AssertionError(f"the unhoisted twin must launch one K6 a baby step ({steps}: "
                             f"{k6_rows}), launched {k6}")
    return out, counts, shapes


def merge_launches(*runs) -> tuple[dict, dict]:
    """The (counts, launches by shape) of several runs, summed."""
    counts, shapes = {}, {}
    for run_counts, run_shapes in runs:
        for key, c in run_counts.items():
            counts[key] = counts.get(key, 0) + c
        for key, c in run_shapes.items():
            shapes[key] = shapes.get(key, 0) + c
    return counts, shapes


def serving_linear(device, n: int = 4096) -> tuple[dict, dict]:
    """Phase 4: linear BSGS serving at N=4096, L=3, d=N/8 = 512, K=10."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import cuda_ntt, encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, GaloisKey, keygen

    times = {}
    t = time.perf_counter()
    ctx = CkksContext.create(n=n)
    gen = torch.Generator().manual_seed(42)
    sk, pk = keygen(ctx, gen, device=device)
    slots = encoding.num_slots(ctx.ntt)
    d, k = slots // 4, 10
    rng = np.random.default_rng(42)
    W, b = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k)
    plan = hei.bsgs_plan(slots, d, k)
    if n == 4096 and (len(plan.baby_steps), len(plan.giant_steps)) != (22, 23):
        raise AssertionError(f"unexpected plan {plan.baby_steps} / {plan.giant_steps}")
    gks = hei.gen_rotation_keys_for_steps(ctx, sk, 2, plan.rotation_steps_needed)
    torch.cuda.synchronize()
    times["keygen_45_galois_s"] = time.perf_counter() - t
    t = time.perf_counter()
    scorer = hei.BsgsLinearScorer(ctx, W, b, gks)
    torch.cuda.synchronize()
    times["scorer_build_s"] = time.perf_counter() - t
    x = rng.normal(0, 0.5, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    torch.cuda.synchronize()

    cuda_ntt.reset_launch_counts()
    out = scorer.score(ct)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    log(f"  one score's launches: {counts}")
    if counts["keyswitch_fused"] != len(plan.giant_steps) or counts["hoisted_products"] != 1:
        raise AssertionError(f"a linear score must launch exactly {len(plan.giant_steps)} K5 "
                             "(one per giant step) and 1 K6")
    if counts["ntt_forward"] < 1 or counts["ntt_inverse"] < 1:
        raise AssertionError("a linear score must launch K1 and K2")
    check_scores("linear score (1 query)", hei.decrypt_class_scores(ctx, sk, out, k), x @ W.T + b)

    unhoisted = hei.BsgsLinearScorer(ctx, W, b, gks, rotation_mode="unhoisted")
    twin_out, twin_counts, twin_shapes = unhoisted_twin_launches(
        unhoisted, ct, len(plan.baby_steps), {(3, n): len(plan.baby_steps)})
    if not same_ciphertext(out, twin_out):
        raise AssertionError("hoisted and unhoisted linear scores differ")
    log("  hoisted == unhoisted: bitwise")
    t = time.perf_counter()
    cpu_gks = {s: GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())
               for s, v in gks.items()}
    cpu_out = hei.BsgsLinearScorer(ctx, W, b, cpu_gks, device="cpu").score(
        hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    times["cpu_plain_score_s"] = time.perf_counter() - t
    if not same_ciphertext(out, cpu_out):
        raise AssertionError("the card's linear score differs from the CPU plain versions'")
    log(f"  card == CPU plain versions: bitwise ({times['cpu_plain_score_s']:.3f} s on the CPU)")

    med, p95 = warm_latency(lambda: scorer.score(ct))
    lat = {"single_median_s": med, "single_p95_s": p95, "single_qps": 1.0 / med}
    device_time_breakdown("one linear score", lambda: scorer.score(ct))

    q, n_ct = 4, 4
    packed = hei.BsgsLinearScorer(ctx, W, b, gks, queries_per_ct=q)
    xs = rng.normal(0, 0.5, (n_ct, q, d))
    cts = hei.encrypt_query_block(ctx, pk, xs, gen, q)
    outs = packed.score_many(cts)
    check_scores("linear score_many (16 queries, 4 per ciphertext)",
                 hei.decrypt_class_scores(ctx, sk, outs, k, queries_per_ct=q), xs @ W.T + b)
    med, p95 = warm_latency(lambda: packed.score_many(cts))
    lat.update(packed_median_s=med, packed_p95_s=p95, packed_qps=q * n_ct / med)
    log("  latency: " + json.dumps(lat))
    log("  phase times (s): " + json.dumps(times))
    return merge_launches((counts, shapes), (twin_counts, twin_shapes))


def serving_mlp(device, n: int = 8192) -> tuple[dict, dict]:
    """Phase 5: depth-2 MLP BSGS serving at N=8192, L=5, d=64, H=16, K=10."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import cuda_ntt, encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, GaloisKey, RelinKey, gen_relin_key, keygen

    t = time.perf_counter()
    ctx = CkksContext.create(n=n, num_primes=5)
    gen = torch.Generator().manual_seed(10)
    sk, pk = keygen(ctx, gen, device=device)
    rlk = gen_relin_key(ctx, sk, gen)
    d, hidden, k = 64, 16, 10
    rng = np.random.default_rng(43)
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (k, hidden)), rng.normal(0, 0.2, k)
    plan1, plan2 = hei.bsgs_mlp_plans(encoding.num_slots(ctx.ntt), d, hidden, k)
    sub = hei.mlp_sub_context(ctx, 2)
    sub_sk = hei.slice_secret_key(sk, sub.num_primes)
    gks1 = hei.gen_rotation_keys_for_steps(ctx, sk, 13, plan1.rotation_steps_needed)
    gks2 = hei.gen_rotation_keys_for_steps(sub, sub_sk, 14, plan2.rotation_steps_needed)
    scorer = hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, gks1, rlk, gks2)
    x = rng.normal(0, 0.4, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    torch.cuda.synchronize()
    log(f"  keys + scorer build: {time.perf_counter() - t:.3f} s; plan 1 "
        f"{len(plan1.baby_steps)} baby / {len(plan1.giant_steps)} giant steps, plan 2 "
        f"{len(plan2.baby_steps)} / {len(plan2.giant_steps)}")

    cuda_ntt.reset_launch_counts()
    out = scorer.score(ct)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    log(f"  one score's launches: {counts}")
    if counts["keyswitch_fused_eval"] < 1:
        raise AssertionError("the MLP's relinearization did not launch K5 in eval-input mode")
    if counts["hoisted_products"] != 2:
        raise AssertionError("an MLP score must launch exactly 2 K6 (one a layer)")
    want = ((x @ w1.T + b1) ** 2) @ w2.T + b2
    check_scores("MLP score", hei.decrypt_class_scores(sub, sub_sk, out, k), want, MLP_ERR_LIMIT)
    twin = hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, gks1, rlk, gks2, rotation_mode="unhoisted")
    steps1, steps2 = len(plan1.baby_steps), len(plan2.baby_steps)
    twin_out, twin_counts, twin_shapes = unhoisted_twin_launches(
        twin, ct, steps1 + steps2, {(5, n): steps1, (3, n): steps2})
    if not same_ciphertext(out, twin_out):
        raise AssertionError("hoisted and unhoisted MLP scores differ")
    log("  hoisted == unhoisted: bitwise")
    t = time.perf_counter()
    cpu = lambda g: {s: GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())  # noqa: E731
                     for s, v in g.items()}
    cpu_rlk = RelinKey(b_mont=rlk.b_mont.cpu(), a_mont=rlk.a_mont.cpu())
    cpu_out = hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, cpu(gks1), cpu_rlk, cpu(gks2),
                                device="cpu").score(hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    if not same_ciphertext(out, cpu_out):
        raise AssertionError("the card's MLP score differs from the CPU plain versions'")
    log(f"  card == CPU plain versions: bitwise ({time.perf_counter() - t:.3f} s on the CPU)")
    med, p95 = warm_latency(lambda: scorer.score(ct))
    log("  latency: " + json.dumps({"median_s": med, "p95_s": p95, "qps": 1.0 / med}))
    device_time_breakdown("one MLP score", lambda: scorer.score(ct))
    return merge_launches((counts, shapes), (twin_counts, twin_shapes))


def hhe_round(device) -> tuple[dict, dict]:
    """Phase 6: the hybrid-HE uplink round of full-width MedCNN, 8 clients."""
    from hefl_tpu_torch import cli
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.encoding import decode_int_center
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.ops import Ciphertext, decrypt
    from hefl_tpu_torch.ckks.packing import PackedSpec, flat_params
    from hefl_tpu_torch.ckks.quantize import deinterleave_fields, quantize
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.fl.config import PackingConfig, TrainConfig
    from hefl_tpu_torch.fl.fedavg import evaluate, train_clients
    from hefl_tpu_torch.fl.secure import (
        aggregate_encrypted, decrypt_average, encrypt_stack_packed, hhe_encrypt_stack, plain_mean,
    )
    from hefl_tpu_torch.fl.stream import OnlineAccumulator
    from hefl_tpu_torch.hhe import (
        derive_client_keys, hhe_bytes_on_wire_record, hhe_center_mod, transcipher_batch,
    )
    from hefl_tpu_torch.models import create_model

    clients, per_client = 8, 48
    # (a) The entry point: one round of `cli.run --hhe`, launches counted from 0.
    args = cli.parse_args([
        "--model", "medcnn", "--dataset", "medical", "--num-clients", str(clients),
        "--epochs", "1", "--n-train", str(clients * per_client), "--n-test", "64",
        "--pack-bits", "8", "--pack-clip", "0.5", "--hhe", "--hhe-key-seed", "0",
        "--no-save-model",
    ])
    cuda_ntt.reset_launch_counts()
    t = time.perf_counter()
    (rec,) = cli.run(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    log(f"  cli.run --hhe (1 round, {cli_s:.3f} s): launches {counts}")
    if counts["transcipher_fused"] != 1 or counts["encrypt_fused"] != 1:
        raise AssertionError("an HHE round must launch exactly one K7 and one K3 (the pads)")
    if counts["decrypt_fused"] < 1:
        raise AssertionError("the owner's decrypt did not launch K4")
    geo, wire = rec["packing"], rec["hhe"]
    log(f"  record: packing {json.dumps(geo)}; hhe {json.dumps(wire)}; stream "
        f"{json.dumps(rec['stream'])}; accuracy {rec['accuracy']:.4f}; "
        f"phases {json.dumps(rec['phases'])}")
    if (geo["interleave"], geo["n_ct"], geo["n_ct_unpacked"]) != (3, 19, 55):
        raise AssertionError(f"unexpected packed geometry {geo}")
    if not wire["expansion_hhe"] <= 1.1 or rec["encode_overflow"] != [0] * clients:
        raise AssertionError(f"expansion_hhe {wire['expansion_hhe']}, saturation "
                             f"{rec['encode_overflow']}")
    if not (rec["stream"]["committed"] and rec["stream"]["fresh"] == clients):
        raise AssertionError(f"the round did not commit all uploads: {rec['stream']}")

    # (b), (c) On one set of trained weights: the client upload, then the HHE
    # and the direct packed paths side by side.
    times = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    (x, y), (xt, yt), _ = make_dataset("medical", seed=1, n_train=clients * per_client,
                                       n_test=64)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), clients))
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    gen = torch.Generator().manual_seed(1)
    model = create_model("medcnn", gen=gen, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = CkksContext.create()
    sk, pk = keygen(ctx, gen, device=device)
    gens = lambda base: [torch.Generator(device=device).manual_seed(base + c)  # noqa: E731
                         for c in range(clients)]
    p_out, _ = phase("train_s", lambda: train_clients(
        model, TrainConfig(epochs=1, num_classes=2), params, xs_d, ys_d, gens=gens(100)))
    keys = derive_client_keys(0, clients)
    base = flat_params(params)
    # The `hhe-smoke` preset's grid (clip 0.5) first, timed; then a grid fine
    # enough (clip 0.02) that one epoch's updates quantize to non-zero codes,
    # so the averaged update itself is compared, not only offsets and noise.
    for clip in (0.5, 0.02):
        spec = PackedSpec.for_params(params, ctx, PackingConfig(bits=8, clip=clip), clients)
        timed = phase if clip == 0.5 else (lambda _name, fn: fn())
        nonzero = sum(int(torch.count_nonzero(quantize(flat_params(p) - base, spec.step, 8)))
                      for p in p_out) / (clients * spec.total)
        cuda_ntt.reset_launch_counts()
        w_hi, w_lo, sat = timed("upload_s", lambda: hhe_encrypt_stack(p_out, params, keys, 0, spec))
        if sum(cuda_ntt.launch_counts().values()) != 0:
            raise AssertionError(f"the client-side upload launched {cuda_ntt.launch_counts()}")
        tc, _ = timed("provision_transcipher_s", lambda: transcipher_batch(
            ctx, spec, pk, w_hi, w_lo, keys, 0, gens(200)))

        def fold():
            acc = OnlineAccumulator(ctx.ntt.p)
            order = np.random.default_rng(2).permutation(clients)
            for c in order:
                acc.fold((int(c), 0), tc.c0[c], tc.c1[c])
            if acc.fold((int(order[0]), 0), tc.c0[order[0]], tc.c1[order[0]]):
                raise AssertionError("a duplicate redelivery folded twice")
            return Ciphertext(*acc.value(), scale=tc.scale)

        hsum = timed("fold_s", fold)
        h_avg = timed("decrypt_s", lambda: decrypt_average(ctx, sk, hsum, clients, packing=spec,
                                                           base_params=params, hhe=True))
        if clip == 0.5:
            results = phase("evaluate_s", lambda: evaluate(
                model, h_avg, torch.from_numpy(xt).to(device), yt))
        direct, dsat = encrypt_stack_packed(ctx, pk, p_out, params, gens(200), spec)
        dsum = aggregate_encrypted(ctx, direct)
        d_avg = decrypt_average(ctx, sk, dsum, clients, packing=spec, base_params=params)
        fields = [deinterleave_fields(v, spec.k, spec.field_bits, spec.guard) for v in (
            hhe_center_mod(decode_int_center(ctx.ntt, decrypt(ctx, sk, hsum)), spec.guard),
            decode_int_center(ctx.ntt, decrypt(ctx, sk, dsum)))]
        if not np.array_equal(*fields) or not all(torch.equal(h_avg[k], d_avg[k]) for k in d_avg):
            raise AssertionError(f"clip {clip}: HHE and direct packed decodes differ")
        ref = plain_mean(p_out)
        errs = [max((avg[k] - ref[k]).abs().max().item() for k in ref) for avg in (h_avg, d_avg)]
        moved = max((h_avg[k] - params[k]).abs().max().item() for k in params)
        log(f"  clip {clip} (step {spec.step:.3e}, {100 * nonzero:.2f} % non-zero codes): HHE == "
            f"direct packed field sums and decoded average, bitwise (8 folds, 1 duplicate); "
            f"vs the plaintext mean HHE {errs[0]:.3e}, direct {errs[1]:.3e} (budget "
            f"{spec.error_budget:.3e}); average moved {moved:.3e}; saturation "
            f"{int(sat.sum())} / {int(dsat.sum())}; upload words {tuple(w_hi.shape)}, no kernel")
        if not max(errs) <= spec.error_budget or int(sat.sum()) or int(dsat.sum()):
            raise AssertionError(f"clip {clip}: a packed average is off the plaintext mean "
                                 "or saturated")
        expansion = hhe_bytes_on_wire_record(spec, ctx.num_primes)["expansion_hhe"]
        if not expansion <= 1.1:
            raise AssertionError(f"expansion_hhe {expansion} > 1.1")
        if clip == 0.5:
            device_time_breakdown("the clients' upload (8 clients)", lambda: hhe_encrypt_stack(
                p_out, params, keys, 0, spec))
            device_time_breakdown("provision + transcipher (8 clients)", lambda: transcipher_batch(
                ctx, spec, pk, w_hi, w_lo, keys, 0, gens(200)))
    if not 0.0 <= results["accuracy"] <= 1.0:
        raise AssertionError(f"bad evaluation {results}")
    log(f"  expansion_hhe {expansion}; test accuracy {results['accuracy']:.4f} (clip 0.5)")
    log("  phase times (s): " + json.dumps(times))
    return counts, shapes


# Phase 7's runs of `run_experiment`: (label, preset, rounds, epochs), each
# preset at its own width, data and ring, cut in rounds and local epochs only.
DRIVER_RUNS = (
    ("a", "medical-8", 2, 2),
    ("c", "medical-skew", 1, 1),
    ("d", "mnist-enc", 1, 1),
    ("e", "mnist-plain", 1, 1),
)
# Run (b): medical-8 as (a), round 0 with a checkpoint, then resumed to round 1.
RESUME_RUN = ("b", "medical-8", 2, 2)
# Run (f): cifar-resnet16 at full width (ResNet-20, 16 clients x 500 images),
# the fused backend, rounds 3 -> 1 and epochs 10 -> 2.
RESNET_RUN = ("f", "cifar-resnet16", 1, 2)
# Run (g): medical-8's round 0 under each training backend, from one seed.
# Their decrypted global models may differ by the JAX package's fused-vs-vmap
# tolerance (tests/test_perf.py): float reduction order, not semantics.
FUSION_RUN = ("g", "medical-8", 1, 2)
FUSED_VS_VMAP_TOL = 2e-2
# Runs (h): the CPU-sized smoke presets at their own sizes (hhe-smoke's ring
# is N = 256).
SMOKE_RUNS = (("h", "fusion-smoke"), ("h", "hhe-smoke"))


def expected_launches(cfg, out: dict, rounds_run: int) -> dict:
    """{(kernel, rows, N): launches} of `rounds_run` rounds of an encrypted
    preset (`round_launches`): on the synchronous engine every round trains
    every client and decrypts; a streaming run's rounds are read from its
    history (cohort size, decrypted or degraded), and a recovered hybrid-HE
    run adds one K7 a refolded upload. n_ct is ceil(params / N) on the float
    path, the packed rows on a packed path. Nothing for a plaintext
    preset."""
    if not cfg.encrypted:
        return {}
    replays = 0
    if out["packing"] is not None:
        n_ct = out["packing"]["n_ct"]
        if out["hhe"] is not None:
            replays = out["obs"]["metrics"].get("recovery.refolded_uploads", 0)
    else:
        n_ct = -(-sum(v.numel() for v in out["params"].values()) // cfg.he.n)
    rounds = (history_rounds(out) if cfg.stream is not None
              else [(cfg.num_clients, True)] * rounds_run)
    return round_launches(cfg, rounds, n_ct, replays)


def cut(name: str, rounds: int, epochs: int, fusion_backend=None, train_kw=None, **kw):
    """PRESETS[name] cut to `rounds` rounds of `epochs` local epochs, the
    training backend optionally pinned, other fields replaced by `kw` and
    TrainConfig fields by `train_kw`."""
    from hefl_tpu_torch.presets import PRESETS

    cfg = PRESETS[name]
    train = dataclasses.replace(cfg.train, epochs=epochs, **(train_kw or {}))
    if fusion_backend is not None:
        train = dataclasses.replace(train, client_fusion=fusion_backend)
    return dataclasses.replace(cfg, rounds=rounds, train=train, **kw)


# Synthetic datasets of phases 7-8, each made once: `make_dataset` is a pure
# function of (name, seed, sizes), and the host takes ~15 s for medical's
# 2,000 images at 256x256x3, which ten runs use.
_DATASETS: dict = {}


@contextlib.contextmanager
def datasets_once():
    """During the block, `run_experiment` and `flagship.flagship_setup` make
    each synthetic dataset once for the whole script."""
    from hefl_tpu_torch import data, experiment

    real = experiment.make_dataset

    def make_dataset(*a, **k):
        key = (a, tuple(sorted(k.items())))
        if key not in _DATASETS:
            _DATASETS[key] = real(*a, **k)
        return _DATASETS[key]

    experiment.make_dataset = data.make_dataset = make_dataset
    try:
        yield
    finally:
        experiment.make_dataset = data.make_dataset = real


@contextlib.contextmanager
def plain_references():
    """During the block, every secure round of `run_experiment` also returns
    its plaintext mean (the masked mean over the kept clients on the masked
    engine, whose return carries the RoundMeta after the overflow); yields
    the (mean, decrypted average) pair of each decrypted round, and the
    arguments of the last round call."""
    from hefl_tpu_torch import experiment

    real_round, real_decrypt = experiment.secure_fedavg_round, experiment.decrypt_average
    refs, pairs, calls = [], [], []

    def round_with_reference(*a, **k):
        calls[:] = [(a, k)]
        *outs, ref = real_round(*a, with_plain_reference=True, **k)
        refs.append(ref)
        return tuple(outs)

    def decrypt(*a, **k):
        avg = real_decrypt(*a, **k)
        pairs.append((refs[-1], avg))
        return avg

    experiment.secure_fedavg_round, experiment.decrypt_average = round_with_reference, decrypt
    try:
        yield pairs, calls
    finally:
        experiment.secure_fedavg_round, experiment.decrypt_average = real_round, real_decrypt


def drive(label: str, cfg, rounds_run: int, device, resume: bool = False,
          check_plain: bool = False, robust: bool = False):
    """One `run_experiment` run with its launches counted from zero, which
    must be exactly `expected_launches`; every round's metrics finite (on
    a robust run: every non-finite per-client metric belongs to an
    excluded client), its encode overflow 0 (not on a robust run, whose
    poisoned clients saturate), its accuracy in [0, 1], and the final
    parameters finite. `check_plain`: each decrypted round within ERR_LIMIT of its
    plaintext (masked) mean. The run's printed lines are captured and
    returned. -> (out, last round call, (counts, shapes), printed text)."""
    import io

    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.experiment import run_experiment
    from hefl_tpu_torch.models import count_params

    cuda_ntt.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with datasets_once(), plain_references() if check_plain else contextlib.nullcontext(
            ([], [])) as (pairs, calls), contextlib.redirect_stdout(printed):
        out = run_experiment(cfg, resume=resume, verbose=True, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    hist = out["history"]
    log(f"  ({label}) {cfg.model} {cfg.num_clients} clients, {cfg.partition}, "
        f"{'encrypted' if cfg.encrypted else 'plaintext'}, rounds "
        f"{[r['round'] for r in hist]} of {cfg.rounds}, {cfg.train.epochs} epochs, "
        f"{count_params(out['params']):,} params, training backend "
        f"{out['client_fusion']['backend']}: {wall:.3f} s")
    for rec in hist:
        log(f"    round {rec['round']}: phases (s) {json.dumps(rec['phases'])}; accuracy "
            f"{rec['accuracy']:.4f} f1 {rec['f1']:.4f}; val_loss {rec['val_loss']}; "
            f"encode_overflow {rec.get('encode_overflow')}"
            + (f"; robust {json.dumps(rec['robust'])}" if "robust" in rec else "")
            + (f"; dp_epsilon {rec['dp_epsilon']}" if "dp_epsilon" in rec else ""))
    log_launch_rows(shapes)
    want = expected_launches(cfg, out, rounds_run)
    if shapes != want:
        raise AssertionError(f"({label}) launched {shapes}, expected exactly {want}")
    if len(hist) != rounds_run:
        raise AssertionError(f"({label}) ran {len(hist)} rounds, expected {rounds_run}")
    for rec in hist:
        finite = np.isfinite(rec["val_loss"]) & np.isfinite(rec["val_acc"])
        kept = (np.asarray(rec["robust"]["participation"]) == 1 if robust
                else np.ones(len(finite), bool))
        if not finite[kept].all() or not 0.0 <= rec["accuracy"] <= 1.0:
            raise AssertionError(f"({label}) bad round record {rec}")
        if cfg.encrypted and not robust and rec["encode_overflow"] != [0] * cfg.num_clients:
            raise AssertionError(f"({label}) encode overflow {rec['encode_overflow']}")
        if not cfg.encrypted and "encode_overflow" in rec:
            raise AssertionError(f"({label}) a plaintext round recorded encode_overflow")
    if not all(torch.isfinite(v).all().item() for v in out["params"].values()):
        raise AssertionError(f"({label}) non-finite parameters")
    if out["hhe"] is not None and not out["hhe"]["expansion_hhe"] <= 1.1:
        raise AssertionError(f"({label}) expansion_hhe {out['hhe']['expansion_hhe']} > 1.1")
    if check_plain:
        errs = [max((avg[k] - ref[k]).abs().max().item() for k in ref) for ref, avg in pairs]
        log(f"    decrypted average vs plaintext mean per round: max abs err {errs} "
            f"(limit {ERR_LIMIT})")
        if len(errs) != rounds_run or not all(e <= ERR_LIMIT for e in errs):
            raise AssertionError(f"({label}) decrypted averages off the plaintext means: {errs}")
    return out, calls, (counts, shapes), printed.getvalue()


def driver_runs(device) -> list[tuple[dict, dict]]:
    """Phase 7: `experiment.run_experiment`, the port's experiment driver, on
    BASELINE.json's presets at full width (medical-8, medical-skew: MedCNN
    256x256x3, 8 clients x 200 images; mnist-enc, mnist-plain: SmallCNN, 2
    clients x 4000 images; cifar-resnet16: ResNet-20 32x32x3, 16 clients x
    500 images; N=4096, L=3 primes of 27 bits, scale 2^30), cut in rounds
    and epochs only (DRIVER_RUNS, RESUME_RUN, RESNET_RUN, FUSION_RUN), and
    the smoke presets fusion-smoke and hhe-smoke (N = 256) at their own
    sizes (SMOKE_RUNS); each run through `drive`. Runs (a), (f) and (g)
    also ask each of their rounds for the plaintext mean of the same
    trained weights (`with_plain_reference`): the driver's decrypted
    average must sit within ERR_LIMIT of it. (g)'s fused and vmap global
    models must agree within FUSED_VS_VMAP_TOL, and each backend's warm
    round is profiled (torch.profiler)."""
    import os
    import tempfile

    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.fl import fusion
    from hefl_tpu_torch.fl.client import train_batch_geometry
    from hefl_tpu_torch.models import count_params, create_model
    from hefl_tpu_torch.presets import PRESETS
    from hefl_tpu_torch.utils import load_checkpoint

    runs = []

    def run(label, cfg, rounds_run, **kw):
        out, calls, launched, _ = drive(label, cfg, rounds_run, device, **kw)
        runs.append(launched)
        return out, calls

    load = os.getloadavg()
    log(f"  host: {os.cpu_count()} CPUs, load average {load[0]:.2f} / {load[1]:.2f} / "
        f"{load[2]:.2f} (1 / 5 / 15 min)")
    t = time.perf_counter()
    outs = {}
    for label, name, rounds, epochs in DRIVER_RUNS:
        outs[label], _ = run(label, cut(name, rounds, epochs), rounds, check_plain=label == "a")
        if label == "a":
            label_b, name_b, rounds_b, epochs_b = RESUME_RUN
            with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                             prefix=".chip_smoke_") as tmp:
                ck = str(Path(tmp) / "round.npz")
                first, _ = run(f"{label_b}, round 0", cut(name_b, 1, epochs_b,
                                                          checkpoint_path=ck), 1)
                saved, next_round, _, _ = load_checkpoint(ck, first["params"])
                if next_round != 1 or not all(torch.equal(saved[k], first["params"][k])
                                              for k in saved):
                    raise AssertionError("the round checkpoint does not restore round 0's params")
                log("    checkpoint: next round 1, restored params == saved params, bitwise")
                resumed, _ = run(f"{label_b}, resumed", cut(name_b, rounds_b, epochs_b,
                                                            checkpoint_path=ck), 1, resume=True)
            if resumed["history"][0]["round"] != 1:
                raise AssertionError("the resumed run did not start at round 1")
            diff = max((resumed["params"][k] - outs["a"]["params"][k]).abs().max().item()
                       for k in resumed["params"])
            log(f"    resumed round 1 vs (a)'s round 1: max |params diff| {diff:.3e} "
                "(cuDNN's backward is not bitwise deterministic on the card; not checked)")
    log(f"  phase 7 (a)-(e) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    label, name, rounds, epochs = RESNET_RUN
    out, _ = run(label, cut(name, rounds, epochs, "fused"), rounds, check_plain=True)
    if count_params(out["params"]) != 272_474:
        raise AssertionError(f"ResNet-20 has {count_params(out['params'])} params, expected 272,474")
    log(f"  phase 7 (f) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    label, name, rounds, epochs = FUSION_RUN
    by_backend = {}
    for backend in ("vmap", "fused"):
        cfg = cut(name, rounds, epochs, backend)
        out, calls = run(f"{label}, {backend}", cfg, rounds, check_plain=True)
        (a, k), = calls
        _, grp, steps = train_batch_geometry(cfg.train, int(a[5].shape[1]))
        n_steps = cfg.train.epochs * steps * (cfg.num_clients if backend == "vmap" else 1)
        train_s = out["history"][0]["phases"]["train+encrypt+aggregate"]
        log(f"    {backend}: train+encrypt+aggregate {train_s:.4f} s for {n_steps} training steps "
            f"({1e3 * train_s / n_steps:.2f} ms a step; batch {grp} a client)")
        device_time_breakdown(f"warm medical-8 round ({backend}, {n_steps} steps)",
                              lambda: experiment.secure_fedavg_round(*a, **k), top=12)
        by_backend[backend] = out
    diff = max((by_backend["fused"]["params"][k] - by_backend["vmap"]["params"][k]).abs().max()
               .item() for k in by_backend["vmap"]["params"])
    log(f"    fused vs vmap decrypted global models: max abs diff {diff:.3e} "
        f"(limit {FUSED_VS_VMAP_TOL})")
    if not diff <= FUSED_VS_VMAP_TOL:
        raise AssertionError(f"fused and vmap rounds differ by {diff}")
    saved_env = os.environ.pop("HEFL_CLIENT_FUSION", None)
    try:
        probe_model = create_model("smallcnn", device=device)
        chosen = fusion.resolve_fusion_backend("auto", probe_model, device)
    finally:
        if saved_env is not None:
            os.environ["HEFL_CLIENT_FUSION"] = saved_env
    log(f"    auto resolved to {chosen!r} on this card: {json.dumps(fusion.fusion_report())}")
    log(f"  phase 7 (g) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    for label, name in SMOKE_RUNS:
        cfg = PRESETS[name]
        out, _ = run(f"{label}, {name}", cfg, cfg.rounds)
        if out["hhe"] is not None:
            log(f"    hhe record: {json.dumps(out['hhe'])}")
    log(f"  phase 7 (h) wall time: {time.perf_counter() - t:.3f} s")
    return runs


# Phase 8, run (i): medical-8's fault schedule — 2 of 8 clients dropped, one
# NaN-poisoned, one +1e15-poisoned, 2 stragglers of up to 0.2 s, a device
# loss on round 1's first attempt — with the norm bound and overflow
# exclusion on; run (j): DP-FedAvg under 25 % dropout (derived floor 6).
ROBUST_FAULTS = dict(seed=0, drop_fraction=0.25, nan_clients=1, huge_clients=1,
                     straggler_fraction=0.25, straggler_delay_s=0.2, fail_rounds=(1,))
ROBUST_TRAIN = dict(on_overflow="exclude", max_update_norm=50.0)
DP_RUN = dict(clip_norm=1.0, noise_multiplier=1.0, delta=1e-5)
DP_STD_TOL = 0.02                    # the noise's std within 2 % of sigma*C/sqrt(K_cal)


@contextlib.contextmanager
def timed_calls(module, names):
    """During the block, each call of `module.<name>` for `names` is timed
    (host clock around the call, synchronized before and after): yields
    {name: [(seconds, args, result), ...]}."""
    real = {n: getattr(module, n) for n in names}
    calls = {n: [] for n in names}

    def timed(n):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real[n](*a, **k)
            torch.cuda.synchronize()
            calls[n].append((time.perf_counter() - t0, a, res))
            return res
        return wrapper

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def robust_runs(device) -> tuple[list[tuple[dict, dict]], list]:
    """Phase 8: robust and private rounds through `run_experiment` at full
    width (MedCNN 256x256x3, 222,722 parameters, medical-8's 8 clients x 200
    images, N=4096, L=3, scale 2^30), cut in rounds and epochs only, each
    run through `drive` (launches exactly `expected_launches`: every
    client's rows are encrypted, so K3 keeps its unmasked shape).

    (i) medical-8, 2 rounds x 1 epoch, fused, under ROBUST_FAULTS with
    ROBUST_TRAIN and one retry: each round's `robust` record must be what
    `schedule_for_round` and the sanitizing predicates give (2 scheduled, 1
    non-finite, the huge client under norm and overflow; 4 surviving; one
    retry on round 1 only) and its decrypted average within ERR_LIMIT of
    the masked plaintext mean; beside it the unmasked twin (same cut), and
    the sanitizer's time (exclusion bits, the masked select of the rows).
    (j) medical-8, 1 round x 1 epoch, DP_RUN under 25 % dropout: the floor
    recalibrated to 6, the decrypt within ERR_LIMIT of the masked mean of
    the sanitized weights, `dp_epsilon` the accountant's, and each client's
    noise (sanitized - global - clipped delta, 222,722 coordinates) with a
    standard deviation within DP_STD_TOL of sigma*C/sqrt(6) and a mean
    within 4 standard errors of 0; the time of DP sanitizing 8 clients and
    the kernels it launches. (k) chaos-smoke at its own size (SmallCNN,
    N=256, 8 clients, 4 rounds): each round's surviving count, exclusions
    and retries equal CHAOS_SMOKE.json's; the clean twin's accuracy is
    printed beside it, ungated (its streams are not the JAX run's).
    -> (the runs' launches, the train + encrypt + aggregate seconds of each
    round of (i)'s unmasked twin, the synchronous full-cohort round that
    phase 9 prints beside its streaming one)."""
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.fl.dp import DpConfig, clip_by_global_norm, epsilon_spent
    from hefl_tpu_torch.fl.faults import (
        EXCLUDED_NONFINITE,
        EXCLUDED_NORM,
        EXCLUDED_OVERFLOW,
        EXCLUDED_SCHEDULED,
        POISON_HUGE,
        POISON_NAN,
        FaultConfig,
        RoundMeta,
        schedule_for_round,
    )
    from hefl_tpu_torch.models import count_params
    from hefl_tpu_torch.presets import PRESETS

    runs = []

    def run(label, cfg, rounds_run, **kw):
        out, calls, launched, printed = drive(label, cfg, rounds_run, device, **kw)
        runs.append(launched)
        return out, calls, printed

    def train_s(out):
        return [rec["phases"]["train+encrypt+aggregate"] for rec in out["history"]]

    t = time.perf_counter()
    clean, _, _ = run("i, unmasked twin", cut("medical-8", 2, 1, "fused"), 2, check_plain=True)
    faults = FaultConfig(**ROBUST_FAULTS)
    cfg = cut("medical-8", 2, 1, "fused", train_kw=ROBUST_TRAIN, faults=faults,
              max_round_retries=1, retry_backoff_s=0.1)
    with timed_calls(secure, ("exclusion_bits", "zero_excluded")) as san:
        out, _, printed = run("i", cfg, 2, check_plain=True, robust=True)
    if count_params(out["params"]) != 222_722:
        raise AssertionError(f"MedCNN has {count_params(out['params'])} params")
    for line in printed.splitlines():
        if "failed" in line or "excluded" in line:
            log(f"    | {line}")
    for rec in out["history"]:
        sched = schedule_for_round(faults, rec["round"], cfg.num_clients)
        bits = (np.where(sched.dropped, EXCLUDED_SCHEDULED, 0)
                | np.where(sched.poison == POISON_NAN, EXCLUDED_NONFINITE, 0)
                | np.where(sched.poison == POISON_HUGE, EXCLUDED_NORM | EXCLUDED_OVERFLOW, 0))
        want = RoundMeta.from_bits(bits).record()
        got = {k: rec["robust"][k] for k in want}
        retries = 1 if rec["round"] in faults.fail_rounds else 0
        if got != want or want["surviving"] != 4 or rec["robust"]["round_retries"] != retries:
            raise AssertionError(f"(i) round {rec['round']}: robust {rec['robust']}, expected "
                                 f"{want} with {retries} retries")
    san_s = [sum(s for s, *_ in calls) for calls in zip(san["exclusion_bits"],
                                                        san["zero_excluded"])]
    masked_s, clean_s = train_s(out), train_s(clean)
    strag = [rec["robust"]["faults"]["straggler_s"] for rec in out["history"]]
    log(f"    (i) train+encrypt+aggregate a round: masked {masked_s} s (straggler waits "
        f"{strag} s: {[round(m - w, 4) for m, w in zip(masked_s, strag)]} s without), "
        f"unmasked twin {clean_s} s; sanitizer (exclusion bits + masked select of the rows) "
        f"{[round(s, 6) for s in san_s]} s, "
        f"{[round(100 * s / (m - w), 3) for s, m, w in zip(san_s, masked_s, strag)]} % of the "
        "round without its straggler wait")

    with timed_calls(secure, ("dp_sanitize",)) as dps:
        cfg = cut("medical-8", 1, 1, "fused", dp=DpConfig(**DP_RUN),
                  faults=FaultConfig(seed=0, drop_fraction=0.25))
        out, _, printed = run("j", cfg, 1, check_plain=True, robust=True)
    floor_line = "dp: noise shares recalibrated to a surviving-cohort floor of 6/8 clients"
    if floor_line not in printed:
        raise AssertionError(f"(j) did not recalibrate the noise floor to 6: {printed!r}")
    log(f"    | {floor_line} ...")
    rec, = out["history"]
    if rec["dp_epsilon"] != epsilon_spent(1, DP_RUN["noise_multiplier"], DP_RUN["delta"]):
        raise AssertionError(f"(j) dp_epsilon {rec['dp_epsilon']}")
    if rec["robust"]["surviving"] != 6:
        raise AssertionError(f"(j) robust {rec['robust']}")
    share = DP_RUN["noise_multiplier"] * DP_RUN["clip_norm"] / np.sqrt(6)
    stats = []
    for _, (_, gp, trained, dp_cfg, k_cal), (sane, _) in dps["dp_sanitize"]:
        if k_cal != 6:
            raise AssertionError(f"(j) shares calibrated to {k_cal} clients, expected 6")
        clipped, _ = clip_by_global_norm({k: trained[k] - gp[k] for k in trained},
                                         dp_cfg.clip_norm)
        noise = torch.cat([(sane[k] - gp[k] - clipped[k]).flatten() for k in gp]).double()
        std, mean = noise.std().item(), noise.mean().item()
        stats.append((round(std, 6), round(mean, 8)))
        if noise.numel() != 222_722 or not (abs(std - share) <= DP_STD_TOL * share
                                            and abs(mean) <= 4 * std / np.sqrt(noise.numel())):
            raise AssertionError(f"(j) noise std {std} / mean {mean} against share {share:.6f}")
    dp_s = sum(s for s, *_ in dps["dp_sanitize"])
    log(f"    (j) noise (std, mean) per client {stats}; share sigma*C/sqrt(6) = {share:.6f} "
        f"(std within {DP_STD_TOL:.0%}, mean within 4 standard errors); dp_sanitize of 8 x "
        f"222,722 weights {dp_s:.6f} s of the {train_s(out)[0]} s round")
    args = [a for _, a, _ in dps["dp_sanitize"]]
    gens = [torch.Generator(device=device).manual_seed(i) for i in range(len(args))]
    device_time_breakdown("dp_sanitize x 8 clients (one warm call each)", lambda: [
        secure.dp_sanitize(g, *a[1:]) for g, a in zip(gens, args)], top=6)
    log(f"  phase 8 (i)-(j) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    gate = json.loads((Path(__file__).resolve().parent / "CHAOS_SMOKE.json").read_text())
    cfg = PRESETS["chaos-smoke"]
    out, _, printed = run("k, chaos-smoke", cfg, cfg.rounds, robust=True)
    for line in printed.splitlines():
        if "failed" in line:
            log(f"    | {line}")
    for rec, ref in zip(out["history"], gate["rounds"]):
        rob = rec["robust"]
        got = {"round": rec["round"], "surviving": rob["surviving"],
               "excluded": {k: rob["excluded"][k] for k in ref["excluded"]},
               "retries": rob["round_retries"]}
        want = {k: ref[k] for k in got}
        extra = {k: v for k, v in rob["excluded"].items() if k not in ref["excluded"] and v}
        if got != want or extra:
            raise AssertionError(f"(k) round {rec['round']}: {got} {extra}, CHAOS_SMOKE.json "
                                 f"has {want}")
    twin, _, _ = run("k, chaos-smoke clean twin", dataclasses.replace(cfg, faults=None),
                     cfg.rounds)
    log(f"    (k) rounds equal CHAOS_SMOKE.json's surviving / excluded / retries; accuracy by "
        f"round {[rec['accuracy'] for rec in out['history']]}, clean twin "
        f"{[rec['accuracy'] for rec in twin['history']]} (not gated); train+encrypt+aggregate "
        f"{train_s(out)} s a round")
    log(f"  phase 8 (k) wall time: {time.perf_counter() - t:.3f} s")
    return runs, clean_s


# Phase 9: the streaming service. (l)'s stream knobs and the chaos-smoke
# stream faults (run_chaos_smoke.sh's streaming twin), at medical-8's width.
STREAM_KNOBS = dict(cohort_size=4, quorum=0.75, deadline_s=2.0, max_retries=1, seed=0)
STREAM_FAULTS = dict(straggler_fraction=0.25, straggler_delay_s=6.0, arrival_delay_s=0.5,
                     duplicate_clients=1, transient_fail_clients=1)


def host_stream_record(stream, faults, round_index: int, num_clients: int) -> dict:
    """The `stream` record of a flat round without staleness carries or
    sanitizer rejects, from the schedules alone (`host_stream_round`)."""
    return host_stream_round(stream, faults, round_index, num_clients)[0]


def host_stream_round(stream, faults, round_index: int, num_clients: int):
    """A flat round without staleness carries or sanitizer rejects, from
    the schedules alone: `sample_cohort`, the fault schedule's dropouts and
    `schedule_arrivals`, the engine's `_retry_times`, then the deliveries in
    (t, seq) order against the dedup set, the deadline and the quorum.
    -> (the `stream` record, the clients folded, the commit time or None)."""
    from hefl_tpu_torch.fl.faults import schedule_arrivals, schedule_for_round
    from hefl_tpu_torch.fl.stream import StreamEngine, quorum_count, sample_cohort

    cohort = sample_cohort(stream, round_index, num_clients)
    sched = schedule_for_round(faults, round_index, num_clients)
    arr = schedule_arrivals(faults, round_index, num_clients)
    retry_times = StreamEngine(stream)._retry_times
    events, retries, unreachable = [], 0, 0
    for c in cohort:
        if sched.dropped[c]:
            continue
        t0 = float(arr.arrival_s[c])
        if arr.permanent[c] or arr.transient[c]:
            times = retry_times(round_index, int(c), t0)
            retries += len(times) if arr.permanent[c] else min(len(times), 1)
            if arr.permanent[c] or not times:
                unreachable += 1
            else:
                events.append((times[0], True, int(c)))
            continue
        events.append((t0, False, int(c)))
        if arr.duplicate[c]:
            events.append((t0 + max(stream.retry_backoff_s * 0.5, 1e-6), False, int(c)))
    deadline = stream.deadline_s if stream.deadline_s > 0 else float("inf")
    quorum = quorum_count(stream, len(cohort))
    fresh = dups = 0
    seen, committed_at, last_t, folded = set(), None, 0.0, []
    for _, (t, retried, c) in sorted(enumerate(events), key=lambda e: (e[1][0], e[0])):
        last_t = max(last_t, t)
        if c in seen:
            dups += 1
            continue
        seen.add(c)
        if committed_at is None and (t <= deadline or retried):
            fresh += 1
            folded.append(c)
            if fresh >= quorum:
                committed_at = t
    commit_s = (committed_at if committed_at is not None
                else min(max(last_t, 0.0), deadline) if events else 0.0)
    return {"cohort": [int(c) for c in cohort], "quorum": quorum,
            "committed": committed_at is not None,
            "degraded_reason": None if committed_at is not None else "quorum",
            "fresh": fresh, "stale_folded": 0, "carried": 0, "stale_excluded": 0,
            "unreachable": unreachable, "arrivals": len(events), "duplicates": dups,
            "rejected": 0, "retries": retries, "commit_s": round(commit_s, 6)}, folded, committed_at


def round_launches(cfg, rounds, n_ct: int, replays: int = 0) -> dict:
    """{(kernel, rows, N): launches} of an encrypted run's `rounds`, each a
    (cohort size, decrypted) pair: K1 twice in keygen (s and e, one [L, N]
    row block each); per round one K3 over the trained slots' n_ct
    ciphertexts each — fedavg.cohort_bucket's slots on a cohort-only
    sampled streaming round, every client's otherwise — or, on the
    hybrid-HE path, one K3 (the pads) and one K7 over the slots' packed
    rows; one K4 over the sum's n_ct a decrypted round; and one K7 a
    journal-replayed hybrid-HE upload (`replays`)."""
    from hefl_tpu_torch.fl.fedavg import cohort_bucket

    n, num_l, c = cfg.he.n, cfg.he.num_primes, cfg.num_clients
    hhe = cfg.stream is not None and cfg.stream.upload_kind == "hhe"
    want = {("ntt_forward", num_l, n): 2}

    def add(key, count=1):
        if count:
            want[key] = want.get(key, 0) + count

    for size, decrypted in rounds:
        sampled = cfg.stream is not None and cfg.stream.cohort_only and size < c
        slots = size if (hhe and sampled) else cohort_bucket(size, c) if sampled else c
        add(("encrypt_fused", slots * n_ct * num_l, n))
        if hhe:
            add(("transcipher_fused", slots * n_ct * num_l, n))
        add(("decrypt_fused", n_ct * num_l, n), int(decrypted))
    add(("transcipher_fused", n_ct * num_l, n), replays)
    return want


def history_rounds(out) -> list:
    return [(len(rec["stream"]["cohort"]), rec["robust"]["surviving"] > 0)
            for rec in out["history"]]


@contextlib.contextmanager
def stream_references():
    """During the block, each streaming round's trained weights (the
    cohort-rowed uploads' plaintexts, `client_uploads`' fourth output) and
    each decrypted average are captured; yields the (plaintext mean of the
    clients the round released, decrypted average) pair of each decrypted
    round."""
    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.fl import stream as stream_mod

    real_up, real_dec = stream_mod.client_uploads, experiment.decrypt_average
    last, pairs = {}, []

    def uploads(*a, **k):
        out = real_up(*a, **k)
        cohort = k.get("cohort")
        last["rows"] = list(cohort) if cohort is not None else list(range(int(a[5].shape[0])))
        last["p_out"] = out[3]
        return out

    def decrypt(*a, **k):
        avg = real_dec(*a, **k)
        kept = [c for c, on in enumerate(k["meta"].participation) if on]
        rows = [last["rows"].index(c) for c in kept]
        ref = {name: torch.stack([last["p_out"][r][name] for r in rows]).mean(dim=0)
               for name in avg}
        pairs.append((ref, avg))
        return avg

    stream_mod.client_uploads, experiment.decrypt_average = uploads, decrypt
    try:
        yield pairs
    finally:
        stream_mod.client_uploads, experiment.decrypt_average = real_up, real_dec


def journal_commits(path) -> dict:
    from hefl_tpu_torch.fl import journal as jr

    return {r["round"]: r["sum_sha"] for r in jr.read_journal(path) if r["kind"] == "commit"}


def crash_run(label: str, cfg, device, want: dict) -> None:
    """`run_experiment` with a CrashConfig: it must raise SimulatedCrash,
    with exactly `want` launched before."""
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.experiment import run_experiment
    from hefl_tpu_torch.fl.faults import SimulatedCrash

    cuda_ntt.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with datasets_once():
            run_experiment(cfg, verbose=False, device=device)
    except SimulatedCrash as e:
        log(f"  ({label}) {cfg.crash}: SimulatedCrash ({e}) after {time.perf_counter() - t0:.3f} s")
    else:
        raise AssertionError(f"({label}) ran to its end through {cfg.crash}")
    torch.cuda.synchronize()
    shapes = cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    if shapes != want:
        raise AssertionError(f"({label}) launched {shapes}, expected exactly {want}")
    return cuda_ntt.launch_counts(), shapes


def stream_runs(device, sync_twin_s: list) -> list[tuple[dict, dict]]:
    """Phase 9: the durable streaming aggregation service through
    `run_experiment`, each run through `drive` (launches exactly
    `expected_launches`). (l) medical-8 at full width (MedCNN 256x256x3,
    222,722 parameters, N=4096, L=3), 2 rounds x 1 epoch, fused, under
    STREAM_KNOBS (a cohort of 4 of 8: K3 at [220, 3, 4096]) and the
    chaos-smoke stream faults: each round's `stream` record equals
    `host_stream_record`, each decrypted average sits within ERR_LIMIT of
    the plaintext mean of the released clients' trained weights, and the
    run's stream.* counters are the sums over its rounds. (m) (l) with
    tau = 1 and a write-ahead journal three ways — the uninterrupted
    journaled twin, the same run crashed by CrashConfig(round=1,
    at="mid_append", after_folds=2) (a 24-byte torn tail), and the
    recovery run (the journal's sealed round 0 and open round 1 replayed):
    the recovered report, the commit sum_sha chain and the final
    parameters bitwise the twin's, recovery.refolded_uploads the fold
    records the crash left; the journal's appends, bytes and fsyncs a
    round, the host seconds of its fold records (ct_body: the device-to-host
    copy; sha256), the recovery latency, and the cost of the deterministic
    algorithms a journaled run trains under (client_uploads of (l) against
    (m)'s twin). (n) chaos-smoke's streaming twin (N=256, 8 clients, 4
    rounds, quorum 3/8, deadline 2 s, one retry, tau = 1): its rounds and
    stream.* counters equal CHAOS_SMOKE.json's stream_check. (o) its
    cohort-only twin and full-C twin (cohort 6 of 8): final parameters
    bitwise equal. (p) hhe-smoke journaled, crashed after round 1's 2nd
    fold, recovered: the replay re-transciphers each persisted symmetric
    upload through K7 at [294, 3, 256], and the sum_sha chain equals the
    uninterrupted journaled twin's."""
    import tempfile

    from hefl_tpu_torch.fl import journal as jr
    from hefl_tpu_torch.fl import stream as stream_mod
    from hefl_tpu_torch.fl.config import StreamConfig
    from hefl_tpu_torch.fl.faults import CrashConfig, FaultConfig
    from hefl_tpu_torch.presets import PRESETS

    runs = []

    def run(label, cfg, rounds_run):
        out, _, launched, printed = drive(label, cfg, rounds_run, device, robust=True)
        runs.append(launched)
        return out, printed

    def train_s(out):
        return [rec["phases"]["train+encrypt+aggregate"] for rec in out["history"]]

    stream_keys = ("stream.arrivals", "stream.duplicates", "stream.retries", "stream.folds",
                   "stream.late_carried", "stream.stale_excluded", "stream.rejected")

    def counters_are_round_sums(label, out):
        hist = [rec["stream"] for rec in out["history"]]
        want = {"stream.arrivals": sum(h["arrivals"] for h in hist),
                "stream.duplicates": sum(h["duplicates"] for h in hist),
                "stream.retries": sum(h["retries"] for h in hist),
                "stream.folds": sum(h["fresh"] + h["stale_folded"] for h in hist),
                "stream.late_carried": sum(h["carried"] for h in hist),
                "stream.stale_excluded": sum(h["stale_excluded"] for h in hist),
                "stream.rejected": sum(h["rejected"] for h in hist)}
        got = {k: out["obs"]["metrics"].get(k) for k in stream_keys}
        if got != want:
            raise AssertionError(f"({label}) stream counters {got}, round sums {want}")

    t = time.perf_counter()
    stream = StreamConfig(**STREAM_KNOBS)
    faults = FaultConfig(seed=0, **STREAM_FAULTS)
    cfg_l = cut("medical-8", 2, 1, "fused", stream=stream, faults=faults)
    with stream_references() as pairs, timed_calls(stream_mod, ("client_uploads",)) as up_l:
        out_l, _ = run("l", cfg_l, 2)
    for rec in out_l["history"]:
        want = host_stream_record(stream, faults, rec["round"], cfg_l.num_clients)
        if rec["stream"] != want:
            raise AssertionError(f"(l) round {rec['round']}: stream {rec['stream']}, the "
                                 f"schedules give {want}")
        log(f"    (l) round {rec['round']}: stream {json.dumps(rec['stream'])}")
    errs = [max((avg[k] - ref[k]).abs().max().item() for k in ref) for ref, avg in pairs]
    log(f"    (l) decrypted average vs the released clients' plaintext mean: max abs err {errs} "
        f"(limit {ERR_LIMIT})")
    if len(errs) != sum(d for _, d in history_rounds(out_l)) or not errs or max(errs) > ERR_LIMIT:
        raise AssertionError(f"(l) decrypted averages off their plaintext means: {errs}")
    counters_are_round_sums("l", out_l)
    log(f"    (l) train+encrypt+aggregate a round: {train_s(out_l)} s (cohort 4 of 8, streaming); "
        f"the synchronous full-cohort round at the same cut (phase 8 (i)'s unmasked twin): "
        f"{sync_twin_s} s")

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix="chip_smoke_journal_") as tmp:
        cfg_m = dataclasses.replace(cfg_l, stream=dataclasses.replace(stream, staleness_rounds=1),
                                    fsync_policy="commit")
        twin_path, crash_path = f"{tmp}/twin.wal", f"{tmp}/crash.wal"
        with (timed_calls(stream_mod, ("client_uploads",)) as up_m,
              timed_calls(jr, ("ct_body",)) as bodies,
              timed_calls(jr.RoundSession, ("fold",)) as folds):
            twin, _ = run("m, journaled twin", dataclasses.replace(cfg_m, journal_path=twin_path),
                          2)
        m = twin["obs"]["metrics"]
        body = bodies["ct_body"][0][2]
        t_sha = time.perf_counter()
        hashlib.sha256(body).hexdigest()
        sha_s = time.perf_counter() - t_sha
        log(f"    (m) journal a round: {m['journal.appends'] / 2} appends, "
            f"{m['journal.bytes_written'] / 2:.0f} bytes, {m['journal.fsyncs'] / 2} fsyncs "
            f"(policy commit); {len(bodies['ct_body'])} persisted bodies of {len(body)} bytes: "
            f"ct_body (device-to-host copy) {[round(x[0], 6) for x in bodies['ct_body']]} s, "
            f"RoundSession.fold (ct_body + sha256 + append) "
            f"{[round(x[0], 6) for x in folds['fold']]} s, sha256 of one body {sha_s:.6f} s")
        log(f"    (m) client_uploads (train + encrypt a cohort of 4): {[round(x[0], 4) for x in up_l['client_uploads']]} s "
            f"in (l) without, {[round(x[0], 4) for x in up_m['client_uploads']]} s in (m) "
            "under torch.use_deterministic_algorithms; train+encrypt+aggregate a round "
            f"{train_s(twin)} s")
        crash_cfg = dataclasses.replace(cfg_m, journal_path=crash_path,
                                        crash=CrashConfig(round=1, at="mid_append", after_folds=2))
        want_crash = round_launches(cfg_m, history_rounds(twin)[:1] + [(4, False)], 55)
        runs.append(crash_run("m, crashed", crash_cfg, device, want_crash))
        scan = jr.scan_journal(crash_path)
        folds_before = sum(r["kind"] == "fold" for r in scan.records)
        if scan.torn_bytes != 24:
            raise AssertionError(f"(m) the crash left a torn tail of {scan.torn_bytes} bytes")
        rec_out, _ = run("m, recovery", dataclasses.replace(crash_cfg, crash=None), 2)
        rep = rec_out["journal"]["recovered"]
        log(f"    (m) recovered: {json.dumps(rep)}; recovery.latency_s "
            f"{rec_out['obs']['metrics']['recovery.latency_s']['sum']} s, refolded uploads "
            f"{rec_out['obs']['metrics']['recovery.refolded_uploads']} (fold records the crash "
            f"left: {folds_before})")
        if (rep["torn_bytes_truncated"], rep["open_round"]) != (24, 1):
            raise AssertionError(f"(m) recovery report {rep}")
        chain, twin_chain = journal_commits(crash_path), journal_commits(twin_path)
        if chain != twin_chain or len(chain) != 2:
            raise AssertionError(f"(m) commit chain {chain}, the twin's {twin_chain}")
        if not all(torch.equal(rec_out["params"][k], twin["params"][k]) for k in twin["params"]):
            raise AssertionError("(m) the recovered parameters differ from the twin's")
        if rec_out["obs"]["metrics"]["recovery.refolded_uploads"] != folds_before:
            raise AssertionError("(m) recovery did not refold every journaled upload")
        log(f"    (m) commit sum_sha chain bitwise the twin's: {chain}")
    log(f"  phase 9 (l)-(m) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    gate = json.loads((Path(__file__).resolve().parent / "CHAOS_SMOKE.json").read_text())
    chaos = PRESETS["chaos-smoke"]
    cfg_n = dataclasses.replace(
        chaos, faults=dataclasses.replace(chaos.faults, **STREAM_FAULTS),
        stream=StreamConfig(quorum=0.375, deadline_s=2.0, max_retries=1, staleness_rounds=1,
                            seed=0))
    out_n, _ = run("n, chaos-smoke streaming twin", cfg_n, cfg_n.rounds)
    ref = gate["stream_check"]
    for rec, want in zip(out_n["history"], ref["rounds"]):
        got = {k: rec["round"] if k == "round" else rec["stream"][k] for k in want}
        if got != want:
            raise AssertionError(f"(n) round {rec['round']}: {got}, CHAOS_SMOKE.json has {want}")
    got = {k: out_n["obs"]["metrics"].get(k) for k in ref["counters"]}
    if got != ref["counters"]:
        raise AssertionError(f"(n) counters {got}, CHAOS_SMOKE.json has {ref['counters']}")
    log(f"    (n) rounds and counters equal CHAOS_SMOKE.json's stream_check: {json.dumps(got)}")
    cohort = StreamConfig(cohort_size=6, quorum=0.3, deadline_s=2.0, max_retries=1,
                          staleness_rounds=1, seed=0)
    outs = {}
    for only in (True, False):
        cfg_o = dataclasses.replace(cfg_n, stream=dataclasses.replace(cohort, cohort_only=only))
        outs[only], _ = run(f"o, cohort {'only' if only else 'full-C'}", cfg_o, cfg_o.rounds)
        # Unsampled clients are attributed "unsampled" unless a carried
        # upload of theirs folded this round.
        if not all(rec["stream"]["committed"] and rec["robust"]["excluded"]["unsampled"] == sum(
                c not in rec["stream"]["cohort"] and not on
                for c, on in enumerate(rec["robust"]["participation"]))
                   for rec in outs[only]["history"]):
            raise AssertionError(f"(o) rounds {[rec['stream'] for rec in outs[only]['history']]}")
    if not all(torch.equal(outs[True]["params"][k], outs[False]["params"][k])
               for k in outs[True]["params"]):
        raise AssertionError("(o) the cohort-only run's parameters differ from the full-C run's")
    log("    (o) cohort-only and full-C final parameters bitwise equal")
    log(f"  phase 9 (n)-(o) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix="chip_smoke_journal_") as tmp:
        hhe = dataclasses.replace(PRESETS["hhe-smoke"], fsync_policy="commit")
        twin, _ = run("p, hhe-smoke journaled twin",
                      dataclasses.replace(hhe, journal_path=f"{tmp}/twin.wal"), hhe.rounds)
        crash_cfg = dataclasses.replace(hhe, journal_path=f"{tmp}/crash.wal",
                                        crash=CrashConfig(round=1, at="post_fold", after_folds=2))
        runs.append(crash_run("p, crashed", crash_cfg, device, round_launches(
            hhe, history_rounds(twin)[:1] + [(8, False)], 294)))
        bodies = sum(r["kind"] == "fold" and "body" in r
                     for r in jr.scan_journal(f"{tmp}/crash.wal").records)
        # One K7 a refolded upload (expected_launches reads the count from
        # the run's recovery.refolded_uploads): every persisted body.
        rec_out, _ = run("p, recovery", dataclasses.replace(crash_cfg, crash=None), hhe.rounds)
        if rec_out["obs"]["metrics"].get("recovery.refolded_uploads") != bodies:
            raise AssertionError(f"(p) recovery refolded {rec_out['obs']['metrics'].get('recovery.refolded_uploads')} "
                                 f"uploads, the journal holds {bodies} bodies")
        chain, twin_chain = journal_commits(f"{tmp}/crash.wal"), journal_commits(f"{tmp}/twin.wal")
        if chain != twin_chain or len(chain) != hhe.rounds:
            raise AssertionError(f"(p) commit chain {chain}, the twin's {twin_chain}")
        if not all(torch.equal(rec_out["params"][k], twin["params"][k]) for k in twin["params"]):
            raise AssertionError("(p) the recovered parameters differ from the twin's")
        log(f"    (p) {bodies} persisted symmetric uploads re-transciphered (K7 at "
            f"[294, 3, 256] each); commit sum_sha chain bitwise the twin's: {chain}")
    log(f"  phase 9 (p) wall time: {time.perf_counter() - t:.3f} s")
    return runs


# Phase 10: the hierarchical fold tree and error feedback. (q)'s stream
# knobs (the full cohort of 8 through 4 host tiers of 2 hospitals), the
# fault schedules of its twins, and the lossy twin's uplinks and tier knobs.
HIER_KNOBS = dict(quorum=0.75, deadline_s=2.0, max_retries=1, seed=0)
HIER_TWINS = (("clean", {}), ("duplicate storm", dict(duplicate_clients=2, arrival_delay_s=1.0)),
              ("regional outage", dict(outage_hosts=1, num_hosts=4)))
LOSSY_LINKS = dict(link_loss_hosts=1, link_dup_hosts=1, link_delay_s=0.5, num_hosts=4)
LOSSY_TIERS = dict(host_quorum=0.5, ship_deadline_s=1.0, host_staleness_rounds=1)
# The dark twin: one uplink a round never delivers, so its tier misses the
# ship, carries under the tier budget and folds stale at the next root.
DARK_LINKS = dict(link_dark_hosts=1, link_delay_s=0.5, num_hosts=4)
# (s): a cohort of 4 of 8, every upload folded, b = 4 (k = 6 at C = 8,
# guard 16: 10 packed rows a client) with error feedback, clip 0.02 (a
# step of 0.00286, where a round's update codes are partly non-zero); its
# twin at b = 8 (k = 3: 19 rows).
EF_STREAM = dict(cohort_size=4, seed=0)
# Readings of `ef_packing_record`'s host-clock fold ratio phase 10 reports.
EF_RATIO_READINGS = 5
EF_PACKING = dict(bits=4, guard_bits=16, clip=0.02, error_feedback=True)


def host_hier_record(stream, faults, round_index: int, num_clients: int, folded,
                     committed_at, stale_folded: int = 0) -> dict:
    """The `hosts` record of a committed hierarchical round from the
    schedules alone: the tiers of the clients the flat round folds
    (`host_stream_round`), each nonempty tier's ship timeline from
    `schedule_links` and the ship policy (first delivery at the commit
    time plus the uplink's delay; a lost one redelivered after a jittered
    backoff on the stream (seed, round, host, 9), exempt from the
    deadline; a dark one never lands; a duplicate lands twice and the root
    dedups it), the host quorum over the nonempty tiers, and the missed
    tiers carried under the tier budget. `stale_folded`: the carried
    partials of the round before."""
    from hefl_tpu_torch.fl.faults import schedule_links
    from hefl_tpu_torch.parallel import host_of_clients

    host_of = host_of_clients(num_clients, stream.num_hosts)
    tiers = sorted({int(host_of[c]) for c in folded})
    link = schedule_links(faults, round_index) if faults is not None and \
        faults._any_link_fault() else None
    deadline = (committed_at + stream.ship_deadline_s if stream.ship_deadline_s > 0
                else float("inf"))
    landed, missed, retries, lost, deduped, done = [], [], 0, 0, 0, 0.0
    for h in tiers:
        delay = float(link.delay_s[h]) if link is not None else 0.0
        dark = bool(link.dark[h]) if link is not None else False
        trans = bool(link.transient[h]) if link is not None else False
        dup = bool(link.duplicate[h]) if link is not None else False
        send = committed_at + delay
        rng = np.random.default_rng([int(stream.seed), int(round_index), h, 9])
        again, t = [], send
        for i in range(stream.max_retries):
            t += stream.retry_backoff_s * 2.0 ** i * (
                1.0 + stream.retry_jitter * float(rng.uniform(-1.0, 1.0)))
            again.append(t)
        if dark:
            lost += 1 + len(again)
            retries += len(again)
            missed.append([h, "unreachable"])
        elif trans:
            lost += 1
            if again:
                retries += 1
                landed.append(h)
                done = max(done, again[0])
            else:
                missed.append([h, "unreachable"])
        elif send > deadline:
            missed.append([h, "timeout"])
        else:
            landed.append(h)
            done = max(done, send)
            deduped += int(dup)
    hq = max(1, int(np.ceil(stream.host_quorum * len(tiers)))) if tiers else 0
    carried = len(missed) if stream.host_staleness_rounds >= 1 and len(landed) >= hq else 0
    return {"nonempty": len(tiers), "landed": landed, "missed": missed, "host_quorum": hq,
            "ship_retries": retries, "ship_lost": lost, "ship_deduped": deduped,
            "tier_carried": carried, "tier_stale_folded": stale_folded,
            "tier_stale_excluded": 0, "ships_done_s": round(done, 6)}


@contextlib.contextmanager
def engine_rounds():
    """During the block, each `StreamEngine.run_round` is recorded: yields a
    list of {round, meta (the StreamRoundMeta), before and after (the
    engine's error-feedback residual rows, None without EF), sha (the
    committed sum's, None when degraded)}. Inside a round only references
    are taken (the engine replaces its residual rows, never writes them in
    place), so the round's timed phases hold no copy or hash made for this
    record; the shas are filled in when the block ends."""
    from hefl_tpu_torch.fl.stream import StreamEngine, ct_hash

    real = StreamEngine.run_round
    rounds = []

    def run_round(self, *a, **k):
        before = self._ef_residual
        out = real(self, *a, **k)
        meta = out[3]
        rounds.append({"round": meta.round_index, "meta": meta, "before": before,
                       "after": self._ef_residual, "sum": out[0] if meta.committed else None})
        return out

    StreamEngine.run_round = run_round
    try:
        yield rounds
    finally:
        StreamEngine.run_round = real
        for rd in rounds:
            total = rd.pop("sum")
            rd["sha"] = None if total is None else ct_hash(total.c0, total.c1)


@contextlib.contextmanager
def upload_records():
    """During the block, each streaming round's `client_uploads` call is
    recorded: yields a list of (cohort rows, uploaded params, global params,
    the ciphertexts or word pairs)."""
    from hefl_tpu_torch.fl import stream as stream_mod

    real = stream_mod.client_uploads
    calls = []

    def uploads(*a, **k):
        out = real(*a, **k)
        cohort = k.get("cohort")
        rows = ([int(c) for c in cohort] if cohort is not None
                else list(range(int(a[5].shape[0]))))
        calls.append((rows, out[3], a[4], out[0]))
        return out

    stream_mod.client_uploads = uploads
    try:
        yield calls
    finally:
        stream_mod.client_uploads = real


def tier_crash_runs(ctx, cts, device) -> None:
    """(r): round 0's 8 uploads (Ciphertext rows on the card) through a
    journaled `HierarchicalAggregator` (fsync_policy "always": every tier
    record durable), crashed by a TierCrash at each of TIER_CRASH_POINTS on
    host 1 after its 2nd fold, then recovered from the tier journals alone
    and the uploads re-delivered to the tiers that had not shipped: the
    root value bitwise the uninterrupted tree's, every upload folded once,
    one root_fold a host, and a re-ship (a second tier_ship attempt) only
    where root.wal lacked the crashed tier's root_fold. Each tier WAL's
    bytes, the appends and fsyncs, the recovery latency. Then
    `dcn_compare_record` on the same uploads."""
    import os
    import tempfile

    from hefl_tpu_torch.fl import journal as jr
    from hefl_tpu_torch.fl.faults import SimulatedCrash
    from hefl_tpu_torch.fl.hierarchy import (
        TIER_CRASH_POINTS,
        HierarchicalAggregator,
        TierCrash,
        dcn_compare_record,
    )
    from hefl_tpu_torch.fl.stream import ct_hash
    from hefl_tpu_torch.obs import metrics as obs_metrics
    from hefl_tpu_torch.parallel import host_of_clients

    p, num = ctx.ntt.p, int(cts.c0.shape[0])
    host_of = host_of_clients(num, 4)

    def deliver(agg, only_unshipped=False):
        for c in range(num):
            if not (only_unshipped and agg._shipped[host_of[c]]):
                agg.fold((c, 0), cts.c0[c], cts.c1[c])

    whole = HierarchicalAggregator(p, 4, num, device=device)
    deliver(whole)
    want = ct_hash(*whole.value())
    for at in TIER_CRASH_POINTS:
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                         prefix="chip_smoke_tiers_") as d:
            base = obs_metrics.snapshot()
            t0 = time.perf_counter()
            agg = HierarchicalAggregator(p, 4, num, journal_dir=d, fsync_policy="always",
                                         crash=TierCrash(host=1, at=at, after_folds=2),
                                         device=device)
            try:
                deliver(agg)
                agg.ship_all(0.0)
            except SimulatedCrash:
                pass
            else:
                raise AssertionError(f"(r) {at}: the tier crash did not fire")
            agg.close()
            crash_s = time.perf_counter() - t0
            # The crashed tier's journal may end in a torn frame: scan it.
            roots_before = {r["host"] for r in jr.scan_journal(f"{d}/root.wal").records
                            if r["kind"] == "root_fold"}
            ships_before = {h: sum(r["kind"] == "tier_ship" for r in jr.scan_journal(
                f"{d}/tier{h}.wal").records) for h in range(4)}
            t0 = time.perf_counter()
            rec = HierarchicalAggregator(p, 4, num, journal_dir=d, fsync_policy="always",
                                         device=device)
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t0
            refolded = rec.refolded
            deliver(rec, only_unshipped=True)
            got = ct_hash(*rec.value())
            rec.close()
            delta = obs_metrics.snapshot_delta(base)
            sizes = {name: os.path.getsize(f"{d}/{name}") for name in sorted(os.listdir(d))}
            roots = [r["host"] for r in jr.read_journal(f"{d}/root.wal")
                     if r["kind"] == "root_fold"]
            ships = {h: sum(r["kind"] == "tier_ship" for r in jr.read_journal(f"{d}/tier{h}.wal"))
                     for h in range(4)}
            reshipped = {h for h in range(4) if ships[h] > max(ships_before[h], 1)}
            log(f"    (r) {at}: crashed after {crash_s:.4f} s; recovery {recover_s:.6f} s "
                f"({refolded} uploads refolded from the tier journals); WAL bytes {sizes}; "
                f"appends {delta.get('journal.appends')}, fsyncs {delta.get('journal.fsyncs')}; "
                f"tier_ship records {ships}, root_fold hosts {sorted(roots)}")
            if got != want:
                raise AssertionError(f"(r) {at}: the recovered root differs from the tree's")
            if rec.folded != num or sorted(roots) != [0, 1, 2, 3]:
                raise AssertionError(f"(r) {at}: folded {rec.folded}, root_folds {roots}")
            must = {h for h in range(4) if ships_before[h] and h not in roots_before}
            if reshipped != must:
                raise AssertionError(f"(r) {at}: re-shipped {reshipped}, root.wal lacked the "
                                     f"root_fold of {must}")
    t0 = time.perf_counter()
    cmp = dcn_compare_record(p, cts.c0, cts.c1, list(range(num)), num, 4)
    log(f"    (r) dcn_compare_record ({time.perf_counter() - t0:.3f} s): "
        f"{json.dumps(cmp)}")
    if not (cmp["bitwise_equal"] and cmp["ratio_ok"]):
        raise AssertionError(f"(r) dcn_compare_record {cmp}")


def dark_hier_checks(stream, faults, out, ups, decrypts) -> None:
    """(q)'s dark-uplink twin: each round's `hosts` record equals
    `host_hier_record` (the missed tier, its carry, and the round after's
    stale tier fold), its `stream` record the flat schedule's, its released
    clients and `host_unreachable` exclusions the schedule's, and each
    decrypt within ERR_LIMIT of the plaintext mean of the uploads the round
    released: the landed tiers' clients of this round and the clients of
    the tier partial carried from the round before (a client in both counts
    twice, as the sum holds both uploads)."""
    from hefl_tpu_torch.parallel import host_of_clients

    num = 8
    host_of = host_of_clients(num, stream.num_hosts)
    hist = out["history"]
    if len(ups) != len(hist) or len(decrypts) != len(hist):
        raise AssertionError(f"(q) dark: {len(hist)} rounds, {len(ups)} uploads, "
                             f"{len(decrypts)} decrypts")
    carried, carried_up, errs, seen = 0, [], [], {"missed": 0, "stale": 0}
    for rec, (rows, p_out, _, _), (_, _, avg) in zip(hist, ups, decrypts):
        r = rec["round"]
        flat, folded, at = host_stream_round(stream, faults, r, num)
        want = host_hier_record(stream, faults, r, num, folded, at, carried)
        missed = {h for h, _ in want["missed"]}
        landed = [c for c in folded if int(host_of[c]) not in missed]
        released = [p_out[rows.index(c)] for c in landed] + [prm for _, prm in carried_up]
        part = sorted(set(landed) | {c for c, _ in carried_up})
        st = dict(rec["stream"])
        hosts = st.pop("hosts")
        if hosts != want or st != flat or not st["committed"]:
            raise AssertionError(f"(q) dark round {r}: stream {rec['stream']}, the schedules "
                                 f"give {flat} and hosts {want}")
        got_part = [c for c, on in enumerate(rec["robust"]["participation"]) if on]
        unreachable = sum(1 for c in folded if int(host_of[c]) in missed)
        if (got_part != part or rec["robust"]["surviving"] != len(released)
                or rec["robust"]["excluded"]["host_unreachable"] != unreachable):
            raise AssertionError(f"(q) dark round {r}: robust {rec['robust']}, expected "
                                 f"participation {part}, surviving {len(released)}, "
                                 f"host_unreachable {unreachable}")
        ref = {k: torch.stack([prm[k] for prm in released]).mean(dim=0) for k in avg}
        errs.append(max((avg[k] - ref[k]).abs().max().item() for k in ref))
        seen["missed"] += len(want["missed"])
        seen["stale"] += want["tier_stale_folded"]
        log(f"    (q) dark round {r}: hosts {json.dumps(hosts)}; released {len(released)} "
            f"uploads (carried from round {r - 1}: {len(carried_up)})")
        carried = want["tier_carried"]
        carried_up = ([(c, p_out[rows.index(c)]) for c in folded if int(host_of[c]) in missed]
                      if carried else [])
    log(f"    (q) dark: decrypted average vs the released uploads' plaintext mean: max abs "
        f"err {errs} (limit {ERR_LIMIT})")
    if not (seen["missed"] and seen["stale"]):
        raise AssertionError(f"(q) dark: the schedule missed {seen['missed']} tiers and folded "
                             f"{seen['stale']} carried partials; both must happen")
    if max(errs) > ERR_LIMIT:
        raise AssertionError(f"(q) dark decrypts off their plaintext means: {errs}")


def hier_ef_runs(device) -> list[tuple[dict, dict]]:
    """Phase 10: the hierarchical fold tree and error feedback through
    `run_experiment`, each run through `drive` (launches exactly
    `expected_launches`), the bitwise comparisons under
    `experiment.deterministic_algorithms`.

    (q) medical-8 at full width (MedCNN 256x256x3, 222,722 parameters,
    N=4096, L=3), 3 rounds x 1 epoch, fused, the full cohort under
    HIER_KNOBS, through 4 host tiers of 2 hospitals and flat, for each of
    HIER_TWINS: each round's committed ciphertext sha and stream record
    (hosts aside) and the final parameters bitwise the flat twin's. The
    lossy twin (LOSSY_LINKS, LOSSY_TIERS): each round's `hosts` record
    equals `host_hier_record`, its sums bitwise the clean flat twin's, each
    decrypt within ERR_LIMIT of the released clients' plaintext mean. The
    dark twin (DARK_LINKS, LOSSY_TIERS): `dark_hier_checks`.
    (r) `tier_crash_runs` on the clean twin's round-0 uploads. (s)
    medical-8 streaming, a cohort of 4 of 8, EF_PACKING (b = 4, error
    feedback), 3 rounds x 1 epoch, once with CKKS uploads and once with
    hybrid-HE uploads: the residual changes on the cohort's rows only and
    is the uploads' own quantization error, |residual| <= step/2 wherever
    the carried update did not saturate, each decrypt within
    `spec.error_budget` of the plaintext mean of the released clients'
    quantized carried updates, the hybrid-HE run bitwise the CKKS run; the
    bytes on the wire and the round seconds against its b = 8 twin, and
    one warm upload at each geometry profiled. (t)
    chaos-smoke's hierarchical twins (N = 256, 4 rounds): duplicate storm
    and regional outage, each bitwise its flat twin, committing
    CHAOS_SMOKE.json's hier_check rounds. Then `ef_packing_record` on the
    card EF_RATIO_READINGS times: its certificates and bytes ratio gated,
    its host-clock fold ratio reported beside its 1.5 floor."""
    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.ckks import quantize
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.packing import PackedSpec, ciphertext_bytes, flat_params
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig
    from hefl_tpu_torch.fl.faults import FaultConfig
    from hefl_tpu_torch.fl.load import ef_packing_record
    from hefl_tpu_torch.fl.secure import encrypt_stack_packed
    from hefl_tpu_torch.presets import PRESETS

    runs = []

    def run(label, cfg, rounds_run):
        out, _, launched, _ = drive(label, cfg, rounds_run, device, robust=True)
        runs.append(launched)
        return out

    def same_params(a, b):
        return all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])

    def strip(rec):
        st = dict(rec["stream"])
        st.pop("hosts", None)
        return st

    t = time.perf_counter()
    stream = StreamConfig(**HIER_KNOBS)
    hier_stream = dataclasses.replace(stream, num_hosts=4)
    flat_shas = {}
    uploads0 = None
    with deterministic_algorithms():
        for name, fkw in HIER_TWINS:
            faults = FaultConfig(seed=0, **fkw) if fkw else None
            twin = {}
            for hosts, st in ((0, stream), (4, hier_stream)):
                cfg = cut("medical-8", 3, 1, "fused", stream=st, faults=faults)
                with engine_rounds() as rounds, upload_records() as ups:
                    out = run(f"q, {name}, {'hierarchical' if hosts else 'flat'}", cfg, 3)
                twin[hosts] = (out, [r["sha"] for r in rounds])
                if hosts and name == "clean":
                    uploads0 = ups[0][3]
            (flat, flat_sha), (hier, hier_sha) = twin[0], twin[4]
            if flat_sha != hier_sha or None in hier_sha:
                raise AssertionError(f"(q) {name}: committed shas {hier_sha}, flat {flat_sha}")
            if [strip(r) for r in hier["history"]] != [r["stream"] for r in flat["history"]]:
                raise AssertionError(f"(q) {name}: stream records differ from the flat twin's")
            if not same_params(flat, hier):
                raise AssertionError(f"(q) {name}: final parameters differ from the flat twin's")
            flat_shas[name] = flat_sha
            log(f"    (q) {name}: committed sums, stream records and final parameters bitwise "
                f"the flat twin's; hosts {[r['stream']['hosts'] for r in hier['history']]}")
        lossy_faults = FaultConfig(seed=0, **LOSSY_LINKS)
        lossy_stream = dataclasses.replace(hier_stream, **LOSSY_TIERS)
        cfg = cut("medical-8", 3, 1, "fused", stream=lossy_stream, faults=lossy_faults)
        with engine_rounds() as rounds, stream_references() as pairs:
            lossy = run("q, lossy uplinks", cfg, 3)
        dark_faults = FaultConfig(seed=0, **DARK_LINKS)
        cfg = cut("medical-8", 3, 1, "fused", stream=lossy_stream, faults=dark_faults)
        with upload_records() as dark_ups, timed_calls(experiment, ("decrypt_average",)) as dec:
            dark = run("q, dark uplink", cfg, 3)
    carried = 0
    for rec in lossy["history"]:
        _, folded, at = host_stream_round(lossy_stream, lossy_faults, rec["round"], 8)
        want = host_hier_record(lossy_stream, lossy_faults, rec["round"], 8, folded, at, carried)
        carried = want["tier_carried"]
        if rec["stream"]["hosts"] != want or want["tier_stale_folded"] or want["missed"]:
            raise AssertionError(f"(q) lossy round {rec['round']}: hosts {rec['stream']['hosts']}"
                                 f", the schedules give {want}")
        log(f"    (q) lossy round {rec['round']}: hosts {json.dumps(rec['stream']['hosts'])}")
    if [r["sha"] for r in rounds] != flat_shas["clean"]:
        raise AssertionError("(q) the lossy twin's sums differ from the clean flat twin's")
    errs = [max((avg[k] - ref[k]).abs().max().item() for k in ref) for ref, avg in pairs]
    log(f"    (q) lossy: sums bitwise the clean flat twin's; decrypted average vs the released "
        f"clients' plaintext mean: max abs err {errs} (limit {ERR_LIMIT})")
    if len(errs) != 3 or max(errs) > ERR_LIMIT:
        raise AssertionError(f"(q) lossy decrypts off their plaintext means: {errs}")
    dark_hier_checks(lossy_stream, dark_faults, dark, dark_ups, dec["decrypt_average"])
    log(f"  phase 10 (q) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    tier_crash_runs(CkksContext.create(), uploads0, device)
    log(f"  phase 10 (r) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    ef_stream = StreamConfig(**EF_STREAM)
    ef = {}
    with deterministic_algorithms():
        for label, kind, bits in (("s, b=4 CKKS", "ckks", 4), ("s, b=4 HHE", "hhe", 4),
                                  ("s, b=8 CKKS twin", "ckks", 8)):
            cfg = cut("medical-8", 3, 1, "fused",
                      stream=dataclasses.replace(ef_stream, upload_kind=kind),
                      packing=PackingConfig(**dict(EF_PACKING, bits=bits)))
            with (engine_rounds() as rounds, upload_records() as ups,
                  timed_calls(experiment, ("decrypt_average",)) as dec):
                out = run(label, cfg, 3)
            ef[label] = (out, rounds, ups, dec["decrypt_average"])
    out4, rounds4, ups4, dec4 = ef["s, b=4 CKKS"]
    spec_step = quantize.symmetric_step(EF_PACKING["clip"], 4)
    budget = out4["packing"]["error_budget"]
    errs, codes = [], []
    for rd, (rows, p_out, gp, _), (_, args, avg) in zip(rounds4, ups4, dec4):
        before = rd["before"] if rd["before"] is not None else torch.zeros_like(rd["after"])
        after = rd["after"]
        others = [c for c in range(8) if c not in rows]
        if not torch.equal(after[others], before[others]) or torch.equal(after[rows],
                                                                          before[rows]):
            raise AssertionError(f"(s) round {rd['round']}: the residual moved off the cohort")
        base = flat_params(gp)
        sent = {}
        for i, c in enumerate(rows):
            upd = flat_params(p_out[i]) - base
            q, res = quantize.ef_quantize(upd, before[c], spec_step, 4)
            if not torch.equal(res, after[c]):
                raise AssertionError(f"(s) round {rd['round']}: client {c}'s residual is not "
                                     "its upload's quantization error")
            carried = upd + before[c]
            inside = (carried / spec_step).abs() <= quantize.qmax(4) + 0.5
            if float(after[c][inside].abs().max()) > spec_step / 2 * (1 + 1e-6):
                raise AssertionError(f"(s) round {rd['round']}: |residual| > step/2")
            sent[c] = quantize.dequantize(q, spec_step)
            codes.append((int((q != 0).sum()), int((~inside).sum()), int(q.numel())))
        kept = [c for c, on in enumerate(rd["meta"].meta.participation) if on]
        ref = base + torch.stack([sent[c] for c in kept]).mean(dim=0)
        errs.append(float((flat_params(avg) - ref).abs().max()))
    log(f"    (s) b=4 CKKS: the residual moves on the cohort's rows only, is each upload's "
        f"quantization error and within step/2 = {spec_step / 2:.6f} where unsaturated; "
        f"(non-zero codes, saturated, coefficients) a client-round {codes}; "
        f"decrypt vs the mean of the quantized carried updates: max abs err {errs} "
        f"(budget {budget:.6f})")
    if len(errs) != 3 or max(errs) > budget:
        raise AssertionError(f"(s) decrypts off the quantized carried mean: {errs}")
    out_h, rounds_h, _, dec_h = ef["s, b=4 HHE"]
    if not (same_params(out4, out_h) and all(
            all(torch.equal(a[2][k], b[2][k]) for k in a[2]) for a, b in zip(dec4, dec_h))
            and torch.equal(rounds4[-1]["after"], rounds_h[-1]["after"])):
        raise AssertionError("(s) the hybrid-HE run is not bitwise the CKKS run")
    out8 = ef["s, b=8 CKKS twin"][0]
    n4, n8 = out4["packing"]["n_ct"], out8["packing"]["n_ct"]
    b4, b8 = (ciphertext_bytes(n, 3, 4096) for n in (n4, n8))
    log(f"    (s) hybrid-HE run bitwise the CKKS run (decrypts, parameters, residual); bytes "
        f"on the wire a client: b=4 {n4} ciphertexts {b4} B (HHE {out_h['hhe']}), b=8 {n8} "
        f"ciphertexts {b8} B, ratio {b4 / b8:.4f}; train+encrypt+aggregate a round: b=4 "
        f"{[r['phases']['train+encrypt+aggregate'] for r in out4['history']]} s, HHE "
        f"{[r['phases']['train+encrypt+aggregate'] for r in out_h['history']]} s, b=8 "
        f"{[r['phases']['train+encrypt+aggregate'] for r in out8['history']]} s")
    if (n4, n8) != (10, 19):
        raise AssertionError(f"(s) packed rows b=4 {n4}, b=8 {n8}; expected 10 and 19")
    # Where a b=4 round's time goes beside b=8's: one warm error-feedback
    # upload (quantize through the residual, pack, encode, encrypt) of round
    # 0's trained cohort at each geometry, under torch.profiler. Outside
    # `drive`, so its launches count in no run.
    rows0, p_out0, gp0, _ = ups4[0]
    up_ctx = CkksContext.create()
    _, up_pk = keygen(up_ctx, torch.Generator().manual_seed(5), device=device)
    res0 = torch.zeros((len(p_out0), flat_params(gp0).numel()), dtype=torch.float32,
                       device=device)
    for bits in (4, 8):
        spec = PackedSpec.for_params(gp0, up_ctx, PackingConfig(**dict(EF_PACKING, bits=bits)), 8)
        gens = [torch.Generator(device=device).manual_seed(i) for i in range(len(p_out0))]
        device_time_breakdown(
            f"(s) b={bits} error-feedback upload of round 0's {len(p_out0)} clients "
            f"({spec.n_ct} ciphertexts each)",
            lambda: encrypt_stack_packed(up_ctx, up_pk, p_out0, gp0, gens, spec,
                                         residual_blk=res0), top=4, host_top=8)
    log(f"  phase 10 (s) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    gate = json.loads((Path(__file__).resolve().parent / "CHAOS_SMOKE.json").read_text())
    chaos = PRESETS["chaos-smoke"]
    base_faults = dataclasses.replace(chaos.faults, **STREAM_FAULTS, fail_rounds=())
    chaos_stream = StreamConfig(quorum=0.375, deadline_s=2.0, max_retries=1, staleness_rounds=1,
                                seed=0)
    legs = (("duplicate-storm", dataclasses.replace(base_faults, duplicate_clients=3,
                                                    arrival_delay_s=0.5)),
            ("regional-outage", dataclasses.replace(base_faults, drop_fraction=0.0,
                                                    nan_clients=0, duplicate_clients=0,
                                                    outage_hosts=1, num_hosts=4)))
    with deterministic_algorithms():
        for name, faults in legs:
            twin = {}
            for hosts in (0, 4):
                cfg = dataclasses.replace(chaos, faults=faults,
                                          stream=dataclasses.replace(chaos_stream,
                                                                     num_hosts=hosts))
                twin[hosts] = run(f"t, chaos-smoke {name}, {hosts} hosts", cfg, cfg.rounds)
            flat, hier = twin[0], twin[4]
            committed = [r["round"] for r in hier["history"] if r["stream"]["committed"]]
            if not same_params(flat, hier) or [strip(r) for r in hier["history"]] != [
                    r["stream"] for r in flat["history"]]:
                raise AssertionError(f"(t) {name}: the hierarchical twin differs from the flat")
            if committed != gate["hier_check"][name]["rounds_committed"]:
                raise AssertionError(f"(t) {name}: committed {committed}, CHAOS_SMOKE.json has "
                                     f"{gate['hier_check'][name]['rounds_committed']}")
            log(f"    (t) {name}: bitwise the flat twin; rounds committed {committed} == "
                "CHAOS_SMOKE.json's hier_check")
    t0 = time.perf_counter()
    ratios = []
    for _ in range(EF_RATIO_READINGS):
        rec = ef_packing_record(device=device)
        if not (rec["certified"] and rec["bytes_ratio_b4_vs_b8"] <= 0.55):
            raise AssertionError(f"ef_packing_record {rec}")
        ratios.append(rec["fold_throughput_ratio_b4_vs_b8"])
    log(f"    ef_packing_record on the card ({time.perf_counter() - t0:.3f} s): {json.dumps(rec)}")
    log(f"    ef_packing_record fold ratio b=4/b=8 over {EF_RATIO_READINGS} readings (reported, "
        f"floor {rec['fold_ratio_floor']}): {ratios}")
    log(f"  phase 10 (t) wall time: {time.perf_counter() - t:.3f} s")
    return runs


# Phase 11: the rotate-and-sum ladder serving, the exact final decode and the
# writers. (u) and (v) use phases 4-5's models and queries (the same seeds),
# so their argmax is compared with the BSGS scorers'.
LADDER_LATENCY_CALLS = 10


def check_ladder_launches(label: str, counts: dict, shapes: dict, n: int, stages: int,
                          blocks: int, num_l: int, num_r: int, fwd_per_stage: int,
                          eval_calls: int = 0, rescale_launches: int = 0) -> None:
    """One ladder score's launches: per stage one K5 call, one K2 launch and
    one K1 launch, plus K1 on the weights and on the bias (for the MLP also
    one eval-input K5 and the rescales' K1/K2); and its forward transforms
    per [L, N] block (K1's one, K5's R digit transforms, at the ladder's
    `blocks` x L rows) are `stages` x `ladder_stage_forward_ntts` plus the
    weights' and the bias'."""
    want = {"keyswitch_fused": stages, "ntt_inverse": stages + rescale_launches,
            "ntt_forward": stages + 2 + rescale_launches, "keyswitch_fused_eval": eval_calls}
    got = {k: counts[k] for k in want}
    if got != want or counts["hoisted_products"] or counts["encrypt_fused"]:
        raise AssertionError(f"({label}) launched {counts}, expected {want}")
    rows = blocks * num_l
    fwd = (shapes.get(("ntt_forward", rows, n), 0)
           + num_r * shapes.get(("keyswitch_fused", rows, n), 0))
    log(f"  ({label}) forward [L, N] transforms a block: {fwd} = {stages} stages x "
        f"{fwd_per_stage} (ladder_stage_forward_ntts) + 2 (the weights, the bias)")
    if fwd != stages * fwd_per_stage + 2:
        raise AssertionError(f"({label}) {fwd} forward transforms a block, expected "
                             f"{stages} x {fwd_per_stage} + 2")


def ladder_linear(device, n: int = 4096) -> tuple[dict, dict]:
    """Phase 11 (u): the ladder `LinearScorer` at N=4096, L=3, d=512, K=10."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import cuda_ntt, encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, GaloisKey, keygen

    t = time.perf_counter()
    ctx = CkksContext.create(n=n)
    gen = torch.Generator().manual_seed(42)
    sk, pk = keygen(ctx, gen, device=device)
    slots = encoding.num_slots(ctx.ntt)
    d, k = slots // 4, 10
    rng = np.random.default_rng(42)
    W, b = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k)
    gks = hei.gen_rotation_keys(ctx, sk, 1)
    plan = hei.bsgs_plan(slots, d, k)
    bsgs = hei.BsgsLinearScorer(ctx, W, b, hei.gen_rotation_keys_for_steps(
        ctx, sk, 2, plan.rotation_steps_needed))
    scorer = hei.LinearScorer(ctx, W, b, gks)
    x = rng.normal(0, 0.5, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    torch.cuda.synchronize()
    stages = len(hei.rotation_steps(slots))
    num_r = ctx.num_primes * ctx.ksk_num_digits
    log(f"  (u) keys ({len(gks)} ladder + {len(plan.rotation_steps_needed)} BSGS Galois keys) "
        f"and scorers: {time.perf_counter() - t:.3f} s; {stages} stages a score")

    cuda_ntt.reset_launch_counts()
    out = scorer.score_batched(ct)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    check_ladder_launches("u, score", counts, shapes, n, stages, k, ctx.num_primes, num_r,
                          hei.ladder_stage_forward_ntts(ctx))
    want = x @ W.T + b
    got = hei.decrypt_score_matrix(ctx, sk, out)
    check_scores("(u) ladder linear score (1 query)", got, want)
    bsgs_got = hei.decrypt_class_scores(ctx, sk, bsgs.score(ct), k)
    if int(np.argmax(got)) != int(np.argmax(bsgs_got)):
        raise AssertionError(f"(u) ladder argmax {np.argmax(got)} != BSGS {np.argmax(bsgs_got)}")
    log(f"  (u) argmax {int(np.argmax(got))} == the BSGS scorer's on the same query; "
        f"max |ladder - BSGS| {float(np.max(np.abs(got - bsgs_got))):.3e}")
    t = time.perf_counter()
    cpu_gks = {s: GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())
               for s, v in gks.items()}
    cpu_out = hei.LinearScorer(ctx, W, b, cpu_gks, device="cpu").score_batched(
        hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    if not same_ciphertext(out, cpu_out):
        raise AssertionError("(u) the card's ladder score differs from the CPU plain versions'")
    log(f"  (u) card == CPU plain versions: bitwise ({time.perf_counter() - t:.3f} s on the CPU)")

    batch = 4
    xs = rng.normal(0, 0.5, (batch, d))
    cts = hei.encrypt_features(ctx, pk, xs, gen)
    torch.cuda.synchronize()
    cuda_ntt.reset_launch_counts()
    outs = scorer.score_many(cts)
    torch.cuda.synchronize()
    m_counts, m_shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(m_shapes)
    if m_counts["keyswitch_fused"] != stages or (
            "keyswitch_fused", batch * k * ctx.num_primes, n) not in m_shapes:
        raise AssertionError(f"(u) score_many launched {m_shapes}")
    check_scores(f"(u) ladder linear score_many ({batch} queries)",
                 hei.decrypt_score_matrix(ctx, sk, outs), xs @ W.T + b)

    lat = {}
    for name, fn, queries in (("ladder", lambda: scorer.score_batched(ct), 1),
                              ("ladder_many", lambda: scorer.score_many(cts), batch),
                              ("bsgs", lambda: bsgs.score(ct), 1)):
        med, p95 = warm_latency(fn, LADDER_LATENCY_CALLS)
        lat.update({f"{name}_median_s": med, f"{name}_p95_s": p95, f"{name}_qps": queries / med})
    log("  (u) latency: " + json.dumps(lat))
    device_time_breakdown("(u) one ladder linear score", lambda: scorer.score_batched(ct))
    for key, c in m_shapes.items():
        shapes[key] = shapes.get(key, 0) + c
    return {name: counts[name] + m_counts[name] for name in counts}, shapes


def ladder_mlp(device, n: int = 8192) -> tuple[dict, dict]:
    """Phase 11 (v): the ladder `MlpScorer` at N=8192, L=5, d=64, H=16, K=10."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import cuda_ntt, encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, gen_relin_key, keygen

    t = time.perf_counter()
    ctx = CkksContext.create(n=n, num_primes=5)
    gen = torch.Generator().manual_seed(10)
    sk, pk = keygen(ctx, gen, device=device)
    rlk = gen_relin_key(ctx, sk, gen)
    d, hidden, k = 64, 16, 10
    rng = np.random.default_rng(43)
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (k, hidden)), rng.normal(0, 0.2, k)
    gks = hei.gen_rotation_keys(ctx, sk, 11)
    scorer = hei.MlpScorer(ctx, w1, b1, w2, b2, gks, rlk)
    sub_sk = hei.slice_secret_key(sk, scorer.sub_ctx.num_primes)
    x = rng.normal(0, 0.4, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    torch.cuda.synchronize()
    slots = encoding.num_slots(ctx.ntt)
    stages = len(hei.rotation_steps(slots))
    num_r = ctx.num_primes * ctx.ksk_num_digits
    plan1, plan2 = hei.bsgs_mlp_plans(slots, d, hidden, k)
    bsgs_ks = plan1.num_keyswitches + plan2.num_keyswitches + 1
    log(f"  (v) keys ({len(gks)} Galois keys, relin) and scorer: {time.perf_counter() - t:.3f} s; "
        f"mlp_compare key-switches a score: ladder {scorer.num_keyswitches} "
        f"({hidden} units x {stages} stages + {hidden} relinearizations, {stages} + 1 K5 calls), "
        f"mlp_bsgs {bsgs_ks}")

    cuda_ntt.reset_launch_counts()
    out = scorer.score_batched(ct)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    # Two rescales, each a K2 on the dropped limb and a K1 on the head rows,
    # for c0 and for c1.
    check_ladder_launches("v, score", counts, shapes, n, stages, hidden, ctx.num_primes, num_r,
                          hei.ladder_stage_forward_ntts(ctx), eval_calls=1, rescale_launches=4)
    if shapes.get(("keyswitch_fused_eval", hidden * ctx.num_primes, n)) != 1:
        raise AssertionError(f"(v) no eval-input K5 at [{hidden}, 5, {n}]: {shapes}")
    want = ((x @ w1.T + b1) ** 2) @ w2.T + b2
    got = hei.decrypt_score_matrix(scorer.sub_ctx, sub_sk, out)
    check_scores("(v) ladder MLP score (1 query)", got, want, MLP_ERR_LIMIT)

    batch = 4
    xs = rng.normal(0, 0.4, (batch, d))
    cts = hei.encrypt_features(ctx, pk, xs, gen)
    torch.cuda.synchronize()
    cuda_ntt.reset_launch_counts()
    outs = scorer.score_many(cts)
    torch.cuda.synchronize()
    m_counts, m_shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(m_shapes)
    if m_shapes.get(("keyswitch_fused", batch * hidden * ctx.num_primes, n)) != stages:
        raise AssertionError(f"(v) score_many launched {m_shapes}")
    check_scores(f"(v) ladder MLP score_many ({batch} queries)",
                 hei.decrypt_score_matrix(scorer.sub_ctx, sub_sk, outs),
                 ((xs @ w1.T + b1) ** 2) @ w2.T + b2, MLP_ERR_LIMIT)
    med, p95 = warm_latency(lambda: scorer.score_batched(ct), LADDER_LATENCY_CALLS)
    med_b, p95_b = warm_latency(lambda: scorer.score_many(cts), LADDER_LATENCY_CALLS)
    log("  (v) latency: " + json.dumps({"median_s": med, "p95_s": p95, "qps": 1.0 / med,
                                         "many_median_s": med_b, "many_p95_s": p95_b,
                                         "many_qps": batch / med_b}))
    device_time_breakdown("(v) one ladder MLP score", lambda: scorer.score_batched(ct))
    for key, c in m_shapes.items():
        shapes[key] = shapes.get(key, 0) + c
    return {name: counts[name] + m_counts[name] for name in counts}, shapes


def check_ladder_shapes_timed(shapes: dict) -> None:
    """Every K1, K2 and K5 launch of (u) and (v) falls on a shape phase 12
    times (NTT_SHAPES by rows x N, KS_SHAPES by mode and rows x N)."""
    timed = {("ntt_forward", b * num_l, n) for b, num_l, n in NTT_SHAPES}
    timed |= {("ntt_inverse", b * num_l, n) for b, num_l, n in NTT_SHAPES}
    timed |= {("keyswitch_fused_eval" if ev else "keyswitch_fused", b * num_l, n)
              for ev, b, num_l, n in KS_SHAPES}
    untimed = {k: c for k, c in shapes.items() if k not in timed}
    log(f"  (u)-(v) K1/K2/K5 launches at {len(shapes)} (kernel, rows, N) shapes, all timed in "
        f"phase 12: {not untimed}")
    if untimed:
        raise AssertionError(f"ladder launches at shapes phase 12 does not time: {untimed}")


def exact_decode_run(device) -> tuple[dict, dict]:
    """Phase 11 (w): medical-8 cut to 1 round of 1 epoch with
    exact_final_decode; the round's residues decoded by the native CRT and
    by the Python-bignum plain version (bitwise), the exact and the float
    decode of the round (within ERR_LIMIT), both decode times."""
    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.ckks import encoding, ops

    captured = []
    real = experiment.decrypt_average

    def capture(*a, **k):
        captured.append((a, k))
        return real(*a, **k)

    experiment.decrypt_average = capture
    try:
        out, _, run, _ = drive("w", cut("medical-8", 1, 1, exact_final_decode=True), 1, device,
                               check_plain=True)
    finally:
        experiment.decrypt_average = real
    (a, k), = captured
    if k.get("exact") is not True:
        raise AssertionError(f"(w) the final round decrypted with exact={k.get('exact')}")
    ctx, sk, ct_sum, num_clients, spec = a
    res = ops.decrypt(ctx, sk, ct_sum).cpu().contiguous().numpy().view(np.uint32)
    denom = ct_sum.scale * num_clients
    t0 = time.perf_counter()
    fast = encoding.decode_exact(ctx.ntt, res, denom)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = encoding.decode_exact_plain(ctx.ntt, res, denom)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(fast, slow):
        raise AssertionError("(w) the native CRT differs from the Python-bignum decode")
    floated = real(*a, **dict(k, exact=False))
    err = max((floated[name] - out["params"][name]).abs().max().item() for name in floated)
    log(f"  (w) residues {list(res.shape)}: native CRT == Python bignum bitwise; decode "
        f"{native_s * 1e3:.3f} ms native, {plain_s * 1e3:.3f} ms bignum; exact vs float decode "
        f"max abs diff {err:.3e} (limit {ERR_LIMIT})")
    if not err <= ERR_LIMIT:
        raise AssertionError(f"(w) exact and float decodes differ by {err}")
    return run


def writer_runs(device, smi: str) -> None:
    """Phase 11 (x): the writers on the card into a temporary directory,
    each exiting 0: bench_inference (3 reps), the BENCH_LOAD writer on the
    10**4-client trace with its sweep, the BENCH_DCN writer, then the trend
    gate over what they wrote (single-point baselines)."""
    import tempfile

    from hefl_tpu_torch import bench_inference
    from hefl_tpu_torch.fl import hierarchy, load
    from hefl_tpu_torch.obs import trend

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        for name, fn, argv in (
            ("BENCH_TORCH_INFER.json", bench_inference._main, ["--reps", "3"]),
            ("BENCH_TORCH_LOAD.json", load._main, ["--smoke", "--sweep"]),
            ("BENCH_TORCH_DCN.json", hierarchy._main, []),
        ):
            t0 = time.perf_counter()
            rc = fn(argv + ["--out", str(Path(tmp) / name)])
            log(f"  (x) {name}: exit {rc} in {time.perf_counter() - t0:.3f} s ({smi})")
            if rc != 0:
                raise AssertionError(f"(x) the writer of {name} exited {rc}")
        rc = trend._main(["--root", tmp, "--out", str(Path(tmp) / "TREND.md"), "--quiet"])
        log(f"  (x) trend gate over the written files: exit {rc}")
        if rc != 0:
            raise AssertionError(f"(x) the trend gate exited {rc}")
        load_rec = json.loads((Path(tmp) / "BENCH_TORCH_LOAD.json").read_text())["bench_load"]
        log("  (x) BENCH_TORCH_LOAD: " + json.dumps({
            "folds_per_s": load_rec["runs"]["commit_grouped"]["folds_per_s"],
            "fsync_ratio": load_rec["group_commit"]["fsync_ratio"],
            "fold_throughput": load_rec["fold_throughput"]["folds_per_s"],
            "ef_packing": {k: v for k, v in load_rec["ef_packing"].items() if "ratio" in k},
            "device": load_rec["device"]}))


def ladder_runs(device, smi: str) -> list[tuple[dict, dict]]:
    """Phase 11: (u)-(x)."""
    t = time.perf_counter()
    runs = [ladder_linear(device), ladder_mlp(device)]
    shapes = {}
    for _, run_shapes in runs:
        for key, c in run_shapes.items():
            if key[0] in ("ntt_forward", "ntt_inverse", "keyswitch_fused", "keyswitch_fused_eval"):
                shapes[key] = shapes.get(key, 0) + c
    check_ladder_shapes_timed(shapes)
    log(f"  phase 11 (u)-(v) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    runs.append(exact_decode_run(device))
    log(f"  phase 11 (w) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    writer_runs(device, smi)
    log(f"  phase 11 (x) wall time: {time.perf_counter() - t:.3f} s")
    return runs


# The headline benchmark's rounds in phase 12 (round 0 cold, round 1 warm).
HEADLINE_ROUNDS = 2


def headline_runs(device, smi: str) -> tuple[tuple[dict, dict], dict]:
    """Phase 12: `bench.run` at the flagship's full width and epochs (its
    launches counted from zero), its gates, then `bench_ntt.run`: every
    kernel bitwise and timed at every shape of its list; both artifacts
    and the trend gate over them in a temporary directory. -> the bench's
    (counts, launches by shape) and the kernels' records by name."""
    import tempfile

    from hefl_tpu_torch import bench, bench_ntt
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.obs import trend

    t = time.perf_counter()
    cuda_ntt.reset_launch_counts()
    art = bench.run(device, rounds=HEADLINE_ROUNDS)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    log(f"  (y) bench launches: {counts}")
    log("  (y) BENCH_TORCH: " + json.dumps({k: art[k] for k in (
        "value", "vs_baseline", "warm_round_s", "steady_round_s", "rounds_per_sec_per_chip",
        "train_mfu", "accuracy", "plaintext_round_s", "enc_plain_max_abs_diff",
        "enc_plain_max_abs_diff_exact_decode", "encode_overflow_count", "ciphertext_expansion",
        "round_stats")}) + f" ({smi})")
    log("  (y) phase_roofline: " + json.dumps(art["phase_roofline"]))
    log("  (y) he_roofline: " + json.dumps(art["he_roofline"]))
    pk = art["packing"]
    log("  (y) packing: " + json.dumps({k: pk[k] for k in (
        "n_ct", "standalone_encrypt_packed_s", "decrypt_core_packed_s",
        "packed_round_max_abs_diff", "error_budget", "packed_round_within_budget")})
        + "; he_roofline_packed " + json.dumps(pk["he_roofline_packed"]))
    log("  (y) cohort_compare: " + json.dumps(art["cohort_compare"]) + "; dcn_compare ratio "
        f"{art['dcn_compare']['bytes_ratio']}, bitwise {art['dcn_compare']['bitwise_equal']}")
    log("  (y) client_fusion_compare: " + json.dumps(art["client_fusion_compare"]))
    if not art["enc_plain_max_abs_diff"] <= ERR_LIMIT:
        raise AssertionError(f"(y) the flagship's decrypted average is "
                             f"{art['enc_plain_max_abs_diff']} off the plaintext mean")
    if art["packing"]["packed_round_within_budget"] is not True:
        raise AssertionError("(y) the packed flagship round is outside its error budget")
    if not (art["cohort_compare"]["bitwise_equal"] and art["dcn_compare"]["bitwise_equal"]):
        raise AssertionError("(y) the cohort-only (or the tiered) sum differs from the full-C one")
    for phase, row in art["phase_roofline"].items():
        if row["flops"] is None or row["mfu"] is None or not 0.0 < row["mfu"] <= 1.0:
            raise AssertionError(f"(y) phase_roofline {phase}: {row}")
    for phase in ("encrypt", "aggregate", "decrypt"):
        row = art["he_roofline"][phase]
        if row["util_vs_peak_int_ops"] is None or row.get("timing_floor_suspect"):
            raise AssertionError(f"(y) he_roofline {phase}: {row}")
    log(f"  phase 12 (y) wall time: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    ntt_art = bench_ntt.run(device)
    records = {rec["name"]: rec for rec in ntt_art["kernels"]}
    if not ntt_art["bitwise"] or ntt_art["kernels_covered"] != [f"K{i}" for i in range(1, 8)]:
        raise AssertionError(f"(z) BENCH_TORCH_NTT: bitwise {ntt_art['bitwise']}, kernels "
                             f"{ntt_art['kernels_covered']}")
    log(f"  (z) BENCH_TORCH_NTT: K1-K7 bitwise at every listed shape "
        f"({sum(len(r['shapes']) for r in records.values())} shapes)")
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        for name, doc in (("BENCH_TORCH.json", art), ("BENCH_TORCH_NTT.json", ntt_art)):
            (Path(tmp) / name).write_text(json.dumps(doc))
        rc = trend._main(["--root", tmp, "--quiet"])
        log(f"  (z) trend gate over BENCH_TORCH.json: exit {rc}")
        if rc != 0:
            raise AssertionError(f"(z) the trend gate exited {rc}")
    log(f"  phase 12 (z) wall time: {time.perf_counter() - t:.3f} s")
    return (counts, shapes), records


# Phase 13: profiler trace attribution. A window whose trace drops a kernel
# event (its launch has no kernel) is traced again, up to TRACE_TRIES windows.
TRACE_TRIES = 3
# (aa)'s rows: every phase of the encrypted round, augmentation included.
ROUND_TRACE_PHASES = ("hefl.sgd_core", "hefl.augment", "hefl.val", "hefl.encrypt",
                      "hefl.psum_aggregate", "hefl.decrypt", "hefl.evaluate")
# (ab)'s profile_round: the flagship cut in local epochs only.
PROFILE_EPOCHS = 2


# K1-K7 by their kernel event's label (K5's digit stage and inner product;
# its eval-input inverse is an inverse NTT, K2's kernel).
PORT_KERNEL_KINDS = (("K3", "EncryptRows"), ("K4", "DecryptRows"), ("K7", "TranscipherRows"),
                     ("K5", "DigitRows"), ("K5", "keyswitch_reduce_kernel"),
                     ("K6", HOIST_KERNEL), ("K2", ", true, PlainRows"),
                     ("K1", ", false, PlainRows"))


def port_kernel_phases(ops) -> dict:
    """{K1-K7: {phase (None: unattributed): kernel events}} of a trace's ops."""
    from hefl_tpu_torch.utils.roofline import kernel_label

    out: dict = {}
    for op in ops:
        if is_port_kernel(op["name"]):
            label = kernel_label(op["name"])
            kind = next(k for k, key in PORT_KERNEL_KINDS if key in label)
            by_phase = out.setdefault(kind, {})
            by_phase[op["phase"]] = by_phase.get(op["phase"], 0) + 1
    return out


def log_trace_rows(label: str, rec: dict) -> None:
    total = rec["device_total_s"] or 1.0
    log(f"  ({label}) {rec['op_events']} {rec['device_events']} events, device total "
        f"{rec['device_total_s']:.6f} s, unattributed {rec['unattributed_s']:.6f} s, dropped "
        f"launches {rec['dropped_launches']}, unlinked {rec['unlinked_device_events']}")
    for phase, row in rec["rows"].items():
        log(f"    {phase:22s} {row['device_seconds']:.6f} s  {row['op_events']:7d} ops  "
            f"{100 * row['device_seconds'] / total:5.1f} %")
    log(f"    modules {json.dumps(rec['modules'])}; host rows {json.dumps(rec['host_rows'])}")


def traced_window(label: str, run):
    """`run(trace_dir)` -> (its output, its wall seconds), with the launch
    counts zeroed before it, traced again while its trace drops kernel
    events (TRACE_TRIES windows) -> (output, wall, counts, shapes, record,
    ops)."""
    import tempfile

    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.obs import trace

    for attempt in range(TRACE_TRIES):
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                         prefix=".chip_smoke_") as tmp:
            cuda_ntt.reset_launch_counts()
            out, wall = run(tmp)
            torch.cuda.synchronize()
            counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
            events = trace.load_trace_events(trace.find_trace_file(tmp))
        rec, by_event = trace.trace_attribution(events), trace.attributed_events(events)
        if rec["dropped_launches"] == 0:
            return out, wall, counts, shapes, rec, by_event["ops"]
        log(f"  ({label}) window {attempt + 1}: {rec['dropped_launches']} launches without "
            f"their kernel event ({by_event['dropped']}); tracing again")
    raise AssertionError(f"({label}) each of {TRACE_TRIES} traces dropped kernel events")


def round_trace(device) -> tuple[dict, dict]:
    """Phase 13 (aa): medical-8 cut to 1 round of 1 epoch through
    `run_experiment(profile_dir=...)`: every phase's row, the port's K3 and
    K4 kernel events in their phases and as many as the round launched,
    the rows' sum, the device total within the traced wall time."""
    cfg = cut("medical-8", 1, 1)

    def run(tmp):
        out = drive("aa", dataclasses.replace(cfg, profile_dir=tmp), 1, device)[0]
        return out, out["history"][0]["phases"]["total"]

    _, wall, counts, shapes, rec, ops = traced_window("aa", run)
    log_trace_rows("aa", rec)
    missing = [p for p in ROUND_TRACE_PHASES if not rec["rows"].get(p, {}).get("device_seconds")]
    if missing or rec["device_events"] != "kernel":
        raise AssertionError(f"(aa) no device time in {missing} ({rec['device_events']})")
    kinds = port_kernel_phases(ops)
    log(f"  (aa) the port's kernel events by phase: {json.dumps(kinds)}; launches {counts}")
    want = {"K3": {"hefl.encrypt": counts["encrypt_fused"]},
            "K4": {"hefl.decrypt": counts["decrypt_fused"]}}
    if kinds != want:
        raise AssertionError(f"(aa) the port's kernel events by phase {kinds}, expected {want}")
    gap = abs(rec["device_total_s"] - sum(r["device_seconds"] for r in rec["rows"].values())
              - rec["unattributed_s"])
    log(f"  (aa) |rows + unattributed - device total| {gap:.3e} s; device total "
        f"{rec['device_total_s']:.6f} s of the traced round's {wall:.6f} s wall")
    if gap > 1e-6 * rec["op_events"] or rec["device_total_s"] > 1.02 * wall:
        raise AssertionError(f"(aa) the rows do not add up ({gap}) or the device time "
                             f"{rec['device_total_s']} exceeds the wall time {wall}")
    return counts, shapes


def profile_round_trace(device, smi: str) -> tuple[dict, dict]:
    """Phase 13 (ab): `profile_round.run` at the flagship's full width, cut
    to PROFILE_EPOCHS local epochs, traced: the record's keys, its trace
    attribution and the round's device busy share."""
    import tempfile

    from hefl_tpu_torch import profile_round
    from hefl_tpu_torch.ckks import cuda_ntt

    cuda_ntt.reset_launch_counts()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        att = profile_round.run(device, profile=tmp, epochs=PROFILE_EPOCHS, reps=1)
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log_launch_rows(shapes)
    missing = [k for k in profile_round.RECORD_KEYS if k not in att]
    tr = att.get("trace_attribution") or {}
    log_trace_rows("ab", tr)
    log(f"  (ab) round_wall_agreement {tr.get('round_wall_agreement')} (the round's device "
        f"busy share), wall {json.dumps(tr.get('wall_s'))}, attributed {tr.get('attributed_sum_s')}"
        f" s; ablation: full {att['full_round_s']} s, train {att['train_s']} s, sgd_core "
        f"{att['sgd_core_s']}, augment {att['augment_s']}, val {att['per_epoch_val_s']}, HE "
        f"{att['he_in_round_s']} (unreliable {att['attribution_unreliable']}) ({smi})")
    if missing or att["attribution_source"] != "trace":
        raise AssertionError(f"(ab) record lacks {missing} or is not traced "
                             f"({att['attribution_source']})")
    if not 0.0 < tr["round_wall_agreement"] <= 1.02:
        raise AssertionError(f"(ab) round_wall_agreement {tr['round_wall_agreement']}")
    return counts, shapes


def serving_trace(device) -> tuple[dict, dict]:
    """Phase 13 (ac): one warm BSGS linear score at phase 4's geometry and
    one ladder linear score at phase 11 (u)'s, each traced: every port
    kernel event in a hefl.serve_* row, K5 in serve_keyswitch or
    serve_hoist (the ladder's in serve_rotate), K6 in serve_hoist."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.obs.trace import round_profiler

    ctx = CkksContext.create(n=4096)
    gen = torch.Generator().manual_seed(42)
    sk, pk = keygen(ctx, gen, device=device)
    slots = encoding.num_slots(ctx.ntt)
    d, k = slots // 4, 10
    rng = np.random.default_rng(42)
    W, b = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k)
    plan = hei.bsgs_plan(slots, d, k)
    bsgs = hei.BsgsLinearScorer(ctx, W, b, hei.gen_rotation_keys_for_steps(
        ctx, sk, 2, plan.rotation_steps_needed))
    ladder = hei.LinearScorer(ctx, W, b, hei.gen_rotation_keys(ctx, sk, 1))
    ct = hei.encrypt_features(ctx, pk, rng.normal(0, 0.5, d), gen)
    runs = []
    for label, fn in (("ac, BSGS", lambda: bsgs.score(ct)),
                      ("ac, ladder", lambda: ladder.score_batched(ct))):
        fn()
        torch.cuda.synchronize()

        def run(tmp, fn=fn):
            with round_profiler(tmp, device):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return None, time.perf_counter() - t0

        _, wall, counts, shapes, rec, ops = traced_window(label, run)
        log_trace_rows(label, rec)
        kinds = port_kernel_phases(ops)
        log(f"  ({label}) wall {wall * 1e3:.3f} ms; the port's kernel events by phase: "
            f"{json.dumps(kinds)}")
        # The ladder's stages run in one serve_rotate range, its K5 calls
        # included; the BSGS sweeps hold theirs in serve_keyswitch.
        allowed = {"K5": ({"hefl.serve_rotate"} if label == "ac, ladder"
                          else {"hefl.serve_keyswitch", "hefl.serve_hoist"}),
                   "K6": {"hefl.serve_hoist"}}
        for kind, by_phase in kinds.items():
            ok = allowed.get(kind)
            bad = [p for p in by_phase if p is None or not p.startswith("hefl.serve_")
                   or (ok is not None and p not in ok)]
            if bad:
                raise AssertionError(f"({label}) {kind} kernel events in {bad}: {by_phase}")
        if (sum(kinds.get("K6", {}).values()) != counts["hoisted_products"]
                or ("K5" in kinds) != bool(counts["keyswitch_fused"])):
            raise AssertionError(f"({label}) kernel events {kinds} vs launches {counts}")
        runs.append((counts, shapes))
    return merge_launches(*runs)


def trace_runs(device, smi: str) -> list[tuple[dict, dict]]:
    """Phase 13: (aa)-(ac)."""
    t = time.perf_counter()
    runs = [round_trace(device)]
    log(f"  phase 13 (aa) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    runs.append(profile_round_trace(device, smi))
    log(f"  phase 13 (ab) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    runs.append(serving_trace(device))
    log(f"  phase 13 (ac) wall time: {time.perf_counter() - t:.3f} s")
    return runs

# Phase 14 (ad): the folder's images a split, at 256x256 from the medical
# generator, and the seed the loader shuffles with.
FOLDER_TRAIN = 80
FOLDER_TEST = 20
# Phase 14 (ah): the flagship recipe cut to this many local epochs.
FLAGSHIP_EPOCHS = 2
_FUSION_PROCESS = """
import json, sys, time, torch
from pathlib import Path
from hefl_tpu_torch.fl import fusion
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.fedavg import client_generators, train_block
from hefl_tpu_torch.models import create_model
from hefl_tpu_torch.obs import metrics
from hefl_tpu_torch.utils import autoselect
autoselect.DEFAULT_DIR = Path(sys.argv[1])
model = create_model("medcnn", device="cuda")
params = {k: v.detach() for k, v in model.named_parameters()}
gen = torch.Generator().manual_seed(0)
xs = torch.randint(0, 256, (2, 64, 256, 256, 3), dtype=torch.uint8, generator=gen).cuda()
ys = torch.randint(0, 2, (2, 64), generator=gen).cuda()
torch.cuda.synchronize()
t0 = time.perf_counter()
backend = fusion.resolve_fusion_backend("auto", model, torch.device("cuda"))
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
# The first training call after the choice: what a run pays next, with
# whatever the probe warmed (or did not) still warm.
cfg = TrainConfig(epochs=1, batch_size=32, client_fusion=backend)
train_block(model, cfg, params, xs, ys, gens=client_generators(gen, 2, torch.device("cuda")))
torch.cuda.synchronize()
train_s = time.perf_counter() - t0 - seconds
snap = metrics.snapshot()
print(json.dumps({"backend": backend, "report": fusion.fusion_report(), "seconds": seconds,
                  "train_s": train_s, "probe": snap.get("autoselect.probe", 0),
                  "cache": snap.get("autoselect.cache", 0)}))
"""


def port_process(args: list, env: dict | None = None, timeout: int = 300) -> str:
    """Run `python args...` from the checkout with the port importable ->
    its standard output; fails the run on a non-zero exit."""
    import os

    root = Path(__file__).resolve().parent
    full = {**os.environ, **(env or {}), "PYTHONPATH": str(root)}
    full = {k: v for k, v in full.items() if v is not None}
    proc = subprocess.run([sys.executable, *args], cwd=root, env=full, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{args[:3]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def folder_round(device) -> tuple[dict, dict]:
    """Phase 14 (ad): a reference-layout PNG folder through the CLI."""
    import tempfile

    from PIL import Image

    from hefl_tpu_torch import cli, experiment
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.data import make_dataset, scan_image_folder

    (x, y), (xt, yt), _ = make_dataset("medical", seed=0, n_train=FOLDER_TRAIN,
                                       n_test=FOLDER_TEST)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        written = {}
        t0 = time.perf_counter()
        for split, imgs, labels in (("Train", x, y), ("Test", xt, yt)):
            for i, (img, lab) in enumerate(zip(imgs, labels)):
                d = Path(tmp) / split / f"class_{int(lab)}"
                d.mkdir(parents=True, exist_ok=True)
                Image.fromarray(img).save(d / f"img_{i:04d}.png")
                written[str(d / f"img_{i:04d}.png")] = img
        write_s = time.perf_counter() - t0
        real_load = experiment.load_folder_splits
        loaded = {}

        def load(*a, **k):
            t = time.perf_counter()
            out = real_load(*a, **k)
            loaded["out"], loaded["seconds"] = out, time.perf_counter() - t
            return out

        args = cli.parse_args(["--data-dir", tmp, "--image-size", "256", "--rounds", "1",
                               "--epochs", "1", "--no-save-model", "--no-events"])
        experiment.load_folder_splits = load
        cuda_ntt.reset_launch_counts()
        try:
            with plain_references() as (pairs, _):
                history = cli.run(args, verbose=False)
            torch.cuda.synchronize()
        finally:
            experiment.load_folder_splits = real_load
        counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
        (lx, ly), (ltx, lty), names = loaded["out"]
        want = {}
        for split, shuffle in (("Train", True), ("Test", False)):
            paths, labels, _ = scan_image_folder(str(Path(tmp) / split), shuffle, args.seed)
            want[split] = (np.stack([written[p] for p in paths]), labels)
    same = (np.array_equal(lx, want["Train"][0]) and np.array_equal(ly, want["Train"][1])
            and np.array_equal(ltx, want["Test"][0]) and np.array_equal(lty, want["Test"][1]))
    n_img = len(lx) + len(ltx)
    errs = [max((avg[k] - ref[k]).abs().max().item() for k in ref) for ref, avg in pairs]
    log(f"  (ad) wrote {n_img} PNGs at 256x256 in {write_s:.3f} s; load_folder_splits "
        f"{loaded['seconds']:.3f} s ({loaded['seconds'] / n_img * 1e3:.3f} ms an image); classes "
        f"{names}; train {lx.shape}, test {ltx.shape}; loaded == written bitwise: {same}")
    rec = history[0]
    log(f"  (ad) round: phases (s) {json.dumps(rec['phases'])}; accuracy {rec['accuracy']:.4f}; "
        f"encode_overflow {rec['encode_overflow']}; decrypted average vs plaintext mean {errs} "
        f"(limit {ERR_LIMIT})")
    log_launch_rows(shapes)
    if not same or names != ["class_0", "class_1"]:
        raise AssertionError(f"(ad) the loaded arrays are not the written ones ({same}) or the "
                             f"classes {names} are not 2")
    if len(errs) != 1 or errs[0] > ERR_LIMIT or rec["encode_overflow"] != [0, 0]:
        raise AssertionError(f"(ad) decrypt off its plaintext mean {errs} or overflow "
                             f"{rec['encode_overflow']}")
    want_launch = {("encrypt_fused", 110 * 3, 4096): 1, ("decrypt_fused", 55 * 3, 4096): 1}
    if {k: v for k, v in shapes.items() if k[0] != "ntt_forward"} != want_launch:
        raise AssertionError(f"(ad) launched {shapes}, expected K3/K4 {want_launch}")
    return counts, shapes


def backend_choice_runs(device) -> None:
    """Phase 14 (ae): the fusion winner persisted across two fresh
    processes; the HE backend record and a contradicting pin."""
    import tempfile

    from hefl_tpu_torch.ckks.backend import he_backend_report

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        env = {"HEFL_AUTOSELECT_CACHE": "1", "HEFL_CLIENT_FUSION": None}
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = port_process(["-c", _FUSION_PROCESS, tmp], env)
            runs.append({**json.loads(out.strip().splitlines()[-1]),
                         "process_s": time.perf_counter() - t0})
        stored = json.loads((Path(tmp) / "hefl_autoselect.json").read_text())
    first, second = runs
    log(f"  (ae) fusion 'auto', fresh process: {first['backend']} by probe in "
        f"{first['seconds']:.6f} s (timings {first['report']['auto_timings_ms']} ms; process "
        f"{first['process_s']:.3f} s); second process: {second['backend']} from the file in "
        f"{second['seconds']:.6f} s (auto_persisted {second['report']['auto_persisted']}; "
        f"process {second['process_s']:.3f} s); the first training call after it (2 clients x 64 "
        f"MedCNN images, 1 epoch) {first['train_s']:.6f} s against {second['train_s']:.6f} s; "
        f"choice + first training: the file saves "
        f"{first['seconds'] + first['train_s'] - second['seconds'] - second['train_s']:.6f} s "
        f"a process (the probe alone {first['seconds'] - second['seconds']:.6f} s); stored "
        f"{json.dumps(stored)}")
    if ((first["probe"], first["cache"], second["probe"], second["cache"]) != (1, 0, 0, 1)
            or second["report"]["auto_persisted"] is not True
            or first["report"]["auto_persisted"] is not False
            or second["backend"] != first["backend"]):
        raise AssertionError(f"(ae) the winner did not persist: {runs}")
    rep = he_backend_report(device)
    try:
        he_backend_report(device, "plain")
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError("(ae) a 'plain' HE pin on the card did not raise")
    log(f"  (ae) he_backend_report {json.dumps(rep)}; 'plain' pin: {refusal}")
    if rep["backend"] != "cuda":
        raise AssertionError(f"(ae) he_backend_report {rep}")


def fidelity_run(device) -> tuple[dict, dict]:
    """Phase 14 (af): fidelity_check over 3 seeds at the flagship shape."""
    from hefl_tpu_torch import fidelity_check
    from hefl_tpu_torch.ckks import cuda_ntt

    cuda_ntt.reset_launch_counts()
    rec = fidelity_check.run(device, (0, 1, 2))
    torch.cuda.synchronize()
    counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
    log(f"  (af) worst max abs diff {rec['worst_max_abs_diff']:.3e} over seeds "
        f"{[r['seed'] for r in rec['rows']]}; exact decode "
        f"{[r['max_abs_diff_exact_decode'] for r in rec['rows']]}; overflow "
        f"{[r['encode_overflow'] for r in rec['rows']]}; encrypt+sum+decrypt s "
        f"{[round(r['seconds'], 6) for r in rec['rows']]}")
    log_launch_rows(shapes)
    if rec["worst_max_abs_diff"] > ERR_LIMIT or any(r["encode_overflow"] for r in rec["rows"]):
        raise AssertionError(f"(af) fidelity {rec}")
    return counts, shapes


def mfu_run(device) -> None:
    """Phase 14 (ag): mfu_probe over the full batch ladder."""
    from hefl_tpu_torch import mfu_probe

    rec = mfu_probe.run(device)
    for row in rec["rows"]:
        log(f"  (ag) batch {row['batch']:4d}: step {row['step_ms']:.3f} ms, "
            f"{row['images_per_s']:.1f} images/s, {row['flops'] / 1e9:.2f} GFLOP, "
            f"mfu {row['mfu']:.4f}")
    log(f"  (ag) verdict: {rec['verdict']}")
    if [r["batch"] for r in rec["rows"]] != list(mfu_probe.LADDER) or not all(
            0 < r["mfu"] <= 1 for r in rec["rows"]):
        raise AssertionError(f"(ag) {rec['rows']}")


def flagship_acc_runs(device) -> tuple[dict, dict]:
    """Phase 14 (ah): flagship_acc stopped after one epoch in its own
    process and resumed here, against the unchunked run and the secure
    round on the same generators."""
    import tempfile

    from hefl_tpu_torch import flagship_acc
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.keys import keygen
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.data import iid_contiguous, stack_federated
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
    from hefl_tpu_torch.flagship import flagship_keygen_gen, flagship_round_gen, flagship_setup

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as chunked, \
            tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as whole:
        t0 = time.perf_counter()
        port_process(["-c", "import os, sys; os.chdir(sys.argv[1]); "
                      "from hefl_tpu_torch.flagship_acc import run; "
                      f"assert run(0, epochs={FLAGSHIP_EPOCHS}, chunk_epochs=1, "
                      f"device='{device}') == (None, None)", chunked])
        first_s = time.perf_counter() - t0
        kept = (Path(chunked) / "flagship_state_torch_0.npz").exists()
        cuda_ntt.reset_launch_counts()
        with contextlib.chdir(chunked):
            got, got_params = flagship_acc.run(0, epochs=FLAGSHIP_EPOCHS, device=device)
        torch.cuda.synchronize()
        counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
        with contextlib.chdir(whole):
            want, want_params = flagship_acc.run(0, epochs=FLAGSHIP_EPOCHS, device=device)
    setup = flagship_setup(0, device=device)
    cfg = dataclasses.replace(setup["cfg"], epochs=FLAGSHIP_EPOCHS, client_fusion="vmap")
    (x, y), ctx = setup["train"], setup["ctx"]
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), 2))
    with deterministic_algorithms():
        sk, pk = keygen(ctx, flagship_keygen_gen(), device=device)
        ct_sum, _, _ = secure_fedavg_round(
            setup["module"], cfg, ctx, pk, setup["params"], torch.from_numpy(xs).to(device),
            torch.from_numpy(ys).to(device), flagship_round_gen(0, 0))
        ref = decrypt_average(ctx, sk, ct_sum, 2, PackSpec.for_params(setup["params"], ctx.n))
    ref_sha = flagship_acc.params_sha256(ref)
    same = all(torch.equal(got_params[k], want_params[k]) for k in want_params)
    log(f"  (ah) first process (1 epoch, then stopped; checkpoint kept {kept}): {first_s:.3f} s; "
        f"resumed run: epochs_run {got['epochs_run']}, {got['finish_reason']}, accuracy "
        f"{got['accuracy']}, val_curve {got['val_curve']}; unchunked accuracy {want['accuracy']}; "
        f"resumed == unchunked bitwise {same} (sha {got['params_sha256'][:16]}), == the secure "
        f"round's {ref_sha == want['params_sha256']}")
    log_launch_rows(shapes)
    if not (kept and same and got["val_curve"] == want["val_curve"]
            and got["params_sha256"] == want["params_sha256"] == ref_sha
            and got["epochs_run"] == FLAGSHIP_EPOCHS and got["encode_overflow_count"] == 0):
        raise AssertionError(f"(ah) the resumed run is not the unchunked one: {got} vs {want}")
    return counts, shapes


def leftover_runs(device) -> list[tuple[dict, dict]]:
    """Phase 14: (ad)-(ah), each synthetic dataset made once."""
    with datasets_once():
        return _leftover_runs(device)


def _leftover_runs(device) -> list[tuple[dict, dict]]:
    t_phase = time.perf_counter()
    t = time.perf_counter()
    runs = [folder_round(device)]
    log(f"  phase 14 (ad) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    backend_choice_runs(device)
    log(f"  phase 14 (ae) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    runs.append(fidelity_run(device))
    log(f"  phase 14 (af) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    mfu_run(device)
    log(f"  phase 14 (ag) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    runs.append(flagship_acc_runs(device))
    log(f"  phase 14 (ah) wall time: {time.perf_counter() - t:.3f} s")
    log(f"  phase 14 wall time: {time.perf_counter() - t_phase:.3f} s")
    return runs


# Phase 15 (ai): the five BASELINE presets through results.run_preset at
# full width, cut to this depth.
RESULTS_ROUNDS = 2
RESULTS_EPOCHS = 1
# results._measure's record keys: the JAX script's, plus power_limit.
RESULTS_KEYS = frozenset((
    "preset", "label", "device", "model", "dataset", "num_clients", "encrypted", "partition",
    "prox_mu", "rounds", "seed", "wallclock_s", "cold_round_s", "warm_round_s",
    "rounds_per_sec_per_chip", "accuracy", "precision", "recall", "f1", "accuracy_by_round",
    "encode_overflow_total", "power_limit"))
# The gate's scope-coverage stages (aj) must all have run.
GATE_COVERAGE_STAGES = ("scope coverage [vmap]", "scope coverage [fused]",
                        "scope coverage [secure]", "scope coverage [stream/server]",
                        "scope coverage [hhe]", "scope coverage [inference]")


def results_runs(device, smi: str) -> list[tuple[dict, dict]]:
    """Phase 15 (ai): `results.run_preset` on the five BASELINE presets at
    full width, RESULTS_ROUNDS x RESULTS_EPOCHS: the JAX record keys plus
    power_limit, no encode overflow, the card's name and power limit in the
    record; each encrypted preset one K3 and one K4 a round, mnist-plain no
    kernel; then RESULTS_TORCH.json and RESULTS_TORCH.md written in a
    temporary directory, each table row naming the card and its limit."""
    import tempfile

    from hefl_tpu_torch import results
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.presets import BASELINE_PRESET_NAMES, PRESETS

    runs, recs = [], []
    for name in BASELINE_PRESET_NAMES:
        cuda_ntt.reset_launch_counts()
        with datasets_once():
            rec = results.run_preset(name, rounds=RESULTS_ROUNDS, epochs=RESULTS_EPOCHS,
                                     device=device)
        torch.cuda.synchronize()
        counts, shapes = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
        log(f"  (ai) {name}: wall {rec['wallclock_s']} s, cold round {rec['cold_round_s']} s, "
            f"steady {rec['warm_round_s']} s; accuracy by round {rec['accuracy_by_round']}, f1 "
            f"{rec['f1']}; encode_overflow_total {rec['encode_overflow_total']}; device "
            f"{rec['device']['kind']} ({rec['power_limit']})")
        log_launch_rows(shapes)
        want = ((RESULTS_ROUNDS, RESULTS_ROUNDS) if PRESETS[name].encrypted else (0, 0))
        if (set(rec) != RESULTS_KEYS or rec["encode_overflow_total"] != 0
                or rec["device"]["kind"] != torch.cuda.get_device_name(0)
                or not rec["power_limit"] or rec["power_limit"] not in smi
                or not 0.0 <= rec["accuracy"] <= 1.0
                or len(rec["accuracy_by_round"]) != RESULTS_ROUNDS):
            raise AssertionError(f"(ai) {name}: bad record {rec}")
        if (counts["encrypt_fused"], counts["decrypt_fused"]) != want or (
                not PRESETS[name].encrypted and any(counts.values())):
            raise AssertionError(f"(ai) {name}: launched {counts}, expected K3/K4 {want}")
        runs.append((counts, shapes))
        recs.append(rec)
    data = {"presets": recs, "convergence": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_results_") as tmp, \
            contextlib.chdir(tmp):
        results._write_evidence(data)
        md = Path(results.RESULTS_MD).read_text()
        stored = json.loads(Path(results.RESULTS_JSON).read_text())
    rows = [line for line in md.splitlines()
            if line.startswith("| ") and f"({recs[0]['power_limit']})" in line]
    log(f"  (ai) RESULTS_TORCH.md rendered in a temporary directory: {len(md.splitlines())} "
        f"lines, {len(rows)} preset rows naming the card and its limit")
    if len(rows) != len(recs) or stored != json.loads(json.dumps(data)):
        raise AssertionError(f"(ai) the rendered evidence is off: {rows}")
    return runs


def gate_run() -> None:
    """Phase 15 (aj): `python -m hefl_tpu_torch.analysis --json --device
    cuda` in its own process: exit 0, the JSON lines in the order
    certificate, finding, summary, no violation, and every coverage stage
    run (a medical-8 round on the card, a BSGS and a ladder score)."""
    t0 = time.perf_counter()
    out = port_process(["-m", "hefl_tpu_torch.analysis", "--json", "--device", "cuda"],
                       timeout=900)
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    kinds = [line["type"] for line in lines]
    rank = {"certificate": 0, "finding": 1, "summary": 2}
    summary = lines[-1] if lines else {}
    stages = {s["stage"]: s for s in summary.get("stages", [])}
    certs = [line for line in lines if line["type"] == "certificate"]
    # The interpreter's certificates carry its proven intervals (the loop
    # invariants and the lazy sum's bound), not restated closed forms.
    proven = [c for c in certs if " ⊆ " in c["summary"] or " stays in [" in c["summary"]]
    log(f"  (aj) gate process {wall:.3f} s: {kinds.count('certificate')} certificates "
        f"({len(proven)} from the interval interpreter), {kinds.count('finding')} findings; "
        f"range certification stage {stages.get('range certification', {}).get('seconds')} s; "
        f"stage seconds {json.dumps({k: v['seconds'] for k, v in stages.items()})}")
    if (kinds != sorted(kinds, key=rank.__getitem__) or kinds.count("summary") != 1
            or kinds[-1] != "summary" or summary.get("schema") != 1 or not summary.get("ok")
            or summary.get("violations") != 0 or not certs or len(proven) != len(certs)
            or "range certification" not in stages
            or any(stage not in stages for stage in GATE_COVERAGE_STAGES)):
        raise AssertionError(f"(aj) the gate's JSON lines are off: {lines[-3:]}")


def certificate_runs() -> None:
    """Phase 15 (aj): the interval interpreter's certificates with their
    probes traced on the card (FakeTensors on CUDA: nothing launches) equal
    the CPU traces string for string, at the default ring and at a refuted
    packing (k + 1) and gadget (an oversized prime)."""
    from hefl_tpu_torch.analysis import cli as gate
    from hefl_tpu_torch.analysis import ranges
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.quantize import max_interleave

    q, p, w, d = gate._default_ring()
    k = max_interleave(q, 8, 8, gate.GRID_GUARD)
    points = [
        ("aggregation", ranges.certify_aggregation, (p,), True),
        ("fold-tree", ranges.certify_fold_tree, (p,), True),
        ("inference", ranges.certify_inference, (p, w, d), True),
        ("keyswitch", ranges.certify_keyswitch, (p, w, d), True),
        ("packing", ranges.certify_packing, (q, 8, k, 8, gate.GRID_GUARD), True),
        ("packing k+1", ranges.certify_packing, (q, 8, k + 1, 8, gate.GRID_GUARD), False),
        ("transciphering", ranges.certify_transciphering, (q, 8, k, 8, gate.GRID_GUARD), True),
        ("keyswitch p>2**62", ranges.certify_keyswitch, ((1 << 62) + 135, 9, 7), False),
    ]
    cuda_ntt.reset_launch_counts()
    t0 = time.perf_counter()
    for label, certify, args, ok in points:
        on_card = certify(*args, device="cuda")
        on_cpu = certify(*args, device="cpu")
        if on_card.ok != ok or on_card.summary() != on_cpu.summary():
            raise AssertionError(f"(aj) {label}: {on_card.summary()[:300]}")
        log(f"  (aj) {label} traced on the card: {on_card.summary()[:150]}...")
    launched = sum(cuda_ntt.launch_counts().values())
    log(f"  (aj) {len(points)} certificates traced on the card and the CPU in "
        f"{time.perf_counter() - t0:.3f} s, equal string for string; port launches {launched}")
    if launched:
        raise AssertionError(f"(aj) tracing launched {launched} port kernels")


def fixture_runs() -> None:
    """Phase 15 (aj): each violation fixture through the gate's `main`
    with `--fixture F --json` and no `--device`, so on the card as the tree
    gate: exit 1, with findings under the fixture's RULE only."""
    import io
    import os

    from hefl_tpu_torch import resolve_device
    from hefl_tpu_torch.analysis import cli as gate

    folder = Path(__file__).resolve().parent / "hefl_tpu_torch" / "analysis" / "fixtures"
    env = dict(os.environ)                      # main() sets the gate's env defaults
    try:
        for path in sorted(folder.glob("violation_*.py")):
            rule = re.search(r'^RULE = "([^"]+)"', path.read_text(), re.M).group(1)
            out, t0 = io.StringIO(), time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = gate.main(["--fixture", str(path), "--json"])
            lines = [line for line in map(json.loads, out.getvalue().splitlines())
                     if line["type"] == "finding"]
            found = [line["rule"] for line in lines]
            log(f"  (aj) fixture {path.name} on {resolve_device()}: exit {rc}, findings "
                f"{found} [{time.perf_counter() - t0:.3f} s]")
            if rc != 1 or not found or set(found) != {rule}:
                raise AssertionError(f"(aj) {path.name} ({rule}): exit {rc}, findings {found}")
            if rule == "loop-overflow":
                # The loop fixpoint's finding cites the carried op.
                log(f"  (aj) {path.name}: {lines[0]['message']}")
                if not lines[0]["message"].startswith("`add` (eqn "):
                    raise AssertionError(f"(aj) {path.name}: {lines[0]['message']}")
    finally:
        os.environ.clear()
        os.environ.update(env)


def preflight_runs(device) -> tuple[dict, dict]:
    """Phase 15 (ak): a clean medical-8 run (1 round x 1 epoch) carries
    analysis.violations = 0 in its metrics; an over-headroom packing (b=16,
    k=16, 8 clients) is refused with AnalysisError by `run_experiment`, and
    by the CLI with "hefl-lint: ...", before any kernel launches."""
    from hefl_tpu_torch import analysis, cli
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.experiment import run_experiment
    from hefl_tpu_torch.fl.config import PackingConfig

    from hefl_tpu_torch.analysis import ranges
    from hefl_tpu_torch.presets import PRESETS as presets

    # The pre-flight from cold caches: its certificates trace their probes.
    for certify in (ranges.certify_aggregation, ranges.certify_fold_inductive,
                    ranges.certify_packing, ranges.certify_transciphering):
        certify.cache_clear()
    for name in ("medical-8", "hhe-smoke"):
        t0 = time.perf_counter()
        report = analysis.check_experiment(presets[name])
        log(f"  (ak) pre-flight of {name} from cold caches: {time.perf_counter() - t0:.3f} s, "
            f"{sum(c is not None for c in report.values())} certificates")
    out, _, run, _ = drive("ak, medical-8", cut("medical-8", 1, 1), 1, device)
    violations = out["obs"]["metrics"].get("analysis.violations")
    bad = cut("medical-8", 1, 1, packing=PackingConfig(bits=16, interleave=16))
    cuda_ntt.reset_launch_counts()
    try:
        with datasets_once():
            run_experiment(bad, verbose=False, device=device)
    except analysis.AnalysisError as exc:
        refused = str(exc)
    else:
        raise AssertionError("(ak) an over-headroom packing ran")
    try:
        cli.run(cli.parse_args(["--model", "medcnn", "--dataset", "medical", "--num-clients",
                                "8", "--rounds", "1", "--epochs", "1", "--pack-bits", "16",
                                "--pack-interleave", "16", "--no-save-model", "--no-events"]))
    except SystemExit as exc:
        cli_refused = str(exc)
    else:
        raise AssertionError("(ak) the CLI ran an over-headroom packing")
    launched = cuda_ntt.launch_counts()
    log(f"  (ak) clean medical-8: analysis.violations {violations}; over-headroom packing: "
        f"{refused[:160]}...; CLI: {cli_refused[:60]}...; launches after both refusals "
        f"{sum(launched.values())}")
    if violations != 0 or any(launched.values()) or not cli_refused.startswith("hefl-lint: "):
        raise AssertionError(f"(ak) violations {violations}, launches {launched}, CLI "
                             f"{cli_refused!r}")
    return run


def results_gate_runs(device, smi: str) -> list[tuple[dict, dict]]:
    """Phase 15: (ai)-(ak)."""
    t_phase = time.perf_counter()
    t = time.perf_counter()
    runs = results_runs(device, smi)
    log(f"  phase 15 (ai) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    gate_run()
    certificate_runs()
    fixture_runs()
    log(f"  phase 15 (aj) wall time: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    runs.append(preflight_runs(device))
    log(f"  phase 15 (ak) wall time: {time.perf_counter() - t:.3f} s")
    log(f"  phase 15 wall time: {time.perf_counter() - t_phase:.3f} s")
    return runs


# Phase 16: the client mesh. Each rank trains MESH_PER_RANK clients of
# MESH_IMAGES `medical` images for one epoch (MedCNN at full width).
MESH_PER_RANK = 2
MESH_IMAGES = 48
MESH_GLOO_RANKS = 2
MESH_DRIVER_ROUNDS = 2
MESH_TEST_IMAGES = 64


def mesh_rank_round(seed: int, device: str | None = None) -> dict:
    """One rank of phase 16: the encrypted MedCNN round on the mesh of the
    world's ranks (`secure_fedavg_round(mesh=)`) under the per-client loop
    and deterministic algorithms, its launches counted from zero, its phase
    times; rank 0 (the owner) decrypts, then runs the one-process round on
    the same inputs (not counted) and compares."""
    import torch.distributed as dist

    from hefl_tpu_torch import parallel
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.models import count_params, create_model

    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device(device or f"cuda:{torch.cuda.current_device()}")
    num = MESH_PER_RANK * world
    (x, y), _, _ = make_dataset("medical", seed=seed, n_train=MESH_IMAGES * num, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), num))
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    gen = torch.Generator().manual_seed(seed)
    model = create_model("medcnn", gen=gen, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    if count_params(params) != 222_722:
        raise AssertionError(f"MedCNN has {count_params(params)} params, expected 222,722")
    ctx = CkksContext.create()
    sk, pk = keygen(ctx, gen, device=device)
    spec = PackSpec.for_params(params, ctx.n)
    cfg = TrainConfig(epochs=1, num_classes=2, client_fusion="vmap")
    mesh = parallel.make_mesh(num, device=device)
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(device),
           "mesh": mesh.record()}
    with deterministic_algorithms():
        torch.cuda.synchronize()
        cuda_ntt.reset_launch_counts()
        names = ("train_block", "encrypt_stack", "psum_ciphertext")
        with timed_calls(secure, names) as calls:
            t0 = time.perf_counter()
            ct_sum, mets, overflow, ref = secure.secure_fedavg_round(
                model, cfg, ctx, pk, params, xs_d, ys_d, torch.Generator().manual_seed(seed + 1),
                with_plain_reference=True, mesh=mesh)
            torch.cuda.synchronize()
            out["round_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        avg = secure.decrypt_average(ctx, sk, ct_sum, num, spec) if rank == 0 else None
        torch.cuda.synchronize()
        out["decrypt_s"] = time.perf_counter() - t0 if rank == 0 else None
        out["counts"], out["shapes"] = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
        for name in names:
            out[f"{name}_s"] = sum(c[0] for c in calls[name]) if calls[name] else None
        out["sum_sha"] = hashlib.sha256(ct_sum.c0.cpu().numpy().tobytes()
                                        + ct_sum.c1.cpu().numpy().tobytes()).hexdigest()
        out["mets_finite"] = bool(torch.isfinite(mets).all()) and tuple(mets.shape) == (num, 1, 4)
        out["overflow"] = int(overflow.sum())
        if rank == 0:
            out["avg_err"] = max((avg[k] - ref[k]).abs().max().item() for k in ref)
            one_sum, _, _, _ = secure.secure_fedavg_round(
                model, cfg, ctx, pk, params, xs_d, ys_d, torch.Generator().manual_seed(seed + 1),
                with_plain_reference=True)
            one_avg = secure.decrypt_average(ctx, sk, one_sum, num, spec)
            out["sum_equal"] = bool(torch.equal(one_sum.c0, ct_sum.c0)
                                    and torch.equal(one_sum.c1, ct_sum.c1))
            out["avg_equal"] = all(torch.equal(avg[k], one_avg[k]) for k in avg)
    return out


def mesh_collectives(seed: int, device: str = "cuda") -> dict:
    """Phase 16 (an), on one rank: psum_mod, ring_psum_mod and
    hierarchical_psum_mod on card tensors (residues near p, each rank's
    drawn from seed + rank) against the sum mod p of every rank's rows
    on the host, and under gloo against the same collectives on CPU copies
    (NCCL takes no host tensor)."""
    import torch.distributed as dist

    from hefl_tpu_torch import parallel
    from hefl_tpu_torch.ckks.keys import CkksContext
    from hefl_tpu_torch.ckks.ntt import plain_tables

    rank, world = dist.get_rank(), dist.get_world_size()
    ctx = CkksContext.create()
    p = plain_tables(ctx.ntt, torch.device("cpu")).p
    pn = p.numpy().reshape(1, -1, 1)
    rows = [((pn - 1 - np.random.default_rng(seed + r).integers(
        0, 2**20, (55, ctx.num_primes, ctx.n))) % pn).astype(np.int32) for r in range(world)]
    want = torch.from_numpy((sum(r.astype(np.int64) for r in rows) % pn).astype(np.int32))
    x = torch.from_numpy(rows[rank])
    on_host = dist.get_backend() == "gloo"
    checks = {}
    for label, fn, mesh, axes in (
            ("psum_mod", parallel.psum_mod, parallel.make_mesh(world), "clients"),
            ("ring_psum_mod", parallel.ring_psum_mod, parallel.make_mesh(world), "clients"),
            ("hierarchical_psum_mod hosts", parallel.hierarchical_psum_mod,
             parallel.make_host_mesh(world, 1), ("hosts", "clients")),
            ("hierarchical_psum_mod clients", parallel.hierarchical_psum_mod,
             parallel.make_host_mesh(1, world), ("hosts", "clients"))):
        card = fn(x.to(device), p.to(device), mesh, axes).cpu()
        ok = bool(torch.equal(card, want))
        if on_host:
            ok = ok and bool(torch.equal(card, fn(x, p, mesh, axes)))
        checks[label] = ok
    return checks


def driver_history(out: dict) -> list[dict]:
    """A run's round records less their timings (phases, phase_roofline)."""
    return [{k: v for k, v in rec.items() if k not in ("phases", "phase_roofline")}
            for rec in out["history"]]


def mesh_driver_cfg(num: int, out_dir: Path):
    """Phase 16 (ao)'s run: medical-8 (MedCNN at full width, N=4096 L=3) cut
    to MESH_DRIVER_ROUNDS rounds of 1 epoch, `num` clients of MESH_IMAGES
    images, the per-client loop; its checkpoints, model and events under
    `out_dir`."""
    return cut("medical-8", MESH_DRIVER_ROUNDS, 1, "vmap", num_clients=num,
               n_train=MESH_IMAGES * num, n_test=MESH_TEST_IMAGES,
               checkpoint_path=str(out_dir / "round.npz"),
               save_model_path=str(out_dir / "model.npz"))


def mesh_rank_experiment(out_dir: str, device: str | None = None) -> dict:
    """Phase 16 (ao), on one rank: `run_experiment` on the mesh of the
    world's ranks (what `torchrun ... -m hefl_tpu_torch.cli` runs on each
    rank), MESH_PER_RANK clients a rank, under deterministic algorithms,
    writing under out_dir/rank{r}; its launches counted from zero."""
    import torch.distributed as dist

    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.experiment import deterministic_algorithms, run_experiment

    rank, world = dist.get_rank(), dist.get_world_size()
    mine = Path(out_dir) / f"rank{rank}"
    mine.mkdir()
    torch.cuda.synchronize()
    cuda_ntt.reset_launch_counts()
    t0 = time.perf_counter()
    with deterministic_algorithms():
        out = run_experiment(mesh_driver_cfg(MESH_PER_RANK * world, mine), verbose=False,
                             device=device or "cuda")
    torch.cuda.synchronize()
    return {"rank": rank, "seconds": time.perf_counter() - t0, "history": driver_history(out),
            "params": {k: v.cpu().numpy() for k, v in out["params"].items()},
            "mesh": out["mesh"], "counts": cuda_ntt.launch_counts(),
            "shapes": cuda_ntt.launch_rows()}


def mesh_driver_check(label: str, ranks: list[dict], out_dir: Path, device: str) -> None:
    """Phase 16 (ao): rank 0's history and parameters bitwise the
    one-process run's (run here, on `device` with no process group, not
    counted), the other ranks' parameters too; only rank 0 wrote files;
    each rank launched one K3 a round over its clients' rows, and rank 0
    alone K4 once a round."""
    from hefl_tpu_torch.experiment import deterministic_algorithms, run_experiment

    size = len(ranks)
    t0 = time.perf_counter()
    with deterministic_algorithms():
        one = run_experiment(mesh_driver_cfg(MESH_PER_RANK * size, out_dir / "one"),
                             verbose=False, device=device)
    one_s = time.perf_counter() - t0
    want = driver_history(one)
    enc_key = launch_key("encrypt_fused", (MESH_PER_RANK * 55, 3, 4096))
    dec_key = launch_key("decrypt_fused", (55, 3, 4096))
    for r in ranks:
        written = sorted(p.name for p in (out_dir / f"rank{r['rank']}").iterdir())
        log(f"  ({label}, ao) rank {r['rank']}: run_experiment {r['seconds']:.3f} s, mesh "
            f"{json.dumps(r['mesh'])}, {len(r['history'])} round record(s), wrote {written}; "
            f"launches {json.dumps({k: v for k, v in r['counts'].items() if v})}")
        lead = r["rank"] == 0
        if r["history"] != (want if lead else []):
            raise AssertionError(f"({label}, ao) rank {r['rank']}'s history is not the "
                                 f"one-process run's: {r['history']} vs {want}")
        if not all(np.array_equal(r["params"][k], v.cpu().numpy())
                   for k, v in one["params"].items()):
            raise AssertionError(f"({label}, ao) rank {r['rank']}'s parameters are not the "
                                 "one-process run's bitwise")
        if bool(written) != lead:
            raise AssertionError(f"({label}, ao) rank {r['rank']} wrote {written}: only rank 0 "
                                 "writes")
        if (r["counts"]["encrypt_fused"] != MESH_DRIVER_ROUNDS
                or r["shapes"].get(enc_key) != MESH_DRIVER_ROUNDS
                or r["counts"]["decrypt_fused"] != (MESH_DRIVER_ROUNDS if lead else 0)
                or r["shapes"].get(dec_key, 0) != (MESH_DRIVER_ROUNDS if lead else 0)):
            raise AssertionError(f"({label}, ao) rank {r['rank']}: launches {r['counts']} "
                                 f"{r['shapes']}, expected one K3 over its clients a round "
                                 "and K4 a round at rank 0 alone")
    log(f"  ({label}, ao) the one-process run ({one_s:.3f} s): accuracy "
        f"{[rec['accuracy'] for rec in want]}; rank 0's history and every rank's parameters "
        "bitwise it, only rank 0 wrote")


def mesh_world(label: str, backend: str, device: str, size: int,
               task_device: str | None = None) -> tuple[dict, dict]:
    """Phase 16 (al)/(am): one world's round, run twice in the same ranks
    (cold, then warm: cuDNN and the communicator set up), each checked;
    -> the ranks' summed (launch counts, launch rows) for the final check.
    `task_device` (None: each rank's card) is where the ranks put their
    tensors."""
    import tempfile

    from hefl_tpu_torch.parallel.launch import World

    t = time.perf_counter()
    with World(size, backend=backend, device=device) as world:
        log(f"  ({label}) world of {size} {backend} rank(s) on {device} up in "
            f"{time.perf_counter() - t:.3f} s")
        rounds = [world.run(mesh_rank_round, 0, task_device) for _ in ("cold", "warm")]
        checks = world.run(mesh_collectives, 1, task_device or "cuda") if size > 1 else None
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                         prefix=".chip_smoke_") as tmp:
            drv = world.run(mesh_rank_experiment, tmp, task_device) if size > 1 else None
            if drv is not None:
                mesh_driver_check(label, drv, Path(tmp), task_device or "cuda:0")
    log(f"  ({label}) world {rounds[0][0]['world']}, backend {rounds[0][0]['backend']}, mesh "
        f"{json.dumps(rounds[0][0]['mesh'])}")
    enc_key = launch_key("encrypt_fused", (MESH_PER_RANK * 55, 3, 4096))
    dec_key = launch_key("decrypt_fused", (55, 3, 4096))
    counts, shapes = {}, {}
    for when, ranks in zip(("cold", "warm"), rounds):
        lead = ranks[0]
        for r in ranks:
            times = {k: (round(r[k], 4) if r[k] is not None else None)
                     for k in ("round_s", "train_block_s", "encrypt_stack_s",
                               "psum_ciphertext_s", "decrypt_s")}
            reduce = ("none (one rank)" if times["psum_ciphertext_s"] is None
                      else f"{times['psum_ciphertext_s']} s")
            log(f"  ({label}, {when}) rank {r['rank']} on {r['device']}: train "
                f"{times['train_block_s']} s, upload {times['encrypt_stack_s']} s, all-reduce "
                f"{reduce}, round {times['round_s']} s, decrypt {times['decrypt_s']} s; "
                f"launches {json.dumps({k: v for k, v in r['counts'].items() if v})}")
            want_dec = 1 if r["rank"] == 0 else 0
            if r["counts"]["encrypt_fused"] != 1 or r["shapes"].get(enc_key) != 1:
                raise AssertionError(f"({label}) rank {r['rank']}: K3 launches "
                                     f"{r['counts']['encrypt_fused']} {r['shapes']}, expected "
                                     f"one over its {MESH_PER_RANK} clients' rows")
            if (r["counts"]["decrypt_fused"] != want_dec
                    or r["shapes"].get(dec_key, 0) != want_dec):
                raise AssertionError(f"({label}) rank {r['rank']}: K4 launches "
                                     f"{r['counts']['decrypt_fused']}, expected {want_dec}")
            if (r["sum_sha"] != rounds[0][0]["sum_sha"] or not r["mets_finite"]
                    or r["overflow"]):
                raise AssertionError(f"({label}) rank {r['rank']}: sum, metrics or overflow "
                                     "differ")
            if size > 1 and r["psum_ciphertext_s"] is None:
                raise AssertionError(f"({label}) rank {r['rank']} ran no all-reduce")
            for k, v in r["counts"].items():
                counts[k] = counts.get(k, 0) + v
            for k, v in r["shapes"].items():
                shapes[k] = shapes.get(k, 0) + v
        log(f"  ({label}, {when}) sum bitwise the one-process round's {lead['sum_equal']}, "
            f"decrypted average bitwise {lead['avg_equal']}, vs the plaintext mean "
            f"{lead['avg_err']:.3e} (limit {ERR_LIMIT})")
        if not (lead["sum_equal"] and lead["avg_equal"] and lead["avg_err"] <= ERR_LIMIT):
            raise AssertionError(f"({label}) the sharded round is not the one-process round")
    if checks is not None:
        log(f"  (an, {backend}) collectives on card tensors bitwise the host's sum mod p"
            + (" and their CPU counterparts" if backend == "gloo" else "")
            + f": {json.dumps(checks[0])}")
        if not all(all(c.values()) for c in checks):
            raise AssertionError(f"(an) a collective on the card differs from the host: {checks}")
    for r in drv or []:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in r["shapes"].items():
            shapes[k] = shapes.get(k, 0) + v
    log(f"  ({label}) wall time: {time.perf_counter() - t:.3f} s")
    return counts, shapes


def mesh_runs() -> list[tuple[dict, dict]]:
    """Phase 16: (al) the NCCL world of every card, (am) MESH_GLOO_RANKS gloo
    ranks sharing cuda:0, and (an) the collectives on card tensors in each
    world of more than one rank."""
    t = time.perf_counter()
    runs = [mesh_world("al", "nccl", "cuda", torch.cuda.device_count()),
            mesh_world("am", "gloo", "cuda:0", MESH_GLOO_RANKS)]
    log(f"  phase 16 wall time: {time.perf_counter() - t:.3f} s")
    return runs


# Phase 17: the streaming and hierarchical engines across the client mesh.
STREAM_MESH_CLIENTS = 8         # medical-8's registry
STREAM_MESH_IMAGES = 24         # `medical` images a client
STREAM_MESH_ROUNDS = 2
# Phase 9's knobs (a cohort of 4 of 8, quorum 0.75, a deadline, a retry)
# with a staleness budget of one round, under phase 9's fault schedule.
MESH_STREAM = dict(STREAM_KNOBS, staleness_rounds=1)
MESH_TIERS = dict(MESH_STREAM, num_hosts=4, host_quorum=0.5, ship_deadline_s=4.0)
# (ap) float CKKS uploads; (aq) 4 host tiers with b = 4 error feedback,
# CKKS and the hybrid-HE upload.
MESH_KINDS = {"flat": (MESH_STREAM, None), "tiers_ef": (MESH_TIERS, EF_PACKING),
              "tiers_ef_hhe": (dict(MESH_TIERS, upload_kind="hhe"), EF_PACKING)}
CT_SPLIT = 2                    # (ar)'s ct ranks a client row


def _medical(num: int, seed: int):
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset

    (x, y), _, _ = make_dataset("medical", seed=seed, n_train=STREAM_MESH_IMAGES * num, n_test=8)
    return stack_federated(x, y, iid_contiguous(len(y), num))


def _medcnn(device, seed: int):
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.models import count_params, create_model

    gen = torch.Generator().manual_seed(seed)
    model = create_model("medcnn", gen=gen, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    if count_params(params) != 222_722:
        raise AssertionError(f"MedCNN has {count_params(params)} params, expected 222,722")
    ctx = CkksContext.create()
    sk, pk = keygen(ctx, gen, device=device)
    return model, params, ctx, sk, pk


def stream_rank_rounds(kind: str, seed: int, device: str | None = None) -> dict:
    """One rank of phase 17 (ap)/(aq): STREAM_MESH_ROUNDS streaming rounds of
    medical-8 at full width (MedCNN 256x256x3, N=4096 L=3) on the client
    mesh of the world's ranks, `kind` of MESH_KINDS, under the per-client
    loop and deterministic algorithms, each rank's rows staged by the
    prefetcher; launches counted from zero, each rank's train, upload,
    gather, fold and decrypt seconds (synchronized host clock). Rank 0
    decrypts each committed round, then runs the one-process engine on the
    same inputs (not counted) and compares sums and decrypts."""
    import torch.distributed as dist

    from hefl_tpu_torch import parallel
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec
    from hefl_tpu_torch.data import RoundPrefetcher
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl import hierarchy, secure
    from hefl_tpu_torch.fl import stream as stream_mod
    from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
    from hefl_tpu_torch.fl.faults import FaultConfig

    rank = dist.get_rank()
    device = torch.device(device or f"cuda:{torch.cuda.current_device()}")
    num = STREAM_MESH_CLIENTS
    xs, ys = _medical(num, seed)
    model, params, ctx, sk, pk = _medcnn(device, seed)
    s_kw, p_kw = MESH_KINDS[kind]
    stream = StreamConfig(**s_kw)
    faults = FaultConfig(seed=0, **STREAM_FAULTS)
    spec = PackedSpec.for_params(params, ctx, PackingConfig(**p_kw), num) if p_kw else None
    hhe = HheConfig() if stream.upload_kind == "hhe" else None
    cfg = TrainConfig(epochs=1, num_classes=2, client_fusion="vmap")
    mesh = parallel.make_mesh(num, device=device)

    def decrypt(ct_sum, sm):
        if spec is not None:
            return secure.decrypt_average(ctx, sk, ct_sum, num, meta=sm.meta, packing=spec,
                                          base_params=params, hhe=hhe is not None)
        return secure.decrypt_average(ctx, sk, ct_sum, num, PackSpec.for_params(params, ctx.n),
                                      meta=sm.meta)

    def rounds(on_mesh: bool):
        engine = stream_mod.StreamEngine(stream, faults)
        pf = RoundPrefetcher(device)
        out = []
        for r in range(STREAM_MESH_ROUNDS):
            kw = dict(packing=spec, hhe=hhe)
            if on_mesh:
                rows = stream_mod.round_rows(stream, mesh, r, num)[0]
                xs_r, ys_r = pf.get(xs, ys, rows=rows)
                if r + 1 < STREAM_MESH_ROUNDS:
                    pf.prefetch(xs, ys, rows=stream_mod.round_rows(stream, mesh, r + 1, num)[0])
                kw.update(mesh=mesh, num_real_clients=num, resident_rows=rows)
            else:
                xs_r, ys_r = pf.get(xs, ys)
            t0 = time.perf_counter()
            ct_sum, mets, _, sm = engine.run_round(model, cfg, ctx, pk, params, xs_r, ys_r,
                                                   torch.Generator().manual_seed(seed + r), r,
                                                   **kw)
            torch.cuda.synchronize()
            rec = {"round_s": time.perf_counter() - t0, "record": sm.record(),
                   "hash": stream_mod.ct_hash(ct_sum.c0, ct_sum.c1),
                   "mets_ok": bool(torch.isfinite(mets[list(sm.cohort)]).all())}
            if rank == 0 and sm.committed:
                t0 = time.perf_counter()
                avg = decrypt(ct_sum, sm)
                torch.cuda.synchronize()
                rec["decrypt_s"] = time.perf_counter() - t0
                rec["avg"] = {k: v.cpu() for k, v in avg.items()}
            out.append(rec)
        return out

    got = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
           "device": str(device), "mesh": mesh.record(), "kind": kind}
    names = {secure: ("train_block", "encrypt_stack", "encrypt_stack_packed",
                      "hhe_encrypt_stack"),
             stream_mod: ("gather_clients",),
             stream_mod.OnlineAccumulator: ("fold",),
             hierarchy.HierarchicalAggregator: ("fold", "ship_all"),
             stream_mod.StreamEngine: ("_transcipher_round",)}
    with deterministic_algorithms():
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(device)
        cuda_ntt.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            timers = {mod: stack.enter_context(timed_calls(mod, fns))
                      for mod, fns in names.items()}
            got["rounds"] = rounds(True)
        got["counts"], got["shapes"] = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
        seconds = {}
        for mod, calls in timers.items():
            for fn, hits in calls.items():
                key = {"train_block": "train", "gather_clients": "gather", "fold": "fold",
                       "ship_all": "fold", "_transcipher_round": "transcipher"}.get(fn, "upload")
                seconds[key] = seconds.get(key, 0.0) + sum(h[0] for h in hits)
        got["seconds"] = seconds
        got["decrypt_s"] = sum(r.get("decrypt_s", 0.0) for r in got["rounds"])
        got["mem_peak_delta"] = torch.cuda.max_memory_allocated(device) - mem0
        if rank == 0:
            one = rounds(False)
            got["same_as_one"] = [a["hash"] == b["hash"] and a["record"] == b["record"]
                                  for a, b in zip(got["rounds"], one)]
            got["avg_same"] = [all(torch.equal(a["avg"][k], b["avg"][k]) for k in a["avg"])
                               for a, b in zip(got["rounds"], one) if "avg" in a]
            got["avg_finite"] = all(all(bool(torch.isfinite(v).all()) for v in r["avg"].values())
                                    for r in got["rounds"] if "avg" in r)
            got["one_round_s"] = [r["round_s"] for r in one]
    for r in got["rounds"]:
        r.pop("avg", None)
    return got


def ct_split_rank_round(num: int, seed: int, device: str | None = None) -> dict:
    """One rank of phase 17 (ar): the encrypted MedCNN round of `num`
    clients on `make_mesh_2d(num, CT_SPLIT)` (each ct rank of a client row
    encrypts ceil(55 / CT_SPLIT) of its block's rows, the slices gathered
    over the ct group) under the per-client loop; launches counted from
    zero; rank 0 decrypts and runs the one-process round (not counted)."""
    import torch.distributed as dist

    from hefl_tpu_torch import parallel
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.fl.fedavg import client_block, pad_index

    rank = dist.get_rank()
    device = torch.device(device or f"cuda:{torch.cuda.current_device()}")
    xs, ys = _medical(num, seed)
    model, params, ctx, sk, pk = _medcnn(device, seed)
    cfg = TrainConfig(epochs=1, num_classes=2, client_fusion="vmap")
    mesh = parallel.make_mesh_2d(num, CT_SPLIT, device=device)
    got = {"rank": rank, "mesh": mesh.record(), "coords": mesh.coords}
    if not mesh.member:
        return got
    n_dev = parallel.client_mesh_size(mesh)
    rows, _ = client_block(mesh, num, pad_index(num, n_dev))
    from hefl_tpu_torch.data import RoundPrefetcher

    xs_r, ys_r = RoundPrefetcher(device).get(xs, ys, rows=rows)
    with deterministic_algorithms():
        torch.cuda.synchronize()
        cuda_ntt.reset_launch_counts()
        with timed_calls(secure, ("encrypt_stack", "train_block")) as calls:
            t0 = time.perf_counter()
            ct_sum, _, _, ref = secure.secure_fedavg_round(
                model, cfg, ctx, pk, params, xs_r, ys_r, torch.Generator().manual_seed(seed + 1),
                with_plain_reference=True, mesh=mesh, num_real_clients=num, resident_rows=rows)
            torch.cuda.synchronize()
            got["round_s"] = time.perf_counter() - t0
        got["train_s"] = sum(c[0] for c in calls["train_block"])
        got["upload_s"] = sum(c[0] for c in calls["encrypt_stack"])
        got["hash"] = hashlib.sha256(ct_sum.c0.cpu().numpy().tobytes()
                                     + ct_sum.c1.cpu().numpy().tobytes()).hexdigest()
        if rank == 0:
            avg = secure.decrypt_average(ctx, sk, ct_sum, num, PackSpec.for_params(params, ctx.n))
            got["avg_err"] = max((avg[k] - ref[k]).abs().max().item() for k in ref)
        torch.cuda.synchronize()
        got["counts"], got["shapes"] = cuda_ntt.launch_counts(), cuda_ntt.launch_rows()
        if rank == 0:
            one, *_ = secure.secure_fedavg_round(
                model, cfg, ctx, pk, params, torch.from_numpy(xs).to(device),
                torch.from_numpy(ys).to(device), torch.Generator().manual_seed(seed + 1))
            got["sum_equal"] = bool(torch.equal(one.c0, ct_sum.c0)
                                    and torch.equal(one.c1, ct_sum.c1))
    return got


def resident_bytes(seed: int, device: str | None = None) -> dict:
    """Phase 17 (as), on one rank: the card memory the prefetcher's copy of
    this rank's block of medical-8's federated arrays takes
    (`torch.cuda.memory_allocated` around `get`) against the whole arrays'
    bytes; then the next round's block staged beside it (the second copy
    of the ring) and the first retired on promotion."""
    import torch.distributed as dist

    from hefl_tpu_torch import parallel
    from hefl_tpu_torch.data import RoundPrefetcher
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl import stream as stream_mod
    from hefl_tpu_torch.fl.config import StreamConfig

    device = torch.device(device or f"cuda:{torch.cuda.current_device()}")
    num = STREAM_MESH_CLIENTS
    xs, ys = _medical(num, seed)
    mesh = parallel.make_mesh(num, device=device)
    stream = StreamConfig(**MESH_STREAM)
    pf = RoundPrefetcher(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    rows0 = stream_mod.round_rows(stream, mesh, 0, num)[0]
    t0 = time.perf_counter()
    # Under deterministic algorithms `empty` queues a fill the side-stream
    # copy must wait for: the rows read back bitwise.
    with deterministic_algorithms():
        got0 = pf.get(xs, ys, rows=rows0)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    one = torch.cuda.memory_allocated(device) - base
    equal = bool(np.array_equal(got0[0].cpu().numpy(), xs[rows0])
                 and np.array_equal(got0[1].cpu().numpy(), ys[rows0]))
    pf.prefetch(xs, ys, rows=stream_mod.round_rows(stream, mesh, 1, num)[0])
    torch.cuda.synchronize()
    two = torch.cuda.memory_allocated(device) - base
    pf.get(xs, ys, rows=stream_mod.round_rows(stream, mesh, 1, num)[0])
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(device) - base
    return {"rank": dist.get_rank(), "rows": [int(r) for r in rows0], "resident": one,
            "staged_two": two, "after_promotion": after, "get_s": get_s,
            "whole": int(xs.nbytes + ys.nbytes),
            "block": int(xs[rows0].nbytes + ys[rows0].nbytes), "equal": equal,
            # Retired on promotion: the ring freed round 0's copy.
            "retired": got0[0].untyped_storage().size() == 0}


def stream_driver_cfg(out_dir: Path, **kw):
    """Phase 17 (at)'s run: medical-8 (MedCNN at full width, N=4096 L=3)
    cut to MESH_DRIVER_ROUNDS rounds of 1 epoch, STREAM_MESH_IMAGES images a
    client, the per-client loop, streaming with MESH_STREAM under phase 9's
    fault schedule, journaled under `out_dir`."""
    from hefl_tpu_torch.fl.config import StreamConfig
    from hefl_tpu_torch.fl.faults import FaultConfig

    return cut("medical-8", MESH_DRIVER_ROUNDS, 1, "vmap",
               n_train=STREAM_MESH_IMAGES * STREAM_MESH_CLIENTS, n_test=MESH_TEST_IMAGES,
               stream=StreamConfig(**MESH_STREAM), faults=FaultConfig(seed=0, **STREAM_FAULTS),
               journal_path=str(out_dir / "journal.wal"), fsync_policy="commit",
               checkpoint_path=None, save_model_path=None, events_path="", **kw)


def stream_rank_experiment(out_dir: str, crash: bool, device: str | None = None) -> dict:
    """Phase 17 (at), on one rank: the journaled streaming `run_experiment`
    on the mesh of the world's ranks (what `torchrun ... -m
    hefl_tpu_torch.cli --stream ...` runs on each rank), optionally crashed
    mid-append in round 1; launches counted from zero; how it ended, the
    journals it opened."""
    import torch.distributed as dist

    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.fl.faults import CrashConfig

    rank = dist.get_rank()
    opened = []
    real = experiment.AggregationServer

    def server(*a, **k):
        opened.append(k["journal_path"])
        return real(*a, **k)

    cfg = stream_driver_cfg(Path(out_dir), crash=(
        CrashConfig(round=1, at="mid_append", after_folds=2) if crash else None))
    torch.cuda.synchronize()
    cuda_ntt.reset_launch_counts()
    experiment.AggregationServer = server
    t0 = time.perf_counter()
    out, ended = None, "completed"
    try:
        with datasets_once():
            out = experiment.run_experiment(cfg, verbose=False, device=device or "cuda")
    except RuntimeError as e:
        ended = f"{type(e).__name__}: {e}"[:160]
    finally:
        experiment.AggregationServer = real
    torch.cuda.synchronize()
    got = {"rank": rank, "seconds": time.perf_counter() - t0, "ended": ended, "opened": opened,
           "counts": cuda_ntt.launch_counts(), "shapes": cuda_ntt.launch_rows()}
    if out is not None:
        got.update(history=driver_history(out), mesh=out["mesh"], journal=out["journal"],
                   params={k: v.cpu().numpy() for k, v in out["params"].items()})
    return got


def stream_driver_check(world, device: str) -> list[tuple[dict, dict]]:
    """Phase 17 (at): the journaled streaming run in `world`, crashed in
    round 1 (rank 0 SimulatedCrash, the others PeerRankFailed), then run
    again: rank 0 recovers from its journal, and rank 0's history and every
    rank's parameters are bitwise the uncrashed one-process run's on
    `device` (not counted); only rank 0 opens the journal."""
    import tempfile

    from hefl_tpu_torch.experiment import run_experiment

    runs = []
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_") as tmp:
        crashed = world.run(stream_rank_experiment, tmp, True, device)
        for r in crashed:
            log(f"  (at) crashed run, rank {r['rank']}: {r['seconds']:.3f} s, ended "
                f"{r['ended']!r}, opened {len(r['opened'])} journal(s)")
        if [r["ended"].split(":")[0] for r in crashed] != (
                ["SimulatedCrash"] + ["PeerRankFailed"] * (len(crashed) - 1)):
            raise AssertionError(f"(at) the crash did not end every rank: "
                                 f"{[r['ended'] for r in crashed]}")
        recovered = world.run(stream_rank_experiment, tmp, False, device)
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                         prefix=".chip_smoke_") as one_dir:
            t0 = time.perf_counter()
            with datasets_once():
                one = run_experiment(stream_driver_cfg(Path(one_dir)), verbose=False,
                                     device=device)
            one_s = time.perf_counter() - t0
    want = driver_history(one)
    for r in recovered:
        lead = r["rank"] == 0
        log(f"  (at) recovery, rank {r['rank']}: {r['seconds']:.3f} s, ended {r['ended']!r}, "
            f"opened {r['opened'] and 'the journal'}; launches "
            f"{json.dumps({k: v for k, v in r['counts'].items() if v})}")
        if r["ended"] != "completed" or r["history"] != (want if lead else []):
            raise AssertionError(f"(at) rank {r['rank']}'s recovered run is not the "
                                 f"one-process run: {r['ended']} {r.get('history')} vs {want}")
        if not all(np.array_equal(r["params"][k], v.cpu().numpy())
                   for k, v in one["params"].items()):
            raise AssertionError(f"(at) rank {r['rank']}'s parameters are not the "
                                 "one-process run's bitwise")
        if bool(r["opened"]) != lead or bool(crashed[r["rank"]]["opened"]) != lead:
            raise AssertionError(f"(at) rank {r['rank']} opened {r['opened']}: only rank 0 "
                                 "journals")
        runs.append((r["counts"], r["shapes"]))
    rep = recovered[0]["journal"]["recovered"]
    log(f"  (at) one-process run {one_s:.3f} s; recovered {json.dumps(rep)}; rank 0's history "
        f"(accuracy {[rec['accuracy'] for rec in want]}) and every rank's parameters bitwise it")
    if (rep["torn_bytes_truncated"], rep["open_round"]) != (24, 1):
        raise AssertionError(f"(at) recovery report {rep}")
    return runs


def _expected_stream_launches(kind: str, mesh: dict, lead: bool, decrypts: int) -> dict:
    """(ap)/(aq)'s predicted launches a rank: each round one K3 over its
    block of the cohort's bucket (2 of 4 clients on 2 ranks, 4 on 1), b = 4
    error feedback packing 10 rows a client; the hybrid-HE upload no K3 on
    the clients and, on every rank, the server's pads (K3) and one K7 over
    the cohort's 4 x 10 rows; K4 at rank 0 a decrypted round."""
    from hefl_tpu_torch.fl.fedavg import cohort_bucket

    n_dev = mesh["clients"]
    cpd = cohort_bucket(STREAM_KNOBS["cohort_size"], STREAM_MESH_CLIENTS, n_dev) // n_dev
    rows = 55 if kind == "flat" else 10
    want = {}
    if kind == "tiers_ef_hhe":
        want[launch_key("encrypt_fused", (STREAM_KNOBS["cohort_size"] * rows, 3, 4096))] = (
            STREAM_MESH_ROUNDS)
        want[launch_key("transcipher_fused", (STREAM_KNOBS["cohort_size"] * rows, 3, 4096))] = (
            STREAM_MESH_ROUNDS)
    else:
        want[launch_key("encrypt_fused", (cpd * rows, 3, 4096))] = STREAM_MESH_ROUNDS
    if lead and decrypts:
        want[launch_key("decrypt_fused", (rows, 3, 4096))] = decrypts
    return want


def stream_world(label: str, backend: str, device: str, size: int,
                 task_device: str | None = None, driver: bool = False) -> list[tuple[dict, dict]]:
    """Phase 17 in one world: (ap) the streaming rounds, with `driver` also
    (aq) the tiers with error feedback (CKKS and HHE), (ar) the ct split,
    (as) the resident bytes and (at) the journaled driver crashed and
    recovered. -> the ranks' (launch counts, launch rows) for the final
    check."""
    from hefl_tpu_torch.parallel.launch import World

    runs = []
    t = time.perf_counter()
    with World(size, backend=backend, device=device) as world:
        log(f"  ({label}) world of {size} {backend} rank(s) on {device} up in "
            f"{time.perf_counter() - t:.3f} s")
        kinds = ("flat", "tiers_ef", "tiers_ef_hhe") if driver else ("flat",)
        for kind in kinds:
            ranks = world.run(stream_rank_rounds, kind, 3, task_device)
            tag = "ap" if kind == "flat" else "aq"
            lead = ranks[0]
            decrypts = sum(1 for r in lead["rounds"] if r["record"]["committed"])
            for r in ranks:
                secs = {k: round(v, 4) for k, v in sorted(r["seconds"].items())}
                log(f"  ({tag}, {kind}) rank {r['rank']} of {r['world']} ({r['backend']}, "
                    f"{r['device']}): rounds {[round(x['round_s'], 4) for x in r['rounds']]} s; "
                    f"{json.dumps(secs)} s; decrypt {round(r['decrypt_s'], 4)} s; peak card "
                    f"memory +{r['mem_peak_delta'] / 2**20:.1f} MiB; launches "
                    f"{json.dumps({k: v for k, v in r['counts'].items() if v})}")
                want = _expected_stream_launches(kind, r["mesh"], r["rank"] == 0, decrypts)
                if r["shapes"] != want:
                    raise AssertionError(f"({tag}, {kind}) rank {r['rank']} launched "
                                         f"{r['shapes']}, predicted {want}")
                if [x["hash"] for x in r["rounds"]] != [x["hash"] for x in lead["rounds"]] or (
                        not all(x["mets_ok"] for x in r["rounds"])):
                    raise AssertionError(f"({tag}, {kind}) rank {r['rank']}'s sums or metrics "
                                         "differ from rank 0's")
                runs.append((r["counts"], r["shapes"]))
            log(f"  ({tag}, {kind}) records {[x['record'] for x in lead['rounds']]}")
            log(f"  ({tag}, {kind}) one-process engine rounds "
                f"{[round(x, 4) for x in lead['one_round_s']]} s; every round's sum and record "
                f"bitwise it: {lead['same_as_one']}, decrypts bitwise {lead['avg_same']}, "
                f"finite {lead['avg_finite']}")
            if not (all(lead["same_as_one"]) and all(lead["avg_same"]) and lead["avg_finite"]
                    and decrypts):
                raise AssertionError(f"({tag}, {kind}) the mesh's rounds are not the "
                                     "one-process engine's")
        if driver or size >= 2:
            num = 2 if size < 4 else 4
            ranks = world.run(ct_split_rank_round, num, 5, task_device)
            split = launch_key("encrypt_fused", (-(-55 // CT_SPLIT) * 2, 3, 4096))
            for r in ranks:
                if "counts" not in r:
                    continue
                log(f"  (ar) rank {r['rank']} at {json.dumps(r['coords'])} of "
                    f"{json.dumps(r['mesh'])}: round {r['round_s']:.4f} s, train "
                    f"{r['train_s']:.4f} s, upload (ct split) {r['upload_s']:.4f} s; launches "
                    f"{json.dumps({k: v for k, v in r['counts'].items() if v})}")
                want = {split: 1}
                if r["rank"] == 0:
                    want[launch_key("decrypt_fused", (55, 3, 4096))] = 1
                if r["shapes"] != want or r["hash"] != ranks[0]["hash"]:
                    raise AssertionError(f"(ar) rank {r['rank']} launched {r['shapes']}, "
                                         f"predicted {want}, or its sum differs")
                runs.append((r["counts"], r["shapes"]))
            lead = ranks[0]
            log(f"  (ar) {num} clients x ct {CT_SPLIT}: sum bitwise the 1-D round's "
                f"{lead['sum_equal']}, decrypted average vs the plaintext mean "
                f"{lead['avg_err']:.3e} (limit {ERR_LIMIT})")
            if not (lead["sum_equal"] and lead["avg_err"] <= ERR_LIMIT):
                raise AssertionError("(ar) the ct-split round is not the 1-D round")
        if driver:
            for r in world.run(resident_bytes, 3, task_device):
                log(f"  (as) rank {r['rank']}: rows {r['rows']} resident "
                    f"{r['resident'] / 2**20:.2f} MiB (its block {r['block'] / 2**20:.2f} MiB) "
                    f"of the whole arrays' {r['whole'] / 2**20:.2f} MiB, copied in "
                    f"{r['get_s']:.4f} s; with the next round staged "
                    f"{r['staged_two'] / 2**20:.2f} MiB, after promotion "
                    f"{r['after_promotion'] / 2**20:.2f} MiB")
                if (not r["equal"] or not r["retired"] or r["resident"] >= r["whole"]
                        or r["resident"] < r["block"]):
                    raise AssertionError(f"(as) rank {r['rank']}: resident {r['resident']} "
                                         f"bytes, block {r['block']}, whole {r['whole']}")
            runs += stream_driver_check(world, task_device or "cuda:0")
    log(f"  ({label}) wall time: {time.perf_counter() - t:.3f} s")
    return runs


def stream_mesh_runs() -> list[tuple[dict, dict]]:
    """Phase 17: (ap) the NCCL world of every card and MESH_GLOO_RANKS gloo
    ranks on cuda:0; (aq)-(at) in the gloo world, (ar) also across the
    cards when there are 2 or more."""
    t = time.perf_counter()
    cards = torch.cuda.device_count()
    runs = stream_world("ap, nccl", "nccl", "cuda", cards)
    runs += stream_world("ap-at, gloo", "gloo", "cuda:0", MESH_GLOO_RANKS, task_device="cuda:0",
                         driver=True)
    log(f"  phase 17 wall time: {time.perf_counter() - t:.3f} s")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from hefl_tpu_torch.ckks import cuda_ntt, ntt as ntt_mod

    t = time.perf_counter()
    cuda_ntt.load_library()
    log(f"phase 1: built {cuda_ntt.library_path().name} in {time.perf_counter() - t:.3f} s")
    report = ptxas_report(cuda_ntt.ptxas_report_path().read_text())
    log_ptxas_report(report)
    log_sass(cuda_ntt)

    log("phase 2: kernels vs plain versions")
    check_kernels(cuda_ntt, ntt_mod, device)

    log("phase 3: encrypted FedAvg round, MedCNN 256x256x3, N=4096 L=3, 2 clients")
    runs = [main_path(device)]
    log("phase 4: linear BSGS serving, N=4096 L=3, d=512, K=10")
    runs.append(serving_linear(device))
    log("phase 5: MLP BSGS serving, N=8192 L=5, d=64, H=16, K=10")
    runs.append(serving_mlp(device))
    log("phase 6: hybrid-HE uplink round, MedCNN 256x256x3, 8 clients, b=8 k=3, N=4096 L=3")
    runs.append(hhe_round(device))
    log("phase 7: run_experiment on the presets medical-8 (2 rounds, and resumed), medical-skew, "
        "mnist-enc, mnist-plain, cifar-resnet16 (fused), medical-8 (vmap and fused), fusion-smoke, "
        "hhe-smoke (N=256)")
    runs += driver_runs(device)
    log("phase 8: robust and private rounds: medical-8 faulted (and its unmasked twin), "
        "medical-8 with DP, chaos-smoke (N=256) and its clean twin")
    robust, sync_twin_s = robust_runs(device)
    runs += robust
    log("phase 9: the streaming service: medical-8 streaming (cohort 4 of 8) and journaled with a "
        "crash and its recovery, chaos-smoke's streaming, cohort-only and full-C twins, "
        "hhe-smoke journaled with a crash and its recovery (N=256)")
    runs += stream_runs(device, sync_twin_s)
    log("phase 10: the hierarchical fold tree and error feedback: medical-8 through 4 host tiers "
        "(clean, duplicate storm, regional outage, lossy and dark uplinks) beside its flat twins, "
        "the tier journals crashed and recovered, medical-8 streaming at b=4 with error feedback "
        "(CKKS, HHE, and a b=8 twin), chaos-smoke's hierarchical twins (N=256)")
    runs += hier_ef_runs(device)
    log("phase 11: the rotate-and-sum ladder: linear (N=4096 L=3, d=512, K=10) and MLP (N=8192 "
        "L=5, d=64, H=16) scores; medical-8 with exact_final_decode; the BENCH_TORCH_INFER, "
        "BENCH_TORCH_LOAD and BENCH_TORCH_DCN writers and the trend gate")
    runs += ladder_runs(device, smi)
    log("phase 12: the headline benchmark (bench.run: the flagship MedCNN 256x256x3, 1600 "
        "images, 2 clients x 10 epochs, N=4096 L=3, 2 rounds) and the kernel benchmark "
        "(bench_ntt.run: K1-K7 at every launched shape)")
    headline, records = headline_runs(device, smi)
    runs.append(headline)
    log("phase 13: profiler trace attribution: medical-8 (1 round x 1 epoch) through "
        "run_experiment(profile_dir=...), profile_round at the flagship's width (2 epochs), "
        "a BSGS and a ladder linear score (N=4096 L=3, d=512, K=10)")
    runs += trace_runs(device, smi)
    log("phase 14: the driver leftovers: a PNG folder through --data-dir (MedCNN 256x256x3, 2 "
        "clients, N=4096 L=3), the persisted fusion choice across two processes and the HE "
        "backend record, fidelity_check (3 seeds), mfu_probe (batch 8..256), flagship_acc "
        f"({FLAGSHIP_EPOCHS} epochs, stopped and resumed)")
    runs += leftover_runs(device)
    log(f"phase 15: results.run_preset on the five BASELINE presets ({RESULTS_ROUNDS} rounds x "
        f"{RESULTS_EPOCHS} epoch, full width), the static gate (python -m "
        "hefl_tpu_torch.analysis --json --device cuda), the pre-flight (medical-8 clean; an "
        "over-headroom packing refused)")
    runs += results_gate_runs(device, smi)
    log(f"phase 16: the client mesh: the encrypted MedCNN round (256x256x3, N=4096 L=3, "
        f"{MESH_PER_RANK} clients a rank) across {torch.cuda.device_count()} NCCL rank(s) and "
        f"across {MESH_GLOO_RANKS} gloo ranks on cuda:0, and the modular all-reduces on the card")
    runs += mesh_runs()
    log(f"phase 17: the streaming engines across the client mesh: medical-8 streaming (MedCNN "
        f"256x256x3, N=4096 L=3, cohort 4 of 8, {STREAM_MESH_ROUNDS} rounds) across "
        f"{torch.cuda.device_count()} NCCL rank(s) and {MESH_GLOO_RANKS} gloo ranks on cuda:0; "
        "4 host tiers with b=4 error feedback (CKKS and hybrid-HE), the ct split, the resident "
        "bytes, the journaled driver crashed and recovered, in the gloo world")
    runs += stream_mesh_runs()
    shapes = {}
    for _, run_shapes in runs:
        for key, count in run_shapes.items():
            shapes[key] = shapes.get(key, 0) + count
    log("phases 3-17 together:")
    log_launch_rows(shapes)
    # The ntt_kernel instantiations K1-K4 and K7 ran in phases 3-17
    # (ntt_plan's cluster size at each launched shape) must not spill
    # registers.
    launched = {ntt_kernel_label(n.bit_length() - 1, cuda_ntt.ntt_plan(rows, n),
                                 *NTT_POLICIES[name])
                for name, rows, n in shapes if name in NTT_POLICIES}
    log(f"  ntt_kernel instantiations K1-K4, K7 launched (registers, spill bytes): "
        f"{json.dumps({k: report[k] for k in sorted(launched)})}")
    if any(report[k][1] or report[k][2] for k in launched):
        raise AssertionError("an ntt_kernel instantiation the main paths launch spills registers")
    # Nor K6's kernel, which phases 4-5 launch.
    log(f"  {HOIST_KERNEL} (registers, spill bytes): {json.dumps(report[HOIST_KERNEL])}")
    if report[HOIST_KERNEL][1] or report[HOIST_KERNEL][2]:
        raise AssertionError(f"{HOIST_KERNEL}, which the serving paths launch, spills registers")
    for name, rec in records.items():
        rec["launches"] = sum(counts[name] for counts, _ in runs)
        if rec["launches"] < 1:
            raise AssertionError(f"no main path launched {name}")
        for entry in rec["shapes"]:
            entry["launches"] = shapes.get(launch_key(name, entry["shape"]), 0)
    # ENC_SHAPES, DEC_SHAPES, HOIST_SHAPES and TC_SHAPES claim every shape
    # K3, K4, K6 and K7 run at: each main-path launch must fall on exactly
    # one of them.
    for name, shape_list in (("encrypt_fused", ENC_SHAPES), ("decrypt_fused", DEC_SHAPES),
                             ("hoisted_products", HOIST_SHAPES), ("transcipher_fused", TC_SHAPES)):
        if len({launch_key(name, shape) for shape in shape_list}) != len(shape_list):
            raise AssertionError("two timed shapes of one kernel share one (B*L, N), so their "
                                 "launches cannot be told apart")
    for name in ("encrypt_fused", "decrypt_fused", "hoisted_products", "transcipher_fused"):
        timed = sum(e["launches"] for e in records[name]["shapes"])
        if timed != records[name]["launches"]:
            raise AssertionError(f"{records[name]['launches'] - timed} {name} launches at a shape "
                                 "phase 12 does not time (bench_ntt's ENC_SHAPES / DEC_SHAPES / "
                                 "HOIST_SHAPES / TC_SHAPES are stale)")

    # ROADMAP Queue 2's ranking: launches x (device time - bound), summed
    # over each kernel's timed shapes, each launch priced at its own shape
    # (launches at untimed shapes left out; the line counts them).
    ranking = []
    for name, rec in records.items():
        entries = [e for e in rec["shapes"] if e["launches"]]
        ranking.append((sum(e["launches"] * (e["ms"] - e["bound_ms"]) for e in entries), name,
                        sum(e["launches"] for e in entries), rec["launches"],
                        [e["shape"] for e in entries]))
    for loss, name, counted, launches, timed_at in sorted(ranking, reverse=True):
        log(f"  launches x (ms - bound): {name} {loss:.6f} ms ({counted} of {launches} launches, "
            f"timed at {timed_at})")
    log(smi)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
