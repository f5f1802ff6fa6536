#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (progress on stdout; the first failure exits non-zero):
  0. require a CUDA device; print the card's name and power limit;
  1. build the CUDA kernels from ops/csrc (twenty-seven sources: nvcc,
     sm_90a, one process per source): nineteen single-device kernels and
     modes, the shard modes of kernels 1-4 and the two 2-D ring kernels, the
     shard modes of the 3-D kernels 10-13 with kernel 10's emit_residual
     mode, the four 3-D ring kernels and the bf16 modes of kernels 1-4;
  2. hold each kernel against its plain PyTorch twin on the card: at
     n = 1025 and 1031 (several tiles per dimension, ragged last tiles),
     every sweep count, error mode and from_zero (kernel 1's Jacobi modes
     also with chunks forced to 64 and 256 rows, and on views at a 4-byte
     offset, which its wrappers copy; the legs, kernels 3 and 4, on both
     routes, the tile kernel and the wavefront, every output of one bit for
     bit the other's, and on the wavefront with chunks forced to 64 and 256
     rows); and at the shapes the main
     paths give them (legs at 4097² and 2049², chains from 1025², 513² and
     257² on every split of their levels between the wide launch and the
     cluster tail, each output and level 0's error bit for bit, smoother,
     residual and trigger loop at 256² down to 8², the multi-word residual
     and the per-sweep errors at 8193², the streamed trigger loop at 2305²
     and 4097², the rb-GS modes at 4097², and at 1025² and 1031² also with
     chunks forced to 64 and 256 rows); the 3-D kernels at n = 65, 129
     and 131 with tiles forced small (several tiles per dimension and z
     chunks, ragged last ones), every sweep count within each cap, from_zero,
     the clean and gpu errors and both restrictions, the per-sweep errors
     (every sweep count, both metrics), the two whole-loop trigger kernels
     (caps of 1-60 sweeps, a trigger of 0 and one that stops mid-loop; held
     to the loop of one-sweep launches bit for bit) and the multi-word
     residual (df32, tw32); and at the 3-D main paths' shapes (legs at 513³
     and 257³, smoother, residual, per-sweep errors and multi-word residual
     at 513³, the streamed trigger loop at 257³, the whole-loop one at 129³
     and 65³);
  3. the library path: 4097² V(3,3) (ω = 0.8, coarsen=3, dense coarse solve)
     through compile_program, one cold and five warm cycles, with the CUDA
     kernels and with plain PyTorch: the iterates after 1 and 6 cycles,
     the float64 relative residuals, ms/cycle, a profile of the kernels'
     cycle;
  4. the CLI path: schedules/Vcycle.txt and schedules/VcycleTrigger.txt
     (compiled engine), each in a subprocess and in process;
  5. smoother throughput at 8193², 8 sweeps per launch (the launch's
     iterate bit for bit the twin's);
  A. refinement to a tolerance: tw32 to 1e-10 at 8193² and df32 at 4097²
     (IterativeRefinementSolver), with the kernels and with kernels="torch";
     then the CLI --tol 1e-10 --state tw32 on schedules/Vcycle.txt;
  R. refinement under a policy: tw32 to 1e-10 at 4097² with the correction
     cycles on 8 row shards of the card (threshold 16), the same cycle count
     as the unsharded run;
  J. the bf16 modes of kernels 1-4 (*_bf16.cu): (a) each mode bit for bit
     its twin run on bf16 tensors (errors within BF16_ERR_RTOL): kernel 1
     with every sweep count, from_zero and metric at 65², 257², 1025² and
     1031² (rows at every 2-byte offset of a 16-byte chunk), with chunks
     forced to 64 and 256 rows, at 2049² and 4097² (1, 3, 8 sweeps) and
     8193² (8 sweeps); the legs on both routes at 65²-4097²; the residual;
     views at a 2-byte offset; (b) the bf16 V(3,3) at 4097² on the kernels
     and on the twins, bit for bit after 1 and 4 cycles, ms/cycle beside
     the fp32 cycle's; (c) tw32 refinement with bf16 inner cycles: six
     cycles at 8193² bit for bit the twins' (their relative residuals
     printed: bf16 corrections do not converge there), to 1e-10 at 513² on
     the kernels and the twins, beside fp32 inner cycles at 8193²; (d) the
     CLI's --dtype bf16 on schedules/Vcycle.txt, its Error the twins';
  B. a trigger V-cycle at 8193² (ω = 0.8, coarsen=3, trigger_batch "auto"):
     its levels reach the batched loop (8193²), the streamed kernel (4097²)
     and the whole-loop kernel (2049² and below); held against the plain
     path with trigger_batch=1 and against the same two-phase loop driven
     through the twins;
  C. rb-GS V(2,2) with full weighting at 4097², cycles and refinement;
  D. 3-D at full width: the bench's v_cycle3 V(3,3) at 513³ (ω = 0.857,
     n_min 5) and compile_program3's V(3,3) at 513³ (coarsen=3, dense solve
     at 9³, ω = 6/7) with the clean and the gpu metric, each with the kernels
     and with plain PyTorch: the iterates after 1 and 4 cycles, the float64
     relative residuals, ms/cycle, a profile; then the CLI --dim 3 on
     schedules/Vcycle.txt, schedules/Wcycle.txt and
     schedules/VcycleTrigger.txt against the JAX CLI's Error;
  E. the 3-D trigger V-cycle at 513³ (ω = 6/7, coarsen=3, clean metric, at
     most 2000 sweeps a node): its levels reach the batched passes of the
     per-sweep errors (513³), the streamed whole-loop kernel (257³) and the
     whole-loop kernel (129³, 65³); with trigger_batch 7, "auto" and 1 on the
     kernels, 7 and "auto" through the twins, 1 on the plain path;
  F. 3-D refinement: tw32 to 1e-10 at 513³ (IterativeRefinement3) with the
     kernels and with kernels="torch"; then the CLI --dim 3 --tol 1e-10
     --state tw32 on schedules/Vcycle.txt;
  G. the 2-D multi-device path on rings of shards, every shard on cuda:0
     (one card: no scaling). G1: the shard modes of kernels 1-4 and the ring
     kernels 17 and 18 against their twins at 1025² and 1031² on rings of
     2, 3, 4 and 8 shards and a 2 x 4 block mesh (several tiles a shard,
     ragged last shards and tiles), steps 1-8 and 11, from_zero, every
     error mode, per_sweep, rb-GS, both restrictions (kernel 1's shard
     modes, rb-GS too, also with chunks forced to 64 and 256 rows; the legs' shard
     modes also on the wavefront, with the rule's chunks and chunks of 64
     and 256 rows, bit for bit against the tile kernel, errors too); every
     shard mode's owned cells bit for bit against the unsharded kernel;
     kernel 18 on both routes (rdma.forced_jacobi_route "tile" and
     "wave"), kernel 2's shard mode through its one batched launch a card;
     kernel 17 with
     caps of 1-60 sweeps and a mid-loop trigger bit for bit against the loop
     of one-sweep sharded error launches, and with passes forced to every
     length 1-8 (a trigger that stops inside a pass, the redo) on rings of
     2, 3 and 8 shards and one with an 8-row shard. G2: at 4097² on 8 shards
     (threshold 16) through compile_program(policy=...) with halo ppermute
     and rdma, and the plain path: bench_scaling.py's program (coarsen=1)
     and the bench's V(3,3), one cold and five warm cycles each, bit for
     bit against the unsharded kernel run, ms/cycle and profiles (coarsen=1:
     6 residual_shard launches a cycle, and the residual's, kernel 18's and
     the DtoD copies' device ms a cycle); the rb-GS V(2,2) FW.
     G3: the 8193² trigger V-cycle on 8 shards (threshold 32) with rdma,
     ppermute and the twins ("auto") and batch 7, equal stop sweeps per
     level, held against phase B's unsharded run; and a 4097² rb-GS
     trigger V-cycle with the gpu metric on 8 shards (the rb-GS shard mode
     one sweep at a time), kernels, twins and plain path with equal stop
     sweeps. The shard modes and ring kernels are also held against their
     plain versions at the timed main-path shapes.
  H. the 3-D multi-device path on rings of z-shards, every shard on cuda:0
     (one card: no scaling). H1: the shard modes of kernels 10-13 (kernel
     10 in every mode: plain, from_zero, clean and gpu errors with 1-8
     sweeps, per_sweep, the lagged one-sweep pass) and kernel 10's
     emit_residual mode (with its clean error too, per shard bit for bit
     the clean raw of kernel 10's shard mode for the same sweeps) against
     their twins, bit for bit, and their owned
     planes against the unsharded kernels, at 65³ and 129³ with tiles forced
     small on rings of 2, 3, 4 and 8 z-shards (ragged last shards); each
     per-sweep error against the one-sweep sharded steps, and each lagged
     pass's error against the step's, bit for bit; the step and the lagged
     pass again at 129³ and 65³ on 8 z-shards with the planned tiles. H2:
     513³ on 8 z-shards (threshold 8): v_cycle3_sharded V(3,3)
     and compile_program3(policy=...) V(3,3) with the clean and gpu metrics,
     on the kernels, the twins and the plain path, one cold and three warm
     cycles, the kernel iterates bit for bit against phase D's unsharded
     runs, launch counts per route (JAX's padded depths), ms/cycle and
     profiles. H3: the 513³ trigger V-cycle under the policy with
     trigger_batch "auto" and 1 (stop sweeps per level equal to phase E's)
     and 7 (kernels against twins; one exact sweep, then passes of 7, as
     JAX's sharded batch runs). The shard modes are also held against their
     plain versions at the timed main-path shapes.
  I. the 3-D ring kernels 19-22 (halo="rdma") on rings of z-shards of
     cuda:0 (one card: no scaling). I1: each against its twin and against
     the PR 6 shard-mode path (window copies, then kernels 10-12 per shard)
     at 65³ and 129³ with tiles forced small on rings of 2, 3, 4, 8 and 16
     z-shards: kernel 20 with 1, 3, 7 and 8 sweeps, plain, from_zero, clean
     and gpu; kernel 21 with both restrictions, from_zero on and off;
     kernel 22 with and without the error and the coarse correction in
     three layouts; kernel 19 with both metrics and a trigger that stops it
     after 50 sweeps or more, against the loop of one-sweep sharded error
     launches; bit for bit, and for kernels 20-22 the raw float64 sums per
     shard against the shard modes'. I2: H2's three programs with halo="rdma", bit
     for bit against phase D's unsharded runs (which H2's ppermute runs
     equal), the ring launches per cycle by kernel, ms/cycle, a profile.
     I3: H3's trigger V-cycle with halo="rdma" ("auto", batch 1, batch 7):
     kernel 19 once per trigger node at 257³-65³ and never at 513³; "auto"
     and batch 1 stop where H3 stops, with its iterates; batch 7 at 513³ as
     H3's, below it as the exact loop.
  K. (run last, after phase 5) the native runtime and the user-facing utilities:
     the port's own build of native/mg_runtime.cpp (build/torch_native/)
     must load; the four
     bundled schedules and generated ones (v_cycle, w_cycle, fmg,
     coarsen=2) parse natively to the Python parser's programs, and the
     natively parsed Vcycle.txt's compiled cycle gives the Python-parsed
     one's iterate bit for bit; a 4097² solution written by the native and
     the numpy CSV writers (byte-identical files, seconds each) and read
     back by read_solution_csv and read_csv_native (its values to 6
     decimals); the CLI on Vcycle.txt writing its Sol_GPU_ file through
     the native writer (Error = 0.000876); utils.profiling.trace() around
     one V(3,3) cycle at 4097², four times, each trace whole (naming the
     CUDA kernels the launch counters say the cycle ran, no launch without
     its kernel event) or empty (late in this script every other profiler
     session holds no device event, PERF.md §7), at least two whole; beside
     four bare torch.profiler sessions of the same cycle (kernel events,
     launch calls, the least launch-to-start time), cost_report's bytes
     bound beside the cycle's ms by CUDA events and DeviceTimer.measure; a tw32 solve
     to 1e-10 at 4097² with DistCheckpointManager(every=2) stopped by
     max_cycles and resumed from latest() by a fresh solver, ending with
     the uninterrupted solve's cycle count and words bit for bit (save and
     resume seconds); examples/torch_01-05 as subprocesses on the card (01
     prints Vcycle.txt's Error, 02-04 residuals within the tolerances they
     ask for, 05 BIT-IDENTICAL with the chains on and off).
  L. (after phase K) the sharded cycles across processes: two worker
     processes joined by gloo (NCCL refuses two ranks on one card), both on
     cuda:0 with two mesh entries each, run the bench's V(3,3) at 4097²
     (coarsen=3, ω 0.8) under multihost.block_policy on the 2×2
     hybrid_block_mesh (1 cold + 3 warm cycles), a trigger V-cycle at 2049²
     on a row ring of the four entries, and compile_program3 V(3,3) at 513³
     (clean metric, 2 cycles) on a z ring across both processes; this
     process runs the same programs on ["cuda:0"] * 4. Every owned block
     (SHA-256), error and stop sweep is the one-process run's, each worker
     launches the shard-mode kernels, the sharded layer's counters equal
     utils.scaling_model's prediction; ms/cycle by CUDA events for both
     runs and the layer's host overheads (a correctness phase: the
     processes share one card, no scaling is shown).
The ring kernels are timed beside
     their twins and the exchange path they replace on the same inputs;
     kernel 19 with the planned tiles at 257³ is held bit for bit against
     the loop of one-sweep sharded error steps, and timed a sweep at 257³,
     129³ and 65³. Kernel 10's one-sweep shard step (129³, 65³ on 8
     z-shards) and its fixed modes at 513³ (3 sweeps + clean, + gpu, from
     zero; whole grid and 8 z-shards) are timed too, the 2-D legs (kernels
     3 and 4) at 8193², 2049², 1025² and 257² (device µs from CUDA graph
     replays below 8193²) and their shard modes at 4097² on 8 row shards
     (device µs a pass), and the 3-D legs (kernels
     11 and 12 on their column passes) at 129³ and 65³, whole grid and on 8
     z-shards, with kernel 11 from zero at 513³; the ring kernels 20-22 and
     kernel 20's exchange path at 129³ and 65³ on 8 z-shards, and kernel 13
     at 257³ and 129³, whole grid and on 8 z-shards (device µs from CUDA
     graph replays at these sizes), with a torch.add of the same two 513³
     volumes beside kernel 13's row as its byte yardstick; kernel 10's
     emit_residual mode at 513³, whole grid and on 8 z-shards, and at 129³
     and 65³ (µs). G3 reads kernel 17's device ms in its rdma "auto" run
     from the profiler; H2 and I2 kernel 13's, emit_residual's and the ring
     kernels' a cycle. Kernel 1's rb-GS mode at 4097², 1025² and 257² and
     its shard pass on 8 row shards (device µs, graph replays) and kernel 17
     a sweep at 4097² on 8 shards print beside the tile-era parent's; kernel
     18 on both routes (8 sweeps at 4097², and in device µs at every launch
     shape of G2's coarsen=1 cycle and at 4097²-513²) and kernel 2's batched
     shard mode at every G2 level (device µs), each bit for bit its twin,
     beside the parent's (2327a20: the tile pipeline, a launch a shard).
Launch counts are set to 0 just before each main-path run and read just
after it. The line before the last is a JSON object describing each kernel;
the last line is the JSON device record. Without a CUDA device the script
exits 1 and prints no result.
"""

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel-vs-twin tolerances: the kernels and twins run the same fp32
# operations, but the error reductions sum in another order.
U_RTOL = 1e-5      # max|Δ| of a grid output ≤ U_RTOL · max|twin output|
ERR_RTOL = 1e-4    # fused error scalars, relative
RES_RTOL = 1e-2    # main path: kernel vs plain float64 residuals, relative
# The CLI's deep solve against the JAX CLI's Error: the two packages' fp32
# problem data differ (torch's and XLA's fp32 exp disagree by an ulp at ~7%
# of points), which moves a 1e-10 solve's Error in its 5th digit; on shared
# data the port prints JAX's 6 digits (tests/test_torch_refine.py).
CLI_TOL_ERR, CLI_TOL_RTOL = 2.221316e-07, 2e-4

# H100 SXM: the data sheet's device memory rate, and the fp32 instruction
# rate outside the tensor cores: 132 SMs × 128 lanes × 1.98 GHz. The data
# sheet's 67 TFLOP/s counts an FMA as two operations, but the kernels'
# __f*_rn arithmetic is never contracted into FMAs, so each counted
# operation is one instruction. A bound is the larger of bytes / HBM and
# operations / FP32.
HBM, FP32 = 3.35e12, 33.5e12
# fp32 operations per point, counted from the kernels' source
SWEEP_OPS = 10     # Jacobi point: 3 adds, 4u, −, h²f, −, ×¼, ×ω, +
RES_OPS = 7        # residual point: 3 adds, 4u, −, ×h⁻², −
ERR_OPS = 9        # residual point + |·| + accumulate
RBGS_OPS = 6       # half-update of a cell: 3 adds, h²f, −, ×¼
RBGS_ERR_OPS = 10  # the Jacobi Δ of a cell: 3 adds, 4u, −, h²f, −, ×¼, |·|, +
# The tile-era rb-GS mode's and ring trigger kernel's device times (7ca9eae,
# before both moved to the wavefront), beside which the [t] rows print this
# tree's: examples/torch_ring_clock.py on an NVIDIA H100 80GB HBM3 at 700 W
# (µs a call from CUDA graph replays; kernel 17 ms a sweep from CUDA events)
PARENT_RBGS_US = {4097: 255.3168, 1025: 29.488, 257: 22.776, "shard": 326.432}
PARENT_RING_MS_A_SWEEP = 0.2156
# Kernel 18 and kernel 2's shard mode before their redesign (2327a20: the
# tile pipeline, a launch a shard): examples/torch_kernel_ab.py ROOT ring on
# an NVIDIA H100 80GB HBM3 at 700 W; kernel 18 with 8 sweeps at 4097² on 8
# shards in ms (CUDA events), 3 sweeps from zero and not at (n, from_zero)
# and a pass of the residual's 8 launches at n in device µs (graph replays)
PARENT_RING18_MS = 0.5817
PARENT_RING18_US = {(4097, True): 169.4064, (4097, False): 253.592, (2049, True): 59.4896,
                    (2049, False): 86.4848, (2048, True): 52.8816, (2048, False): 77.2496,
                    (1025, True): 21.4576, (1025, False): 27.552, (1024, True): 18.7296,
                    (1024, False): 23.728, (513, True): 16.4672, (513, False): 20.488,
                    (512, True): 15.9232, (512, False): 20.4224, (256, True): 16.0496,
                    (256, False): 21.296, (128, True): 15.272, (128, False): 19.7728}
PARENT_RES_SHARD_US = {4097: 148.192, 2048: 120.176, 1024: 61.9696, 512: 60.456, 256: 59.7104,
                       128: 43.736}
RES_MW_OPS = {2: 227, 3: 232}   # two dd chains, the exact product, the combination
# The bf16 modes of kernels 1-4 (phase J): the kernels round every result the
# twin materialises to bf16 (a cvt and a widening move, 2 instructions each;
# the Jacobi point 10 roundings, the residual point 7), and their error sums
# are float partials in the tile order rounded once, where the twins' torch.sum
# rounds the sum and each scaling to bf16 (2-3 roundings of 2^-9): errors are
# held to 2^-6 relative. Bytes count 2 a state word.
BF16_SWEEP_OPS = SWEEP_OPS + 2 * 10
BF16_RES_OPS = RES_OPS + 2 * 7
BF16_ERR_OPS = BF16_RES_OPS + 2
BF16_PROLONG_OPS = 3 + 2 * 4   # the prolongation and add of a point: ~3 ops, ~4 roundings
BF16_ERR_RTOL = 2.0 ** -6
# the 3-D kernels (col3.cuh's passes), per fine point unless noted
SWEEP3_OPS = 11    # 7-point sweep: 5 adds, 6u, −, h²f, −, ×ω/6, +
EXTRA3_OPS = 11    # the clean error of an iterate: 5 adds, 6u, −, ×h⁻², −, |·|, accumulate
RES3_OPS = 9       # residual: 5 adds, 6u, −, ×h⁻², −
GPU_ERR3_OPS = 3   # the gpu error of a point: −, |·|, accumulate
FW3_OPS = 65       # per coarse point: 9 z-combines (3×, 2+), 3 y-combines, 1 x-combine
PROLONG3_OPS = 5.75  # prolongation and add, averaged over the parities of (z, y, x)
RES_MW3_OPS = {2: 329, 3: 337}  # two 7-point dd chains, the exact product, the combination
# the JAX CLI's --dim 3 Error on the 256³ schedules (fp32, CPU, compiled engine;
# VcycleTrigger.txt measured once with the JAX package's CLI on the CPU)
CLI3_ERRORS = {"Vcycle.txt": 3.422244e-02, "Wcycle.txt": 3.339685e-03,
               "VcycleTrigger.txt": 8.048455e-04}
CLI3_RTOL = 1e-4
# VcycleTrigger.txt's 64³ trigger node (plain ops in both packages) stops on
# a near-tie: its slope at sweep 277 lies within the noise of an fp32 sum of
# the trigger, so the summation decides the stop (XLA's fp32 sum: 278
# sweeps; the port's float64 sum: 277), and one sweep moves Error by 3.0e-3
# relative (ROADMAP Queue 3, item 5)
CLI3_RTOL_OF = {"VcycleTrigger.txt": 5e-3}

# Path B's stop sweeps per level (the 8193² trigger V-cycle), batch 7 and
# "auto", as the sweep-at-a-time trigger kernels gave them (this script on an
# NVIDIA H100 80GB HBM3): the kernels' sums and stop rule decide them, not
# their design
_PATH_B_MID = [(4097, 2), (2049, 2), (1025, 2), (513, 2), (257, 2), (129, 2), (65, 2),
               (33, 3), (17, 11), (17, 4), (33, 4), (65, 4), (129, 4), (257, 4), (513, 4),
               (1025, 4), (2049, 4), (4097, 3)]
PATH_B_STOPS_BATCH7 = [(8193, 7)] + _PATH_B_MID + [(8193, 7)]
PATH_B_STOPS_AUTO = [(8193, 2)] + _PATH_B_MID + [(8193, 5)]

PKG = "multigrid_poisson_solver_tpu_torch/ops/csrc/"
TPU = "multigrid_poisson_solver_tpu/ops/"
KERNELS = {  # name -> (CUDA source, TPU kernel it replaces, main-path run)
    "jacobi": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:161", "Vcycle.txt"),
    "residual": (PKG + "residual.cu", TPU + "pallas_kernels.py:1077", "Vcycle.txt"),
    "trigger": (PKG + "trigger.cu", TPU + "pallas_chain.py:501", "VcycleTrigger.txt"),
    "descend": (PKG + "descend.cu", TPU + "pallas_kernels.py:590", "library"),
    "ascend": (PKG + "ascend.cu", TPU + "pallas_kernels.py:852", "library"),
    "chain_descend": (PKG + "chain_descend.cu", TPU + "pallas_chain.py:228", "library"),
    "chain_ascend": (PKG + "chain_ascend.cu", TPU + "pallas_chain.py:292", "library"),
    "residual_mw": (PKG + "residual_mw.cu", TPU + "pallas_kernels.py:1474", "refine"),
    "jacobi_errs": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:161", "trigger8193"),
    "trigger_stream": (PKG + "trigger_stream.cu", TPU + "pallas_chain.py:636", "trigger8193"),
    "rbgs": (PKG + "rbgs.cu", TPU + "pallas_kernels.py:161", "rbgs"),
    "jacobi3": (PKG + "jacobi3.cu", TPU + "pallas3d.py:237", "compiled3_gpu"),
    "descend3": (PKG + "descend3.cu", TPU + "pallas3d.py:746", "v_cycle3"),
    "ascend3": (PKG + "ascend3.cu", TPU + "pallas3d.py:1103", "v_cycle3"),
    "residual3": (PKG + "residual3.cu", TPU + "pallas3d.py:1420", "compiled3_gpu"),
    "jacobi3_errs": (PKG + "jacobi3.cu", TPU + "pallas3d.py:237", "trigger3_513"),
    "trigger3": (PKG + "trigger3.cu", TPU + "pallas3d.py:1804", "trigger3_513"),
    "trigger3_stream": (PKG + "trigger3_stream.cu", TPU + "pallas3d.py:1999", "trigger3_513"),
    "residual_mw3": (PKG + "residual_mw3.cu", TPU + "pallas3d.py:1588", "refine3"),
    # the shard modes of kernels 1-4 and the two ring kernels (phase G)
    "jacobi_shard": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:500", "sharded"),
    "jacobi_errs_shard": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:500", "sharded_trigger_b7"),
    "rbgs_shard": (PKG + "rbgs.cu", TPU + "pallas_kernels.py:500", "sharded_rbgs"),
    "residual_shard": (PKG + "residual.cu", TPU + "pallas_kernels.py:1166", "sharded"),
    "descend_shard": (PKG + "descend.cu", TPU + "pallas_kernels.py:1233", "sharded_legs"),
    "ascend_shard": (PKG + "ascend.cu", TPU + "pallas_kernels.py:1388", "sharded_legs"),
    "rdma_jacobi": (PKG + "rdma_jacobi.cu", TPU + "pallas_rdma.py:157", "sharded_rdma"),
    "rdma_trigger": (PKG + "rdma_trigger.cu", TPU + "pallas_rdma.py:396", "sharded_trigger_rdma"),
    # the shard modes of the 3-D kernels 10-13 and kernel 10's emit_residual
    # mode (phase H)
    "jacobi3_shard": (PKG + "jacobi3.cu", TPU + "pallas3d.py:586", "h_compiled3_gpu"),
    "jacobi3_errs_shard": (PKG + "jacobi3.cu", TPU + "pallas3d.py:586", "h_trigger3_b7"),
    "jacobi3_residual": (PKG + "jacobi3.cu", TPU + "pallas3d.py:682", "h_v_cycle3"),
    "descend3_shard": (PKG + "descend3.cu", TPU + "pallas3d.py:1007", "h_v_cycle3"),
    "ascend3_shard": (PKG + "ascend3.cu", TPU + "pallas3d.py:1321", "h_v_cycle3"),
    "residual3_shard": (PKG + "residual3.cu", TPU + "pallas3d.py:1530", "h_compiled3_gpu"),
    # the 3-D ring kernels 19-22 (phase I)
    "rdma_trigger3": (PKG + "rdma_trigger3.cu", TPU + "pallas_rdma3.py:66", "i_trigger3_auto"),
    "rdma_jacobi3": (PKG + "rdma_jacobi3.cu", TPU + "pallas_rdma3.py:422", "i_compiled3_gpu"),
    "rdma_descend3": (PKG + "rdma_descend3.cu", TPU + "pallas_rdma3.py:856", "i_compiled3"),
    "rdma_ascend3": (PKG + "rdma_ascend3.cu", TPU + "pallas_rdma3.py:1285", "i_compiled3"),
    # the bf16 modes of kernels 1-4 (phase J): kernels 1 and 2 on the CLI's
    # --dtype bf16 Vcycle.txt run, the legs on the bf16-inner refinement
    "jacobi_bf16": (PKG + "jacobi_bf16.cu", TPU + "pallas_kernels.py:161", "cli_bf16"),
    "residual_bf16": (PKG + "residual_bf16.cu", TPU + "pallas_kernels.py:1077", "cli_bf16"),
    "descend_bf16": (PKG + "descend_bf16.cu", TPU + "pallas_kernels.py:590", "refine_bf16"),
    "ascend_bf16": (PKG + "ascend_bf16.cu", TPU + "pallas_kernels.py:852", "refine_bf16"),
}


# the kernels every single-device path reaches (phase 2 holds them); then
# the 2-D shard modes and the ring kernels (phase G), the 3-D shard modes
# (phase H), the 3-D ring kernels (phase I) and the bf16 modes (phase J)
SINGLE_DEVICE = tuple(KERNELS)[:19]
PHASE_G = tuple(KERNELS)[19:27]
PHASE_H = tuple(KERNELS)[27:33]
PHASE_I = tuple(KERNELS)[33:37]
PHASE_J = tuple(KERNELS)[37:]


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, reps, rounds=5):
    """Median over ``rounds`` of the mean device time of ``reps`` chained calls
    (CUDA events; one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def wall_ms(fn):
    """Host wall time of one call that ends in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def device_events(fn):
    """One call of fn under torch.profiler after a warm one: (its wall ms,
    [(event, device ms, count)] largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(fn)
    # the device's own events (kernels, copies, fills), not the host ops
    # that launched them, which carry the same device time again
    return wall, sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                        key=lambda r: -r[1])


def profile(label, fn, per=1):
    """Device time by kernel over one call of fn (torch.profiler), per
    ``per`` units of work, and the device's idle share of the wall time
    (the profiler slows the host, so the idle share is an upper bound)."""
    wall, rows = device_events(fn)
    busy = sum(r[1] for r in rows)
    say(f"[p] {label}: wall {wall / per:.3f} ms, device busy {busy / per:.3f} ms per unit, "
        f"idle {max(0.0, 1 - busy / wall):.1%} (under the profiler)")
    for key, ms, count in rows[:8]:
        say(f"[p]     {ms / per:8.3f} ms  {count / per:6.1f}×  {key[:90]}")
    return rows


def kernel_ms(rows, match, per=1):
    """Device ms of the profile rows whose kernel name ``match`` accepts, per
    ``per`` units, and their launches."""
    hit = [(ms, count) for key, ms, count in rows if match(key)]
    return sum(ms for ms, _ in hit) / per, sum(count for _, count in hit) / per


def graph_us(fn, per=1, replays=20):
    """Device µs of one call of fn, per ``per`` units: the call captured in a
    CUDA graph and timed with CUDA events around ``replays`` replays, so its
    kernels, copies and fills run back to back with no gap in which the card
    waits for the host (whose launch rate sets CUDA events' time around eager
    calls at 129³ and 65³). The profiler's sums dropped events late in this
    script (0 µs for 10 residual3 calls at 257³ on an H100, PERF.md)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm: workspaces and buffers allocated outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) * 1e3 / replays / per
    del graph
    return us


def trace_device_side(path, counts):
    """A Chrome trace's device side: per counted kernel its kernel events;
    the kernel events in all; the places (0 = first, in time order) of the
    kernel launch calls whose kernel event is missing; and the least time in
    µs from a launch call to its kernel's start, by correlation (negative:
    the device's timestamps run behind the host's)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")), key=lambda e: e["ts"])
    start = {e["args"].get("correlation"): e["ts"] for e in launches}
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    lost = [i for i, e in enumerate(launches) if e["args"].get("correlation") not in seen]
    lags = [e["ts"] - start[c] for e in kernels
            if (c := e.get("args", {}).get("correlation")) in start]
    hits = {k: sum(bool(re.search(rf"\b{k}_(kernel|wave_kernel|tail)\b", e.get("name", "")))
                   for e in kernels) for k in counts}
    return hits, len(kernels), len(launches), lost, min(lags, default=float("nan"))


def bound(nbytes, ops):
    """(the least time the card could take in ms, what bounds it)."""
    tb, tf = nbytes / HBM * 1e3, ops / FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Compare:
    """Per-kernel record of kernel-vs-twin comparisons."""

    def __init__(self):
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.bitwise = {k: True for k in KERNELS}
        self.cases = {k: 0 for k in KERNELS}

    def grid(self, kernel, what, got, want):
        import torch

        require(got.shape == want.shape, f"{kernel} {what}: shape {tuple(got.shape)} "
                f"vs twin {tuple(want.shape)}")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        self.max_abs[kernel] = max(self.max_abs[kernel], diff)
        self.bitwise[kernel] &= bool(torch.equal(got, want))
        require(bool(torch.isfinite(got).all()), f"{kernel} {what}: non-finite output")
        require(diff <= U_RTOL * scale,
                f"{kernel} {what}: max|Δ| {diff:.3e} > {U_RTOL:g}·{scale:.3e}")

    def scalar(self, kernel, what, got, want):
        got, want = float(got), float(want)
        require(abs(got - want) <= ERR_RTOL * abs(want),
                f"{kernel} {what}: error {got:.9e} vs twin {want:.9e}")

    def grids(self, kernel, what, got, want):
        require(len(got) == len(want), f"{kernel} {what}: {len(got)} levels vs {len(want)}")
        for k, (g, w) in enumerate(zip(got, want)):
            self.grid(kernel, f"{what} level {k}", g, w)


def ladder(n0, n_min=9):
    sizes = [n0]
    while sizes[-1] > n_min:
        sizes.append((sizes[-1] + 1) // 2)
    return tuple(sizes)


def phase2(K, torch, cmp, problem, GridSpec):
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 0.8

    def legs(n, steps_list, modes, fzs, restrictions, ascend=True, routes=(None,)):
        """The legs against their twins; with several ``routes`` (None: the
        size rule's; "tile", "wave": K.forced_leg_route) each route, and
        every output of each bit for bit the first route's."""
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        m = (n + 1) // 2
        uc = rand(m, m)

        def on_routes(name, what, fn):
            outs = []
            for route in routes:
                with K.forced_leg_route(route) if route else contextlib.nullcontext():
                    outs.append(fn())
            for route, out in zip(routes[1:], outs[1:]):
                require(all(a is b or bool(torch.equal(a, b)) for a, b in zip(out, outs[0])),
                        f"{name} {what}: the {route} route differs from the {routes[0]} route")
            return outs[0]

        for steps in steps_list:
            for compat in modes:
                tag = f"n={n} steps={steps} err={compat}"
                mode = True if compat is None else compat
                for fz in fzs:
                    # from_zero: the kernel must not read u, so u stays random
                    for restriction in restrictions:
                        args = (h, steps, omega, restriction, mode, compat is not None, fz)
                        what = f"{tag} fz={fz} {restriction}"
                        gu, gfc, ge = on_routes("descend", what,
                                                lambda: K.fused_descend(u, f, *args))
                        wu, wfc, we = K.fused_descend_torch(u, f, *args)
                        cmp.grid("descend", what + " u", gu, wu)
                        cmp.grid("descend", what + " f_coarse", gfc, wfc)
                        if compat is not None:
                            cmp.scalar("descend", what, ge, we)
                        cmp.cases["descend"] += 1
                if ascend:
                    args = (h, steps, omega, mode, compat is not None)
                    gu, ge = on_routes("ascend", tag, lambda: K.fused_ascend(u, f, uc, *args))
                    wu, we = K.fused_ascend_torch(u, f, uc, *args)
                    cmp.grid("ascend", tag, gu, wu)
                    if compat is not None:
                        cmp.scalar("ascend", tag, ge, we)
                    cmp.cases["ascend"] += 1

    def smoother(n, steps_list, modes, fzs, negate=(False, True)):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for ng in negate:
            cmp.grid("residual", f"n={n} negate={ng}", K.residual(u, f, h, ng),
                     K.residual_torch(u, f, h, ng))
            cmp.cases["residual"] += 1
        for steps in steps_list:
            for compat in modes:
                for fz in fzs:
                    tag = f"n={n} steps={steps} err={compat} fz={fz}"
                    if compat is None:
                        cmp.grid("jacobi", tag, K.fused_jacobi(u, f, h, steps, omega, fz),
                                 K.fused_jacobi_torch(u, f, h, steps, omega, fz))
                    else:
                        gu, ge = K.fused_jacobi_err(u, f, h, steps, omega, compat, fz)
                        wu, we = K.fused_jacobi_err_torch(u, f, h, steps, omega, compat, fz)
                        cmp.grid("jacobi", tag, gu, wu)
                        cmp.scalar("jacobi", tag, ge, we)
                    cmp.cases["jacobi"] += 1

    def chains(sizes, pre, post, restriction, fz, compat, want_err):
        """Both chains against their twins on every split of the ladder
        (K.forced_chain_split: the levels n <= S in the cluster tail, 0 all
        wide), every output bit for bit; level 0's error bit for bit the
        error of a per-level fused_ascend launch on the tile route."""
        h0 = 1.0 / (sizes[0] - 1)
        n0, nc = sizes[0], sizes[-1]
        u0, f0, uc = rand(n0, n0), rand(n0, n0), rand(nc, nc)
        d_args = (sizes, h0, pre, omega, restriction, fz)
        wu, wf = K.chain_descend_torch(u0, f0, *d_args)
        a_args = (wu, [f0] + wf[:-1], uc, sizes, h0, post, omega, compat, want_err)
        au, ae = K.chain_ascend_torch(*a_args)
        if want_err:
            # level 0 alone: the level below from the twin (bit for bit the
            # chain's), then one ascend launch on the tile route
            below = K.chain_ascend_torch(wu[1:], wf[:-1], uc, sizes[1:], 2 * h0, post[1:],
                                         omega)[0] if len(sizes) > 2 else uc
            with K.forced_leg_route("tile"):
                lu, le = K.fused_ascend(wu[0], f0, below, h0, post[0], omega, compat, True)
            require(bool(torch.equal(lu, au)), f"chain_ascend {sizes}: the tile route's "
                    "level 0 differs from the twin's")
        for split in (257, 129, 65, 0):
            with K.forced_chain_split(split):
                gu, gf = K.chain_descend(u0, f0, *d_args)
                what = f"{n0}..{nc} pre={pre} {restriction} fz={fz} split={split}"
                cmp.grids("chain_descend", what + " u", gu, wu)
                cmp.grids("chain_descend", what + " f", gf, wf)
                require(all(bool(torch.equal(a, b)) for a, b in zip(gu + gf, wu + wf)),
                        f"chain_descend {what}: not bit for bit the twin's")
                cmp.cases["chain_descend"] += 1
                gu, ge = K.chain_ascend(*a_args)
                what = (f"{n0}..{nc} post={post} err={compat if want_err else None} "
                        f"split={split}")
                cmp.grid("chain_ascend", what, gu, au)
                require(bool(torch.equal(gu, au)),
                        f"chain_ascend {what}: not bit for bit the twin's")
                if want_err:
                    cmp.scalar("chain_ascend", what, ge, ae)
                    require(bool(torch.equal(ge, le)), f"chain_ascend {what}: error "
                            f"{float(ge):.9e}, a fused_ascend launch's {float(le):.9e}")
                cmp.cases["chain_ascend"] += 1

    def one_sweep_loop(n, u, f, compat, trig, max_sweeps):
        """The loop the whole-loop trigger kernels are held to: trigger_loop
        over kernel 1's one-sweep launches, whose partials the kernels form
        and sum in the same order."""
        h = 1.0 / (n - 1)
        return trigger_loop(lambda v: K.fused_jacobi_err(v, f, h, 1, omega, compat), u, trig,
                            max_sweeps)

    def trigger(n, u, f, compat, trig, max_sweeps, loop=False, route=None, ref=None,
                twin=True):
        """Kernel 8 (on ``route``: "cluster", "tile" or "wave" through
        K.forced_trigger_route, else the size rule's) against its twin's
        loop (the same stop) and, with ``loop``, bit for bit the one-sweep
        loop (``ref`` where given), and then (``twin``) the twin run for
        that many sweeps."""
        h = 1.0 / (n - 1)
        forced = contextlib.nullcontext() if route is None else K.forced_trigger_route(route)
        with forced:
            gu, ge, gk = K.trigger_smooth(u, f, h, omega, compat, trig, max_sweeps)
        what = f"n={n} err={compat} trigger={trig} max={max_sweeps} route={route}"
        if loop:
            ru, re_, rk = ref or one_sweep_loop(n, u, f, compat, trig, max_sweeps)
            require(int(gk) == rk and bool(torch.equal(gu, ru)) and bool(torch.equal(ge, re_)),
                    f"trigger {what}: {int(gk)} sweeps vs {rk} of the loop of one-sweep kernel "
                    "1 launches, or another iterate or error")
            cmp.cases["trigger"] += 1
            if not twin:
                return int(gk)
            # the twin run for that many sweeps (its errors sum in another
            # order, so its own stop test may flip near the threshold)
            wu, we, wk = K.trigger_smooth_torch(u, f, h, omega, compat, 0.0, int(gk))
        else:
            wu, we, wk = K.trigger_smooth_torch(u, f, h, omega, compat, trig, max_sweeps)
            require(int(gk) == int(wk), f"trigger {what}: {int(gk)} sweeps vs twin {int(wk)}")
            cmp.cases["trigger"] += 1
        cmp.grid("trigger", f"{what} ({int(wk)} sweeps)", gu, wu)
        cmp.scalar("trigger", what, ge, we)
        return int(gk)

    def stream(n, u, f, compat, trig, max_sweeps):
        """The streamed loop against the sweep-at-a-time loop of one-sweep
        kernel launches, which sums the same partials in the same order: the
        same stop sweep, iterate and error, bit for bit. Then against the
        twin run for that many sweeps: the twin's errors sum in another
        order, so near the threshold its own stop test can flip a few sweeps
        apart after thousands of sweeps."""
        h = 1.0 / (n - 1)
        gu, ge, gk = K.trigger_smooth_stream(u, f, h, omega, compat, trig, max_sweeps)
        ru, re_, rk = one_sweep_loop(n, u, f, compat, trig, max_sweeps)
        what = f"n={n} err={compat} trigger={trig} max={max_sweeps}"
        require(int(gk) == rk and bool(torch.equal(gu, ru)) and bool(torch.equal(ge, re_)),
                f"trigger_stream {what}: {int(gk)} sweeps vs {rk} of the one-sweep launches")
        wu, we, _ = K.trigger_smooth_torch(u, f, h, omega, compat, 0.0, int(gk))
        cmp.grid("trigger_stream", f"{what} ({int(gk)} sweeps)", gu, wu)
        cmp.scalar("trigger_stream", what, ge, we)
        cmp.cases["trigger_stream"] += 1
        return int(gk), gu, ge

    def residual_mw(n):
        h = 1.0 / (n - 1)
        u0 = rand(n, n)
        u1, u2, f = rand(n, n) * 1e-8, rand(n, n) * 1e-16, rand(n, n)
        cmp.grid("residual_mw", f"n={n} tw", K.residual_tw(u0, u1, u2, f, h),
                 K.residual_tw_torch(u0, u1, u2, f, h))
        cmp.grid("residual_mw", f"n={n} df", K.residual_df(u0, u1, f, h),
                 K.residual_df_torch(u0, u1, f, h))
        cmp.cases["residual_mw"] += 2

    def jacobi_errs(n):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for compat in (True, False, "gpu"):
            for steps in range(1, K.errs_sweep_cap(compat) + 1):
                gu, ge = K.fused_jacobi_errs(u, f, h, steps, omega, compat)
                wu, we = K.fused_jacobi_errs_torch(u, f, h, steps, omega, compat)
                what = f"n={n} err={compat} steps={steps}"
                cmp.grid("jacobi_errs", what, gu, wu)
                for s in range(steps):
                    cmp.scalar("jacobi_errs", f"{what} iterate {s + 1}", ge[s], we[s])
                cmp.cases["jacobi_errs"] += 1
            # errs[s − 1] is the error a launch of s sweeps reports, bit for bit
            for s in range(1, steps + 1):
                require(torch.equal(ge[s - 1], K.fused_jacobi_err(u, f, h, s, omega, compat)[1]),
                        f"jacobi_errs n={n} err={compat}: errs[{s - 1}] differs from the "
                        f"error of {s} sweeps")

    def rbgs(n):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for steps in (1, 2, 3, 4):
            for fz in (False, True):
                what = f"n={n} steps={steps} fz={fz}"
                cmp.grid("rbgs", what, K.fused_rbgs(u, f, h, steps, fz),
                         K.fused_rbgs_torch(u, f, h, steps, fz))
                cmp.cases["rbgs"] += 1
                for compat in (True, False):
                    gu, ge = K.fused_rbgs_err(u, f, h, steps, compat, fz)
                    wu, we = K.fused_rbgs_err_torch(u, f, h, steps, compat, fz)
                    cmp.grid("rbgs", f"{what} err={compat}", gu, wu)
                    cmp.scalar("rbgs", f"{what} err={compat}", ge, we)
                    cmp.cases["rbgs"] += 1

    # kernel 8 on every route at every band layout of the cluster (block 0
    # alone to 65², 3-5 busy blocks at 66²-131², 8 at 256² and 257²), bit
    # for bit the one-sweep loop on every metric: max_sweeps 1, 2 and 9, a
    # stop at sweep 2, and stops on the problem's data
    trigger_inside = [0]
    route_stops = {}
    for n in (16, 33, 65, 66, 100, 129, 131, 256, 257):
        spec = GridSpec(n)
        ub = problem.boundary_grid(spec, torch.float32, "cuda")
        fb = problem.source_grid(spec, torch.float32, "cuda") + ub
        for compat in (True, False, "gpu"):
            u, f = rand(n, n), rand(n, n)
            cases = [(u, f, 0.0, m) for m in (1, 2, 9)] + [(u, f, 1e30, 50)]
            cases += [(ub, fb, trig, 100_000) for trig in (0.01, 1e-4)]
            for u, f, trig, max_sweeps in cases:
                ref = one_sweep_loop(n, u, f, compat, trig, max_sweeps)
                for route in ("cluster", "tile", "wave"):
                    k = trigger(n, u, f, compat, trig, max_sweeps, loop=True, route=route,
                                ref=ref, twin=route == "cluster" and u is not ub)
                if trig == 1e-4:
                    route_stops[f"{n}/{compat}"] = k
    say(f"[2] kernel 8 on every route, stop sweeps at trigger 1e-4 (level/metric): "
        f"{route_stops}")
    # several tiles per dimension, ragged last tiles; every mode
    for n in (1025, 1031):
        smoother(n, (1, 3, 7, 8), (None, True, False, "gpu"), (False, True))
        # the legs on both routes (the size rule takes the tile kernel here)
        legs(n, (1, 3, 7, 8), (None, True, False, "gpu"), (False, True),
             ("sampling", "full_weighting"), routes=("tile", "wave"))
        # kernel 8 above the cluster, on the tile loop (the rule's here) and
        # the wavefront passes: the final iterate in out or the scratch grid,
        # stops on the problem's data, and with passes forced to 7 a stop
        # inside a pass
        for compat in (True, False, "gpu"):
            for max_sweeps in (50, 51):
                u, f = rand(n, n), rand(n, n)
                ref = one_sweep_loop(n, u, f, compat, 0.0, max_sweeps)
                for route in ("tile", "wave"):
                    trigger(n, u, f, compat, 0.0, max_sweeps, loop=True, route=route, ref=ref,
                            twin=route == "tile")
            u = rand(n, n) * 0.01
            f = problem.source_grid(GridSpec(n), torch.float32, "cuda")
            for trig in (1e-2, 1e-3):
                ref = one_sweep_loop(n, u, f, compat, trig, 100_000)
                for route in ("tile", "wave"):
                    trigger(n, u, f, compat, trig, 100_000, loop=True, route=route, ref=ref,
                            twin=False)
                with K.forced_trigger_batch(7):
                    k = trigger(n, u, f, compat, trig, 100_000, loop=True, route="wave", ref=ref,
                                twin=False)
                trigger_inside[0] += k % 7 != 0
        residual_mw(n)
        jacobi_errs(n)
        rbgs(n)
    # kernel 1's wavefront with chunks of several tile rows, which its
    # occupancy rule gives only large grids: every sweep count, error kind
    # and from_zero, the per-sweep mode and the rb-GS modes (iterates bit for
    # bit, main)
    for rows in (64, 256):
        with K.forced_chunk_rows(rows):
            for n in (1025, 1031):
                smoother(n, range(1, 9), (None, True, False, "gpu"), (False, True), negate=())
                jacobi_errs(n)
                rbgs(n)
                # the legs' wavefront the same way: every sweep count, error
                # kind, from_zero and restriction, its outputs bit for bit the
                # tile kernel's
                legs(n, range(1, 9), (None, True, False, "gpu"), (False, True),
                     ("sampling", "full_weighting"), routes=("wave", "tile"))
    # u and f 4 bytes into a buffer (contiguous views): kernel 1's entry
    # points refuse them (its 16-byte copies), its wrappers pass aligned
    # copies, and the results are the aligned inputs', bit for bit
    from multigrid_poisson_solver_tpu_torch.ops import build

    lib = build.load()
    for n in (1025, 1031):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        uv, fv = (torch.empty(n * n + 1, device="cuda")[1:].view(n, n).copy_(x) for x in (u, f))
        for steps, compat in ((1, True), (2, "gpu"), (8, None)):
            got = K.fused_jacobi_err(uv, fv, h, steps, omega, compat) if compat else \
                (K.fused_jacobi(uv, fv, h, steps, omega), None)
            want = K.fused_jacobi_err(u, f, h, steps, omega, compat) if compat else \
                (K.fused_jacobi(u, f, h, steps, omega), None)
            require(all(a is b or bool(torch.equal(a, b)) for a, b in zip(got, want)),
                    f"jacobi n={n} steps={steps} err={compat}: a view at an offset differs")
        gu, ge = K.fused_jacobi_errs(uv, fv, h, 7, omega, True)
        wu, we = K.fused_jacobi_errs(u, f, h, 7, omega, True)
        require(bool(torch.equal(gu, wu)) and bool(torch.equal(ge, we)),
                f"jacobi_errs n={n}: a view at an offset differs")
        for steps in (1, 3):
            gu, ge = K.fused_rbgs_err(uv, fv, h, steps, True)
            wu, we = K.fused_rbgs_err(u, f, h, steps, True)
            require(bool(torch.equal(gu, wu)) and bool(torch.equal(ge, we)),
                    f"rbgs n={n} steps={steps}: a view at an offset differs")
        rc = lib.mg_jacobi(uv.data_ptr(), fv.data_ptr(), torch.empty_like(u).data_ptr(), None,
                           None, n, 1, 0, 0, h * h, omega, 1.0 / (h * h), 0.0, 0.0,
                           torch.cuda.current_stream().cuda_stream)
        require(rc == 716, f"mg_jacobi took a misaligned u and f (rc {rc}, not "
                "cudaErrorMisalignedAddress)")
        rc = lib.mg_rbgs(uv.data_ptr(), fv.data_ptr(), torch.empty_like(u).data_ptr(), None,
                         None, n, 1, 0, 0, h * h, 0.0, torch.cuda.current_stream().cuda_stream)
        require(rc == 716, f"mg_rbgs took a misaligned u and f (rc {rc}, not "
                "cudaErrorMisalignedAddress)")
    # the library path's legs: 3 sweeps, sampling, the finest level's cpu error
    # (the size rule's wavefront, its outputs bit for bit the tile kernel's)
    for n in (4097, 2049):
        legs(n, (3,), (None, True), (False, True), ("sampling",), routes=(None, "tile"))
    # the library path's chains (1025 → 9, from zero) and other ladders,
    # entering at 1025², 513² and 257², on every split
    chains(ladder(1025), (3,) * 7, (3,) * 7, "sampling", True, True, False)
    chains(ladder(1025), (3,) * 7, (3,) * 7, "sampling", False, True, True)
    chains(ladder(1025, 3), (8, 1, 2, 3, 4, 5, 6, 7, 8), (8, 0, 1, 2, 3, 4, 5, 6, 7),
           "full_weighting", False, False, True)
    chains(ladder(513), (3,) * 6, (3,) * 6, "full_weighting", True, "gpu", True)
    chains(ladder(513, 3), (1, 8, 2, 7, 3, 6, 4, 5), (5, 4, 6, 3, 7, 2, 8, 1), "sampling",
           False, False, True)
    chains(ladder(257), (2,) * 5, (1,) * 5, "full_weighting", True, "gpu", True)
    chains(ladder(257, 3), (3, 1, 4, 1, 5, 2, 6), (1, 6, 2, 5, 0, 8, 4), "sampling", False,
           True, True)
    chains((33, 17), (3,), (3,), "sampling", False, True, True)
    chains((5, 3), (2,), (2,), "full_weighting", False, False, True)
    # a split whose tail does not fit the cluster raises; nothing falls back
    f0 = rand(1025, 1025)
    with K.forced_chain_split(513):
        try:
            K.chain_descend(None, f0, ladder(1025), 1.0 / 1024, (3,) * 7, omega, "sampling", True)
            torch.cuda.synchronize()
            refused = False
        except RuntimeError:
            refused = True
    require(refused, "chain_descend ran a 513² level in the cluster tail")
    with K.forced_trigger_route("cluster"):
        try:
            K.trigger_smooth(f0, f0, 1.0 / 1024, omega, True, 0.0, 3)
            torch.cuda.synchronize()
            refused = False
        except RuntimeError:
            refused = True
    require(refused, "trigger_smooth ran a 1025² level in the cluster")
    # the CLI path's even levels: trigger smoothing on the problem's own data,
    # single sweeps with and without the finest error, residuals
    sweeps = {}
    for n in (256, 128, 64, 32, 16, 8):
        smoother(n, (1,), (None, True), (False,))
        spec = GridSpec(n)
        u = problem.boundary_grid(spec, torch.float32, "cuda")
        f = problem.source_grid(spec, torch.float32, "cuda") + u
        for trig in (0.01, 1e-4):
            if n >= 16:
                sweeps[f"{n}@{trig:g}"] = trigger(n, u, f, True, trig, 100_000)
    say(f"[2] trigger sweeps on the problem's data (level@trigger): {sweeps}")
    # this slice's main-path shapes: the refinement's 8193² residual and the
    # trigger V-cycle's 8193² passes, its streamed 4097² level (and a ragged
    # 2305²), the rb-GS cycle's 4097² level
    residual_mw(8193)
    jacobi_errs(8193)
    rbgs(4097)
    stops, inside = {}, 0
    for n in (2305, 4097):
        for compat in (True, False, "gpu"):
            b = K.errs_sweep_cap(compat)
            # one pass (the iterate in out), two (in the scratch grid), a
            # short last pass, and a loop that ends inside a pass (the replay)
            for max_sweeps in (b, 2 * b, 2 * b + 3, b - 2):
                stream(n, rand(n, n), rand(n, n), compat, 0.0, max_sweeps)
            spec = GridSpec(n)
            u = rand(n, n) * 0.01
            f = problem.source_grid(spec, torch.float32, "cuda")
            for trig in (1e-2, 1e-3):
                k, ku, ke = stream(n, u, f, compat, trig, 100_000)
                stops[f"{n}@{trig:g}/{compat}"] = k
                # passes of 7 (the stop inside a pass unless 7 divides it):
                # the same loop, bit for bit
                with K.forced_trigger_batch(7):
                    gu, ge, gk = K.trigger_smooth_stream(u, f, 1.0 / (n - 1), omega, compat,
                                                         trig, 100_000)
                require(int(gk) == k and bool(torch.equal(gu, ku)) and bool(torch.equal(ge, ke)),
                        f"trigger_stream {n} {compat} {trig}: passes of 7 give another loop")
                cmp.cases["trigger_stream"] += 1
                inside += k % 7 != 0
    say(f"[2] streamed trigger stop sweeps (level@trigger/metric): {stops}")
    require(inside > 0 and trigger_inside[0] > 0, "no trigger loop stopped inside a pass of "
            "7: the redo went unchecked")
    torch.cuda.synchronize()


@contextlib.contextmanager
def twins_in_place(K):
    """Every kernel entry point of ops.kernels replaced by its plain twin, so
    the engine's kernel routing runs its exact control flow on the twins."""
    names = ["fused_jacobi", "fused_jacobi_err", "fused_jacobi_errs", "fused_rbgs",
             "fused_rbgs_err", "residual", "fused_descend", "fused_ascend", "chain_descend",
             "chain_ascend", "trigger_smooth"]
    saved = {name: getattr(K, name) for name in names + ["trigger_smooth_stream",
                                                         "residual_df", "residual_tw"]}
    for name in names:
        setattr(K, name, getattr(K, name + "_torch"))
    K.trigger_smooth_stream = K.trigger_smooth_torch
    K.residual_df, K.residual_tw = K.residual_df_torch, K.residual_tw_torch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


@contextlib.contextmanager
def twins3_in_place(K3):
    """Every kernel entry point of ops.kernels3 replaced by its plain twin
    (both whole-loop trigger kernels by the one-sweep loop)."""
    names = ["fused_jacobi3", "fused_jacobi3_err", "fused_jacobi3_errs", "fused_descend3",
             "fused_ascend3", "residual3", "trigger_step3", "trigger_smooth3", "residual_df3",
             "residual_tw3"]
    saved = {name: getattr(K3, name) for name in names + ["trigger_smooth3_stream"]}
    for name in names:
        setattr(K3, name, getattr(K3, name + "_torch"))
    K3.trigger_smooth3_stream = K3.trigger_smooth3_torch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K3, name, fn)


def phase_refine(tmg, K, torch, run_counts):
    """Path A: refinement to a tolerance, kernels against kernels="torch"."""
    results = {}
    for n, state, tol in ((8193, "tw32", 1e-10), (4097, "df32", 1e-9)):
        for kernels in ("auto", "torch"):
            solver = tmg.IterativeRefinementSolver(
                tmg.REFERENCE_PROBLEM, n, config=tmg.SolverConfig(omega=0.8, kernels=kernels),
                max_cycles=30, state=state, device="cuda")
            K.reset_launch_counts()
            ms, rep = wall_ms(lambda: solver.solve(tol))
            counts = dict(K.launches)
            if kernels == "auto" and n == 8193:
                run_counts["refine"] = counts
            require(kernels == "auto" or not any(counts.values()),
                    f"the plain refinement launched {counts}")
            require(bool(torch.isfinite(rep.u).all()) and rep.u.shape == (n, n),
                    f"refinement {n}² {state}: non-finite or misshapen result")
            rate = rep.rel_residual ** (1.0 / max(rep.cycles, 1))
            say(f"[A] refine {n}² {state} to {tol:g} kernels={kernels}: {rep.cycles} cycles, "
                f"rel {rep.rel_residual:.6e}, error {rep.error_vs_analytic:.6e}, wall {ms:.1f} ms "
                f"({ms / max(rep.cycles, 1):.2f} ms/cycle), effective contraction {rate:.4f}")
            results[(n, kernels)] = rep
            if kernels == "auto" and n == 8193:
                profile(f"refine {n}² {state} per cycle", lambda: solver.solve(tol),
                        per=rep.cycles)
        k, t = results[(n, "auto")], results[(n, "torch")]
        require(k.cycles == t.cycles, f"refine {n}² {state}: {k.cycles} cycles with the kernels, "
                f"{t.cycles} plain")
        if state == "tw32":
            require(k.rel_residual <= tol, f"tw32 {n}²: rel {k.rel_residual:.3e} > {tol:g}")
        for what, got, want in (("u", k.u, t.u), ("u_lo", k.u_lo, t.u_lo)):
            diff, scale = float((got - want).abs().max()), float(want.abs().max())
            say(f"[A] {n}² {state} word {what}: max|kernel − plain| {diff:.3e} "
                f"(bit-identical: {bool(torch.equal(got, want))})")
            require(diff <= U_RTOL * scale, f"refine {n}² {state}: {what} differs")
    say(f"[A] launches over the 8193² tw32 kernel run: {run_counts['refine']}")


def phase_cli_tol(cli, K, run_counts):
    argv = ["1", "schedules/Vcycle.txt", "--tol", "1e-10", "--state", "tw32", "--quiet",
            "--no-output"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    require(proc.returncode == 0, f"CLI --tol failed:\n{proc.stdout}\n{proc.stderr}")
    m = re.search(r"RelRes = (\S+) after (\d+) cycles\n\s+Error = (\S+)\nTime Used = (\S+)",
                  proc.stdout)
    require(m is not None, f"CLI --tol printed no result:\n{proc.stdout}")
    err = float(m.group(3))
    say(f"[A] CLI --tol 1e-10 --state tw32 Vcycle.txt: RelRes = {m.group(1)} after "
        f"{m.group(2)} cycles, Error = {m.group(3)} (JAX CLI: 16 cycles, {CLI_TOL_ERR:.6e}), "
        f"solve {m.group(4)} ms, process {ms:.0f} ms")
    require(int(m.group(2)) == 16, "CLI --tol on Vcycle.txt: not 16 cycles")
    require(abs(err - CLI_TOL_ERR) <= CLI_TOL_RTOL * CLI_TOL_ERR,
            f"CLI --tol Error {err:.6e} vs {CLI_TOL_ERR:.6e}")
    K.reset_launch_counts()
    require(cli.main(argv + ["--device", "cuda"]) == 0, "in-process CLI --tol failed")
    run_counts["cli_tol"] = dict(K.launches)
    say(f"[A] launches over the in-process CLI --tol run: {run_counts['cli_tol']}")


def phase_trigger(tmg, K, torch, run_counts):
    """Path B: the trigger V-cycle at 8193² across all three trigger tiers.
    On the reference problem no 8193² trigger node outlasts the 2B exact
    sweeps "auto" starts with, so "auto" is the trigger_batch=1 loop there;
    the batched passes of the per-sweep error mode run with an integer
    trigger_batch, the main run."""
    n = 8193
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    cap = 2000
    out, profiled = {}, []

    def run(tag, batch, kernels="auto"):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, kernels=kernels,
                               trigger_batch=batch, max_trigger_sweeps=cap)
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        require(bool(torch.isfinite(u).all()) and bool(torch.isfinite(err)),
                f"trigger V-cycle {tag}: non-finite result")
        say(f"[B] trigger V-cycle {n}² {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}")
        hit = [k for _, k in cc.trigger_sweeps if k >= cap]
        if hit:
            say(f"[B] {tag}: {len(hit)} trigger node(s) reached max_trigger_sweeps={cap}")
        out[tag] = (u, float(err), cc.trigger_sweeps, ms, counts)
        if batch == 7 and not profiled:
            profiled.append(tag)
            cc.trigger_sweeps = None
            rows = profile(f"trigger V-cycle {n}² {tag}", lambda: cc(u0, f))
            ms1, k1 = kernel_ms(rows, lambda key: "jacobi_errs_kernel<" in key)
            say(f"[t] jacobi_errs (kernel 1's per-sweep mode) in the {tag} run: {ms1:.3f} ms "
                f"device, {k1:.0f} launches, of {sum(r[1] for r in rows):.3f} ms busy "
                f"(torch.profiler)")
            # the whole-loop trigger kernels by route: kernel 8's cluster
            # (≤ 257²), tile loop (513², 1025²) and wavefront passes (2049²),
            # kernel 9's passes (4097²)
            parts = {name: kernel_ms(rows, lambda key, m=match: m(key)) for name, match in (
                ("kernel 8 cluster", lambda key: "trigger_cluster_kernel" in key),
                ("kernel 8 tile loop", lambda key: key.startswith("trigger_kernel")),
                ("kernel 8 wavefront", lambda key: "trigger_wave_kernel<" in key),
                ("kernel 9 wavefront", lambda key: "trigger_stream_wave_kernel<" in key))}
            say(f"[t] trigger kernels in the {tag} run (ms device, launches): "
                + ", ".join(f"{k} {ms:.3f} in {c:.0f}" for k, (ms, c) in parts.items())
                + f"; kernels 8 + 9 {sum(ms for ms, _ in parts.values()):.3f} ms")
        return tag, counts

    main, run_counts["trigger8193"] = run("kernels, batch 7", 7)
    auto = run("kernels, auto", "auto")[0]
    batch1 = run("kernels, batch 1", 1)[0]
    with twins_in_place(K):
        twins = run("twins, batch 7", 7)[0]
        twins_auto = run("twins, auto", "auto")[0]
    plain = run("plain, batch 1", 1, kernels="torch")[0]
    for a, b in ((main, twins), (auto, twins_auto), (batch1, plain)):
        ua, ea, sa = out[a][:3]
        ub, eb, sb = out[b][:3]
        require(sa == sb, f"trigger V-cycle: stop points {sa} ({a}) vs {sb} ({b})")
        diff, scale = float((ua - ub).abs().max()), float(ub.abs().max())
        say(f"[B] {a} vs {b}: equal stop points, max|Δu| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(ua, ub))})")
        require(diff <= U_RTOL * scale, f"trigger V-cycle iterates differ: {a} vs {b}")
    counts = run_counts["trigger8193"]
    say(f"[B] launches over the batch-7 kernel run: {counts}; over the auto run: "
        f"{out[auto][4]}")
    for k in ("trigger", "trigger_stream", "jacobi_errs"):
        require(counts[k] > 0, f"the trigger V-cycle did not launch {k}")
    # the stop sweeps the sweep-at-a-time trigger kernels gave: the kernels'
    # sums and stop rule, not their design, decide them
    for tag, want in ((main, PATH_B_STOPS_BATCH7), (auto, PATH_B_STOPS_AUTO)):
        require(out[tag][2] == want, f"trigger V-cycle {tag}: stop sweeps {out[tag][2]}, "
                f"not the earlier runs' {want}")
    # the first node (8193² going down) starts where the exact run's does:
    # its batched passes overshoot the exact stop sweep by fewer than 7
    (m, k), (_, k1) = out[main][2][0], out[batch1][2][0]
    require(m == n and k % 7 == 0 and k1 <= k < k1 + 7,
            f"batch-7 {m}²: {k} sweeps against {k1} exact")
    return {tag: out[tag][3] for tag in out}, out[main][2], out[auto][2]


def phase_rbgs(tmg, K, torch, run_counts):
    """Path C: rb-GS V(2,2) with full weighting at 4097², cycles and refinement."""
    n = 4097
    program = tmg.v_cycle(n, n_min=8, steps=2, coarse_option=0, coarsen=3)
    results = {}
    for kernels in ("auto", "torch"):
        cfg = tmg.SolverConfig(smoother="rbgs", restriction="full_weighting",
                               collect_node_stats=False, kernels=kernels)
        cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
        u0, f = cold.init()
        K.reset_launch_counts()
        u1, _ = cold(u0, f)
        u = u1
        for _ in range(5):
            u, err = warm(u, f)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        if kernels == "auto":
            run_counts["rbgs"] = counts
        require(bool(torch.isfinite(u).all()) and bool(torch.isfinite(err)),
                f"rb-GS cycle kernels={kernels}: non-finite output")
        ms = time_ms(lambda: warm(u, f), reps=5, rounds=3)
        results[kernels] = (u1, u, ms)
        if kernels == "auto":
            profile(f"rb-GS V(2,2) FW {n}² per cycle",
                    lambda: [warm(u, f) for _ in range(3)], per=3)
        say(f"[C] rb-GS V(2,2) FW {n}² kernels={kernels}: {ms:.3f} ms/cycle, last error "
            f"{float(err):.6e}")
    for i, what in ((0, "1 cycle"), (1, "6 cycles")):
        got, want = results["auto"][i], results["torch"][i]
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[C] iterate after {what}: max|u_kernel − u_plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"rb-GS iterates differ after {what}")
    say(f"[C] launches over the kernel path's 6 cycles: {run_counts['rbgs']}")
    require(not run_counts["rbgs"]["descend"] and run_counts["rbgs"]["rbgs"] > 0
            and run_counts["rbgs"]["residual"] > 0, "the rb-GS cycle took the wrong kernels")
    reps = {}
    for kernels in ("auto", "torch"):
        cfg = tmg.SolverConfig(smoother="rbgs", restriction="full_weighting", kernels=kernels)
        solver = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n, program=program,
                                               config=cfg, max_cycles=30, device="cuda")
        ms, reps[kernels] = wall_ms(lambda: solver.solve(1e-9))
        say(f"[C] refine rb-GS FW {n}² df32 to 1e-9 kernels={kernels}: {reps[kernels].cycles} "
            f"cycles, rel {reps[kernels].rel_residual:.6e}, wall {ms:.1f} ms")
    require(reps["auto"].cycles == reps["torch"].cycles, "rb-GS refinement: cycle counts differ")
    return results["auto"][2]


def phase2_3d(K3, torch, cmp, small=((65, (6, 10, 6)), (129, (8, 16, 10)), (131, (8, 16, 10))),
              legs=(513, 257), main=513):
    """The 3-D kernels against their twins: at the ``small`` sizes with the
    tile forced to (ty, tx, cz), every sweep count within each cap, from_zero,
    the clean and gpu errors, both restrictions, the per-sweep errors, the
    trigger loops and the multi-word residual; then with the planned tiles
    at the main paths' shapes."""
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 6.0 / 7.0

    def jacobi(n, u, f, h, steps, fz, modes):
        tag = f"n={n} steps={steps} fz={fz}"
        if None in modes:
            cmp.grid("jacobi3", tag, K3.fused_jacobi3(u, f, h, steps, omega, fz),
                     K3.fused_jacobi3_torch(u, f, h, steps, omega, fz))
            cmp.cases["jacobi3"] += 1
        for mode in modes:
            if mode is None or (mode == "clean" and steps - fz > 7):
                continue
            gu, ge = K3.fused_jacobi3_err(u, f, h, steps, omega, mode, fz)
            wu, we = K3.fused_jacobi3_err_torch(u, f, h, steps, omega, mode, fz)
            cmp.grid("jacobi3", f"{tag} err={mode}", gu, wu)
            cmp.scalar("jacobi3", f"{tag} err={mode}", ge, we)
            cmp.cases["jacobi3"] += 1

    def descend(n, u, f, h, steps, fz, restriction, want_err):
        tag = f"n={n} steps={steps} fz={fz} {restriction} err={want_err}"
        args = (h, steps, omega, fz, restriction, want_err)
        gu, gfc, ge = K3.fused_descend3(u, f, *args)
        wu, wfc, we = K3.fused_descend3_torch(u, f, *args)
        cmp.grid("descend3", tag + " u", gu, wu)
        cmp.grid("descend3", tag + " f_coarse", gfc, wfc)
        if want_err:
            cmp.scalar("descend3", tag, ge, we)
        cmp.cases["descend3"] += 1

    def ascend(n, u, f, uc, h, steps, want_err):
        tag = f"n={n} steps={steps} err={want_err}"
        gu, ge = K3.fused_ascend3(u, f, uc, h, steps, omega, want_err)
        wu, we = K3.fused_ascend3_torch(u, f, uc, h, steps, omega, want_err)
        cmp.grid("ascend3", tag, gu, wu)
        if want_err:
            cmp.scalar("ascend3", tag, ge, we)
        cmp.cases["ascend3"] += 1

    def residual(n, u, f, h):
        for ng in (False, True):
            cmp.grid("residual3", f"n={n} negate={ng}", K3.residual3(u, f, h, ng),
                     K3.residual3_torch(u, f, h, ng))
            cmp.cases["residual3"] += 1

    def errs(n, u, f, h, all_counts=True):
        """Every sweep count (or the cap), both metrics; errs[s − 1] is the
        error the s-th one-sweep step of a trigger loop reports, bit for bit."""
        for compat in ("clean", "gpu"):
            cap = K3.errs3_sweep_cap(compat)
            for steps in range(1 if all_counts else cap, cap + 1):
                gu, ge = K3.fused_jacobi3_errs(u, f, h, steps, omega, compat)
                wu, we = K3.fused_jacobi3_errs_torch(u, f, h, steps, omega, compat)
                what = f"n={n} {compat} steps={steps}"
                cmp.grid("jacobi3_errs", what, gu, wu)
                for s in range(steps):
                    cmp.scalar("jacobi3_errs", f"{what} iterate {s + 1}", ge[s], we[s])
                cmp.cases["jacobi3_errs"] += 1
            v = u
            for s in range(1, cap + 1):
                v, e = K3.trigger_step3(v, f, h, omega, compat)
                require(torch.equal(ge[s - 1], e),
                        f"jacobi3_errs n={n} {compat}: errs[{s - 1}] differs from the error "
                        f"of the {s}th one-sweep step")

    def mid_trigger(u, f, h, compat, k=30):
        """A trigger that ends the loop near sweep k: the slope the one-sweep
        loop takes there (data-dependent, so some stop lands inside a pass)."""
        v, prev = u, None
        for _ in range(k):
            v, e = K3.trigger_step3(v, f, h, omega, compat)
            slope, prev = (None if prev is None else abs(float(e) - prev)), float(e)
        return slope

    def trigger3(name, n, u, f, h, compat, trig, max_sweeps):
        """A whole-loop trigger kernel against the loop of one-sweep launches,
        which sum the same partials in the same order: the same stop sweep,
        iterate and error, bit for bit; then against the twin run for that
        many sweeps."""
        fn = K3.trigger_smooth3 if name == "trigger3" else K3.trigger_smooth3_stream
        gu, ge, gk = fn(u, f, h, omega, compat, trig, max_sweeps)
        ru, re_, rk = trigger_loop(lambda v: K3.trigger_step3(v, f, h, omega, compat), u, trig,
                                   max_sweeps)
        what = f"n={n} {compat} trigger={trig:.6g} max={max_sweeps}"
        require(int(gk) == rk and bool(torch.equal(gu, ru)) and bool(torch.equal(ge, re_)),
                f"{name} {what}: {int(gk)} sweeps vs {rk} of the one-sweep launches")
        wu, we, _ = K3.trigger_smooth3_torch(u, f, h, omega, compat, 0.0, int(gk))
        cmp.grid(name, f"{what} ({int(gk)} sweeps)", gu, wu)
        cmp.scalar(name, what, ge, we)
        cmp.cases[name] += 1
        return int(gk)

    stops = {}

    def loops(n, u, f, h, caps=(1, 20, 21, 9)):
        """Both trigger kernels, both metrics: a trigger of 0 to each cap (the
        final iterate in either buffer, a short last pass) and a trigger that
        stops mid-loop."""
        for compat in ("clean", "gpu"):
            trig = mid_trigger(u, f, h, compat)
            for name in ("trigger3", "trigger3_stream"):
                for cap in caps:
                    trigger3(name, n, u, f, h, compat, 0.0, cap)
                stops[f"{name} {n}/{compat}"] = trigger3(name, n, u, f, h, compat, trig, 60)

    def residual_mw(n):
        hh = 1.0 / (n - 1)
        w0, w1, w2, ff = rand(n, n, n), rand(n, n, n) * 1e-8, rand(n, n, n) * 1e-16, rand(n, n, n)
        cmp.grid("residual_mw3", f"n={n} tw", K3.residual_tw3(w0, w1, w2, ff, hh),
                 K3.residual_tw3_torch(w0, w1, w2, ff, hh))
        cmp.grid("residual_mw3", f"n={n} df", K3.residual_df3(w0, w1, ff, hh),
                 K3.residual_df3_torch(w0, w1, ff, hh))
        cmp.cases["residual_mw3"] += 2

    saved = K3.FORCE_TILE3
    try:
        for n, tile in small:
            K3.FORCE_TILE3 = tile
            h = 1.0 / (n - 1)
            u, f = rand(n, n, n), rand(n, n, n)
            m = (n + 1) // 2
            uc = rand(m, m, m)
            residual(n, u, f, h)
            for steps in range(1, 9):
                for fz in (False, True):
                    jacobi(n, u, f, h, steps, fz, (None, "clean", "gpu"))
                    for restriction, cap in (("full_weighting", 6), ("sampling", 7)):
                        if steps - fz <= cap:
                            for want_err in (False, True):
                                descend(n, u, f, h, steps, fz, restriction, want_err)
                ascend(n, u, f, uc, h, steps, False)
                if steps <= 7:
                    ascend(n, u, f, uc, h, steps, True)
            errs(n, u, f, h)
            loops(n, rand(n, n, n) * 0.01, f, h)
            residual_mw(n)    # 2^k + 1 grids (65, 129) and one that is not (131)
    finally:
        K3.FORCE_TILE3 = saved
    # the main path's shapes, planned tiles: 3 sweeps, both legs' variants
    for n in legs:
        h = 1.0 / (n - 1)
        u, f = rand(n, n, n), rand(n, n, n)
        m = (n + 1) // 2
        uc = rand(m, m, m)
        for fz, want_err in ((False, False), (False, True), (True, False), (True, True)):
            descend(n, u, f, h, 3, fz, "full_weighting", want_err)
        descend(n, u, f, h, 3, False, "sampling", True)
        ascend(n, u, f, uc, h, 3, False)
        ascend(n, u, f, uc, h, 3, True)
        del u, f, uc
    h = 1.0 / (main - 1)
    u, f = rand(main, main, main), rand(main, main, main)
    jacobi(main, u, f, h, 3, False, (None, "clean", "gpu"))
    jacobi(main, u, f, h, 3, True, ("clean",))
    jacobi(main, u, f, h, 8, False, (None,))
    residual(main, u, f, h)
    errs(main, u, f, h, all_counts=False)
    del u, f
    residual_mw(main)
    # the trigger loops at their main-path sizes, planned tiles (65³: the
    # smallest level kernel 16 takes, where its blocks are fewest)
    for n, name in ((257, "trigger3_stream"), (129, "trigger3"), (65, "trigger3")):
        h = 1.0 / (n - 1)
        u, f = rand(n, n, n) * 0.01, rand(n, n, n)
        b = K3.errs3_sweep_cap("clean") if name == "trigger3_stream" else 1
        for compat in ("clean", "gpu"):
            for cap in (b, 2 * b, 2 * b + 3, 50):
                trigger3(name, n, u, f, h, compat, 0.0, cap)
            stops[f"{name} {n}/{compat}"] = trigger3(name, n, u, f, h, compat,
                                                     mid_trigger(u, f, h, compat), 60)
    say(f"[2] 3-D trigger stop sweeps at a mid-loop trigger (kernel size/metric): {stops}")
    inside = sum(k % 7 != 0 for key, k in stops.items() if "stream" in key and "clean" in key)
    require(inside > 0 and all(k < 60 for k in stops.values()),
            "no streamed 3-D trigger loop stopped inside a pass, or one ran to its cap")
    torch.cuda.synchronize()


def rel_res3(p3, u, f, h):
    """float64 ‖r‖₂ / ‖f‖₂ over the interior."""
    import torch

    r = p3.residual3(u.double(), f.double(), h)[1:-1, 1:-1, 1:-1]
    return float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(f.double()[1:-1, 1:-1, 1:-1]))


def compare_paths(tag, results, torch):
    """Kernel path against plain: iterates after 1 and 4 cycles, float64
    residuals, and no launch on the plain path."""
    k, t = results["auto"], results["torch"]
    for i, what in ((0, "1 cycle"), (1, "4 cycles")):
        got, want = k["u"][i], t["u"][i]
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[D] {tag} iterate after {what}: max|u_kernel − u_plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"{tag}: kernel and plain iterates differ after {what}: "
                f"{diff:.3e} > {U_RTOL:g}·{scale:.3e}")
        rk, rt = k["res"][i], t["res"][i]
        require(abs(rk - rt) <= RES_RTOL * rt, f"{tag}: float64 residuals {rk:.6e} (kernels) "
                f"vs {rt:.6e} (plain) after {what}")
    require(not any(t["counts"].values()), f"{tag}: the plain path launched {t['counts']}")


def phase_3d(tmg, K, torch, run_counts, n=513):
    """Path D: 3-D at full width (513³)."""
    from multigrid_poisson_solver_tpu_torch import cli
    from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3

    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    out = {}

    def run(tag, step, kernels, counts_key=None, profile_it=False):
        """One cold cycle and three warm ones through step(u, warm)."""
        results = {}
        for k in ("auto", "torch") if kernels else ("torch",):
            K.reset_launch_counts()
            u1 = step(k, u0, False)
            u = u1
            for _ in range(3):
                u = step(k, u, True)
            torch.cuda.synchronize()
            counts = dict(K.launches)
            require(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
                    f"{tag} kernels={k}: non-finite or misshapen iterate")
            r1, r4 = rel_res3(p3, u1, f, h), rel_res3(p3, u, f, h)
            ms = time_ms(lambda: step(k, u, True), reps=3 if k == "auto" else 1, rounds=3)
            results[k] = {"u": (u1, u), "res": (r1, r4), "ms": ms, "counts": counts}
            say(f"[D] {tag} kernels={k}: {ms:.3f} ms/cycle, float64 rel. residual "
                f"{r1:.6e} after 1 cycle, {r4:.6e} after 4 (per-cycle ratio "
                f"{(r4 / r1) ** (1 / 3):.4f})")
            if k == "auto":
                say(f"[D] {tag} launches over the kernel path's 4 cycles: {counts}")
                if counts_key:
                    run_counts[counts_key] = counts
                if profile_it:
                    profile(f"{tag} per cycle", lambda: [step(k, u, True) for _ in range(3)],
                            per=3)
        compare_paths(tag, results, torch)
        out[tag] = results

    # 1. the library V-cycle, as in the bench
    run("v_cycle3 513³ V(3,3)",
        lambda k, u, warm: tmg.v_cycle3(u, f, h, n_min=5, pre=3, post=3, omega=0.857,
                                        kernels=k), True, "v_cycle3", profile_it=True)
    # 2. the compiled engine, clean metric (fused legs) and gpu metric (no
    #    fused leg: smoother passes, the residual kernel, 2:1 transfers)
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    for compat, key in ((True, "compiled3"), ("gpu", "compiled3_gpu")):
        ccs = {k: tmg.compile_program3(program, prob, tmg.SolverConfig(
            omega=6.0 / 7.0, compat_error=compat, collect_node_stats=False, kernels=k),
            device="cuda") for k in ("auto", "torch")}
        run(f"compile_program3 513³ V(3,3) compat={compat}",
            lambda k, u, warm: ccs[k](u, f, warm=warm)[0], True, key,
            profile_it=compat is True)
    require(run_counts["compiled3"]["descend3"] > 0 and run_counts["compiled3"]["ascend3"] > 0,
            "the clean compiled3 cycle did not run the fused legs")
    require(run_counts["compiled3_gpu"]["descend3"] == 0
            and run_counts["compiled3_gpu"]["residual3"] > 0,
            "the gpu-metric compiled3 cycle did not take the non-fused legs")

    # 3. the CLI --dim 3 against the JAX CLI's Error
    for name, want in CLI3_ERRORS.items():
        argv = ["1", f"schedules/{name}", "--dim", "3", "--engine", "compiled", "--quiet",
                "--no-output"]
        proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch",
                               *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"CLI --dim 3 failed:\n{proc.stdout}\n{proc.stderr}")
        match = re.search(r"Error = ([0-9.eE+-]+)\nTime Used = (\S+)", proc.stdout)
        require(match is not None, f"CLI --dim 3 printed no error:\n{proc.stdout}")
        err = float(match.group(1))
        rtol = CLI3_RTOL_OF.get(name, CLI3_RTOL)
        say(f"[D] CLI --dim 3 {name}: Error = {match.group(1)} (JAX CLI {want:.6e}, "
            f"rel. diff {abs(err - want) / want:.2e}, bound {rtol:g}), solve {match.group(2)} ms")
        require(abs(err - want) <= rtol * want, f"CLI --dim 3 {name}: Error {err:.6e} "
                f"vs the JAX CLI's {want:.6e}")
        K.reset_launch_counts()
        require(cli.main(argv + ["--device", "cuda"]) == 0, f"in-process CLI --dim 3 {name}")
        run_counts[f"cli3 {name}"] = dict(K.launches)
        say(f"[D] launches over the in-process CLI --dim 3 run on {name}: "
            f"{run_counts[f'cli3 {name}']}")
    return {tag: (r["auto"]["ms"], r["torch"]["ms"]) for tag, r in out.items()}, out


def phase_trigger3(tmg, K, K3, torch, run_counts, n=513):
    """Path E: the 3-D trigger V-cycle at 513³ across all trigger tiers."""
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    prob = tmg.REFERENCE_PROBLEM_3D
    cap = 2000
    out = {}

    def run(tag, batch, kernels="auto", profile_it=False):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=False, collect_node_stats=False,
                               kernels=kernels, trigger_batch=batch, max_trigger_sweeps=cap)
        cc = tmg.compile_program3(program, prob, cfg, device="cuda")
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        require(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all())
                and bool(torch.isfinite(err)), f"3-D trigger V-cycle {tag}: non-finite result")
        require(kernels == "auto" or not any(counts.values()),
                f"3-D trigger V-cycle {tag}: the plain path launched {counts}")
        say(f"[E] trigger V-cycle {n}³ {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}")
        hit = [k for _, k in cc.trigger_sweeps if k >= cap]
        if hit:
            say(f"[E] {tag}: {len(hit)} trigger node(s) reached max_trigger_sweeps={cap}")
        out[tag] = (u, float(err), cc.trigger_sweeps, ms, counts)
        if profile_it:
            cc.trigger_sweeps = None
            profile(f"trigger V-cycle {n}³ {tag}", lambda: cc(u0, f))
        return tag

    main = run("kernels, batch 7", 7, profile_it=True)
    run_counts["trigger3_513"] = out[main][4]
    auto = run("kernels, auto", "auto")
    batch1 = run("kernels, batch 1", 1)
    with twins3_in_place(K3):
        twins = run("twins, batch 7", 7)
        twins_auto = run("twins, auto", "auto")
    plain = run("plain, batch 1", 1, kernels="torch")
    for a, b in ((main, twins), (auto, twins_auto), (batch1, plain)):
        ua, _, sa = out[a][:3]
        ub, _, sb = out[b][:3]
        require(sa == sb, f"3-D trigger V-cycle: stop points {sa} ({a}) vs {sb} ({b})")
        diff, scale = float((ua - ub).abs().max()), float(ub.abs().max())
        say(f"[E] {a} vs {b}: equal stop points, max|Δu| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(ua, ub))})")
        require(diff <= U_RTOL * scale, f"3-D trigger V-cycle iterates differ: {a} vs {b}")
    counts = run_counts["trigger3_513"]
    say(f"[E] launches over the batch-7 kernel run: {counts}; over the auto run: "
        f"{out[auto][4]}; over the batch-1 run: {out[batch1][4]}")
    for k in ("trigger3", "trigger3_stream", "jacobi3_errs"):
        require(counts[k] > 0, f"the 3-D trigger V-cycle did not launch {k}")
    # the first node (513³ going down) starts where the exact run's does: its
    # batched passes overshoot the exact stop sweep by fewer than 7
    (m, k), (_, k1) = out[main][2][0], out[batch1][2][0]
    require(m == n and k % 7 == 0 and k1 <= k < k1 + 7,
            f"batch-7 {m}³: {k} sweeps against {k1} exact")
    return {tag: out[tag][3] for tag in out}, out[main][2], out[auto][2], out[batch1][2]


def phase_refine3(tmg, K, torch, run_counts, cli, n=513, tol=1e-10):
    """Path F: 3-D refinement, tw32 to 1e-10 at 513³, kernels against
    kernels="torch"; then the CLI --dim 3 --tol on Vcycle.txt."""
    results = {}
    for kernels in ("auto", "torch"):
        solver = tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, n, max_cycles=25,
                                          state="tw32", kernels=kernels, device="cuda")
        K.reset_launch_counts()
        ms, rep = wall_ms(lambda: solver.solve(tol))
        counts = dict(K.launches)
        if kernels == "auto":
            run_counts["refine3"] = counts
        require(kernels == "auto" or not any(counts.values()),
                f"the plain 3-D refinement launched {counts}")
        require(bool(torch.isfinite(rep.u).all()) and rep.u.shape == (n, n, n),
                f"refine3 {n}³: non-finite or misshapen result")
        say(f"[F] refine3 {n}³ tw32 to {tol:g} kernels={kernels}: {rep.cycles} cycles, "
            f"rel {rep.rel_residual:.6e}, error {rep.error_vs_analytic:.6e}, wall {ms:.1f} ms "
            f"({ms / max(rep.cycles, 1):.2f} ms/cycle)")
        require(rep.rel_residual <= tol, f"refine3 {n}³ kernels={kernels}: rel "
                f"{rep.rel_residual:.3e} > {tol:g}")
        results[kernels] = rep
        if kernels == "auto":
            profile(f"refine3 {n}³ tw32 per cycle", lambda: solver.solve(tol), per=rep.cycles)
    k, t = results["auto"], results["torch"]
    require(k.cycles == t.cycles, f"refine3 {n}³: {k.cycles} cycles with the kernels, "
            f"{t.cycles} plain")
    for what, got, want in (("u", k.u, t.u), ("u_lo", k.u_lo, t.u_lo)):
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[F] {n}³ tw32 word {what}: max|kernel − plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"refine3 {n}³: {what} differs")
    say(f"[F] launches over the {n}³ tw32 kernel run: {run_counts['refine3']}")
    argv = ["1", "schedules/Vcycle.txt", "--dim", "3", "--tol", "1e-10", "--state", "tw32",
            "--quiet", "--no-output"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    require(proc.returncode == 0, f"CLI --dim 3 --tol failed:\n{proc.stdout}\n{proc.stderr}")
    m = re.search(r"Error = (\S+)\nRelative residual = (\S+) \((\d+) refinement cycles\)\n"
                  r"Time Used = (\S+)", proc.stdout)
    require(m is not None, f"CLI --dim 3 --tol printed no result:\n{proc.stdout}")
    require(math.isfinite(float(m.group(1))) and math.isfinite(float(m.group(2))),
            "CLI --dim 3 --tol: a non-finite result")
    say(f"[F] CLI --dim 3 --tol 1e-10 --state tw32 Vcycle.txt: Error = {m.group(1)}, relative "
        f"residual {m.group(2)} after {m.group(3)} cycles, solve {m.group(4)} ms, process "
        f"{ms:.0f} ms")
    K.reset_launch_counts()
    require(cli.main(argv + ["--device", "cuda"]) == 0, "in-process CLI --dim 3 --tol failed")
    run_counts["cli3_tol"] = dict(K.launches)
    say(f"[F] launches over the in-process CLI --dim 3 --tol run: {run_counts['cli3_tol']}")
    return {kern: (r.cycles, r.wall_time_s * 1e3) for kern, r in results.items()}


@contextlib.contextmanager
def sharded_twins_in_place(K, rdma):
    """Every shard-mode entry point of ops.kernels and both ring kernels of
    ops.rdma replaced by their plain twins (the sharded wrappers look them up
    at each call)."""
    names = ["fused_jacobi_shard", "fused_jacobi_errs_shard", "residual_shard",
             "residual_shards", "fused_descend_shard", "fused_ascend_shard"]
    saved = {name: getattr(K, name) for name in names}
    saved_ring = (rdma.rdma_jacobi, rdma.rdma_trigger)
    for name in names:
        setattr(K, name, getattr(K, name + "_torch"))
    rdma.rdma_jacobi, rdma.rdma_trigger = rdma.rdma_jacobi_torch, rdma.rdma_trigger_torch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)
        rdma.rdma_jacobi, rdma.rdma_trigger = saved_ring


def ring_policies(threshold=16):
    """Rings of 2, 3, 4 and 8 shards and a 2 × 4 block mesh, every shard on
    cuda:0."""
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    pols = {f"rows-{p}": M.ShardingPolicy(M.make_mesh(["cuda:0"] * p), threshold_rows=threshold)
            for p in (2, 3, 4, 8)}
    pols["block-2x4"] = M.BlockShardingPolicy(M.make_mesh_2d((2, 4), ["cuda:0"] * 8),
                                              threshold_rows=threshold)
    return pols


@contextlib.contextmanager
def sharded3_twins_in_place(K3):
    """Every 3-D shard-mode entry point of ops.kernels3, and the whole-grid
    emit_residual one, replaced by its plain twin (parallel.kernel_shard3
    looks them up at each call)."""
    names = ["fused_jacobi3_shard", "fused_jacobi3_errs_shard", "fused_jacobi3_residual_shard",
             "fused_descend3_shard", "fused_ascend3_shard", "residual3_shard",
             "fused_jacobi3_residual", "trigger_pass3_shard"]
    saved = {name: getattr(K3, name) for name in names}
    for name in names:
        setattr(K3, name, getattr(K3, name + "_torch"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K3, name, fn)


def z_policy(shards, threshold=8):
    """A ring of ``shards`` z-shards, every one on cuda:0."""
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    return M.ZShardingPolicy3(M.make_mesh_z(["cuda:0"] * shards), threshold_planes=threshold)


def phase_h1(K3, torch, cmp, sizes=((65, (6, 10, 6)), (129, (8, 16, 10))), rings=(2, 3, 4, 8)):
    """H1: the 3-D shard modes (kernel 10 in every mode, its emit_residual
    mode, kernels 11-13) against their twins, bit for bit, and their owned
    planes against the unsharded kernels', at 65³ and 129³ with tiles forced
    small (several tiles per dimension, several z blocks per shard), on
    rings of 2, 3, 4 and 8 z-shards (ragged last shards), from_zero at the
    cut planes; each per-sweep error against the error of the one-sweep
    sharded steps, bit for bit; emit_residual's clean error per shard
    against kernel 10's shard-mode clean error of the same sweeps, bit for
    bit, and on the whole grid against its twin."""
    from multigrid_poisson_solver_tpu_torch.parallel import halo3
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8765)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 6.0 / 7.0
    G = S.gather

    def twin(fn, *args, **kw):
        with sharded3_twins_in_place(K3):
            return fn(*args, **kw)

    def same(what, got, want):
        require(bool(torch.equal(got, want)), f"{what}: owned planes differ from the unsharded "
                f"kernel (max|Δ| {float((got - want).abs().max()):.3e})")

    def lagged(w, us, fs, h, compat, nl, count=3):
        """The lagged one-sweep pass (the route of a sharded clean trigger
        node): its iterate and its error of the iterate it reads against its
        twin and against the one-sweep step, bit for bit."""
        v, prev = us, None
        for s in range(count):
            gv, ge = KS3.sharded_trigger_pass3(v, fs, h, omega, compat)
            tv, te = twin(KS3.sharded_trigger_pass3, v, fs, h, omega, compat)
            sv, se = KS3.sharded_trigger_step3(v, fs, h, omega, compat, nl)
            cmp.grid("jacobi3_shard", f"{w} lagged pass {s}", G(gv), G(tv))
            cmp.scalar("jacobi3_shard", f"{w} lagged pass {s}", ge, te)
            cmp.cases["jacobi3_shard"] += 1
            same(f"jacobi3_shard {w} lagged pass {s}", G(gv), G(sv))
            # clean: the error of v, the previous step's; gpu: of the result
            want = se if compat == "gpu" else prev
            if want is not None:
                require(bool(torch.equal(ge, want)), f"jacobi3_shard {w}: the lagged pass {s} "
                        f"measured {float(ge):.9e}, the one-sweep step {float(want):.9e}")
            v, prev = sv, se

    def sweeps(u, f, h, steps, fz):
        """The unsharded kernel's passes of at most 8 sweeps."""
        first = True
        while steps > 0:
            k = min(steps, K3.MAX_FUSED_SWEEPS_3D)
            u = K3.fused_jacobi3(u, f, h, k, omega, fz and first)
            steps -= k
            first = False
        return u

    saved = K3.FORCE_TILE3
    try:
        for n, tile in sizes:
            K3.FORCE_TILE3 = tile
            h = 1.0 / (n - 1)
            u, f = rand(n, n, n), rand(n, n, n)
            m = (n + 1) // 2
            uc = rand(m, m, m)
            for p in rings:
                pol = z_policy(p)
                nl = pol.planes_per_device(n)
                lay = S.layout_of(pol, n)
                us, fs = S.shard(u, lay), S.shard(f, lay)
                what = f"n={n} {p} z-shards {lay.rows}"
                for steps in (*range(1, 9), 11):
                    for fz in (False, True):
                        w = f"{what} steps={steps} fz={fz}"
                        got = G(KS3.sharded_fused_jacobi3(us, fs, h, steps, omega, fz, nl))
                        cmp.grid("jacobi3_shard", w, got, G(twin(
                            KS3.sharded_fused_jacobi3, us, fs, h, steps, omega, fz, nl)))
                        cmp.cases["jacobi3_shard"] += 1
                        same(f"jacobi3_shard {w}", got, sweeps(u, f, h, steps, fz))
                for compat in ("clean", "gpu"):
                    for steps, fz in ((k, z) for k in range(1, 9) for z in (False, True)):
                        w = f"{what} steps={steps} fz={fz} err={compat}"
                        gu, ge = KS3.sharded_fused_jacobi3_err(us, fs, h, steps, omega, compat,
                                                               fz, nl)
                        wu, we = twin(KS3.sharded_fused_jacobi3_err, us, fs, h, steps, omega,
                                      compat, fz, nl)
                        cmp.grid("jacobi3_shard", w, G(gu), G(wu))
                        cmp.scalar("jacobi3_shard", w, ge, we)
                        cmp.cases["jacobi3_shard"] += 1
                        same(f"jacobi3_shard {w}", G(gu), sweeps(u, f, h, steps, fz))
                        if not (compat == "clean" and steps - fz > 7):
                            ke = K3.fused_jacobi3_err(u, f, h, steps, omega, compat, fz)[1]
                            cmp.scalar("jacobi3_shard", f"{w} against the unsharded kernel", ge,
                                       ke)
                    cap = K3.errs3_sweep_cap(compat)
                    gu, ge = KS3.sharded_fused_jacobi3_errs(us, fs, h, cap, omega, compat, nl)
                    wu, we = twin(KS3.sharded_fused_jacobi3_errs, us, fs, h, cap, omega, compat,
                                  nl)
                    w = f"{what} per-sweep err={compat}"
                    cmp.grid("jacobi3_errs_shard", w, G(gu), G(wu))
                    ku, ke = K3.fused_jacobi3_errs(u, f, h, cap, omega, compat)
                    for s in range(cap):
                        cmp.scalar("jacobi3_errs_shard", f"{w} iterate {s + 1}", ge[s], we[s])
                        cmp.scalar("jacobi3_errs_shard", f"{w} iterate {s + 1} against the "
                                   f"unsharded kernel", ge[s], ke[s])
                    cmp.cases["jacobi3_errs_shard"] += 1
                    same(f"jacobi3_errs_shard {w}", G(gu), ku)
                    v = us
                    for s in range(1, cap + 1):
                        v, e = KS3.sharded_trigger_step3(v, fs, h, omega, compat, nl)
                        require(bool(torch.equal(ge[s - 1], e)),
                                f"jacobi3_errs_shard {w}: errs[{s - 1}] differs from the error "
                                f"of the {s}th one-sweep sharded step")
                    lagged(w, us, fs, h, compat, nl)
                for steps, fz, negate in ((3, False, True), (3, True, True), (1, True, False),
                                          (7, False, False)):
                    w = f"{what} emit_residual steps={steps} fz={fz} negate={negate}"
                    gu, gr = KS3.sharded_smooth_residual3(us, fs, h, steps, omega, fz, negate, nl)
                    wu, wr = twin(KS3.sharded_smooth_residual3, us, fs, h, steps, omega, fz,
                                  negate, nl)
                    cmp.grid("jacobi3_residual", w + " u", G(gu), G(wu))
                    cmp.grid("jacobi3_residual", w + " r", G(gr), G(wr))
                    cmp.cases["jacobi3_residual"] += 1
                    ku, kr = K3.fused_jacobi3_residual(u, f, h, steps, omega, fz, negate)
                    same(f"jacobi3_residual {w} u", G(gu), ku)
                    same(f"jacobi3_residual {w} r", G(gr), kr)
                    same(f"jacobi3_residual {w}: the whole-grid mode against the pair", kr,
                         K3.residual3(sweeps(u, f, h, steps, fz), f, h, negate))
                    # the clean error: per shard the raw Σ|r| of kernel 10's
                    # shard mode with the clean error for the same sweeps, bit
                    # for bit (one tile plan, the same |r| in the same order)
                    ext = steps - fz + 1
                    for i in range(len(lay.rows)):
                        ue, fe = S.extend(us, i, 0, ext), S.extend(fs, i, 0, ext)
                        args = (fe, halo3.geo3(fs, i, ext), h, steps, omega, fz)
                        su, sr, sraw = K3.fused_jacobi3_residual_shard(
                            None if fz else ue, *args, negate, "clean")
                        tu, tr, traw = K3.fused_jacobi3_residual_shard_torch(ue, *args, negate,
                                                                             "clean")
                        cu, craw = K3.fused_jacobi3_shard(None if fz else ue, *args, "clean")
                        wc = f"{w} shard {i} clean error"
                        cmp.grid("jacobi3_residual", wc + " u", su, tu)
                        cmp.grid("jacobi3_residual", wc + " r", sr, tr)
                        cmp.scalar("jacobi3_residual", wc, sraw, traw)
                        cmp.cases["jacobi3_residual"] += 1
                        same(f"jacobi3_residual {wc} u", su, cu)
                        require(bool(torch.equal(sraw, craw)), f"jacobi3_residual {wc}: raw "
                                f"{float(sraw)!r} differs from kernel 10's shard-mode clean raw "
                                f"{float(craw)!r}")
                    # the whole grid with the clean error: the same u and r
                    ku, kr, kraw = K3.fused_jacobi3_residual(u, f, h, steps, omega, fz, negate,
                                                             "clean")
                    wraw = K3.fused_jacobi3_residual_torch(u, f, h, steps, omega, fz, negate,
                                                           "clean")[2]
                    cmp.scalar("jacobi3_residual", f"{w} whole grid clean error", kraw, wraw)
                    cmp.cases["jacobi3_residual"] += 1
                    same(f"jacobi3_residual {w} whole grid with the clean error u", G(gu), ku)
                    same(f"jacobi3_residual {w} whole grid with the clean error r", G(gr), kr)
                for negate in (False, True):
                    w = f"{what} negate={negate}"
                    got = G(KS3.sharded_residual3(us, fs, h, negate))
                    cmp.grid("residual3_shard", w, got, G(twin(KS3.sharded_residual3, us, fs, h,
                                                               negate)))
                    cmp.cases["residual3_shard"] += 1
                    same(f"residual3_shard {w}", got, K3.residual3(u, f, h, negate))
                for restriction in ("full_weighting", "sampling"):
                    for fz in (False, True):
                        for steps in (1, 3, 6):
                            w = f"{what} steps={steps} fz={fz} {restriction}"
                            args = (h, steps, omega, fz, restriction, True, nl)
                            gu, gfc, ge = KS3.sharded_fused_descend3(us, fs, *args)
                            wu, wfc, we = twin(KS3.sharded_fused_descend3, us, fs, *args)
                            cmp.grid("descend3_shard", w + " u", G(gu), G(wu))
                            cmp.grid("descend3_shard", w + " f_coarse", G(gfc), G(wfc))
                            cmp.scalar("descend3_shard", w, ge, we)
                            cmp.cases["descend3_shard"] += 1
                            ku, kfc, ke = K3.fused_descend3(u, f, h, steps, omega, fz,
                                                            restriction, True)
                            same(f"descend3_shard {w}", G(gu), ku)
                            same(f"descend3_shard {w} f_coarse", G(gfc), kfc)
                            cmp.scalar("descend3_shard", f"{w} against the unsharded kernel",
                                       ge, ke)
                child = S.as_level(uc, pol, m)
                for steps, want_err in ((1, False), (3, False), (3, True), (7, True), (8, False)):
                    ext_z, ext_c = KS3.ascend3_halo(steps, want_err)
                    if ext_z > nl or ext_c + 1 > nl // 2:
                        continue
                    w = f"{what} steps={steps} err={want_err}"
                    gu, ge = KS3.sharded_fused_ascend3(us, fs, child, h, steps, omega, want_err,
                                                       nl)
                    wu, we = twin(KS3.sharded_fused_ascend3, us, fs, child, h, steps, omega,
                                  want_err, nl)
                    cmp.grid("ascend3_shard", w, G(gu), G(wu))
                    ku, ke = K3.fused_ascend3(u, f, uc, h, steps, omega, want_err)
                    if want_err:
                        cmp.scalar("ascend3_shard", w, ge, we)
                        cmp.scalar("ascend3_shard", f"{w} against the unsharded kernel", ge, ke)
                    cmp.cases["ascend3_shard"] += 1
                    same(f"ascend3_shard {w}", G(gu), ku)
            del u, f, uc
            torch.cuda.synchronize()
    finally:
        K3.FORCE_TILE3 = saved
    # H3's exact loops at their sizes with the planned tiles: the one-sweep
    # step and the lagged pass at 129³ and 65³ on 8 z-shards
    for n in (129, 65):
        h = 1.0 / (n - 1)
        pol = z_policy(8)
        lay = S.layout_of(pol, n)
        us, fs = S.shard(rand(n, n, n) * 0.01, lay), S.shard(rand(n, n, n), lay)
        for compat in ("clean", "gpu"):
            w = f"n={n} 8 z-shards {lay.rows} planned tiles {compat}"
            gu, ge = KS3.sharded_trigger_step3(us, fs, h, omega, compat)
            wu, we = twin(KS3.sharded_trigger_step3, us, fs, h, omega, compat)
            cmp.grid("jacobi3_shard", f"{w} one-sweep step", G(gu), G(wu))
            cmp.scalar("jacobi3_shard", f"{w} one-sweep step", ge, we)
            cmp.cases["jacobi3_shard"] += 1
            lagged(w, us, fs, h, compat, pol.planes_per_device(n), count=4)


H_V_CYCLE = "v_cycle3 513³ V(3,3)"
H_COMPILED = {"clean": "compile_program3 513³ V(3,3) compat=True",
              "gpu": "compile_program3 513³ V(3,3) compat=gpu"}


def phase_h2(tmg, K, K3, torch, run_counts, unsharded, n=513):
    """H2: 513³ on 8 z-shards of cuda:0 (threshold 8): v_cycle3_sharded V(3,3)
    and compile_program3(policy=...) V(3,3) with the clean and gpu metrics,
    on the kernels, through the twins and on the plain path, one cold and
    three warm cycles each, against phase D's unsharded runs (``unsharded``:
    its iterates after 1 and 4 cycles); launch counts per route; ms/cycle and
    a profile."""
    from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    pol = z_policy(8)
    mesh = pol.mesh
    fs = S.as_level(f, pol, n)
    times = {}

    def run(tag, step, key):
        """One cold cycle and three warm ones through step(kind, u, warm) on
        the kernels, the twins and the plain path."""
        res = {}
        for kind in ("kernels", "twins", "plain"):
            with contextlib.ExitStack() as stack:
                if kind == "twins":
                    stack.enter_context(twins3_in_place(K3))
                    stack.enter_context(sharded3_twins_in_place(K3))
                K.reset_launch_counts()
                u1 = step(kind, u0, False)
                u = u1
                for _ in range(3):
                    u = step(kind, u, True)
                torch.cuda.synchronize()
                counts = dict(K.launches)
                g1, g4 = S.gather(u1), S.gather(u)
                require(tuple(g4.shape) == (n, n, n) and bool(torch.isfinite(g4).all()),
                        f"[H2] {tag} {kind}: non-finite or misshapen iterate")
                ms = time_ms(lambda: step(kind, u, True), reps=1 if kind == "plain" else 3,
                             rounds=3)
            res[kind] = (g1, g4, counts, ms)
            times[f"{tag} {kind}"] = ms
            say(f"[H2] {tag} on 8 z-shards {kind}: {ms:.3f} ms/cycle (unsharded kernels "
                f"{unsharded[tag]['auto']['ms']:.3f}); launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if kind == "kernels":
                run_counts[key] = counts
                rows = profile(f"{tag} on 8 z-shards per cycle",
                               lambda: [step(kind, u, True) for _ in range(3)], per=3)
                ms13, k13 = kernel_ms(rows, lambda key: key.startswith("residual3_kernel"),
                                      per=3)
                say(f"[p]     kernel 13 (residual3): {ms13:.3f} ms device a cycle, {k13:.0f} "
                    f"launches")
                # kernel 10's emit_residual mode: its sweeps and its residual
                # pass launch kernels of their own names (csrc/jacobi3.cu)
                ms10r, k10r = kernel_ms(rows, lambda key: "jacobi3_residual_" in key, per=3)
                say(f"[p]     kernel 10 emit_residual (jacobi3_residual_* passes): "
                    f"{ms10r:.3f} ms device a cycle, {k10r:.0f} launches")
        ref = unsharded[tag]
        for i, what in ((0, "1 cycle"), (1, "4 cycles")):
            got, want = res["kernels"][i], ref["auto"]["u"][i]
            require(bool(torch.equal(got, want)), f"[H2] {tag}: the sharded kernel iterate after "
                    f"{what} differs from phase D's unsharded one (max|Δ| "
                    f"{float((got - want).abs().max()):.3e})")
            for kind, base in (("twins", ref["auto"]["u"][i]), ("plain", ref["torch"]["u"][i])):
                g = res[kind][i]
                diff, scale = float((g - base).abs().max()), float(base.abs().max())
                say(f"[H2] {tag} {kind} after {what}: max|Δu| {diff:.3e} against phase D's "
                    f"{'kernel' if kind == 'twins' else 'plain'} run (bit-identical: "
                    f"{bool(torch.equal(g, base))})")
                require(diff <= U_RTOL * scale, f"[H2] {tag} {kind}: outside the phase D gate "
                        f"after {what}")
            rk = rel_res3(p3, res["kernels"][i], f, h)
            rt = rel_res3(p3, res["plain"][i], f, h)
            require(abs(rk - rt) <= RES_RTOL * rt, f"[H2] {tag}: float64 residuals {rk:.6e} "
                    f"(kernels) vs {rt:.6e} (plain) after {what}")
        say(f"[H2] {tag}: sharded kernel iterates bit-identical to phase D's unsharded run after "
            f"1 and 4 cycles")
        require(not any(res["plain"][2].values()), f"[H2] {tag}: the plain path launched a kernel")
        return res

    def vstep(kind, u, warm):
        return tmg.v_cycle3_sharded(u, fs, h, mesh, n_min=5, pre=3, post=3, omega=0.857,
                                    kernels="torch" if kind == "plain" else "auto")

    run(H_V_CYCLE, vstep, "h_v_cycle3")
    # trouble spot 1's routes: JAX's depths 528, 264, 136, 72 (nl 66, 33, 17,
    # 9): the legs per shard at 513³, emit_residual and prolong-add + the
    # shard smoother at 257³, 129³ and 65³; per cycle and shard
    c = run_counts["h_v_cycle3"]
    want = {"descend3_shard": 1, "ascend3_shard": 1, "jacobi3_residual": 3, "jacobi3_shard": 3}
    require(all(c[k] == 4 * 8 * v for k, v in want.items()) and not c["descend3"],
            f"[H2] v_cycle3_sharded took other routes than JAX's: {c}")
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    for compat, key in (("clean", "h_compiled3"), ("gpu", "h_compiled3_gpu")):
        cfgs = {kind: tmg.SolverConfig(omega=6.0 / 7.0, compat_error=True if compat == "clean"
                                       else "gpu", collect_node_stats=False,
                                       kernels="torch" if kind == "plain" else "auto")
                for kind in ("kernels", "plain")}
        ccs = {kind: tmg.compile_program3(program, prob, cfgs[kind], device="cuda", policy=pol)
               for kind in cfgs}
        ccs["twins"] = ccs["kernels"]
        res = run(H_COMPILED[compat], lambda kind, u, warm: ccs[kind](u, fs, warm=warm)[0], key)
        # the error of the last node against the unsharded engine's, on the
        # same iterate
        cc1 = tmg.compile_program3(program, prob, cfgs["kernels"], device="cuda", warm=True)
        _, e1 = cc1(res["kernels"][1], f)
        _, es = ccs["kernels"](res["kernels"][1], fs, warm=True)
        say(f"[H2] {H_COMPILED[compat]}: last error sharded {float(es):.9e}, unsharded "
            f"{float(e1):.9e}")
        require(abs(float(es) - float(e1)) <= 1e-6 * abs(float(e1)),
                f"[H2] {H_COMPILED[compat]}: errors differ beyond 1e-6 relative")
    c, g = run_counts["h_compiled3"], run_counts["h_compiled3_gpu"]
    # the policy's depths are all even (528, 272, 144, 80): the legs per shard
    # at every sharded level with the clean metric; smoother passes and the
    # sharded residual with the gpu metric
    require(c["descend3_shard"] == c["ascend3_shard"] == 4 * 4 * 8 and not c["descend3"]
            and g["jacobi3_shard"] == 4 * 8 * 8 and g["residual3_shard"] == 4 * 4 * 8
            and not g["descend3_shard"], f"[H2] compile_program3 under the policy took other "
            f"routes than JAX's: clean {c}, gpu {g}")
    return times


def phase_h3(tmg, K, K3, torch, run_counts, unsharded_levels, n=513):
    """H3: the 513³ trigger V-cycle (ω 6/7, clean, trigger 0.01) on 8
    z-shards of cuda:0 with trigger_batch "auto", 1 and 7, on the kernels and
    (batch 7) the twins; stop sweeps per level against phase E's unsharded
    runs (``unsharded_levels``: batch tag → levels). Returns the wall ms and
    the (iterate, stop sweeps) of each run."""
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    prob = tmg.REFERENCE_PROBLEM_3D
    pol = z_policy(8)
    cap = 2000
    out = {}

    def run(tag, batch, twins=False):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=False, collect_node_stats=False,
                               trigger_batch=batch, max_trigger_sweeps=cap)
        cc = tmg.compile_program3(program, prob, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twins:
                stack.enter_context(twins3_in_place(K3))
                stack.enter_context(sharded3_twins_in_place(K3))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[H3] sharded 3-D trigger V-cycle {tag}: non-finite result")
        say(f"[H3] trigger V-cycle {n}³ on 8 z-shards {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, ms, counts)
        return tag

    auto = run("kernels, auto", "auto")
    b1 = run("kernels, batch 1", 1)
    b7 = run("kernels, batch 7", 7)
    tb7 = run("twins, batch 7", 7, twins=True)
    run_counts["h_trigger3_b7"] = out[b7][3]
    for tag, phase_e in ((auto, "auto"), (b1, "batch 1")):
        want = unsharded_levels[phase_e]
        require(out[tag][1] == want, f"[H3] stop sweeps {out[tag][1]} ({tag}) vs phase E's "
                f"unsharded {phase_e} run {want}")
    require(out[b7][1] == out[tb7][1], f"[H3] batch 7: stop sweeps {out[b7][1]} on the kernels "
            f"vs {out[tb7][1]} through the twins")
    diff = float((out[b7][0] - out[tb7][0]).abs().max())
    require(diff <= U_RTOL * float(out[tb7][0].abs().max()), "[H3] batch 7: kernel and twin "
            "iterates differ")
    # JAX's sharded explicit batch runs one exact sweep, then passes of 7 from
    # its error (its unsharded one starts batched): the first node stops 1 +
    # 7j sweeps in, within the 7 sweeps after the exact stop
    (m, k), (_, k1) = out[b7][1][0], unsharded_levels["batch 1"][0]
    require(m == n and k % 7 == 1 and k1 <= k < k1 + 7,
            f"[H3] batch 7 at {m}³: {k} sweeps against {k1} exact")
    require(out[b7][3]["jacobi3_errs_shard"] > 0 and out[auto][3]["jacobi3_shard"] > 0,
            "[H3] the sharded trigger loops did not launch the shard modes")
    say(f"[H3] stop sweeps per level equal phase E's unsharded auto and batch-1 runs; batch 7 "
        f"kernels = twins, first node {k} sweeps (exact {k1})")
    return {tag: v[2] for tag, v in out.items()}, {tag: v[:2] for tag, v in out.items()}


@contextlib.contextmanager
def ring3_twins_in_place(R3):
    """The whole-loop ring kernel 19 replaced by its twin, the loop of
    one-sweep sharded error passes (parallel.kernel_shard3 looks it up at
    each call)."""
    saved = R3.rdma_trigger3
    R3.rdma_trigger3 = R3.rdma_trigger3_torch
    try:
        yield
    finally:
        R3.rdma_trigger3 = saved


def phase_i1(K3, torch, cmp, sizes=((65, (6, 10, 6), (2, 3, 4, 8, 16)),
                                    (129, (8, 16, 10), (2, 3, 4, 8)))):
    """I1: the 3-D ring kernels 19-22 against their twins (the exchange path
    on the shard-mode twins) and against the PR 6 shard-mode path on the
    card (parallel.kernel_shard3's exchange and kernels 10-12 per shard), at
    65³ and 129³ with tiles forced small (several tiles and z chunks cross
    each cut), on rings of 2, 3, 4, 8 and (65³) 16 z-shards of cuda:0
    (ragged last shards; on 16 shards of 4 planes a window of up to 8 planes
    spans two neighbours' blocks). Owned planes, coarse slabs and errors bit
    for bit against the shard-mode path, and kernels 20, 21 and 22's raw
    float64 sums per shard against the shard modes' (the same tile plans); against
    the twins the iterates bit for bit and the errors within ERR_RTOL;
    kernel 19's stop sweep against
    the loop of one-sweep sharded error launches, with a trigger that stops
    it after at least 50 sweeps."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
    from multigrid_poisson_solver_tpu_torch.parallel import halo3
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9876)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega, G = 6.0 / 7.0, S.gather
    nl = 16   # the shard-mode path's planes per device: one pass, every halo fits

    def same(what, got, want):
        require(bool(torch.equal(got, want)), f"{what}: differs from the shard-mode path "
                f"(max|Δ| {float((got - want).abs().max()):.3e})")

    def errs(name, what, got_raws, twin_raws, want, compat, n, h, lay):
        got = halo3.sum_err3(got_raws, compat, n, h, torch.float32, lay)
        same(f"{name} {what} error", got, want)
        cmp.scalar(name, what, got, halo3.sum_err3(twin_raws, compat, n, h, torch.float32, lay))

    def raws(name, what, got_raws, shard_raws):
        """A ring kernel's raw float64 sums per shard against the shard
        modes' (the same tile plans), bit for bit."""
        got, want = torch.stack(got_raws), torch.stack(shard_raws)
        require(bool(torch.equal(got, want)), f"{name} {what}: raw float64 sums {got.tolist()} "
                f"differ from the shard modes' {want.tolist()}")

    def shard_jacobi_raws(us, fs, h, steps, fz, mode):
        """Kernel 10's shard mode on each shard's windows (the exchange
        path's halo): its raw sums."""
        ext = steps - int(fz) + int(mode == "clean")
        return [K3.fused_jacobi3_shard(None if fz else S.extend(us, i, 0, ext),
                                       S.extend(fs, i, 0, ext), halo3.geo3(fs, i, ext), h, steps,
                                       omega, fz, mode)[1]
                for i in range(len(fs.layout.rows))]

    def shard_descend_raws(us, fs, h, steps, fz, restriction):
        """Kernel 11's shard mode on each shard's window (the exchange
        path's halo): its raw clean sums."""
        ext = steps - int(fz) + 1 + int(restriction == "full_weighting")
        return [K3.fused_descend3_shard(None if fz else S.extend(us, i, 0, ext),
                                        S.extend(fs, i, 0, ext), halo3.geo3(fs, i, ext), h,
                                        steps, omega, fz, restriction, True)[2]
                for i in range(len(fs.layout.rows))]

    def shard_ascend_raws(us, fs, child, h, steps):
        """Kernel 12's shard mode with the clean error on each shard's
        windows: its raw sums."""
        ext, ext_c = steps + 1, (steps + 2) // 2
        out = []
        for i, (z0, z1) in enumerate(fs.layout.rows):
            cz0 = z0 // 2 - ext_c
            c_win = S.planes(child, cz0, (z1 + 1) // 2 + ext_c + 1, "cuda:0")
            out.append(K3.fused_ascend3_shard(S.extend(us, i, 0, ext), S.extend(fs, i, 0, ext),
                                              c_win, cz0, halo3.geo3(fs, i, ext), h, steps,
                                              omega, True)[1])
        return out

    saved = K3.FORCE_TILE3
    try:
        for n, tile, rings in sizes:
            K3.FORCE_TILE3 = tile
            h, m = 1.0 / (n - 1), (n + 1) // 2
            u, f, uc = rand(n, n, n), rand(n, n, n), rand(m, m, m)
            for p in rings:
                lay = S.z_layout(n, ["cuda:0"] * p)
                us, fs = S.shard(u, lay), S.shard(f, lay)
                what = f"n={n} {p} z-shards {lay.rows}"
                for steps in (1, 3, 7, 8):
                    for fz in (False, True):
                        for mode in (None, "clean", "gpu"):
                            if mode == "clean" and steps - fz > 7:
                                continue
                            w = f"{what} steps={steps} fz={fz} err={mode}"
                            gu, graw = R3.rdma_jacobi3(us, fs, h, steps, omega, fz, mode)
                            tu, traw = R3.rdma_jacobi3_torch(us, fs, h, steps, omega, fz, mode)
                            cmp.grid("rdma_jacobi3", w, G(gu), G(tu))
                            if mode is None:
                                ref = KS3.sharded_fused_jacobi3(us, fs, h, steps, omega, fz, nl)
                            else:
                                ref, rerr = KS3.sharded_fused_jacobi3_err(us, fs, h, steps, omega,
                                                                          mode, fz, nl)
                                errs("rdma_jacobi3", w, graw, traw, rerr, mode, n, h, lay)
                                raws("rdma_jacobi3", w, graw,
                                     shard_jacobi_raws(us, fs, h, steps, fz, mode))
                            same(f"rdma_jacobi3 {w}", G(gu), G(ref))
                            cmp.cases["rdma_jacobi3"] += 1
                for restriction in ("full_weighting", "sampling"):
                    for fz in (False, True):
                        for steps in (1, 3, 6):
                            w = f"{what} steps={steps} fz={fz} {restriction}"
                            args = (h, steps, omega, fz, restriction, True)
                            gu, gfc, graw = R3.rdma_descend3(us, fs, *args)
                            tu, tfc, traw = R3.rdma_descend3_torch(us, fs, *args)
                            ru, rfc, rerr = KS3.sharded_fused_descend3(us, fs, *args, nl)
                            cmp.grid("rdma_descend3", w + " u", G(gu), G(tu))
                            cmp.grid("rdma_descend3", w + " f_coarse", G(gfc), G(tfc))
                            same(f"rdma_descend3 {w} u", G(gu), G(ru))
                            same(f"rdma_descend3 {w} f_coarse", G(gfc), G(rfc))
                            errs("rdma_descend3", w, graw, traw, rerr, "clean", n, h, lay)
                            raws("rdma_descend3", w, graw,
                                 shard_descend_raws(us, fs, h, steps, fz, restriction))
                            cmp.cases["rdma_descend3"] += 1
                children = {"tensor": uc, "coarse blocks": S.shard(uc, R3.coarse_layout3(fs)),
                            "m split": S.shard(uc, S.z_layout(m, ["cuda:0"] * p))}
                for steps, want_err in ((1, False), (3, False), (3, True), (7, True), (8, False)):
                    for cname, child in children.items():
                        w = f"{what} steps={steps} err={want_err} child={cname}"
                        gu, graw = R3.rdma_ascend3(us, fs, child, h, steps, omega, want_err)
                        tu, traw = R3.rdma_ascend3_torch(us, fs, child, h, steps, omega, want_err)
                        ru, rerr = KS3.sharded_fused_ascend3(us, fs, child, h, steps, omega,
                                                             want_err, nl)
                        cmp.grid("rdma_ascend3", w, G(gu), G(tu))
                        same(f"rdma_ascend3 {w}", G(gu), G(ru))
                        if want_err:
                            errs("rdma_ascend3", w, graw, traw, rerr, "clean", n, h, lay)
                            raws("rdma_ascend3", w, graw,
                                 shard_ascend_raws(us, fs, child, h, steps))
                        cmp.cases["rdma_ascend3"] += 1
                for compat in ("clean", "gpu"):
                    # a trigger at the 55th sweep's slope of the one-sweep loop
                    v, prev, slopes = us, None, []
                    for _ in range(55):
                        v, e = KS3.sharded_trigger_step3(v, fs, h, omega, compat, nl)
                        if prev is not None:
                            slopes.append(float(torch.abs(e - prev)))
                        prev = e
                    trig = slopes[-1]
                    w = f"{what} {compat} trigger {trig:.6e}"
                    ru, rerr, rk = trigger_loop(
                        lambda x: KS3.sharded_trigger_step3(x, fs, h, omega, compat, nl), us, trig,
                        200)
                    gu, gerr, gk = R3.rdma_trigger3(us, fs, h, omega, compat, trig, 200)
                    tu, terr, tk = R3.rdma_trigger3_torch(us, fs, h, omega, compat, trig, 200)
                    require(rk >= 50 and int(gk) == rk == int(tk),
                            f"rdma_trigger3 {w}: {int(gk)} sweeps, the one-sweep loop {rk}, the "
                            f"twin {int(tk)} (at least 50 wanted)")
                    same(f"rdma_trigger3 {w}", G(gu), G(ru))
                    same(f"rdma_trigger3 {w} error", gerr, rerr)
                    cmp.grid("rdma_trigger3", w, G(gu), G(tu))
                    cmp.scalar("rdma_trigger3", w, gerr, terr)
                    cmp.cases["rdma_trigger3"] += 1
                del us, fs, children
            del u, f, uc
            torch.cuda.synchronize()
    finally:
        K3.FORCE_TILE3 = saved


I_COUNTS = ("rdma_jacobi3", "rdma_descend3", "rdma_ascend3", "rdma_trigger3", "jacobi3_shard",
            "descend3_shard", "ascend3_shard", "jacobi3_residual", "residual3_shard",
            "jacobi3_errs_shard")


def phase_i2(tmg, K, torch, run_counts, unsharded, n=513):
    """I2: phase H2's programs with halo="rdma" (513³ on 8 z-shards of cuda:0,
    threshold 8): v_cycle3_sharded V(3,3) and compile_program3(policy=...)
    V(3,3) with the clean and gpu metrics, one cold and three warm cycles,
    the iterates after 1 and 4 cycles bit for bit against phase D's
    unsharded runs (``unsharded``), which H2 holds the ppermute runs to
    bit for bit; ring launches per cycle by kernel, ms/cycle and a profile."""
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    pol = z_policy(8)
    fs = S.as_level(f, pol, n)
    times, cycles = {}, 4

    def run(tag, step, key):
        K.reset_launch_counts()
        u1 = step(u0, False)
        u = u1
        for _ in range(cycles - 1):
            u = step(u, True)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        run_counts[key] = counts
        for i, (got, what) in enumerate(((S.gather(u1), "1 cycle"), (S.gather(u), "4 cycles"))):
            want = unsharded[tag]["auto"]["u"][i]
            require(bool(torch.equal(got, want)), f"[I2] {tag} rdma: the iterate after {what} "
                    f"differs from phase D's unsharded one, which H2's ppermute run equals "
                    f"(max|Δ| {float((got - want).abs().max()):.3e})")
        ms = time_ms(lambda: step(u, True), reps=3, rounds=3)
        times[tag] = ms
        per = {k: counts[k] / cycles for k in I_COUNTS if counts[k]}
        say(f"[I2] {tag} on 8 z-shards, halo rdma: {ms:.3f} ms/cycle; bit-identical to phase D "
            f"(and so to H2's ppermute run) after 1 and 4 cycles; launches per cycle {per}")
        rows = profile(f"{tag} on 8 z-shards, halo rdma, per cycle",
                       lambda: [step(u, True) for _ in range(3)], per=3)
        # kernels 20, 21 and 22's launches (csrc/rdma3.cuh's ring_*3 kernels
        # and the two legs' own), and kernel 13's
        ring, _ = kernel_ms(rows, lambda key: "ring_" in key and "3_kernel" in key, per=3)
        ms13, _ = kernel_ms(rows, lambda key: key.startswith("residual3_kernel"), per=3)
        ms10r, k10r = kernel_ms(rows, lambda key: "jacobi3_residual_" in key, per=3)
        say(f"[p]     ring kernels 20-22 (ring_*3 launches): {ring:.3f} ms device a cycle; "
            f"kernel 13 (residual3): {ms13:.3f}; kernel 10 emit_residual (jacobi3_residual_* "
            f"passes): {ms10r:.3f}, {k10r:.0f} launches")
        return counts

    c = run(H_V_CYCLE, lambda u, warm: tmg.v_cycle3_sharded(
        u, fs, h, pol.mesh, n_min=5, pre=3, post=3, omega=0.857, halo="rdma"), "i_v_cycle3")
    # JAX's depths 528, 264, 136, 72 (nl 66, 33, 17, 9): the ring legs at
    # 513³; emit_residual, prolong-add and the ring smoother at 257³-65³
    want = {"rdma_descend3": 1, "rdma_ascend3": 1, "rdma_jacobi3": 3, "jacobi3_residual": 24,
            "descend3_shard": 0, "ascend3_shard": 0, "jacobi3_shard": 0}
    require(all(c[k] == cycles * v for k, v in want.items()),
            f"[I2] v_cycle3_sharded halo rdma took other routes than JAX's: {c}")
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    for compat, key in (("clean", "i_compiled3"), ("gpu", "i_compiled3_gpu")):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=True if compat == "clean" else "gpu",
                               collect_node_stats=False, halo="rdma")
        cc = tmg.compile_program3(program, prob, cfg, device="cuda", policy=pol)
        run(H_COMPILED[compat], lambda u, warm: cc(u, fs, warm=warm)[0], key)
    c, g = run_counts["i_compiled3"], run_counts["i_compiled3_gpu"]
    # depths ×16 (nl 66, 34, 18, 10): the ring legs at every sharded level
    # (clean); ring smoother passes and the sharded residual (gpu)
    require(c["rdma_descend3"] == c["rdma_ascend3"] == cycles * 4 and not c["descend3_shard"]
            and not c["ascend3_shard"] and g["rdma_jacobi3"] == cycles * 8
            and not g["jacobi3_shard"] and g["residual3_shard"] == cycles * 4 * 8,
            f"[I2] compile_program3 halo rdma took other routes than JAX's: clean {c}, gpu {g}")
    return times


def phase_i3(tmg, K, torch, run_counts, h3_runs, n=513):
    """I3: phase H3's trigger V-cycle with halo="rdma" ("auto", batch 1,
    batch 7): kernel 19 runs every trigger node at 257³-65³ (where JAX's
    rdma_trigger3_fits admits the shard), before any batching, and none at
    513³ (which it refuses). "auto" and batch 1 stop where H3's runs stop
    and give its iterates bit for bit; batch 7's 513³ nodes stop where H3's
    batch 7 does, and its ring levels where the exact loop does on the same
    inputs (kernel 19 replaced by its twin)."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3

    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    prob = tmg.REFERENCE_PROBLEM_3D
    pol = z_policy(8)
    out = {}

    def run(tag, batch, twin=False):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=False, collect_node_stats=False,
                               trigger_batch=batch, max_trigger_sweeps=2000, halo="rdma")
        cc = tmg.compile_program3(program, prob, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twin:
                stack.enter_context(ring3_twins_in_place(R3))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[I3] {tag}: non-finite result")
        ring_nodes = sum(1 for m, _ in cc.trigger_sweeps if m < n and pol.is_sharded(m))
        require(counts["rdma_trigger3"] == (0 if twin else ring_nodes),
                f"[I3] {tag}: {counts['rdma_trigger3']} ring trigger launches for {ring_nodes} "
                f"trigger nodes on sharded levels below {n}³")
        say(f"[I3] trigger V-cycle {n}³ on 8 z-shards, halo rdma, {tag}: {ms:.1f} ms, sweeps per "
            f"level {cc.trigger_sweeps}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, ms, counts)
        if tag == "auto":
            cc.trigger_sweeps = None
            profile(f"sharded trigger V-cycle {n}³ halo rdma {tag}", lambda: cc(u0, f))

    twin7 = "batch 7, kernel 19's twin"
    for tag, batch in (("auto", "auto"), ("batch 1", 1), ("batch 7", 7)):
        run(tag, batch)
    run(twin7, 7, twin=True)
    run_counts["i_trigger3_auto"] = out["auto"][3]
    for tag in ("auto", "batch 1"):
        g, sweeps = h3_runs[f"kernels, {tag}"]
        require(out[tag][1] == sweeps and bool(torch.equal(out[tag][0], g)),
                f"[I3] {tag}: stop sweeps {out[tag][1]} against H3's {sweeps}, or iterates differ")
    top = [s for s in out["batch 7"][1] if s[0] == n]
    require(top == [s for s in h3_runs["kernels, batch 7"][1] if s[0] == n]
            and out["batch 7"][1] == out[twin7][1],
            f"[I3] batch 7: {out['batch 7'][1]} against H3's {n}³ nodes and the exact loop's "
            f"{out[twin7][1]}")
    say(f"[I3] stop sweeps per level: auto and batch 1 equal H3's (phase E's) and their iterates "
        f"bit for bit; batch 7 at {n}³ as H3's batch 7, below it the exact loop's")
    return {tag: v[2] for tag, v in out.items()}


def phase_g1(K, torch, cmp):
    """G1: the shard modes of kernels 1-4 and kernels 17 and 18 against their
    twins at 1025² and 1031² (several 32 x 128 tiles per shard; ragged last
    shards and tiles), on rings of 2, 3, 4 and 8 shards and a 2 x 4 block
    mesh; every shard mode's owned cells against the unsharded kernel, bit
    for bit (kernel 1's also with chunks of several tile rows); the ring
    trigger against the loop of one-sweep sharded error launches, bit for
    bit."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5678)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 0.8
    G = S.gather

    def twin(fn, *args, **kw):
        """fn on the shard-mode twins (the wrappers look the kernels up at
        each call)."""
        with sharded_twins_in_place(K, rdma):
            return fn(*args, **kw)

    def same(what, got, want):
        require(bool(torch.equal(got, want)), f"{what}: owned cells differ from the unsharded "
                f"kernel (max|Δ| {float((got - want).abs().max()):.3e})")

    stops = {}
    for n in (1025, 1031):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        m = (n + 1) // 2
        uc = rand(m, m)
        for tag, pol in ring_policies().items():
            lay = S.layout_of(pol, n)
            us, fs = S.shard(u, lay), S.shard(f, lay)
            ring = len(lay.cols) == 1
            what = f"n={n} {tag}"
            for steps in ((1, 2, 3, 4, 5, 6, 7, 8, 11) if n == 1025 else (1, 5, 8, 11)):
                for fz in (False, True):
                    w = f"{what} steps={steps} fz={fz}"
                    got = G(KS.sharded_fused_jacobi(us, fs, h, steps, omega, fz))
                    cmp.grid("jacobi_shard", w, got,
                             G(twin(KS.sharded_fused_jacobi, us, fs, h, steps, omega, fz)))
                    cmp.cases["jacobi_shard"] += 1
                    same(f"jacobi_shard {w}", got, K.fused_jacobi(u, f, h, steps, omega, fz))
                    if ring:   # kernel 18 on both routes
                        ring_twin = G(rdma.rdma_jacobi_torch(us, fs, h, steps, omega, fz))
                        for route in ("tile", "wave"):
                            with rdma.forced_jacobi_route(route):
                                ring_u = G(KS.rdma_fused_jacobi(us, fs, h, steps, omega, fz))
                            same(f"rdma_jacobi {w} {route}", ring_u, got)
                            cmp.grid("rdma_jacobi", f"{w} {route}", ring_u, ring_twin)
                            cmp.cases["rdma_jacobi"] += 1
            for compat in (True, False, "gpu"):
                for steps in (1, 7, 11):
                    w = f"{what} steps={steps} err={compat}"
                    gu, ge = KS.sharded_fused_jacobi_err(us, fs, h, steps, omega, compat)
                    wu, we = twin(KS.sharded_fused_jacobi_err, us, fs, h, steps, omega,
                                  compat)
                    cmp.grid("jacobi_shard", w, G(gu), G(wu))
                    cmp.scalar("jacobi_shard", w, ge, we)
                    cmp.cases["jacobi_shard"] += 1
                    ku, ke = K.fused_jacobi_err(u, f, h, steps, omega, compat)
                    same(f"jacobi_shard {w}", G(gu), ku)
                    cmp.scalar("jacobi_shard", f"{w} against the unsharded kernel", ge, ke)
                cap = K.errs_sweep_cap(compat)
                gu, ge = KS.sharded_fused_jacobi_errs(us, fs, h, cap, omega, compat)
                wu, we = twin(KS.sharded_fused_jacobi_errs, us, fs, h, cap, omega, compat)
                w = f"{what} per-sweep err={compat}"
                cmp.grid("jacobi_errs_shard", w, G(gu), G(wu))
                for s in range(cap):
                    cmp.scalar("jacobi_errs_shard", f"{w} iterate {s + 1}", ge[s], we[s])
                cmp.cases["jacobi_errs_shard"] += 1
                same(f"jacobi_errs_shard {w}", G(gu), K.fused_jacobi(u, f, h, cap, omega))
                for s in (1, cap):
                    require(torch.equal(ge[s - 1], KS.sharded_fused_jacobi_err(
                        us, fs, h, s, omega, compat)[1]),
                        f"jacobi_errs_shard {w}: errs[{s - 1}] differs from the error of {s} "
                        f"sweeps")
            for steps in (1, 2, 3, 4):
                w = f"{what} rb-GS steps={steps}"
                got = G(KS.sharded_fused_jacobi(us, fs, h, steps, 1.0, smoother="rbgs"))
                cmp.grid("rbgs_shard", w, got, G(twin(
                    KS.sharded_fused_jacobi, us, fs, h, steps, 1.0, smoother="rbgs")))
                same(f"rbgs_shard {w}", got, K.fused_rbgs(u, f, h, steps))
                cmp.cases["rbgs_shard"] += 1
                for compat in ((True, False) if steps <= 3 else ()):
                    gu, ge = KS.sharded_fused_jacobi_err(us, fs, h, steps, 1.0, compat,
                                                         smoother="rbgs")
                    wu, we = twin(KS.sharded_fused_jacobi_err, us, fs, h, steps, 1.0,
                                  compat, smoother="rbgs")
                    cmp.grid("rbgs_shard", f"{w} err={compat}", G(gu), G(wu))
                    cmp.scalar("rbgs_shard", f"{w} err={compat}", ge, we)
                    cmp.cases["rbgs_shard"] += 1
            for negate in (False, True):
                got = G(KS.sharded_residual(us, fs, h, negate))
                cmp.grid("residual_shard", f"{what} negate={negate}", got,
                         G(twin(KS.sharded_residual, us, fs, h, negate)))
                same(f"residual_shard {what}", got, K.residual(u, f, h, negate))
                cmp.cases["residual_shard"] += 1
            if n % 2:
                for restriction in ("sampling", "full_weighting"):
                    for fz in (False, True):
                        for steps in (1, 3, 6):
                            w = f"{what} steps={steps} fz={fz} {restriction}"
                            args = (h, steps, omega, restriction, "cpu", fz)
                            gu, gfc, ge = KS.sharded_fused_descend(us, fs, *args)
                            wu, wfc, we = twin(KS.sharded_fused_descend, us, fs, *args)
                            cmp.grid("descend_shard", w + " u", G(gu), G(wu))
                            cmp.grid("descend_shard", w + " f_coarse", G(gfc), G(wfc))
                            cmp.scalar("descend_shard", w, ge, we)
                            cmp.cases["descend_shard"] += 1
                            ku, kfc, _ = K.fused_descend(u, f, h, steps, omega, restriction,
                                                         True, True, fz)
                            same(f"descend_shard {w}", G(gu), ku)
                            same(f"descend_shard {w} f_coarse", G(gfc), kfc)
                child = S.as_level(uc, pol, m)
                for steps, mode in ((1, None), (3, "cpu"), (7, "clean"), (8, "gpu")):
                    w = f"{what} steps={steps} err={mode}"
                    gu, ge = KS.sharded_fused_ascend(us, fs, child, h, steps, omega, mode)
                    wu, we = twin(KS.sharded_fused_ascend, us, fs, child, h, steps, omega,
                                  mode)
                    cmp.grid("ascend_shard", w, G(gu), G(wu))
                    if mode is not None:
                        cmp.scalar("ascend_shard", w, ge, we)
                    cmp.cases["ascend_shard"] += 1
                    compat = {None: True, "cpu": True, "clean": False, "gpu": "gpu"}[mode]
                    same(f"ascend_shard {w}", G(gu),
                         K.fused_ascend(u, f, uc, h, steps, omega, compat, mode is not None)[0])
            if not ring:
                continue
            v0 = S.shard(u * 0.01, lay)
            for compat in (True, False, "gpu"):
                def one(v):
                    return KS.sharded_fused_jacobi_err(v, fs, h, 1, omega, compat)

                v, prev, slope = v0, None, None
                for _ in range(20):    # a trigger that stops the loop near sweep 20
                    v, e = one(v)
                    slope, prev = (None if prev is None else abs(float(e) - prev)), float(e)
                for trig, max_sweeps in ((0.0, 1), (0.0, 2), (0.0, 37), (slope, 60)):
                    w = f"{what} err={compat} trigger={trig:.6g} max={max_sweeps}"
                    gu, ge, gk = KS.rdma_fused_trigger(v0, fs, h, trig, omega, compat,
                                                       max_sweeps)
                    ru, re_, rk = trigger_loop(one, v0, trig, max_sweeps)
                    require(int(gk) == rk and bool(torch.equal(G(gu), G(ru)))
                            and bool(torch.equal(ge, re_)),
                            f"rdma_trigger {w}: {int(gk)} sweeps vs {rk} of the one-sweep "
                            f"sharded launches, or another iterate or error")
                    if max_sweeps in (37, 60):
                        wu, we, _ = rdma.rdma_trigger_torch(v0, fs, h, omega, compat, 0.0,
                                                            int(gk))
                        cmp.grid("rdma_trigger", f"{w} ({int(gk)} sweeps)", G(gu), G(wu))
                        cmp.scalar("rdma_trigger", w, ge, we)
                    cmp.cases["rdma_trigger"] += 1
                    if max_sweeps == 60:
                        stops[f"{n} {tag} {compat}"] = int(gk)
        torch.cuda.synchronize()
    # the shard modes with chunks of several tile rows (the occupancy rule
    # gives these blocks one tile row a chunk): every sweep count, error
    # kind, from_zero and the per-sweep mode on 2 and 8 row shards and 2 x 4
    # blocks, bit for bit against the twins and the unsharded kernel
    pols = ring_policies()
    for rows in (64, 256):
        with K.forced_chunk_rows(rows):
            for n in (1025, 1031):
                h = 1.0 / (n - 1)
                u, f = rand(n, n), rand(n, n)
                for tag in ("rows-2", "rows-8", "block-2x4"):
                    lay = S.layout_of(pols[tag], n)
                    us, fs = S.shard(u, lay), S.shard(f, lay)
                    what = f"n={n} {tag} chunks of {rows} rows"
                    for steps in range(1, 9):
                        for compat in (None, True, False, "gpu"):
                            for fz in (False, True):
                                w = f"{what} steps={steps} err={compat} fz={fz}"
                                if compat is None:
                                    gu = KS.sharded_fused_jacobi(us, fs, h, steps, omega, fz)
                                    wu = twin(KS.sharded_fused_jacobi, us, fs, h, steps, omega,
                                              fz)
                                    ku = K.fused_jacobi(u, f, h, steps, omega, fz)
                                else:
                                    gu, ge = KS.sharded_fused_jacobi_err(us, fs, h, steps, omega,
                                                                         compat, fz)
                                    wu, we = twin(KS.sharded_fused_jacobi_err, us, fs, h, steps,
                                                  omega, compat, fz)
                                    ku, ke = K.fused_jacobi_err(u, f, h, steps, omega, compat,
                                                                fz)
                                    cmp.scalar("jacobi_shard", w, ge, we)
                                    cmp.scalar("jacobi_shard", f"{w} against the unsharded "
                                               f"kernel", ge, ke)
                                cmp.grid("jacobi_shard", w, G(gu), G(wu))
                                cmp.cases["jacobi_shard"] += 1
                                same(f"jacobi_shard {w}", G(gu), ku)
                    for compat in (True, False, "gpu"):
                        cap = K.errs_sweep_cap(compat)
                        gu, ge = KS.sharded_fused_jacobi_errs(us, fs, h, cap, omega, compat)
                        wu, we = twin(KS.sharded_fused_jacobi_errs, us, fs, h, cap, omega, compat)
                        w = f"{what} per-sweep err={compat}"
                        cmp.grid("jacobi_errs_shard", w, G(gu), G(wu))
                        cmp.cases["jacobi_errs_shard"] += 1
                        same(f"jacobi_errs_shard {w}", G(gu), K.fused_jacobi(u, f, h, cap, omega))
                        for s in range(1, cap + 1):
                            require(torch.equal(ge[s - 1], KS.sharded_fused_jacobi_err(
                                us, fs, h, s, omega, compat)[1]),
                                f"jacobi_errs_shard {w}: errs[{s - 1}] differs from the error "
                                f"of {s} sweeps")
                    for steps in (1, 2, 3, 4):
                        for compat in (None, True, False) if steps <= 3 else (None,):
                            w = f"{what} rb-GS steps={steps} err={compat}"
                            if compat is None:
                                gu = KS.sharded_fused_jacobi(us, fs, h, steps, 1.0,
                                                             smoother="rbgs")
                                wu = twin(KS.sharded_fused_jacobi, us, fs, h, steps, 1.0,
                                          smoother="rbgs")
                                ku = K.fused_rbgs(u, f, h, steps)
                            else:
                                gu, ge = KS.sharded_fused_jacobi_err(us, fs, h, steps, 1.0,
                                                                     compat, smoother="rbgs")
                                wu, we = twin(KS.sharded_fused_jacobi_err, us, fs, h, steps,
                                              1.0, compat, smoother="rbgs")
                                ku, ke = K.fused_rbgs_err(u, f, h, steps, compat)
                                cmp.scalar("rbgs_shard", w, ge, we)
                                cmp.scalar("rbgs_shard", f"{w} against the unsharded kernel",
                                           ge, ke)
                            cmp.grid("rbgs_shard", w, G(gu), G(wu))
                            cmp.cases["rbgs_shard"] += 1
                            same(f"rbgs_shard {w}", G(gu), ku)
        torch.cuda.synchronize()
    # kernel 17 at every pass length (rdma.forced_trigger_batch 1..8, held at
    # 7 for the cpu and clean metrics) on rings of 2, 3 and 8 shards and one
    # whose first shard has 8 rows (a pass's whole halo): a trigger that
    # stops the loop at sweep 19 where the slopes fall (inside a pass for
    # every B > 1: the redo) and a max_sweeps inside the second pass, stop
    # sweep, iterate and error bit for bit the loop of one-sweep sharded
    # error launches
    inside = 0
    for n in (1025, 1031):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        lays = {tag: S.layout_of(pols[tag], n) for tag in ("rows-2", "rows-3", "rows-8")}
        lays["rows-3, 8 + 2 shards"] = S.Layout(n, ((0, 8), (8, n // 2), (n // 2, n)),
                                                ((0, n),), ((torch.device("cuda:0"),),) * 3)
        for tag, lay in lays.items():
            fs, v0 = S.shard(f, lay), S.shard(u * 0.01, lay)
            for compat in (True, False, "gpu"):
                def one(v):
                    return KS.sharded_fused_jacobi_err(v, fs, h, 1, omega, compat)

                v, errs = v0, []
                for _ in range(19):
                    v, e = one(v)
                    errs.append(float(e))
                trig = 0.5 * (abs(errs[17] - errs[16]) + abs(errs[18] - errs[17]))
                mid = trigger_loop(one, v0, trig, 200)
                for batch in range(1, 9):
                    with rdma.forced_trigger_batch(batch):
                        for t, max_sweeps in ((trig, 200), (0.0, batch + 3)):
                            ru, re_, rk = mid if t else trigger_loop(one, v0, t, max_sweeps)
                            gu, ge, gk = KS.rdma_fused_trigger(v0, fs, h, t, omega, compat,
                                                               max_sweeps)
                            w = (f"n={n} {tag} err={compat} B={batch} trigger={t:.6g} "
                                 f"max={max_sweeps}")
                            require(int(gk) == rk and bool(torch.equal(G(gu), G(ru)))
                                    and bool(torch.equal(ge, re_)),
                                    f"rdma_trigger {w}: {int(gk)} sweeps vs {rk} of the "
                                    f"one-sweep sharded launches, or another iterate or error")
                            cmp.cases["rdma_trigger"] += 1
                            b = min(batch, 8 - (compat != "gpu"))
                            inside += t > 0 and rk % b != 0
        torch.cuda.synchronize()
    say(f"[G1] ring trigger loops at every pass length that stopped inside a pass: {inside}")
    require(inside > 0, "no ring trigger loop stopped inside a pass: the redo went unchecked")
    # the legs' shard modes on the wavefront (the size rule sends these
    # blocks to the tile kernel, which the loops above hold) with the
    # occupancy rule's chunks and chunks of 64 and 256 rows: per shard bit for
    # bit against the twins, the tile kernel (errors too) and the unsharded
    # kernel, on rings of 2, 3, 4 and 8 shards and 2 x 4 blocks
    def legs_on(route, fn):
        with K.forced_leg_route(route):
            return fn()

    for rows in (None, 64, 256):
        with K.forced_chunk_rows(rows) if rows else contextlib.nullcontext():
            for n in (1025, 1031):
                h = 1.0 / (n - 1)
                u, f = rand(n, n), rand(n, n)
                m = (n + 1) // 2
                uc = rand(m, m)
                for tag, pol in pols.items():
                    lay = S.layout_of(pol, n)
                    us, fs = S.shard(u, lay), S.shard(f, lay)
                    what = f"n={n} {tag} wavefront, chunks of {rows or 'the rule'} rows"
                    for i, (restriction, fz) in enumerate(
                            ((r, z) for r in ("sampling", "full_weighting") for z in (False, True))):
                        for steps in (1, 3, 5, 6):   # the shard halo (8) caps k + 1 + FW
                            mode = (None, "cpu", "clean", "gpu")[(steps + i) % 4]
                            w = f"{what} steps={steps} fz={fz} {restriction} err={mode}"
                            args = (h, steps, omega, restriction, mode, fz)
                            gu, gfc, ge = legs_on("wave", lambda: KS.sharded_fused_descend(
                                us, fs, *args))
                            wu, wfc, we = twin(KS.sharded_fused_descend, us, fs, *args)
                            tu, tfc, te = legs_on("tile", lambda: KS.sharded_fused_descend(
                                us, fs, *args))
                            cmp.grid("descend_shard", w + " u", G(gu), G(wu))
                            cmp.grid("descend_shard", w + " f_coarse", G(gfc), G(wfc))
                            cmp.cases["descend_shard"] += 1
                            same(f"descend_shard {w} (the tile kernel)", G(gu), G(tu))
                            same(f"descend_shard {w} f_coarse (the tile kernel)", G(gfc), G(tfc))
                            if mode is not None:
                                cmp.scalar("descend_shard", w, ge, we)
                                require(bool(torch.equal(ge, te)), f"descend_shard {w}: the "
                                        f"error differs from the tile kernel's")
                            compat = {None: True, "cpu": True, "clean": False, "gpu": "gpu"}[mode]
                            ku, kfc, _ = K.fused_descend(u, f, h, steps, omega, restriction,
                                                         compat, True, fz)
                            same(f"descend_shard {w}", G(gu), ku)
                            same(f"descend_shard {w} f_coarse", G(gfc), kfc)
                    child = S.as_level(uc, pol, m)
                    for steps, mode in ((1, "gpu"), (2, "cpu"), (3, None), (5, "clean"),
                                        (7, "cpu"), (8, "gpu")):
                        w = f"{what} steps={steps} err={mode}"
                        gu, ge = legs_on("wave", lambda: KS.sharded_fused_ascend(
                            us, fs, child, h, steps, omega, mode))
                        wu, we = twin(KS.sharded_fused_ascend, us, fs, child, h, steps, omega,
                                      mode)
                        tu, te = legs_on("tile", lambda: KS.sharded_fused_ascend(
                            us, fs, child, h, steps, omega, mode))
                        cmp.grid("ascend_shard", w, G(gu), G(wu))
                        cmp.cases["ascend_shard"] += 1
                        same(f"ascend_shard {w} (the tile kernel)", G(gu), G(tu))
                        if mode is not None:
                            cmp.scalar("ascend_shard", w, ge, we)
                            require(bool(torch.equal(ge, te)), f"ascend_shard {w}: the error "
                                    f"differs from the tile kernel's")
                        compat = {None: True, "cpu": True, "clean": False, "gpu": "gpu"}[mode]
                        same(f"ascend_shard {w}", G(gu),
                             K.fused_ascend(u, f, uc, h, steps, omega, compat, mode is not None)[0])
        torch.cuda.synchronize()
    say(f"[G1] ring trigger stop sweeps at a mid-loop trigger: {stops}")
    require(all(k < 60 for k in stops.values()), "a mid-loop ring trigger ran to its cap")


def ring18_rows(K, torch, rdma, S, ring8, u, f, h, us2, fs2, g2, pts):
    """[t] rows of kernel 18 on both routes (forced) and the batched
    residual, each held bit for bit against its twin: 8 sweeps at 4097² on
    8 shards (CUDA events); every launch shape of G2's coarsen=1 rdma cycle
    (2048² down to 128², 3 sweeps from zero and not) and the threshold's
    A/B sizes (4097², 2049², 1025², 513²), device µs a call (graph_us: a
    replay reuses the captured ring tags, so its flag waits pass at once;
    the posts still run); the batched residual at every G2 level (4097²
    down to 128² on one-row windows), device µs a launch. The parent's
    (2327a20, the tile pipeline and a launch a shard) beside."""
    n = u.shape[0]
    want = S.gather(rdma.rdma_jacobi_torch(us2, fs2, h, 8, 0.8))
    for route in ("tile", "wave"):
        with rdma.forced_jacobi_route(route):
            require(bool(torch.equal(S.gather(rdma.rdma_jacobi(us2, fs2, h, 8, 0.8)), want)),
                    f"rdma_jacobi at {n}², 8 sweeps, {route}: differs from its twin")
            ms = time_ms(lambda: rdma.rdma_jacobi(us2, fs2, h, 8, 0.8), reps=10)
        say(f"[t] rdma_jacobi at {n}² on 8 shards, 8 sweeps, {route} route: {ms:.4f} ms "
            f"(parent {PARENT_RING18_MS:.4f}); bound "
            f"{bound(3 * g2, 8 * SWEEP_OPS * pts)[0]:.4f} ms")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1819)
    for m in (4097, 2049, 2048, 1025, 1024, 513, 512, 256, 128):
        um, fm = (torch.randn(m, m, generator=gen, device="cuda") for _ in range(2))
        lay, hm = S.layout_of(ring8, m), 1.0 / (m - 1)
        us, fs = S.shard(um, lay), S.shard(fm, lay)
        for fz in (True, False):
            src = fs if fz else us
            twin = S.gather(rdma.rdma_jacobi_torch(src, fs, hm, 3, 0.8, fz))
            got = {}
            for route in ("tile", "wave"):
                with rdma.forced_jacobi_route(route):
                    require(bool(torch.equal(S.gather(rdma.rdma_jacobi(src, fs, hm, 3, 0.8, fz)),
                                             twin)),
                            f"rdma_jacobi at {m}², 3 sweeps, fz={fz}, {route}: differs from its "
                            f"twin")
                    got[route] = graph_us(lambda: rdma.rdma_jacobi(src, fs, hm, 3, 0.8, fz))
            say(f"[t] rdma_jacobi at {m}² on 8 shards, 3 sweeps, from_zero={fz}: tile "
                f"{got['tile']:.2f} µs, wave {got['wave']:.2f} µs device a call (parent "
                f"{PARENT_RING18_US.get((m, fz), float('nan')):.2f}); bound "
                f"{bound((8 if fz else 12) * m * m, (3 - fz) * SWEEP_OPS * m * m)[0] * 1e3:.2f} "
                f"µs")
        if m in (2049, 1025, 513):
            continue
        wins = [(S.extend(us, i, 0, 1, 0), S.extend(fs, i, 0, 1, 0))
                for i in range(len(lay.rows))]
        geos = [K.ShardGeo(m, r0, 0, r1 - r0, m, 1, 0) for r0, r1 in lay.rows]
        args = ([w[0] for w in wins], [w[1] for w in wins], geos, hm)
        for a, b in zip(K.residual_shards(*args), K.residual_shards_torch(*args)):
            require(bool(torch.equal(a, b)), f"residual_shards at {m}²: differs from its twin")
        us_ = graph_us(lambda: K.residual_shards(*args))
        say(f"[t] residual_shard at {m}² on 8 shards, one batched launch: {us_:.2f} µs device "
            f"(parent, 8 launches: {PARENT_RES_SHARD_US.get(m, float('nan')):.2f}); bound "
            f"{bound(12 * m * m, RES_OPS * m * m)[0] * 1e3:.2f} µs")


def phase_g2(tmg, K, torch, run_counts):
    """G2: two V-cycles at 4097² on a ring of 8 shards on one card, through
    compile_program(policy=...) with halo="ppermute" and "rdma" and on the
    plain path, against the unsharded kernel run; and the rb-GS V(2,2)."""
    from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    n = 4097
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16)
    programs = {
        # bench_scaling.py's program: non-2:1 levels, separate sweeps
        "bench_scaling coarsen=1": (tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0,
                                                coarsen=1), {}),
        # the bench's V(3,3): fused legs per shard, the chains below
        "V(3,3) coarsen=3": (tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3),
                             {"omega": 0.8}),
        "rb-GS V(2,2) FW": (tmg.v_cycle(n, n_min=8, steps=2, coarse_option=0, coarsen=3),
                            {"smoother": "rbgs", "restriction": "full_weighting"}),
    }
    keys = {("bench_scaling coarsen=1", "ppermute"): "sharded",
            ("bench_scaling coarsen=1", "rdma"): "sharded_rdma",
            ("V(3,3) coarsen=3", "ppermute"): "sharded_legs",
            ("rb-GS V(2,2) FW", "ppermute"): "sharded_rbgs"}
    times = {}
    for name, (program, kw) in programs.items():
        runs = {}
        variants = [("unsharded", None, {}), ("ppermute", pol, {}), ("rdma", pol, {"halo": "rdma"}),
                    ("plain", pol, {"kernels": "torch"})]
        if "rb-GS" in name:   # the ring kernels smooth Jacobi only
            variants = [v for v in variants if v[0] != "rdma"]
        for tag, policy, extra in variants:
            cfg = tmg.SolverConfig(collect_node_stats=False, **kw, **extra)
            cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                       policy=policy)
            warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                       warm=True, policy=policy)
            u0, f = cold.init()
            K.reset_launch_counts()
            ms_cold, (u1, err) = wall_ms(lambda: cold(u0, f))
            u = u1
            for _ in range(5):
                u, err = warm(u, f)
            torch.cuda.synchronize()
            counts = dict(K.launches)
            if (name, tag) in keys:
                run_counts[keys[(name, tag)]] = counts
            g1, g6, fg = cold.unpad(u1), cold.unpad(u), S.gather(f)
            require(tuple(g6.shape) == (n, n) and bool(torch.isfinite(g6).all())
                    and bool(torch.isfinite(err)), f"[G2] {name} {tag}: non-finite output")
            h = cold.finest_spec.h
            r1 = float(relative_residual_norm(g1.double(), fg.double(), h))
            r6 = float(relative_residual_norm(g6.double(), fg.double(), h))
            ms = time_ms(lambda: warm(u, f), reps=1 if tag == "plain" else 3, rounds=3)
            runs[tag] = (g1, g6, r1, r6, counts)
            times[f"{name} {tag}"] = ms
            say(f"[G2] {n}² {name} {tag}: {ms:.3f} ms/cycle (cold cycle {ms_cold:.1f} ms wall), "
                f"float64 rel. residual {r1:.6e} after 1 cycle, {r6:.6e} after 6; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if tag in ("ppermute", "rdma") and "coarsen=1" in name:
                # kernel 2's shard mode: one launch a sharded level (6 a cycle)
                require(counts["residual_shard"] == 6 * 6, f"[G2] {name} {tag}: "
                        f"{counts['residual_shard']} residual_shard launches in 6 cycles, not 36")
            if tag in ("ppermute", "rdma") and "rb-GS" not in name:
                rows = profile(f"{n}² {name} {tag} per cycle",
                               lambda: [warm(u, f) for _ in range(3)], per=3)
                parts = [(what, *kernel_ms(rows, match, per=3)) for what, match in (
                    ("residual", lambda key: "residual" in key),
                    ("rdma_jacobi", lambda key: "rdma_jacobi" in key),
                    ("jacobi shard mode", lambda key: key.startswith("void jacobi_kernel<true")),
                    ("DtoD copies", lambda key: "Memcpy DtoD" in key))]
                say(f"[p] {n}² {name} {tag}, device ms a cycle: " + "; ".join(
                    f"{what} {ms:.4f} in {cnt:.1f} launches" for what, ms, cnt in parts))
        if "rdma" in runs:
            for i, what in ((0, "1 cycle"), (1, "6 cycles")):
                require(bool(torch.equal(runs["rdma"][i], runs["ppermute"][i])),
                        f"[G2] {name}: rdma and ppermute iterates differ after {what}")
            say(f"[G2] {name}: rdma and ppermute iterates bit-identical after 1 and 6 cycles")
        want = runs["unsharded"]
        for tag, got in runs.items():
            if tag == "unsharded":
                continue
            for i, j, what in ((0, 2, "1 cycle"), (1, 3, "6 cycles")):
                diff = float((got[i] - want[i]).abs().max())
                scale = float(want[i].abs().max())
                say(f"[G2] {name} {tag} against unsharded after {what}: max|Δu| {diff:.3e} "
                    f"(bit-identical: {bool(torch.equal(got[i], want[i]))}), residual "
                    f"{got[j]:.6e} vs {want[j]:.6e}")
                require(diff <= U_RTOL * scale and abs(got[j] - want[j]) <= RES_RTOL * want[j],
                        f"[G2] {name} {tag}: outside the phase 3 gate after {what}")
                # the kernel paths' owned cells are the unsharded kernels', bit for bit
                require(tag == "plain" or bool(torch.equal(got[i], want[i])),
                        f"[G2] {name} {tag}: not bit-identical to the unsharded run after {what}")
        if "plain" in runs:
            require(not any(runs["plain"][4].values()),
                    f"[G2] {name}: the plain sharded path launched a kernel")
    return times


def phase_g3(tmg, K, torch, run_counts, unsharded_levels):
    """G3: the 8193² trigger V-cycle on a ring of 8 shards (threshold 32):
    the sharded levels take the batched per-sweep passes (8193²) and the ring
    trigger kernel or the one-sweep sharded loop (4097²-257²); 129² and
    below are the single-device tiers."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    n, cap = 8193, 2000
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=32)
    out = {}

    def run(tag, batch, halo, twins=False):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, trigger_batch=batch,
                               max_trigger_sweeps=cap, halo=halo)
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twins:
                stack.enter_context(twins_in_place(K))
                stack.enter_context(sharded_twins_in_place(K, rdma))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[G3] sharded trigger V-cycle {tag}: non-finite result")
        say(f"[G3] sharded trigger V-cycle {n}² {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, ms, counts)
        if tag == "rdma, auto":
            cc.trigger_sweeps = None
            rows = profile(f"sharded trigger V-cycle {n}² {tag}", lambda: cc(u0, f))
            ms17, k17 = kernel_ms(rows, lambda key: "rdma_trigger_kernel" in key)
            say(f"[t] rdma_trigger (kernel 17) in the G3 {tag} run: {ms17:.3f} ms device, "
                f"{k17:.0f} launches, of {sum(r[1] for r in rows):.3f} ms busy (torch.profiler)")
            ms1, k1 = kernel_ms(rows, lambda key: key.startswith("void jacobi_kernel<true"))
            say(f"[t] jacobi_shard (kernel 1's shard mode) in the G3 {tag} run: {ms1:.3f} ms "
                f"device, {k1:.0f} launches (torch.profiler)")
        return tag

    rd = run("rdma, auto", "auto", "rdma")
    pp = run("ppermute, auto", "auto", "ppermute")
    tw = run("twins, auto", "auto", "ppermute", twins=True)
    b7 = run("rdma, batch 7", 7, "rdma")
    tb7 = run("twins, batch 7", 7, "rdma", twins=True)
    run_counts["sharded_trigger_rdma"] = out[rd][3]
    run_counts["sharded_trigger_b7"] = out[b7][3]
    for a, b in ((rd, pp), (rd, tw), (b7, tb7)):
        require(out[a][1] == out[b][1], f"[G3] stop sweeps {out[a][1]} ({a}) vs {out[b][1]} ({b})")
    require(bool(torch.equal(out[rd][0], out[pp][0])),
            "[G3] the finest iterate differs between rdma and ppermute")
    for a, b in ((rd, tw), (b7, tb7)):
        diff = float((out[a][0] - out[b][0]).abs().max())
        require(diff <= U_RTOL * float(out[b][0].abs().max()), f"[G3] {a} vs {b}: iterates differ")
    say("[G3] equal stop sweeps per level among rdma, ppermute and the twins; rdma and ppermute "
        "finest iterates bit-identical")
    require(out[rd][3]["rdma_trigger"] > 0 and out[b7][3]["jacobi_errs_shard"] > 0,
            "[G3] the ring trigger or the sharded per-sweep passes were not launched")
    # against phase B's unsharded "auto" run: the sharded error is the shards'
    # partials added in shard order, another order than the unsharded
    # kernels' one reduction, so a stop may move by a sweep at a near tie
    ours, theirs = out[rd][1], unsharded_levels
    require(len(ours) == len(theirs) and [a for a, _ in ours] == [a for a, _ in theirs],
            "[G3] the sharded and unsharded trigger V-cycles visit other levels")
    moved = [(m, k, kk) for (m, k), (_, kk) in zip(ours, theirs) if k != kk]
    say(f"[G3] stop sweeps per level, sharded rdma auto {ours}; unsharded (phase B, auto) "
        f"{theirs}; levels that differ (n, sharded, unsharded): {moved or 'none'}")
    require(all(abs(k - kk) <= 1 for _, k, kk in moved),
            "[G3] a stop sweep moved by more than one sweep against the unsharded run")
    for m, k, kk in moved:
        say(f"[G3] near tie at {m}²: the slope crosses the trigger within the rounding of the "
            f"two error sums (sharded stop {k}, unsharded {kk})")
    return {tag: v[2] for tag, v in out.items()}, ours


def phase_g3_rbgs(tmg, K, torch, run_counts):
    """G3, rb-GS: a trigger V-cycle at 4097² with rb-GS and the gpu metric on
    8 shards (threshold 32): its sharded levels (4097²-257²) smooth one
    sweep at a time through the rb-GS shard mode and add the shards' gpu
    error partials; on the kernels, through the twins and on the plain
    path."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    n, cap = 4097, 200
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=32)
    out = {}
    for tag, kernels, twins in (("kernels", "auto", False), ("twins", "auto", True),
                                ("plain", "torch", False)):
        cfg = tmg.SolverConfig(smoother="rbgs", compat_error="gpu", collect_node_stats=False,
                               max_trigger_sweeps=cap, kernels=kernels)
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twins:
                stack.enter_context(twins_in_place(K))
                stack.enter_context(sharded_twins_in_place(K, rdma))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[G3] rb-GS gpu trigger V-cycle {tag}: non-finite result")
        say(f"[G3] rb-GS gpu-metric trigger V-cycle {n}² {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, counts)
    run_counts["sharded_rbgs_trigger"] = out["kernels"][2]
    require(out["kernels"][2]["rbgs_shard"] > 0,
            "[G3] the rb-GS gpu trigger V-cycle did not launch the rb-GS shard mode")
    require(not any(out["plain"][2].values()), "[G3] the plain rb-GS path launched a kernel")
    want = out["twins"]
    for tag in ("kernels", "plain"):
        got = out[tag]
        require(got[1] == want[1], f"[G3] rb-GS stop sweeps {got[1]} ({tag}) vs {want[1]} (twins)")
        diff = float((got[0] - want[0]).abs().max())
        require(diff <= U_RTOL * float(want[0].abs().max()),
                f"[G3] rb-GS {tag} vs twins: iterates differ by {diff:.3e}")
        say(f"[G3] rb-GS {tag} against the twins: equal stop sweeps, max|Δu| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got[0], want[0]))})")


def phase_bf16_kernels(K, torch, cmp):
    """Phase J (a): the bf16 modes of kernels 1-4 against their twins run on
    bf16 tensors, on the card: iterates, coarse right-hand sides and
    residuals bit for bit, the errors within BF16_ERR_RTOL. Kernel 1 with
    every sweep count, from_zero and metric at 65², 257², 1025² and 1031²
    (1031 = 2^10 + 7: a row of 2062 bytes, so rows start at every 2-byte
    offset of a 16-byte chunk) and with chunks forced to 64 and 256 rows,
    at 2049² and 4097² with 1, 3 and 8 sweeps, at 8193² with 8; the legs
    on both routes (tile and wavefront, each output of one bit for bit the
    other's) at 65²-4097²; the residual at every size; views at a 2-byte
    offset (the wrappers copy them aligned)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2020)
    bf16 = torch.bfloat16
    omega = 0.8

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    def same(k, what, got, want):
        cmp.grid(k, what, got.float(), want.float())
        require(got.dtype == bf16 and bool(torch.equal(got, want)),
                f"{k} {what}: not bit for bit the bf16 twin")

    def err(k, what, got, want):
        require(got.dtype == bf16 and want.dtype == bf16, f"{k} {what}: the error is not bf16")
        got, want = float(got), float(want)
        require(abs(got - want) <= BF16_ERR_RTOL * abs(want),
                f"{k} {what}: error {got:.6e} vs twin {want:.6e}")

    def smoother(n, steps_list, modes, fzs):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for steps in steps_list:
            for compat in modes:
                for fz in fzs:
                    what = f"n={n} steps={steps} err={compat} fz={fz}"
                    if compat is None:
                        same("jacobi_bf16", what, K.fused_jacobi(u, f, h, steps, omega, fz),
                             K.fused_jacobi_torch(u, f, h, steps, omega, fz))
                    else:
                        gu, ge = K.fused_jacobi_err(u, f, h, steps, omega, compat, fz)
                        wu, we = K.fused_jacobi_err_torch(u, f, h, steps, omega, compat, fz)
                        same("jacobi_bf16", what, gu, wu)
                        err("jacobi_bf16", what, ge, we)
                    cmp.cases["jacobi_bf16"] += 1

    def residual(n):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for negate in (False, True):
            same("residual_bf16", f"n={n} negate={negate}", K.residual(u, f, h, negate),
                 K.residual_torch(u, f, h, negate))
            cmp.cases["residual_bf16"] += 1

    def legs(n, steps_list, modes, fzs, routes):
        h = 1.0 / (n - 1)
        m = (n + 1) // 2
        u, f, uc = rand(n, n), rand(n, n), rand(m, m)

        def on_routes(name, what, fn):
            outs = []
            for route in routes:
                with K.forced_leg_route(route) if route else contextlib.nullcontext():
                    outs.append(fn())
            for route, out in zip(routes[1:], outs[1:]):
                require(all(a is b or bool(torch.equal(a, b)) for a, b in zip(out, outs[0])),
                        f"{name} {what}: the {route} route differs from the {routes[0]} route")
            return outs[0]

        for steps in steps_list:
            for compat in modes:
                mode = True if compat is None else compat
                for fz in fzs:
                    for restriction in ("sampling", "full_weighting"):
                        args = (h, steps, omega, restriction, mode, compat is not None, fz)
                        what = f"n={n} steps={steps} err={compat} fz={fz} {restriction}"
                        gu, gfc, ge = on_routes("descend_bf16", what,
                                                lambda: K.fused_descend(u, f, *args))
                        wu, wfc, we = K.fused_descend_torch(u, f, *args)
                        same("descend_bf16", what + " u", gu, wu)
                        same("descend_bf16", what + " f_coarse", gfc, wfc)
                        if compat is not None:
                            err("descend_bf16", what, ge, we)
                        cmp.cases["descend_bf16"] += 1
                args = (h, steps, omega, mode, compat is not None)
                what = f"n={n} steps={steps} err={compat}"
                gu, ge = on_routes("ascend_bf16", what, lambda: K.fused_ascend(u, f, uc, *args))
                wu, we = K.fused_ascend_torch(u, f, uc, *args)
                same("ascend_bf16", what, gu, wu)
                if compat is not None:
                    err("ascend_bf16", what, ge, we)
                cmp.cases["ascend_bf16"] += 1

    every = (None, True, False, "gpu")
    for n in (65, 257, 1025, 1031):
        smoother(n, range(1, 9), every, (False, True))
        residual(n)
        legs(n, range(1, 9), every, (False, True), ("tile", "wave"))
    for rows in (64, 256):
        with K.forced_chunk_rows(rows):
            smoother(1031, range(1, 9), every, (False, True))
            legs(1031, (1, 2, 3, 8), every, (False, True), ("wave", "tile"))
    for n in (2049, 4097):
        smoother(n, (1, 3, 8), every, (False, True))
        residual(n)
        legs(n, (1, 3, 8), (None, True, "gpu"), (False, True), (None, "tile"))
    smoother(8193, (8,), every, (False, True))
    residual(8193)
    # views 2 bytes into a buffer: the wrappers copy them aligned, and the
    # results are the aligned inputs', bit for bit; the entry points refuse
    # them (cudaErrorMisalignedAddress)
    from multigrid_poisson_solver_tpu_torch.ops import build

    lib = build.load()
    for n in (1025, 1031):
        h, m = 1.0 / (n - 1), (n + 1) // 2
        u, f, uc = rand(n, n), rand(n, n), rand(m, m)

        def view(x):
            return torch.empty(x.numel() + 1, device="cuda", dtype=bf16)[1:].view(
                x.shape).copy_(x)

        uv, fv, cv = view(u), view(f), view(uc)
        for route in ("tile", "wave"):
            with K.forced_leg_route(route):
                pairs = [(K.fused_jacobi_err(uv, fv, h, 3, omega, True),
                          K.fused_jacobi_err(u, f, h, 3, omega, True)),
                         (K.fused_descend(uv, fv, h, 3, omega, "full_weighting", True, True),
                          K.fused_descend(u, f, h, 3, omega, "full_weighting", True, True)),
                         (K.fused_ascend(uv, fv, cv, h, 3, omega, "gpu", True),
                          K.fused_ascend(u, f, uc, h, 3, omega, "gpu", True))]
            for got, want in pairs:
                require(all(bool(torch.equal(a, b)) for a, b in zip(got, want)),
                        f"bf16 n={n} {route}: a view at an offset differs")
        rc = lib.mg_jacobi_bf16(uv.data_ptr(), fv.data_ptr(), torch.empty_like(u).data_ptr(),
                                None, None, n, 1, 0, 0, h * h, omega, 1.0 / (h * h), 0.0, 0.0,
                                torch.cuda.current_stream().cuda_stream)
        require(rc == 716, f"mg_jacobi_bf16 took a misaligned u and f (rc {rc})")
        rc = lib.mg_ascend_bf16(u.data_ptr(), f.data_ptr(), cv.data_ptr(),
                                torch.empty_like(u).data_ptr(), None, None, n, 1, 0, h * h,
                                omega, 1.0 / (h * h), 0.0, torch.cuda.current_stream().cuda_stream)
        require(rc == 716, f"mg_ascend_bf16 took a misaligned coarse correction (rc {rc})")
    torch.cuda.synchronize()


def phase_bf16(tmg, K, torch, run_counts):
    """Phase J (b)-(d): the bf16 main paths on the card. (b) the bf16 V(3,3)
    at 4097² on the kernels and on the twins (the engine's kernel routing
    with every entry point replaced by its twin): iterates bit for bit after
    1 and 4 cycles, ms/cycle beside the fp32 cycle's (chained bf16 cycles
    diverge at this size, as JAX's bf16 engine's do at 513²-2049² on the
    CPU: tests/bf16_witness.py; the residuals are printed, not bounded); (c) tw32 refinement
    with inner_dtype=torch.bfloat16: at 8193² six cycles, the words and each
    cycle's relative residual bit for bit the twins' (bf16 corrections do not
    converge there: see the comment below), and to 1e-10 at 513² on the
    kernels and the twins (equal cycles and words), beside fp32 inner cycles
    to 1e-10 at 8193²; (d) the CLI's --dtype bf16 on schedules/Vcycle.txt, in
    a subprocess and in process, its Error the twins' run's."""
    from multigrid_poisson_solver_tpu_torch import cli
    from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm

    bf16 = torch.bfloat16
    # (b) the library V(3,3) with a bf16 state
    n = 4097
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    iterates, ms = {}, {}
    for route in ("kernels", "twins"):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, dtype=bf16)
        cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                   warm=True)
        with twins_in_place(K) if route == "twins" else contextlib.nullcontext():
            u0, f = cold.init()
            K.reset_launch_counts()
            u1, err = cold(u0, f)
            u = u1
            for _ in range(3):
                u, err = warm(u, f)
            torch.cuda.synchronize()
            counts = dict(K.launches)
            if route == "kernels":
                run_counts["library_bf16"] = counts
                ms[route] = time_ms(lambda: warm(u, f), reps=5, rounds=3)
        require(u.dtype == bf16 and bool(torch.isfinite(u.float()).all()),
                f"[J] bf16 V(3,3) on the {route}: non-finite or not bf16")
        iterates[route] = (u1, u, err)
        h = cold.finest_spec.h
        say(f"[J] bf16 V(3,3) {n}² on the {route}: float64 rel. residual "
            f"{float(relative_residual_norm(u1.double(), f.double(), h)):.6e} after 1 cycle, "
            f"{float(relative_residual_norm(u.double(), f.double(), h)):.6e} after 4, "
            f"last error {float(err):.6e}; launches {({k: v for k, v in counts.items() if v})}")
    require(run_counts["library_bf16"]["descend_bf16"] > 0
            and run_counts["library_bf16"]["ascend_bf16"] > 0
            and run_counts["library_bf16"]["descend"] == 0,
            f"[J] the bf16 V(3,3) did not run the bf16 legs: {run_counts['library_bf16']}")
    for k, what in ((0, "1 cycle"), (1, "4 cycles")):
        got, want = iterates["kernels"][k], iterates["twins"][k]
        require(bool(torch.equal(got, want)), f"[J] bf16 V(3,3): the kernels' iterate after "
                f"{what} differs from the twins' (max|Δ| {float((got - want).abs().max()):.3e})")
    cfg32 = tmg.SolverConfig(omega=0.8, collect_node_stats=False)
    warm32 = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg32, device="cuda", warm=True)
    u32, f32 = warm32.init()
    ms["fp32"] = time_ms(lambda: warm32(u32, f32), reps=5, rounds=3)
    say(f"[J] bf16 V(3,3) {n}²: iterates bit-identical to the twins' after 1 and 4 cycles; "
        f"{ms['kernels']:.3f} ms/cycle (fp32 cycle {ms['fp32']:.3f} ms/cycle, CUDA events)")

    # (c) tw32 refinement with bf16 inner cycles. A bf16 correction carries
    # its rounding, 2^-9 of |e| at each point, and A multiplies that
    # high-frequency part by ~8/h²: from ~1025² the outer residual stalls and
    # from 2049² it rises instead of falling. JAX's solver does the same on
    # the CPU (tests/bf16_witness.py --refine: at 2049² both rise over 8
    # cycles; ROADMAP Queue 3 item 9), so at 8193² a fixed budget of cycles
    # runs, the kernels' words and per-cycle relative residuals the twins',
    # bit for bit; the 1e-10 target at 513², where bf16 cycles still reach
    # it, on both
    bud = 6
    traj = {}
    for route in ("kernels", "twins"):
        with twins_in_place(K) if route == "twins" else contextlib.nullcontext():
            solver = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 8193, max_cycles=bud,
                                                   state="tw32", inner_dtype=bf16,
                                                   device="cuda")
            f8 = solver.init_rhs()
            words, rels = solver._fresh(), []
            K.reset_launch_counts()
            t_k = time.perf_counter()
            for _ in range(bud):
                words, rel, _ = solver._words(words, f8, 0.0, 1)
                rels.append(float(rel))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t_k) * 1e3
            if route == "kernels":
                run_counts["refine_bf16"] = dict(K.launches)
        traj[route] = (words, rels, wall)
        say(f"[J] tw32 8193² inner bf16 on the {route}: relative residual after each of "
            f"{bud} cycles " + ", ".join(f"{r:.3e}" for r in rels)
            + f"; {wall / bud:.2f} ms/cycle (host clock, with a residual read a cycle)")
    # bit patterns, so a residual that overflows to NaN on both compares equal
    require([r.hex() for r in traj["kernels"][1]] == [r.hex() for r in traj["twins"][1]]
            and all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                    for a, b in zip(traj["kernels"][0], traj["twins"][0])),
            "[J] bf16-inner tw32 8193²: the kernels' words or residuals differ from the twins'")
    rc = run_counts["refine_bf16"]
    require(rc["descend_bf16"] > 0 and rc["ascend_bf16"] > 0 and rc["residual_mw"] > 0
            and rc["descend"] == 0, f"[J] the bf16-inner refinement's launches: {rc}")
    reps = {}
    for n_r, inner, route in ((513, bf16, "kernels"), (513, bf16, "twins"), (8193, None, "kernels")):
        with twins_in_place(K) if route == "twins" else contextlib.nullcontext():
            solver = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n_r, max_cycles=60,
                                                   state="tw32", inner_dtype=inner,
                                                   device="cuda")
            wall, rep = wall_ms(lambda: solver.solve(1e-10))
        require(bool(torch.isfinite(rep.u).all()) and rep.rel_residual <= 1e-10,
                f"[J] tw32 {n_r}² inner {inner} on the {route}: rel {rep.rel_residual:.3e}")
        reps[(n_r, route)] = (rep, wall)
        say(f"[J] tw32 {n_r}² to 1e-10, inner {'bf16' if inner else 'fp32'} on the {route}: "
            f"{rep.cycles} cycles, rel {rep.rel_residual:.6e}, error "
            f"{rep.error_vs_analytic:.6e}, wall {wall:.1f} ms ({wall / rep.cycles:.2f} ms/cycle)")
    k513, t513 = reps[(513, "kernels")][0], reps[(513, "twins")][0]
    require(k513.cycles == t513.cycles and bool(torch.equal(k513.u, t513.u)),
            "[J] bf16-inner tw32 513²: the kernels' solve differs from the twins'")

    # (d) the CLI with --dtype bf16 on a fixed-step schedule
    argv = ["1", "schedules/Vcycle.txt", "--engine", "compiled", "--dtype", "bf16", "--quiet",
            "--no-output"]
    proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"[J] CLI --dtype bf16 failed:\n{proc.stdout}\n{proc.stderr}")
    errors = {"subprocess": re.search(r"Error = (\S+)", proc.stdout)}
    for route in ("kernels", "twins"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                (twins_in_place(K) if route == "twins" else contextlib.nullcontext()):
            K.reset_launch_counts()
            rc_cli = cli.main(argv + ["--device", "cuda"])
            counts = dict(K.launches)
        require(rc_cli == 0, f"[J] in-process CLI --dtype bf16 on the {route} failed")
        if route == "kernels":
            run_counts["cli_bf16"] = counts
        errors[route] = re.search(r"Error = (\S+)", buf.getvalue())
    require(all(m is not None for m in errors.values()), f"[J] CLI --dtype bf16: no Error {errors}")
    e = {k: m.group(1) for k, m in errors.items()}
    say(f"[J] CLI --dtype bf16 Vcycle.txt: Error = {e['subprocess']} (in process "
        f"{e['kernels']}, on the twins {e['twins']}); launches "
        f"{({k: v for k, v in run_counts['cli_bf16'].items() if v})}")
    require(e["subprocess"] == e["kernels"] == e["twins"] and math.isfinite(float(e["kernels"])),
            f"[J] CLI --dtype bf16: the kernels' Error differs from the twins' ({e})")
    return ms, {"8193 bf16": traj["kernels"][1], "513 bf16": reps[(513, "kernels")],
                "8193 fp32": reps[(8193, "kernels")]}


def phase_refine_policy(tmg, K, torch, run_counts):
    """Refinement under a policy: tw32 to 1e-10 at 4097² with the correction
    cycles on 8 row shards of the card (threshold 16; the shard-mode
    kernels), against the unsharded run: the same cycle count."""
    n, tol = 4097, 1e-10
    pol = ring_policies()["rows-8"]
    reps = {}
    for label, policy in (("unsharded", None), ("8 row shards", pol)):
        solver = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n, max_cycles=40,
                                               state="tw32", device="cuda", policy=policy)
        K.reset_launch_counts()
        wall, rep = wall_ms(lambda: solver.solve(tol))
        counts = {k: v for k, v in K.launches.items() if v}
        if policy is not None:
            run_counts["refine_policy"] = dict(K.launches)
        require(bool(torch.isfinite(rep.u).all()) and rep.rel_residual <= tol,
                f"[R] tw32 {n}² {label}: rel {rep.rel_residual:.3e} > {tol:g}")
        reps[label] = rep
        say(f"[R] tw32 {n}² to {tol:g}, {label}: {rep.cycles} cycles, rel "
            f"{rep.rel_residual:.6e}, error {rep.error_vs_analytic:.6e}, wall {wall:.1f} ms "
            f"({wall / rep.cycles:.2f} ms/cycle); launches {counts}")
    require(reps["8 row shards"].cycles == reps["unsharded"].cycles,
            f"[R] tw32 {n}²: {reps['8 row shards'].cycles} cycles on 8 row shards, "
            f"{reps['unsharded'].cycles} unsharded")
    rc = run_counts["refine_policy"]
    require(rc["descend_shard"] > 0 and rc["ascend_shard"] > 0,
            f"[R] the sharded refinement did not run the shard-mode legs: {rc}")


PHASE_L_SPECS = {
    # the bench's V(3,3) under the block policy on the 2×2 hybrid mesh
    "V(3,3) 4097² block": {"kind": "block2d", "n": 4097, "threshold": 32, "cycles": 4,
                           "reps": 2, "program": {"n_min": 8, "steps": 3, "coarse_option": 0,
                                                  "coarsen": 3}, "config": {"omega": 0.8}},
    "trigger V-cycle 2049² rows": {"kind": "trigger2d", "n": 2049, "threshold": 32,
                                   "cycles": 1, "reps": 1,
                                   "program": {"n_min": 8, "steps": -1, "coarse_option": 0,
                                               "coarsen": 3},
                                   "config": {"omega": 0.8, "max_trigger_sweeps": 2000}},
    "compile_program3 V(3,3) 513³ z": {"kind": "compiled3", "n": 513, "threshold": 8,
                                        "cycles": 2, "reps": 2,
                                        "program": {"n_min": 8, "steps": 3, "coarse_option": 0,
                                                    "coarsen": 3},
                                        "config": {"omega": 6.0 / 7.0, "compat_error": True}},
}
# both processes of phase L share one card: NCCL refuses two ranks on one GPU
PHASE_L_DEVICE = "cuda:0"
# shard-mode kernels each program must launch in every worker
PHASE_L_LAUNCHES = {"V(3,3) 4097² block": ("descend_shard", "ascend_shard"),
                    # the one-sweep step with its fused error, the sharded residual
                    "trigger V-cycle 2049² rows": ("jacobi_shard", "residual_shard"),
                    "compile_program3 V(3,3) 513³ z": ("descend3_shard", "ascend3_shard")}


def phase_l(tmg, K, torch, run_counts):
    """L: the sharded cycles across processes (two gloo workers on
    ``PHASE_L_DEVICE``) against one process on the same logical meshes.
    Returns the [end] figures."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    import torch_multihost_cpu as runner

    from multigrid_poisson_solver_tpu_torch.parallel import multihost
    from multigrid_poisson_solver_tpu_torch.utils import scaling_model as sm

    t0 = time.perf_counter()
    one = runner.run_programs(PHASE_L_SPECS, [PHASE_L_DEVICE] * 4, time_it=True)
    one_over = runner.overheads([PHASE_L_DEVICE] * 2)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    each = multihost.spawn(runner.worker, 2,
                           (PHASE_L_SPECS, 2, PHASE_L_DEVICE, False, False, True, True),
                           backend="gloo", timeout=150, threads=torch.get_num_threads())
    t_multi = time.perf_counter() - t0
    multi = runner.merge(each)
    report = runner.compare(one, multi)
    out = {}
    for name, diffs in report.items():
        a, b = one[name], multi[name]
        require(not diffs, f"[L] {name}: two processes differ from one: {diffs}")
        for r, w in enumerate(each):
            got = {k: v for k, v in w[name]["launches"].items() if v}
            require(all(got.get(k, 0) > 0 for k in PHASE_L_LAUNCHES[name]),
                    f"[L] {name}: worker {r} launched {got}, not the shard modes "
                    f"{PHASE_L_LAUNCHES[name]}")
            run_counts[f"l {name} worker {r}"] = w[name]["launches"]
        say(f"[L] {name}: {len(a['blocks'])} blocks bit-identical (SHA-256), errors {b['errs']}"
            f", stop sweeps {b['sweeps'] or '-'}; launches a worker "
            f"{[{k: v for k, v in w[name]['launches'].items() if v} for w in each]}")
        ms = " / ".join(f"{w[name]['ms']:.3f}" for w in each)
        walls = " / ".join(f"{w[name]['wall_ms']:.1f}" for w in each)
        say(f"[L] {name}: {a['ms']:.3f} ms/cycle in one process (4 entries), {ms} ms/cycle in "
            f"the two workers (CUDA events; host wall {a['wall_ms']:.1f}, {walls} ms)")
        out.setdefault("ms", {})[name] = (a["ms"], [w[name]["ms"] for w in each])
    # the sharded layer's counters against the model's prediction
    spec = PHASE_L_SPECS["V(3,3) 4097² block"]
    prog = tmg.v_cycle(spec["n"], **spec["program"])
    cfg = tmg.SolverConfig(collect_node_stats=False, **spec["config"])
    model = sm.comm_report(prog, 4, spec["threshold"], 2, 2, cfg)
    require(model.counts() == multi["V(3,3) 4097² block"]["counts"],
            "[L] the 4097² block cycle's counters differ from utils.scaling_model's")
    say(f"[L] V(3,3) 4097² block: counters equal utils.scaling_model.comm_report's "
        f"({model.pieces} pieces, {model.pieces_xproc} between processes in "
        f"{model.messages} messages, {model.events_gather} gathers a cold cycle)")
    w = each[0]["overheads"]
    piece_s = one_over["exchange_s"] / one_over["pieces"]
    message_s = w["exchange_s"]
    say(f"[L] overheads (host s; gloo, staged through host memory, both processes on one "
        f"card): PIECE_S {piece_s:.3e} (one process, {one_over['pieces']} pieces an "
        f"exchange), MESSAGE_S {message_s:.3e} (an exchange of one message a process), "
        f"COLLECTIVE_S {w['psum_s']:.3e} (a psum); the one-process psum "
        f"{one_over['psum_s']:.3e}")
    say(f"[L] one process {t_one:.1f} s, two workers {t_multi:.1f} s with their start; "
        f"both processes share cuda:0: a correctness phase, no scaling is shown")
    out["overheads"] = (piece_s, message_s, w["psum_s"])
    return out


def phase_k(tmg, K, torch, run_counts):
    """K: the native runtime, the CSV writers, profiling, the checkpoint
    manager and the user examples on the card. Returns the figures for the
    [end] lines."""
    import tempfile
    from unittest import mock

    import numpy as np

    from multigrid_poisson_solver_tpu_torch import native
    from multigrid_poisson_solver_tpu_torch.refine import IterativeRefinementSolver
    from multigrid_poisson_solver_tpu_torch.schedule import parse_cycle_file, to_cycle_file
    from multigrid_poisson_solver_tpu_torch.utils import io as tio
    from multigrid_poisson_solver_tpu_torch.utils import profiling as tprof
    from multigrid_poisson_solver_tpu_torch.utils.checkpoint import SolverState
    from multigrid_poisson_solver_tpu_torch.utils.dist_checkpoint import DistCheckpointManager

    out = {}
    # -- the native runtime: built by the port into build/torch_native/ ----------
    t0 = time.perf_counter()
    require(native.available(), "[K] the native runtime library did not build or load")
    say(f"[K] native runtime {native.library_path().relative_to(ROOT)} loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    texts = {name: (ROOT / "schedules" / name).read_text()
             for name in ("test.txt", "Vcycle.txt", "VcycleTrigger.txt", "Wcycle.txt")}
    for label, prog in (("v_cycle 4097", tmg.v_cycle(4097, n_min=8, steps=3, coarse_option=0,
                                                     coarsen=3)),
                        ("w_cycle 257", tmg.w_cycle(257, n_min=8, steps=2)),
                        ("fmg 257", tmg.fmg(257, n_min=8, steps=2)),
                        ("v_cycle 256 coarsen=2", tmg.v_cycle(256, n_min=5, steps=-1,
                                                              coarsen=2))):
        texts[label] = to_cycle_file(prog)
    for label, text in texts.items():
        require(native.parse_cycle_native(text) == parse_cycle_file(text),
                f"[K] the native parser's program for {label} differs from the Python one")
    say(f"[K] native parser: {len(texts)} schedules equal to the Python parser's "
        f"({', '.join(texts)})")
    iterates = []
    for prog in (native.parse_cycle_native(texts["Vcycle.txt"]),
                 parse_cycle_file(texts["Vcycle.txt"])):
        cc = tmg.compile_program(prog, tmg.REFERENCE_PROBLEM, device="cuda")
        u, f = cc.init()
        iterates.append(cc(u, f)[0])
    require(torch.equal(*iterates), "[K] Vcycle.txt parsed natively runs another iterate")
    say("[K] compile_program of the natively parsed Vcycle.txt: iterate bit-identical to "
        "the Python-parsed program's")

    # -- CSV: a 4097² card solution through both writers --------------------------
    n = 4097
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False)
    cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
    u0, f = cold.init()
    u = cold(u0, f)[0]
    torch.cuda.synchronize()
    u64 = u.double().cpu().numpy()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        tio.write_solution_csv(u, tmp / "native.txt")
        t_native = time.perf_counter() - t0
        with mock.patch.object(native, "load", lambda: None):
            t0 = time.perf_counter()
            tio.write_solution_csv(u, tmp / "numpy.txt")
            t_numpy = time.perf_counter() - t0
        size = (tmp / "native.txt").stat().st_size
        require((tmp / "native.txt").read_bytes() == (tmp / "numpy.txt").read_bytes(),
                "[K] the native and numpy CSV writers wrote different files")
        t0 = time.perf_counter()
        back = tio.read_solution_csv(tmp / "native.txt")
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        fast = native.read_csv_native(tmp / "native.txt", n, n)
        t_read_native = time.perf_counter() - t0
        require(back.shape == (n, n) and np.array_equal(fast[::-1], back),
                "[K] read_csv_native and read_solution_csv read different values")
        d_round = float(np.abs(back - u64.round(6)).max())
        d_value = float(np.abs(back - u64).max())
        require(d_round <= 1e-12 and d_value <= 5.000001e-7,
                f"[K] the CSV holds other values than the solution to 6 decimals "
                f"(max|Δ| {d_round:.3e} to the rounded tensor, {d_value:.3e} to the tensor)")
        say(f"[K] CSV {n}² ({size / 1e6:.1f} MB): native writer {t_native:.3f} s, numpy writer "
            f"{t_numpy:.3f} s, byte-identical; read_solution_csv {t_read:.3f} s, "
            f"read_csv_native {t_read_native:.3f} s, equal; max|Δ| to the tensor rounded to 6 "
            f"decimals {d_round:.1e}")
        out["csv"] = (size, t_native, t_numpy)
        # the CLI writes its Sol_GPU_ file through the native writer
        sol = tmp / "Sol_GPU_Vcycle.txt"
        proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch", "1",
                               "schedules/Vcycle.txt", "--engine", "compiled", "--quiet",
                               "--output", str(sol)], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        require(proc.returncode == 0, f"[K] CLI failed:\n{proc.stdout}\n{proc.stderr}")
        match = re.search(r"Error = ([0-9.eE+-]+)", proc.stdout)
        require(match is not None and f"{float(match.group(1)):.6f}" == "0.000876",
                f"[K] CLI Vcycle.txt error is not the reference's 0.000876:\n{proc.stdout}")
        m = parse_cycle_file(texts["Vcycle.txt"]).n_max
        require(tio.read_solution_csv(sol).shape == (m, m), "[K] the CLI's Sol_GPU_ file")
        say(f"[K] CLI Vcycle.txt: Error = {match.group(1)}, {sol.name} written ({m}×{m})")

        # -- profiling: trace(), cost_report, DeviceTimer -----------------------------
        u = warm(u, f)[0]
        torch.cuda.synchronize()
        # late in this script every other torch.profiler session holds no
        # device event (PERF.md §7): bare sessions of the same cycle show
        # it, and trace() is held to whole or empty, never a partial trace
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        got = []
        for _ in range(4):
            K.reset_launch_counts()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                warm(u, f)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(tmp / "bare.json"))
            counts = {k: v for k, v in K.launches.items() if v}
            hits, n_kern, n_launch, lost, lag = trace_device_side(tmp / "bare.json", counts)
            got.append(f"{n_kern}/{n_launch} (lost {len(lost)}, lag {lag:.1f} µs)")
        say("[K] bare profiles: kernel events / launch calls " + ", ".join(got))
        whole = []
        for i in range(4):
            K.reset_launch_counts()
            with tprof.trace(tmp / "trace"):
                warm(u, f)
            counts = {k: v for k, v in K.launches.items() if v}
            hits, n_kern, n_launch, lost, lag = trace_device_side(tmp / "trace" / "trace.json",
                                                                  counts)
            say(f"[K] trace() {i}: {n_kern} kernel events of {n_launch} launch calls; calls "
                f"without a kernel event at places {lost[:12]}; the counted kernels' events "
                f"{hits}; least launch-to-start {lag:.1f} µs")
            require(n_kern == 0 or (all(hits.values()) and not lost),
                    f"[K] trace() {i} is partial: {n_kern} kernel events, launches lost at "
                    f"{lost[:12]}, the counted kernels' events {hits} (counted: {counts})")
            if n_kern:
                whole.append((hits, counts))
        require(len(whole) >= 2, f"[K] only {len(whole)} of 4 traces hold device events")
        hits, counts = whole[-1]
        run_counts["K trace"] = counts
        ours = sum(hits.values())
        require(ours >= sum(counts.values()),
                f"[K] the trace holds {ours} kernel events of the port's kernels, the counters "
                f"{sum(counts.values())} launches")
        say(f"[K] trace() of one V(3,3) at {n}²: {len(whole)} of 4 traces whole, the last "
            f"{ours} kernel events of the port's kernels; launch counters {counts}")
    ms = time_ms(lambda: warm(u, f), reps=5, rounds=3)
    cost = tprof.cost_report(program)
    timer = tprof.DeviceTimer()
    t_measure = timer.measure(warm, u, f)
    t_diff, spread = timer.measure_differential_median(warm, u, f, reps=4, k=3)
    say(f"[K] V(3,3) {n}²: cost_report roofline {cost.roofline_s * 1e3:.4f} ms "
        f"({cost.total_bytes / 1e6:.1f} MB at 3.35 TB/s); measured {ms:.4f} ms/cycle (CUDA "
        f"events), DeviceTimer.measure {t_measure * 1e3:.4f} ms, measure_differential_median "
        f"{t_diff * 1e3:.4f} ms ({spread[0] * 1e3:.4f}-{spread[1] * 1e3:.4f}); the cycle takes "
        f"{ms / (cost.roofline_s * 1e3):.2f}× the bytes bound")
    out["cost"] = (cost.roofline_s * 1e3, ms, t_measure * 1e3, t_diff * 1e3)
    del cold, warm, u0, u, f, iterates

    # -- checkpoints: tw32 to 1e-10 at 4097², stopped and resumed -----------------
    tol = 1e-10

    def solver(**kw):
        return IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n, state="tw32", device="cuda",
                                         **kw)

    full = solver().solve(tol)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        with DistCheckpointManager(Path(tmp), every=2) as mgr:
            cut = solver(max_cycles=5).solve(tol, checkpoints=mgr, checkpoint_chunk=1)
        t_cut = time.perf_counter() - t0
        mgr = DistCheckpointManager(Path(tmp), every=2)
        t0 = time.perf_counter()
        saved = mgr.latest()
        t_latest = time.perf_counter() - t0
        require(saved is not None and saved.cycle == 4 and cut.cycles == 5,
                f"[K] the cut solve's checkpoint: {None if saved is None else saved.cycle}")
        t0 = time.perf_counter()
        rep = solver().solve(tol, checkpoints=mgr, checkpoint_chunk=1)
        t_resumed = time.perf_counter() - t0
        words = (rep.u, rep.u_lo)
        # one save of the final state, timed: the async return, then the commit
        state = SolverState(u=rep.u, f=torch.zeros_like(rep.u), u_lo=rep.u_lo,
                            u_lo2=torch.zeros_like(rep.u), cycle=1000)
        t0 = time.perf_counter()
        mgr.maybe_save(state)
        t_async = time.perf_counter() - t0
        mgr.wait_until_finished()
        t_commit = time.perf_counter() - t0
        mgr.close()
    require(rep.cycles == full.cycles and rep.rel_residual == full.rel_residual
            and torch.equal(words[0], full.u) and torch.equal(words[1], full.u_lo),
            f"[K] the resumed solve ({rep.cycles} cycles, {rep.rel_residual:.6e}) is not the "
            f"uninterrupted one ({full.cycles}, {full.rel_residual:.6e}) bit for bit")
    say(f"[K] DistCheckpointManager tw32 to {tol:g} at {n}²: uninterrupted {full.cycles} "
        f"cycles ({full.wall_time_s * 1e3:.1f} ms); cut at 5 cycles with saves at 2 and 4 "
        f"({t_cut:.3f} s), latest() {t_latest:.3f} s, resumed from cycle 4 to {rep.cycles} "
        f"cycles ({t_resumed:.3f} s), words and residual bit-identical; one save of four "
        f"{n}² words: async return {t_async:.3f} s, committed {t_commit:.3f} s")
    out["ckpt"] = (t_async, t_commit, t_latest)
    del full, rep, words, state

    # -- the user examples, as subprocesses on the card ---------------------------
    t0 = time.perf_counter()
    names = sorted(p.name for p in (ROOT / "examples").glob("torch_0*.py"))
    require(len(names) == 5, f"[K] examples: {names}")
    procs = [(name, subprocess.Popen([sys.executable, f"examples/{name}"], cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for name in names]
    texts = {}
    for name, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"[K] {name} exited {proc.returncode}:\n{stdout}\n"
                f"{stderr[-3000:]}")
        texts[name] = stdout
        for line in stdout.strip().splitlines():
            say(f"[K]   {name}: {line}")
    match = re.search(r"\[compiled\]\s+Error = (\S+)", texts[names[0]])
    require(match is not None and f"{float(match.group(1)):.6f}" == "0.000876",
            f"[K] {names[0]} printed no Vcycle.txt Error of 0.000876")
    # 02-04: each printed residual finite and within the tolerance it asked for
    for name, tols in ((names[1], (1e-10, 1e-13)), (names[2], (1e-10,)), (names[3], (1e-9,))):
        res = [float(v) for v in re.findall(r"(?:rel residual|refined to|sharded refinement:) "
                                            r"(\S+)", texts[name])]
        require(len(res) == len(tols) and all(math.isfinite(r) and r <= t
                                              for r, t in zip(res, tols)),
                f"[K] {name}: residuals {res} against the tolerances {tols}")
    require("BIT-IDENTICAL" in texts[names[4]] and
            re.search(r"chain kernel launches [1-9]\d* \(chains on\), 0 \(off\)",
                      texts[names[4]]), f"[K] {names[4]}: the chains did not run or differ")
    say(f"[K] examples torch_01-05 exited 0 in {time.perf_counter() - t0:.1f} s (run together)")
    return out


def main():
    import torch

    # -- phase 0: the card ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch import cli
    from multigrid_poisson_solver_tpu_torch.ops import build
    from multigrid_poisson_solver_tpu_torch.ops import kernels as K
    from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
    from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    say(smi)
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the dense coarse solve must run in full fp32")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    say(f"[1] built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if ("Function properties" in line or "Used" in line or "spill" in line
                    or line.startswith("compiled ")):
                say("    " + line.strip())

    # -- phase 2: kernels against their twins ----------------------------------
    t0 = time.perf_counter()
    cmp = Compare()
    phase2(K, torch, cmp, tmg.REFERENCE_PROBLEM, tmg.GridSpec)
    phase2_3d(K3, torch, cmp)
    for k in SINGLE_DEVICE:
        say(f"[2] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
    for k in ("residual3", "jacobi", "jacobi_errs", "descend", "ascend"):
        require(cmp.bitwise[k], f"[2] {k}: not bit-identical to its twin")
    say(f"[2] done in {time.perf_counter() - t0:.1f} s "
        f"(tolerances: grids {U_RTOL:g}·max|twin|, errors {ERR_RTOL:g} relative)")

    # -- phase 3: the library path, 4097² V(3,3) ---------------------------------
    n = 4097
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    results, counts = {}, {}
    for kernels in ("auto", "torch"):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, kernels=kernels)
        cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                   warm=True)
        u0, f = cold.init()
        h = cold.finest_spec.h
        K.reset_launch_counts()
        u1, err = cold(u0, f)
        u = u1
        for _ in range(5):
            u, err = warm(u, f)
        torch.cuda.synchronize()
        counts[kernels] = dict(K.launches)
        r1 = float(relative_residual_norm(u1.double(), f.double(), h))
        r6 = float(relative_residual_norm(u.double(), f.double(), h))
        require(tuple(u.shape) == (n, n) and bool(torch.isfinite(u).all())
                and bool(torch.isfinite(err)), f"{kernels}: non-finite cycle output")
        ms = time_ms(lambda: warm(u, f), reps=5, rounds=3)
        results[kernels] = (ms, r1, r6, float(err), u1, u)
        say(f"[3] V(3,3) {n}² kernels={kernels}: {ms:.3f} ms/cycle, float64 rel. "
            f"residual {r1:.6e} after 1 cycle, {r6:.6e} after 6, last error {float(err):.6e}")
        if kernels == "auto":   # where the cycle's device time goes
            profile(f"V(3,3) {n}² per cycle", lambda: [warm(u, f) for _ in range(5)], per=5)
    (_, r1k, r6k, ek, u1k, u6k), (_, r1t, r6t, et, u1t, u6t) = (results["auto"],
                                                              results["torch"])
    for what, got, want in (("1 cycle", u1k, u1t), ("6 cycles", u6k, u6t)):
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[3] iterate after {what}: max|u_kernel − u_plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"kernel and plain iterates differ after {what}: "
                f"{diff:.3e} > {U_RTOL:g}·{scale:.3e}")
    require(abs(r1k - r1t) <= RES_RTOL * r1t and abs(r6k - r6t) <= RES_RTOL * r6t,
            "kernel and plain main paths disagree on the float64 residuals")
    lib_counts = counts["auto"]
    say(f"[3] launches over the kernel path's 6 cycles: {lib_counts}")
    require(not any(counts["torch"].values()), f"the plain path launched {counts['torch']}")
    # the same cycle with the chain kernels switched off, for comparison
    cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False)
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
    chain_root, K.CHAIN_MAX_ROOT = K.CHAIN_MAX_ROOT, 0
    ms_legs = time_ms(lambda: warm(u6k, f), reps=5, rounds=3)
    K.CHAIN_MAX_ROOT = chain_root
    say(f"[3] the same cycle with per-level legs instead of the chains: {ms_legs:.3f} ms/cycle")

    # -- phase 4: the CLI path ------------------------------------------------------
    run_counts = {"library": lib_counts}
    # the reference binary's printed errors (tests/test_reference_parity.py)
    for name, want in (("Vcycle.txt", "0.000876"), ("VcycleTrigger.txt", "0.000784")):
        argv = ["1", f"schedules/{name}", "--engine", "compiled", "--quiet", "--no-output"]
        proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch",
                               *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"CLI failed:\n{proc.stdout}\n{proc.stderr}")
        match = re.search(r"Error = ([0-9.eE+-]+)", proc.stdout)
        require(match is not None, f"CLI printed no error:\n{proc.stdout}")
        cli_err = float(match.group(1))
        say(f"[4] CLI {name}: Error = {match.group(1)} ({cli_err:.6f}; reference {want})")
        require(f"{cli_err:.6f}" == want, f"CLI error on {name} differs from the reference")
        K.reset_launch_counts()
        require(cli.main(argv + ["--device", "cuda"]) == 0, f"in-process CLI on {name} failed")
        run_counts[name] = dict(K.launches)
        say(f"[4] launches over the in-process CLI run on {name}: {run_counts[name]}")
    # the VcycleTrigger.txt solve on three routes of its trigger nodes (256²
    # down): kernel 8 as the engine routes them; kernel 9 on the same levels
    # (trigger_fits off); the loop of one-sweep kernel 1 launches with a host
    # read a sweep (both off, trigger_batch 1). Then where kernel 8's solve
    # spends its device time, beside the float64 Gauss-Seidel coarse solve.
    vprog = tmg.parse_cycle_path(ROOT / "schedules" / "VcycleTrigger.txt")
    no = (lambda n: False)
    routes = (("kernel 8 (as routed)", K.trigger_fits, K.trigger_stream_fits, "auto"),
              ("kernel 9 on kernel 8's levels", no, K.trigger_stream_fits, "auto"),
              ("one-sweep kernel 1 loop", no, no, 1))
    solves = {}
    for label, fits, stream_fits, batch in routes:
        saved = K.trigger_fits, K.trigger_stream_fits
        K.trigger_fits, K.trigger_stream_fits = fits, stream_fits
        try:
            cc = tmg.compile_program(vprog, tmg.REFERENCE_PROBLEM,
                                     tmg.SolverConfig(trigger_batch=batch), device="cuda")
            ui, fi = cc.init()
            K.reset_launch_counts()
            cc(ui, fi)
            launched = {k: v for k, v in K.launches.items() if v}
            say(f"[4] VcycleTrigger.txt compiled solve, {label}: launches {launched}")
            solves[label] = (cc, ui, fi, fits, stream_fits)
            if fits is not no:
                rows = profile("VcycleTrigger.txt compiled solve, kernel 8", lambda: cc(ui, fi))
                ms8, k8 = kernel_ms(rows, lambda key: "trigger_cluster_kernel" in key)
                say(f"[t] VcycleTrigger.txt: trigger_cluster_kernel {ms8:.3f} ms device in "
                    f"{k8:.0f} launches, of {sum(r[1] for r in rows):.3f} ms busy; the rest "
                    f"(the float64 GS's small kernels, the transfers) "
                    f"{sum(r[1] for r in rows) - ms8:.3f} ms")
        finally:
            K.trigger_fits, K.trigger_stream_fits = saved
    # host-bound solves: each route timed twice, in turns
    walls = {label: [] for label in solves}
    for _ in range(2):
        for label, (cc, ui, fi, fits, stream_fits) in solves.items():
            saved = K.trigger_fits, K.trigger_stream_fits
            K.trigger_fits, K.trigger_stream_fits = fits, stream_fits
            try:
                walls[label].append(time_ms(lambda: cc(ui, fi), reps=3, rounds=3))
            finally:
                K.trigger_fits, K.trigger_stream_fits = saved
    for label, ms in walls.items():
        say(f"[4] VcycleTrigger.txt compiled solve, {label}: "
            + " / ".join(f"{m:.3f}" for m in ms) + " ms (two turns)")

    # -- paths A, B, C ----------------------------------------------------------------
    phase_refine(tmg, K, torch, run_counts)
    phase_cli_tol(cli, K, run_counts)
    t0 = time.perf_counter()
    phase_refine_policy(tmg, K, torch, run_counts)
    say(f"[R] done in {time.perf_counter() - t0:.1f} s")

    # -- phase J: the bf16 modes of kernels 1-4 and the bf16 main paths ----------
    t0 = time.perf_counter()
    phase_bf16_kernels(K, torch, cmp)
    for k in PHASE_J:
        say(f"[J] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the bf16 twin: {cmp.bitwise[k]}")
        require(cmp.bitwise[k], f"[J] {k}: not bit-identical to its twin")
    say(f"[J] kernels done in {time.perf_counter() - t0:.1f} s (errors within "
        f"{BF16_ERR_RTOL:g} relative)")
    t0 = time.perf_counter()
    ms_bf16, refine_bf16 = phase_bf16(tmg, K, torch, run_counts)
    say(f"[J] paths done in {time.perf_counter() - t0:.1f} s")
    ms_trigger, trigger_levels, auto_levels = phase_trigger(tmg, K, torch, run_counts)
    ms_rbgs = phase_rbgs(tmg, K, torch, run_counts)
    ms_3d, runs_3d = phase_3d(tmg, K, torch, run_counts)
    ms_trigger3, trigger3_levels, auto3_levels, exact3_levels = phase_trigger3(
        tmg, K, K3, torch, run_counts)
    refine3_runs = phase_refine3(tmg, K, torch, run_counts, cli)

    # -- phase G: the 2-D multi-device path on a ring of shards on one card ------
    t0 = time.perf_counter()
    phase_g1(K, torch, cmp)
    for k in PHASE_G:
        say(f"[G1] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
    for k in ("jacobi_shard", "jacobi_errs_shard", "descend_shard", "ascend_shard"):
        require(cmp.bitwise[k], f"[G1] {k}: not bit-identical to its twin")
    say(f"[G1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_g2 = phase_g2(tmg, K, torch, run_counts)
    say(f"[G2] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_g3, g3_levels = phase_g3(tmg, K, torch, run_counts, auto_levels)
    phase_g3_rbgs(tmg, K, torch, run_counts)
    say(f"[G3] done in {time.perf_counter() - t0:.1f} s")

    # -- phase H: the 3-D multi-device path on a ring of z-shards on one card ----
    t0 = time.perf_counter()
    phase_h1(K3, torch, cmp)
    for k in PHASE_H:
        say(f"[H1] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
        require(cmp.bitwise[k], f"[H1] {k}: not bit-identical to its twin")
    say(f"[H1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_h2 = phase_h2(tmg, K, K3, torch, run_counts, runs_3d)
    say(f"[H2] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_h3, h3_runs = phase_h3(tmg, K, K3, torch, run_counts, {"auto": auto3_levels,
                                                               "batch 1": exact3_levels})
    say(f"[H3] done in {time.perf_counter() - t0:.1f} s")

    # -- phase I: the 3-D ring kernels on a ring of z-shards on one card ---------
    t0 = time.perf_counter()
    phase_i1(K3, torch, cmp)
    for k in PHASE_I:
        say(f"[I1] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
        require(cmp.bitwise[k], f"[I1] {k}: not bit-identical to its twin")
    say(f"[I1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_i2 = phase_i2(tmg, K, torch, run_counts, runs_3d)
    say(f"[I2] done in {time.perf_counter() - t0:.1f} s")
    del runs_3d
    t0 = time.perf_counter()
    ms_i3 = phase_i3(tmg, K, torch, run_counts, h3_runs)
    del h3_runs
    say(f"[I3] done in {time.perf_counter() - t0:.1f} s")
    for k, (_, _, run) in KERNELS.items():
        require(run_counts[run][k] > 0, f"the {run} run did not launch {k}")

    # -- timings at the main paths' shapes -------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rnd(m, scale=1.0):
        return torch.randn(m, m, generator=gen, device="cuda") * scale

    u, f, uc = rnd(n), rnd(n), rnd((n + 1) // 2)
    h = 1.0 / (n - 1)
    sizes = ladder(1025)
    hc = 1.0 / 1024
    uq, fq = rnd(1025), rnd(1025)
    c_args = (sizes, hc, (3,) * 7, 0.8, "sampling", True)
    u_list, f_list = K.chain_descend(uq, fq, *c_args)
    a_args = (u_list, [fq] + f_list[:-1], rnd(9), sizes, hc, (3,) * 7, 0.8, True, False)
    ut, ft = rnd(256), rnd(256)
    t_args = (1.0 / 255, 0.8, True, 0.0, 100)
    n8 = 8193
    h8 = 1.0 / (n8 - 1)
    w0, w1, w2, f8 = rnd(n8), rnd(n8, 1e-8), rnd(n8, 1e-16), rnd(n8)
    s_sweeps = 98   # 14 passes of 7 sweeps
    s_args = (h, 0.8, True, 0.0, s_sweeps)
    g2 = 4 * n * n            # bytes of one 4097² grid
    g8 = 4 * n8 * n8
    pts, pts8 = n * n, n8 * n8
    ladder_pts = sum(s * s for s in sizes)
    calls = {  # name -> (shape, kernel call, plain call, bytes, operations)
        "jacobi": (f"{n}², 3 sweeps + cpu error",
                   lambda: K.fused_jacobi_err(u, f, h, 3, 0.8, True),
                   lambda: K.fused_jacobi_err_torch(u, f, h, 3, 0.8, True),
                   3 * g2, (3 * SWEEP_OPS + ERR_OPS) * pts),
        "residual": (f"{n}²", lambda: K.residual(u, f, h), lambda: K.residual_torch(u, f, h),
                     3 * g2, RES_OPS * pts),
        "trigger": ("256², 100 sweeps (trigger 0), cpu error",
                    lambda: K.trigger_smooth(ut, ft, *t_args),
                    lambda: K.trigger_smooth_torch(ut, ft, *t_args),
                    3 * 4 * 256 * 256, 100 * (SWEEP_OPS + ERR_OPS) * 256 * 256),
        "descend": (f"{n}², 3 sweeps, sampling, cpu error",
                    lambda: K.fused_descend(u, f, h, 3, 0.8, "sampling", True, True),
                    lambda: K.fused_descend_torch(u, f, h, 3, 0.8, "sampling", True, True),
                    3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + RES_OPS) * pts),
        "ascend": (f"{n}², 3 sweeps, cpu error",
                   lambda: K.fused_ascend(u, f, uc, h, 3, 0.8, True, True),
                   lambda: K.fused_ascend_torch(u, f, uc, h, 3, 0.8, True, True),
                   3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + 3) * pts),
        "chain_descend": ("1025² → 9², 3 sweeps, sampling, from zero",
                          lambda: K.chain_descend(uq, fq, *c_args),
                          lambda: K.chain_descend_torch(uq, fq, *c_args),
                          4 * (1025 * 1025 + 2 * ladder_pts - 1025 * 1025 - 81),
                          (3 * SWEEP_OPS + RES_OPS) * (ladder_pts - 81)),
        "chain_ascend": ("9² → 1025², 3 sweeps",
                         lambda: K.chain_ascend(*a_args), lambda: K.chain_ascend_torch(*a_args),
                         4 * (2 * (ladder_pts - 81) + 81 + 1025 * 1025),
                         (3 * SWEEP_OPS + 3) * (ladder_pts - 81)),
        "residual_mw": (f"{n8}², tw32 (3 words)",
                        lambda: K.residual_tw(w0, w1, w2, f8, h8),
                        lambda: K.residual_tw_torch(w0, w1, w2, f8, h8),
                        5 * g8, RES_MW_OPS[3] * pts8),
        "jacobi_errs": (f"{n8}², 7 sweeps, cpu error of every iterate",
                        lambda: K.fused_jacobi_errs(f8, w0, h8, 7, 0.8, True),
                        lambda: K.fused_jacobi_errs_torch(f8, w0, h8, 7, 0.8, True),
                        3 * g8, 7 * (SWEEP_OPS + ERR_OPS) * pts8),
        "trigger_stream": (f"{n}², {s_sweeps} sweeps (trigger 0), cpu error",
                           lambda: K.trigger_smooth_stream(u, f, *s_args),
                           lambda: K.trigger_smooth_torch(u, f, *s_args),
                           3 * g2, s_sweeps * (SWEEP_OPS + ERR_OPS) * pts),
        "rbgs": (f"{n}², 2 sweeps + cpu error",
                 lambda: K.fused_rbgs_err(u, f, h, 2, True),
                 lambda: K.fused_rbgs_err_torch(u, f, h, 2, True),
                 3 * g2, (2 * RBGS_OPS + RBGS_ERR_OPS) * pts),
    }
    n3, w3 = 513, 6.0 / 7.0
    h3, m3 = 1.0 / (n3 - 1), (n3 + 1) // 2
    u3 = torch.randn(n3, n3, n3, generator=gen, device="cuda")
    f3 = torch.randn(n3, n3, n3, generator=gen, device="cuda")
    c3 = torch.randn(m3, m3, m3, generator=gen, device="cuda")
    c4 = torch.randn(n3, n3, n3, generator=gen, device="cuda") * 1e-8   # the lower words
    c5 = torch.randn(n3, n3, n3, generator=gen, device="cuda") * 1e-16
    g3, pts3 = 4 * n3 ** 3, n3 ** 3
    calls.update({
        "jacobi3": (f"{n3}³, 3 sweeps + clean error",
                    lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "clean"),
                    lambda: K3.fused_jacobi3_err_torch(u3, f3, h3, 3, w3, "clean"),
                    3 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS) * pts3),
        "descend3": (f"{n3}³, 3 sweeps, full weighting, clean error",
                     lambda: K3.fused_descend3(u3, f3, h3, 3, w3, want_err=True),
                     lambda: K3.fused_descend3_torch(u3, f3, h3, 3, w3, want_err=True),
                     3.125 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS + 1) * pts3 + FW3_OPS * m3 ** 3),
        "ascend3": (f"{n3}³, 3 sweeps",
                    lambda: K3.fused_ascend3(u3, f3, c3, h3, 3, w3),
                    lambda: K3.fused_ascend3_torch(u3, f3, c3, h3, 3, w3),
                    3.125 * g3, (3 * SWEEP3_OPS + PROLONG3_OPS) * pts3),
        "residual3": (f"{n3}³, negated", lambda: K3.residual3(u3, f3, h3, True),
                      lambda: K3.residual3_torch(u3, f3, h3, True), 3 * g3, RES3_OPS * pts3),
        "jacobi3_errs": (f"{n3}³, 7 sweeps, clean error of every iterate",
                         lambda: K3.fused_jacobi3_errs(u3, f3, h3, 7, w3, "clean"),
                         lambda: K3.fused_jacobi3_errs_torch(u3, f3, h3, 7, w3, "clean"),
                         3 * g3, 7 * (SWEEP3_OPS + EXTRA3_OPS) * pts3),
        "residual_mw3": (f"{n3}³, tw32 (3 words)",
                         lambda: K3.residual_tw3(u3, c4, c5, f3, h3),
                         lambda: K3.residual_tw3_torch(u3, c4, c5, f3, h3),
                         5 * g3, RES_MW3_OPS[3] * pts3),
    })
    # the bf16 modes at the fp32 rows' shapes (kernel 1 at 8193² with 8
    # sweeps, the rest at 4097²), bytes at 2 a state word
    ub, fb, ucb, u8b, f8b = (x.to(torch.bfloat16) for x in (u, f, uc, w0, f8))
    dsc16 = (h, 3, 0.8, "sampling", True, True)
    asc16 = (h, 3, 0.8, True, True)
    calls.update({
        "jacobi_bf16": (f"{n8}², 8 sweeps", lambda: K.fused_jacobi(u8b, f8b, h8, 8, 0.8),
                        lambda: K.fused_jacobi_torch(u8b, f8b, h8, 8, 0.8),
                        3 * g8 / 2, 8 * BF16_SWEEP_OPS * pts8),
        "residual_bf16": (f"{n}²", lambda: K.residual(ub, fb, h),
                          lambda: K.residual_torch(ub, fb, h), 3 * g2 / 2, BF16_RES_OPS * pts),
        "descend_bf16": (f"{n}², 3 sweeps, sampling, cpu error",
                         lambda: K.fused_descend(ub, fb, *dsc16),
                         lambda: K.fused_descend_torch(ub, fb, *dsc16), 3.25 * g2 / 2,
                         (3 * BF16_SWEEP_OPS + BF16_ERR_OPS + BF16_RES_OPS) * pts),
        "ascend_bf16": (f"{n}², 3 sweeps, cpu error", lambda: K.fused_ascend(ub, fb, ucb, *asc16),
                        lambda: K.fused_ascend_torch(ub, fb, ucb, *asc16), 3.25 * g2 / 2,
                        (3 * BF16_SWEEP_OPS + BF16_ERR_OPS + BF16_PROLONG_OPS) * pts),
    })
    # the whole-loop trigger kernels at their main-path sizes, a trigger of 0
    # and a fixed sweep count; a trigger loop's bound counts its sweeps'
    # operations and its grids once
    n16, n15, t_sweeps = 129, 257, 98   # 14 passes of 7 sweeps
    u16, f16 = (torch.randn(n16, n16, n16, generator=gen, device="cuda") for _ in range(2))
    u15, f15 = (torch.randn(n15, n15, n15, generator=gen, device="cuda") for _ in range(2))
    t16 = (1.0 / (n16 - 1), w3, "clean", 0.0, t_sweeps)
    t15 = (1.0 / (n15 - 1), w3, "clean", 0.0, t_sweeps)
    calls.update({
        "trigger3": (f"{n16}³, {t_sweeps} sweeps (trigger 0), clean error",
                     lambda: K3.trigger_smooth3(u16, f16, *t16),
                     lambda: K3.trigger_smooth3_torch(u16, f16, *t16),
                     3 * 4 * n16 ** 3, t_sweeps * (SWEEP3_OPS + EXTRA3_OPS) * n16 ** 3),
        "trigger3_stream": (f"{n15}³, {t_sweeps} sweeps (trigger 0), clean error",
                            lambda: K3.trigger_smooth3_stream(u15, f15, *t15),
                            lambda: K3.trigger_smooth3_torch(u15, f15, *t15),
                            3 * 4 * n15 ** 3, t_sweeps * (SWEEP3_OPS + EXTRA3_OPS) * n15 ** 3),
    })
    # the shard modes and the ring kernels at the sharded main paths' shapes:
    # a level split over a ring of 8 shards on the card; the shard modes
    # launched on every shard's window (the exchange done beforehand), the
    # ring kernels with their exchange inside
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    ring8 = ring_policies()["rows-8"]
    ch = KS.COARSE_HALO

    def ring_windows(level, a, b):
        lay = S.layout_of(ring8, level)
        xs, ys = S.shard(a, lay), S.shard(b, lay)
        ext = [(S.extend(xs, i, 0, KS.HALO, 0), S.extend(ys, i, 0, KS.HALO, 0))
               for i in range(len(lay.rows))]
        geos = [K.ShardGeo(level, r0, 0, r1 - r0, level, KS.HALO, 0) for r0, r1 in lay.rows]
        return lay, xs, ys, ext, geos

    lay2, us2, fs2, ext2, geo2 = ring_windows(n, u, f)
    _, _, _, ext8, geo8 = ring_windows(n8, f8, w0)
    cw2 = [S.window(uc, r0 // 2 - ch, (r1 + 1) // 2 + ch, -ch, (n + 1) // 2 + ch)
           for r0, r1 in lay2.rows]

    def shards(fn, ext, geos):
        return lambda: [fn(ue, fe, g) for (ue, fe), g in zip(ext, geos)]

    def both(fn, plain_fn, ext=ext2, geos=geo2):
        return shards(fn, ext, geos), shards(plain_fn, ext, geos)

    on8 = f"{n}² on 8 shards"
    calls.update({
        "jacobi_shard": (f"{on8}, 3 sweeps + cpu error",
                         *both(lambda ue, fe, g: K.fused_jacobi_shard(ue, fe, g, h, 3, 0.8, False,
                                                                      "cpu"),
                               lambda ue, fe, g: K.fused_jacobi_shard_torch(ue, fe, g, h, 3, 0.8,
                                                                            False, "cpu")),
                         3 * g2, (3 * SWEEP_OPS + ERR_OPS) * pts),
        "jacobi_errs_shard": (f"{n8}² on 8 shards, 7 sweeps, cpu error of every iterate",
                              *both(lambda ue, fe, g: K.fused_jacobi_errs_shard(ue, fe, g, h8, 7,
                                                                                0.8, "cpu"),
                                    lambda ue, fe, g: K.fused_jacobi_errs_shard_torch(
                                        ue, fe, g, h8, 7, 0.8, "cpu"), ext8, geo8),
                              3 * g8, 7 * (SWEEP_OPS + ERR_OPS) * pts8),
        "rbgs_shard": (f"{on8}, 2 rb-GS sweeps + cpu error",
                       *both(lambda ue, fe, g: K.fused_jacobi_shard(ue, fe, g, h, 2, 1.0, False,
                                                                    "cpu", "rbgs"),
                             lambda ue, fe, g: K.fused_jacobi_shard_torch(ue, fe, g, h, 2, 1.0,
                                                                          False, "cpu", "rbgs")),
                       3 * g2, (2 * RBGS_OPS + RBGS_ERR_OPS) * pts),
        "residual_shard": (f"{on8}, one batched launch",
                           lambda: K.residual_shards([e[0] for e in ext2], [e[1] for e in ext2],
                                                     geo2, h),
                           lambda: K.residual_shards_torch([e[0] for e in ext2],
                                                           [e[1] for e in ext2], geo2, h),
                           3 * g2, RES_OPS * pts),
        "descend_shard": (f"{on8}, 3 sweeps, sampling, cpu error",
                          *both(lambda ue, fe, g: K.fused_descend_shard(ue, fe, g, h, 3, 0.8,
                                                                        "sampling", "cpu"),
                                lambda ue, fe, g: K.fused_descend_shard_torch(
                                    ue, fe, g, h, 3, 0.8, "sampling", "cpu")),
                          3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + RES_OPS) * pts),
        "ascend_shard": (f"{on8}, 3 sweeps, cpu error",
                         lambda: [K.fused_ascend_shard(ue, fe, c, g.row0 // 2 - ch, -ch, g, h, 3,
                                                       0.8, "cpu")
                                  for (ue, fe), g, c in zip(ext2, geo2, cw2)],
                         lambda: [K.fused_ascend_shard_torch(ue, fe, c, g.row0 // 2 - ch, -ch, g,
                                                             h, 3, 0.8, "cpu")
                                  for (ue, fe), g, c in zip(ext2, geo2, cw2)],
                         3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + 3) * pts),
        "rdma_jacobi": (f"{on8}, 8 sweeps, the exchange inside",
                        lambda: rdma.rdma_jacobi(us2, fs2, h, 8, 0.8),
                        lambda: rdma.rdma_jacobi_torch(us2, fs2, h, 8, 0.8),
                        3 * g2, 8 * SWEEP_OPS * pts),
        "rdma_trigger": (f"{on8}, {s_sweeps} sweeps (trigger 0), cpu error",
                         lambda: rdma.rdma_trigger(us2, fs2, h, 0.8, True, 0.0, s_sweeps),
                         lambda: rdma.rdma_trigger_torch(us2, fs2, h, 0.8, True, 0.0, s_sweeps),
                         3 * g2, s_sweeps * (SWEEP_OPS + ERR_OPS) * pts),
    })
    # the 3-D shard modes at the sharded main paths' shapes: 513³ (257³ for
    # emit_residual, v_cycle3_sharded's odd-depth levels) on 8 z-shards of
    # the card, launched on every shard's windows (exchanged beforehand)
    zring = z_policy(8)

    def z_windows(level, ext, *vols):
        lay = S.layout_of(zring, level)
        geos = [K3.ShardGeo3(level, z0, z1 - z0, ext) for z0, z1 in lay.rows]
        return geos, [[S.planes(v, z0 - ext, z1 + ext) for v in vols] for z0, z1 in lay.rows]

    def on_shards(fn, geos, wins):
        return lambda: [fn(g, *w) for g, w in zip(geos, wins)]

    def both3(fn, plain_fn, geos, wins):
        return on_shards(fn, geos, wins), on_shards(plain_fn, geos, wins)

    geo3_3, win3_3 = z_windows(n3, 3, u3, f3)      # 3 sweeps, gpu error; residual; ascend
    geo3_5, win3_5 = z_windows(n3, 5, u3, f3)      # descend: 3 sweeps + −r + FW ring
    geo3_8, win3_8 = z_windows(n3, 8, u3, f3)      # 7 sweeps, clean error of each
    h15 = 1.0 / (n15 - 1)
    geo15, win15 = z_windows(n15, 3, f15)           # emit_residual from zero, 3 sweeps
    ext_c = KS3.ascend3_halo(3, False)[1]
    cwin3 = [S.planes(c3, g.z0 // 2 - ext_c, (g.z0 + g.nz + 1) // 2 + ext_c + 1) for g in geo3_3]
    pts15 = n15 ** 3
    zon8 = f"{n3}³ on 8 z-shards"
    calls.update({
        "jacobi3_shard": (f"{zon8}, 3 sweeps + gpu error",
                          *both3(lambda g, ue, fe: K3.fused_jacobi3_shard(ue, fe, g, h3, 3, w3,
                                                                          False, "gpu"),
                                 lambda g, ue, fe: K3.fused_jacobi3_shard_torch(ue, fe, g, h3, 3,
                                                                                w3, False, "gpu"),
                                 geo3_3, win3_3),
                          3 * g3, (3 * SWEEP3_OPS + GPU_ERR3_OPS) * pts3),
        "jacobi3_errs_shard": (f"{zon8}, 7 sweeps, clean error of every iterate",
                               *both3(lambda g, ue, fe: K3.fused_jacobi3_errs_shard(
                                   ue, fe, g, h3, 7, w3, "clean"),
                                   lambda g, ue, fe: K3.fused_jacobi3_errs_shard_torch(
                                       ue, fe, g, h3, 7, w3, "clean"), geo3_8, win3_8),
                               3 * g3, 7 * (SWEEP3_OPS + EXTRA3_OPS) * pts3),
        "jacobi3_residual": (f"{n15}³ on 8 z-shards, 3 sweeps from zero, negated residual",
                             *both3(lambda g, fe: K3.fused_jacobi3_residual_shard(
                                 None, fe, g, h15, 3, w3, True, True),
                                 lambda g, fe: K3.fused_jacobi3_residual_shard_torch(
                                     None, fe, g, h15, 3, w3, True, True), geo15, win15),
                             3 * 4 * pts15, (2 * SWEEP3_OPS + 3 + RES3_OPS) * pts15),
        "descend3_shard": (f"{zon8}, 3 sweeps, full weighting, clean error",
                           *both3(lambda g, ue, fe: K3.fused_descend3_shard(
                               ue, fe, g, h3, 3, w3, False, "full_weighting", True),
                               lambda g, ue, fe: K3.fused_descend3_shard_torch(
                                   ue, fe, g, h3, 3, w3, False, "full_weighting", True),
                               geo3_5, win3_5),
                           3.125 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS + 1) * pts3 + FW3_OPS * m3 ** 3),
        "ascend3_shard": (f"{zon8}, 3 sweeps",
                          lambda: [K3.fused_ascend3_shard(ue, fe, c, g.z0 // 2 - ext_c, g, h3, 3,
                                                          w3)
                                   for g, (ue, fe), c in zip(geo3_3, win3_3, cwin3)],
                          lambda: [K3.fused_ascend3_shard_torch(ue, fe, c, g.z0 // 2 - ext_c, g,
                                                                h3, 3, w3)
                                   for g, (ue, fe), c in zip(geo3_3, win3_3, cwin3)],
                          3.125 * g3, (3 * SWEEP3_OPS + PROLONG3_OPS) * pts3),
        "residual3_shard": (f"{zon8}, negated",
                            *both3(lambda g, ue, fe: K3.residual3_shard(ue, fe, g, h3, True),
                                   lambda g, ue, fe: K3.residual3_shard_torch(ue, fe, g, h3,
                                                                              True),
                                   geo3_3, win3_3),
                            3 * g3, RES3_OPS * pts3),
    })
    # the 3-D ring kernels at the sharded main paths' shapes: 513³ on 8
    # z-shards of the card (the trigger loop at 257³, its largest ring
    # level), the exchange inside the launch
    from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    zu3, zf3 = (S.shard(v, S.layout_of(zring, n3)) for v in (u3, f3))
    zc3 = S.shard(c3, R3.coarse_layout3(zf3))
    zu15, zf15 = (S.shard(v, S.layout_of(zring, n15)) for v in (u15, f15))
    d3 = (h3, 3, w3, False, "full_weighting", True)
    calls.update({
        "rdma_trigger3": (f"{n15}³ on 8 z-shards, {t_sweeps} sweeps (trigger 0), clean error",
                          lambda: R3.rdma_trigger3(zu15, zf15, *t15),
                          lambda: R3.rdma_trigger3_torch(zu15, zf15, *t15),
                          3 * 4 * n15 ** 3, t_sweeps * (SWEEP3_OPS + EXTRA3_OPS) * n15 ** 3),
        "rdma_jacobi3": (f"{zon8}, 3 sweeps + gpu error",
                         lambda: R3.rdma_jacobi3(zu3, zf3, h3, 3, w3, False, "gpu"),
                         lambda: R3.rdma_jacobi3_torch(zu3, zf3, h3, 3, w3, False, "gpu"),
                         3 * g3, (3 * SWEEP3_OPS + GPU_ERR3_OPS) * pts3),
        "rdma_descend3": (f"{zon8}, 3 sweeps, full weighting, clean error",
                          lambda: R3.rdma_descend3(zu3, zf3, *d3),
                          lambda: R3.rdma_descend3_torch(zu3, zf3, *d3),
                          3.125 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS + 1) * pts3 + FW3_OPS * m3 ** 3),
        "rdma_ascend3": (f"{zon8}, 3 sweeps",
                         lambda: R3.rdma_ascend3(zu3, zf3, zc3, h3, 3, w3),
                         lambda: R3.rdma_ascend3_torch(zu3, zf3, zc3, h3, 3, w3),
                         3.125 * g3, (3 * SWEEP3_OPS + PROLONG3_OPS) * pts3),
    })
    # what each ring kernel replaces on the same inputs: the PR 6 exchange
    # path (window copies, then a shard-mode launch per shard; the trigger
    # loop as one-sweep sharded error steps with a host read each)
    nl3, nl15 = zring.planes_per_device(n3), zring.planes_per_device(n15)
    exchange = {
        "rdma_trigger3": lambda: trigger_loop(lambda v: KS3.sharded_trigger_step3(
            v, zf15, t15[0], w3, "clean", nl15), zu15, 0.0, t_sweeps),
        "rdma_jacobi3": lambda: KS3.sharded_fused_jacobi3_err(zu3, zf3, h3, 3, w3, "gpu",
                                                              nl=nl3),
        "rdma_descend3": lambda: KS3.sharded_fused_descend3(zu3, zf3, *d3, nl3),
        "rdma_ascend3": lambda: KS3.sharded_fused_ascend3(zu3, zf3, zc3, h3, 3, w3, nl=nl3),
    }
    times = {}
    for k, (shape, kern, plain, nbytes, ops) in calls.items():
        bound_ms, bound_by = bound(nbytes, ops)
        times[k] = (time_ms(kern, reps=10), time_ms(plain, reps=2, rounds=3), bound_ms, bound_by)
        say(f"[t] {k} at {shape}: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    # the chains (kernels 6 and 7) at the library path's ladder in device µs a
    # call (graph_us), on the rule's split and on every forced one
    for split in (None, 257, 129, 65, 0):
        with K.forced_chain_split(split) if split is not None else contextlib.nullcontext():
            us_d = graph_us(calls["chain_descend"][1])
            us_a = graph_us(calls["chain_ascend"][1])
        say(f"[t] chains at 1025² → 9², 3 sweeps, split "
            f"{'the rule' if split is None else split}: chain_descend {us_d:.2f} µs device a "
            f"call, chain_ascend {us_a:.2f}")
    # kernel 8 on each route: 100 sweeps (cpu error, trigger 0; ms a call by
    # CUDA events) at 256² (the [t] row above), 129² and 65²; the 2-4-sweep
    # loops of path B's levels above the cluster (µs device a call, graph
    # replays); kernel 9's 2- and 3-sweep loops at 4097² (µs device a call)
    # and its 98-sweep loop (ms a call)
    for m in (256, 129, 65):
        um, fm = rnd(m), rnd(m)
        by = {}
        for route in ("cluster", "tile", "wave"):
            with K.forced_trigger_route(route):
                by[route] = time_ms(lambda: K.trigger_smooth(um, fm, 1 / (m - 1), 0.8, True, 0.0,
                                                             100), reps=5)
        b_ms, b_by = bound(3 * 4 * m * m, 100 * (SWEEP_OPS + ERR_OPS) * m * m)
        say(f"[t] trigger at {m}², 100 sweeps, cpu error, ms a call: "
            + ", ".join(f"{r} {v:.4f}" for r, v in by.items())
            + f" (the rule's: cluster); bound {b_ms:.4f} ({b_by})")
    for m in (513, 1025, 2049):
        um, fm = rnd(m), rnd(m)
        line = []
        for sweeps in (2, 3, 4):
            for route in ("tile", "wave"):
                with K.forced_trigger_route(route):
                    us = graph_us(lambda: K.trigger_smooth(um, fm, 1 / (m - 1), 0.8, True, 0.0,
                                                           sweeps))
                line.append(f"{sweeps} sweeps {route} {us:.2f}")
        say(f"[t] trigger at {m}², µs device a call (the rule's route: "
            f"{'wave' if m * m >= 3 << 19 else 'tile'}): " + ", ".join(line))
    line = []
    for sweeps in (2, 3):
        us = graph_us(lambda: K.trigger_smooth_stream(u, f, h, 0.8, True, 0.0, sweeps))
        line.append(f"{sweeps} sweeps {us:.2f} µs")
    ms = time_ms(lambda: K.trigger_smooth_stream(u, f, *s_args), reps=3)
    line.append(f"{s_sweeps} sweeps {ms:.4f} ms")
    say(f"[t] trigger_stream at {n}², device a call: " + ", ".join(line))
    # kernel 13's byte yardstick, the card's streaming rate at its 12 B a
    # point: one elementwise PyTorch op that reads the same two 513³ volumes
    # and writes a third
    o3 = torch.empty_like(u3)
    ms = time_ms(lambda: torch.add(u3, f3, out=o3), reps=10)
    say(f"[t] residual3 at {calls['residual3'][0]}: kernel {times['residual3'][0]:.4f} ms; "
        f"torch.add of the same two {n3}³ volumes {ms:.4f} ms ({3 * g3 / ms / 1e9:.3f} TB/s)")
    del o3
    def outputs(x):
        """The tensors of a call's result, in order (sharded grids gathered)."""
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, S.ShardedGrid):
            return [S.gather(x)]
        if isinstance(x, (tuple, list)):
            return [t for y in x for t in outputs(y)]
        return []

    for k in KERNELS:
        if k in SINGLE_DEVICE:
            continue
        shape, kern, plain = calls[k][:3]
        got, want = outputs(kern()), outputs(plain())
        require(len(got) == len(want), f"{k} at {shape}: {len(got)} outputs vs {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            what = f"at {shape}, output {i}"
            if not a.is_floating_point():
                require(bool(torch.equal(a, b)), f"{k} {what}: {a.tolist()} vs {b.tolist()}")
            elif a.dim() <= 1:
                for x, y in zip(a.reshape(-1), b.reshape(-1)):
                    if a.dtype == torch.bfloat16:   # a bf16 mode's error (phase J's bound)
                        require(abs(float(x) - float(y)) <= BF16_ERR_RTOL * abs(float(y)),
                                f"{k} {what}: error {float(x):.9e} vs twin {float(y):.9e}")
                    else:
                        cmp.scalar(k, what, x, y)
            else:
                cmp.grid(k, what, a, b)
        cmp.cases[k] += 1
        say(f"[t] {k} at {shape}: held against its plain version, max|Δ| so far "
            f"{cmp.max_abs[k]:.3e}, bit-identical: {cmp.bitwise[k]}")
    # the ring legs beside the shard modes alone on windows exchanged
    # beforehand (the same inputs; kernels 11 and 12's shard-mode rows)
    alone = {"rdma_descend3": "descend3_shard", "rdma_ascend3": "ascend3_shard"}
    for k, fn in exchange.items():
        ms = time_ms(fn, reps=1 if k == "rdma_trigger3" else 3)
        say(f"[t] {k} at {calls[k][0]}: ring kernel {times[k][0]:.4f} ms; the exchange path "
            f"(window copies and a shard-mode launch per shard) {ms:.4f} ms"
            + (f"; the shard mode alone {times[alone[k]][0]:.4f} ms" if k in alone else ""))
    # kernel 19 with the planned tiles against the loop it replaces, which
    # sums the same partials in the same order: the same iterate and error
    (gu, ge, gk), (ru, re_, rk) = calls["rdma_trigger3"][1](), exchange["rdma_trigger3"]()
    require(int(gk) == rk and bool(torch.equal(S.gather(gu), S.gather(ru)))
            and bool(torch.equal(ge, re_)), f"rdma_trigger3 at {calls['rdma_trigger3'][0]}: "
            f"differs from the loop of one-sweep sharded error steps")
    say(f"[t] rdma_trigger3 at {calls['rdma_trigger3'][0]}: bit for bit the loop of one-sweep "
        f"sharded error steps; {times['rdma_trigger3'][0] / t_sweeps:.4f} ms a sweep")
    del gu, ru
    # kernel 1's rb-GS mode (2 sweeps + cpu error, path C's pass) at 4097²,
    # 1025² and 257² and its shard pass on the 8 row shards of 4097² in
    # device µs a call (graph_us), and kernel 17 a sweep at 4097² on 8 shards
    # (CUDA events around 98-sweep calls of ~5 ms: a graph replay would reuse
    # its captured tags, which the flags have passed); the parent's beside
    for m in (4097, 1025, 257):
        um, fm, hm = rnd(m), rnd(m), 1.0 / (m - 1)
        us_ = graph_us(lambda: K.fused_rbgs_err(um, fm, hm, 2, True))
        say(f"[t] rbgs at {m}², 2 sweeps + cpu error: {us_:.2f} µs device a call "
            f"(tile-era parent {PARENT_RBGS_US[m]:.2f}); bound "
            f"{bound(12 * m * m, (2 * RBGS_OPS + RBGS_ERR_OPS) * m * m)[0] * 1e3:.2f} µs")
    del um, fm
    us_ = graph_us(calls["rbgs_shard"][1])
    say(f"[t] rbgs_shard at {calls['rbgs_shard'][0]}: {us_:.2f} µs device a pass of 8 launches "
        f"(tile-era parent {PARENT_RBGS_US['shard']:.2f}); bound "
        f"{times['rbgs_shard'][2] * 1e3:.2f} µs")
    say(f"[t] rdma_trigger (kernel 17) at {calls['rdma_trigger'][0]}: "
        f"{times['rdma_trigger'][0] / s_sweeps:.4f} ms a sweep (tile-era parent "
        f"{PARENT_RING_MS_A_SWEEP:.4f}); bound by operations a sweep "
        f"{(SWEEP_OPS + ERR_OPS) * pts / FP32 * 1e3:.4f} ms, 12 B a point unblocked "
        f"{12 * pts / HBM * 1e3:.4f} ms")
    # kernel 1 at the other main-path shapes: 8 sweeps at 8193² (phase 5's
    # launch), G3's pass (one sweep + cpu error on 8 row shards of 8193²) and
    # the small levels in device µs a call (graph_us); a torch.add of two
    # 8193² grids as the byte yardstick (12 B a point, as one fused pass)
    ms = time_ms(lambda: K.fused_jacobi(f8, w0, h8, 8, 0.8), reps=10)
    say(f"[t] jacobi at {n8}², 8 sweeps: {ms:.4f} ms; bound "
        f"{bound(3 * g8, 8 * SWEEP_OPS * pts8)[0]:.4f} ms")
    ms = time_ms(shards(lambda ue, fe, g: K.fused_jacobi_shard(ue, fe, g, h8, 1, 0.8, False,
                                                               "cpu"), ext8, geo8), reps=10)
    say(f"[t] jacobi_shard at {n8}² on 8 shards, 1 sweep + cpu error: {ms:.4f} ms; bound "
        f"{bound(3 * g8, (SWEEP_OPS + ERR_OPS) * pts8)[0]:.4f} ms")
    for m in (1025, 257, 65):
        um, fm = rnd(m), rnd(m)
        us_ = graph_us(lambda: K.fused_jacobi_err(um, fm, 1.0 / (m - 1), 3, 0.8, True))
        say(f"[t] jacobi at {m}², 3 sweeps + cpu error: {us_:.2f} µs device a call; bound "
            f"{bound(12 * m * m, (3 * SWEEP_OPS + ERR_OPS) * m * m)[0] * 1e3:.2f} µs")
    # the legs (kernels 3 and 4: 3 sweeps, sampling, cpu error) at the other
    # levels the main paths give them (V(3,3): 4097², 2049²; tw32: 8193² to
    # 2049²; G2 per shard: 512 x 4097 down), on the size rule's route: ms at
    # 8193², device µs a call at 2049², 1025² and 257² (graph_us); the
    # shard modes at 4097² on 8 row shards in device µs a pass of 8 launches
    # (graph_us: at 2049² and below the host's issue rate would set CUDA
    # events' time around eager calls)
    for m in (8193, 2049, 1025, 257):
        um, fm, cm, hm = rnd(m), rnd(m), rnd((m + 1) // 2), 1.0 / (m - 1)
        for name, fn, ops in (
                ("descend", lambda: K.fused_descend(um, fm, hm, 3, 0.8, "sampling", True, True),
                 3 * SWEEP_OPS + ERR_OPS + RES_OPS),
                ("ascend", lambda: K.fused_ascend(um, fm, cm, hm, 3, 0.8, True, True),
                 3 * SWEEP_OPS + ERR_OPS + 3)):
            b_ms = bound(3.25 * 4 * m * m, ops * m * m)[0]
            if m > 2049:
                say(f"[t] {name} at {m}², 3 sweeps, cpu error: {time_ms(fn, reps=10):.4f} ms; "
                    f"bound {b_ms:.4f} ms")
            else:
                say(f"[t] {name} at {m}², 3 sweeps, cpu error: {graph_us(fn):.2f} µs device a "
                    f"call; bound {b_ms * 1e3:.2f} µs")
        del um, fm, cm
    for k in ("descend_shard", "ascend_shard"):
        say(f"[t] {k} at {calls[k][0]}: {graph_us(calls[k][1]):.2f} µs device a pass of 8 "
            f"launches; bound {times[k][2] * 1e3:.2f} µs")
    o8 = torch.empty_like(f8)
    ms = time_ms(lambda: torch.add(f8, w0, out=o8), reps=10)
    say(f"[t] torch.add of two {n8}² grids: {ms:.4f} ms ({3 * g8 / ms / 1e9:.3f} TB/s)")
    del o8
    ms_ex = time_ms(lambda: KS.sharded_fused_jacobi(us2, fs2, h, 8, 0.8), reps=5)
    ms_un = time_ms(lambda: K.fused_jacobi(u, f, h, 8, 0.8), reps=5)
    say(f"[t] 8 sweeps at {n}²: unsharded kernel {ms_un:.4f} ms; 8 shards through the exchange "
        f"path (halo copies + a launch a shard) {ms_ex:.4f} ms; through the ring kernel "
        f"{times['rdma_jacobi'][0]:.4f} ms")
    ring18_rows(K, torch, rdma, S, ring8, u, f, h, us2, fs2, g2, pts)
    say(f"[t] ring trigger loop at {n}² on 8 shards: {times['rdma_trigger'][0] / s_sweeps:.4f} "
        f"ms per sweep; the unsharded streamed loop {times['trigger_stream'][0] / s_sweeps:.4f} "
        f"ms per sweep")
    say(f"[t] streamed trigger loop at {n}²: {times['trigger_stream'][0] / s_sweeps:.4f} ms "
        f"per sweep (12 B per point per sweep unblocked: "
        f"{12 * pts / HBM * 1e3:.4f} ms)")
    for k, m in (("trigger3", n16), ("trigger3_stream", n15)):
        say(f"[t] {k} at {m}³: {times[k][0] / t_sweeps:.4f} ms per sweep, plain "
            f"{times[k][1] / t_sweeps:.4f}; per-sweep bounds: operations "
            f"{(SWEEP3_OPS + EXTRA3_OPS) * m ** 3 / FP32 * 1e3:.4f} ms, 12 B per point unblocked "
            f"{12 * m ** 3 / HBM * 1e3:.4f} ms")
    # the column pass's other main-path shapes: kernel 16 at 65³ (the trigger
    # V-cycle's smallest kernel level) and the per-sweep pass with the gpu
    # metric's 8 sweeps
    n65 = 65
    u65, f65 = (torch.randn(n65, n65, n65, generator=gen, device="cuda") for _ in range(2))
    t65 = (1.0 / (n65 - 1), w3, "clean", 0.0, t_sweeps)
    ms = time_ms(lambda: K3.trigger_smooth3(u65, f65, *t65), reps=10)
    say(f"[t] trigger3 at {n65}³: {ms / t_sweeps:.4f} ms per sweep ({t_sweeps} sweeps, trigger "
        f"0, clean error); per-sweep bound: operations "
        f"{(SWEEP3_OPS + EXTRA3_OPS) * n65 ** 3 / FP32 * 1e3:.4f} ms")
    ms = time_ms(lambda: K3.fused_jacobi3_errs(u3, f3, h3, 8, w3, "gpu"), reps=3)
    say(f"[t] jacobi3_errs at {n3}³, 8 sweeps, gpu error of every iterate: {ms:.4f} ms, bound "
        f"{bound(3 * g3, 8 * (SWEEP3_OPS + GPU_ERR3_OPS) * pts3)[0]:.4f} ms; 7 sweeps, clean: "
        f"{times['jacobi3_errs'][0]:.4f} ms; on 8 z-shards, 7 sweeps, clean: "
        f"{times['jacobi3_errs_shard'][0]:.4f} ms")
    # kernel 19 a sweep at its other ring levels (129³, 65³ on 8 z-shards)
    for m, um, fm in ((n16, u16, f16), (n65, u65, f65)):
        zu, zf = (S.shard(v, S.layout_of(zring, m)) for v in (um, fm))
        tm = (1.0 / (m - 1), w3, "clean", 0.0, t_sweeps)
        ms = time_ms(lambda: R3.rdma_trigger3(zu, zf, *tm), reps=5)
        say(f"[t] rdma_trigger3 at {m}³ on 8 z-shards: {ms / t_sweeps:.4f} ms a sweep "
            f"({t_sweeps} sweeps, trigger 0, clean error); per-sweep bound: operations "
            f"{(SWEEP3_OPS + EXTRA3_OPS) * m ** 3 / FP32 * 1e3:.4f} ms")
    # kernel 10's one-sweep shard step, H3 "auto"'s exact loops at 129³ and
    # 65³ on 8 z-shards: the step (a sweep, a pass that reads its result and
    # the sum) and the lagged pass (one sweep that measures the iterate it
    # reads), on windows exchanged beforehand; device time a shard step
    # (graph_us)
    for m, um, fm in ((n16, u16, f16), (n65, u65, f65)):
        hm = 1.0 / (m - 1)
        for ext, label, fn in (
                (2, "one-sweep step (sweep + read-only pass)",
                 lambda g, ue, fe: K3.fused_jacobi3_shard(ue, fe, g, hm, 1, w3, False, "clean",
                                                          K3.err_plan3(g.nz))),
                (1, "lagged pass (one sweep)",
                 lambda g, ue, fe: K3.trigger_pass3_shard(ue, fe, g, hm, w3, "clean"))):
            geos, wins = z_windows(m, ext, um, fm)
            us_ = graph_us(lambda: [fn(g, *wi) for g, wi in zip(geos, wins)], per=len(geos))
            say(f"[t] jacobi3_shard at {m}³ on 8 z-shards, {label}, clean error: {us_:.2f} µs "
                f"device a shard step; bound {bound(12 * m ** 3 / 8, 0)[0] * 1e3:.2f} µs")
    # kernel 10's fixed modes at 513³, whole grid and on 8 z-shards
    geo3_4, win3_4 = z_windows(n3, 4, u3, f3)      # 3 sweeps + the clean error's read
    for label, fn, shard_fn, geos, wins in (
            ("3 sweeps + clean error", lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "clean"),
             lambda g, ue, fe: K3.fused_jacobi3_shard(ue, fe, g, h3, 3, w3, False, "clean"),
             geo3_4, win3_4),
            ("3 sweeps + gpu error", lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "gpu"),
             lambda g, ue, fe: K3.fused_jacobi3_shard(ue, fe, g, h3, 3, w3, False, "gpu"),
             geo3_3, win3_3),
            ("3 sweeps from zero", lambda: K3.fused_jacobi3(u3, f3, h3, 3, w3, True),
             lambda g, ue, fe: K3.fused_jacobi3_shard(None, fe, g, h3, 3, w3, True),
             geo3_3, win3_3)):
        ms_w = time_ms(fn, reps=5)
        ms_s = time_ms(on_shards(shard_fn, geos, wins), reps=5)
        say(f"[t] jacobi3 at {n3}³, {label}: {ms_w:.4f} ms whole grid, {ms_s:.4f} ms on 8 "
            f"z-shards; bound {bound(3 * g3, 0)[0]:.4f} ms")
    # kernel 10's emit_residual mode, 3 sweeps from zero and the negated
    # residual (v_cycle3_sharded's pass at its odd-depth levels): at 513³,
    # whole grid and on 8 z-shards (windows of 3 planes), in ms; at 129³ and
    # 65³ in device µs a call (graph_us). Bound: f read, u and r written
    # once (12 B a point, what the TPU's fused pass moves); the column
    # passes move 32 B a point on the whole grid (8 for the sweep that forms
    # the closed form from f at its loads, 12 for the last sweep, 12 for the
    # residual pass) and 36 on a shard (the last sweep writes the window the
    # residual pass reads and the owned planes)
    er_ops = 2 * SWEEP3_OPS + 3 + RES3_OPS
    ms_w = time_ms(lambda: K3.fused_jacobi3_residual(None, f3, h3, 3, w3, True, True), reps=5)
    ms_s = time_ms(on_shards(lambda g, ue, fe: K3.fused_jacobi3_residual_shard(
        None, fe, g, h3, 3, w3, True, True), geo3_3, win3_3), reps=5)
    say(f"[t] jacobi3_residual at {n3}³, 3 sweeps from zero, negated residual: {ms_w:.4f} ms "
        f"whole grid, {ms_s:.4f} ms on 8 z-shards; bound {bound(3 * g3, er_ops * pts3)[0]:.4f} "
        f"ms; the column passes' 32 and 36 B a point {32 * pts3 / HBM * 1e3:.4f} and "
        f"{36 * pts3 / HBM * 1e3:.4f} ms")
    for m, fm in ((n16, f16), (n65, f65)):
        hm = 1.0 / (m - 1)
        geos3, wins3 = z_windows(m, 3, fm)
        for label, fn in (
                ("whole grid", lambda: K3.fused_jacobi3_residual(None, fm, hm, 3, w3, True, True)),
                ("on 8 z-shards", lambda: [K3.fused_jacobi3_residual_shard(
                    None, fe, g, hm, 3, w3, True, True) for g, (fe,) in zip(geos3, wins3)])):
            us_ = graph_us(fn)
            b_us = bound(12 * m ** 3, er_ops * m ** 3)[0] * 1e3
            say(f"[t] jacobi3_residual at {m}³, 3 sweeps from zero, negated residual, {label}: "
                f"{us_:.2f} µs device a call; bound {b_us:.2f} µs")
        del geos3, wins3
    # the legs (kernels 11 and 12) at v_cycle3's smaller kernel levels (129³
    # and 65³, where the descent starts from zero), whole grid and on 8
    # z-shards, device µs a call (graph_us); kernel 11 from zero at 513³
    for m, um, fm in ((n16, u16, f16), (n65, u65, f65)):
        hm, mc = 1.0 / (m - 1), (m + 1) // 2
        cm = torch.randn(mc, mc, mc, generator=gen, device="cuda")
        geos5, wins5 = z_windows(m, 5, um, fm)      # 3 sweeps + −r + FW ring
        geos4, wins4 = z_windows(m, 4, um, fm)      # ascend3_halo(3, False)
        cwins = [S.planes(cm, g.z0 // 2 - ext_c, (g.z0 + g.nz + 1) // 2 + ext_c + 1)
                 for g in geos4]
        for label, fn in (
                ("descend3, 3 sweeps, full weighting, clean error",
                 lambda: K3.fused_descend3(um, fm, hm, 3, w3, want_err=True)),
                ("descend3, 3 sweeps from zero, full weighting",
                 lambda: K3.fused_descend3(um, fm, hm, 3, w3, True)),
                ("ascend3, 3 sweeps", lambda: K3.fused_ascend3(um, fm, cm, hm, 3, w3)),
                ("descend3_shard on 8 z-shards, 3 sweeps, full weighting, clean error",
                 lambda: [K3.fused_descend3_shard(ue, fe, g, hm, 3, w3, False, "full_weighting",
                                                  True) for g, (ue, fe) in zip(geos5, wins5)]),
                ("ascend3_shard on 8 z-shards, 3 sweeps",
                 lambda: [K3.fused_ascend3_shard(ue, fe, c, g.z0 // 2 - ext_c, g, hm, 3, w3)
                          for g, (ue, fe), c in zip(geos4, wins4, cwins)])):
            us_ = graph_us(fn)
            say(f"[t] {label} at {m}³: {us_:.2f} µs device a call; bound "
                f"{bound(12.5 * m ** 3, 0)[0] * 1e3:.2f} µs")
    # the ring kernels 20-22 at 129³ and 65³ on 8 z-shards, and kernel 20's
    # exchange path, device µs a call (graph_us: the same stream orders a
    # ring call's post before its passes, so replayed tags stay correct)
    for m, um, fm in ((n16, u16, f16), (n65, u65, f65)):
        hm, mc = 1.0 / (m - 1), (m + 1) // 2
        zum, zfm = (S.shard(v, S.layout_of(zring, m)) for v in (um, fm))
        zcm = S.shard(torch.randn(mc, mc, mc, generator=gen, device="cuda"),
                      R3.coarse_layout3(zfm))
        nlm = zring.planes_per_device(m)
        for label, fn, nbytes in (
                ("rdma_descend3, 3 sweeps, full weighting, clean error",
                 lambda: R3.rdma_descend3(zum, zfm, hm, 3, w3, False, "full_weighting", True),
                 12.5 * m ** 3),
                ("rdma_ascend3, 3 sweeps", lambda: R3.rdma_ascend3(zum, zfm, zcm, hm, 3, w3),
                 12.5 * m ** 3),
                ("rdma_jacobi3, 3 sweeps + gpu error",
                 lambda: R3.rdma_jacobi3(zum, zfm, hm, 3, w3, False, "gpu"), 12 * m ** 3),
                ("the exchange path it replaces (sharded_fused_jacobi3_err), 3 sweeps + gpu error",
                 lambda: KS3.sharded_fused_jacobi3_err(zum, zfm, hm, 3, w3, "gpu", nl=nlm),
                 12 * m ** 3)):
            us_ = graph_us(fn)
            say(f"[t] {label} at {m}³ on 8 z-shards: {us_:.2f} µs device a call; bound "
                f"{bound(nbytes, 0)[0] * 1e3:.2f} µs")
    # kernel 13 at its smaller main-path levels (the gpu metric's and the
    # trigger V-cycles' 257³ and 129³), whole grid and on 8 z-shards (windows
    # of one halo plane), device µs a call
    for m, um, fm in ((n15, u15, f15), (n16, u16, f16)):
        hm = 1.0 / (m - 1)
        geos1, wins1 = z_windows(m, 1, um, fm)
        for label, fn in (
                ("residual3, negated", lambda: K3.residual3(um, fm, hm, True)),
                ("residual3_shard on 8 z-shards, negated",
                 lambda: [K3.residual3_shard(ue, fe, g, hm, True)
                          for g, (ue, fe) in zip(geos1, wins1)])):
            us_ = graph_us(fn)
            say(f"[t] {label} at {m}³: {us_:.2f} µs device a call; bound "
                f"{bound(12 * m ** 3, RES3_OPS * m ** 3)[0] * 1e3:.2f} µs")
        del geos1, wins1
    ms = time_ms(lambda: K3.fused_descend3(u3, f3, h3, 3, w3, True), reps=5)
    say(f"[t] descend3 at {n3}³, 3 sweeps from zero, full weighting: {ms:.4f} ms; bound "
        f"{bound(8.5 * pts3, 0)[0]:.4f} ms (f read, u and the coarse grid written)")
    del u65, f65, geo3_4, win3_4

    # -- phase 5: smoother throughput at 8193² -------------------------------------
    u, f = rnd(n8), rnd(n8)
    dofs = (n8 - 2) ** 2 * 8
    # the timed launch's output, bit for bit the twin's
    require(bool(torch.equal(K.fused_jacobi(u, f, h8, 8, 0.8),
                             K.fused_jacobi_torch(u, f, h8, 8, 0.8))),
            f"[5] 8 sweeps at {n8}²: the kernel's iterate differs from the twin's")
    ms_k = time_ms(lambda: K.fused_jacobi(u, f, h8, 8, 0.8), reps=10)
    ms_p = time_ms(lambda: K.fused_jacobi_torch(u, f, h8, 8, 0.8), reps=2, rounds=3)
    say(f"[5] smoothing {n8}², 8 sweeps per launch: kernel {dofs / ms_k / 1e6:.2f} GDoF/s "
        f"({ms_k / 8:.4f} ms/sweep), plain {dofs / ms_p / 1e6:.2f} GDoF/s "
        f"({ms_p / 8:.4f} ms/sweep)")
    # -- phase K: the native runtime and the user-facing utilities -------------------
    t0 = time.perf_counter()
    k_out = phase_k(tmg, K, torch, run_counts)
    say(f"[K] done in {time.perf_counter() - t0:.1f} s")
    # -- phase L: the sharded cycles across processes ---------------------------------
    t0 = time.perf_counter()
    l_out = phase_l(tmg, K, torch, run_counts)
    say(f"[L] done in {time.perf_counter() - t0:.1f} s")

    say(f"[end] trigger V-cycle {n8}² wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_trigger.items()))
    say(f"[end] sweeps per level, batch 7: {trigger_levels}; auto: {auto_levels}")
    say(f"[end] rb-GS V(2,2) {n}² {ms_rbgs:.3f} ms/cycle")
    r513, w513 = refine_bf16["513 bf16"]
    r8, w8 = refine_bf16["8193 fp32"]
    say(f"[end] bf16 V(3,3) {n}² {ms_bf16['kernels']:.3f} ms/cycle (fp32 {ms_bf16['fp32']:.3f}); "
        f"tw32 to 1e-10 with bf16 inner cycles: 513² {r513.cycles} cycles, {w513:.1f} ms; "
        f"8193² relative residuals " + ", ".join(f"{r:.2e}" for r in refine_bf16["8193 bf16"])
        + f" (fp32 inner: {r8.cycles} cycles, {w8:.1f} ms)")
    say("[end] 3-D ms/cycle (kernels, plain): "
        + "; ".join(f"{tag} {a:.3f}, {b:.3f}" for tag, (a, b) in ms_3d.items()))
    say(f"[end] 3-D trigger V-cycle 513³ wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_trigger3.items()))
    say(f"[end] 3-D sweeps per level, batch 7: {trigger3_levels}; auto: {auto3_levels}; "
        f"exact: {exact3_levels}")
    say("[end] refine3 513³ tw32 to 1e-10 (cycles, wall ms): "
        + "; ".join(f"{k} {c}, {ms:.1f}" for k, (c, ms) in refine3_runs.items()))
    say("[end] G2 ms/cycle at 4097² on 8 shards of one card (no scaling: one card): "
        + "; ".join(f"{tag} {ms:.3f}" for tag, ms in ms_g2.items()))
    say("[end] G3 sharded trigger V-cycle 8193² wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_g3.items())
        + f"; sweeps per level, rdma auto: {g3_levels}")
    say("[end] H2 ms/cycle at 513³ on 8 z-shards of one card (no scaling: one card): "
        + "; ".join(f"{tag} {ms:.3f}" for tag, ms in ms_h2.items()))
    say("[end] H3 sharded 3-D trigger V-cycle 513³ wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_h3.items()))
    say("[end] I2 ms/cycle at 513³ on 8 z-shards of one card, halo rdma (H2's ppermute beside): "
        + "; ".join(f"{tag} {ms:.3f} ({ms_h2[tag + ' kernels']:.3f})"
                    for tag, ms in ms_i2.items()))
    say("[end] I3 sharded 3-D trigger V-cycle 513³ wall ms, halo rdma: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_i3.items()))
    size, t_native, t_numpy = k_out["csv"]
    roof, ms_cycle, ms_measure, ms_diff = k_out["cost"]
    say(f"[end] K: CSV {n}² ({size / 1e6:.1f} MB) native {t_native:.3f} s, numpy {t_numpy:.3f} "
        f"s; V(3,3) {n}² cost_report roofline {roof:.4f} ms vs {ms_cycle:.4f} ms/cycle (events), "
        f"DeviceTimer {ms_measure:.4f} / {ms_diff:.4f} ms; checkpoint save {k_out['ckpt'][0]:.3f}"
        f" s (commit {k_out['ckpt'][1]:.3f} s), latest() {k_out['ckpt'][2]:.3f} s")
    say("[end] L ms/cycle, one process on 4 entries vs two workers on 2 each (one card, no "
        "scaling): " + "; ".join(f"{name} {a:.3f} vs {' / '.join(f'{x:.3f}' for x in b)}"
                                 for name, (a, b) in l_out["ms"].items())
        + "; PIECE_S, MESSAGE_S, COLLECTIVE_S " + ", ".join(f"{x:.3e}" for x in l_out["overheads"]))
    say(f"[end] chip_smoke ran {time.perf_counter() - t_start:.0f} s")

    # no single PyTorch call computes any of these functions: library_ms is null
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": run_counts[run][k], "run": run, "max_abs_err": cmp.max_abs[k],
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": times[k][2],
         "bound_by": times[k][3], "library_ms": None}
        for k, (src, tpu, run) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
