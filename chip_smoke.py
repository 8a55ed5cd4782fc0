#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (stroke_prediction_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  Phases:

1. card name and power limit (nvidia-smi), torch / CUDA versions, kernel
   build (nvcc, from ops/csrc in this checkout) and its seconds;
2. kernel phase, tester shapes: the float32 K1 (conv forward, 3xTF32 on
   the tensor cores) against its plain PyTorch version and against a
   float64 conv at the ten U-Net 3^3 convs on a 68x168x168 volume plus one
   z-SAME / ELU / plane-table case, with its TFLOP/s, tile efficiency and
   the replaced CUDA-core kernel's recorded time per layer; kernel, plain
   and library times (CUDA events) and the least time the card could take
   (bound; for K1 both on the CUDA cores and in 3xTF32); K5, the whole EDT
   in two kernels (``edt_sites``), bit for bit against its plain version
   at the validation step's, the tester's and two larger masks and at edge
   cases, its device time per call (torch.profiler) beside the parent
   composition (the parent's scan, copies and sqrt around today's single
   pass) and the plain version, kernel A's time without its scan along D,
   and the single pass (``edt_parabola``) at the line shapes;
3. kernel phase, training shapes: at the ten convs of one training step
   (batch 6, 68x104x104 patch), in float32 and in bfloat16, K1 (on the
   tensor cores: bfloat16, and float32 in 3xTF32) and the backward
   kernels K2 (fused dx + dW; on the tensor cores, float32 in 3xTF32, at
   the layers its channel bound takes: L1, L2, L3, L10), K3 (dx) and K4
   (dW + db), both on the tensor cores, float32 in 3xTF32,
   against their plain versions, each at every layer whichever route the
   step takes there, K2 and K4 twice for bit-identical dW and db and K3
   twice for a bit-identical dx, the float32 K2 and K3 also against a
   float64 dgrad (and the float32 K2's dW and db, and the float32 K4's at
   the layers of its route, L1 and L4-L9, against a float64 wgrad); K2
   vs K3 + K4 per fused layer; K1 (both
   types) vs cuDNN's forward at every layer, K2 (both types) vs cuDNN's
   dgrad + wgrad per fused layer, K3 (both types) vs cuDNN's
   dgrad and K4 (both types) vs cuDNN's wgrad per layer of their route,
   each with its TFLOP/s and tile efficiency; a small 's' + ELU +
   plane-table case and an odd-channel (3 -> 4) one, forward (K1) and
   backward (the float32 K2, K3 and K4 against float64 there too), and
   K1, K3 and K4 at a wide 192 -> 64 layer (the Unet3D class default's
   L7), K3 there too twice and, in float32, K3 and K4 against float64;
   times as above, with cuDNN's forward and backward as the library
   yardsticks;
4. tester phase: the port's full-volume U-Net tester CLI on three
   synthetic 256x256x28 cases (resampled to 128x128x28, padded by 20 to
   68x168x168), channels 2 16 32 64 32 16 32 2 with seeded random weights
   and BN statistics; the launch counts of K1 and K5 in that run; finite
   outputs; one case re-run on the CPU (plain versions) and compared; its
   HD / ASSD on the card with the EDT's kernels and with its plain version;
   a torch.profiler trace of three more cases (device time by kernel), and
   the EDT's device time per case inside those cases, with its kernels and
   with the parent composition, beside the same masks' EDTs back to back,
   after an L2 flush and after an idle gap;
4b. CAE phase: the port's shape tester CLI (``cli.test_shape_reconstruction``,
   no ``--device``: the card) at the reference width (channels 1 16 24 32
   100 200 1, seeded weights, BN statistics the moments of each layer's
   input over three blobs so that the reconstructions follow the latent,
   written with ``save_cae_checkpoint``) on the three synthetic cases
   (28x128x128 masks); K1 and K5 launches per case; every K1 and
   edt_sites call of one case held on its own inputs against its plain
   version; the float32 K1 at each distinct layer of a case (recorded at
   the wrapper) against its plain version and a float64 conv, timed beside
   cuDNN with the bound, summed per case; a torch.profiler trace of its
   cases (device busy, K1's share); one case on the card against the CPU
   (latents and reconstructions, the measures); the curve tester CLI on
   one case; its three sweeps recorded as the case was (every call on its
   own inputs, then K1 at each distinct layer, N = 1 to 11); each sweep
   batched (timed) against the serial forwards, element by element and by
   the measures, its first and last step required to differ;
5. training phase: the port's training CLI at the reference width and
   patch in its default bfloat16 on eight full-size synthetic cases (six
   train, two validate, batch 6, three epochs, ``--profile``: its trace of
   the second epoch holds the ``train_step`` range and K1); the launch
   counts of K1-K5
   per step against the fused / split rule; finite losses, the artifacts,
   the best-valid model loaded and run; then 30 more training steps back
   to back (mean and spread of ms per step) and a torch.profiler trace of
   one step;
6. one float32 training step (batch 2, full width and patch) on the card
   and on the CPU from the same weights and crop: loss, every parameter
   gradient and the running statistics compared; the same step in float64
   on the CPU as a third witness of which side is further off; the same
   step in bfloat16 on the card against the CPU's bfloat16 step at the CAE
   bfloat16 step's limits (float64 the witness), with two controls (the
   entry conv's K4 output zeroed, the entry BN's gradients zeroed) that
   must fail the gradient limit.
7. CAE training phase: the port's CAE training CLI
   (``cli.train_shape_reconstruction``: no ``--device``, ``--dtype`` or
   ``--channelscae``, so the card, bfloat16 and channels 1 16 24 32 100 200
   1) on the eight cases' 28x128x128 masks (six train, two validate, batch
   4, three epochs); K1-K5 launches per training step, validation batch
   and visual forward against the route rule (45 / 15 / 27 / 30 K1 / K2 /
   K3 / K4 a step); finite losses, the artifacts, the best-valid
   ``_cae1.model`` in the CAE tester; every K1-K4 call of one training step
   in bfloat16 and in float32 held on its own inputs against its plain
   version (K2-K4 run twice, bit-identical); K1-K4 at each distinct layer
   of a step in both types beside plain and cuDNN's forward, dgrad and
   wgrad with the bound, summed per step; 10 bfloat16 steps back to back
   and a torch.profiler trace of one; one float32 and one bfloat16 step
   (batch 2, same weights, batch, flips and fields) on the card against
   the CPU, float32 also against a float64 CPU step.
8. CAE learners phase: the step learner's CLI
   (``cli.train_interpolationstep_after_reconstruction``) and phase 2's
   (``cli.train_shape_prediction --initbycae``) on phase 7's best-valid
   ``_cae1.model`` (the card, bfloat16, channels 1 16 24 32 100 200 1, the
   eight cases, batch 4, one epoch each); K1-K5 launches by route against
   :func:`learner_launches` (a frozen conv's backward is K3 alone: 45 K1 +
   6 K3 a step-learner step; 14 K1, 2 K2, 10 K3, 12 K4 in bfloat16 and 63
   K1 + 18 K3 in float32 a phase-2 step; 45 / 77 K1 and 6 edt_sites a
   validation batch); every K1-K4 and edt_sites call of one training step
   and one validation batch of each on its own inputs against plain,
   counted by kernel and type; the frozen parameters after the runs as
   ``_cae1.model``'s, the step learner's BN statistics moved,
   ``_cae2.model`` the phase-1 CAE byte for byte; K1-K4 per layer of a
   step beside cuDNN; 10 timed steps and a profile of one each; a float32
   step of each from its trained weights on the card against a float64 CPU
   step, with a control that must fail (the CPU's float32 step printed
   beside: the folded BN's kernel gradient can be ill-conditioned there); the
   three CAE learners' visual forward (ten
   reconstructions of one case) against one forward a step.
9. CTP CAE phase: the CTP-conditioned CAE's training CLI
   (``cli.train_shape_reconstruction_with_ctp``: the card, bfloat16, channels
   3 16 24 32 100 200 1, so the entry conv at C_in 3 on the mask, CBV and
   TTD, the images padded by 20 to 68x168x168) on the eight cases, batch
   4, two epochs; launches per step and validation batch; finite losses,
   the artifacts, the ``cae3d_ctp`` header; every K1-K4 and edt_sites call
   of one bfloat16 and one float32 step and of one validation batch against
   plain (K1 and K4 at C_in 3 among them); K1-K4 per layer beside cuDNN, the
   entry conv apart; 10 timed steps and a profile; one float32 step (batch
   2, seeded weights) card vs CPU at the STEP_* limits with two controls,
   the entry BN and entry kernel gradients against a float64 step (the
   plain versions, run on the card).
10. SDM phase: the SDM baseline tester's CLI (``cli.test_sdm_resampling``,
   the card) on three cases with the labels, one with the U-Net
   segmentations (``--groundtruth 0``) and one without the latent resample
   (``--downsample 0``): edt_sites launches per case, the results lines and
   the dumps; every edt_sites call of each case against plain; each case
   card vs CPU (thresholded reconstructions equal, DC / HD / ASSD within
   1e-6); ms a case to the measures and with the dumps; a case's device
   time and kernels, its edt_sites time against plain and the bound.
11. large U-Net phase (``large_unet_phase``, lines prefixed ``large
   unet``): the 4-scale U-Net (``LargeUnet3D``, kind ``large_unet3d``) at
   channels 2 32 64 128 256 128 64 32 32 2 with seeded weights.  The
   U-Net tester CLI on a ``large_unet3d`` checkpoint (BN statistics the
   moments of the cases' images) on three cases at ``--xyoriginal 264
   --padding 44 44 44`` (116x220x220 -> 28x132x132): 14 K1 and 4
   edt_sites a case, the dumps, every K1 / edt_sites call of a case
   against plain, K1 per layer against float64 and cuDNN, a case's dumps
   with each NIfTI codec, a 92^3 forward card vs CPU.  Training through
   ``UnetSegmentationLearner`` (bfloat16, batch 6, 116x124x124 patches, two
   epochs, ``log_throughput`` and ``profile_dir``): 14 / 0 / 13 / 14
   K1-K4 a step, the ``[throughput]`` line, the trace, every K1 / K3 / K4
   call of a step in both types against plain, per layer beside cuDNN, 20
   timed steps and a profile, a float32 step against float64 within twice
   the CPU's distance, and a float64 step card vs CPU at the STEP_* limits
   (``large_step_vs_cpu``).  The tester phases also read one dump each
   through the native and the pure-Python NIfTI codec.
12. data-parallel phase (``dp_phase``, lines prefixed ``dp``): (a) the
   training CLI at the reference width with ``--distributed --nprocs 1
   --procid 0`` over NCCL (the host path: the process-sharded loader and
   the prefetch) for two epochs between two plain CLI runs of the same
   seed: K1-K5 launches, its curves against the plain runs' spread, its
   files; (b) two ranks on the one card over gloo (``dp_rank``, started
   with ``torch.multiprocessing``), each one full-width training step on 3
   rows of a global batch of 6: float64 (the plain versions) against the
   one-process float64 step at DP_F64_REL, float32 and bfloat16 (K1-K4 on
   each rank, 10 / 3 / 6 / 7 a step) within DP_FACTOR times their
   one-process distance to float64 plus DP_FLOOR, a control with BN's
   moments per rank that must fail, the ranks' gradients equal, rank 1
   writing nothing, each rank's bfloat16 ms per step and its collectives'
   share; then every K1-K4 call of one step at a rank's batch of 3 in both
   types against plain, and per layer beside cuDNN.
13. CAE data-parallel phase (``cae_dp_phase``, lines prefixed ``cae dp``):
   (a) the phase-1 and phase-2 CLIs at the reference width (bfloat16,
   batch 4) with ``--distributed --nprocs 1 --procid 0`` over NCCL for one
   epoch each beside a plain run: K1-K5 launches by the route rule, the
   curves equal to the plain run's, the files; phase 2's plain run twice,
   bit for bit (curves and ``.model`` files); (b) two ranks on
   the one card over gloo (``cae_dp_rank``), each one full-width step of
   each learner (phase 1, the CTP CAE, step learning, phase 2) on 2 rows of
   a global batch of 4: float64 (the plain versions) against the
   one-process float64 step at DP_F64_REL, float32 and bfloat16 within
   DP_FACTOR times their one-process distance to float64 (the larger of
   the rows in their order and in the ranks': a float32 CAE step's
   distance depends on the order of its sums) plus DP_FLOOR, every K1-K4
   and edt_sites call of those two steps against plain, the
   per-rank BN control failing, the ranks' losses and gradients equal, rank
   1 writing nothing (phase 2's two ``.model`` files included), each rank's
   augmented rows its rows of one process's, each learner's bfloat16 ms per
   rank-step with its all_reduce calls and their share; then K1-K4 per
   layer of a phase-1 rank-step in both types beside cuDNN.
14. grouped CAE phase (``cae_grouped_phase``, lines prefixed ``cae
   grouped``), structure batching on (``STROKE_TPU_CAE_BATCH=1``: a
   branch's structures as one pass with grouped BN) at the reference width
   on 28x128x128 masks: (a) one phase-1 and one CTP training step (batch
   4) in bfloat16 and in float32, every K1-K4 call against plain (the
   entry conv's fused K2 at C_in 1 and 3, which the grouped affine's dx
   brings in), 13 / 5 / 8 / 8 K1-K4 a step (45 / 15 / 27 / 30 with the
   passes one structure each), the launches of an unrecorded step, K1-K4
   per layer of a bfloat16 step beside cuDNN (also at a rank's batch of 2)
   and the entry convs' K2 in both types; (b) at batch 2, the grouped
   float32 step and the sequential one against a grouped float64 CPU step
   (computed in the witnesses' pool from the phase's start) at the
   STEP_* limits, a control with the entry conv's dx dropped failing them;
   (c) a tester case and the curve case's sweeps, switch on against off:
   the measures, K1 launches, every call against plain; (d) two ranks on
   the one card over gloo, one float64 rank-step of each learner against
   the one-process grouped step at DP_F64_REL, the all_reduce calls a
   rank-step (59 / 59 / 42 / 35 on, 169 / 169 / 98 / 54 off) and ms per
   bfloat16 rank-step on (off: the CAE data-parallel phase's); (e)
   each learner's one-process bfloat16 ms per step, on and off, with
   device busy and kernels, and phase 1's and phase 2's with cuDNN's
   deterministic algorithms against any, 12 steps each, interleaved.

15. spatial phase (``spatial_phase``, lines prefixed ``spatial``): the H
   axis sharded over the ranks (the ``space`` mesh axis) on the reference
   U-Net, four ranks on the one card over gloo (``spatial_rank``), on the
   data-parallel phase's global batch of 6 (H 104): (a) a float32 and (b)
   a bfloat16 training step at {data: 2, space: 2} within DP_FACTOR times
   the one-process step's distance to float64 plus DP_FLOOR, a float64
   step at DP_F64_REL of the one-process float64 step and two float64
   controls that must fail it (the row exchanges' adjoint dropped, BN's
   count a rank's positions times the world); (c) the float32 eval forward
   at {data: 1, space: 4} against one process; (d) every K1-K4 call of
   each rank's float32 and bfloat16 step against plain, and K1-K4 per
   layer of rank 0's step beside cuDNN; (e) each rank's bfloat16 ms per
   rank-step with the shares of exchange_rows and all_reduce, the
   exchanges a step and their bytes beside an all-gather's, and its K1-K4
   launches.

16. spatial CAE phase (``spatial_cae_phase``, lines prefixed ``spatial
   cae``): the rest of the ``space`` axis, four ranks on the one card over
   gloo (``spatial_cae_rank``) on the CAE data-parallel phase's global
   batch of 4 (28x128x128; the CTP images padded to 68x168x168, each cut
   by its own block rule): (a) each of the four learners' float64, float32
   and bfloat16 rank-steps at {data: 2, space: 2}: float64 at
   SPATIAL_F64_REL of the one-process float64 step, float32 and bfloat16
   within DP_FACTOR times the one-process steps' distance to float64 plus
   DP_FLOOR, every K1-K4 and edt_sites call of the float32 and bfloat16
   rank-steps against plain and counted (45 / 15 / 27 / 30 a phase-1
   rank-step, as one process), phase 1's augmented float64 rank-step
   against one process's, and two float64 controls that must fail (the
   padded convs padding each rank's block; the elastic noise drawn over a
   rank's block of H); (b) eval_step on the CAE tester phase's calibrated
   CAE at {data: 1, space: 4}: float64 (HD bit for bit, Dice at
   DP_F64_REL, ASSD at DP_ASSD_REL of one process) and float32, every K1
   and edt_sites call against plain; (c) a float64 LargeUnet3D step at
   {2, 2} on 116x220x220 patches at DP_F64_REL of one process and a
   bfloat16 one under the data-parallel rule, launches as one process's;
   (d) each rank's phase-1 bfloat16 ms per rank-step with the shares of
   exchange_rows and all_reduce, the exchanges and their bytes beside an
   all-gather's, and K1-K4 per layer of rank 0's rank-step beside cuDNN;
   (e) K4's repeat check: the U-Net spatial rank-step of phase 15 and the
   phase-1 CAE rank-step three times each on every rank with every K4
   call's inputs and outputs hashed and compared, then K4 (bfloat16 and
   float32) 200 times at (3, 18, 19, 36, 32), where one rank-step's K4
   once gave two results on the same inputs, and K4 and K2 ten
   times at each of their rank-step shapes, their partials filled with NaN
   before each launch, bit-equal and finite.

17. graph phase (``graph_phase``, lines prefixed ``graph``): the learner's
   planned epoch, each single-process step captured into a CUDA graph after
   its first (eager) step and replayed (``STROKE_TPU_DEVICE_CACHE``, on by
   default; phases 5-16 run with it off, the eager loop, because they
   count and record each kernel's calls at its wrapper, which a replay
   does not call).  (a) the U-Net CLI (reference width, bfloat16, batch 6,
   ``--profile``) and the phase-1 CLI (reference width, bfloat16, batch 4,
   a loss factor from the first epoch on), three epochs across an lr
   milestone and the beta1 ramp, twice eagerly and once graphed: where the
   two eager runs are bit-equal the graphed run's curves JSON, ``.model``
   and ``.optim`` files equal theirs byte for byte, else its curves are
   within 1e-6 of theirs; its steps replayed; the trace of its second
   epoch holds the ``train_step`` ranges and K1; two controls that must
   fail: the learning rate kept a Python float (baked into the capture)
   and the learner's generator not registered with the graphs; (b) ms a
   training step graphed against eager, ten each in turns, by CUDA events
   and host clock, for the U-Net, phase 1 and the 4-scale U-Net, and from
   torch.profiler traces of three replayed and three eager steps, training
   and validation: the busy share and kernels a step, the K1-K5 kernels a
   step by kernel name, equal on both sides (K1 in training, K1 and K5 in
   validation), and the host's CUDA API calls that put work on
   the card, one graph launch and at most three calls in all a replayed
   training step; (c) the sync debug mode "error" over one
   eager run of each graphed learner's step body, training and validation;
   (d) the step learner, phase 2, the CTP CAE and phase 1 with structure
   batching, two epochs, one eager and one graphed run each, their curves
   within 1e-6.

The CPU witnesses of phases 6-9, 11 and 14 (their float32, bfloat16 and
float64 CPU steps) run in a pool of WITNESS_WORKERS processes started after
the kernel build; their checks run after the last phase (phase 14's within
it).

Prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises and exits non-zero.
"""

import contextlib
import copy
import filecmp
import json
import math
import os
import subprocess
import sys
import tempfile
import time

CHANNELS = (2, 16, 32, 64, 32, 16, 32, 2)
VOLUME_DHW = (68, 168, 168)          # 28 x 128 x 128 resampled, padded 20
PATCH_DHW = (68, 104, 104)           # the training patch, (W, H, D) reversed
TRAIN_BATCH = 6
FOLD = (0, 1, 2)
TRAIN_FOLD = tuple(range(8))         # 6 training + 2 validation cases
TIMED_STEPS = 30                     # training steps timed back to back
K1_TILE = (8, 16)                    # K1's tile (output plane), both types
K2_TILE = (9, 16)                    # K2's tile (input plane), both types
K3_TILE = (8, 16)                    # K3's tile (input plane), both types
K4_TILE = (9, 16)                    # K4's tile (output plane), both types
K1_TOL = dict(atol=1e-4, rtol=1e-4)  # sums of up to 27 * 96 terms, reordered
SLICE_ATOL = 1e-4                    # card vs CPU probabilities
# backward vs plain: float32 dx as K1; float32 dW / db sum up to 6 * 64 *
# 100 * 100 terms, so relative to the largest entry
DW_REL = 1e-4
# bfloat16 outputs (y, dx) vs the plain version on the same bfloat16
# inputs: both accumulate in float32 and round once to bfloat16, which may
# land one bfloat16 step (2^-8 of the value) apart
BF16_REL = 1e-2
# one float32 step, card vs CPU
STEP_LOSS_REL, STEP_GRAD_REL, STEP_STATS_ATOL = 1e-5, 1e-3, 1e-5

# the float32 K1, K2 and K3 vs a float64 conv / dgrad on the card, relative
# to max|ref|
F64_REL = 1e-5

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, bf16
# on the tensor cores (the peak for bfloat16 inputs), float32 products as
# 3xTF32 on the tensor cores (three TF32 products each: a third of the 495
# TFLOP/s TF32 rate), HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# the float32 kernels on the tensor cores in 3xTF32
TF32X3_KERNELS = ("K1", "K2", "K3", "K4")

# the replaced CUDA-core float32 K1 (conv3x3_fwd.cu) per tester layer, ms on
# an NVIDIA H100 80GB HBM3 at 700 W, as PERF.md records it
CUDA_CORE_K1_MS = (0.2999, 1.2408, 0.3213, 0.6674, 0.1473, 0.2092, 1.2190,
                   0.3116, 1.4042, 0.3530)


def bound_ms(ops, nbytes, dtype="float32"):
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_key(key, dname):
    """The PEAK_FLOPS entry of kernel ``key`` in storage type ``dname``."""
    return "tf32x3" if dname == "float32" and key in TF32X3_KERNELS else dname


def rel_err(got, ref):
    """max |got - ref| / max |ref|, in float32."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


# The CPU witnesses (the earlier phases' float32 / bfloat16 / float64 CPU
# steps that a card step is held to) run in a pool of processes started at
# the script's beginning, so that they overlap the card's phases: a witness
# function submits its CPU sides there (:func:`witness`) when their inputs
# exist, computes its card sides, and returns a :class:`Deferred` whose
# comparisons run when the script resolves it, after the last phase.  The
# pool keeps the host's other cores for the card's phases.
WITNESS_WORKERS, WITNESS_THREADS = 2, 2
_WITNESS_POOL = []


def _witness_init():
    import torch

    torch.set_num_threads(WITNESS_THREADS)


def start_witnesses():
    """The witnesses' process pool (spawned processes: they import this
    script again, not its main)."""
    import concurrent.futures
    import multiprocessing

    _WITNESS_POOL.append(concurrent.futures.ProcessPoolExecutor(
        WITNESS_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_witness_init))


def stop_witnesses():
    """Stop the pool's processes, whatever they are running."""
    for pool in _WITNESS_POOL:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.kill()
        pool.shutdown(wait=False, cancel_futures=True)
    _WITNESS_POOL.clear()


def _run_witness(name, args):
    import torch

    return globals()[name](torch, *args)


def witness(fn, *args):
    """``fn(torch, *args)`` (a module-level function) in the witnesses'
    pool -> a future of its result; at once where no pool runs."""
    import concurrent.futures

    if _WITNESS_POOL:
        return _WITNESS_POOL[0].submit(_run_witness, fn.__name__, args)
    import torch

    done = concurrent.futures.Future()
    done.set_result(fn(torch, *args))
    return done


class Deferred:
    """A check that waits for its CPU witnesses: ``finish()`` runs at
    :meth:`resolve` (the script's end, :func:`resolve_witnesses`), and the
    deferred value formats and indexes as its result."""

    pending = []

    def __init__(self, finish):
        self._finish, self._done, self._value = finish, False, None
        Deferred.pending.append(self)

    def resolve(self):
        if not self._done:
            self._value, self._done = self._finish(), True
        return self._value

    def __getitem__(self, key):
        return self.resolve()[key]

    def __format__(self, spec):
        return format(self.resolve(), spec)


def resolve_witnesses(torch):
    """Every deferred witness check, in the order the phases made them."""
    for d in Deferred.pending:
        d.resolve()


def learner_stub(learner):
    """A picklable stand-in for ``learner``'s ``make_dto`` and ``loss``: an
    instance of its class with the attributes those read."""
    stub = type(learner).__new__(type(learner))
    stub.__dict__.update({k: v for k, v in learner.__dict__.items()
                          if k in ("_norm_hours", "_inputs_from_images",
                                   "_label_weights")})
    return stub


def tile_efficiency(plane, tile):
    """The real share of a (rows, columns) plane cut into ``tile``s."""
    (ph, pw), (th, tw) = plane, tile
    return ph * pw / (-(-ph // th) * th * -(-pw // tw) * tw)


def all_wrappers():
    from stroke_prediction_tpu_torch.ops.conv3x3 import KERNEL_WRAPPERS
    from stroke_prediction_tpu_torch.ops.edt import edt_parabola, edt_sites
    return KERNEL_WRAPPERS + (edt_sites, edt_parabola)


def reset_launches():
    for fn in all_wrappers():
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in all_wrappers()}


def yardstick_ms(torch, fn):
    """:func:`cuda_ms` of a plain version or a library call, its warm-up
    call timed too: over 5 calls, or 2 where that call took longer than
    YARDSTICK_SLOW_MS."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = 2 if start.elapsed_time(end) > YARDSTICK_SLOW_MS else 5
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` calls, timed with CUDA events after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def unet_conv_shapes(dhw, channels):
    """(input D, H, W, C_in, C_out) of the U-Net's ten 3^3 convs."""
    c_in, b1, b2, b3, b4, b5, _, _ = channels
    shapes = []

    def block(s, ci, co):
        shapes.append((*s, ci, co))
        s = tuple(v - 2 for v in s)
        shapes.append((*s, co, co))
        return tuple(v - 2 for v in s)

    r1 = block(dhw, c_in, b1)
    r2 = block(tuple(v // 2 for v in r1), b1, b2)
    r3 = block(tuple(v // 2 for v in r2), b2, b3)
    r4 = block(tuple(2 * v for v in r3), b3 + b2, b4)
    block(tuple(2 * v for v in r4), b4 + b1, b5)
    return shapes


def kernel_phase(torch):
    import torch.nn.functional as F

    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, fold_bn_zsame)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    k1 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
              bound_ms_cuda_cores=0.0, max_abs_err=0.0, max_rel_err_f64=0.0,
              ops=0.0, bytes=0.0)
    print("K1 conv3x3_fwd per layer (batch 1, float32, 'v', LeakyReLU 0.01; "
          "3xTF32 on the tensor cores; err vs plain max|y - plain|, vs f64 "
          "max|y - ref64| / max|ref64|; bound CUDA cores / 3xTF32):")
    for i, (d, h, w, ci, co) in enumerate(
            unet_conv_shapes(VOLUME_DHW, CHANNELS), 1):
        x = uniform((1, d, h, w, ci), -1.0, 1.0)
        bnd = (27 * ci) ** -0.5
        k = uniform((3, 3, 3, ci, co), -bnd, bnd)
        b = uniform((co,), -bnd, bnd)
        y = conv3x3(x, k, b, "leaky_relu", 0.01)
        ref = conv3x3_plain(x, k, b, "leaky_relu", 0.01)
        ref64 = conv3x3_plain(x.double(), k.double(), b.double(),
                              "leaky_relu", 0.01)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        torch.testing.assert_close(y, ref, **K1_TOL)
        f64 = rel_err(y.double(), ref64)
        plain_f64 = rel_err(ref.double(), ref64)
        if f64 > F64_REL:
            raise AssertionError(f"K1 L{i} float32: {f64:.3e} of max|ref| "
                                 f"off the float64 conv")
        del ref64
        w_lib = k.permute(4, 3, 0, 1, 2).contiguous()
        x_lib = x.permute(0, 4, 1, 2, 3)                 # channels-last view
        iters = 10
        ms = cuda_ms(torch, lambda: conv3x3(x, k, b, "leaky_relu", 0.01),
                     iters)
        plain = cuda_ms(torch, lambda: conv3x3_plain(x, k, b, "leaky_relu",
                                                     0.01), iters)
        lib = cuda_ms(torch, lambda: F.conv3d(x_lib, w_lib, b), iters)
        ops = 2.0 * 27 * ci * co * (d - 2) * (h - 2) * (w - 2)
        nbytes = 4.0 * (x.numel() + k.numel() + b.numel() + y.numel())
        b_cc, by_cc = bound_ms(ops, nbytes)
        bms, by = bound_ms(ops, nbytes, "tf32x3")
        print(f"  L{i:<2} in {d}x{h}x{w} {ci:>2}->{co:<2} {ops / 1e9:6.2f} "
              f"GFLOP  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
              f"tile eff. {tile_efficiency((h - 2, w - 2), K1_TILE):.3f})  "
              f"CUDA-core K1 {CUDA_CORE_K1_MS[i - 1]:.4f} ms (recorded)  "
              f"plain {plain:.4f} ms  cuDNN {lib:.4f} ms  bound "
              f"{b_cc:.4f} ({by_cc[0]}) / {bms:.4f} ({by[0]}) ms  err vs "
              f"plain {err:.3e}, vs f64 {f64:.3e} (plain f32 vs f64 "
              f"{plain_f64:.3e})")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms), ("bound_ms_cuda_cores", b_cc),
                       ("ops", ops), ("bytes", nbytes)):
            k1[key] += v
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["max_rel_err_f64"] = max(k1["max_rel_err_f64"], f64)
        del x, k, b, y, ref, x_lib, w_lib
    k1["bound_by"] = bound_ms(k1["ops"], k1["bytes"], "tf32x3")[1]
    print(f"  sum of the 10 layers: {k1['ops'] / 1e9:.2f} GFLOP  kernel "
          f"{k1['ms']:.4f} ms ({k1['ops'] / k1['ms'] / 1e9:.1f} TFLOP/s)  "
          f"CUDA-core K1 {sum(CUDA_CORE_K1_MS):.4f} ms (recorded)  plain "
          f"{k1['plain_ms']:.4f} ms  cuDNN {k1['library_ms']:.4f} ms  bound "
          f"CUDA cores {k1['bound_ms_cuda_cores']:.4f} ms / 3xTF32 "
          f"{k1['bound_ms']:.4f} ms  max err vs f64 "
          f"{k1['max_rel_err_f64']:.3e} of max|ref|")

    # z-SAME + ELU + per-plane bias table (the CAE encoder's form)
    x = uniform((1, 12, 20, 22, 8), -1.0, 1.0)
    k = uniform((3, 3, 3, 8, 16), -0.1, 0.1)
    k2, table = fold_bn_zsame(k, uniform((16,), -0.1, 0.1),
                              uniform((8,), 0.5, 1.5),
                              uniform((8,), -0.5, 0.5), 12)
    y = conv3x3(x, k2.contiguous(), table, "elu", 1.0, "s")
    ref = conv3x3_plain(x, k2, table, "elu", 1.0, "s")
    torch.cuda.synchronize()
    err_s = float((y - ref).abs().max())
    torch.testing.assert_close(y, ref, **K1_TOL)
    print(f"K1 's' + ELU + plane table (1, 12, 20, 22, 8->16): max|err| "
          f"{err_s:.3e}")
    k1["max_abs_err"] = max(k1["max_abs_err"], err_s)

    return k1


# K5, the whole EDT per call: the validation step's (2, 28, 64, 64) and
# the tester's (1, 28, 128, 128) surface masks, a 168^2 plane at the
# tester's padded depth, a 256^2 plane (the reference's volumes before
# the 0.5 in-plane resample), and a CAE training validation batch's masks
EDT_SHAPES = ((2, 28, 64, 64), (1, 28, 128, 128), (1, 68, 168, 168),
              (1, 28, 256, 256), (2, 28, 128, 128))
EDT_VALID, EDT_TESTER, EDT_CAE_VALID = (EDT_SHAPES[0], EDT_SHAPES[1],
                                        EDT_SHAPES[4])
EDT_PER_STEP = 4       # EDTs per validation step and per tester case
EDT_KERNELS = ("edt_scan_d_pass_h_kernel", "edt_pass_w_kernel")
EDT_STRIP = 32         # kernel A's w columns a block (kStrip)


# Operations of an exact O(n) lower envelope, counted at the float32 rate:
# one parabola pass pushes each element once and pops it at most once, so
# at most two intersection tests of 6 operations each (every f is an
# integer square or 1e12: the tests compare exactly by integer
# cross-multiplication), two fill compares and f + (i - v)^2 in 3, 17 an
# element; the whole EDT adds the two-sided scan along D (a select each
# way, the nearer side, its square, the clamp: 6) and the sqrt, 41 a voxel.
ENVELOPE_PASS_OPS = 17
EDT_OPS_PER_VOXEL = 6 + 2 * ENVELOPE_PASS_OPS + 1


def edt_bound(shape):
    """Least ms of one EDT: the larger of its bytes, 5 a voxel (the mask
    in, the distance out), and an exact O(n) envelope's operations
    (EDT_OPS_PER_VOXEL).  The (H + W) candidates a voxel of the kernels'
    brute-force min-plus are their choice, not the function's need."""
    n, d, h, w = shape
    voxels = n * d * h * w
    return bound_ms(EDT_OPS_PER_VOXEL * voxels, 5.0 * voxels)


# torch.profiler sessions on the card's machine now and then record no
# device time: three times in one run of this script on an NVIDIA H100
# 80GB HBM3, each once, twice in a row for one SDM call in another, and
# four times in a row for one SDM call in a third
PROFILE_ATTEMPTS = 8


def profiled(torch, run, what):
    """``run()`` under torch.profiler (CPU and CUDA activity), then
    synchronized; run and traced again, up to PROFILE_ATTEMPTS sessions in
    all, while the trace holds no device time -> the profiler (its trace
    may still hold no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA and e.self_device_time_total
               for e in prof.key_averages()):
            break
        print(f"{what}: no device time in the trace"
              + (", profiling again" if attempt + 1 < PROFILE_ATTEMPTS
                 else ""))
        time.sleep(0.5)
    return prof


# torch.cuda._sleep cycles of the spin kernel that opens a counted trace
# (~1 ms at the card's clock)
LEAD_CYCLES = 2_000_000


def lead_in(torch):
    """One spin kernel (``torch.cuda._sleep``, named like EDT_MARK) at the
    start of a traced region, left out of its counts: the kernels after it
    start about a millisecond into the trace.  A trace on the card's
    machine loses the kernels that run in its first moments (seen in every
    retrace: the first 4 of 10 ``edt_sites`` calls, the first K1 of an
    eager validation step)."""
    torch.cuda._sleep(LEAD_CYCLES)


def device_ms(torch, fn, reps, events=False, expect=None):
    """Device time per call and kernels per call, from the kernels' device
    time in a torch.profiler trace of ``reps`` calls after a warm-up call,
    and {kernel name: device ms per call}.  ``events``: where no trace
    holds device time, the calls' time between CUDA events instead, with
    the kernels not measured (nan, {}).  A trace on the card's machine
    now and then lacks kernel events (seen: 19 of 20 calls' kernel A of
    ``edt_sites``; 38 of its 40 events; 11 of 40; 5 of 10 calls' each):
    a kernel seen in fewer calls than were made, or a count a call other
    than ``expect``, is traced again (up to PROFILE_ATTEMPTS traces); in
    the last trace a kernel seen in at least half the calls counts
    floor(count / reps + 1/2) launches a call, each at its mean time in
    the trace, and the shortfall is printed."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        prof = profiled(torch, lambda: (lead_in(torch),
                                        [fn() for _ in range(reps)]),
                        "device_ms")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and EDT_MARK not in e.key]
        if not sum(e.self_device_time_total for e in kernels):
            if not events:
                raise AssertionError("no device time in the profiler's "
                                     "trace")
            ms = cuda_ms(torch, fn, reps)
            print(f"device_ms: no device time in {PROFILE_ATTEMPTS} "
                  f"traces: {ms:.4f} ms a call between CUDA events "
                  f"(kernels not measured)")
            return ms, float("nan"), {}
        n_k, per, lost = 0.0, {}, 0
        for e in kernels:
            n = e.count / reps
            if n >= 0.5 and n != round(n):
                lost += 1
                print(f"device_ms: {e.key[:60]} seen {e.count} times in "
                      f"{reps} calls (events lost): "
                      f"{math.floor(n + 0.5)} a call")
                n = math.floor(n + 0.5)
            n_k += n
            per[e.key] = e.self_device_time_total / e.count * n / 1e3
        if not lost and (expect is None or n_k == expect):
            break
        print(f"device_ms: {n_k:g} kernels a call in the trace"
              + (f", {expect} expected" if expect is not None else "")
              + f", {lost} kernels with events lost"
              + (", tracing again" if attempt + 1 < PROFILE_ATTEMPTS
                 else ""))
    return sum(per.values()), n_k, per


def edt_edge_masks(torch, gen, dev):
    """The CPU test's edge cases on the card (odd sizes, an axis of length
    1, lines and planes without a site, a volume without any), the largest
    extents the kernels take, and a permuted view (copied to contiguous
    before the kernels)."""
    def rand(shape, p=0.1):
        return torch.rand(shape, generator=gen, device=dev) < p

    cases = {"odd 2x5x7x33": rand((2, 5, 7, 33)),
             "D = 1": rand((2, 1, 9, 12), 0.2),
             "H = 1": rand((1, 6, 1, 11), 0.2),
             "W = 1": rand((1, 6, 9, 1), 0.2),
             "D = 1024": rand((1, 1024, 3, 40), 0.002),
             "H = 1024": rand((1, 3, 1024, 40), 0.002),
             "W = 1024": rand((1, 3, 5, 1024), 0.002),
             "permuted view": rand((28, 64, 64, 2), 0.02).permute(3, 0, 1, 2)}
    s = rand((1, 9, 8, 10))
    s[:, :, rand((8, 10), 0.5)] = False
    cases["columns without a site"] = s
    s = rand((1, 7, 10, 9))
    s[:, 3] = False
    s[:, :, 4] = False
    cases["planes without a site"] = s
    s = rand((2, 5, 6, 7))
    s[0] = False
    cases["a volume without any site"] = s
    return cases


def edt_phase(torch):
    """K5: the whole EDT (``edt_sites``, two kernels a call) bit for bit
    against its plain version at EDT_SHAPES and the edge cases, through
    ``distance_transform_edt`` and ``signed_edt`` too; device time per call
    beside the parent composition (its cummax scan, movedim copies and
    sqrt around today's ``edt_parabola``, one launch a pass; run from the
    same module) and the plain version; host ms per call; kernel A's scan
    along D, as kernel A's time less its time on the same planes laid out
    as N * D volumes of depth 1 (the same blocks and H pass, one z to
    scan).  Then the single pass (``edt_parabola``) at the line shapes, as
    before."""
    from stroke_prediction_tpu_torch.ops import edt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    k5 = {"max_abs_err": 0.0}

    def hold(name, sites):
        out = edt.edt_sites(sites)
        ref = edt.edt_sites_plain(sites)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"K5 edt_sites differs from its plain "
                                 f"version at {name}: max|err| {err}")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)

    cases = edt_edge_masks(torch, gen, dev)
    for name, sites in cases.items():
        hold(name, sites)
    print(f"K5 edt_sites equals its plain version at the edge cases: "
          f"{', '.join(cases)}")

    vol = torch.rand((28, 64, 64), generator=gen, device=dev) < 0.9
    before = edt.edt_sites.launches
    dist = edt.distance_transform_edt(vol)
    sdm = edt.signed_edt(vol.float())
    torch.cuda.synchronize()
    if edt.edt_sites.launches - before != 3:
        raise AssertionError("distance_transform_edt + signed_edt made "
                             f"{edt.edt_sites.launches - before} edt_sites "
                             f"calls, expected 3")
    if not (torch.equal(dist.cpu(), edt.distance_transform_edt(vol.cpu()))
            and torch.equal(sdm.cpu(), edt.signed_edt(vol.float().cpu()))):
        raise AssertionError("distance_transform_edt / signed_edt on the "
                             "card differ from the CPU's")

    print("K5 whole EDT per call (device ms from torch.profiler; host ms "
          "= CUDA events around 20 Python calls; parent composition = the "
          "parent's scan + 2 x (copy + today's edt_parabola) + sqrt):")
    for shape in EDT_SHAPES:
        sites = torch.rand(shape, generator=gen, device=dev) < 0.02
        sites[:, :, :, ::7] = False            # columns without a site
        sites[:, shape[1] // 2] = False        # a plane without a site
        hold(shape, sites)
        ms, n_k, per = device_ms(torch, lambda: edt.edt_sites(sites), 20,
                                 expect=2)
        split = [sum(v for nm, v in per.items() if k in nm)
                 for k in EDT_KERNELS]
        if n_k != 2 or any(not any(k in nm for k in EDT_KERNELS)
                           for nm in per):
            raise AssertionError(f"edt_sites ran {n_k} kernels a call: "
                                 f"{list(per)}")

        def parent():
            return edt.separable_edt(sites, (1, 2, 3), edt.edt_parabola)

        if not torch.equal(parent(), edt.edt_sites(sites)):
            raise AssertionError(f"the parent composition differs at "
                                 f"{shape}")
        p_ms, p_k, _ = device_ms(torch, parent, 20)
        planes = sites.reshape((-1, 1) + shape[2:])
        _, _, per1 = device_ms(torch, lambda: edt.edt_sites(planes), 20)
        a1 = sum(v for nm, v in per1.items() if EDT_KERNELS[0] in nm)
        scan = split[0] - a1
        pl_ms, pl_k, _ = device_ms(torch, lambda: edt.edt_sites_plain(sites),
                                   3)
        host = cuda_ms(torch, lambda: edt.edt_sites(sites), 20)
        p_host = cuda_ms(torch, parent, 20)
        bms, by = edt_bound(shape)
        print(f"  {shape}: edt_sites {ms:.4f} ms ({n_k:g} kernels: scan D + "
              f"pass H {split[0]:.4f}, pass W + sqrt {split[1]:.4f}; scan "
              f"along D {scan:.4f} = {100 * scan / split[0]:.1f}% of kernel "
              f"A, which takes {a1:.4f} at depth 1)  parent composition "
              f"{p_ms:.4f} ms ({p_k:g} kernels)  plain {pl_ms:.4f} ms "
              f"({pl_k:g} kernels)  bound {bms:.5f} ms ({by}; "
              f"{100 * bms / ms:.1f}% of edt_sites)  host ms per call "
              f"{host:.4f} (parent composition {p_host:.4f})  exact")
        k5[shape] = dict(ms=ms, kernels=n_k, kernel_ms=split, scan_ms=scan,
                         parent_ms=p_ms, parent_kernels=p_k, plain_ms=pl_ms,
                         bound_ms=bms, bound_by=by, host_ms=host,
                         parent_host_ms=p_host)

    # the single pass: exact against the plain version; some lines without
    # a site.  (3584, 128): a tester case's pass; (11424, 168): one at
    # n = 168; (3584, 64): a validation step's pass (2 x 28 x 64 lines of a
    # 64^2 plane)
    for n_lines, n in ((28 * 128, 128), (68 * 168, 168), (2 * 28 * 64, 64)):
        f2 = torch.randint(0, n, (n_lines, n), generator=gen,
                           device=dev).float() ** 2
        f2[::8] = edt._BIG
        out = edt.edt_parabola(f2)
        ref = edt.edt_parabola_plain(f2)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"({n_lines}, {n}): max|err| {err}")
        ms = cuda_ms(torch, lambda: edt.edt_parabola(f2), 20)
        plain = cuda_ms(torch, lambda: edt.edt_parabola_plain(f2), 5)
        pass_ms, _, _ = device_ms(torch, lambda: edt.edt_parabola(f2), 20)
        # the larger of its bytes (f in, out) and an O(n) envelope's
        # operations; the n candidates an output are the kernel's choice
        bms, by = bound_ms(ENVELOPE_PASS_OPS * n_lines * n, 8.0 * n_lines * n)
        print(f"K5 edt_parabola ({n_lines}, {n}): max|err| {err} (exact); "
              f"kernel {pass_ms:.4f} ms device, {ms:.4f} ms host per call  "
              f"plain {plain:.4f} ms  bound {bms:.5f} ms ({by})")
        k5[(n_lines, n)] = dict(ms=pass_ms, host_ms=ms, plain_ms=plain,
                                bound_ms=bms, bound_by=by)
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
    print("K5 has no single PyTorch library call that computes it "
          "(library_ms null)")
    return k5


def train_kernel_phase(torch):
    """K1 and K2-K4 at the ten convs of one training step, float32 and
    bfloat16.  Returns {dtype: [per-layer dict]} and the 's'-case errors."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        bwd_route, conv3x3, conv3x3_bwd_dw, conv3x3_bwd_dw_plain,
        conv3x3_bwd_dx, conv3x3_bwd_dx_plain, conv3x3_bwd_fused,
        conv3x3_plain, fold_bn_zsame)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def uniform(shape, lo, hi, dtype=torch.float32):
        t = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
        return t.to(dtype)

    rel = {}     # (kernel, dtype) -> largest max|err| / max|ref| seen

    def note(key, got, ref):
        rel[key] = max(rel.get(key, 0.0), rel_err(got, ref))
        return float((got.float() - ref.float()).abs().max())

    def check_out(name, got, ref, dtype):
        """y / dx: float32 as K1; bfloat16 within one rounding step."""
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, **K1_TOL)
        elif rel_err(got, ref) > BF16_REL:
            raise AssertionError(f"{name}: rel err {rel_err(got, ref)}")
        return note((name.split()[0] + " y/dx", str(dtype)[6:]), got, ref)

    def check_sum(name, got, ref, dtype):
        """dW / db, float32 in both types."""
        if rel_err(got, ref) > DW_REL:
            raise AssertionError(f"{name}: rel err {rel_err(got, ref)}")
        return note((name.split()[0] + " dW/db", str(dtype)[6:]), got, ref)

    def check_f64(name, dx, g, y, k, x_shape, act, alpha, mode):
        """A float32 dx (K2, K3) vs a float64 dgrad on the card."""
        ref64 = conv3x3_bwd_dx_plain(g.double(), y.double(), k.double(),
                                     x_shape, act, alpha, mode)
        err = rel_err(dx.double(), ref64)
        if err > F64_REL:
            raise AssertionError(f"{name}: {err:.3e} of max|ref| off the "
                                 f"float64 dgrad")
        return err

    def check_f64_dw(name, dk, db, x, g, y, act, alpha, mode, table=False):
        """A float32 dW and db (K2, K4) vs a float64 wgrad on the card,
        held to the float32 dW limit."""
        rdk64, rdb64 = conv3x3_bwd_dw_plain(x.double(), g.double(),
                                            y.double(), act, alpha, mode,
                                            table)
        err = max(rel_err(dk.double(), rdk64), rel_err(db.double(), rdb64))
        if err > DW_REL:
            raise AssertionError(f"{name}: {err:.3e} of max|ref| off the "
                                 f"float64 wgrad")
        return err

    shapes = unet_conv_shapes(PATCH_DHW, CHANNELS)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        nb = 2 if dtype == torch.bfloat16 else 4
        rows = []
        print(f"K1-K4 per layer of one training step (batch {TRAIN_BATCH}, "
              f"{dname}, 'v', LeakyReLU 0.01; ms kernel / plain / cuDNN / "
              f"bound):")
        for i, (d, h, w, ci, co) in enumerate(shapes, 1):
            route = bwd_route(ci, co, i > 1)
            # K2 takes only the channels its route allows (both types)
            k2 = bwd_route(ci, co) == "fused"
            x = uniform((TRAIN_BATCH, d, h, w, ci), -1.0, 1.0, dtype)
            bnd = (27 * ci) ** -0.5
            k = uniform((3, 3, 3, ci, co), -bnd, bnd, dtype)
            b = uniform((co,), -bnd, bnd)
            y = conv3x3(x, k, b, "leaky_relu", 0.01)
            err = {"K1": check_out(f"K1 L{i} {dname}", y,
                                   conv3x3_plain(x, k, b, "leaky_relu", 0.01),
                                   dtype)}
            g = uniform(y.shape, -1.0, 1.0, dtype)
            a = (g, y, "leaky_relu", 0.01)
            rdx = conv3x3_bwd_dx_plain(g, y, k, x.shape, "leaky_relu", 0.01)
            rdk, rdb = conv3x3_bwd_dw_plain(x, *a)
            dx3 = conv3x3_bwd_dx(g, y, k, x.shape, "leaky_relu", 0.01)
            dx3b = conv3x3_bwd_dx(g, y, k, x.shape, "leaky_relu", 0.01)
            dk4, db4 = conv3x3_bwd_dw(x, *a)
            dk4b, db4b = conv3x3_bwd_dw(x, *a)
            runs = [("K4", (dk4, db4), (dk4b, db4b))]
            if k2:
                dx2, dk2, db2 = conv3x3_bwd_fused(x, g, y, k, "leaky_relu",
                                                  0.01)
                dk2b, db2b = conv3x3_bwd_fused(x, g, y, k, "leaky_relu",
                                               0.01)[1:]
                runs.append(("K2", (dk2, db2), (dk2b, db2b)))
            torch.cuda.synchronize()
            if not torch.equal(dx3, dx3b):
                raise AssertionError(f"K3 L{i} {dname}: dx differs between "
                                     f"two runs")
            for name, p, q in runs:
                if not (torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])):
                    raise AssertionError(f"{name} L{i} {dname}: dW or db "
                                         f"differs between two runs")
            tag = f"L{i} {dname}"
            f64 = {}
            if dtype == torch.float32:
                f64["K3"] = check_f64(f"K3 dx {tag}", dx3, g, y, k, x.shape,
                                      "leaky_relu", 0.01, "v")
                if k2:
                    f64["K2"] = check_f64(f"K2 dx {tag}", dx2, g, y, k,
                                          x.shape, "leaky_relu", 0.01, "v")
                    f64["K2 dW"] = check_f64_dw(f"K2 dk, db {tag}", dk2,
                                                db2, x, *a, "v")
                if route in ("dw", "split"):
                    f64["K4 dW"] = check_f64_dw(f"K4 dk, db {tag}", dk4,
                                                db4, x, *a, "v")
            if k2:
                err["K2"] = max(check_out(f"K2 dx {tag}", dx2, rdx, dtype),
                                check_sum(f"K2 dk {tag}", dk2, rdk, dtype),
                                check_sum(f"K2 db {tag}", db2, rdb, dtype))
                del dx2, dk2, db2, dk2b, db2b
            err["K3"] = check_out(f"K3 dx {tag}", dx3, rdx, dtype)
            err["K4"] = max(check_sum(f"K4 dk {tag}", dk4, rdk, dtype),
                            check_sum(f"K4 db {tag}", db4, rdb, dtype))
            del rdx, rdk, rdb, dx3, dx3b, dk4, db4, dk4b, db4b, runs

            # times; the library yardstick is cuDNN's dgrad / wgrad on the
            # masked cotangent (TF32 off), which the port never calls
            iters = 5
            gp = (g.float() * torch.where(y > 0, 1.0, 0.01)).to(dtype)
            x_l, g_l = x.permute(0, 4, 1, 2, 3), gp.permute(0, 4, 1, 2, 3)
            w_l = k.permute(4, 3, 0, 1, 2).contiguous()
            in_size = tuple(x_l.shape)
            w_size = tuple(w_l.shape)
            ms = {
                "K1": cuda_ms(torch, lambda: conv3x3(
                    x, k, b, "leaky_relu", 0.01), iters),
                "K3": cuda_ms(torch, lambda: conv3x3_bwd_dx(
                    g, y, k, x.shape, "leaky_relu", 0.01), iters),
                "K4": cuda_ms(torch, lambda: conv3x3_bwd_dw(x, *a), iters)}
            if k2:
                ms["K2"] = cuda_ms(torch, lambda: conv3x3_bwd_fused(
                    x, g, y, k, "leaky_relu", 0.01), iters)
            plain = {
                "K1": cuda_ms(torch, lambda: conv3x3_plain(
                    x, k, b, "leaky_relu", 0.01), iters),
                "K3": cuda_ms(torch, lambda: conv3x3_bwd_dx_plain(
                    g, y, k, x.shape, "leaky_relu", 0.01), iters),
                "K4": cuda_ms(torch, lambda: conv3x3_bwd_dw_plain(x, *a),
                              iters)}
            plain["K2"] = plain["K3"] + plain["K4"]
            lib = {
                "K1": cuda_ms(torch, lambda: torch.nn.functional.conv3d(
                    x_l, w_l, b.to(dtype)), iters),
                "K3": cuda_ms(torch, lambda: torch.nn.grad.conv3d_input(
                    in_size, w_l, g_l), iters),
                "K4": cuda_ms(torch, lambda: torch.nn.grad.conv3d_weight(
                    x_l, w_size, g_l), iters)}
            lib["K2"] = lib["K3"] + lib["K4"]
            flops = 2.0 * 27 * ci * co * y[..., 0].numel()
            nx, ny, nk = x.numel(), y.numel(), k.numel()
            ops = {"K1": flops, "K2": 2 * flops, "K3": flops, "K4": flops}
            nbytes = {                      # each input once, each output once
                "K1": nb * (nx + nk + ny) + 4 * co,
                "K2": nb * (nx + 2 * ny + nk + nx) + 4 * (nk + co),
                "K3": nb * (2 * ny + nk + nx),
                "K4": nb * (nx + 2 * ny) + 4 * (nk + co)}
            bnd_ms = {key: bound_ms(ops[key], nbytes[key],
                                    peak_key(key, dname))
                      for key in ops}
            rows.append(dict(layer=i, route=route, shape=(d, h, w, ci, co),
                             err=err, f64=f64, ms=ms, plain=plain, lib=lib,
                             bound=bnd_ms, ops=ops, bytes=nbytes))
            print(f"  L{i:<2} in {d}x{h}x{w} {ci:>2}->{co:<2} route "
                  f"{route:5s} "
                  + "  ".join(f"{key} {ms[key]:.4f}/{plain[key]:.4f}/"
                              f"{lib[key]:.4f}/{bnd_ms[key][0]:.4f}"
                              f"({bnd_ms[key][1][0]})" for key in ms)
                  + "  max|err| " + " ".join(f"{key} {v:.3e}"
                                             for key, v in err.items())
                  + "".join(f"  {key} vs f64 {v:.3e} of max|ref|"
                            for key, v in f64.items()))

            def vs_library(key, call, tile, plane):
                """A kernel against cuDNN at this layer; its tile
                efficiency is the real share of the tiled plane (K1 and K4
                tile the output plane, K2 and K3 the input plane)."""
                print(f"      L{i} {key} {ms[key]:.4f} ms vs cuDNN {call} "
                      f"{lib[key]:.4f} ms ({ms[key] / lib[key]:.2f}x); {key} "
                      f"at {ops[key] / ms[key] / 1e9:.1f} TFLOP/s; tile "
                      f"efficiency {tile_efficiency(plane, tile):.3f} "
                      f"({tile[0]}x{tile[1]} tiles over "
                      f"{plane[0]}x{plane[1]}); bound "
                      f"{bnd_ms[key][0]:.4f} ms ({peak_key(key, dname)})")

            vs_library("K1", "forward", K1_TILE, (h - 2, w - 2))
            if route == "fused":
                split = ms["K3"] + ms["K4"]
                print(f"      L{i} K2 {ms['K2']:.4f} ms vs K3 + K4 "
                      f"{split:.4f} ms ({split / ms['K2']:.2f}x)")
                vs_library("K2", "dgrad + wgrad", K2_TILE, (h, w))
            if route == "split":
                vs_library("K3", "dgrad", K3_TILE, (h, w))
            if route in ("dw", "split"):
                vs_library("K4", "wgrad", K4_TILE, (h - 2, w - 2))
            del x, k, b, y, g, gp, x_l, g_l, w_l
        results[dname] = rows

    # z-SAME + ELU + per-plane bias table, forward and backward (the CAE
    # encoder's form), and an odd channel count (3 -> 4: padded channels,
    # scalar staging) in 'v' + LeakyReLU
    s_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case, (shape, co, act, alpha, mode) in (
                ("'s' + ELU + plane table", ((2, 12, 20, 22, 8), 16, "elu",
                                             1.0, "s")),
                ("3 -> 4", ((2, 9, 23, 37, 3), 4, "leaky_relu", 0.01,
                            "v"))):
            x = uniform(shape, -1.0, 1.0, dtype)
            ci, d_out = shape[-1], shape[1] - 2 * (mode == "v")
            k, bias = fold_bn_zsame(uniform((3, 3, 3, ci, co), -0.1, 0.1),
                                    uniform((co,), -0.1, 0.1),
                                    uniform((ci,), 0.5, 1.5),
                                    uniform((ci,), -0.5, 0.5), d_out)
            table = mode == "s"
            if not table:
                bias = bias[0].contiguous()
            k = k.to(dtype).contiguous()
            y = conv3x3(x, k, bias, act, alpha, mode)
            ry = conv3x3_plain(x, k, bias, act, alpha, mode)
            g = uniform(y.shape, -1.0, 1.0, dtype)
            a = (g, y, act, alpha, mode)
            rdx = conv3x3_bwd_dx_plain(g, y, k, x.shape, act, alpha, mode)
            rdk, rdb = conv3x3_bwd_dw_plain(x, *a, table)
            dx2, dk2, db2 = conv3x3_bwd_fused(x, *a[:2], k, *a[2:], table)
            dk2b, db2b = conv3x3_bwd_fused(x, *a[:2], k, *a[2:], table)[1:]
            dx3 = conv3x3_bwd_dx(g, y, k, x.shape, act, alpha, mode)
            dx3b = conv3x3_bwd_dx(g, y, k, x.shape, act, alpha, mode)
            dk4, db4 = conv3x3_bwd_dw(x, *a, table)
            dk4b, db4b = conv3x3_bwd_dw(x, *a, table)
            torch.cuda.synchronize()
            for name, p, q in (("K2", (dk2, db2), (dk2b, db2b)),
                               ("K4", (dk4, db4), (dk4b, db4b))):
                if not (torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])):
                    raise AssertionError(f"{name} {case} {dname}: dW or db "
                                         f"differs between two runs")
            if not torch.equal(dx3, dx3b):
                raise AssertionError(f"K3 {case} {dname}: dx differs "
                                     f"between two runs")
            if dtype == torch.float32:
                s_err[f"K3 {case} float32 vs f64"] = check_f64(
                    f"K3 {case} dx", dx3, g, y, k, x.shape, act, alpha, mode)
                s_err[f"K2 {case} float32 vs f64"] = check_f64(
                    f"K2 {case} dx", dx2, g, y, k, x.shape, act, alpha, mode)
                s_err[f"K2 {case} float32 dW, db vs f64"] = check_f64_dw(
                    f"K2 {case} dk, db", dk2, db2, x, *a, table)
                s_err[f"K4 {case} float32 dW, db vs f64"] = check_f64_dw(
                    f"K4 {case} dk, db", dk4, db4, x, *a, table)
            s_err[f"{case} {dname}"] = max(
                check_out(f"K1 {case} y", y, ry, dtype),
                check_out(f"K2 {case} dx", dx2, rdx, dtype),
                check_out(f"K3 {case} dx", dx3, rdx, dtype),
                *(check_sum(n, p, q, dtype) for n, p, q in (
                    (f"K2 {case} dk", dk2, rdk), (f"K2 {case} db", db2, rdb),
                    (f"K4 {case} dk", dk4, rdk),
                    (f"K4 {case} db", db4, rdb))))
    print(f"K1-K4 's' + ELU + plane table (2, 12, 20, 22, 8->16) and 3 -> 4 "
          f"(2, 9, 23, 37): max|err| {s_err}")

    # K1, K3 and K4 at a wide layer: the Unet3D class default (2, 32, 64,
    # 128, 64, 32, 32, 2) has a 192 -> 64 conv (L7), which the bfloat16 K1
    # takes as 12 chunks of 16 input channels, K3 as two N slices of 96
    # input channels and K4 as 12 x 4 slice pairs (12 x 2 of 16 x 32
    # channels in float32)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        shape, co = (2, 10, 20, 22, 192), 64
        x = uniform(shape, -1.0, 1.0, dtype)
        k = uniform((3, 3, 3, 192, co), -192 ** -0.5, 192 ** -0.5, dtype)
        bias = uniform((co,), -0.1, 0.1)
        y = conv3x3(x, k, bias, "leaky_relu", 0.01)
        ry = conv3x3_plain(x, k, bias, "leaky_relu", 0.01)
        g = uniform(y.shape, -1.0, 1.0, dtype)
        a = (g, y, "leaky_relu", 0.01)
        dx3 = conv3x3_bwd_dx(g, y, k, shape, "leaky_relu", 0.01)
        dx3b = conv3x3_bwd_dx(g, y, k, shape, "leaky_relu", 0.01)
        rdx = conv3x3_bwd_dx_plain(g, y, k, shape, "leaky_relu", 0.01)
        dk4, db4 = conv3x3_bwd_dw(x, *a)
        dk4b, db4b = conv3x3_bwd_dw(x, *a)
        rdk, rdb = conv3x3_bwd_dw_plain(x, *a)
        torch.cuda.synchronize()
        if not (torch.equal(dk4, dk4b) and torch.equal(db4, db4b)):
            raise AssertionError(f"K4 192 -> 64 {dname}: dW or db differs "
                                 f"between two runs")
        if not torch.equal(dx3, dx3b):
            raise AssertionError(f"K3 192 -> 64 {dname}: dx differs between "
                                 f"two runs")
        if dtype == torch.float32:
            s_err["K3 192 -> 64 float32 vs f64"] = check_f64(
                "K3 192->64 dx", dx3, g, y, k, shape, "leaky_relu", 0.01,
                "v")
            s_err["K4 192 -> 64 float32 dW, db vs f64"] = check_f64_dw(
                "K4 192->64 dk, db", dk4, db4, x, *a, "v")
        s_err[f"K1 192 -> 64 {dname}"] = check_out(
            f"K1 192->64 y {dname}", y, ry, dtype)
        s_err[f"K3 192 -> 64 {dname}"] = check_out(
            f"K3 192->64 dx {dname}", dx3, rdx, dtype)
        s_err[f"K4 192 -> 64 {dname}"] = max(
            check_sum(f"K4 192->64 dk {dname}", dk4, rdk, dtype),
            check_sum(f"K4 192->64 db {dname}", db4, rdb, dtype))
    print(f"K1, K3, K4 192 -> 64 {shape}: max|err| " + "; ".join(
        f"{dname} " + ", ".join(f"{s_err[f'{kn} 192 -> 64 {dname}']:.3e}"
                                for kn in ("K1", "K3", "K4"))
        for dname in ("float32", "bfloat16")))
    print("largest max|err| / max|ref| over the layers (y, dx in the "
          "storage type; dW, db float32 in both): " + "; ".join(
              f"{k} {d} {v:.3e}" for (k, d), v in sorted(rel.items())))
    return results, s_err


def slice_phase(torch, work):
    from stroke_prediction_tpu_torch.cli import test_unet_segmentation as cli
    from stroke_prediction_tpu_torch.eval.unet_tester import (
        UnetSegmentationTester)
    from stroke_prediction_tpu_torch.models.convert import save_unet_checkpoint
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training
    from stroke_prediction_tpu_torch.utils.nifti import read_nifti

    gen = torch.Generator().manual_seed(0)
    model = Unet3D(CHANNELS, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "var"):                    # BatchNorm
                m.scale.uniform_(0.8, 1.2, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.mean.uniform_(-0.5, 0.5, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)
    ckpt = os.path.join(work, "unet.model")
    save_unet_checkpoint(ckpt, model)

    out_base = os.path.join(work, "unet")
    args = get_args_unet_training(
        [ckpt, "--synthetic", "--fold", *map(str, FOLD), "--outbasepath",
         out_base, "--device", "cuda", "--channels", *map(str, CHANNELS)])

    reset_launches()
    t0 = time.perf_counter()
    tester = cli.test(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"slice: tester CLI on {len(FOLD)} cases in {wall:.2f} s; "
          f"launches {launches}")
    if any(launches[k] for k in ("conv3x3_bwd_fused", "conv3x3_bwd_dx",
                                 "conv3x3_bwd_dw")):
        raise AssertionError("the tester launched a backward kernel")
    n = len(tester.case_seconds)
    if n != len(FOLD):
        raise AssertionError(f"tester ran {n} cases, expected {len(FOLD)}")
    if launches["conv3x3"] != 10 * n:
        raise AssertionError(f"K1 launched {launches['conv3x3']} times, "
                             f"expected 10 per case")
    if launches["edt_sites"] != EDT_PER_STEP * n or launches["edt_parabola"]:
        raise AssertionError(f"K5: {launches['edt_sites']} edt_sites calls "
                             f"and {launches['edt_parabola']} single passes, "
                             f"expected {EDT_PER_STEP} calls per case and "
                             f"no single pass")
    steady = tester.case_seconds[1:]
    infer_ms = 1e3 * sum(s[1] for s in steady) / len(steady)
    total_ms = 1e3 * sum(s[2] for s in steady) / len(steady)
    print(f"slice: ms per case after the first: {infer_ms:.2f} to metrics on "
          f"the host (forward + Dice/HD/ASSD), {total_ms:.2f} incl. the "
          f"NIfTI dumps; per case (id, s, s): {tester.case_seconds}")

    for cid, _, _ in tester.case_seconds:
        for part in ("_core", "_penu"):
            vol, _ = read_nifti(f"{out_base}_{cid}{part}.nii.gz")
            if vol.shape != (256, 256, 28) or not vol.size:
                raise AssertionError(f"case {cid}{part}: shape {vol.shape}")
            if not (vol.min() >= 0.0 and vol.max() <= 1.0):
                raise AssertionError(f"case {cid}{part}: values outside "
                                     f"[0, 1] or not finite")
    check_dump_codecs(f"{out_base}_{tester.case_seconds[0][0]}_core.nii.gz",
                      "slice")

    # one case again on the card and on the CPU (plain versions)
    loader = tester._dataloader
    batch = loader.dataset.stack([loader.indices[0]])
    with torch.inference_mode():
        m_gpu, seg_gpu = tester.infer_batch(batch)
        cpu = UnetSegmentationTester(loader, ckpt, out_base + "_cpu", None,
                                     "cpu")
        t0 = time.perf_counter()
        m_cpu, seg_cpu = cpu.infer_batch(batch)
        cpu_s = time.perf_counter() - t0
    seg_gpu = seg_gpu.cpu()
    if tuple(seg_gpu.shape) != (1, 28, 128, 128, 2):
        raise AssertionError(f"output shape {tuple(seg_gpu.shape)}")
    if not torch.isfinite(seg_gpu).all():
        raise AssertionError("non-finite probabilities on the card")
    err = float((seg_gpu - seg_cpu).abs().max())
    print(f"slice: case {int(batch['case_id'][0])} card vs CPU max|prob err| "
          f"{err:.3e} (CPU plain path {cpu_s:.1f} s); Dice core "
          f"{m_gpu['core'].dc:.6f} / {m_cpu['core'].dc:.6f}, penumbra "
          f"{m_gpu['penu'].dc:.6f} / {m_cpu['penu'].dc:.6f}; HD core "
          f"{m_gpu['core'].hd:.4f} / {m_cpu['core'].hd:.4f}")
    if err > SLICE_ATOL:
        raise AssertionError(f"card and CPU probabilities differ by {err}")
    for part in ("core", "penu"):
        for f in ("dc", "hd", "assd"):
            a, b = getattr(m_gpu[part], f), getattr(m_cpu[part], f)
            if abs(a - b) > 1e-3 * max(1.0, abs(b)):
                raise AssertionError(f"{part} {f}: card {a} vs CPU {b}")
    edt_metrics_vs_plain(torch, tester, batch)
    edt_case = profile_cases(torch, tester, batch, infer_ms)
    return launches, infer_ms, edt_case


def edt_metrics_vs_plain(torch, tester, batch):
    """One case's core and penumbra measures on the card, through the EDT's
    kernels and again with ``edt_sites_plain`` in their place on the same
    card tensors: the distance volumes are equal, so HD and ASSD must be.
    Random weights may predict no core (HD inf on both sides, whatever the
    EDT gives), so the predicted penumbra is held against the core label
    too, and at least one pair must have a finite HD."""
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.eval import metrics
    from stroke_prediction_tpu_torch.inference import unet_inference
    from stroke_prediction_tpu_torch.ops.edt import edt_sites, edt_sites_plain

    with torch.inference_mode():
        dto = unet_inference(tester._model,
                             tester._to_device(batch[KEY_IMAGES]),
                             tester._to_device(batch[KEY_LABELS]))
        pairs = {part: (getattr(dto.outputs, part),
                        getattr(dto.given_variables, part))
                 for part in ("core", "penu")}
        pairs["penu vs core label"] = (dto.outputs.penu,
                                       dto.given_variables.core)
        finite = 0
        for part, args in pairs.items():
            before = edt_sites.launches
            card = metrics.binary_measures(*args)
            calls = edt_sites.launches - before
            kernel_edt = metrics.edt_to_sites
            metrics.edt_to_sites = lambda s, axes: edt_sites_plain(s, axes)
            try:
                plain = metrics.binary_measures(*args)
            finally:
                metrics.edt_to_sites = kernel_edt
            if calls != 2 or edt_sites.launches - before != 2:
                raise AssertionError(f"{part}: {calls} edt_sites calls with "
                                     f"the kernels, "
                                     f"{edt_sites.launches - before - calls}"
                                     f" with the plain version")
            for f in ("hd", "assd", "dc"):
                a, b = getattr(card, f), getattr(plain, f)
                if not torch.equal(a, b):
                    raise AssertionError(f"{part} {f}: kernels {float(a)} "
                                         f"vs plain {float(b)}")
            finite += bool(torch.isfinite(card.hd))
            print(f"slice: {part} HD {float(card.hd):.6f} ASSD "
                  f"{float(card.assd):.6f} equal with the EDT's kernels and "
                  f"with its plain version on the card")
    if not finite:
        raise AssertionError("no pair has a finite HD: the EDT's values "
                             "were not compared")


# The CAE serving path at the reference width (--channelscae default):
# per tester case 3 encodes x 7 K1 layers + 4 decodes x 6, and two EDT calls
# for each of the three binary_measures; a sweep of the curve tester
# encodes the core and penumbra and decodes them and its batched
# interpolations once each
CAE_CHANNELS = (1, 16, 24, 32, 100, 200, 1)
CAE_DHW = (28, 128, 128)  # the masks, 256 x 256 x 28 resampled by 0.5
CAE_K1_PER_CASE = 3 * 7 + 4 * 6
CAE_EDT_PER_CASE = 6
CAE_SWEEP_K1, CAE_SWEEP_EDT = 2 * 7 + 3 * 6, 2
CAE_ATOL = 1e-4           # card vs CPU reconstructions and latents
CAE_DICE_ATOL = 1e-5      # card vs CPU, and batched sweep vs serial: Dice
CAE_ASSD_ATOL = 1e-3      # batched sweep vs serial: ASSD (tests/test_eval.py)
CAE_MIN_MOVED = 0.01      # a sweep's first vs last step: voxels apart
CAE_KERNELS = ("K1", "K2", "K3", "K4")
CAE_FIELDS = ("core", "penu", "lesion", "interpolation")
CAE_MEASURED = {"lesion": "interpolation", "core": "core", "penu": "penu"}


def cae_blobs(torch, dhw, radii=(0.45, 0.7, 1.0)):
    """(len(radii), D, H, W, 1) masks of nested ellipsoids, scaled by
    ``radii``."""
    d, h, w = torch.meshgrid(*(torch.arange(n, dtype=torch.float32)
                               for n in dhw), indexing="ij")
    r2 = (((d - dhw[0] / 2) / 8) ** 2 + ((h - dhw[1] * 0.47) / (
        dhw[1] / 5)) ** 2 + ((w - dhw[2] * 0.55) / (dhw[2] / 4)) ** 2)
    return torch.stack([(r2 < r * r).float() for r in radii])[..., None]


def cae_model(torch, channels=CAE_CHANNELS, dhw=CAE_DHW):
    """The CAE with seeded weights and BN scales and biases.  Its BN
    statistics are the moments of each layer's input over three nested
    blobs, as a trained model's running statistics are of its data, so
    that each layer passes its input's variation on and the
    reconstructions follow the latent.  The last bias is set so that the
    middle blob's reconstruction has its median at 0.5: the thresholded
    reconstructions then hold both classes."""
    from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
    from stroke_prediction_tpu_torch.models.layers import BatchNorm

    gen = torch.Generator().manual_seed(2)
    model = Cae3D(Enc3D(channels, generator=gen),
                  Dec3D(channels, generator=gen))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    blobs = cae_blobs(torch, dhw)
    last = model.dec.decoder.convs[-1]         # its output: the logits
    logits = []
    hook = last.register_forward_hook(lambda m, a, y: logits.append(y))
    with torch.no_grad():
        for m in bns:
            m.scale.uniform_(0.8, 1.2, generator=gen)
            m.bias.uniform_(-0.1, 0.1, generator=gen)
            m.momentum = 0.0            # the running statistics := batch's
        model.train().dec.decoder(model.enc.encoder(blobs))
        for m in bns:
            m.momentum = 0.9
        model.eval().dec.decoder(model.enc.encoder(blobs[1:2]))
        hook.remove()
        last.bias -= logits[-1].median()
    return model


def cae_recorded(torch, run, grad=False):
    """``run()`` (under inference mode unless ``grad``) with the wrappers of
    K1-K4 and edt_sites recorded as the CAE path calls them, each call held
    on its own inputs against its plain version: y and dx within K1_TOL
    (float32) or BF16_REL of max|ref| (bfloat16), dW and db within DW_REL
    of max|ref| (of float64 where the kernel is nearer to it than plain),
    each backward kernel run twice for a bit-identical result,
    edt_sites equal -> ({(kernel, N, D, H, W, C_in, C_out, mode, plane
    table, act, storage type): calls}, {mask shape: edt_sites calls},
    {kernel: largest max|err|})."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.ops import edt as edt_mod

    real = {"K1": cm.conv3x3, "K2": cm.conv3x3_bwd_fused,
            "K3": cm.conv3x3_bwd_dx, "K4": cm.conv3x3_bwd_dw,
            "edt": edt_mod.edt_sites}
    calls, sites, worst = {}, {}, dict.fromkeys(CAE_KERNELS, 0.0)

    def out_err(name, got, ref):
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, ref, **K1_TOL)
        elif rel_err(got, ref) > BF16_REL:
            raise AssertionError(f"{name}: {rel_err(got, ref):.3e} of "
                                 f"max|ref| off plain")
        return float((got.float() - ref.float()).abs().max())

    def sum_err(name, got, ref, ref64=None):
        """``ref64``: the float64 result, computed where the kernel is off
        plain: a kernel within DW_REL of float64 and nearer to it than its
        plain version is held to float64 instead (float32 sums over ~1.8M
        CT voxels at the CTP entry conv put cuDNN's wgrad 0.95e-4 to
        1.05e-4 of max|dk| off float64, the 3xTF32 K4 4.8e-6 to 5.8e-6);
        otherwise the pair's errors against float64 say which side is
        off."""
        if rel_err(got, ref) > DW_REL:
            far = ""
            if ref64 is not None:
                r64 = ref64()
                k64, p64 = rel_err(got, r64), rel_err(ref, r64)
                if k64 <= DW_REL and k64 < p64:
                    print(f"cae: {name}: {rel_err(got, ref):.3e} of "
                          f"max|ref| off plain; plain {p64:.3e} off "
                          f"float64, the kernel {k64:.3e}: held to float64")
                    return float((got.double() - r64).abs().max())
                far = (f"; against float64 the kernel {k64:.3e}, plain "
                       f"{p64:.3e}")
            raise AssertionError(f"{name}: {rel_err(got, ref):.3e} of "
                                 f"max|ref| off plain{far}")
        return float((got - ref).abs().max())

    def dk64(x, g, y, act, alpha, mode):
        """dW in float64 from the same g' (rounded as the kernels form
        it)."""
        gp = cm._masked_cotangent(g, y, act, alpha).double()
        return lambda: torch.nn.grad.conv3d_weight(
            cm._ncdhw(x.double()), (g.shape[-1], x.shape[-1], 3, 3, 3),
            cm._ncdhw(gp), padding=(cm.MODES[mode], 0, 0)
        ).permute(2, 3, 4, 1, 0)

    def note(kernel, x_shape, co, mode, table, act, err, dtype):
        key = (kernel, *x_shape, co, mode, table, act, str(dtype)[6:])
        calls[key] = calls.get(key, 0) + 1
        worst[kernel] = max(worst[kernel], err)

    def same(name, a, b):
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError(f"{name} differs between two runs")

    def k1(x, kernel, bias, act="none", alpha=0.01, mode="v"):
        y = real["K1"](x, kernel, bias, act, alpha, mode)
        err = out_err("K1", y, cm.conv3x3_plain(x, kernel, bias, act, alpha,
                                                mode))
        note("K1", x.shape, kernel.shape[-1], mode, bias.ndim == 2, act, err,
             x.dtype)
        return y

    def k2(x, g, y, kernel, act="none", alpha=0.01, mode="v",
           bias_table=False):
        a = (x, g, y, kernel, act, alpha, mode, bias_table)
        out = real["K2"](*a)
        same(f"K2 {tuple(x.shape)}", out, real["K2"](*a))
        rdx, rdk, rdb = cm.conv3x3_bwd_fused_plain(*a)
        err = max(out_err("K2 dx", out[0], rdx),
                  sum_err(f"K2 dk {tuple(x.shape)}", out[1], rdk,
                          dk64(x, g, y, act, alpha, mode)),
                  sum_err("K2 db", out[2], rdb))
        note("K2", x.shape, kernel.shape[-1], mode, bias_table, act, err,
             x.dtype)
        return out

    def k3(g, y, kernel, x_shape, act="none", alpha=0.01, mode="v"):
        a = (g, y, kernel, x_shape, act, alpha, mode)
        dx = real["K3"](*a)
        same(f"K3 {tuple(x_shape)}", (dx,), (real["K3"](*a),))
        err = out_err("K3 dx", dx, cm.conv3x3_bwd_dx_plain(*a))
        note("K3", x_shape, kernel.shape[-1], mode, False, act, err, y.dtype)
        return dx

    def k4(x, g, y, act="none", alpha=0.01, mode="v", bias_table=False):
        a = (x, g, y, act, alpha, mode, bias_table)
        out = real["K4"](*a)
        same(f"K4 {tuple(x.shape)}", out, real["K4"](*a))
        rdk, rdb = cm.conv3x3_bwd_dw_plain(*a)
        err = max(sum_err(f"K4 dk {tuple(x.shape)}", out[0], rdk,
                          dk64(x, g, y, act, alpha, mode)),
                  sum_err("K4 db", out[1], rdb))
        note("K4", x.shape, g.shape[-1], mode, bias_table, act, err, x.dtype)
        return out

    def edt(mask):
        out = real["edt"](mask)
        if not torch.equal(out, edt_mod.edt_sites_plain(mask)):
            raise AssertionError(f"edt_sites on a {tuple(mask.shape)} mask "
                                 f"of the CAE path differs from its plain "
                                 f"version")
        sites[tuple(mask.shape)] = sites.get(tuple(mask.shape), 0) + 1
        return out

    # each kernel's wrapper counts into its module's attribute by name
    for fn in (k1, k2, k3, k4, edt):
        fn.launches = 0

    def install(fns):
        (cm.conv3x3, cm.conv3x3_bwd_fused, cm.conv3x3_bwd_dx,
         cm.conv3x3_bwd_dw, edt_mod.edt_sites) = fns

    install((k1, k2, k3, k4, edt))
    try:
        with torch.inference_mode(not grad):
            run()
        torch.cuda.synchronize()
    finally:
        install(tuple(real.values()))
    return calls, sites, worst


def cae_check_recorded(name, calls, sites, worst, want, edt_shapes,
                       prefix="cae"):
    """The recorded calls of a CAE run (or another path's): ``want``
    ({kernel: calls}, no call of a kernel it leaves out) and edt_sites
    called at ``edt_shapes`` ({mask shape: calls})."""
    counts = {k: sum(n for key, n in calls.items() if key[0] == k)
              for k in CAE_KERNELS}
    print(f"{prefix}: {name}: calls {counts} on their own inputs against plain "
          f"(y, dx: float32 {K1_TOL}, bfloat16 {BF16_REL} of max|ref|; dW, "
          f"db {DW_REL} of max|ref|; K2-K4 bit-identical on repeat), "
          f"max|err| {worst}; edt_sites {sites} equal to plain")
    if counts != {k: want.get(k, 0) for k in CAE_KERNELS} or \
            sites != edt_shapes:
        raise AssertionError(f"{name}: expected calls {want} and edt_sites "
                             f"at {edt_shapes}")


def cae_kernel_phase(torch, calls, per, alpha=1.0, what="the CAE's"):
    """The float32 K1 at every distinct layer of ``calls``' K1 calls (as
    :func:`cae_recorded` gives them, each with its activation at
    ``alpha``) against its plain version and a float64 conv, timed beside
    cuDNN's conv; sums ``per`` (each layer times its calls)."""
    import torch.nn.functional as F

    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        MODES, conv3x3, conv3x3_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops=0.0,
               bytes=0.0, max_abs_err=0.0, max_rel_err_f64=0.0, launches=0)
    print(f"\nK1 at {what} layers {per} (float32, activation at {alpha}, "
          f"3xTF32; x n = calls; bias a plane table or a vector; cuDNN with "
          f"the vector bias, no activation):")
    for (kern, nb, d, h, w, ci, co, mode, table, act, _), n in \
            calls.items():
        if kern != "K1":
            continue
        d_out = d if mode == "s" else d - 2
        bnd = (27 * ci) ** -0.5
        x = uniform((nb, d, h, w, ci), -1.0, 1.0)
        k = uniform((3, 3, 3, ci, co), -bnd, bnd)
        b = uniform((d_out, co) if table else (co,), -bnd, bnd)
        y = conv3x3(x, k, b, act, alpha, mode)
        ref = conv3x3_plain(x, k, b, act, alpha, mode)
        ref64 = conv3x3_plain(x.double(), k.double(), b.double(), act, alpha,
                              mode)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        torch.testing.assert_close(y, ref, **K1_TOL)
        f64 = rel_err(y.double(), ref64)
        if f64 > F64_REL:
            raise AssertionError(f"K1 at {what} layer {d}x{h}x{w} {ci}->{co}: "
                                 f"{f64:.3e} of max|ref| off float64")
        del ref64
        x_lib = x.permute(0, 4, 1, 2, 3)
        w_lib = k.permute(4, 3, 0, 1, 2).contiguous()
        b_lib = b[0].contiguous() if table else b
        ms = cuda_ms(torch, lambda: conv3x3(x, k, b, act, alpha, mode), 10)
        plain = cuda_ms(torch, lambda: conv3x3_plain(x, k, b, act, alpha,
                                                     mode), 10)
        lib = cuda_ms(torch, lambda: F.conv3d(
            x_lib, w_lib, b_lib, padding=(MODES[mode], 0, 0)), 10)
        ops = 2.0 * 27 * ci * co * nb * d_out * (h - 2) * (w - 2)
        nbytes = 4.0 * (x.numel() + k.numel() + b.numel() + y.numel())
        bms, by = bound_ms(ops, nbytes, "tf32x3")
        print(f"  in {nb}x{d}x{h}x{w} {ci:>3}->{co:<3} '{mode}' "
              f"{'table ' if table else 'vector'} x{n}  {ops / 1e9:6.3f} "
              f"GFLOP  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
              f"tile eff. {tile_efficiency((h - 2, w - 2), K1_TILE):.3f})  "
              f"plain {plain:.4f} ms  cuDNN {lib:.4f} ms  bound {bms:.4f} "
              f"({by[0]}) ms  err vs plain {err:.3e}, vs f64 {f64:.3e}")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bms), ("ops", ops), ("bytes", nbytes)):
            tot[key] += n * v
        tot["launches"] += n
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["max_rel_err_f64"] = max(tot["max_rel_err_f64"], f64)
        del x, k, b, y, ref, x_lib, w_lib, b_lib
    tot["bound_by"] = bound_ms(tot["ops"], tot["bytes"], "tf32x3")[1]
    print(f"  {per} ({tot['launches']} launches): "
          f"{tot['ops'] / 1e9:.2f} GFLOP  kernel {tot['ms']:.4f} ms "
          f"({tot['ops'] / tot['ms'] / 1e9:.1f} TFLOP/s)  plain "
          f"{tot['plain_ms']:.4f} ms  cuDNN {tot['library_ms']:.4f} ms  "
          f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}; the sum's "
          f"own: {bound_ms(tot['ops'], tot['bytes'], 'tf32x3')[0]:.4f})  "
          f"max err vs f64 {tot['max_rel_err_f64']:.3e} of max|ref|")
    return tot


def cae_check_cli_run(name, tester, launches, per_case_k1, per_case_edt):
    """The launches of a CAE CLI run: K1 and edt_sites as its cases need
    them, no backward kernel and no single EDT pass."""
    n = len(tester.case_seconds)
    print(f"cae: {name} on {n} case(s); launches {launches}; per case K1 "
          f"{launches['conv3x3'] / n:g}, edt_sites "
          f"{launches['edt_sites'] / n:g}")
    if any(launches[k] for k in ("conv3x3_bwd_fused", "conv3x3_bwd_dx",
                                 "conv3x3_bwd_dw", "edt_parabola")):
        raise AssertionError(f"{name} launched a backward kernel or a "
                             f"single EDT pass")
    if (launches["conv3x3"] != per_case_k1 * n
            or launches["edt_sites"] != per_case_edt * n):
        raise AssertionError(f"{name}: expected {per_case_k1} K1 and "
                             f"{per_case_edt} edt_sites launches a case")


def cae_phase(torch, work):
    """The CAE serving path on the card: the shape tester's CLI on three
    full-size cases, K1 at its layers, a profile of its cases, one case
    against the CPU, and the curve tester's CLI on one case with its
    batched sweeps against the serial forwards."""
    from stroke_prediction_tpu_torch.cli import test_shape_reconstruction
    from stroke_prediction_tpu_torch.eval.cae_tester import (
        CaeReconstructionTester)
    from stroke_prediction_tpu_torch.models.convert import (
        save_cae_checkpoint)
    from stroke_prediction_tpu_torch.utils.args import get_args_shape_testing
    from stroke_prediction_tpu_torch.utils.nifti import read_nifti

    ckpt = os.path.join(work, "cae.model")
    save_cae_checkpoint(ckpt, cae_model(torch))
    base = os.path.join(work, "shape")
    # no --device: the CLI's default, the card
    args = get_args_shape_testing(["--path", ckpt, "--fold", *map(str, FOLD),
                                   "--synthetic", "--outbasepath", base])
    reset_launches()
    t0 = time.perf_counter()
    (tester,) = test_shape_reconstruction.test(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if tester.device.type != "cuda" or len(tester.case_seconds) != len(FOLD):
        raise AssertionError(f"the shape tester ran {tester.case_seconds} "
                             f"on {tester.device}")
    cae_check_cli_run("shape tester CLI", tester, launches, CAE_K1_PER_CASE,
                      CAE_EDT_PER_CASE)
    steady = tester.case_seconds[1:]
    infer_ms = 1e3 * sum(s[1] for s in steady) / len(steady)
    total_ms = 1e3 * sum(s[2] for s in steady) / len(steady)
    print(f"cae: CLI wall {wall:.2f} s; ms per case after the first: "
          f"{infer_ms:.2f} to metrics on the host (forward + three "
          f"measures), {total_ms:.2f} incl. the three NIfTI dumps; per case "
          f"(id, s, s): {tester.case_seconds}")
    for cid, _, _ in tester.case_seconds:
        for part in ("_core", "_pred", "_penu"):
            vol, _ = read_nifti(f"{base}_{cid}{part}.nii.gz")
            if vol.shape != (256, 256, 28) or not (
                    vol.min() >= 0.0 and vol.max() <= 1.0):
                raise AssertionError(f"case {cid}{part}: shape {vol.shape} "
                                     f"or values outside [0, 1]")
    check_dump_codecs(f"{base}_{tester.case_seconds[0][0]}_pred.nii.gz",
                      "cae")

    loader = tester._dataloader
    batch = loader.dataset.stack([loader.indices[0]])
    calls, edt_calls, worst = cae_recorded(
        torch, lambda: tester.infer_batch(batch))
    cae_check_recorded("one shape tester case", calls, edt_calls, worst,
                       {"K1": CAE_K1_PER_CASE},
                       {(1, *CAE_DHW): CAE_EDT_PER_CASE})
    k1 = cae_kernel_phase(torch, calls, "per CAE tester case")
    busy_ms, k1_busy = cae_profile(torch, tester, batch, infer_ms)

    # one case on the card and on the CPU (plain versions)
    with torch.inference_mode():
        m_gpu, dto_gpu = tester.infer_batch(batch)
        cpu = CaeReconstructionTester(loader, ckpt, base + "_cpu", 10, "cpu")
        t0 = time.perf_counter()
        m_cpu, dto_cpu = cpu.infer_batch(batch)
        cpu_s = time.perf_counter() - t0
    worst = 0.0
    for part in ("latents", "reconstructions"):
        for f in CAE_FIELDS:
            a = getattr(getattr(dto_gpu, part).gtruth, f).cpu()
            b = getattr(getattr(dto_cpu, part).gtruth, f)
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{part} {f}: {tuple(a.shape)} on the "
                                     f"card, {tuple(b.shape)} on the CPU")
            worst = max(worst, float((a - b).abs().max()))
    print(f"cae: case {int(batch['case_id'][0])} card vs CPU max|err| of the "
          f"latents and reconstructions {worst:.3e} (CPU plain path "
          f"{cpu_s:.1f} s)")
    if worst > CAE_ATOL:
        raise AssertionError(f"card and CPU CAE outputs differ by {worst}")
    for name, field in CAE_MEASURED.items():
        a = getattr(dto_gpu.reconstructions.gtruth, field).cpu() > 0.5
        b = getattr(dto_cpu.reconstructions.gtruth, field) > 0.5
        flips = int((a != b).sum())
        g, c = m_gpu[name], m_cpu[name]
        print(f"cae: {name} Dice {g.dc:.6f} / {c.dc:.6f}, HD {g.hd:.4f} / "
              f"{c.hd:.4f}, ASSD {g.assd:.4f} / {c.assd:.4f} (card / CPU); "
              f"{flips} voxels thresholded apart, of {a.sum()} / {b.sum()} "
              f"foreground")
        # equal masks: equal Dice; else each voxel apart moves Dice by at
        # most 3 / (|card mask| + |CPU mask|)
        limit = (3.0 * flips / max(1, int(a.sum() + b.sum())) if flips
                 else CAE_DICE_ATOL)
        if abs(g.dc - c.dc) > limit:
            raise AssertionError(f"{name} Dice: card {g.dc} vs CPU {c.dc} "
                                 f"({flips} voxels apart)")
    sweeps, k1_curve = cae_curve(torch, ckpt, base + "_curve")
    return dict(launches=launches, infer_ms=infer_ms, total_ms=total_ms,
                k1=k1, busy_ms=busy_ms, k1_busy=k1_busy, sweeps=sweeps,
                k1_curve=k1_curve)


def cae_profile(torch, tester, batch, infer_ms, reps=3):
    """Device time per CAE tester case by kernel (torch.profiler) and its
    share of the unprofiled ms per case."""
    from torch.autograd import DeviceType

    with torch.inference_mode():
        prof = profiled(torch, lambda: [tester.infer_batch(batch)
                                        for _ in range(reps)], "cae profile")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if not busy_ms:
        raise AssertionError("cae profile: no device time in the trace")
    groups = kernel_groups(kernels, reps)
    k1 = groups.get("K1 conv forward", (0.0, 0.0))
    print(f"cae profile: device busy {busy_ms:.3f} ms per case of "
          f"{infer_ms:.2f} ms ({100 * busy_ms / infer_ms:.1f}% busy) in "
          f"{sum(e.count for e in kernels) / reps:.0f} kernels; K1 "
          f"{k1[0]:.3f} ms ({100 * k1[0] / busy_ms:.1f}%, x{k1[1]:g})")
    print("  by kernel, per case: " + "; ".join(
        f"{g} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%, x{n:g})"
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"  {ms:8.4f} ms {100 * ms / busy_ms:5.1f}%  x{e.count / reps:g}"
              f"  {e.key[:90]}")
    if k1[1] != CAE_K1_PER_CASE:
        raise AssertionError(f"the profiled CAE case ran {k1[1]:g} K1 "
                             f"kernels, expected {CAE_K1_PER_CASE}")
    return busy_ms, k1


def cae_curve(torch, ckpt, base):
    """The curve tester's CLI on one case, K1 at its sweeps' layers, then
    each of its three sweeps batched (timed) against the serial forwards
    at the same steps."""
    from stroke_prediction_tpu_torch.cli import (
        test_shape_reconstruction_CurveAnalysis as curve_cli)
    from stroke_prediction_tpu_torch.utils.args import get_args_shape_testing

    args = get_args_shape_testing(["--path", ckpt, "--fold", str(FOLD[0]),
                                   "--synthetic", "--outbasepath", base])
    reset_launches()
    t0 = time.perf_counter()
    (curve,) = curve_cli.test(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cae_check_cli_run("curve tester CLI", curve, read_launches(),
                      CAE_K1_PER_CASE + 3 * CAE_SWEEP_K1,
                      CAE_EDT_PER_CASE + 3 * CAE_SWEEP_EDT)
    print(f"cae: curve CLI wall {wall:.2f} s (one case, NIfTI dumps "
          f"included)")

    loader = curve._dataloader
    batch = loader.dataset.stack([loader.indices[0]])
    k1 = cae_kernel_phase(torch, cae_sweep_calls(torch, curve, batch),
                          "per curve case's three sweeps")
    return cae_sweeps_vs_serial(torch, curve, batch), k1


def cae_sweep_calls(torch, curve, batch):
    """The calls in the case's three sweeps, each K1 and edt_sites call
    held on its own inputs against its plain version."""
    _, sweeps = curve.sweeps(batch)
    calls, edt_calls, worst = cae_recorded(torch, lambda: [
        curve.infer_batch_steps(batch, steps) for steps, _ in sweeps])
    edt_want = {}
    for steps, _ in sweeps:
        key = (len(steps), *CAE_DHW)
        edt_want[key] = edt_want.get(key, 0) + CAE_SWEEP_EDT
    cae_check_recorded("the curve case's three sweeps", calls, edt_calls,
                       worst, {"K1": 3 * CAE_SWEEP_K1}, edt_want)
    return calls


def cae_sweeps_vs_serial(torch, curve, batch):
    """Each sweep batched (timed) against the serial forwards at its steps,
    element by element and by the measures; the reconstruction must follow
    the step -> {sweep: (steps, ms)}."""
    _, sweeps = curve.sweeps(batch)
    out = {}
    for name, (steps, _) in zip(("fixed", "relative", "uniform"), sweeps):
        with torch.inference_mode():
            curve.infer_batch_steps(batch, steps)          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched, dto = curve.infer_batch_steps(batch, steps)
            ms = 1e3 * (time.perf_counter() - t0)
            serial = [curve.infer_batch(batch, s) for s in steps]
        rec = dto.reconstructions.gtruth.interpolation
        lat = dto.latents.gtruth.interpolation
        worst = 0.0
        for i, (s, a, (m, one)) in enumerate(zip(steps, batched, serial)):
            b = m["lesion"]
            worst = max(worst, float((rec[i] - one.reconstructions.gtruth
                                      .interpolation[0]).abs().max()),
                        float((lat[i] - one.latents.gtruth.interpolation[0])
                              .abs().max()))
            same_inf = a.assd == b.assd == float("inf")
            if (abs(a.dc - b.dc) > CAE_DICE_ATOL
                    or not (same_inf or abs(a.assd - b.assd)
                            <= CAE_ASSD_ATOL)):
                raise AssertionError(f"sweep {name} step {s}: batched "
                                     f"{a} vs serial {b}")
        if worst > CAE_ATOL:
            raise AssertionError(f"sweep {name}: a batched interpolation "
                                 f"latent or reconstruction is {worst} off "
                                 f"its serial one")
        # the reconstructions follow the step, so a wrong step or a swapped
        # sample would show in the comparisons above
        moved = float(((rec[0] > 0.5) != (rec[-1] > 0.5)).float().mean())
        dice_moved = abs(batched[0].dc - batched[-1].dc)
        out[name] = (len(steps), ms)
        print(f"cae: {name} sweep of {len(steps)} steps {ms:.2f} ms "
              f"batched (host clock, to the measures); equal to the serial "
              f"forwards (latents and reconstructions {worst:.3e} <= "
              f"{CAE_ATOL}, Dice {CAE_DICE_ATOL}, ASSD {CAE_ASSD_ATOL}); "
              f"first vs last step: {100 * moved:.2f}% of the voxels "
              f"thresholded apart, lesion Dice {dice_moved:.4f} apart; "
              f"lesion Dice {[round(m.dc, 4) for m in batched]}")
        if moved < CAE_MIN_MOVED or dice_moved <= CAE_DICE_ATOL:
            raise AssertionError(f"sweep {name}: the reconstruction barely "
                                 f"follows the step ({moved} of the voxels "
                                 f"and {dice_moved} of Dice moved)")
    return out


def train_phase(torch, work):
    """The port's training CLI at the reference configuration on the card:
    launch counts per step, finite losses, artifacts, the best-valid model
    loaded and run, ms per step, a profile of one step."""
    from stroke_prediction_tpu_torch.cli import train_unet_segmentation as cli
    from stroke_prediction_tpu_torch.models.factory import load_model
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

    base = os.path.join(work, "train")
    prof = os.path.join(work, "train_profile")
    args = get_args_unet_training(
        [os.path.join(work, "unused.model"), "--synthetic",
         "--fold", *map(str, TRAIN_FOLD), "--validsetsize", "0.25",
         "--batchsize", str(TRAIN_BATCH), "--epochs", "3",
         "--outbasepath", base, "--device", "cuda",
         "--channels", *map(str, CHANNELS), "--profile", prof])
    if args.dtype != "bfloat16":
        raise AssertionError(f"the CLI's default dtype is {args.dtype}")

    reset_launches()
    t0 = time.perf_counter()
    learner = cli.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = dict(learner.step_counts)
    print(f"\ntrain: CLI, 3 epochs in {wall:.2f} s; steps {steps}; "
          f"launches {launches}")

    # launches per step from the fused / split rule
    routes = [bwd_route(ci, co, i > 0) for i, (*_, ci, co) in
              enumerate(unet_conv_shapes(PATCH_DHW, CHANNELS))]
    n_train, n_eval = steps["train"], steps["eval"]
    want = {
        "conv3x3": 10 * (n_train + n_eval + steps["visual"]),
        "conv3x3_bwd_fused": routes.count("fused") * n_train,
        "conv3x3_bwd_dx": routes.count("split") * n_train,
        "conv3x3_bwd_dw": (routes.count("split") + routes.count("dw"))
        * n_train,
        "edt_sites": EDT_PER_STEP * n_eval}
    print(f"train: routes per layer {routes}; expected launches {want} and "
          f"no single EDT pass")
    if n_train != 3 or n_eval != 3:
        raise AssertionError(f"expected 3 train and 3 eval steps: {steps}")
    if launches["edt_parabola"]:
        raise AssertionError(f"edt_parabola launched "
                             f"{launches['edt_parabola']} times on the path")
    for name, n in want.items():
        if launches[name] != n or n < 1:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {n} (>= 1)")

    curves = learner._metric_dtos
    for phase in ("training", "validate"):
        losses = [m["loss"] for m in curves[phase]]
        print(f"train: {phase} losses {losses}")
        if len(losses) != 3 or not all(0.0 <= v <= 1.0 for v in losses):
            raise AssertionError(f"{phase} losses {losses}")
    check_artifacts(base, ["_unet.model", "_unet.optim", "_unet.json",
                           "_unet_final.model"],
                    ["_visual_1.png", "_visual_plots.png"], "train")
    model, config = load_model(base + "_unet.model", "cuda")
    with torch.no_grad():
        seg = model(torch.zeros((1,) + PATCH_DHW + (2,), device="cuda"))
    torch.cuda.synchronize()
    if tuple(seg.shape) != (1, 28, 64, 64, 2) or not torch.isfinite(
            seg).all():
        raise AssertionError(f"best-valid model: output {tuple(seg.shape)}")
    print(f"train: best-valid model {config} runs: output "
          f"{tuple(seg.shape)}")
    check_trace(prof, "train", n_train // 3)

    print(f"train: CLI training passes (s, steps): "
          f"{learner.train_pass_seconds}")
    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(TRAIN_BATCH, device="cuda")
    step_ms = time_steps(torch, lambda: learner.train_step(
        {k: None if v is None else v.index_select(0, rows)
         for k, v in data.items()}), TIMED_STEPS,
        f"train (bfloat16, batch {TRAIN_BATCH})")[0]
    profile_step(torch, learner)
    return launches, step_ms, learner


def check_artifacts(base, names, pngs, what):
    """The training CLI's files ``base + name`` exist and are not empty;
    the PNGs too where matplotlib is installed."""
    try:
        import matplotlib  # noqa: F401
        names = names + pngs
    except ImportError:
        print(f"{what}: no matplotlib here, so no PNGs are expected")
    for suffix in names:
        if not os.path.getsize(base + suffix):
            raise AssertionError(f"empty {base + suffix}")


def time_steps(torch, step, n, what):
    """``n`` calls of ``step`` (one training step) back to back after a
    warm-up call: host ms per step between two synchronizes, and the mean
    and spread of the device ms between CUDA events recorded after each
    step -> (mean, std, host ms)."""
    step()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(n):
        step()
        marks[i + 1].record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    per = sorted(marks[i].elapsed_time(marks[i + 1]) for i in range(n))
    mean = sum(per) / n
    std = (sum((v - mean) ** 2 for v in per) / n) ** 0.5
    print(f"{what}: {n} steps back to back: host {host_ms:.3f} ms per step; "
          f"CUDA events per step mean {mean:.3f} ms, std {std:.3f}, min "
          f"{per[0]:.3f}, median {per[n // 2]:.3f}, max {per[-1]:.3f}")
    return mean, std, host_ms


# profiler kernel names -> groups (first match wins)
PROFILE_GROUPS = (
    *((k, "K5 EDT") for k in EDT_KERNELS),
    ("conv3x3_fwd", "K1 conv forward"),
    ("conv3x3_bwd_dx_tc_kernel", "K3 dx"),
    ("conv3x3_bwd_dw_tc_kernel", "K4 dW"),
    ("conv3x3_bwd_tc_kernel", "K2 fused"),
    ("conv3x3_bwd_dx_f32_tc_kernel", "K3 dx (float32)"),
    ("conv3x3_bwd_f32_tc_kernel", "K2 fused (float32)"),
    ("conv3x3_bwd_dw_f32_tc_kernel", "K4 dW (float32)"),
    ("finalize", "K2/K4 dW, db reductions"),
    ("MeanOps", "BN moments (means)"), ("MaxOps", "max reductions"),
    ("multi_tensor_apply", "Adam (foreach)"),
    ("gemm", "matmuls (upsample, 1^3 head)"),
    ("xmma", "matmuls (upsample, 1^3 head)"),
    ("Memcpy", "copies"), ("copy", "copies / casts"))


def kernel_groups(kernels, reps=1):
    """{group: (device ms, kernels)} per rep of profiler kernel events."""
    groups = {}
    for e in kernels:
        g = next((name for frag, name in PROFILE_GROUPS if frag in e.key),
                 "other elementwise / reductions")
        ms, n = groups.get(g, (0.0, 0.0))
        groups[g] = (ms + e.self_device_time_total / 1e3 / reps,
                     n + e.count / reps)
    return groups


def profile_step(torch, learner):
    """One training step: device time by phase (CUDA events around the
    parts of ``UnetSegmentationLearner.train_step``) and by kernel
    (torch.profiler), and the device's busy share of the step's wall."""
    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(TRAIN_BATCH, device="cuda")
    batch = {k: None if v is None else v.index_select(0, rows)
             for k, v in data.items()}
    model, opt = learner._model.train(), learner._optimizer

    def step(marks):
        marks[0].record()
        images, labels = learner.crop(batch)
        loss, outs = learner.forward_loss(images, labels)
        marks[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        marks[2].record()
        opt.step()
        marks[3].record()
        with torch.no_grad():
            learner._metrics(loss, *(o.detach() for o in outs),
                             training=True)
        marks[4].record()

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    step(marks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(marks)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    phases = ["crop + forward + loss", "backward", "Adam", "metrics"]
    print(f"train profile: one step {wall_ms:.2f} ms (host clock); by phase "
          f"(CUDA events): " + "; ".join(
              f"{name} {marks[i].elapsed_time(marks[i + 1]):.3f} ms"
              for i, name in enumerate(phases)))
    trace_kernels(torch, lambda: step(marks), "train profile", wall_ms)


def trace_kernels(torch, run, what, wall_ms):
    """``run()`` under torch.profiler: the device's busy ms and share of
    ``wall_ms``, the kernels' count, their time by group and the largest
    fifteen -> (busy ms, kernels, {group: (ms, count)}); (0, 0, {}) when
    the trace holds no device time."""
    from torch.autograd import DeviceType

    prof = profiled(torch, run, what)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        print(f"{what}: no device time in the trace (not measured)")
        return 0.0, 0, {}
    n_kernels = sum(e.count for e in kernels)
    groups = kernel_groups(kernels)
    print(f"{what}: device busy {busy_ms:.3f} ms of {wall_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy); {n_kernels} kernels")
    print("  by kernel: " + "; ".join(
        f"{g} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%, x{c:g})"
        for g, (ms, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:8.4f} ms {100 * ms / busy_ms:5.1f}%  x{e.count}"
              f"  {e.key[:100]}")
    return busy_ms, n_kernels, groups


def unet_step_side(torch, model, imgs, labs, stub, side, dev, dtype):
    """One side of :func:`step_vs_cpu`: the U-Net training step (forward,
    loss, backward) of ``model`` in ``dtype`` on ``dev`` -> (loss,
    gradients, running statistics, seconds); "zeroed" in ``side`` zeroes
    the entry conv's K4 output."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm

    real_dw = cm.conv3x3_bwd_dw

    def entry_dw_zeroed(x, *args):
        """K4 with the entry conv's (data input) dW and db zeroed."""
        out = real_dw(x, *args)
        return (tuple(torch.zeros_like(t) for t in out)
                if x.shape[-1] == CHANNELS[0] else out)

    entry_dw_zeroed.launches = 0
    wide = torch.promote_types(dtype, torch.float32)
    m = copy.deepcopy(model).to(dev, wide).train()
    m.compute_dtype = dtype
    t0 = time.perf_counter()
    seg = m(imgs.to(dev))
    labs_d = labs.to(dev, wide)
    loss = stub.loss(seg[..., 0:1], seg[..., 1:2], labs_d[..., 0:1],
                     labs_d[..., 1:2])
    if "zeroed" in side:
        cm.conv3x3_bwd_dw = entry_dw_zeroed
    try:
        loss.backward()
    finally:
        cm.conv3x3_bwd_dw = real_dw
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (float(loss.detach()),
            {k: p.grad.cpu().double() for k, p in m.named_parameters()},
            {k: b.cpu().double() for k, b in m.named_buffers()}, secs)


def step_vs_cpu(torch, learner):
    """One float32 training step (forward, loss, backward; no optimizer
    step) at full width and patch, batch 2, on the card and on the CPU from
    the same weights and crop, and the same step in float64 on the CPU: the
    card's float32 step is held to the float64 one at the STEP_* limits;
    the CPU's float32 step against both is printed (its sums' order, which
    the host's CPU and thread count set, put it 6.2e-4 to 7.2e-4 of
    max|grad| off float64 on one host, the card 1.3e-4).  The same
    step in bfloat16 on the card and on the CPU, with two controls
    (:func:`unet_bf16_step_check`).  The CPU sides run in the witnesses'
    pool; the comparisons when the returned :class:`Deferred` resolves."""
    from stroke_prediction_tpu_torch.data.augment import (
        crop_patch, random_offsets)
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D

    data, _ = learner.device_data(learner._dataloader_training)
    images = data[KEY_IMAGES][:2].cpu()
    labels = data[KEY_LABELS][:2].cpu()
    offsets = random_offsets(torch.Generator().manual_seed(2), 2,
                             tuple(images.shape[1:4]), PATCH_DHW[::-1])
    imgs, labs = crop_patch(images, labels, offsets, PATCH_DHW[::-1],
                            (20, 20, 20))
    model = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(3))
    stub = learner_stub(learner)
    sides = (("card", "cuda", torch.float32),
             ("CPU", "cpu", torch.float32),
             ("CPU float64", "cpu", torch.float64),
             ("card bfloat16", "cuda", torch.bfloat16),
             ("card bfloat16, entry K4 zeroed", "cuda", torch.bfloat16),
             ("CPU bfloat16", "cpu", torch.bfloat16))
    cpu = {side: witness(unet_step_side, model, imgs, labs, stub, side,
                         dev, dtype)
           for side, dev, dtype in sides if dev == "cpu"}
    out = {side: unet_step_side(torch, model, imgs, labs, stub, side, dev,
                                dtype)
           for side, dev, dtype in sides if dev != "cpu"}
    return Deferred(lambda: step_vs_cpu_check(out, cpu))


def step_vs_cpu_check(out, cpu):
    """:func:`step_vs_cpu`'s comparisons, its CPU sides in."""
    out.update({side: f.result() for side, f in cpu.items()})

    def compare(a, b):
        """(loss rel, (worst grad err / max|grad|, its name), stats err)."""
        (l_a, g_a, b_a, _), (l_b, g_b, b_b, _) = out[a], out[b]
        grad = max((rel_err(g_a[k], g_b[k]), k) for k in g_b)
        stats = max(float((b_a[k] - b_b[k]).abs().max()) for k in b_b)
        print(f"step {a} vs {b} (batch 2, {len(g_b)} gradients): loss "
              f"{l_a:.9f} / {l_b:.9f} (rel {abs(l_a - l_b) / abs(l_b):.2e}); "
              f"max grad err {grad[0]:.2e} of max|grad| at {grad[1]}; "
              f"running stats max|err| {stats:.2e}")
        return abs(l_a - l_b) / abs(l_b), grad, stats

    print("\nstep seconds: " + ", ".join(f"{side} {v[3]:.2f} s"
                                         for side, v in out.items()))
    card32 = compare("card", "CPU")
    loss_rel, grad, stats_err = card64 = compare("card", "CPU float64")
    cpu64 = compare("CPU", "CPU float64")
    print(f"step float32 vs float64: card {card64[1][0]:.2e}, CPU "
          f"{cpu64[1][0]:.2e} of max|grad|: the "
          f"{'card' if card64[1][0] > cpu64[1][0] else 'CPU'} is further off")
    if loss_rel > STEP_LOSS_REL or grad[0] > STEP_GRAD_REL or \
            stats_err > STEP_STATS_ATOL:
        raise AssertionError("the card's float32 training step is beyond "
                             "the STEP_* limits of the float64 step")
    bf16 = unet_bf16_step_check(out)
    return dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
                stats_err=stats_err, card_vs_cpu=card32[1][0],
                cpu_vs_f64=cpu64[1][0], bfloat16=bf16)


def unet_layer_of(key):
    """A U-Net parameter's layer: a block's layer (its BN and conv) or a
    head conv."""
    parts = key.split(".")
    return ".".join(parts[:4] if parts[0] == "blocks" else parts[:2])


def unet_bf16_step_check(out):
    """The bfloat16 U-Net step (same weights and crop) on the card against
    the CPU's bfloat16 step by the CAE bfloat16 step's limits
    (:func:`bf16_step_check`, stated before this check's first run), with
    its two controls: the entry conv's K4 output zeroed on the card, and
    the card's entry BN gradients zeroed."""
    entry = "blocks.0.layers.0.bn."
    card = out["card bfloat16"]
    out["card bfloat16, entry BN zeroed"] = (card[0], {
        k: g.new_zeros(g.shape) if k.startswith(entry) else g
        for k, g in card[1].items()}) + card[2:]
    return bf16_step_check(out, unet_layer_of, "U-Net step (batch 2)", (
        "card bfloat16, entry K4 zeroed", "card bfloat16, entry BN zeroed"))


def grad_compare(out, a, b, layer_of, what):
    """Side ``a`` of a training step against side ``b`` (``out``: {side:
    (loss, {parameter: gradient}, {buffer: value}, seconds)}) -> (loss
    rel, (worst gradient's |err| / its layer's largest |grad| of ``b``, its
    name), running statistics max|err|, {layer: |g_a - g_b| / |g_b| over
    the layer's gradients}), ``layer_of`` naming a parameter's layer."""
    (l_a, g_a, b_a, _), (l_b, g_b, b_b, _) = out[a], out[b]
    if set(g_a) != set(g_b):
        raise AssertionError(f"{what} {a} vs {b}: gradients of "
                             f"{sorted(set(g_a) ^ set(g_b))}")
    scale, diff2, ref2 = {}, {}, {}
    for k, g in g_b.items():
        lay = layer_of(k)
        scale[lay] = max(scale.get(lay, 0.0), float(g.abs().max()))
        diff2[lay] = diff2.get(lay, 0.0) + float(((g_a[k] - g) ** 2).sum())
        ref2[lay] = ref2.get(lay, 0.0) + float((g ** 2).sum())
    grad = max((float((g_a[k] - g_b[k]).abs().max()) / scale[layer_of(k)],
                k) for k in g_b)
    norm = {lay: (diff2[lay] / ref2[lay]) ** 0.5 for lay in scale}
    stats = max(float((b_a[k] - b_b[k]).abs().max()) for k in b_b)
    worst = max(norm, key=norm.get)
    loss_rel = abs(l_a - l_b) / abs(l_b)
    print(f"{what} {a} vs {b} ({len(g_b)} gradients): loss {l_a:.9f} / "
          f"{l_b:.9f} (rel {loss_rel:.2e}); max grad err {grad[0]:.2e} of "
          f"its layer's max|grad| at {grad[1]}; per layer |err| / |grad| at "
          f"most {norm[worst]:.2e} ({worst}); running stats max|err| "
          f"{stats:.2e}")
    return loss_rel, grad, stats, norm


def bf16_step_check(out, layer_of, what, controls):
    """The card's bfloat16 step ("card bfloat16") against the CPU's ("CPU
    bfloat16"), the float64 CPU step the witness: the loss and the running
    statistics within CAE_BF16_LOSS_REL and CAE_BF16_STATS_ATOL of the
    CPU's, each gradient within CAE_BF16_GRAD_REL of its layer's largest
    CPU gradient, and per layer against float64 (|err| / |grad| over the
    layer) no further off than CAE_BF16_GRAD_FACTOR times the CPU's
    bfloat16 step plus CAE_BF16_GRAD_FLOOR.  Each of ``controls`` (sides of
    ``out``) must fail the gradient limit -> the card's readings, with the
    controls'."""
    cpu64 = grad_compare(out, "CPU bfloat16", "CPU float64", layer_of,
                         what)[3]

    def check(card):
        loss_rel, grad, stats, _ = grad_compare(out, card, "CPU bfloat16",
                                                layer_of, what)
        card64 = grad_compare(out, card, "CPU float64", layer_of, what)[3]
        excess = {lay: card64[lay] - (CAE_BF16_GRAD_FACTOR * cpu64[lay]
                                      + CAE_BF16_GRAD_FLOOR)
                  for lay in cpu64}
        worst = max(excess, key=excess.get)
        res = dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
                   stats_err=stats, card_vs_f64=max(card64.values()),
                   cpu_vs_f64=max(cpu64.values()), worst_layer=worst,
                   worst_layer_card_cpu_vs_f64=(card64[worst], cpu64[worst]))
        failed = [name for name, bad in (
            ("loss", loss_rel > CAE_BF16_LOSS_REL),
            ("stats", stats > CAE_BF16_STATS_ATOL),
            ("grad", grad[0] > CAE_BF16_GRAD_REL),
            ("grad vs float64", excess[worst] > 0)) if bad]
        print(f"{what} {card} vs float64, per layer |err| / |grad|: card "
              f"{res['card_vs_f64']:.3e}, CPU {res['cpu_vs_f64']:.3e} at "
              f"most; nearest its limit: {worst} card {card64[worst]:.3e} "
              f"vs CPU {cpu64[worst]:.3e}; limits failed: {failed}")
        return res, failed

    res, failed = check("card bfloat16")
    if failed:
        raise AssertionError(f"{what} bfloat16: card and CPU differ beyond "
                             f"the {failed} limits: {res}")
    res["controls"] = {}
    for card in controls:
        r, failed = check(card)
        res["controls"][card] = dict(grad_rel=r["grad_rel"],
                                     worst_grad=r["worst_grad"],
                                     failed=failed)
        if "grad" not in failed:
            raise AssertionError(f"{what} bfloat16: the {card} control "
                                 f"passes the CAE_BF16_GRAD_REL limit: {r}")
    return res


# CAE phase-1 training at the reference width (--channelscae default) and
# batch (--batchsize 4) on eight synthetic cases, six training and two
# validating, three epochs; the card-vs-CPU steps at batch 2 keep the CPU's
# share of the run short
CAE_TRAIN_BATCH = 4
CAE_TRAIN_EPOCHS = 3
CAE_TIMED_STEPS = 10
# the plain version and cuDNN beside each kernel in the per-layer tables:
# timed over 5 calls, or over 2 where one call takes longer than
# YARDSTICK_SLOW_MS (a CAE step's plain dW alone takes ~0.7 s a call, and
# the script's time limit is shared by every phase)
YARDSTICK_SLOW_MS = 20.0
CAE_VS_CPU_BATCH = 2
CAE_VS_CPU_FACTOR = 0.4          # the latent L1 term on
# one bfloat16 CAE step, card vs CPU (the CPU's plain versions round to
# bfloat16 where the kernels do, so only the sums' order differs), from
# seeded weights:
# * the loss and the running statistics within CAE_BF16_LOSS_REL and
#   CAE_BF16_STATS_ATOL of the CPU's;
# * each gradient within CAE_BF16_GRAD_REL of its layer's largest
#   gradient (its BN and conv) of the CPU's.  The first limit stated here,
#   1e-1, read 0.112 on the card at enc.encoder.blocks.9.conv.kernel, the
#   fc conv's kernel, while the float64 rule below held; 0.25 sits between
#   that reading and the two controls that must fail it (a card step with
#   the entry conv's K4 output zeroed, and the card's entry BN gradients
#   zeroed): a zero gradient of the layer reads 1.0, and the entry BN's
#   bfloat16 bias gradient stands ~0.8 of its layer's largest gradient
#   off float64 on both sides;
# * each layer's gradients against float64 (|err| / |grad| over the layer)
#   no further off than CAE_BF16_GRAD_FACTOR times the CPU's bfloat16 ones
#   plus CAE_BF16_GRAD_FLOOR: the CPU's own bfloat16 step is 0.55 of the
#   entry layer's gradients' norm off float64, the bias gradients being
#   sums over every voxel that cancel far below their terms, so this rule
#   alone would pass a zero layer (1.0).
CAE_BF16_LOSS_REL, CAE_BF16_STATS_ATOL = 2e-2, 2e-2
CAE_BF16_GRAD_REL = 0.25
CAE_BF16_GRAD_FACTOR, CAE_BF16_GRAD_FLOOR = 2.0, 1e-2
CAE_ENTRY = "enc.encoder.blocks.0"


def cae_conv_layers(channels=CAE_CHANNELS):
    """(C_in, C_out, input needs a gradient) of the stride-1 3^3 convs (K1)
    of one encode and of one decode, in call order."""
    c_in, origin, d2, d4, d8, fc = channels[:6]
    encode = [(c_in, origin, False), (origin, origin, True), (d2, d2, True),
              (d2, d2, True), (d4, d4, True), (d4, d4, True), (d8, fc, True)]
    decode = [(d4, d4, True), (d4, d2, True), (d2, d2, True),
              (d2, origin, True), (origin, origin, True),
              (origin, origin, True)]
    return encode, decode


def cae_step_launches(channels=CAE_CHANNELS):
    """K1-K4 launches of one training step (three encodes, four decodes)
    as the route rule gives them, and K1's of one forward."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    encode, decode = cae_conv_layers(channels)
    routes = ([bwd_route(*c) for c in encode] * 3
              + [bwd_route(*c) for c in decode] * 4)
    return {"K1": len(routes), "K2": routes.count("fused"),
            "K3": routes.count("split"),
            "K4": routes.count("split") + routes.count("dw")}


def set_cae_dtype(model, dtype):
    model.enc.encoder.compute_dtype = dtype
    model.dec.decoder.compute_dtype = dtype


def cae_train_phase(torch, work):
    """CAE phase-1 training on the card: the port's CLI in its default
    bfloat16, launches per step and per validation batch, finite losses,
    artifacts and the best-valid model in the shape tester; every K1-K4 call
    of one step in each type on its own inputs; K1-K4 at each distinct
    layer of a step; ms per step and a profile of one; one float32 and one
    bfloat16 step on the card against the CPU."""
    from stroke_prediction_tpu_torch.cli import train_shape_reconstruction
    from stroke_prediction_tpu_torch.data.loader import get_testdata
    from stroke_prediction_tpu_torch.eval.cae_tester import (
        CaeReconstructionTester)
    from stroke_prediction_tpu_torch.utils.args import (
        get_args_shape_training)

    base = os.path.join(work, "shape_train")
    # no --device, no --dtype, no --channelscae: the card, bfloat16, the
    # reference width
    args = get_args_shape_training(
        ["--synthetic", "--fold", *map(str, TRAIN_FOLD), "--validsetsize",
         "0.25", "--batchsize", str(CAE_TRAIN_BATCH), "--epochs",
         str(CAE_TRAIN_EPOCHS), "--outbasepath", base])
    if args.dtype != "bfloat16" or tuple(args.channelscae) != CAE_CHANNELS:
        raise AssertionError(f"the CLI's defaults: {args.dtype}, "
                             f"{args.channelscae}")
    reset_launches()
    t0 = time.perf_counter()
    learner = train_shape_reconstruction.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = dict(learner.step_counts)
    per_step = cae_step_launches()
    fwd = per_step["K1"]
    n_train, n_eval, n_vis = steps["train"], steps["eval"], steps["visual"]
    want = {"conv3x3": fwd * (n_train + n_eval + n_vis),
            "conv3x3_bwd_fused": per_step["K2"] * n_train,
            "conv3x3_bwd_dx": per_step["K3"] * n_train,
            "conv3x3_bwd_dw": per_step["K4"] * n_train,
            "edt_sites": CAE_EDT_PER_CASE * n_eval, "edt_parabola": 0}
    print(f"\ncae train: CLI, {CAE_TRAIN_EPOCHS} epochs in {wall:.2f} s; "
          f"steps {steps}; launches {launches}; per training step "
          f"{per_step}, per validation batch K1 {fwd} and "
          f"{CAE_EDT_PER_CASE} edt_sites, per visual forward K1 {fwd}; "
          f"training passes (s, steps) {learner.train_pass_seconds}")
    if (learner.device.type != "cuda" or n_train != 2 * CAE_TRAIN_EPOCHS
            or n_eval != CAE_TRAIN_EPOCHS):
        raise AssertionError(f"cae train: steps {steps} on "
                             f"{learner.device}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"cae train: {name} launched "
                                 f"{launches[name]} times, expected {n}")
    curves = learner._metric_dtos
    for phase in ("training", "validate"):
        losses = [m["loss"] for m in curves[phase]]
        print(f"cae train: {phase} losses {losses}; lesion Dice "
              f"{[round(m['lesion_dc'], 4) for m in curves[phase]]}")
        if len(losses) != CAE_TRAIN_EPOCHS or not all(
                math.isfinite(v) and v >= 0.0 for v in losses):
            raise AssertionError(f"cae train: {phase} losses {losses}")
    check_artifacts(base, ["_cae1.model", "_cae1.optim", "_cae1.json",
                           "_cae1_final.model"],
                    ["_cae1_1.png", "_cae1_plots.png"], "cae train")
    valid = learner._dataloader_validation
    tester = CaeReconstructionTester(
        get_testdata(valid.dataset, valid.indices, shuffle=False),
        base + "_cae1.model", base + "_tester", 10, "cuda")
    vb = valid.dataset.stack(valid.indices[:1])
    with torch.inference_mode():
        m, dto = tester.infer_batch(vb)
    rec = dto.reconstructions.gtruth.interpolation
    if tuple(rec.shape) != (1, *CAE_DHW, 1) or not torch.isfinite(rec).all():
        raise AssertionError(f"best-valid CAE: {tuple(rec.shape)}")
    print(f"cae train: best-valid _cae1.model runs in the CAE tester: "
          f"lesion Dice {m['lesion'].dc:.4f}, HD {m['lesion'].hd:.2f}")

    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(CAE_TRAIN_BATCH, device="cuda")
    batch = {k: None if v is None else v.index_select(0, rows)
             for k, v in data.items()}
    # the validation batch as the CLI's epochs ran it (bfloat16): K1 and
    # edt_sites on their own inputs
    vdata, _ = learner.device_data(valid)
    if (len(valid.indices), *CAE_DHW) != EDT_CAE_VALID:
        raise AssertionError(f"cae train: {len(valid.indices)} validation "
                             f"cases")
    v_calls, v_sites, v_worst = cae_recorded(
        torch, lambda: learner.eval_step(vdata))
    cae_check_recorded("one bfloat16 validation batch", v_calls, v_sites,
                       v_worst, {"K1": fwd}, {EDT_CAE_VALID: CAE_EDT_PER_CASE})
    recorded = {}
    for dtype in (torch.bfloat16, torch.float32):
        set_cae_dtype(learner._model, dtype)
        calls, sites, worst = cae_recorded(
            torch, lambda: learner.train_step(batch, CAE_VS_CPU_FACTOR),
            grad=True)
        cae_check_recorded(f"one {str(dtype)[6:]} training step", calls,
                           sites, worst, per_step, {})
        recorded[dtype] = calls, worst
    set_cae_dtype(learner._model, torch.bfloat16)
    times = {dtype: cae_step_kernel_times(torch, calls)
             for dtype, (calls, _) in recorded.items()}
    mean, std, host = time_steps(torch, lambda: learner.train_step(batch),
                                 CAE_TIMED_STEPS,
                                 f"cae train (bfloat16, batch "
                                 f"{CAE_TRAIN_BATCH})")
    step_ms = dict(mean=mean, std=std, host=host)
    busy = cae_profile_step(torch, learner, batch)
    vs_cpu = cae_steps_vs_cpu(torch, learner)
    return dict(launches=launches, per_step=per_step, steps=steps,
                recorded={str(d)[6:]: r[1] for d, r in recorded.items()},
                times={str(d)[6:]: t for d, t in times.items()},
                step_ms=step_ms, busy=busy, vs_cpu=vs_cpu, wall=wall,
                learner=learner)


def cae_layer_times(torch, key, dtype, gen):
    """K1 and the backward kernels its route takes at one CAE layer (random
    inputs at the recorded shape), timed beside their plain versions and
    cuDNN's forward, dgrad and wgrad (TF32 off), with the bound."""
    import torch.nn.functional as F

    from stroke_prediction_tpu_torch.ops.conv3x3 import (
        MODES, conv3x3, conv3x3_bwd_dw, conv3x3_bwd_dw_plain, conv3x3_bwd_dx,
        conv3x3_bwd_dx_plain, conv3x3_bwd_fused, conv3x3_bwd_fused_plain,
        conv3x3_plain)

    nb, d, h, w, ci, co, mode, table, act, route = key
    dname = str(dtype)[6:]
    dev = torch.device("cuda")

    def uniform(shape, lo, hi, dt=dtype):
        t = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
        return t.to(dt)

    d_out = d if mode == "s" else d - 2
    bnd = (27 * ci) ** -0.5
    x = uniform((nb, d, h, w, ci), -1.0, 1.0)
    k = uniform((3, 3, 3, ci, co), -bnd, bnd)
    b = uniform((d_out, co) if table else (co,), -bnd, bnd, torch.float32)
    y = conv3x3(x, k, b, act, 1.0, mode)
    g = uniform(y.shape, -1.0, 1.0)
    pad = (MODES[mode], 0, 0)
    gp = (g.float() * torch.where(y > 0, 1.0, y.float() + 1.0)).to(dtype)
    x_l, g_l = x.permute(0, 4, 1, 2, 3), gp.permute(0, 4, 1, 2, 3)
    w_l = k.permute(4, 3, 0, 1, 2).contiguous()
    b_l = (b[0] if table else b).to(dtype).contiguous()
    runs = {"K1": (lambda: conv3x3(x, k, b, act, 1.0, mode),
                   lambda: conv3x3_plain(x, k, b, act, 1.0, mode),
                   lambda: F.conv3d(x_l, w_l, b_l, padding=pad))}
    dgrad = lambda: torch.nn.grad.conv3d_input(  # noqa: E731
        tuple(x_l.shape), w_l, g_l, padding=pad)
    wgrad = lambda: torch.nn.grad.conv3d_weight(  # noqa: E731
        x_l, tuple(w_l.shape), g_l, padding=pad)
    if route == "fused":
        runs["K2"] = (lambda: conv3x3_bwd_fused(x, g, y, k, act, 1.0, mode,
                                                table),
                      lambda: conv3x3_bwd_fused_plain(x, g, y, k, act, 1.0,
                                                      mode, table),
                      lambda: (dgrad(), wgrad()))
    if route in ("split", "dx"):
        runs["K3"] = (lambda: conv3x3_bwd_dx(g, y, k, x.shape, act, 1.0,
                                             mode),
                      lambda: conv3x3_bwd_dx_plain(g, y, k, x.shape, act,
                                                   1.0, mode), dgrad)
    if route in ("split", "dw"):
        runs["K4"] = (lambda: conv3x3_bwd_dw(x, g, y, act, 1.0, mode, table),
                      lambda: conv3x3_bwd_dw_plain(x, g, y, act, 1.0, mode,
                                                   table), wgrad)
    nbyte = 2 if dtype == torch.bfloat16 else 4
    flops = 2.0 * 27 * ci * co * y[..., 0].numel()
    nx, ny, nk, nbias = x.numel(), y.numel(), k.numel(), b.numel()
    ops = {"K1": flops, "K2": 2 * flops, "K3": flops, "K4": flops}
    nbytes = {                          # each input once, each output once
        "K1": nbyte * (nx + nk + ny) + 4 * nbias,
        "K2": nbyte * (2 * nx + 2 * ny + nk) + 4 * (nk + nbias),
        "K3": nbyte * (2 * ny + nk + nx),
        "K4": nbyte * (nx + 2 * ny) + 4 * (nk + nbias)}
    out = {}
    for kern, (fn, plain, lib) in runs.items():
        bms, by = bound_ms(ops[kern], nbytes[kern], peak_key(kern, dname))
        out[kern] = dict(ms=cuda_ms(torch, fn, 5),
                         plain_ms=yardstick_ms(torch, plain),
                         library_ms=yardstick_ms(torch, lib), bound_ms=bms,
                         bound_by=by, ops=ops[kern], bytes=nbytes[kern],
                         t_ops=ops[kern] / PEAK_FLOPS[peak_key(kern, dname)]
                         * 1e3, t_bytes=nbytes[kern] / PEAK_BYTES * 1e3)
    return out


def cae_step_kernel_times(torch, calls, want=None, what="cae train",
                          layers=None):
    """K1-K4 at each distinct layer of a recorded step (calls keyed by K1's
    shapes and storage type), each layer's times times its calls ->
    {kernel: sums}; the launches a step must be ``want`` (phase 1's by the
    route rule when not given).  A layer's route is the one its backward
    calls took: K2 fused, K3 + K4 split, K4 alone dw, K3 alone dx (frozen
    parameters), none (no backward).  ``layers``, where given, receives
    each K1 key's {kernel: times}."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    gen = torch.Generator(device="cuda").manual_seed(4)
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   ops=0.0, bytes=0.0, t_ops=0.0, t_bytes=0.0, launches=0)
           for k in CAE_KERNELS}
    dtypes = sorted({key[-1] for key in calls})
    print(f"{what}: K1-K4 per distinct layer of one step ({dtypes}; x n = "
          f"calls a step; ms kernel / plain / cuDNN (K2: dgrad + wgrad) / "
          f"bound; TFLOP/s; bound in bf16, float32 in 3xTF32):")

    # a layer: its shapes, mode and type.  K3's calls do not carry the
    # bias form, so layers that differ only in it (an encoder's plane table
    # and a decoder's vector at 7x29x29, 32 -> 32) are one group, whose
    # backward calls the first of its K1 forms is timed with
    groups = {}
    for key, n in calls.items():
        groups.setdefault(key[1:8] + key[-1:], {})[key[0]] = groups.get(
            key[1:8] + key[-1:], {}).get(key[0], 0) + n
    timed = set()
    for key, n in calls.items():
        if key[0] != "K1":
            continue
        nb, d, h, w, ci, co = key[1:7]
        group = key[1:8] + key[-1:]
        bwd = {k: groups[group].get(k, 0) for k in ("K2", "K3", "K4")}
        route = {frozenset({"K2"}): "fused", frozenset({"K3", "K4"}): "split",
                 frozenset({"K4"}): "dw", frozenset({"K3"}): "dx",
                 frozenset(): "none"}[frozenset(k for k, c in bwd.items()
                                                if c)]
        if route != "none" and route != bwd_route(ci, co, route != "dw",
                                                  route != "dx"):
            raise AssertionError(f"{what}: {key} took route {route}")
        if route == "split" and bwd["K3"] != bwd["K4"]:
            raise AssertionError(f"{what}: {key}: K3 x{bwd['K3']}, K4 "
                                 f"x{bwd['K4']}")
        if group in timed:
            route = "none"          # its backward timed with the first form
        timed.add(group)
        times = cae_layer_times(torch, key[1:-1] + (route,),
                                getattr(torch, key[-1]), gen)
        if layers is not None:
            layers[key] = times
        parts = []
        for kern, t in times.items():
            n_kern = n if kern == "K1" else bwd[kern]
            for f in ("ms", "plain_ms", "library_ms", "bound_ms", "ops",
                      "bytes", "t_ops", "t_bytes"):
                tot[kern][f] += n_kern * t[f]
            tot[kern]["launches"] += n_kern
            parts.append(f"{kern} x{n_kern} {t['ms']:.4f}/{t['plain_ms']:.4f}"
                         f"/{t['library_ms']:.4f}/{t['bound_ms']:.4f}"
                         f"({t['bound_by'][0]}) "
                         f"{t['ops'] / t['ms'] / 1e9:.1f}")
        print(f"  {key[-1]:8s} in {nb}x{d}x{h}x{w} {ci:>3}->{co:<3} "
              f"'{key[7]}' {'table ' if key[8] else 'vector'} route "
              f"{route:5s} " + "  ".join(parts))
    for kern, t in tot.items():
        t["bound_by"] = ("operations" if t["t_ops"] >= t["t_bytes"]
                         else "bytes")
        t["gflop"] = t["ops"] / 1e9
        if t["launches"]:
            print(f"  per step {kern} ({t['launches']} launches): "
                  f"{t['gflop']:.2f} GFLOP  kernel {t['ms']:.4f} ms "
                  f"({t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s)  plain "
                  f"{t['plain_ms']:.4f} ms  cuDNN {t['library_ms']:.4f} ms  "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    want = cae_step_launches() if want is None else want
    got = {k: t["launches"] for k, t in tot.items()}
    if got != {k: want.get(k, 0) for k in CAE_KERNELS}:
        raise AssertionError(f"{what}: the timed layers give {got} "
                             f"launches a step, expected {want}")
    return tot


def cae_profile_step(torch, learner, batch, what="cae train"):
    """One CAE learner's training step under torch.profiler: device busy,
    the hand kernels' share, the number of kernels."""
    learner.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.train_step(batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, n_kernels, groups = trace_kernels(
        torch, lambda: learner.train_step(batch), f"{what} profile",
        wall_ms)
    if not busy_ms:
        raise AssertionError(f"{what} profile: no device time in the trace")
    hand = sum(ms for g, (ms, _) in groups.items() if g.startswith("K"))
    print(f"{what} profile: one step {wall_ms:.2f} ms (host clock, "
          f"unprofiled); K1-K5 {hand:.3f} ms ({100 * hand / busy_ms:.1f}% "
          f"of device busy)")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, kernels=n_kernels,
                hand_ms=hand)


def cae_layer_of(key):
    """A CAE parameter's layer: an encoder block (its BN and conv), a
    decoder conv or transposed conv with the BN in front of it, or a dense
    layer of the step head."""
    from stroke_prediction_tpu_torch.models.cae3d import DecoderStack

    parts = key.split(".")
    if parts[:3] == ["dec", "decoder", "bns"]:
        kind, i = DecoderStack.ORDER[int(parts[3])]
        return f"dec.decoder.{kind}s.{i}"
    return ".".join(parts[:4] if parts[1] in ("encoder", "decoder")
                    else parts[:2])


def cae_step_side(torch, model, labels, clinical, noise, flip, stub, side,
                  dev, dt):
    """One side of :func:`cae_steps_vs_cpu`: the CAE training step
    (augmentation by the given flips and noise, forward, loss at
    CAE_VS_CPU_FACTOR, backward) of ``model`` in ``dt`` on ``dev`` ->
    (loss, gradients, running statistics, seconds); "zeroed" in ``side``
    zeroes the entry conv's K4 output."""
    from stroke_prediction_tpu_torch.data.augment import (
        elastic_deform_batch, hemispheric_flip)
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.ops.warp import elastic_fields
    from stroke_prediction_tpu_torch.train.cae_learners import cae_loss

    real_dw = cm.conv3x3_bwd_dw

    def entry_dw_zeroed(x, *args):
        """K4 with the entry conv's (data input) dW and db zeroed."""
        out = real_dw(x, *args)
        return (tuple(torch.zeros_like(t) for t in out)
                if x.shape[-1] == CAE_CHANNELS[0] else out)

    entry_dw_zeroed.launches = 0
    m = copy.deepcopy(model).to(dev).train()
    if dt == torch.float64:
        m.double()
    set_cae_dtype(m, dt)
    wide = torch.promote_types(dt, torch.float32)
    t0 = time.perf_counter()
    labs = elastic_deform_batch(
        hemispheric_flip(labels.to(dev, wide), flip.to(dev)),
        elastic_fields(noise.to(dev, wide)))
    dto = m(stub.make_dto(labs, clinical.to(dev, wide)))
    loss = cae_loss(dto, CAE_VS_CPU_FACTOR)
    if "zeroed" in side:
        cm.conv3x3_bwd_dw = entry_dw_zeroed
    try:
        # as the CAE learners' train_step runs it: cuDNN's deterministic
        # algorithms, TF32 off
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            loss.backward()
    finally:
        cm.conv3x3_bwd_dw = real_dw
    if dev == "cuda":
        torch.cuda.synchronize()
    return (float(loss.detach()),
            {k: p.grad.cpu().double()
             for k, p in m.named_parameters() if p.grad is not None},
            {k: b.cpu().double() for k, b in m.named_buffers()},
            time.perf_counter() - t0)


def cae_steps_vs_cpu(torch, learner):
    """One CAE training step (forward, loss at CAE_VS_CPU_FACTOR, backward;
    no optimizer step) at batch 2 on the same batch, flips and displacement
    fields, with a float64 CPU step as the witness:

    * from seeded weights (as :func:`step_vs_cpu`'s U-Net), float32 and
      bfloat16, with the bfloat16 limits' two controls;
    * from the trained weights (the CLI's run), float32.

    Each float32 card step is held to the float64 one at the STEP_*
    limits; the CPU's float32 step is only printed: a channel whose batch
    variance falls far below its squared mean makes the folded BN's kernel
    gradient ``dk' * s + t * db'`` two large terms that cancel, and the
    CPU's sums' order put it 3.9e-3 of its layer's largest gradient off
    float64 on the card's first trained run, the card 1.4e-5 (from the
    seeded weights 6.8e-4, the card 2.0e-4).

    The CPU sides run in the witnesses' pool; the comparisons when the
    returned :class:`Deferred` resolves."""
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
    from stroke_prediction_tpu_torch.ops.warp import elastic_noise

    data, _ = learner.device_data(learner._dataloader_training)
    labels = data[KEY_LABELS][:CAE_VS_CPU_BATCH].cpu()
    clinical = data[KEY_GLOBAL][:CAE_VS_CPU_BATCH].cpu()
    noise = elastic_noise(torch.Generator().manual_seed(5), CAE_VS_CPU_BATCH,
                          CAE_DHW)
    flip = torch.tensor([True, False])
    gen = torch.Generator().manual_seed(3)
    seeded = Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                   Dec3D(CAE_CHANNELS, generator=gen))
    trained = copy.deepcopy(learner._model).cpu()
    stub = learner_stub(learner)
    sides = (("card float32", seeded, "cuda", torch.float32),
             ("CPU float32", seeded, "cpu", torch.float32),
             ("card bfloat16", seeded, "cuda", torch.bfloat16),
             ("card bfloat16, entry K4 zeroed", seeded, "cuda",
              torch.bfloat16),
             ("CPU bfloat16", seeded, "cpu", torch.bfloat16),
             ("CPU float64", seeded, "cpu", torch.float64),
             ("trained card float32", trained, "cuda", torch.float32),
             ("trained CPU float32", trained, "cpu", torch.float32),
             ("trained CPU float64", trained, "cpu", torch.float64))
    args = (labels, clinical, noise, flip, stub)
    cpu = {side: witness(cae_step_side, model, *args, side, dev, dt)
           for side, model, dev, dt in sides if dev == "cpu"}
    out = {side: cae_step_side(torch, model, *args, side, dev, dt)
           for side, model, dev, dt in sides if dev != "cpu"}
    n_params = len(list(seeded.parameters()))
    return Deferred(lambda: cae_steps_vs_cpu_check(out, cpu, n_params))


def cae_steps_vs_cpu_check(out, cpu, n_params):
    """:func:`cae_steps_vs_cpu`'s comparisons, its CPU sides in."""
    import torch

    out.update({side: f.result() for side, f in cpu.items()})
    print("\ncae step seconds: " + ", ".join(f"{side} {v[3]:.2f} s"
                                            for side, v in out.items()))
    entry_bn = {k: torch.zeros_like(g) if k.startswith(CAE_ENTRY + ".bn.")
                else g for k, g in out["card bfloat16"][1].items()}
    out["card bfloat16, entry BN zeroed"] = (out["card bfloat16"][0],
                                             entry_bn) + out["card bfloat16"][2:]
    if any(len(v[1]) != n_params for v in out.values()):
        raise AssertionError(f"cae step: {n_params} gradients expected")
    what = f"cae step (batch {CAE_VS_CPU_BATCH})"

    def compare(a, b):
        return grad_compare(out, a, b, cae_layer_of, what)

    def f32_check(card, cpu, f64):
        """The card's float32 step against the float64 step ``f64`` within
        the STEP_* limits; the CPU's float32 step against both, printed."""
        loss_rel, grad, stats, _ = compare(card, f64)
        res = dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
                   stats_err=stats, card_vs_cpu=compare(card, cpu)[1][0],
                   cpu_vs_f64=compare(cpu, f64)[1][0])
        if (loss_rel > STEP_LOSS_REL or grad[0] > STEP_GRAD_REL
                or stats > STEP_STATS_ATOL):
            raise AssertionError(f"cae step {card} vs {f64}: beyond the "
                                 f"STEP_* limits: {res}")
        return res

    f32 = f32_check("card float32", "CPU float32", "CPU float64")
    f32_trained = f32_check("trained card float32", "trained CPU float32",
                            "trained CPU float64")

    bf16 = bf16_step_check(out, cae_layer_of, what, (
        "card bfloat16, entry K4 zeroed", "card bfloat16, entry BN zeroed"))
    return {"float32": f32, "float32 trained": f32_trained,
            "bfloat16": bf16}


# The two learners on a frozen phase-1 CAE: the CAE training phase's
# best-valid _cae1.model, the same eight cases, batch 4, the reference
# width, bfloat16 (the CLIs' default), one epoch each (the script's wall
# grew by ~155 s with two, and epochs are what a new phase cuts first);
# phase 2 with --initbycae
CAE_LEARNER_EPOCHS = 1
STEP_HEAD = ("reduce1", "reduce2", "step_head")
# the visual forward (ten interpolation reconstructions of one case, the
# fixed hours decoded as one batch) against one forward a step: float32
# within CAE_ATOL; bfloat16 within VIS_BF16_ATOL (stated before the first
# run: a batch of 9 may take another cuDNN algorithm or matmul kernel in
# the transposed and 1^3 convs than a batch of 1, whose float32 sums may
# round to the neighbouring bfloat16 value, carried through the decoder's
# last layers to the probabilities)
VIS_BF16_ATOL = 2e-2


def learner_launches(kind, channels=CAE_CHANNELS):
    """K1-K4 launches by (kernel, storage type) of one training step and of
    one validation batch (or visual forward) of the step learner (the
    whole CAE in bfloat16, frozen but the head) or of phase 2 (a bfloat16
    encoder on two inputs; a frozen float32 CAE: three inputs decodes,
    three encodes and four decodes on the gtruth branch), by the route
    rule: a frozen conv whose input needs a gradient takes 'dx' (K3)."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    encode, decode = cae_conv_layers(channels)
    kernels = {"fused": ("K2",), "split": ("K3", "K4"), "dw": ("K4",),
               "dx": ("K3",)}
    step, valid = {}, {}

    def add(counts, key, n):
        if n:
            counts[key] = counts.get(key, 0) + n

    def backward(dtype, layers, n, frozen):
        for ci, co, input_grad in layers:
            for k in kernels[bwd_route(ci, co, input_grad, not frozen)]:
                add(step, (k, dtype), n)

    if kind == "step":
        for counts in (step, valid):
            add(counts, ("K1", "bfloat16"), 3 * len(encode) + 4 * len(decode))
        # hinge and Dice reach the head through the interpolation's decode
        backward("bfloat16", decode, 1, frozen=True)
    else:
        for counts in (step, valid):
            add(counts, ("K1", "bfloat16"), 2 * len(encode))
            add(counts, ("K1", "float32"),
                3 * len(decode) + 3 * len(encode) + 4 * len(decode))
        backward("bfloat16", encode, 2, frozen=False)
        backward("float32", decode, 3, frozen=True)
    return step, valid


def by_kernel(counts):
    out = {}
    for (k, _), n in counts.items():
        out[k] = out.get(k, 0) + n
    return out


def learner_check_recorded(what, calls, sites, worst, want, edt_shapes):
    """The recorded calls of a learner's step or validation batch by
    (kernel, storage type) against ``want``; edt_sites at
    ``edt_shapes``."""
    got = {}
    for key, n in calls.items():
        got[(key[0], key[-1])] = got.get((key[0], key[-1]), 0) + n
    print(f"{what}: calls by (kernel, type) {got} on their own inputs "
          f"against plain (y, dx: float32 {K1_TOL}, bfloat16 {BF16_REL} of "
          f"max|ref|; dW, db {DW_REL} of max|ref|; K2-K4 bit-identical on "
          f"repeat), max|err| {worst}; edt_sites {sites} equal to plain")
    if got != want or sites != edt_shapes:
        raise AssertionError(f"{what}: expected calls {want} and edt_sites "
                             f"at {edt_shapes}")


def cae_learners_phase(torch, work, phase1):
    """The step learner and phase 2 on the card against the CAE training
    phase's best-valid ``_cae1.model``: each CLI in bfloat16 at the
    reference width (launches by route against :func:`learner_launches`,
    finite losses, artifacts), every K1-K4 and edt_sites call of one
    training step and one validation batch on its own inputs, the launches
    by kernel and type, the frozen parts after the runs (parameters as the
    _cae1.model's, the step learner's BN statistics moved, _cae2.model the
    phase-1 CAE bit for bit), K1-K4 per layer of a step beside cuDNN, 20
    timed steps and a profile of one, a float32 step each on the card
    against a float64 CPU step with a control that must fail
    (:func:`learner_step_vs_cpu`), and the three CAE
    learners' visual forward against one forward a step."""
    from stroke_prediction_tpu_torch.cli import (
        train_interpolationstep_after_reconstruction as step_cli)
    from stroke_prediction_tpu_torch.cli import train_shape_prediction
    from stroke_prediction_tpu_torch.models.convert import state_to_jax
    from stroke_prediction_tpu_torch.utils.args import (
        get_args_shape_prediction_training, get_args_step_training)
    from stroke_prediction_tpu_torch.utils.checkpoint import load_checkpoint

    cae1 = os.path.join(work, "shape_train_cae1.model")
    with open(cae1, "rb") as f:
        cae1_bytes = f.read()
    cae1_tree, _ = load_checkpoint(cae1)
    width = [*map(str, CAE_CHANNELS)]
    common = ["--synthetic", "--fold", *map(str, TRAIN_FOLD),
              "--validsetsize", "0.25", "--batchsize", str(CAE_TRAIN_BATCH),
              "--epochs", str(CAE_LEARNER_EPOCHS)]
    runs = {
        "step": (step_cli, get_args_step_training,
                 ["--channelscae", *width],
                 ["_cae1step.model", "_cae1step.optim", "_cae1step.json",
                  "_cae1step_final.model"],
                 ["_cae1step_1.png", "_cae1step_plots.png"]),
        "prediction": (train_shape_prediction,
                       get_args_shape_prediction_training,
                       ["--channelsenc", *width, "--initbycae"],
                       ["_cae2.model", "_cae2_enc.model", "_cae2.optim",
                        "_cae2.json", "_cae2_final.model",
                        "_cae2_enc_final.model"],
                       ["_cae2_1.png", "_cae2_plots.png"])}
    res = {}
    for kind, (cli, parse, extra, files, pngs) in runs.items():
        what = f"cae {kind}"
        base = os.path.join(work, kind)
        args = parse([cae1, *common, *extra, "--outbasepath", base])
        if args.dtype != "bfloat16" or args.device != "cuda":
            raise AssertionError(f"{what}: the CLI's defaults {args.dtype}, "
                                 f"{args.device}")
        reset_launches()
        t0 = time.perf_counter()
        learner = cli.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        steps = dict(learner.step_counts)
        per_step, per_valid = learner_launches(kind)
        step_k, valid_k = by_kernel(per_step), by_kernel(per_valid)
        n_train, n_eval, n_vis = steps["train"], steps["eval"], \
            steps["visual"]
        want = {"conv3x3": step_k["K1"] * n_train
                + valid_k["K1"] * (n_eval + n_vis),
                "conv3x3_bwd_fused": step_k.get("K2", 0) * n_train,
                "conv3x3_bwd_dx": step_k.get("K3", 0) * n_train,
                "conv3x3_bwd_dw": step_k.get("K4", 0) * n_train,
                "edt_sites": CAE_EDT_PER_CASE * n_eval, "edt_parabola": 0}
        print(f"\n{what}: CLI, {CAE_LEARNER_EPOCHS} epochs in {wall:.2f} s; "
              f"steps {steps}; launches {launches}; per training step "
              f"{per_step}, per validation batch and visual forward "
              f"{per_valid} and {CAE_EDT_PER_CASE} edt_sites; training "
              f"passes (s, steps) {learner.train_pass_seconds}")
        if (learner.device.type != "cuda"
                or n_train != 2 * CAE_LEARNER_EPOCHS
                or n_eval != CAE_LEARNER_EPOCHS):
            raise AssertionError(f"{what}: steps {steps} on "
                                 f"{learner.device}")
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{what}: {name} launched "
                                     f"{launches[name]} times, expected {n}")
        for phase in ("training", "validate"):
            curve = learner._metric_dtos[phase]
            losses = [m["loss"] for m in curve]
            print(f"{what}: {phase} losses {losses}; lesion Dice "
                  f"{[round(m['lesion_dc'], 4) for m in curve]}")
            if len(losses) != CAE_LEARNER_EPOCHS or not all(
                    math.isfinite(v) and v >= 0.0 for v in losses):
                raise AssertionError(f"{what}: {phase} losses {losses}")
        check_artifacts(base, files, pngs, what)

        data, _ = learner.device_data(learner._dataloader_training)
        rows = torch.arange(CAE_TRAIN_BATCH, device="cuda")
        batch = {k: None if v is None else v.index_select(0, rows)
                 for k, v in data.items()}
        vdata, _ = learner.device_data(learner._dataloader_validation)
        v_calls, v_sites, v_worst = cae_recorded(
            torch, lambda: learner.eval_step(vdata))
        learner_check_recorded(f"{what}: one validation batch", v_calls,
                               v_sites, v_worst, per_valid,
                               {EDT_CAE_VALID: CAE_EDT_PER_CASE})
        calls, sites, worst = cae_recorded(
            torch, lambda: learner.train_step(batch), grad=True)
        learner_check_recorded(f"{what}: one training step", calls, sites,
                               worst, per_step, {})
        times = cae_step_kernel_times(torch, calls, step_k, what)
        mean, std, host = time_steps(
            torch, lambda: learner.train_step(batch), CAE_TIMED_STEPS,
            f"{what} (bfloat16, batch {CAE_TRAIN_BATCH})")
        busy = cae_profile_step(torch, learner, batch, what)
        res[kind] = dict(learner=learner, launches=launches, steps=steps,
                         per_step=step_k, per_valid=valid_k,
                         per_step_by_type=per_step, worst=worst,
                         valid_worst=v_worst, times=times,
                         step_ms=dict(mean=mean, std=std, host=host),
                         busy=busy, wall=wall)

    # the frozen parts after the runs, the recorded and timed steps
    # included
    step_l, pred_l = res["step"]["learner"], res["prediction"]["learner"]
    step_tree = state_to_jax(step_l._model.state_dict(),
                             step_l._model.config)
    final_tree, _ = load_checkpoint(os.path.join(
        work, "step_cae1step_final.model"))
    moved = 0
    for tree, name in ((step_tree, "the step learner's CAE"),
                       (final_tree, "_cae1step_final.model")):
        for kind_, sub in cae1_tree.items():
            for path, leaf in flat_items(sub):
                got = tree[kind_]
                for p_ in path:
                    got = got[p_]
                if kind_ == "params":
                    if not (got == leaf).all():
                        raise AssertionError(f"{name}: frozen {path} moved")
                elif (got == leaf).all():
                    raise AssertionError(f"{name}: BN statistic {path} did "
                                         f"not move")
                else:
                    moved += 1
    for suffix in ("_cae2.model", "_cae2_final.model"):
        with open(os.path.join(work, "prediction" + suffix), "rb") as f:
            if f.read() != cae1_bytes:
                raise AssertionError(f"{suffix} is not the phase-1 CAE")
    pred_tree = state_to_jax(pred_l._cae.state_dict(), pred_l._cae.config)
    for kind_, sub in cae1_tree.items():
        for path, leaf in flat_items(sub):
            got = pred_tree[kind_]
            for p_ in path:
                got = got[p_]
            if not (got == leaf).all():
                raise AssertionError(f"phase 2's frozen CAE: {kind_} {path} "
                                     f"changed")
    print(f"cae learners: after the runs the step learner's frozen "
          f"parameters (and its _cae1step_final.model's) equal "
          f"_cae1.model's, its {moved // 2} BN statistics all moved; "
          f"_cae2.model and _cae2_final.model equal _cae1.model byte for "
          f"byte, phase 2's frozen CAE (parameters and statistics) "
          f"unchanged")

    vs_cpu = {kind: learner_step_vs_cpu(torch, res[kind]["learner"], kind)
              for kind in ("step", "prediction")}
    vis = {name: vis_vs_serial(torch, learner, name) for name, learner in (
        ("reconstruction", phase1["learner"]), ("step", step_l),
        ("prediction", pred_l))}
    for kind in ("step", "prediction"):
        res[kind].pop("learner")
    return dict(res, vs_cpu=vs_cpu, vis=vis)


def flat_items(tree, path=()):
    """(path, leaf) of a nested dict's leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_items(v, path + (k,))
        else:
            yield path + (k,), v


def learner_layer_of(key):
    """A trained parameter's layer: an encoder block (its BN and conv) or a
    dense layer of the step head."""
    parts = key.split(".")
    return ".".join(parts[:3] if "blocks" in parts else parts[:-1])


def learner_step_side(torch, models, batch, stub, kind, dev, dt):
    """One side of :func:`learner_step_vs_cpu`: the step of ``kind`` from
    the trained ``models`` in ``dt`` on ``dev`` -> (loss, trained
    gradients, running statistics, seconds)."""
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.inference import cae_enc_inference

    ms = [copy.deepcopy(m).to(dev) for m in models]
    if dt == torch.float64:
        for m in ms:
            m.double()
    if kind == "step":
        set_cae_dtype(ms[0], dt)
    else:
        set_cae_dtype(ms[0], torch.promote_types(dt, torch.float32))
        ms[1].encoder.compute_dtype = dt
    wide = torch.promote_types(dt, torch.float32)
    b = {k: None if v is None else v.to(dev, wide) for k, v in batch.items()}
    t0 = time.perf_counter()
    dto = stub.make_dto(b[KEY_LABELS], b[KEY_GLOBAL], images=b[KEY_IMAGES])
    if kind == "step":
        dto = ms[0].train()(dto)
    else:
        dto = cae_enc_inference(ms[0], ms[1], dto, True)
    loss = stub.loss(dto, 0.0)
    # as the CAE learners' train_step runs it: cuDNN's deterministic
    # algorithms, TF32 off
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        loss.backward()
    if dev == "cuda":
        torch.cuda.synchronize()
    trained = ms[-1]
    return (float(loss.detach()),
            {k: p.grad.cpu().double()
             for k, p in trained.named_parameters() if p.requires_grad},
            {k: v.cpu().double() for k, v in trained.named_buffers()},
            time.perf_counter() - t0)


def learner_step_vs_cpu(torch, learner, kind):
    """One float32 step of a learner (forward, loss, backward; no optimizer
    step, no augmentation) at batch 2 from its trained weights, on the card,
    on the CPU and in float64 on the CPU.  The card's loss, every trained
    gradient relative to its layer's largest and the running statistics
    that the step moves against the float64 step at the STEP_* limits; a
    control (the step head's kernel gradient, or phase 2's entry BN
    gradients, zeroed on the card) must fail the gradient limit.  The CPU's
    float32 step is only printed, as :func:`cae_steps_vs_cpu` prints it on
    trained weights: a channel whose batch variance falls far below its
    squared mean makes the folded BN's kernel gradient two large terms that
    cancel, and the CPU's sums' order put phase 2's encoder.blocks.9 kernel
    gradient 1.48e-3 of its layer's largest off float64 in one run on an
    NVIDIA H100 80GB HBM3 (700 W), the card 9.0e-7.  The CPU sides run in
    the witnesses' pool; the comparisons when the returned
    :class:`Deferred` resolves."""
    data, _ = learner.device_data(learner._dataloader_training)
    batch = {k: None if v is None else v[:CAE_VS_CPU_BATCH].cpu()
             for k, v in data.items()}
    models = ((learner._model,) if kind == "step"
              else (learner._cae, learner._model))
    models = tuple(copy.deepcopy(m).cpu() for m in models)
    stub = learner_stub(learner)
    card, cpu, f64 = "card float32", "CPU float32", "CPU float64"
    pool = {side: witness(learner_step_side, models, batch, stub, kind,
                          "cpu", dt)
            for side, dt in ((cpu, torch.float32), (f64, torch.float64))}
    out = {card: learner_step_side(torch, models, batch, stub, kind, "cuda",
                                   torch.float32)}
    return Deferred(lambda: learner_step_vs_cpu_check(out, pool, kind))


def learner_step_vs_cpu_check(out, pool, kind):
    """:func:`learner_step_vs_cpu`'s comparisons, its CPU sides in."""
    import torch

    card, cpu, f64 = "card float32", "CPU float32", "CPU float64"
    out.update({side: f.result() for side, f in pool.items()})
    control = ("enc.step_head.kernel",) if kind == "step" else tuple(
        f"encoder.blocks.0.bn.{n}" for n in ("scale", "bias"))
    c = out[card]
    out[card + ", control"] = (c[0], {
        k: torch.zeros_like(g) if k in control else g
        for k, g in c[1].items()}) + c[2:]
    what = f"cae {kind} step (batch {CAE_VS_CPU_BATCH})"
    print(f"\n{what} seconds: " + ", ".join(
        f"{side} {v[3]:.2f} s" for side, v in out.items()))

    def compare(a, b):
        loss_rel, grad, stats, _ = grad_compare(out, a, b, learner_layer_of,
                                                what)
        return dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
                    stats_err=stats)

    def failed(r):
        return [name for name, bad in (
            ("loss", r["loss_rel"] > STEP_LOSS_REL),
            ("grad", r["grad_rel"] > STEP_GRAD_REL),
            ("stats", r["stats_err"] > STEP_STATS_ATOL)) if bad]

    res = compare(card, f64)
    ctrl = compare(card + ", control", f64)
    res["control"] = dict(zeroed=control, grad_rel=ctrl["grad_rel"],
                          failed=failed(ctrl))
    res["card_vs_cpu"] = compare(card, cpu)["grad_rel"]
    res["cpu_vs_f64"] = compare(cpu, f64)["grad_rel"]
    print(f"{what}: the card's float32 step vs float64: limits failed "
          f"{failed(res)}; the control ({control} zeroed) failed "
          f"{res['control']['failed']}; float64 gradients off by the card "
          f"{res['grad_rel']:.2e}, the CPU {res['cpu_vs_f64']:.2e} "
          f"(card vs CPU {res['card_vs_cpu']:.2e}, not held)")
    if failed(res):
        raise AssertionError(f"{what}: the card's float32 step beyond the "
                             f"STEP_* limits of float64: {res}")
    if "grad" not in res["control"]["failed"]:
        raise AssertionError(f"{what}: the control passes the gradient "
                             f"limit: {ctrl}")
    return res


def vis_vs_serial(torch, learner, name):
    """A CAE learner's visual forward (``_vis_reconstructions``: the ten
    interpolation reconstructions of one validation case, the fixed hours
    decoded as one batch) against one forward a step, in bfloat16 (as
    trained; VIS_BF16_ATOL) and float32 (CAE_ATOL).  How far the columns
    lie apart (the largest distance from the first) is printed beside: a
    step read for all would show as that much off."""
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)

    valid = learner._dataloader_validation
    sample = valid.dataset.sample(valid.indices[0])
    batch = {k: None if sample.get(k) is None else torch.from_numpy(
        sample[k][None]).to("cuda") for k in (KEY_IMAGES, KEY_LABELS,
                                              KEY_GLOBAL)}
    trained = (learner._model.encoder.compute_dtype
               if name == "prediction"
               else learner._model.enc.encoder.compute_dtype)
    res = {}
    for dt, limit in ((torch.bfloat16, VIS_BF16_ATOL),
                      (torch.float32, CAE_ATOL)):
        if name == "prediction":
            learner._model.encoder.compute_dtype = dt
        else:
            set_cae_dtype(learner._model, dt)
        with torch.inference_mode():
            rec = learner._vis_reconstructions(batch)
            serial = [learner.forward(learner.make_dto(
                batch[KEY_LABELS], batch[KEY_GLOBAL],
                None if s is None else [s], batch[KEY_IMAGES])
            ).reconstructions.gtruth.interpolation[0, ..., 0]
                for s in learner.VIS_STEPS]
        torch.cuda.synchronize()
        if tuple(rec.shape) != (len(learner.VIS_STEPS), *CAE_DHW):
            raise AssertionError(f"{name} visual forward: {rec.shape}")
        err = max(float((r - s_).abs().max()) for r, s_ in zip(rec, serial))
        moved = max(float((s_ - serial[0]).abs().max()) for s_ in serial)
        dname = str(dt)[6:]
        print(f"cae {name} visual forward ({dname}): ten reconstructions "
              f"vs one forward a step max|err| {err:.3e} (limit {limit}); "
              f"the steps' largest distance from the own time's "
              f"{moved:.3e}")
        res[dname] = dict(max_abs_err=err, moved=moved)
        if err > limit:
            raise AssertionError(f"{name} visual forward ({dname}): {err} "
                                 f"off one forward a step")
    if name == "prediction":
        learner._model.encoder.compute_dtype = trained
    else:
        set_cae_dtype(learner._model, trained)
    return res


# CTP-conditioned CAE phase-1 training at the reference width with the
# entry conv at C_in 3 (the mask, CBV and TTD): the CLI's defaults (bfloat16,
# batch 4, images padded by 20) on the eight cases, two epochs; one float32
# step at batch 2 card vs CPU at the STEP_* limits, with the entry gradients
# against a float64 step within CTP_ENTRY_F64_REL of their own max|ref|
# (stated before the first run: the CPU's float32 entry gradients were
# 2.4e-6 to 2e-5 of their max off JAX's float64 in the CPU tests, and the
# folded BN's ``dk' s + t db'`` cancels at the CT channels' means)
CTP_CHANNELS = (3, 16, 24, 32, 100, 200, 1)
CTP_PAD = (20, 20, 20)
CTP_EPOCHS = 2
CTP_ENTRY_F64_REL = 1e-4
# the card-vs-CPU step's loss has the latent L1 term off: its gradient,
# sign(z_interp - z_lesion), jumps where the two latents nearly coincide,
# as they do here (the three encodes share the CBV and TTD channels): at
# 0.4 one latent element of 40000 took the other sign on the card than in
# float64 and put the fc kernel's gradient 1.43e-3 of its layer's largest
# off (the CPU's 2.6e-4); at 0 the card read 3.3e-4 (NVIDIA H100 80GB
# HBM3, 700 W)
CTP_VS_CPU_FACTOR = 0.0
CTP_ENTRY = ("enc.encoder.blocks.0.bn.scale", "enc.encoder.blocks.0.bn.bias",
             "enc.encoder.blocks.0.conv.kernel")


def cae_ctp_phase(torch, work):
    """The CTP-conditioned CAE's phase-1 training on the card: the port's
    CLI (``cli.train_shape_reconstruction_with_ctp``: no ``--device`` or
    ``--dtype``, so the card and bfloat16) at channels 3 16 24 32 100 200
    1; launches per step and validation batch against the route rule;
    finite losses, the artifacts, the ``cae3d_ctp`` header and the
    best-valid model loaded; every K1-K4 and edt_sites call of one bfloat16
    and one float32 step and of one validation batch on its own inputs
    against plain, K1 and K4 at the entry conv at C_in 3 among them; K1-K4
    per layer beside cuDNN; 10 timed steps and a profile; one float32 step
    card vs CPU (:func:`ctp_step_vs_cpu`)."""
    from stroke_prediction_tpu_torch.cli import (
        train_shape_reconstruction_with_ctp as ctp_cli)
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
    from stroke_prediction_tpu_torch.models.factory import load_model
    from stroke_prediction_tpu_torch.utils.args import (
        get_args_shape_training)

    what = "cae ctp"
    base = os.path.join(work, "ctp")
    args = get_args_shape_training(
        ["--synthetic", "--fold", *map(str, TRAIN_FOLD), "--validsetsize",
         "0.25", "--batchsize", str(CAE_TRAIN_BATCH), "--epochs",
         str(CTP_EPOCHS), "--channelscae", *map(str, CTP_CHANNELS),
         "--outbasepath", base])
    if (args.dtype != "bfloat16" or args.device != "cuda"
            or tuple(args.padding) != CTP_PAD):
        raise AssertionError(f"{what}: the CLI's defaults {args.dtype}, "
                             f"{args.device}, {args.padding}")
    reset_launches()
    t0 = time.perf_counter()
    learner = ctp_cli.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = dict(learner.step_counts)
    per_step = cae_step_launches(CTP_CHANNELS)
    fwd = per_step["K1"]
    n_train, n_eval, n_vis = steps["train"], steps["eval"], steps["visual"]
    want = {"conv3x3": fwd * (n_train + n_eval + n_vis),
            "conv3x3_bwd_fused": per_step["K2"] * n_train,
            "conv3x3_bwd_dx": per_step["K3"] * n_train,
            "conv3x3_bwd_dw": per_step["K4"] * n_train,
            "edt_sites": CAE_EDT_PER_CASE * n_eval, "edt_parabola": 0}
    print(f"\n{what}: CLI, {CTP_EPOCHS} epochs in {wall:.2f} s; steps "
          f"{steps}; launches {launches}; per training step {per_step}, per "
          f"validation batch K1 {fwd} and {CAE_EDT_PER_CASE} edt_sites; "
          f"training passes (s, steps) {learner.train_pass_seconds}")
    if (learner.device.type != "cuda" or n_train != 2 * CTP_EPOCHS
            or n_eval != CTP_EPOCHS
            or learner._base_betas != (0.99, 0.999)):
        raise AssertionError(f"{what}: steps {steps} on {learner.device}, "
                             f"betas {learner._base_betas}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    for phase in ("training", "validate"):
        curve = learner._metric_dtos[phase]
        losses = [m["loss"] for m in curve]
        print(f"{what}: {phase} losses {losses}; lesion Dice "
              f"{[round(m['lesion_dc'], 4) for m in curve]}")
        if len(losses) != CTP_EPOCHS or not all(
                math.isfinite(v) and v >= 0.0 for v in losses):
            raise AssertionError(f"{what}: {phase} losses {losses}")
    check_artifacts(base, ["_cae1.model", "_cae1.optim", "_cae1.json",
                           "_cae1_final.model"],
                    ["_cae1_1.png", "_cae1_plots.png"], what)
    model, config = load_model(base + "_cae1.model", "cuda")
    header = {"kind": "cae3d_ctp", "channels": list(CTP_CHANNELS),
              "n_ch_global": 5, "step": False, "padding": list(CTP_PAD)}
    valid = learner._dataloader_validation
    vdata, _ = learner.device_data(valid)
    with torch.inference_mode():
        dto = model(cae_dto_from_batch(
            vdata[KEY_IMAGES][:1], vdata[KEY_LABELS][:1],
            vdata[KEY_GLOBAL][:1], inputs_from_images=True))
    rec = dto.reconstructions.gtruth.interpolation
    if (config != header or tuple(rec.shape) != (1, *CAE_DHW, 1)
            or not torch.isfinite(rec).all()):
        raise AssertionError(f"{what}: best-valid model {config}, "
                             f"{tuple(rec.shape)}")
    print(f"{what}: best-valid _cae1.model {config} runs: interpolation "
          f"{tuple(rec.shape)}, images {tuple(vdata[KEY_IMAGES].shape)}")

    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(CAE_TRAIN_BATCH, device="cuda")
    batch = {k: None if v is None else v.index_select(0, rows)
             for k, v in data.items()}
    if len(valid.indices) != EDT_CAE_VALID[0]:
        raise AssertionError(f"{what}: {len(valid.indices)} validation "
                             f"cases")
    v_calls, v_sites, v_worst = cae_recorded(
        torch, lambda: learner.eval_step(vdata))
    cae_check_recorded(f"{what}: one bfloat16 validation batch", v_calls,
                       v_sites, v_worst, {"K1": fwd},
                       {EDT_CAE_VALID: CAE_EDT_PER_CASE})
    recorded = {}
    # (N, D, H, W, C_in, C_out) of the entry conv
    entry_layer = (CAE_TRAIN_BATCH, *CAE_DHW, *CTP_CHANNELS[:2])
    for dtype in (torch.bfloat16, torch.float32):
        set_cae_dtype(learner._model, dtype)
        calls, sites, worst = cae_recorded(
            torch, lambda: learner.train_step(batch, CAE_VS_CPU_FACTOR),
            grad=True)
        dname = str(dtype)[6:]
        cae_check_recorded(f"{what}: one {dname} training step", calls,
                           sites, worst, per_step, {})
        entry = sorted({k[0] for k in calls if k[1:7] == entry_layer})
        print(f"{what}: {dname} step: kernels at the entry conv (C_in "
              f"{CTP_CHANNELS[0]}): {entry}")
        if entry != ["K1", "K4"]:
            raise AssertionError(f"{what}: the entry conv ran {entry}")
        recorded[dname] = calls, worst
    set_cae_dtype(learner._model, torch.bfloat16)
    layers = {}
    times = {dname: cae_step_kernel_times(torch, calls, per_step, what,
                                          layers)
             for dname, (calls, _) in recorded.items()}
    entry_times = {key[-1]: t for key, t in layers.items()
                   if key[1:7] == entry_layer}
    mean, std, host = time_steps(
        torch, lambda: learner.train_step(batch), CAE_TIMED_STEPS,
        f"{what} (bfloat16, batch {CAE_TRAIN_BATCH})")
    busy = cae_profile_step(torch, learner, batch, what)
    vs_cpu = ctp_step_vs_cpu(torch, learner)
    return dict(launches=launches, per_step=per_step, steps=steps,
                recorded={d: r[1] for d, r in recorded.items()},
                valid_worst=v_worst, times=times, entry_times=entry_times,
                step_ms=dict(mean=mean, std=std, host=host), busy=busy,
                vs_cpu=vs_cpu, wall=wall)


def ctp_step_side(torch, seeded, labels, images, clinical, noise, flip,
                  stub, side, dev, dt):
    """One side of :func:`ctp_step_vs_cpu`: the CTP training step of
    ``seeded`` in ``dt`` on ``dev`` (float64 with the plain versions of
    K1-K4; "zeroed" in ``side``: the entry conv's K4 output zeroed) ->
    ((loss, gradients, running statistics, seconds), the signs of
    z_interp - z_lesion)."""
    from stroke_prediction_tpu_torch.data.augment import (
        elastic_deform_batch, hemispheric_flip)
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.ops.warp import elastic_fields
    from stroke_prediction_tpu_torch.train.cae_learners import cae_loss

    real_dw = cm.conv3x3_bwd_dw

    def entry_dw_zeroed(x, *args):
        """K4 with the entry conv's (data input) dW and db zeroed."""
        out = real_dw(x, *args)
        return (tuple(torch.zeros_like(t) for t in out)
                if x.shape[-1] == CTP_CHANNELS[0] else out)

    entry_dw_zeroed.launches = 0
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    plain = {n: getattr(cm, n + "_plain") for n in names}
    m = copy.deepcopy(seeded).to(dev).train()
    if dt == torch.float64:
        m.double()
    set_cae_dtype(m, dt)
    swap = (plain if dt == torch.float64 else
            dict(real, conv3x3_bwd_dw=entry_dw_zeroed)
            if "zeroed" in side else real)
    t0 = time.perf_counter()
    try:
        for n in names:
            setattr(cm, n, swap[n])
        f = flip.to(dev)
        labs = elastic_deform_batch(
            hemispheric_flip(labels.to(dev, dt), f),
            elastic_fields(noise.to(dev, dt)))
        imgs = hemispheric_flip(images.to(dev, dt), f)
        dto = m(stub.make_dto(labs, clinical.to(dev, dt), images=imgs))
        lat = dto.latents.gtruth
        sign = torch.sign(lat.interpolation - lat.lesion).detach().cpu()
        loss = cae_loss(dto, CTP_VS_CPU_FACTOR)
        # as the CAE learners' train_step runs it: cuDNN's deterministic
        # algorithms, TF32 off
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            loss.backward()
    finally:
        for n in names:
            setattr(cm, n, real[n])
    if dev == "cuda":
        torch.cuda.synchronize()
    return (float(loss.detach()),
            {k: p.grad.cpu().double()
             for k, p in m.named_parameters() if p.grad is not None},
            {k: b.cpu().double() for k, b in m.named_buffers()},
            time.perf_counter() - t0), sign


def ctp_step_vs_cpu(torch, learner):
    """One float32 CTP training step (forward, loss at CTP_VS_CPU_FACTOR,
    backward; no optimizer step) at batch 2 from seeded weights, on the
    same masks, images, flips and displacement fields, on the card and on
    the CPU, and a float64 step (the plain versions, run on the card): the
    card's loss, every gradient (relative to its layer's largest) and the
    running statistics against float64 at the STEP_* limits, the CPU's
    float32 step against both printed (as :func:`step_vs_cpu`); two
    controls (the entry conv's K4 output zeroed on the card, the card's
    entry BN gradients zeroed) must fail the gradient limit; the entry
    BN's scale and bias and the entry kernel's gradients, card and CPU,
    against float64 within CTP_ENTRY_F64_REL of their own max|ref|.  The
    CPU side runs in the
    witnesses' pool; the comparisons when the returned :class:`Deferred`
    resolves."""
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.cae3d import (
        Cae3DCtp, Dec3D, Enc3DCtp)
    from stroke_prediction_tpu_torch.ops.warp import elastic_noise

    data, _ = learner.device_data(learner._dataloader_training)
    nb = CAE_VS_CPU_BATCH
    labels = data[KEY_LABELS][:nb].cpu()
    images = data[KEY_IMAGES][:nb].cpu()
    clinical = data[KEY_GLOBAL][:nb].cpu()
    noise = elastic_noise(torch.Generator().manual_seed(5), nb, CAE_DHW)
    flip = torch.tensor([True, False])
    gen = torch.Generator().manual_seed(3)
    seeded = Cae3DCtp(Enc3DCtp(CTP_CHANNELS, padding=CTP_PAD, generator=gen),
                      Dec3D(CTP_CHANNELS, generator=gen))
    args = (seeded, labels, images, clinical, noise, flip,
            learner_stub(learner))
    # the float64 witness runs the plain versions (the CPU's code) on the
    # card: float64 convs there take seconds, on the CPU ~55 s
    sides = (("card float32", "cuda", torch.float32),
             ("card float32, entry K4 zeroed", "cuda", torch.float32),
             ("CPU float32", "cpu", torch.float32),
             ("float64 (plain, on the card)", "cuda", torch.float64))
    pool = {side: witness(ctp_step_side, *args, side, dev, dt)
            for side, dev, dt in sides if dev == "cpu"}
    got = {side: ctp_step_side(torch, *args, side, dev, dt)
           for side, dev, dt in sides if dev != "cpu"}
    n_params = len(list(seeded.parameters()))
    return Deferred(lambda: ctp_step_vs_cpu_check(got, pool, n_params))


def ctp_step_vs_cpu_check(got, pool, n_params):
    """:func:`ctp_step_vs_cpu`'s comparisons, its CPU side in."""
    import torch

    got.update({side: f.result() for side, f in pool.items()})
    out = {side: v[0] for side, v in got.items()}
    signs = {side: v[1] for side, v in got.items()}
    nb = CAE_VS_CPU_BATCH
    print("\ncae ctp step seconds: " + ", ".join(
        f"{side} {v[3]:.2f} s" for side, v in out.items()))
    f64 = "float64 (plain, on the card)"
    flips = {side: int((s_ != signs[f64]).sum()) for side, s_ in
             signs.items() if side != f64}
    print(f"cae ctp step (factor {CTP_VS_CPU_FACTOR}): latent elements "
          f"where sign(z_interp - z_lesion), the L1 term's gradient, "
          f"differs from float64's (of {signs[f64].numel()}): {flips}")
    card = out["card float32"]
    out["card float32, entry BN zeroed"] = (card[0], {
        k: torch.zeros_like(g) if k in CTP_ENTRY[:2] else g
        for k, g in card[1].items()}) + card[2:]
    if any(len(v[1]) != n_params for v in out.values()):
        raise AssertionError(f"cae ctp step: {n_params} gradients expected")
    what = f"cae ctp step (batch {nb})"
    loss_rel, grad, stats, _ = grad_compare(out, "card float32", f64,
                                            cae_layer_of, what)
    res = dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
               stats_err=stats,
               card_vs_cpu=grad_compare(out, "card float32", "CPU float32",
                                        cae_layer_of, what)[1][0],
               cpu_vs_f64=grad_compare(out, "CPU float32", f64,
                                       cae_layer_of, what)[1][0],
               controls={})
    entry = {}
    for k in CTP_ENTRY:
        ref = out[f64][1][k]
        entry[k] = {side: rel_err(out[side][1][k], ref)
                    for side in ("card float32", "CPU float32")}
    res["entry_vs_f64"] = entry
    print(f"{what}: the entry's gradients against float64, of their own "
          f"max|ref| (limit {CTP_ENTRY_F64_REL}): {entry}")
    for side in ("card float32, entry K4 zeroed",
                 "card float32, entry BN zeroed"):
        g = grad_compare(out, side, f64, cae_layer_of, what)[1]
        res["controls"][side] = dict(grad_rel=g[0], worst_grad=g[1])
        if g[0] <= STEP_GRAD_REL:
            raise AssertionError(f"{what}: the {side} control passes the "
                                 f"STEP_GRAD_REL limit: {g}")
    if (loss_rel > STEP_LOSS_REL or grad[0] > STEP_GRAD_REL
            or stats > STEP_STATS_ATOL):
        raise AssertionError(f"{what}: card vs float64 beyond the STEP_* "
                             f"limits: {res}")
    if any(e["card float32"] > CTP_ENTRY_F64_REL for e in entry.values()):
        raise AssertionError(f"{what}: the card's entry gradients off "
                             f"float64: {entry}")
    return res


# The SDM baseline tester on the card: its CLI on three cases with the
# labels, on one with the U-Net segmentations and on one without the latent
# resample; a case's four EDTs are one edt_sites call of four volumes, its
# three measures' EDTs one call a direction of three
SDM_FOLD = (0, 1, 2)
SDM_EDT_PER_CASE = {(4, *CAE_DHW): 1, (3, *CAE_DHW): 2}
SDM_MEASURES_ATOL = 1e-6     # card vs CPU: DC, HD, ASSD


def sdm_case_inputs(torch, args, case_index):
    """A case's (core, penu, lesion, time to treatment) as the SDM CLI reads
    them -> {device: inputs} for the card and the CPU."""
    from stroke_prediction_tpu_torch.cli.common import make_dataset
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS, LABEL_CORE, LABEL_LESION,
        LABEL_PENU, MOD_UNET_CORE, MOD_UNET_PENU)

    ds = make_dataset(args, [MOD_UNET_CORE, MOD_UNET_PENU],
                      [LABEL_CORE, LABEL_PENU, LABEL_LESION],
                      flip_split_id=args.hemisflipid)
    sample = ds.sample(case_index)
    clinical = sample[KEY_GLOBAL]
    ttt = float(clinical[1]) / (float(args.normalize) - float(clinical[0]))
    out = {}
    for dev in ("cuda", "cpu"):
        labels = torch.from_numpy(sample[KEY_LABELS]).to(dev)
        src = labels if args.groundtruth else torch.from_numpy(
            sample[KEY_IMAGES]).to(dev)
        out[dev] = (src[..., 0], src[..., 1], labels[..., 2], ttt)
    return out


def sdm_phase(torch, work):
    """The SDM baseline tester's CLI (``cli.test_sdm_resampling``, no
    ``--device``: the card) on three cases with ``--groundtruth 1``, one
    with ``--groundtruth 0`` and one with ``--downsample 0``: edt_sites
    launches (SDM_EDT_PER_CASE; no conv kernel), the results lines and the
    dumps; per case of each run, every edt_sites call on its own masks
    equal to plain, and the case on the card against the port on the CPU
    (the thresholded reconstructions equal, DC / HD / ASSD within
    SDM_MEASURES_ATOL); ms a case to the measures and with the dumps; a
    case's device time and kernels (torch.profiler), and its edt_sites
    calls' device time against plain and the bytes bound."""
    from stroke_prediction_tpu_torch.cli import test_sdm_resampling as sdm_cli
    from stroke_prediction_tpu_torch.ops import edt as edt_mod
    from stroke_prediction_tpu_torch.utils.args import get_args_sdm

    runs = (("groundtruth 1", SDM_FOLD, []),
            ("groundtruth 0", SDM_FOLD[:1], ["--groundtruth", "0"]),
            ("downsample 0", SDM_FOLD[:1], ["--downsample", "0"]))
    per_case_edt = sum(SDM_EDT_PER_CASE.values())
    res = {}
    for name, fold, extra in runs:
        what = f"sdm ({name})"
        base = os.path.join(work, "sdm_" + name.replace(" ", ""))
        args = get_args_sdm(["--synthetic", "--fold", *map(str, fold),
                             "--outbasepath", base, *extra])
        if args.device != "cuda":
            raise AssertionError(f"{what}: the CLI's default {args.device}")
        reset_launches()
        t0 = time.perf_counter()
        seconds = sdm_cli.infer(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        with open(base + "_sdm_results.txt") as f:
            lines = f.read().splitlines()
        print(f"\n{what}: CLI on {len(seconds)} case(s) in {wall:.2f} s; "
              f"launches {launches}; (case, s to measures, s with dumps) "
              f"{seconds}; results lines {lines}")
        if (len(seconds) != len(fold) or len(lines) != len(fold)
                or launches["edt_sites"] != per_case_edt * len(fold)
                or any(n for k, n in launches.items() if k != "edt_sites")):
            raise AssertionError(f"{what}: launches {launches}, expected "
                                 f"{per_case_edt} edt_sites a case and no "
                                 f"other kernel")
        for cid, _, _ in seconds:
            for part in ("_lesion", "_fuctgt", "_core", "_penu"):
                if not os.path.getsize(f"{base}_{cid}{part}.nii.gz"):
                    raise AssertionError(f"{what}: empty {part} dump")
        check_dump_codecs(f"{base}_{seconds[0][0]}_core.nii.gz", what)
        checks = []
        for cid, _, _ in seconds:
            inputs = sdm_case_inputs(torch, args, cid)
            card_in, cpu_in = inputs["cuda"], inputs["cpu"]
            got = []
            calls, sites, _ = cae_recorded(torch, lambda: got.append(
                sdm_cli.sdm_case(*card_in, bool(args.downsample))))
            (card_out, card_m), = got
            cpu_out, cpu_m = sdm_cli.sdm_case(*cpu_in, bool(args.downsample))
            if calls or sites != SDM_EDT_PER_CASE:
                raise AssertionError(f"{what}: case {cid}: calls {calls}, "
                                     f"edt_sites {sites}")
            masks = [(card_out[i].cpu() > 0, cpu_out[i] > 0) for i in (1, 2)]
            masks.append((card_out[0].cpu() < 0, cpu_out[0] < 0))
            m_err = max(0.0 if a == b else abs(a - b)
                        for u, v in zip(card_m, cpu_m) for a, b in zip(u, v))
            sdm_err = max(rel_err(card_out[i].cpu(), cpu_out[i])
                          for i in range(6))
            same = all(torch.equal(a, b) for a, b in masks)
            checks.append(dict(case=cid, masks_equal=same, measures_err=m_err,
                               sdm_rel_err=sdm_err, measures=card_m))
            print(f"{what}: case {cid}: every edt_sites call {sites} equal "
                  f"to plain; card vs CPU: thresholded masks equal {same}, "
                  f"DC/HD/ASSD max|err| {m_err:.3e} (limit "
                  f"{SDM_MEASURES_ATOL}), SDM values {sdm_err:.3e} of "
                  f"max|ref|; [DC, HD, ASSD] x (lesion, core, penumbra) "
                  f"{card_m}")
            if not same or m_err > SDM_MEASURES_ATOL:
                raise AssertionError(f"{what}: case {cid}: card and CPU "
                                     f"differ: {checks[-1]}")
        after = [s for s in seconds[1:]] or seconds
        res[name] = dict(
            launches=launches, cases=checks, wall=wall,
            to_measures_ms=1e3 * sum(s[1] for s in after) / len(after),
            with_dumps_ms=1e3 * sum(s[2] for s in after) / len(after))

    # one case of the first run: device time and kernels, and its
    # edt_sites calls (kept) timed against plain and the bound
    args = get_args_sdm(["--synthetic", "--fold", "0"])
    case_in = sdm_case_inputs(torch, args, SDM_FOLD[0])["cuda"]
    kept, real = [], edt_mod.edt_sites

    def keep(mask):
        kept.append(mask.clone())
        return real(mask)

    keep.launches = 0
    edt_mod.edt_sites = keep
    try:
        sdm_cli.sdm_case(*case_in)
    finally:
        edt_mod.edt_sites = real
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdm_cli.sdm_case(*case_in)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy, n_kernels, groups = trace_kernels(
        torch, lambda: sdm_cli.sdm_case(*case_in), "sdm case profile",
        wall_ms)
    if not busy:
        raise AssertionError("sdm case profile: no device time in the trace")
    # each call traced on its own: device_ms counts a kernel by its calls
    timed_calls = [device_ms(torch, lambda m=m: real(m), 10, events=True)
                   for m in kept]
    k5_ms = sum(t[0] for t in timed_calls)
    k5_kernels = sum(t[1] for t in timed_calls)
    plain_ms = cuda_ms(torch, lambda: [edt_mod.edt_sites_plain(m)
                                       for m in kept], 3)
    bounds = [edt_bound(tuple(m.shape)) for m in kept]
    bound = sum(b[0] for b in bounds)
    k5 = dict(launches=len(kept), ms=k5_ms, kernels=k5_kernels,
              plain_ms=plain_ms, bound_ms=bound, bound_by=bounds[0][1],
              shapes=[tuple(m.shape) for m in kept])
    print(f"sdm: per case {len(kept)} edt_sites calls at {k5['shapes']}: "
          f"device {k5_ms:.4f} ms in {k5_kernels:g} kernels, plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bounds[0][1]}; "
          f"{100 * bound / k5_ms:.1f}% of it); the case: host {wall_ms:.2f} "
          f"ms, device busy {busy:.3f} ms in {n_kernels} kernels")
    return dict(runs=res, k5=k5, case=dict(wall_ms=wall_ms, busy_ms=busy,
                                           kernels=n_kernels))


# torch.cuda._sleep's kernel: launched just before and just after each EDT
# call of a marked trace, it brackets that call's device work
EDT_MARK = "spin_kernel"


def marked_spans(prof, reps):
    """(device ms, kernels) per rep of the device work between each pair of
    EDT_MARK kernels of a trace, in device order."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    ms, n, marks, inside = 0.0, 0, 0, False
    for e in events:
        if EDT_MARK in e.name:
            inside, marks = not inside, marks + 1
        elif inside:
            ms += e.time_range.elapsed_us() / 1e3
            n += 1
    if inside or marks != 2 * EDT_PER_STEP * reps:
        raise AssertionError(f"{marks} EDT marks in the trace, expected "
                             f"{2 * EDT_PER_STEP * reps}")
    return ms / reps, n / reps


def profile_cases(torch, tester, batch, infer_ms, reps=3):
    """Device time per tester case by kernel (torch.profiler, CUPTI) and the
    device's busy share of the unprofiled ms per case.  Then the EDT's
    device time per case inside the tester's own cases, its calls marked
    (EDT_MARK): with its kernels, and with the parent composition (the
    parent's scan, copies and sqrt around today's single pass) in their
    place; and the same case's four masks' EDTs outside the case: back to
    back, after an L2 flush (a 256 MB write) and after 2 ms of an idle card
    before each case's worth; the labels' layout; the shares of the masks'
    columns, 8-column lanes and 32-column strips with a site in every
    column (where an outward scan along D could stop early).  Returns
    {what: (device ms, kernels) per case} and those shares."""
    from torch.autograd import DeviceType

    from stroke_prediction_tpu_torch.data.dataset import KEY_LABELS
    from stroke_prediction_tpu_torch.eval import metrics
    from stroke_prediction_tpu_torch.ops import edt

    def trace(fn, n=reps):
        with torch.inference_mode():
            return profiled(torch, lambda: [fn() for _ in range(n)],
                            "profile")

    prof = trace(lambda: tester.infer_batch(batch))
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if not busy_ms:
        raise AssertionError("profile: no device time in the trace")
    print(f"profile: device busy {busy_ms:.3f} ms per case of {infer_ms:.2f} "
          f"ms ({100 * busy_ms / infer_ms:.1f}% busy); "
          f"{sum(e.count for e in kernels) / reps:.0f} kernels per case")
    groups = kernel_groups(kernels, reps)
    print("  by kernel, per case: " + "; ".join(
        f"{g} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%, x{n:g})"
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    named = groups.get("K5 EDT", (0.0, 0.0))
    if named[1] != 2 * EDT_PER_STEP:
        raise AssertionError(f"the profiled tester case ran {named[1]:g} EDT "
                             f"kernels, expected {2 * EDT_PER_STEP}")
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"  {ms:8.4f} ms {100 * ms / busy_ms:5.1f}%  x{e.count / reps:g}"
              f"  {e.key[:90]}")

    masks = []
    kernel_edt = metrics.edt_to_sites

    def in_case(edt_fn):
        def marked(sites, axes):
            if len(masks) < EDT_PER_STEP:
                masks.append(sites)
            torch.cuda._sleep(1)
            out = edt_fn(sites, axes)
            torch.cuda._sleep(1)
            return out
        metrics.edt_to_sites = marked
        try:
            return marked_spans(trace(lambda: tester.infer_batch(batch)),
                                reps)
        finally:
            metrics.edt_to_sites = kernel_edt

    out = {"named": named, "in_case": in_case(kernel_edt),
           "parent_in_case": in_case(
               lambda s, axes: edt.separable_edt(s, axes, edt.edt_parabola))}
    labels = tester._to_device(batch[KEY_LABELS])
    print(f"profile: the case's labels {tuple(labels.shape)} arrive with "
          f"strides {labels.stride()}; the EDT's masks are contiguous: "
          f"{[m.is_contiguous() for m in masks]}")
    if out["in_case"][1] != 2 * EDT_PER_STEP:
        raise AssertionError(f"{out['in_case'][1]:g} kernels inside the "
                             f"marked EDT calls, expected "
                             f"{2 * EDT_PER_STEP}")

    flush = torch.empty(64 << 20, device="cuda")
    variants = {"back_to_back": lambda: None, "l2_flushed": flush.zero_,
                "idle_gap": lambda: (torch.cuda.synchronize(),
                                     time.sleep(2e-3))}
    for name, before in variants.items():
        def case_edts():
            before()
            for m in masks:
                edt.edt_sites(m)
        prof = trace(case_edts, 20)
        ks = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and any(k in e.key for k in EDT_KERNELS)]
        out[name] = (sum(e.self_device_time_total for e in ks) / 1e3 / 20,
                     sum(e.count for e in ks) / 20)
    del flush
    print("profile: the EDT per case, device ms (kernels): "
          + "; ".join(f"{k} {ms:.4f} ({n:g})" for k, (ms, n) in out.items())
          + f"  [named = the EDT kernels' names in the trace above; in_case "
          f"/ parent_in_case = inside the marked calls of {reps} cases with "
          f"the kernels / the parent composition; the rest = the case's "
          f"{len(masks)} masks, 20 times: back to back, after an L2 flush, "
          f"after 2 ms idle]")

    # an outward scan along D could stop a lane early only where all its 8
    # columns (kernel A's 8-byte loads) hold a site, and shorten a block's
    # scan only where all the columns of its 32-wide strip do
    cols = torch.stack([m.any(dim=1) for m in masks])     # (4, N, H, W)
    n4, h, w = cols.shape[1:]
    if w % EDT_STRIP == 0:
        lanes = cols.reshape(-1, n4, h, w // 8, 8).all(-1)
        strips = cols.reshape(-1, n4, h, w // EDT_STRIP, EDT_STRIP).all(
            -1).all(2)
        shares = {"columns": float(cols.float().mean()),
                  "lanes": float(lanes.float().mean()),
                  "strips": float(strips.float().mean())}
        print(f"profile: the case's EDT masks: {100 * shares['columns']:.2f}"
              f"% of (h, w) columns hold a site; {100 * shares['lanes']:.2f}"
              f"% of 8-column lanes and {100 * shares['strips']:.2f}% of "
              f"32-column strips hold one in every column")
        out["with_a_site_in_every_column"] = shares
    return out


# The 4-scale U-Net (LargeUnet3D, kind large_unet3d) at its default width.
# The tester runs on synthetic 264x264x28 cases, resampled to 132x132x28
# and padded by 44 to 116x220x220, whose output (the input less 88) is the
# 28x132x132 labels; training crops 116x124x124 patches (labels 28x36x36)
# at batch 6 of the same padded volumes.  Every 3^3 conv but the entry one
# is over FUSED_DW_BYTES, so a step runs 14 K1, 13 K3, 14 K4 and no K2.
LARGE_CHANNELS = (2, 32, 64, 128, 256, 128, 64, 32, 32, 2)
LARGE_GEOMETRY = ("--xyoriginal", "264", "--zsize", "28", "--padding", "44",
                  "44", "44")
LARGE_PAD = (44, 44, 44)
LARGE_OUT_DHW = (28, 132, 132)
LARGE_PATCH_WHD = (124, 124, 116)
LARGE_EPOCHS = 2
LARGE_TIMED_STEPS = 10
LARGE_CPU_DHW = (92, 92, 92)      # the card-vs-CPU forward: output 4^3
LARGE_VS_CPU_BATCH = 2
# The float32 LargeUnet3D step (batch 2, seeded weights) is too
# ill-conditioned for STEP_GRAD_REL card vs CPU: on an NVIDIA H100 80GB HBM3
# (700 W) the card's float32 gradients were 6.40e-3 of their layer's
# largest off a float64 step and the CPU's 4.02e-3, so card and CPU stood
# 6.29e-3 apart, though every K1 / K3 / K4 call of the step agreed with its
# plain version.  With every 3^3 conv computed in float64 and rounded to
# float32 (``in_float64``) the card's step was 1.38e-3 off float64 and the
# CPU's 6.74e-3: the card's distance is mostly its convs' float32 sums, the
# CPU's its other float32 operations (which of them is not measured), so
# the CPU's float32 step cannot judge the card's other operations at
# STEP_GRAD_REL either.  So the step is held two ways.  The
# whole float32 step, the kernels in it: the card's gradients against the
# float64 step (the largest element's |err| over its layer's largest
# gradient, and |err| / |grad| over a layer, each the largest over the
# layers) no further off than LARGE_F32_GRAD_FACTOR times the CPU's float32
# step plus LARGE_F32_GRAD_FLOOR, its loss and running statistics card vs
# CPU at STEP_LOSS_REL and STEP_STATS_ATOL; the entry conv's K4 output
# zeroed must fail it.  The step's operations on the card against the
# CPU's, where float32 rounding does not blur them: the float64 step (the
# plain versions) card vs CPU at the STEP_* limits; the card's entry BN
# gradients zeroed must fail it.
LARGE_F32_GRAD_FACTOR, LARGE_F32_GRAD_FLOOR = 2.0, 1e-4


def large_conv_layers(channels=LARGE_CHANNELS):
    """(C_in, C_out, input needs a gradient) of LargeUnet3D's fourteen 3^3
    convs, in call order."""
    c_in, b1, b2, b3, b4, b5, b6, b7 = channels[:8]
    blocks = ((c_in, b1), (b1, b2), (b2, b3), (b3, b4), (b4 + b3, b5),
              (b5 + b2, b6), (b6 + b1, b7))
    layers = []
    for ci, co in blocks:
        layers += [(ci, co, bool(layers)), (co, co, True)]
    return layers


def large_step_launches(channels=LARGE_CHANNELS):
    """K1-K4 launches of one LargeUnet3D training step by the route rule."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    routes = [bwd_route(*c) for c in large_conv_layers(channels)]
    return {"K1": len(routes), "K2": routes.count("fused"),
            "K3": routes.count("split"),
            "K4": routes.count("split") + routes.count("dw")}


def kernel_widths(calls, kernel):
    """The (C_in, C_out) pairs at which ``kernel`` ran in recorded
    ``calls``."""
    return sorted({key[5:7] for key in calls if key[0] == kernel})


def check_dump_codecs(path, what):
    """One tester dump read by the native codec and by the pure-Python
    reader: equal volumes and affines (where the native codec is in
    use)."""
    import numpy as np

    from stroke_prediction_tpu_torch.utils import native_io
    from stroke_prediction_tpu_torch.utils.nifti import read_nifti

    if not native_io.available():
        return
    (vol, aff), (ref, ref_aff) = native_io.read_nifti(path), read_nifti(path)
    if not (np.array_equal(vol, ref) and np.array_equal(aff, ref_aff)):
        raise AssertionError(f"{what}: {path} reads differently through the "
                             f"native and the pure-Python codec")
    print(f"{what}: dump {os.path.basename(path)} {vol.shape} equal through "
          f"the native and the pure-Python readers")


def check_trace(logdir, what, train_steps):
    """The learner's torch.profiler trace in ``logdir``: ``train_steps``
    ``train_step`` ranges (one traced epoch) and the K1 kernel."""
    from stroke_prediction_tpu_torch.utils.profiling import TRACE_FILE

    path = os.path.join(logdir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    steps = sum(e.get("name") == "train_step"
                and e.get("cat") == "user_annotation" for e in events)
    k1 = sum("conv3x3_fwd" in n for n in names)
    print(f"{what}: --profile trace {path}: {os.path.getsize(path)} bytes, "
          f"{len(names)} events, {steps} train_step ranges, {k1} K1 kernel "
          f"events")
    if steps != train_steps or not k1:
        raise AssertionError(f"{what}: the trace holds {steps} train_step "
                             f"ranges (expected {train_steps}) and {k1} K1 "
                             f"kernels")


def nifti_codec():
    """``native`` or ``python (<why the native codec is not in use>)``."""
    from stroke_prediction_tpu_torch.utils import native_io

    return ("native" if native_io.available() else
            f"python ({native_io.build_error()})")


def large_unet_model(torch, images):
    """LargeUnet3D at LARGE_CHANNELS with seeded weights and BN scales and
    biases; its BN statistics moved by one training-mode forward of
    ``images`` at momentum 0, so that they are those images' moments at
    each layer, as a trained model's are of its data."""
    from stroke_prediction_tpu_torch.models.layers import BatchNorm
    from stroke_prediction_tpu_torch.models.unet3d import LargeUnet3D

    gen = torch.Generator().manual_seed(6)
    model = LargeUnet3D(LARGE_CHANNELS, generator=gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.scale.uniform_(0.8, 1.2, generator=gen)
            m.bias.uniform_(-0.1, 0.1, generator=gen)
            m.momentum = 0.0
        model.to("cuda").train()(images)
        for m in bns:
            m.momentum = 0.9
    return model.eval()


def large_unet_tester(torch, work):
    """The U-Net tester CLI on a ``large_unet3d`` checkpoint: launches,
    dumps, every K1 and edt_sites call of one case against plain, K1 per
    distinct layer against float64 and cuDNN, ms a case, the dumps' wall
    with each codec, and a 92^3 forward card vs CPU."""
    from stroke_prediction_tpu_torch.cli import test_unet_segmentation as cli
    from stroke_prediction_tpu_torch.cli.common import make_dataset
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_CASE_ID, KEY_IMAGES, LABEL_CORE, LABEL_PENU, MOD_CBV, MOD_TTD)
    from stroke_prediction_tpu_torch.data.loader import get_testdata
    from stroke_prediction_tpu_torch.models.convert import save_unet_checkpoint
    from stroke_prediction_tpu_torch.utils import native_io
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training
    from stroke_prediction_tpu_torch.utils.checkpoint import load_checkpoint
    from stroke_prediction_tpu_torch.utils.nifti import read_nifti

    what = "large unet"
    ckpt = os.path.join(work, "large_unet.model")
    base = os.path.join(work, "large")
    args = get_args_unet_training(
        [ckpt, "--synthetic", "--fold", *map(str, FOLD), *LARGE_GEOMETRY,
         "--outbasepath", base, "--device", "cuda"])
    cases = get_testdata(make_dataset(args, [MOD_CBV, MOD_TTD],
                                      [LABEL_CORE, LABEL_PENU],
                                      pad=tuple(args.padding)), args.fold)
    images = torch.from_numpy(cases.dataset.stack(cases.indices)[
        KEY_IMAGES]).to("cuda")
    model = large_unet_model(torch, images)
    del images
    save_unet_checkpoint(ckpt, model)
    header = load_checkpoint(ckpt)[1]
    if header != {"kind": "large_unet3d", "channels": list(LARGE_CHANNELS)}:
        raise AssertionError(f"{what}: checkpoint header {header}")

    reset_launches()
    t0 = time.perf_counter()
    tester = cli.test(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = len(tester.case_seconds)
    print(f"{what}: tester CLI on {n} cases ({header}) in {wall:.2f} s; "
          f"launches {launches}; nifti codec: {nifti_codec()}")
    want = {"conv3x3": 14 * len(FOLD), "edt_sites": EDT_PER_STEP * len(FOLD)}
    if n != len(FOLD) or any(v != want.get(k, 0)
                             for k, v in launches.items()):
        raise AssertionError(f"{what}: {n} cases, launches {launches}; "
                             f"expected {want} and no other kernel")
    steady = tester.case_seconds[1:]
    infer_ms = 1e3 * sum(s[1] for s in steady) / len(steady)
    total_ms = 1e3 * sum(s[2] for s in steady) / len(steady)
    print(f"{what}: ms per case after the first: {infer_ms:.2f} to the "
          f"measures, {total_ms:.2f} with the two NIfTI dumps; per case (id, "
          f"s, s): {tester.case_seconds}")
    native_size = (2 * LARGE_OUT_DHW[2], 2 * LARGE_OUT_DHW[1],
                   LARGE_OUT_DHW[0])
    for cid, _, _ in tester.case_seconds:
        for part in ("_core", "_penu"):
            vol, _ = read_nifti(f"{base}_{cid}{part}.nii.gz")
            if vol.shape != native_size or not (
                    vol.min() >= 0.0 and vol.max() <= 1.0):
                raise AssertionError(f"{what}: case {cid}{part}: shape "
                                     f"{vol.shape} or values outside [0, 1]")
    check_dump_codecs(f"{base}_{tester.case_seconds[0][0]}_core.nii.gz",
                      what)

    loader = tester._dataloader
    batch = loader.dataset.stack([loader.indices[0]])
    calls, sites, worst = cae_recorded(
        torch, lambda: tester.infer_batch(batch))
    cae_check_recorded("one tester case", calls, sites, worst, {"K1": 14},
                       {(1, *LARGE_OUT_DHW): EDT_PER_STEP}, what)
    k1 = cae_kernel_phase(torch, calls, "per large U-Net tester case", 0.01,
                          "the large U-Net's")

    # a case's two dumps with each codec
    cid = int(batch[KEY_CASE_ID][0])
    with torch.inference_mode():
        _, seg = tester.infer_batch(batch)
    dump_s = {}
    real_write = native_io.write_nifti
    for codec in ("native", "python"):
        if codec == "native" and not native_io.available():
            continue
        if codec == "python":
            native_io.write_nifti = lambda *a: False
        try:
            t0 = time.perf_counter()
            tester.save_inference(seg, batch, "_" + codec)
            dump_s[codec] = time.perf_counter() - t0
        finally:
            native_io.write_nifti = real_write
    print(f"{what}: one case's two dumps ({native_size}, gzip level "
          f"{native_io.GZIP_LEVEL}), s by codec: {dump_s}")
    if "native" in dump_s:
        a = read_nifti(f"{base}_{cid}_core_native.nii.gz")
        b = read_nifti(f"{base}_{cid}_core_python.nii.gz")
        if not all((x == y).all() for x, y in zip(a, b)):
            raise AssertionError(f"{what}: the two codecs' dumps differ")

    # the full-width model on one 92^3 input, card vs CPU
    x = torch.rand((1, *LARGE_CPU_DHW, 2), generator=torch.Generator()
                   .manual_seed(7)) * 2.0
    with torch.inference_mode():
        card = tester._model(x.to("cuda")).cpu()
        cpu = copy.deepcopy(tester._model).to("cpu")(x)
    err = float((card - cpu).abs().max())
    print(f"{what}: one {LARGE_CPU_DHW} input card vs CPU: output "
          f"{tuple(card.shape)}, max|prob err| {err:.3e} (limit "
          f"{SLICE_ATOL}); probabilities {float(cpu.min()):.4f} to "
          f"{float(cpu.max()):.4f}")
    if tuple(card.shape) != (1, 4, 4, 4, 2) or not err <= SLICE_ATOL:
        raise AssertionError(f"{what}: card vs CPU {err}")
    return dict(launches=launches, k1=k1, infer_ms=infer_ms,
                total_ms=total_ms, dump_s=dump_s, vs_cpu=err,
                widths=kernel_widths(calls, "K1"))


def large_unet_train(torch, work):
    """UnetSegmentationLearner on a bfloat16 LargeUnet3D (the library route:
    the CLI builds Unet3D only) with ``log_throughput`` and ``profile_dir``:
    launches, losses, the header, the ``[throughput]`` line, the trace;
    every K1, K3 and K4 call of one step in both types against plain; per
    layer beside cuDNN; timed steps and a profile; a float32 step card vs
    CPU."""
    import contextlib
    import io
    import re

    from stroke_prediction_tpu_torch.cli.common import make_dataset
    from stroke_prediction_tpu_torch.data.dataset import (
        LABEL_CORE, LABEL_PENU, MOD_CBV, MOD_TTD)
    from stroke_prediction_tpu_torch.data.loader import (
        get_stroke_shape_training_data)
    from stroke_prediction_tpu_torch.models.factory import load_model
    from stroke_prediction_tpu_torch.models.unet3d import (
        LargeUnet3D, unet_output_spatial)
    from stroke_prediction_tpu_torch.train.optim import make_optimizer
    from stroke_prediction_tpu_torch.train.unet_learner import (
        UnetSegmentationLearner)
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

    what = "large unet train"
    base = os.path.join(work, "large_train")
    prof = os.path.join(work, "large_profile")
    args = get_args_unet_training(
        [os.path.join(work, "unused.model"), "--synthetic", "--fold",
         *map(str, TRAIN_FOLD), "--validsetsize", "0.25", "--batchsize",
         str(TRAIN_BATCH), *LARGE_GEOMETRY, "--device", "cuda"])
    ds_train, ds_valid = get_stroke_shape_training_data(
        make_dataset(args, [MOD_CBV, MOD_TTD], [LABEL_CORE, LABEL_PENU],
                     flip_split_id=args.hemisflipid, pad=LARGE_PAD),
        args.fold, args.validsetsize, seed=args.seed,
        batchsize=args.batchsize)
    model = LargeUnet3D(LARGE_CHANNELS,
                        generator=torch.Generator().manual_seed(args.seed),
                        compute_dtype=getattr(torch, args.dtype)).to("cuda")
    learner = UnetSegmentationLearner(
        ds_train, ds_valid, model,
        make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                       weight_decay=1e-5), None, n_epochs=LARGE_EPOCHS,
        patch_whd=LARGE_PATCH_WHD, pad_xyz=LARGE_PAD, path_outputs_base=base,
        seed=args.seed, log_throughput=True, profile_dir=prof, device="cuda")

    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            learner.run_training()
        torch.cuda.synchronize()
    finally:
        print(out.getvalue())
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = dict(learner.step_counts)
    per_step = large_step_launches()
    n_train, n_eval = steps["train"], steps["eval"]
    n_fwd = n_train + n_eval + steps["visual"]
    want = {"conv3x3": per_step["K1"] * n_fwd,
            "conv3x3_bwd_fused": per_step["K2"] * n_train,
            "conv3x3_bwd_dx": per_step["K3"] * n_train,
            "conv3x3_bwd_dw": per_step["K4"] * n_train,
            "edt_sites": EDT_PER_STEP * n_eval, "edt_parabola": 0}
    print(f"{what}: {args.dtype}, batch {TRAIN_BATCH}, patch "
          f"{LARGE_PATCH_WHD[::-1]} (D, H, W), {LARGE_EPOCHS} epochs in "
          f"{wall:.2f} s; steps {steps}; launches {launches}; per training "
          f"step {per_step} (K2 does not run: every conv but the entry is "
          f"over FUSED_DW_BYTES, the entry takes dW only); training passes "
          f"(s, steps) {learner.train_pass_seconds}")
    if per_step != {"K1": 14, "K2": 0, "K3": 13, "K4": 14}:
        raise AssertionError(f"{what}: the route rule gives {per_step}")
    if n_train != LARGE_EPOCHS or n_eval != LARGE_EPOCHS:
        raise AssertionError(f"{what}: steps {steps}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    rates = re.findall(r"\[throughput\] ([0-9.]+) volumes/sec/chip over "
                       r"(\d+) timed steps", out.getvalue())
    print(f"{what}: [throughput] lines (volumes/sec/chip, timed passes; "
          f"a pass is one step of {TRAIN_BATCH} volumes, and the timed one "
          f"is the traced one): {rates}")
    if [n for _, n in rates] != [str(e) for e in range(LARGE_EPOCHS)] or \
            not float(rates[-1][0]) > 0:
        raise AssertionError(f"{what}: [throughput] lines {rates}")
    for phase in ("training", "validate"):
        losses = [m["loss"] for m in learner._metric_dtos[phase]]
        if len(losses) != LARGE_EPOCHS or not all(0.0 <= v <= 1.0
                                                  for v in losses):
            raise AssertionError(f"{what}: {phase} losses {losses}")
    check_artifacts(base, ["_unet.model", "_unet.optim", "_unet.json",
                           "_unet_final.model"],
                    ["_visual_1.png", "_visual_plots.png"], what)
    best, config = load_model(base + "_unet.model", "cuda")
    with torch.no_grad():
        seg = best(torch.zeros((1, *LARGE_PATCH_WHD[::-1], 2),
                               device="cuda"))
    if (config != {"kind": "large_unet3d", "channels": list(LARGE_CHANNELS)}
            or not isinstance(best, LargeUnet3D)
            or tuple(seg.shape) != (1, *unet_output_spatial(
                LARGE_PATCH_WHD[::-1], 4), 2)):
        raise AssertionError(f"{what}: best-valid model {config}, "
                             f"{tuple(seg.shape)}")
    print(f"{what}: best-valid model {config} runs: output "
          f"{tuple(seg.shape)}")
    check_trace(prof, what, n_train // LARGE_EPOCHS)

    data, _ = learner.device_data(learner._dataloader_training)
    rows = torch.arange(TRAIN_BATCH, device="cuda")
    batch = {k: None if v is None else v.index_select(0, rows)
             for k, v in data.items()}
    recorded = {}
    for dtype in (torch.bfloat16, torch.float32):
        learner._model.compute_dtype = dtype
        calls, sites, worst = cae_recorded(
            torch, lambda: learner.train_step(batch), grad=True)
        dname = str(dtype)[6:]
        cae_check_recorded(f"one {dname} training step", calls, sites, worst,
                           per_step, {}, what)
        recorded[dname] = calls, worst
    learner._model.compute_dtype = torch.bfloat16
    times = {dname: cae_step_kernel_times(torch, calls, per_step, what)
             for dname, (calls, _) in recorded.items()}
    mean, std, host = time_steps(
        torch, lambda: learner.train_step(batch), LARGE_TIMED_STEPS,
        f"{what} (bfloat16, batch {TRAIN_BATCH})")
    busy = cae_profile_step(torch, learner, batch, what)
    vs_cpu = large_step_vs_cpu(torch, learner)
    widths = {k: kernel_widths(recorded["bfloat16"][0], k)
              for k in ("K1", "K3", "K4")}
    print(f"{what}: widths (C_in, C_out) per kernel: {widths}")
    return dict(launches=launches, per_step=per_step, steps=steps,
                recorded={d: r[1] for d, r in recorded.items()}, times=times,
                step_ms=dict(mean=mean, std=std, host=host), busy=busy,
                vs_cpu=vs_cpu, widths=widths,
                throughput=float(rates[-1][0]),
                step_rate=1e3 * TRAIN_BATCH / mean, learner=learner)


def in_float64(torch, fn):
    """``fn`` (a conv function's plain version) computed in float64, its
    results rounded to its first tensor input's type."""
    def run(*args, **kw):
        dt = next(a.dtype for a in args if torch.is_tensor(a))
        out = fn(*(a.double() if torch.is_tensor(a) else a for a in args),
                 **kw)
        return (tuple(o.to(dt) for o in out) if isinstance(out, tuple)
                else out.to(dt))

    run.launches = 0
    return run


def large_step_side(torch, seeded, imgs, labs, stub, dev, dt, swap):
    """One side of :func:`large_step_vs_cpu`: the LargeUnet3D step of
    ``seeded`` in ``dt`` on ``dev`` with the 3^3 convs of ``swap``
    ("kernels", "kernels, entry K4 zeroed", "convs in float64" or
    "plain") -> (loss, gradients, running statistics, seconds)."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm

    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    plain = {n: getattr(cm, n + "_plain") for n in names}

    def entry_dw_zeroed(x, *args):
        """K4 with the entry conv's (data input) dW and db zeroed."""
        out = real["conv3x3_bwd_dw"](x, *args)
        return (tuple(torch.zeros_like(t) for t in out)
                if x.shape[-1] == LARGE_CHANNELS[0] else out)

    entry_dw_zeroed.launches = 0
    convs = {"kernels": real,
             "kernels, entry K4 zeroed": dict(
                 real, conv3x3_bwd_dw=entry_dw_zeroed),
             "convs in float64": {n: in_float64(torch, f)
                                  for n, f in plain.items()},
             "plain": plain}[swap]
    m = copy.deepcopy(seeded).to(dev, dt).train()
    m.compute_dtype = dt
    t0 = time.perf_counter()
    try:
        for n in names:
            setattr(cm, n, convs[n])
        seg = m(imgs.to(dev))
        labs_d = labs.to(dev, dt)
        loss = stub.loss(seg[..., 0:1], seg[..., 1:2], labs_d[..., 0:1],
                         labs_d[..., 1:2])
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            loss.backward()
    finally:
        for n in names:
            setattr(cm, n, real[n])
    if dev == "cuda":
        torch.cuda.synchronize()
    return (float(loss.detach()),
            {k: p.grad.cpu().double() for k, p in m.named_parameters()},
            {k: b.cpu().double() for k, b in m.named_buffers()},
            time.perf_counter() - t0)


def large_step_vs_cpu(torch, learner):
    """One LargeUnet3D training step (forward, loss, backward; no optimizer
    step) at batch LARGE_VS_CPU_BATCH from seeded weights on the same crop,
    on the card and on the CPU: in float32, in float32 with the 3^3 convs
    in float64 (:func:`in_float64`), and in float64 (the plain versions).
    The card's float32 step against float64 within LARGE_F32_GRAD_FACTOR
    times the CPU's (:func:`f64_distance`), its loss and statistics card vs
    CPU at STEP_LOSS_REL and STEP_STATS_ATOL; the float64 step card vs CPU
    at the STEP_* limits.  A control for each: the entry conv's K4 output
    zeroed on the card, and the card's entry BN gradients zeroed.  The CPU
    sides run in the witnesses' pool; the comparisons when the returned
    :class:`Deferred` resolves."""
    from stroke_prediction_tpu_torch.data.augment import (
        crop_patch, random_offsets)
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.unet3d import LargeUnet3D

    nb = LARGE_VS_CPU_BATCH
    data, _ = learner.device_data(learner._dataloader_training)
    images, labels = data[KEY_IMAGES][:nb].cpu(), data[KEY_LABELS][:nb].cpu()
    offsets = random_offsets(torch.Generator().manual_seed(2), nb,
                             tuple(images.shape[1:4]), LARGE_PATCH_WHD)
    imgs, labs = crop_patch(images, labels, offsets, LARGE_PATCH_WHD,
                            LARGE_PAD)
    seeded = LargeUnet3D(LARGE_CHANNELS,
                         generator=torch.Generator().manual_seed(3))
    card, cpu = "card float32", "CPU float32"
    card64, cpu64 = card + ", convs in float64", cpu + ", convs in float64"
    f64, cpu_f64 = "card float64 (plain)", "CPU float64"
    sides = ((card, "cuda", torch.float32, "kernels"),
             (card + ", entry K4 zeroed", "cuda", torch.float32,
              "kernels, entry K4 zeroed"),
             (cpu, "cpu", torch.float32, "kernels"),
             (card64, "cuda", torch.float32, "convs in float64"),
             (cpu64, "cpu", torch.float32, "convs in float64"),
             (f64, "cuda", torch.float64, "plain"),
             (cpu_f64, "cpu", torch.float64, "plain"))
    args = (seeded, imgs, labs, learner_stub(learner))
    pool = {side: witness(large_step_side, *args, dev, dt, swap)
            for side, dev, dt, swap in sides if dev == "cpu"}
    out = {side: large_step_side(torch, *args, dev, dt, swap)
           for side, dev, dt, swap in sides if dev != "cpu"}
    return Deferred(lambda: large_step_vs_cpu_check(out, pool))


def large_step_vs_cpu_check(out, pool):
    """:func:`large_step_vs_cpu`'s comparisons, its CPU sides in."""
    out.update({side: f.result() for side, f in pool.items()})
    what = f"large unet step (batch {LARGE_VS_CPU_BATCH})"
    card, cpu = "card float32", "CPU float32"
    card64, cpu64 = card + ", convs in float64", cpu + ", convs in float64"
    f64, cpu_f64 = "card float64 (plain)", "CPU float64"
    print(f"\n{what} seconds: " + ", ".join(
        f"{side} {v[3]:.2f} s" for side, v in out.items()))
    entry = "blocks.0.layers.0.bn."
    c = out[f64]
    out[f64 + ", entry BN zeroed"] = (c[0], {
        k: g.new_zeros(g.shape) if k.startswith(entry) else g
        for k, g in c[1].items()}) + c[2:]
    loss_rel, grad, stats, _ = grad_compare(out, card, cpu, unet_layer_of,
                                            what)
    dist = {side: f64_distance(out, side, f64, what)
            for side in (card, card + ", entry K4 zeroed", cpu, card64,
                         cpu64)}
    limit = {m: LARGE_F32_GRAD_FACTOR * dist[cpu][m] + LARGE_F32_GRAD_FLOOR
             for m in ("element", "layer")}

    def excess(side):
        return max(dist[side][m] - limit[m] for m in limit)

    rest = grad_compare(out, f64, cpu_f64, unet_layer_of, what)
    rest_control = grad_compare(out, f64 + ", entry BN zeroed", cpu_f64,
                                unet_layer_of, what)
    res = dict(loss_rel=loss_rel, grad_rel=grad[0], worst_grad=grad[1],
               stats_err=stats, vs_f64=dist[card], cpu_vs_f64=dist[cpu],
               excess=excess(card),
               control_excess=excess(card + ", entry K4 zeroed"),
               convs64=dict(card_vs_f64=dist[card64],
                            cpu_vs_f64=dist[cpu64]),
               f64=dict(loss_rel=rest[0], grad_rel=rest[1][0],
                        worst_grad=rest[1][1], stats_err=rest[2],
                        control=rest_control[1][0]))
    print(f"{what}: the card's float32 step vs float64 within "
          f"{LARGE_F32_GRAD_FACTOR} x the CPU's + {LARGE_F32_GRAD_FLOOR} "
          f"(element {limit['element']:.3e}, layer {limit['layer']:.3e}): "
          f"excess {res['excess']:.3e} (entry K4 zeroed "
          f"{res['control_excess']:.3e}); card vs CPU gradients {grad[0]:.2e}"
          f" of their layer's largest (not held: STEP_GRAD_REL "
          f"{STEP_GRAD_REL}), loss and statistics {loss_rel:.2e} / "
          f"{stats:.2e}; with the convs in float64 the card "
          f"{dist[card64]['element']:.3e} and the CPU "
          f"{dist[cpu64]['element']:.3e} off float64; the float64 step card "
          f"vs CPU at the STEP_* limits: loss {rest[0]:.2e}, gradients "
          f"{rest[1][0]:.2e}, statistics {rest[2]:.2e} (entry BN zeroed "
          f"{rest_control[1][0]:.2e})")
    if res["control_excess"] <= 0:
        raise AssertionError(f"{what}: the entry K4 zeroed control passes "
                             f"the float64 rule: {res}")
    if rest_control[1][0] <= STEP_GRAD_REL:
        raise AssertionError(f"{what}: the entry BN zeroed control passes "
                             f"STEP_GRAD_REL: {res}")
    if (loss_rel > STEP_LOSS_REL or stats > STEP_STATS_ATOL
            or res["excess"] > 0 or rest[0] > STEP_LOSS_REL
            or rest[1][0] > STEP_GRAD_REL or rest[2] > STEP_STATS_ATOL):
        raise AssertionError(f"{what}: beyond the limits: {res}")
    return res


def f64_distance(out, side, f64, what):
    """Side ``side``'s float32 gradients against the float64 step ``f64``:
    the largest element's |err| over its layer's largest float64 gradient,
    and |err| / |grad| over a layer, each the largest over the layers, with
    the layers that hold them."""
    g64 = out[f64][1]
    scale, elem, d2, r2 = {}, {}, {}, {}
    for k, ref in g64.items():
        lay = unet_layer_of(k)
        scale[lay] = max(scale.get(lay, 0.0), float(ref.abs().max()))
    for k, ref in g64.items():
        lay, diff = unet_layer_of(k), out[side][1][k] - ref
        elem[lay] = max(elem.get(lay, 0.0),
                        float(diff.abs().max()) / scale[lay])
        d2[lay] = d2.get(lay, 0.0) + float((diff ** 2).sum())
        r2[lay] = r2.get(lay, 0.0) + float((ref ** 2).sum())
    l2 = {lay: (d2[lay] / r2[lay]) ** 0.5 for lay in d2}
    worst, worst_l2 = max(elem, key=elem.get), max(l2, key=l2.get)
    got = dict(element=elem[worst], element_at=worst, layer=l2[worst_l2],
               layer_at=worst_l2)
    print(f"{what} {side} vs float64: element {got['element']:.3e} at "
          f"{worst}, layer {got['layer']:.3e} at {worst_l2}")
    return got


def large_unet_phase(torch, work):
    """The 4-scale U-Net at its default width: the tester CLI
    (:func:`large_unet_tester`) and training (:func:`large_unet_train`)."""
    return dict(tester=large_unet_tester(torch, work),
                train=large_unet_train(torch, work))


# Data-parallel U-Net training on the one card.  (a) the training CLI with
# --distributed --nprocs 1 --procid 0 over NCCL (the host path: the
# process-sharded loader and the prefetch) against two plain CLI runs of the
# same seed; (b) two ranks on cuda:0 over gloo (NCCL refuses two ranks on
# one card), each one full-width step on its 3 rows of a global batch of 6.
DP_EPOCHS = 2
DP_WORLD = 2
DP_SIDES = ("float64", "float32", "bfloat16", "float64, per-rank BN")
# a rank's float64 step (plain versions) against the one-process float64
# step: loss, gradients (of their layer's largest), running statistics (of
# their buffer's largest) and the counted measures, relative; ASSD is a
# float32 sum of distances that the ranks add in another order
DP_F64_REL, DP_ASSD_REL = 1e-9, 1e-6
# a rank's float32 / bfloat16 step against the one-process float64 step:
# within DP_FACTOR times that type's one-process distance plus DP_FLOOR
# (the form of the 4-scale U-Net's LARGE_F32_GRAD_FACTOR limit)
DP_FACTOR, DP_FLOOR = 2.0, 1e-4
# the --distributed CLI's curves against a plain run's: within twice two
# plain runs' spread plus DP_CURVE_REL of the value
DP_CURVE_REL = 1e-6
DP_TIMED_STEPS = 4
DP_RANK_TIMEOUT = 600           # seconds for both ranks together


def dp_cli(torch, work):
    """(a): the CLI over NCCL as rank 0 of 1 between two plain runs: launch
    counts of K1-K5 in its run, its curves against the plain runs' spread,
    its files."""
    from stroke_prediction_tpu_torch.cli import train_unet_segmentation as cli
    from stroke_prediction_tpu_torch.cli.common import free_port
    from stroke_prediction_tpu_torch.utils.args import get_args_unet_training

    def run(name, extra):
        base = os.path.join(work, name)
        args = get_args_unet_training(
            [os.path.join(work, "unused.model"), "--synthetic", "--fold",
             *map(str, TRAIN_FOLD), "--validsetsize", "0.25", "--batchsize",
             str(TRAIN_BATCH), "--epochs", str(DP_EPOCHS), "--outbasepath",
             base, "--device", "cuda", "--channels", *map(str, CHANNELS),
             *extra])
        reset_launches()
        t0 = time.perf_counter()
        learner = cli.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return learner, read_launches(), wall, base

    plain_a = run("dp_plain_a", [])
    dist = run("dp_distributed", ["--distributed", "--coordinator",
                                  f"127.0.0.1:{free_port()}", "--nprocs",
                                  "1", "--procid", "0"])
    plain_b = run("dp_plain_b", [])
    learner, launches, wall, base = dist
    if not (learner._mesh is not None and learner._mesh.world == 1
            and learner._dataloader_training.process_shard):
        raise AssertionError("dp: the --distributed run did not take the "
                             "mesh and the process-sharded loader")
    steps = dict(learner.step_counts)
    per = dp_launches()
    n_fwd = steps["train"] + steps["eval"] + steps["visual"]
    want = {"conv3x3": per["K1"] * n_fwd,
            "conv3x3_bwd_fused": per["K2"] * steps["train"],
            "conv3x3_bwd_dx": per["K3"] * steps["train"],
            "conv3x3_bwd_dw": per["K4"] * steps["train"],
            "edt_sites": EDT_PER_STEP * steps["eval"], "edt_parabola": 0}
    print(f"dp: CLI --distributed (NCCL, rank 0 of 1), {DP_EPOCHS} epochs in "
          f"{wall:.2f} s (plain {plain_a[2]:.2f}, {plain_b[2]:.2f} s); steps "
          f"{steps}; launches {launches}, expected {want}")
    for name, n in want.items():
        if launches[name] != n or (n < 1 and name != "edt_parabola"):
            raise AssertionError(f"dp: {name} launched {launches[name]} "
                                 f"times, expected {n}")

    spread = curve_gap(plain_b[0], plain_a[0])
    gap = curve_gap(learner, plain_a[0])
    print(f"dp: --distributed curves vs a plain run: largest relative gap "
          f"{gap:.3e}; two plain runs {spread:.3e}; limit "
          f"{2 * spread + DP_CURVE_REL:.3e}; losses "
          f"{[m['loss'] for m in learner._metric_dtos['training']]} / "
          f"{[m['loss'] for m in plain_a[0]._metric_dtos['training']]}")
    if gap > 2 * spread + DP_CURVE_REL:
        raise AssertionError("dp: the --distributed run's curves leave the "
                             "plain runs' spread")
    check_artifacts(base, ["_unet.model", "_unet.optim", "_unet.json",
                           "_unet_final.model"],
                    ["_visual_1.png", "_visual_plots.png"], "dp")
    return dict(launches=launches, steps=steps, wall_s=wall,
                curve_gap=gap, curve_spread=spread), plain_a[0]


def dp_launches():
    """K1-K4 launches of one U-Net training step by the route rule."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    routes = [bwd_route(ci, co, i > 0) for i, (*_, ci, co) in
              enumerate(unet_conv_shapes(PATCH_DHW, CHANNELS))]
    return {"K1": len(routes), "K2": routes.count("fused"),
            "K3": routes.count("split"),
            "K4": routes.count("split") + routes.count("dw")}


def dp_learner(torch, inputs, dtype, mesh, distances, base):
    """A U-Net learner at ``inputs``' weights in ``dtype`` on the card."""
    import types

    from stroke_prediction_tpu_torch.models.unet3d import Unet3D
    from stroke_prediction_tpu_torch.train.optim import make_optimizer
    from stroke_prediction_tpu_torch.train.unet_learner import (
        UnetSegmentationLearner)

    model = Unet3D(CHANNELS, compute_dtype=dtype)
    model.load_state_dict(inputs["state"])
    model.to("cuda", torch.promote_types(dtype, torch.float32))
    return UnetSegmentationLearner(
        types.SimpleNamespace(batch_size=TRAIN_BATCH), None, model,
        make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                       weight_decay=1e-5), None, 1,
        patch_whd=PATCH_DHW[::-1], pad_xyz=(20, 20, 20),
        path_outputs_base=base, distances_on_training=distances,
        device=torch.device("cuda", torch.cuda.current_device()),
        mesh=mesh)


def dp_patches(torch, inputs, sharding, dtype):
    wide = torch.promote_types(dtype, torch.float32)
    return (sharding.take(inputs["images"]).contiguous().to("cuda"),
            sharding.take(inputs["labels"]).contiguous().to("cuda", wide))


def dp_step(torch, inputs, side, mesh=None, distances=True, base=None):
    """One U-Net training step of ``side`` (a DP_SIDES entry: float64 with
    the plain versions of K1-K4, float32 or bfloat16 with the kernels; the
    control with BN's moments left per rank) at ``inputs``' weights: on
    this rank's rows of the global batch where ``mesh`` is given, else on
    the whole batch -> ({loss, grads, stats, metrics, launches}, learner)."""
    from stroke_prediction_tpu_torch.models import layers
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    dtype = getattr(torch, side.split(",")[0])
    learner = dp_learner(torch, inputs, dtype, mesh, distances,
                         base or os.path.join(tempfile.gettempdir(), "dp"))
    sharding = row_sharding(mesh, len(inputs["images"]))
    imgs, labs = dp_patches(torch, inputs, sharding, dtype)
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    reduce_sums = layers.reduce_sums
    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        if "per-rank" in side:
            layers.reduce_sums = lambda *xs: xs
        reset_launches()
        with sharding.active():
            metrics = learner.train_patches(imgs, labs)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        for n in names:
            setattr(cm, n, real[n])
        layers.reduce_sums = reduce_sums
    model = learner._model
    return dict(loss=float(metrics["loss"]),
                grads={k: p.grad.cpu().double()
                       for k, p in model.named_parameters()},
                stats={k: b.cpu().double() for k, b in model.named_buffers()},
                metrics={k: float(v) for k, v in metrics.items()},
                launches=launches), learner


def rank_step_times(torch, step, n=DP_TIMED_STEPS):
    """``n`` calls of ``step`` (one training step of this rank) back to
    back after a warm-up call, host clock between synchronizes; then as
    many again with a synchronize around each all_reduce, whose time is the
    collectives', and around each transfer of the row exchanges
    (``collectives._transport``, under H sharding) -> ms per step,
    instrumented ms per step, collective ms per step, all_reduce calls per
    step, exchange ms and transfers per step."""
    import torch.distributed as dist

    from stroke_prediction_tpu_torch.parallel import collectives

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    steps(1)
    step_ms = steps(n)
    real, spent = dist.all_reduce, [0.0, 0]

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = real(t, *a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return work

    transport, moved = collectives._transport, [0.0, 0]

    def timed_transport(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = transport(*a)
        torch.cuda.synchronize()
        moved[0] += time.perf_counter() - t0
        moved[1] += 1
        return got

    dist.all_reduce, collectives._transport = timed, timed_transport
    try:
        inst_ms = steps(n)
    finally:
        dist.all_reduce = real
        collectives._transport = transport
    return dict(step_ms=step_ms, instrumented_ms=inst_ms,
                collective_ms=1e3 * spent[0] / n, calls=spent[1] / n,
                exchange_ms=1e3 * moved[0] / n, exchange_calls=moved[1] / n)


def dp_time(torch, inputs, mesh):
    """:func:`rank_step_times` of this rank's bfloat16 U-Net step (the
    CLI's training step: no distances)."""
    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    learner = dp_learner(torch, inputs, torch.bfloat16, mesh, False,
                         os.path.join(tempfile.gettempdir(), "dp_time"))
    sharding = row_sharding(mesh, len(inputs["images"]))
    imgs, labs = dp_patches(torch, inputs, sharding, torch.bfloat16)

    def step():
        with sharding.active():
            learner.train_patches(imgs, labs)

    return rank_step_times(torch, step)


def dp_rank(rank, coordinator, inputs_path, outdir):
    """One rank of (b), on cuda:0 over gloo: each DP_SIDES step on its rows,
    the bfloat16 step timed, the lead-only writes of its learner into its
    own directory -> outdir/rank<rank>.pt."""
    import torch

    from stroke_prediction_tpu_torch.parallel import distributed
    from stroke_prediction_tpu_torch.parallel.mesh import make_data_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(coordinator, DP_WORLD, rank, backend="gloo",
                           device="cuda")
    mesh = make_data_mesh()
    inputs = torch.load(inputs_path)
    base = os.path.join(outdir, f"files{rank}", "unet")
    os.makedirs(os.path.dirname(base))
    out, learners = {}, {}
    for side in DP_SIDES:
        out[side], learners[side] = dp_step(torch, inputs, side, mesh,
                                            base=base)
    learners["bfloat16"].save_model()
    learners["bfloat16"].save_training()
    out["timing"] = dp_time(torch, inputs, mesh)
    out["device"] = str(torch.cuda.current_device())
    distributed.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def run_ranks(torch, rank_fn, inputs_path, outdir, what, world=DP_WORLD):
    """``rank_fn(rank, coordinator, inputs_path, outdir)`` in ``world``
    spawned processes on the one card, within DP_RANK_TIMEOUT (killed
    after it) -> each rank's ``outdir/rank<r>.pt``."""
    from stroke_prediction_tpu_torch.cli.common import free_port

    os.makedirs(outdir)
    torch.cuda.empty_cache()      # the ranks' cuDNN workspaces share the card
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        rank_fn, args=(f"127.0.0.1:{free_port()}", inputs_path, outdir),
        nprocs=world, join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > DP_RANK_TIMEOUT:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"{what}: the ranks did not end in "
                                 f"{DP_RANK_TIMEOUT} s")
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
             for r in range(world)]
    print(f"\n{what}: {world} ranks on {[r['device'] for r in ranks]} "
          f"over gloo in {time.perf_counter() - t0:.1f} s")
    return ranks


def dp_distance(got, ref, layer_of=unet_layer_of):
    """A step's results against a reference step's: loss relative; the
    largest gradient error over its layer's largest reference gradient,
    and |err| / |grad| over a layer (``layer_of`` a parameter's layer);
    running statistics over their buffer's largest; the measures relative
    (ASSD apart)."""
    scale, elem, d2, r2 = {}, {}, {}, {}
    if got["grads"].keys() != ref["grads"].keys():
        raise AssertionError(f"gradients of {sorted(got['grads'])} against "
                             f"{sorted(ref['grads'])}")
    for k, g in ref["grads"].items():
        lay = layer_of(k)
        scale[lay] = max(scale.get(lay, 0.0), float(g.abs().max()))
    for k, g in ref["grads"].items():
        lay, diff = layer_of(k), got["grads"][k] - g
        elem[lay] = max(elem.get(lay, 0.0),
                        float(diff.abs().max()) / scale[lay])
        d2[lay] = d2.get(lay, 0.0) + float((diff ** 2).sum())
        r2[lay] = r2.get(lay, 0.0) + float((g ** 2).sum())
    worst = max(elem, key=elem.get)
    metric = {}
    for k, w in got["metrics"].items():
        v = ref["metrics"][k]
        metric[k] = (abs(w - v) / max(abs(v), 1e-30) if math.isfinite(v)
                     else (0.0 if w == v else math.inf))
    return dict(
        loss=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        element=elem[worst], element_at=worst,
        layer=max((d2[lay] / r2[lay]) ** 0.5 for lay in d2),
        stats=max(float((got["stats"][k] - b).abs().max())
                  / max(float(b.abs().max()), 1e-30)
                  for k, b in ref["stats"].items()),
        metrics=max(v for k, v in metric.items() if not k.endswith("assd")),
        assd=max((v for k, v in metric.items() if k.endswith("assd")),
                 default=0.0))


def dp_ranks(torch, work, learner):
    """(b): two ranks on the one card over gloo through the library API,
    each one full-width step on 3 of a global batch of 6 (the first six
    training cases, seeded crops and weights), against the one-process
    steps on the whole batch: float64 at DP_F64_REL, float32 and bfloat16
    within DP_FACTOR times their one-process distance to float64 plus
    DP_FLOOR, the per-rank BN control failing DP_F64_REL; launches per
    rank; the ranks' gradients equal; rank 1 wrote nothing; ms per step and
    the collectives' share.  Then the kernels at the ranks' batch-3 shapes:
    every call of one bfloat16 and one float32 step against plain, and
    per layer beside cuDNN."""
    from stroke_prediction_tpu_torch.data.augment import (
        crop_patch, random_offsets)
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D

    data, _ = learner.device_data(learner._dataloader_training)
    images = data[KEY_IMAGES][:TRAIN_BATCH].cpu()
    labels = data[KEY_LABELS][:TRAIN_BATCH].cpu()
    offsets = random_offsets(torch.Generator().manual_seed(2), TRAIN_BATCH,
                             tuple(images.shape[1:4]), PATCH_DHW[::-1])
    imgs, labs = crop_patch(images, labels, offsets, PATCH_DHW[::-1],
                            (20, 20, 20))
    model = Unet3D(CHANNELS, generator=torch.Generator().manual_seed(3))
    inputs = {"state": model.state_dict(), "images": imgs, "labels": labs}
    path = os.path.join(work, "dp_inputs.pt")
    torch.save(inputs, path)
    one = {side: dp_step(torch, inputs, side)[0] for side in DP_SIDES[:3]}

    outdir = os.path.join(work, "dp_ranks")
    ranks = run_ranks(torch, dp_rank, path, outdir, "dp")

    per = dp_launches()
    want = {"conv3x3": per["K1"], "conv3x3_bwd_fused": per["K2"],
            "conv3x3_bwd_dx": per["K3"], "conv3x3_bwd_dw": per["K4"],
            "edt_sites": EDT_PER_STEP, "edt_parabola": 0}
    one_f64 = {side: dp_distance(one[side], one["float64"])
               for side in DP_SIDES[1:3]}
    res = {"one_process_vs_f64": one_f64, "ranks": []}
    for r, got in enumerate(ranks):
        d = {side: dp_distance(got[side], one["float64"])
             for side in DP_SIDES}
        for side in DP_SIDES:
            print(f"dp: rank {r} {side} vs the one-process float64 step: "
                  f"{d[side]}; launches {got[side]['launches']}")
        f64 = d["float64"]
        if max(f64["loss"], f64["element"], f64["layer"], f64["stats"],
               f64["metrics"]) > DP_F64_REL or f64["assd"] > DP_ASSD_REL:
            raise AssertionError(f"dp: rank {r}'s float64 step is off the "
                                 f"one-process step: {f64}")
        if d["float64, per-rank BN"]["element"] <= DP_F64_REL:
            raise AssertionError(f"dp: rank {r}: the per-rank BN control "
                                 f"passes: {d['float64, per-rank BN']}")
        for side in DP_SIDES[1:3]:
            limit = {m: DP_FACTOR * one_f64[side][m] + DP_FLOOR
                     for m in ("loss", "element", "layer", "stats")}
            over = {m: d[side][m] for m in limit if d[side][m] > limit[m]}
            print(f"dp: rank {r} {side}: limits {limit}")
            if over:
                raise AssertionError(f"dp: rank {r} {side} beyond "
                                     f"{limit}: {over}")
            if got[side]["launches"] != want:
                raise AssertionError(f"dp: rank {r} {side} launches "
                                     f"{got[side]['launches']}, expected "
                                     f"{want}")
        res["ranks"].append(dict(
            vs_f64={s: {m: d[s][m] for m in ("loss", "element", "layer",
                                              "stats", "metrics", "assd")}
                    for s in DP_SIDES},
            launches_per_step=ranks[r]["bfloat16"]["launches"],
            timing=got["timing"]))
        print(f"dp: rank {r} bfloat16 step (batch {TRAIN_BATCH // DP_WORLD} "
              f"a rank, both ranks on the one card): {got['timing']}")
    for side in DP_SIDES:
        a, b = ranks[0][side], ranks[1][side]
        if a["loss"] != b["loss"] or any(
                not torch.equal(a["grads"][k], b["grads"][k])
                for k in a["grads"]):
            raise AssertionError(f"dp: {side}: the ranks' losses or "
                                 f"gradients differ")
    lead = sorted(os.listdir(os.path.join(outdir, "files0")))
    other = os.listdir(os.path.join(outdir, "files1"))
    print(f"dp: rank 0 wrote {lead}, rank 1 {other}")
    if other or not {"unet_unet.model", "unet_unet.optim",
                     "unet_unet.json"} <= set(lead):
        raise AssertionError("dp: the lead alone must write")

    half = dict(inputs, images=imgs[:TRAIN_BATCH // DP_WORLD],
                labels=labs[:TRAIN_BATCH // DP_WORLD])
    recorded, times = {}, {}
    for side in DP_SIDES[1:3]:
        calls, sites, worst = cae_recorded(
            torch, lambda: dp_step(torch, half, side, distances=False),
            grad=True)
        cae_check_recorded(f"one {side} step at a rank's batch "
                           f"{TRAIN_BATCH // DP_WORLD}", calls, sites, worst,
                           per, {}, "dp")
        recorded[side] = worst
        times[side] = cae_step_kernel_times(torch, calls, per, "dp")
    res.update(recorded=recorded, times=times, one=one, inputs=path)
    return res


def dp_phase(torch, work):
    """Data-parallel U-Net training: (a) :func:`dp_cli`, (b)
    :func:`dp_ranks`."""
    cli, learner = dp_cli(torch, work)
    return dict(cli=cli, **dp_ranks(torch, work, learner))


# The H axis sharded over the ranks (the ``space`` mesh axis) on the
# reference U-Net: four ranks on cuda:0 over gloo (NCCL refuses ranks that
# share a card), each on its rows and its block of H of the data-parallel
# phase's global batch of 6 (patch 68x104x104, H 104): (a) a float32 and
# (b) a bfloat16 training step at {data: 2, space: 2} under the
# data-parallel rule, with a float64 step and two float64 controls; (c) the
# eval forward at {data: 1, space: 4}; (d) every K1-K4 call of a rank's
# float32 and bfloat16 step against plain; (e) ms per rank-step and its
# exchanges.
SPATIAL_MESH = (2, 2)
SPATIAL_FORWARD_MESH = (1, 4)
SPATIAL_WORLD = 4
SPATIAL_SIDES = ("float64", "float32", "bfloat16", "float64, no adjoint",
                 "float64, BN count per rank")
SPATIAL_FORWARD_REL = 1e-5      # (c): of the one-process output's largest


def spatial_step(torch, inputs, side, mesh, record=False):
    """One U-Net training step of ``side`` (a SPATIAL_SIDES entry) on this
    rank's rows and block of H of ``inputs``' global batch: float64 with the
    plain versions of K1-K4, float32 and bfloat16 with the kernels; the
    controls drop the row exchanges' adjoint (no gradient sent back to a
    row's owner) or count BN's positions as this rank's times the world.
    ``record``: under :func:`cae_recorded` (every K1-K4 call against
    plain) -> ({loss, grads, stats, metrics, launches, exchanges}, the
    recorded (calls, worst) or None)."""
    import dataclasses

    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.parallel import collectives, spatial
    from stroke_prediction_tpu_torch.parallel.mesh import (
        batch_sharding, shard_batch)

    dtype = getattr(torch, side.split(",")[0])
    learner = dp_learner(torch, inputs, dtype, mesh, False,
                         os.path.join(tempfile.gettempdir(), "spatial"))
    sharding = batch_sharding(mesh, spatial=True)
    local = shard_batch(mesh, {"images": inputs["images"],
                               "labels": inputs["labels"]}, spatial=True)
    imgs = local["images"].contiguous().to("cuda")
    labs = local["labels"].contiguous().to(
        "cuda", torch.promote_types(dtype, torch.float32))
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    scatter, count = collectives._scatter_add, spatial.global_count
    got = {}

    def run():
        with sharding.active():
            got["metrics"] = learner.train_patches(imgs, labs)

    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        if "no adjoint" in side:
            collectives._scatter_add = lambda g, plan, shape: scatter(
                g, dataclasses.replace(plan, send=(), recv=()), shape)
        if "BN count" in side:
            spatial.global_count = (
                lambda x: x.numel() // x.shape[-1] * mesh.world)
        reset_launches()
        collectives.reset_exchange_counts()
        recorded = None
        if record:
            calls, _, worst = cae_recorded(torch, run, grad=True)
            recorded = (calls, worst)
        else:
            run()
        torch.cuda.synchronize()
        launches = read_launches()
        exchanges = dict(collectives.EXCHANGE_COUNTS)
    finally:
        for n in names:
            setattr(cm, n, real[n])
        collectives._scatter_add, spatial.global_count = scatter, count
    model = learner._model
    return dict(loss=float(got["metrics"]["loss"]),
                grads={k: p.grad.cpu().double()
                       for k, p in model.named_parameters()},
                stats={k: b.cpu().double() for k, b in model.named_buffers()},
                metrics={k: float(v) for k, v in got["metrics"].items()
                         if not k.endswith(("_hd", "_assd"))},
                launches=launches, exchanges=exchanges), recorded


def spatial_forward(torch, inputs, mesh=None):
    """The float32 eval forward of ``inputs``' images: this rank's block of
    H under a spatial ``mesh``, the whole batch without one -> (output on
    the host, launches)."""
    from stroke_prediction_tpu_torch.models.unet3d import Unet3D
    from stroke_prediction_tpu_torch.parallel.mesh import (
        batch_sharding, shard_batch)

    model = Unet3D(CHANNELS)
    model.load_state_dict(inputs["state"])
    model.to("cuda").eval()
    images = shard_batch(mesh, {"images": inputs["images"]},
                         spatial=True)["images"].contiguous().to("cuda")
    reset_launches()
    with batch_sharding(mesh, spatial=True).active(), torch.no_grad():
        y = model(images)
    torch.cuda.synchronize()
    return y.cpu(), read_launches()


def spatial_rank(rank, coordinator, inputs_path, outdir):
    """One rank of the spatial phase, on cuda:0 over gloo: each
    SPATIAL_SIDES step at SPATIAL_MESH (the float32 and a second bfloat16
    step recorded), the bfloat16 rank-step timed with its exchanges and
    all_reduce calls, then the eval forward at SPATIAL_FORWARD_MESH ->
    outdir/rank<rank>.pt."""
    import torch

    from stroke_prediction_tpu_torch.parallel import distributed
    from stroke_prediction_tpu_torch.parallel.mesh import (
        batch_sharding, make_mesh, shard_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(coordinator, SPATIAL_WORLD, rank, backend="gloo",
                           device="cuda")
    mesh = make_mesh(*SPATIAL_MESH)
    inputs = torch.load(inputs_path)
    out, recorded = {}, {}
    for side in SPATIAL_SIDES:
        out[side], rec = spatial_step(torch, inputs, side, mesh,
                                      record=side == "float32")
        if rec:
            recorded["float32"] = rec
    recorded["bfloat16"] = spatial_step(torch, inputs, "bfloat16", mesh,
                                        record=True)[1]
    out["recorded"] = recorded

    learner = dp_learner(torch, inputs, torch.bfloat16, mesh, False,
                         os.path.join(tempfile.gettempdir(), "spatial_time"))
    sharding = batch_sharding(mesh, spatial=True)
    local = shard_batch(mesh, {"images": inputs["images"],
                               "labels": inputs["labels"]}, spatial=True)
    imgs = local["images"].contiguous().to("cuda")
    labs = local["labels"].contiguous().to("cuda", torch.float32)

    def step():
        with sharding.active():
            learner.train_patches(imgs, labs)

    out["timing"] = rank_step_times(torch, step)
    out["forward"] = spatial_forward(torch, inputs,
                                     make_mesh(*SPATIAL_FORWARD_MESH))
    out["device"] = str(torch.cuda.current_device())
    distributed.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def spatial_phase(torch, work, dp):
    """(a)-(e) on the data-parallel phase's inputs, against its one-process
    card steps on the whole batch (float64 with the plain versions,
    float32, bfloat16)."""
    one, path = dp["one"], dp["inputs"]
    inputs = torch.load(path)
    height = inputs["images"].shape[2]
    ranks = run_ranks(torch, spatial_rank, path,
                      os.path.join(work, "spatial_ranks"), "spatial",
                      world=SPATIAL_WORLD)
    per = dp_launches()
    want = {"conv3x3": per["K1"], "conv3x3_bwd_fused": per["K2"],
            "conv3x3_bwd_dx": per["K3"], "conv3x3_bwd_dw": per["K4"],
            "edt_sites": 0, "edt_parabola": 0}
    one_f64 = {side: dp_distance(one[side], one["float64"])
               for side in ("float32", "bfloat16")}
    res = {"ranks": []}
    for r, got in enumerate(ranks):
        d = {side: dp_distance(got[side], one["float64"])
             for side in SPATIAL_SIDES}
        for side in SPATIAL_SIDES:
            print(f"spatial: rank {r} {side} vs the one-process float64 "
                  f"step: {d[side]}; launches {got[side]['launches']}")
        f64 = d["float64"]
        if max(f64["loss"], f64["element"], f64["layer"], f64["stats"],
               f64["metrics"]) > DP_F64_REL:
            raise AssertionError(f"spatial: rank {r}'s float64 step is off "
                                 f"the one-process step: {f64}")
        for side in SPATIAL_SIDES[3:]:
            if d[side]["element"] <= DP_F64_REL:
                raise AssertionError(f"spatial: rank {r}: the control "
                                     f"'{side}' passes: {d[side]}")
        for side in ("float32", "bfloat16"):
            limit = {m: DP_FACTOR * one_f64[side][m] + DP_FLOOR
                     for m in ("loss", "element", "layer", "stats")}
            over = {m: d[side][m] for m in limit if d[side][m] > limit[m]}
            print(f"spatial: rank {r} {side}: limits {limit}")
            if over:
                raise AssertionError(f"spatial: rank {r} {side} beyond "
                                     f"{limit}: {over}")
        if got["bfloat16"]["launches"] != want:
            raise AssertionError(f"spatial: rank {r} bfloat16 launches "
                                 f"{got['bfloat16']['launches']}, expected "
                                 f"{want}")
        for dname, (calls, worst) in got["recorded"].items():
            cae_check_recorded(f"rank {r}'s {dname} step", calls, {}, worst,
                               per, {}, "spatial")
        ex, t = got["bfloat16"]["exchanges"], got["timing"]
        print(f"spatial: rank {r} bfloat16 rank-step (rows "
              f"{TRAIN_BATCH // SPATIAL_MESH[0]} a rank, H {height} over "
              f"{SPATIAL_MESH[1]}, {SPATIAL_WORLD} ranks on the one card): "
              f"{t['step_ms']:.3f} ms; instrumented {t['instrumented_ms']:.3f}"
              f" ms, of it exchange_rows {t['exchange_ms']:.3f} ms "
              f"({t['exchange_calls']:.0f} transfers) and all_reduce "
              f"{t['collective_ms']:.3f} ms ({t['calls']:.0f} calls); "
              f"{ex['exchanges']} exchanges + {ex['adjoints']} adjoints a "
              f"step, {ex['bytes']} bytes received against "
              f"{ex['all_gather_bytes']} for an all-gather of the same "
              f"tensors; K1-K4 launches {got['bfloat16']['launches']}")
        res["ranks"].append(dict(
            vs_f64={s: {m: d[s][m] for m in ("loss", "element", "layer",
                                              "stats", "metrics")}
                    for s in SPATIAL_SIDES},
            launches_per_step=got["bfloat16"]["launches"], exchanges=ex,
            timing=t, recorded={k: v[1] for k, v in
                                got["recorded"].items()}))
    for side in SPATIAL_SIDES:
        a = ranks[0][side]
        for b in ranks[1:]:
            if a["loss"] != b[side]["loss"] or any(
                    not torch.equal(a["grads"][k], b[side]["grads"][k])
                    for k in a["grads"]):
                raise AssertionError(f"spatial: {side}: the ranks' losses or "
                                     f"gradients differ")

    ref, ref_launches = spatial_forward(torch, inputs)
    got = torch.cat([rk["forward"][0] for rk in ranks], dim=2)
    err = rel_err(got, ref)
    res["forward"] = dict(rel_err=err, bit_equal=bool(torch.equal(got, ref)),
                          launches=[rk["forward"][1]["conv3x3"]
                                    for rk in ranks])
    print(f"spatial: eval forward at {SPATIAL_FORWARD_MESH} (H {height}, "
          f"output H {ref.shape[2]}) vs one process: "
          f"{err:.3e} of max|ref| (limit {SPATIAL_FORWARD_REL}), bit-equal "
          f"{res['forward']['bit_equal']}; K1 launches a rank "
          f"{res['forward']['launches']} (one process "
          f"{ref_launches['conv3x3']})")
    if got.shape != ref.shape or err > SPATIAL_FORWARD_REL:
        raise AssertionError(f"spatial: the forward at {SPATIAL_FORWARD_MESH}"
                             f" is {err:.3e} of max|ref| off one process")
    res["times"] = {dname: cae_step_kernel_times(
        torch, ranks[0]["recorded"][dname][0], per,
        f"spatial ({dname})") for dname in ("bfloat16", "float32")}
    return res


# Data-parallel training of the four CAE learners on the one card.  (a) the
# phase-1 and phase-2 CLIs at the reference width with --distributed
# --nprocs 1 --procid 0 over NCCL (the host path) for one epoch each beside
# three plain runs of the same seed; (b) two ranks on cuda:0 over gloo, each
# one full-width step of each learner (phase 1, CTP, step learning, phase 2)
# on 2 rows of a global batch of 4.
CAE_DP_LEARNERS = ("phase1", "ctp", "step", "prediction")
CAE_DP_BATCH = 4
CAE_DP_EPOCHS = 1
# the loss's curriculum factor in (b): phase 1 with the latent L1 term on;
# the CTP CAE without it, as its card-vs-CPU step (CTP_VS_CPU_FACTOR)
CAE_DP_FACTOR = {"phase1": CAE_VS_CPU_FACTOR, "ctp": CTP_VS_CPU_FACTOR,
                 "step": 0.0, "prediction": 0.0}
# the augmentation each learner draws, by the data it deforms
CAE_DP_AUGMENT = {"phase1": "random_cae_augment",
                  "ctp": "random_cae_augment_ctp",
                  "prediction": "random_cae_augment_images"}


def cae_dp_cli_want(kind, steps):
    """K1-K5 launches of a CLI run of the phase-1 or phase-2 learner by the
    route rule, from its steps."""
    if kind == "phase1":
        step_k = cae_step_launches()
        valid_k = {"K1": step_k["K1"]}
    else:
        per_step, per_valid = learner_launches(kind)
        step_k, valid_k = by_kernel(per_step), by_kernel(per_valid)
    return {"conv3x3": step_k["K1"] * steps["train"]
            + valid_k["K1"] * (steps["eval"] + steps["visual"]),
            "conv3x3_bwd_fused": step_k.get("K2", 0) * steps["train"],
            "conv3x3_bwd_dx": step_k.get("K3", 0) * steps["train"],
            "conv3x3_bwd_dw": step_k.get("K4", 0) * steps["train"],
            "edt_sites": CAE_EDT_PER_CASE * steps["eval"], "edt_parabola": 0}


def curve_gap(x, y):
    """The largest relative gap between two learners' curves."""
    gap = 0.0
    for phase in ("training", "validate"):
        for a, b in zip(x._metric_dtos[phase], y._metric_dtos[phase]):
            for k, v in b.items():
                if math.isfinite(v) or a[k] != v:
                    gap = max(gap, abs(a[k] - v) / max(abs(v), 1e-30)
                              if math.isfinite(v) else math.inf)
    return gap


def cae_dp_cli(torch, work):
    """(a): the phase-1 and phase-2 CLIs over NCCL as rank 0 of 1, each
    beside one plain run: K1-K5 launches of its run by the route rule, its
    curves within DP_CURVE_REL of the plain run's, its files -> (results,
    {kind: the --distributed run's learner}).  Phase 2 runs a second plain
    run, which must equal the first bit for bit (curves and written
    encoder): its frozen float32 CAE's cuDNN convs take the deterministic
    algorithms."""
    from stroke_prediction_tpu_torch.cli import train_shape_prediction
    from stroke_prediction_tpu_torch.cli import train_shape_reconstruction
    from stroke_prediction_tpu_torch.cli.common import free_port
    from stroke_prediction_tpu_torch.utils.args import (
        get_args_shape_prediction_training, get_args_shape_training)

    cae1 = os.path.join(work, "shape_train_cae1.model")
    common = ["--synthetic", "--fold", *map(str, TRAIN_FOLD),
              "--validsetsize", "0.25", "--batchsize", str(CAE_TRAIN_BATCH),
              "--epochs", str(CAE_DP_EPOCHS)]
    runs = {"phase1": (train_shape_reconstruction, get_args_shape_training,
                       [], ["_cae1.model", "_cae1.optim", "_cae1.json",
                            "_cae1_final.model"]),
            "prediction": (train_shape_prediction,
                           get_args_shape_prediction_training,
                           [cae1, "--initbycae"],
                           ["_cae2.model", "_cae2_enc.model", "_cae2.optim",
                            "_cae2.json", "_cae2_final.model",
                            "_cae2_enc_final.model"])}
    res, learners = {}, {}
    for kind, (cli, parse, extra, files) in runs.items():
        what = f"cae dp {kind}"

        def run(name, flags):
            base = os.path.join(work, f"cae_dp_{kind}_{name}")
            args = parse([*extra, *common, "--outbasepath", base, *flags])
            if args.dtype != "bfloat16" or args.device != "cuda":
                raise AssertionError(f"{what}: {args.dtype}, {args.device}")
            reset_launches()
            t0 = time.perf_counter()
            learner = cli.train(args)
            torch.cuda.synchronize()
            return (learner, read_launches(), time.perf_counter() - t0,
                    base)

        plain = run("plain_a", [])
        dist = run("distributed", ["--distributed", "--coordinator",
                                   f"127.0.0.1:{free_port()}", "--nprocs",
                                   "1", "--procid", "0"])
        learner, launches, wall, base = dist
        if not (learner._mesh is not None and learner._mesh.world == 1
                and learner._dataloader_training.process_shard):
            raise AssertionError(f"{what}: the --distributed run did not "
                                 f"take the mesh and the process-sharded "
                                 f"loader")
        steps = dict(learner.step_counts)
        want = cae_dp_cli_want(kind, steps)
        print(f"\n{what}: CLI --distributed (NCCL, rank 0 of 1), "
              f"{CAE_DP_EPOCHS} epoch in {wall:.2f} s (plain "
              f"{plain[2]:.2f} s); steps {steps}; launches {launches}, "
              f"expected {want}")
        if steps["train"] < 1 or steps["eval"] < 1:
            raise AssertionError(f"{what}: steps {steps}")
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{what}: {name} launched "
                                     f"{launches[name]} times, expected {n}")
        spread = 0.0
        if kind == "prediction":
            again = run("plain_b", [])
            spread = curve_gap(again[0], plain[0])
            same = [name for name in files if name.endswith(".model") and
                    not filecmp.cmp(plain[3] + name, again[3] + name,
                                    shallow=False)]
            print(f"{what}: two plain runs from one seed: curves "
                  f"{spread:.3e} apart; .model files that differ: {same}")
            if spread or same:
                raise AssertionError(f"{what}: two plain runs from one seed "
                                     f"differ")
        gap = curve_gap(learner, plain[0])
        print(f"{what}: --distributed curves vs the plain run: largest "
              f"relative gap {gap:.3e} (limit {DP_CURVE_REL:.0e}); losses "
              f"{[m['loss'] for m in learner._metric_dtos['training']]} / "
              f"{[m['loss'] for m in plain[0]._metric_dtos['training']]}")
        if gap > DP_CURVE_REL:
            raise AssertionError(f"{what}: the --distributed run's curves "
                                 f"leave the plain run's")
        check_artifacts(base, files, [], what)
        res[kind] = dict(launches=launches, steps=steps, wall_s=wall,
                         curve_gap=gap, curve_spread=spread)
        learners[kind] = learner
    return res, learners


def cae_dp_inputs(torch, learners):
    """(b)'s global batches of CAE_DP_BATCH (the first training cases of
    the (a) runs: phase 1's masks and clinical vectors; its CBV and TTD
    zero-padded by CTP_PAD for the CTP CAE; phase 2's U-Net segmentations)
    and seeded weights (phase 2's frozen CAE: the CAE training phase's
    best-valid model) on the host."""
    import torch.nn.functional as F

    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.models.cae3d import (
        Cae3D, Cae3DCtp, Dec3D, Enc3D, Enc3DCtp, Enc3DStep)

    def rows(learner):
        data, _ = learner.device_data(learner._dataloader_training)
        return {k: v[:CAE_DP_BATCH].cpu() for k, v in data.items()}

    d1, d2 = rows(learners["phase1"]), rows(learners["prediction"])
    masks = {KEY_IMAGES: None, KEY_LABELS: d1[KEY_LABELS],
             KEY_GLOBAL: d1[KEY_GLOBAL]}
    pad = [p for d in reversed(CTP_PAD) for p in (d, d)]
    ctp = dict(masks, **{KEY_IMAGES: F.pad(d1[KEY_IMAGES], [0, 0] + pad)})
    gen = torch.Generator().manual_seed(6)
    states = {
        "phase1": Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                        Dec3D(CAE_CHANNELS, generator=gen)),
        "ctp": Cae3DCtp(Enc3DCtp(CTP_CHANNELS, padding=CTP_PAD,
                                 generator=gen),
                        Dec3D(CTP_CHANNELS, generator=gen)),
        "step": Cae3D(Enc3DStep(CAE_CHANNELS, generator=gen),
                      Dec3D(CAE_CHANNELS, generator=gen)),
        "prediction": Enc3D(CAE_CHANNELS, generator=gen)}
    states = {k: m.state_dict() for k, m in states.items()}
    states["cae"] = {k: v.cpu() for k, v in
                     learners["prediction"]._cae.state_dict().items()}
    return dict(states=states, data={"phase1": masks, "step": masks,
                                     "ctp": ctp, "prediction": d2})


def cae_dp_learner(torch, inputs, kind, dtype, mesh, base, distances=True):
    """``kind``'s learner at ``inputs``' weights in ``dtype`` on the card
    (phase 2: a float32 frozen CAE, float64 with a float64 encoder), Adam
    over what its CLI trains."""
    import types

    from stroke_prediction_tpu_torch.models.cae3d import (
        Cae3D, Cae3DCtp, Dec3D, Enc3D, Enc3DCtp, Enc3DStep)
    from stroke_prediction_tpu_torch.train import cae_learners
    from stroke_prediction_tpu_torch.train.optim import (
        make_optimizer, trainable_by_path)

    wide = torch.promote_types(dtype, torch.float32)
    dev = torch.device("cuda", torch.cuda.current_device())
    states = inputs["states"]
    loader = types.SimpleNamespace(batch_size=CAE_DP_BATCH, dataset=None,
                                   indices=[])
    kw = dict(device=dev, mesh=mesh, path_outputs_base=base,
              distances_on_training=distances)
    if kind == "prediction":
        cae = Cae3D(Enc3D(CAE_CHANNELS), Dec3D(CAE_CHANNELS))
        cae.load_state_dict(states["cae"])
        cae.to(dev, torch.promote_types(wide, torch.float32))
        if dtype == torch.float64:
            set_cae_dtype(cae, dtype)
        enc = Enc3D(CAE_CHANNELS, compute_dtype=dtype)
        enc.load_state_dict(states["prediction"])
        enc.to(dev, wide)
        return cae_learners.CaePredictionLearner(
            loader, None, cae, enc, make_optimizer(
                enc.parameters(), 1e-3, betas=(0.9, 0.999),
                weight_decay=1e-5), None, 1, **kw)
    if kind == "ctp":
        model = Cae3DCtp(Enc3DCtp(CTP_CHANNELS, padding=CTP_PAD,
                                  compute_dtype=dtype),
                         Dec3D(CTP_CHANNELS, compute_dtype=dtype))
    else:
        model = Cae3D((Enc3DStep if kind == "step" else Enc3D)(
            CAE_CHANNELS, compute_dtype=dtype),
            Dec3D(CAE_CHANNELS, compute_dtype=dtype))
    model.load_state_dict(states[kind])
    model.to(dev, wide)
    params = (trainable_by_path(model, STEP_HEAD) if kind == "step"
              else model.parameters())
    cls = (cae_learners.CaeStepLearner if kind == "step"
           else cae_learners.CaeReconstructionLearner)
    return cls(loader, None, model, make_optimizer(
        params, 1e-3, betas=(0.9, 0.999), weight_decay=1e-5), None, 1,
        inputs_from_images=kind == "ctp", **kw)


def cae_dp_batch(torch, inputs, kind, sharding, dtype):
    """This rank's rows of ``kind``'s global batch on the card."""
    wide = torch.promote_types(dtype, torch.float32)
    return {k: None if v is None else sharding.take(v).contiguous().to(
        "cuda", wide) for k, v in inputs["data"][kind].items()}


def cae_dp_step(torch, inputs, kind, side, mesh=None, base=None,
                record=False):
    """One training step of ``kind`` (augmentation off) in ``side`` (a
    DP_SIDES entry) on this rank's rows of its global batch where ``mesh``
    is given, else on the whole batch; ``record``: every K1-K4 and
    edt_sites call held on its own inputs against plain
    (:func:`cae_recorded`) -> ({loss, grads, stats, metrics, calls by
    kernel, worst}, learner, recorded calls)."""
    from stroke_prediction_tpu_torch.models import layers
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    dtype = getattr(torch, side.split(",")[0])
    learner = cae_dp_learner(torch, inputs, kind, dtype, mesh, base or
                             os.path.join(tempfile.gettempdir(), "cae_dp"))
    learner.augment = lambda batch: batch
    sharding = row_sharding(mesh, CAE_DP_BATCH)
    batch = cae_dp_batch(torch, inputs, kind, sharding, dtype)
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    reduce_sums = layers.reduce_sums
    got = []

    def run():
        with sharding.active():
            got.append(learner.train_step(batch, CAE_DP_FACTOR[kind]))

    calls, sites, worst = {}, {}, {}
    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        if "per-rank" in side:
            layers.reduce_sums = lambda *xs: xs
        if record:
            calls, sites, worst = cae_recorded(torch, run, grad=True)
        else:
            run()
            torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(cm, n, real[n])
        layers.reduce_sums = reduce_sums
    metrics = got[0]
    model = learner._model
    counts = {k: sum(n for key, n in calls.items() if key[0] == k)
              for k in CAE_KERNELS}
    return dict(loss=float(metrics["loss"]),
                grads={k: p.grad.cpu().double()
                       for k, p in model.named_parameters()
                       if p.grad is not None},
                stats={k: b.cpu().double() for k, b in model.named_buffers()},
                metrics={k: float(v) for k, v in metrics.items()},
                calls=counts, sites=sites, worst=worst), learner, calls


def cae_dp_augment(torch, inputs, kind, mesh=None):
    """``kind``'s augmentation of this rank's rows under a sharded step
    (of the whole batch without ``mesh``) from one seed on the card, and
    the generator's next numbers -> host tensors."""
    from stroke_prediction_tpu_torch.data import augment
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_IMAGES, KEY_LABELS)
    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    sharding = row_sharding(mesh, CAE_DP_BATCH)
    batch = cae_dp_batch(torch, inputs, kind, sharding, torch.float32)
    fn = getattr(augment, CAE_DP_AUGMENT[kind])
    args = ((batch[KEY_LABELS],) if kind == "phase1"
            else (batch[KEY_IMAGES], batch[KEY_LABELS]))
    gen = torch.Generator(device="cuda").manual_seed(5)
    with sharding.active():
        out = fn(gen, *args)
    out = out if isinstance(out, tuple) else (out,)
    return ([t.cpu() for t in out]
            + [torch.rand(4, generator=gen, device="cuda").cpu()])


def cae_dp_time(torch, inputs, kind, mesh, n=DP_TIMED_STEPS):
    """:func:`rank_step_times` (``n`` steps) of this rank's bfloat16 step of
    ``kind`` (augmentation on, no distances, as the CLI's step)."""
    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    learner = cae_dp_learner(torch, inputs, kind, torch.bfloat16, mesh,
                             os.path.join(tempfile.gettempdir(), "cae_dp"),
                             distances=False)
    sharding = row_sharding(mesh, CAE_DP_BATCH)
    batch = cae_dp_batch(torch, inputs, kind, sharding, torch.bfloat16)

    def step():
        with sharding.active():
            learner.train_step(batch, CAE_DP_FACTOR[kind])

    return rank_step_times(torch, step, n)


def cae_dp_rank(rank, coordinator, inputs_path, outdir):
    """One rank of (b), on cuda:0 over gloo: each learner's DP_SIDES steps
    on its rows (float32 and bfloat16 recorded against plain), phase 1's
    and phase 2's lead-only writes into this rank's own directory, the
    augmentation of its rows, the bfloat16 step timed ->
    outdir/rank<rank>.pt."""
    import torch

    from stroke_prediction_tpu_torch.parallel import distributed
    from stroke_prediction_tpu_torch.parallel.mesh import make_data_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(coordinator, DP_WORLD, rank, backend="gloo",
                           device="cuda")
    mesh = make_data_mesh()
    inputs = torch.load(inputs_path)
    out = {"steps": {}, "augment": {}, "timing": {}, "calls": {}}
    for kind in CAE_DP_LEARNERS:
        base = os.path.join(outdir, f"files{rank}", kind)
        os.makedirs(os.path.dirname(base), exist_ok=True)
        for side in DP_SIDES:
            record = side in ("float32", "bfloat16")
            torch.cuda.empty_cache()
            got, learner, calls = cae_dp_step(torch, inputs, kind, side,
                                              mesh, base, record)
            out["steps"][(kind, side)] = got
            if record:
                out["calls"][(kind, side)] = calls
            if side == "bfloat16" and kind in ("phase1", "prediction"):
                learner.save_model()
                learner.save_training()
        if kind in CAE_DP_AUGMENT:
            out["augment"][kind] = cae_dp_augment(torch, inputs, kind, mesh)
        out["timing"][kind] = cae_dp_time(torch, inputs, kind, mesh)
    out["device"] = str(torch.cuda.current_device())
    distributed.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def layer_errors(got, ref, layer_of):
    """[(layer, largest gradient error / the layer's largest reference
    gradient, the layer's largest reference gradient)], worst first."""
    scale, err = {}, {}
    for k, g in ref["grads"].items():
        lay = layer_of(k)
        scale[lay] = max(scale.get(lay, 0.0), float(g.abs().max()))
        err[lay] = max(err.get(lay, 0.0),
                       float((got["grads"][k] - g).abs().max()))
    return sorted(((lay, err[lay] / scale[lay], scale[lay]) for lay in err),
                  key=lambda t: -t[1])


def cae_dp_layer_of(key):
    """A parameter's layer; phase 2's encoder keys as the CAE's encoder's."""
    return cae_layer_of(key if key.startswith(("enc.", "dec."))
                        else "enc." + key)


def cae_dp_want(kind):
    """K1-K4 calls of one training step of ``kind`` by the route rule."""
    if kind in ("phase1", "ctp"):
        return cae_step_launches(CTP_CHANNELS if kind == "ctp"
                                 else CAE_CHANNELS)
    return by_kernel(learner_launches(kind)[0])


def cae_dp_ranks(torch, work, learners):
    """(b): two ranks on the one card over gloo through the library API,
    each one full-width step of each learner on 2 of a global batch of 4,
    against the one-process steps on the whole batch: float64 at
    DP_F64_REL, float32 and bfloat16 within DP_FACTOR times their
    one-process distance to float64 (the larger of the steps with the rows
    in their order and in the ranks') plus DP_FLOOR, the per-rank BN
    control failing DP_F64_REL; every K1-K4 call of a rank's float32 and
    bfloat16 steps against plain, counted by the route rule, and edt_sites
    at the rank's masks; the ranks' losses and gradients equal; rank 1 wrote
    nothing; each rank's augmented rows its rows of one process's; ms per
    step and the collectives' share.  Then K1-K4 per layer of a rank's
    phase-1 step in both types beside cuDNN."""
    inputs = cae_dp_inputs(torch, learners)
    path = os.path.join(work, "cae_dp_inputs.pt")
    torch.save(inputs, path)
    one = {(kind, side): cae_dp_step(torch, inputs, kind, side)[0]
           for kind in CAE_DP_LEARNERS for side in DP_SIDES[:3]}
    # the typed steps again with the rows in the ranks' order (rank 0's,
    # then rank 1's): a float32 step's distance to float64 depends on the
    # order of its sums, by a factor of ~4 at the decoder's first
    # transposed conv
    order = [i for r in range(DP_WORLD)
             for i in range(r, CAE_DP_BATCH, DP_WORLD)]
    ranked = dict(inputs, data={
        kind: {k: None if v is None else v[order] for k, v in data.items()}
        for kind, data in inputs["data"].items()})
    one_ranked = {(kind, side): cae_dp_step(torch, ranked, kind, side)[0]
                  for kind in CAE_DP_LEARNERS for side in DP_SIDES[1:3]}
    aug = {kind: cae_dp_augment(torch, inputs, kind)
           for kind in CAE_DP_AUGMENT}
    outdir = os.path.join(work, "cae_dp_ranks")
    ranks = run_ranks(torch, cae_dp_rank, path, outdir, "cae dp")

    sites_want = {(CAE_DP_BATCH // DP_WORLD, *CAE_DHW): CAE_EDT_PER_CASE}
    res = {"one_process_vs_f64": {}, "ranks": [], "calls": {}}
    for kind in CAE_DP_LEARNERS:
        f64 = one[(kind, "float64")]
        by_order = {side: [dp_distance(o[(kind, side)], f64,
                                       cae_dp_layer_of)
                           for o in (one, one_ranked)]
                    for side in DP_SIDES[1:3]}
        for side, (natural, ranks_order) in by_order.items():
            print(f"cae dp: {kind} one process {side} vs float64: rows in "
                  f"their order {natural}; in the ranks' order "
                  f"{ranks_order}")
        one_f64 = {side: {m: max(d[m] for d in ds)
                          for m in ("loss", "element", "layer", "stats")}
                   for side, ds in by_order.items()}
        res["one_process_vs_f64"][kind] = one_f64
        want = cae_dp_want(kind)
        for r, got in enumerate(ranks):
            d = {side: dp_distance(got["steps"][(kind, side)], f64,
                                   cae_dp_layer_of) for side in DP_SIDES}
            for side in DP_SIDES:
                print(f"cae dp: {kind} rank {r} {side} vs the one-process "
                      f"float64 step: {d[side]}")
            dd = d["float64"]
            if max(dd["loss"], dd["element"], dd["layer"], dd["stats"],
                   dd["metrics"]) > DP_F64_REL or dd["assd"] > DP_ASSD_REL:
                raise AssertionError(f"cae dp: {kind} rank {r}'s float64 "
                                     f"step is off the one-process step: "
                                     f"{dd}")
            if d["float64, per-rank BN"]["element"] <= DP_F64_REL:
                raise AssertionError(f"cae dp: {kind} rank {r}: the per-rank"
                                     f" BN control passes")
            for side in DP_SIDES[1:3]:
                limit = {m: DP_FACTOR * one_f64[side][m] + DP_FLOOR
                         for m in ("loss", "element", "layer", "stats")}
                over = {m: d[side][m] for m in limit if d[side][m] > limit[m]}
                step = got["steps"][(kind, side)]
                print(f"cae dp: {kind} rank {r} {side}: limits {limit}; "
                      f"calls {step['calls']} (route rule {want}), "
                      f"edt_sites {step['sites']}; max|err| vs plain "
                      f"{step['worst']}")
                if over:
                    for name, x in (("rank", step),
                                    ("one process", one[(kind, side)]),
                                    ("ranks' order", one_ranked[(kind,
                                                                 side)])):
                        print(f"cae dp: {kind} {side} {name}: worst layers "
                              f"{layer_errors(x, f64, cae_dp_layer_of)[:6]}")
                    raise AssertionError(f"cae dp: {kind} rank {r} {side} "
                                         f"beyond {limit}: {over}")
                if step["calls"] != {k: want.get(k, 0) for k in CAE_KERNELS} \
                        or step["sites"] != sites_want:
                    raise AssertionError(f"cae dp: {kind} rank {r} {side}: "
                                         f"calls {step['calls']}, edt_sites "
                                         f"{step['sites']}")
            print(f"cae dp: {kind} rank {r} bfloat16 step (batch "
                  f"{CAE_DP_BATCH // DP_WORLD} a rank, both ranks on the one "
                  f"card, augmentation on): {got['timing'][kind]}")
        for side in DP_SIDES:
            a, b = (r["steps"][(kind, side)] for r in ranks)
            if (a["loss"] != b["loss"]
                    or a["grads"].keys() != b["grads"].keys()
                    or any(not torch.equal(a["grads"][k], b["grads"][k])
                           for k in a["grads"])):
                raise AssertionError(f"cae dp: {kind} {side}: the ranks' "
                                     f"losses or gradients differ")
        if kind in CAE_DP_AUGMENT:
            for r, got in enumerate(ranks):
                mine = got["augment"][kind]
                ref = [t[r::DP_WORLD] for t in aug[kind][:-1]] + \
                    [aug[kind][-1]]
                if len(mine) != len(ref) or not all(
                        torch.equal(x, y) for x, y in zip(mine, ref)):
                    raise AssertionError(f"cae dp: {kind} rank {r}'s "
                                         f"augmented rows are not its rows "
                                         f"of one process's")
            print(f"cae dp: {kind}: each rank's augmented rows "
                  f"({CAE_DP_AUGMENT[kind]}, one seed) equal its rows of one "
                  f"process's bit for bit, and its generator's next numbers")
    lead = sorted(os.listdir(os.path.join(outdir, "files0")))
    other = os.listdir(os.path.join(outdir, "files1"))
    print(f"cae dp: rank 0 wrote {lead}, rank 1 {other}")
    if other or not {"phase1_cae1.model", "phase1_cae1.optim",
                     "phase1_cae1.json", "prediction_cae2.model",
                     "prediction_cae2_enc.model", "prediction_cae2.optim",
                     "prediction_cae2.json"} <= set(lead):
        raise AssertionError("cae dp: the lead alone must write")
    for r, got in enumerate(ranks):
        res["ranks"].append(dict(
            timing=got["timing"],
            calls={k: s["calls"] for k, s in got["steps"].items()
                   if s["calls"]},
            worst={k: s["worst"] for k, s in got["steps"].items()
                   if s["worst"]}))
    times = {}
    for side in DP_SIDES[1:3]:
        times[side] = cae_step_kernel_times(
            torch, ranks[0]["calls"][("phase1", side)], cae_dp_want("phase1"),
            f"cae dp: phase 1 rank step, {side}")
    res.update(one=one, inputs=path, times=times, recorded={
        side: {k: max(r["steps"][(kind, side)]["worst"][k] for r in ranks
                      for kind in CAE_DP_LEARNERS) for k in CAE_KERNELS}
        for side in DP_SIDES[1:3]})
    return res


def cae_dp_use(res, key):
    """A kernel's use on the CAE data-parallel path (``res``:
    :func:`cae_dp_phase`'s): its launches in the two --distributed CLI runs
    (NCCL, rank 0 of 1), each learner's calls a rank-step in (b), and per
    phase-1 rank-step the layers' sums (both types)."""
    wrapper = {"K1": "conv3x3", "K2": "conv3x3_bwd_fused",
               "K3": "conv3x3_bwd_dx", "K4": "conv3x3_bwd_dw"}[key]
    return {"launches": sum(r["launches"][wrapper]
                            for r in res["cli"].values()),
            "launches_per_rank_step": {
                kind: res["ranks"][0]["calls"][(kind, "bfloat16")][key]
                for kind in CAE_DP_LEARNERS},
            **{side: dict({f: res["times"][side][key][f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "gflop")}, max_abs_err=res["recorded"][side][key])
               for side in ("bfloat16", "float32")},
            "per": f"one phase-1 data-parallel rank-step ({DP_WORLD} ranks "
                   f"on the one card, global batch {CAE_DP_BATCH}, "
                   f"{CAE_DP_BATCH // DP_WORLD} a rank, channels 1 16 24 32 "
                   f"100 200 1, 28x128x128): each layer's time times its "
                   f"calls; max_abs_err: every call of the four learners' "
                   f"rank-steps vs plain; launches: the phase-1 and phase-2 "
                   f"--distributed CLI runs' {CAE_DP_EPOCHS} epoch each"}


def cae_dp_phase(torch, work):
    """Data-parallel CAE training: (a) :func:`cae_dp_cli`, (b)
    :func:`cae_dp_ranks`."""
    cli, learners = cae_dp_cli(torch, work)
    return dict(cli=cli, **cae_dp_ranks(torch, work, learners))


# Structure batching (STROKE_TPU_CAE_BATCH=1, models/cae3d.py): each
# branch's structures stacked on the batch axis as one grouped pass, at the
# reference width on 28x128x128 masks
GROUPED_SWITCH = "STROKE_TPU_CAE_BATCH"
# K1-K4 launches of one grouped phase-1 or CTP training step, counted from
# the code before the first card run: one encode of the three structures
# (K1 at its 7 stride-1 convs; K2 at the entry, whose affined input now
# needs dx, and at 16 -> 16; K3 + K4 at the five wider layers) and one
# decode of the four (K1 at 6; K2 at 24 -> 16 and the two 16 -> 16, K3 +
# K4 at the three wider); 45 / 15 / 27 / 30 with the passes one structure
# each
GROUPED_STEP = {"K1": 13, "K2": 5, "K3": 8, "K4": 8}
# K1 launches of a tester case (one encode, one decode) and of the curve
# case's three sweeps (each an encode of the core and the penumbra and a
# decode of them with the sweep's interpolations), switch off and on
GROUPED_CASE_K1 = {"0": CAE_K1_PER_CASE, "1": 7 + 6}
GROUPED_SWEEPS_K1 = {"0": 3 * CAE_SWEEP_K1, "1": 3 * (7 + 6)}
# all_reduce calls a 2-rank rank-step, counted from the code before the
# first card run: BN one call a layer forward (10 encoder + 12 decoder
# layers: 22) and one a layer backward where its input carries a gradient
# (phase 1 and CTP 21: not the entry's, whose input is data; step learning
# 12: the decoder alone, the head's step reaching it through the
# interpolation; phase 2 9: its encoder's layers but the entry's), beside
# the loss's, the measures' and the gradients' calls, which do not change
# (16 / 16 / 8 / 4); with the switch off one call a layer and structure
GROUPED_ALL_REDUCE = {"on": {"phase1": 59, "ctp": 59, "step": 42,
                             "prediction": 35},
                      "off": {"phase1": 169, "ctp": 169, "step": 98,
                              "prediction": 54}}
GROUPED_TIMED_STEPS = 2      # bfloat16 steps and rank-steps timed a side
# (e): steps a side of phase 1's and phase 2's bfloat16 step with cuDNN's
# deterministic algorithms and with any, interleaved
CUDNN_COST_STEPS = 12
# (b)'s float64 CPU witness (~65 s at CAE_VS_CPU_BATCH on the H100 host's
# CPU in a process of its own) runs in the witnesses' pool from the phase's
# start: seconds to wait for it after the card's steps
GROUPED_WITNESS_TIMEOUT = 600
GROUPED_MEASURES_ATOL = 1e-4  # a tester's measures, switch on vs off


def grouped_step_launches(channels=CAE_CHANNELS):
    """K1-K4 launches of one grouped training step by the route rule: the
    encoder's entry input needs a gradient (the grouped affine applied to
    it), one encode and one decode."""
    from stroke_prediction_tpu_torch.ops.conv3x3 import bwd_route

    encode, decode = cae_conv_layers(channels)
    routes = [bwd_route(ci, co) for ci, co, _ in encode] + [
        bwd_route(*c) for c in decode]
    return {"K1": len(routes), "K2": routes.count("fused"),
            "K3": routes.count("split"),
            "K4": routes.count("split") + routes.count("dw")}


def grouped_inputs(torch):
    """(b)-(e)'s inputs in :func:`cae_dp_inputs`' layout: the global batch
    of CAE_DP_BATCH synthetic cases (masks and clinical vectors; CBV and
    TTD padded by CTP_PAD for the CTP CAE; the U-Net segmentations for phase
    2) and seeded weights, phase 2's frozen CAE the tester phase's
    calibrated :func:`cae_model`."""
    from stroke_prediction_tpu_torch.cli.common import make_dataset
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_IMAGES, KEY_LABELS, LABEL_CORE, LABEL_LESION,
        LABEL_PENU, MOD_CBV, MOD_TTD, MOD_UNET_CORE, MOD_UNET_PENU)
    from stroke_prediction_tpu_torch.models.cae3d import (
        Cae3D, Cae3DCtp, Dec3D, Enc3D, Enc3DCtp, Enc3DStep)
    from stroke_prediction_tpu_torch.utils.args import get_args_shape_training

    args = get_args_shape_training(["--synthetic"])
    labels = [LABEL_CORE, LABEL_PENU, LABEL_LESION]
    rows = list(TRAIN_FOLD[:CAE_DP_BATCH])

    def batch(mods, pad=None):
        b = make_dataset(args, mods, labels, pad=pad).stack(rows)
        return {k: torch.from_numpy(b[k]).float()
                for k in (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL)}

    ctp = batch([MOD_CBV, MOD_TTD], CTP_PAD)
    masks = dict(ctp, **{KEY_IMAGES: None})
    gen = torch.Generator().manual_seed(6)
    states = {
        "phase1": Cae3D(Enc3D(CAE_CHANNELS, generator=gen),
                        Dec3D(CAE_CHANNELS, generator=gen)),
        "ctp": Cae3DCtp(Enc3DCtp(CTP_CHANNELS, padding=CTP_PAD,
                                 generator=gen),
                        Dec3D(CTP_CHANNELS, generator=gen)),
        "step": Cae3D(Enc3DStep(CAE_CHANNELS, generator=gen),
                      Dec3D(CAE_CHANNELS, generator=gen)),
        "prediction": Enc3D(CAE_CHANNELS, generator=gen),
        "cae": cae_model(torch)}
    return dict(states={k: m.state_dict() for k, m in states.items()},
                data={"phase1": masks, "step": masks, "ctp": ctp,
                      "prediction": batch([MOD_UNET_CORE, MOD_UNET_PENU])})


def grouped_kernels(torch, inputs):
    """(a): one phase-1 training step in bfloat16 and in float32 and one CTP
    step in both (batch 4, augmentation off, one process), every K1-K4 call
    on its own inputs against plain (the entry conv's K2 at C_in 1 and 3
    among them), GROUPED_STEP calls a step; one phase-1 bfloat16 step
    unrecorded for the launches the wrappers count; K1-K4 per layer of the
    bfloat16 phase-1 step at batch 4 and at a rank's batch of 2 beside
    cuDNN, and the entry convs' K2 (C_in 1 and 3) in both types."""
    if grouped_step_launches() != GROUPED_STEP or \
            grouped_step_launches(CTP_CHANNELS) != GROUPED_STEP:
        raise AssertionError(f"cae grouped: the route rule gives "
                             f"{grouped_step_launches()} a step, not the "
                             f"predicted {GROUPED_STEP}")
    recorded, worst = {}, {}
    for kind in ("phase1", "ctp"):
        for side in ("bfloat16", "float32"):
            got, _, calls = cae_dp_step(torch, inputs, kind, side,
                                        record=True)
            recorded[(kind, side)] = calls
            print(f"cae grouped: one {kind} {side} step (batch "
                  f"{CAE_DP_BATCH}): K1-K4 calls {got['calls']} on their "
                  f"own inputs against plain, max|err| {got['worst']}")
            if got["calls"] != GROUPED_STEP:
                raise AssertionError(f"cae grouped: {kind} {side}: calls "
                                     f"{got['calls']}, expected "
                                     f"{GROUPED_STEP}")
            for k in CAE_KERNELS:
                worst.setdefault(side, {})[k] = max(
                    worst.get(side, {}).get(k, 0.0), got["worst"][k])
    # the launches the wrappers count, in an unrecorded step
    learner = cae_dp_learner(torch, inputs, "phase1", torch.bfloat16, None,
                             os.path.join(tempfile.gettempdir(), "grouped"),
                             distances=False)
    batch = cae_dp_batch(torch, inputs, "phase1",
                         grouped_sharding(), torch.bfloat16)
    learner.train_step(batch)
    reset_launches()
    learner.train_step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"cae grouped: one phase-1 bfloat16 step unrecorded: launches "
          f"{launches}")
    if [launches[w] for w in ("conv3x3", "conv3x3_bwd_fused",
                              "conv3x3_bwd_dx", "conv3x3_bwd_dw")] != [
            GROUPED_STEP[k] for k in CAE_KERNELS]:
        raise AssertionError(f"cae grouped: launches {launches}")
    times = cae_step_kernel_times(
        torch, recorded[("phase1", "bfloat16")], GROUPED_STEP,
        "cae grouped: phase-1 step, bfloat16")
    # the entry convs (C_in 1 and 3; their input the whole masks), both
    # types
    gen = torch.Generator(device="cuda").manual_seed(7)
    entry = {}
    for side in ("bfloat16", "float32"):
        for kind, c_in in (("phase1", 1), ("ctp", 3)):
            (key,) = [k for k in recorded[(kind, side)] if k[0] == "K1"
                      and k[2:6] == (*CAE_DHW, c_in)]
            entry[(c_in, side)] = cae_layer_times(
                torch, key[1:-1] + ("fused",), getattr(torch, side), gen)
        for c_in in (1, 3):
            t = entry[(c_in, side)]["K2"]
            print(f"cae grouped: the entry conv's K2 at C_in {c_in}, "
                  f"{side}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                  f"cuDNN dgrad + wgrad {t['library_ms']:.4f}, bound "
                  f"{t['bound_ms']:.4f} {t['bound_by']})")
    # a rank's batch of 2: the shapes of (d)'s rank-steps
    _, _, calls = cae_dp_step(torch, grouped_half(inputs), "phase1",
                              "bfloat16", record=True)
    rank_times = cae_step_kernel_times(
        torch, calls, GROUPED_STEP, "cae grouped: phase-1 step at a rank's "
        "batch of 2, bfloat16")
    return dict(launches=launches, worst=worst, times=times, entry=entry,
                rank_times=rank_times)


def grouped_sharding():
    """The whole batch of a one-process step."""
    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    return row_sharding(None, CAE_DP_BATCH)


def grouped_half(inputs):
    """``inputs`` with rank 0's rows of the global batch (every other
    row), a rank's batch for a one-process step."""
    return dict(inputs, data={
        kind: {k: None if v is None else v[0::DP_WORLD]
               for k, v in data.items()}
        for kind, data in inputs["data"].items()})


class _EntryWithoutDx:
    """``Conv3x3Fn`` with the input of a C_in-1 conv (the entry) detached:
    its backward then takes K4 alone, as the folded entry conv on data does,
    and the grouped entry BN gets no gradient (the JAX s2d path's grouped
    fault)."""

    real = None

    @staticmethod
    def apply(x, *args):
        if x.shape[-1] == CAE_CHANNELS[0]:
            x = x.detach()
        return _EntryWithoutDx.real.apply(x, *args)


def grouped_step(torch, inputs, dev, dt, drop_entry_dx=False):
    """(b)'s step: one phase-1 training step (forward, loss at
    CAE_VS_CPU_FACTOR, backward; augmentation off) at batch
    CAE_VS_CPU_BATCH from the seeded weights, with the switch as set, on
    ``dev`` in ``dt`` -> (loss, gradients and buffers in float64 on the
    CPU, seconds)."""
    from stroke_prediction_tpu_torch.data.dataset import (
        KEY_GLOBAL, KEY_LABELS)
    from stroke_prediction_tpu_torch.inference import cae_dto_from_batch
    from stroke_prediction_tpu_torch.models import layers
    from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
    from stroke_prediction_tpu_torch.train.cae_learners import cae_loss

    data = inputs["data"]["phase1"]
    labels = data[KEY_LABELS][:CAE_VS_CPU_BATCH].to(dev, dt)
    clinical = data[KEY_GLOBAL][:CAE_VS_CPU_BATCH].to(dev, dt)
    m = Cae3D(Enc3D(CAE_CHANNELS), Dec3D(CAE_CHANNELS))
    m.load_state_dict(inputs["states"]["phase1"])
    m = m.to(dev, dt).train()
    set_cae_dtype(m, dt)
    t0 = time.perf_counter()
    _EntryWithoutDx.real = layers.Conv3x3Fn
    if drop_entry_dx:
        layers.Conv3x3Fn = _EntryWithoutDx
    try:
        loss = cae_loss(m(cae_dto_from_batch(None, labels, clinical)),
                        CAE_VS_CPU_FACTOR)
        loss.backward()
    finally:
        layers.Conv3x3Fn = _EntryWithoutDx.real
    if dev == "cuda":
        torch.cuda.synchronize()
    return (float(loss.detach()),
            {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .cpu().double() for k, p in m.named_parameters()},
            {k: b.cpu().double() for k, b in m.named_buffers()},
            time.perf_counter() - t0)


def grouped_witness(torch):
    """(b)'s witness, the grouped float64 CPU step of its own
    :func:`grouped_inputs` (seeded, on the CPU), in the witnesses' pool."""
    saved = os.environ.get(GROUPED_SWITCH)
    os.environ[GROUPED_SWITCH] = "1"
    try:
        return grouped_step(torch, grouped_inputs(torch), "cpu",
                            torch.float64)
    finally:
        if saved is None:
            del os.environ[GROUPED_SWITCH]
        else:
            os.environ[GROUPED_SWITCH] = saved


def grouped_steps_vs_f64(torch, inputs, witness):
    """(b): :func:`grouped_step` on the card in float32, grouped and
    sequential, each against the grouped float64 CPU step of ``witness``
    (:func:`grouped_witness`'s future, submitted at the phase's start) at
    the STEP_* limits; the grouped step with the entry conv's dx dropped
    must fail them."""
    dropped = "grouped card float32, entry dx dropped"
    out = {}
    for side, switch, drop in (("grouped card float32", "1", False),
                               ("card float32", "0", False),
                               (dropped, "1", True)):
        os.environ[GROUPED_SWITCH] = switch
        out[side] = grouped_step(torch, inputs, "cuda", torch.float32, drop)
    os.environ[GROUPED_SWITCH] = "1"
    t0 = time.perf_counter()
    out["grouped CPU float64"] = witness.result(GROUPED_WITNESS_TIMEOUT)
    print("\ncae grouped step seconds: " + ", ".join(
        f"{side} {v[3]:.2f} s" for side, v in out.items()) +
        f" (the witnesses' pool; waited for {time.perf_counter() - t0:.1f} "
        f"s)")
    what = f"cae grouped step (batch {CAE_VS_CPU_BATCH})"
    res = {}
    for side in ("grouped card float32", "card float32", dropped):
        loss_rel, grad, stats, norm = grad_compare(
            out, side, "grouped CPU float64", cae_layer_of, what)
        res[side] = dict(loss_rel=loss_rel, grad_rel=grad[0],
                         worst_grad=grad[1], stats_err=stats,
                         layer_rel=max(norm.values()))
        beyond = (loss_rel > STEP_LOSS_REL or grad[0] > STEP_GRAD_REL
                  or stats > STEP_STATS_ATOL)
        if beyond != (side == dropped):
            verdict = "passes" if side == dropped else "is beyond"
            raise AssertionError(f"{what}: {side} vs float64 {verdict} the "
                                 f"STEP_* limits: {res[side]}")
    entry = [k for k in out[dropped][1] if k.startswith(CAE_ENTRY + ".bn.")]
    if any(out[dropped][1][k].any() for k in entry) or not all(
            out["grouped card float32"][1][k].any() for k in entry):
        raise AssertionError(f"{what}: the entry BN's gradients: zero with "
                             f"the entry dx dropped, non-zero otherwise")
    g, s = (res[k]["grad_rel"] for k in ("grouped card float32",
                                         "card float32"))
    print(f"{what}: grouped card float32 {g:.3e}, sequential {s:.3e} of its "
          f"layer's largest gradient off the grouped float64 CPU step "
          f"(STEP_GRAD_REL {STEP_GRAD_REL}); the entry-dx control "
          f"{res[dropped]['grad_rel']:.3e} at {res[dropped]['worst_grad']}")
    return res


def grouped_testers(torch, work, inputs):
    """(c): the curve tester on one case with the switch off and on: the
    case's measures (one forward) and each of its three sweeps', within
    GROUPED_MEASURES_ATOL, and K1 launches a case and a curve case's
    sweeps; with the switch on every K1 and edt_sites call on its own
    inputs against plain."""
    from stroke_prediction_tpu_torch.cli.common import make_dataset
    from stroke_prediction_tpu_torch.data.dataset import (
        LABEL_CORE, LABEL_LESION, LABEL_PENU, MOD_CBV, MOD_TTD)
    from stroke_prediction_tpu_torch.data.loader import get_testdata
    from stroke_prediction_tpu_torch.eval.cae_tester import (
        CaeReconstructionTesterCurve)
    from stroke_prediction_tpu_torch.models.cae3d import Cae3D, Dec3D, Enc3D
    from stroke_prediction_tpu_torch.models.convert import (
        save_cae_checkpoint)
    from stroke_prediction_tpu_torch.utils.args import get_args_shape_testing

    model = Cae3D(Enc3D(CAE_CHANNELS), Dec3D(CAE_CHANNELS))
    model.load_state_dict(inputs["states"]["cae"])
    ckpt = os.path.join(work, "grouped_cae.model")
    save_cae_checkpoint(ckpt, model.eval())
    args = get_args_shape_testing(["--path", ckpt, "--fold", str(FOLD[0]),
                                   "--synthetic"])
    dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                           [LABEL_CORE, LABEL_PENU, LABEL_LESION],
                           pad=tuple(args.padding))
    loader = get_testdata(dataset, [FOLD[0]], seed=args.seed)
    curve = CaeReconstructionTesterCurve(
        loader, ckpt, os.path.join(work, "grouped_curve"), 10,
        device="cuda")
    batch = loader.dataset.stack([loader.indices[0]])
    _, sweeps = curve.sweeps(batch)
    fields = ("dc", "hd", "assd", "precision", "sensitivity", "specificity")
    got, k1 = {}, {}
    for switch in ("0", "1"):
        os.environ[GROUPED_SWITCH] = switch
        with torch.inference_mode():
            curve.infer_batch(batch)                    # warm-up
            reset_launches()
            case, _ = curve.infer_batch(batch)
            n_case = read_launches()["conv3x3"]
            reset_launches()
            swept = [curve.infer_batch_steps(batch, steps)[0]
                     for steps, _ in sweeps]
            n_sweeps = read_launches()["conv3x3"]
        k1[switch] = (n_case, n_sweeps)
        got[switch] = [case[p] for p in ("lesion", "core", "penu")] + [
            m for ms in swept for m in ms]
        if (n_case, n_sweeps) != (GROUPED_CASE_K1[switch],
                                  GROUPED_SWEEPS_K1[switch]):
            raise AssertionError(f"cae grouped tester, switch {switch}: K1 "
                                 f"{n_case} a case, {n_sweeps} the sweeps")
    apart = [(i, f, getattr(a, f), getattr(b, f))
             for i, (a, b) in enumerate(zip(got["1"], got["0"]))
             for f in fields
             if not getattr(a, f) == getattr(b, f) == float("inf")]
    worst = max(abs(on - off) for _, _, on, off in apart)
    calls, sites, rec_worst = cae_recorded(torch, lambda: (
        curve.infer_batch(batch),
        [curve.infer_batch_steps(batch, steps) for steps, _ in sweeps]))
    edt_want = {(1, *CAE_DHW): CAE_EDT_PER_CASE}
    for steps, _ in sweeps:
        key = (len(steps), *CAE_DHW)
        edt_want[key] = edt_want.get(key, 0) + CAE_SWEEP_EDT
    cae_check_recorded("the grouped tester case and its three sweeps",
                       calls, sites, rec_worst,
                       {"K1": GROUPED_CASE_K1["1"] + GROUPED_SWEEPS_K1["1"]},
                       edt_want,
                       prefix="cae grouped")
    print(f"cae grouped: tester case and sweeps, switch on vs off: "
          f"{len(got['1'])} measures, largest |difference| {worst:.3e} "
          f"(limit {GROUPED_MEASURES_ATOL}); K1 a case / the sweeps: off "
          f"{k1['0']}, on {k1['1']}")
    if worst > GROUPED_MEASURES_ATOL or len(got["1"]) != len(got["0"]):
        moved = [m for m in apart if abs(m[2] - m[3]) > GROUPED_MEASURES_ATOL]
        raise AssertionError(f"cae grouped: the tester's measures move with "
                             f"the switch (measure index, field, on, off): "
                             f"{moved}")
    os.environ[GROUPED_SWITCH] = "1"
    return dict(worst=worst, k1=k1, recorded=rec_worst)


def cae_dp_calls(torch, inputs, kind, mesh):
    """The all_reduce calls of one of this rank's bfloat16 steps of
    ``kind`` (:func:`cae_dp_time`'s step), untimed."""
    import torch.distributed as dist

    from stroke_prediction_tpu_torch.parallel.mesh import row_sharding

    learner = cae_dp_learner(torch, inputs, kind, torch.bfloat16, mesh,
                             os.path.join(tempfile.gettempdir(), "cae_dp"),
                             distances=False)
    sharding = row_sharding(mesh, CAE_DP_BATCH)
    batch = cae_dp_batch(torch, inputs, kind, sharding, torch.bfloat16)
    real, calls = dist.all_reduce, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    dist.all_reduce = counted
    try:
        with sharding.active():
            learner.train_step(batch, CAE_DP_FACTOR[kind])
    finally:
        dist.all_reduce = real
    return calls[0]


def cae_grouped_rank(rank, coordinator, inputs_path, outdir):
    """One rank of (d), on cuda:0 over gloo: each learner's float64 step
    (the plain versions) with the switch on, its bfloat16 rank-step timed
    with the switch on, with its all_reduce calls, and those of one
    rank-step with the switch off -> outdir/rank<rank>.pt."""
    import torch

    from stroke_prediction_tpu_torch.parallel import distributed
    from stroke_prediction_tpu_torch.parallel.mesh import make_data_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(coordinator, DP_WORLD, rank, backend="gloo",
                           device="cuda")
    mesh = make_data_mesh()
    inputs = torch.load(inputs_path)
    out = {"steps": {}, "timing": {}, "off_calls": {}}
    for kind in CAE_DP_LEARNERS:
        os.environ[GROUPED_SWITCH] = "1"
        torch.cuda.empty_cache()
        out["steps"][kind] = cae_dp_step(torch, inputs, kind, "float64",
                                         mesh)[0]
        out["timing"][kind] = cae_dp_time(torch, inputs, kind, mesh,
                                          GROUPED_TIMED_STEPS)
        os.environ[GROUPED_SWITCH] = "0"
        out["off_calls"][kind] = cae_dp_calls(torch, inputs, kind, mesh)
    out["device"] = str(torch.cuda.current_device())
    distributed.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def grouped_one_process(torch, inputs):
    """(d)'s reference: each learner's one-process grouped float64 step on
    the global batch (the plain versions, on the card)."""
    os.environ[GROUPED_SWITCH] = "1"
    return {kind: cae_dp_step(torch, inputs, kind, "float64")[0]
            for kind in CAE_DP_LEARNERS}


def grouped_ranks(torch, work, one):
    """(d): two ranks on the one card over gloo, one rank-step of each
    learner on 2 of the global batch of 4 with the switch on: float64 at
    DP_F64_REL of ``one`` (:func:`grouped_one_process`), the ranks equal;
    the all_reduce calls a rank-step, on and off, against
    GROUPED_ALL_REDUCE; ms per bfloat16 rank-step and the collectives'
    share with the switch on (off: :func:`cae_dp_phase`'s, the same
    rank-steps in the same run).  The ranks read the inputs that
    :func:`cae_grouped_phase` saved."""
    os.environ[GROUPED_SWITCH] = "1"
    path = os.path.join(work, "grouped_inputs.pt")
    ranks = run_ranks(torch, cae_grouped_rank, path,
                      os.path.join(work, "grouped_ranks"), "cae grouped")
    res = {"vs_one_process": {}, "timing": ranks[0]["timing"]}
    for kind in CAE_DP_LEARNERS:
        for r, got in enumerate(ranks):
            d = dp_distance(got["steps"][kind], one[kind], cae_dp_layer_of)
            print(f"cae grouped: {kind} rank {r} float64 vs the one-process "
                  f"grouped float64 step: {d}")
            if max(d["loss"], d["element"], d["layer"], d["stats"],
                   d["metrics"]) > DP_F64_REL or d["assd"] > DP_ASSD_REL:
                raise AssertionError(f"cae grouped: {kind} rank {r}: {d}")
            res["vs_one_process"][(kind, r)] = d
            t = got["timing"][kind]
            print(f"cae grouped: {kind} rank {r} bfloat16 rank-step, switch "
                  f"on: {t['step_ms']:.3f} ms; all_reduce {t['calls']:g} a "
                  f"step, {got['off_calls'][kind]} with the switch off "
                  f"(predicted {GROUPED_ALL_REDUCE['on'][kind]}, "
                  f"{GROUPED_ALL_REDUCE['off'][kind]}); "
                  f"{t['collective_ms']:.3f} of {t['instrumented_ms']:.3f} ms "
                  f"instrumented "
                  f"({100 * t['collective_ms'] / t['instrumented_ms']:.1f}%)")
            if (t["calls"], got["off_calls"][kind]) != tuple(
                    GROUPED_ALL_REDUCE[name][kind] for name in ("on", "off")):
                raise AssertionError(f"cae grouped: {kind}: {t['calls']} / "
                                     f"{got['off_calls'][kind]} all_reduce a "
                                     f"rank-step on / off, predicted "
                                     f"{GROUPED_ALL_REDUCE}")
        a, b = (r["steps"][kind] for r in ranks)
        if a["loss"] != b["loss"] or any(
                not torch.equal(a["grads"][k], b["grads"][k])
                for k in a["grads"]):
            raise AssertionError(f"cae grouped: {kind}: the ranks' losses or "
                                 f"gradients differ")
    return res


def cudnn_cost(torch, step, n, what):
    """``step`` (one training step) ``n`` times with cuDNN's deterministic
    algorithms (as the port runs) and ``n`` times with any, interleaved
    (ABBA), after a warm-up of each: the mean and spread of each side's
    device ms between CUDA events around each step, and the difference
    with its standard error."""
    real_flags = torch.backends.cudnn.flags

    def any_algorithm(*args, **kw):
        return real_flags(*args, **dict(kw, deterministic=False))

    order = [i % 4 in (1, 2) for i in range(2 * n)]     # True: any
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4 * n)]
    try:
        for free in (False, True):
            torch.backends.cudnn.flags = any_algorithm if free else real_flags
            step()
        torch.cuda.synchronize()
        for i, free in enumerate(order):
            torch.backends.cudnn.flags = any_algorithm if free else real_flags
            marks[2 * i].record()
            step()
            marks[2 * i + 1].record()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.flags = real_flags
    per = {False: [], True: []}
    for i, free in enumerate(order):
        per[free].append(marks[2 * i].elapsed_time(marks[2 * i + 1]))
    stat = {}
    for free, name in ((False, "deterministic"), (True, "any")):
        v = per[free]
        mean = sum(v) / n
        stat[name] = dict(mean=mean, std=(sum((x - mean) ** 2 for x in v)
                                          / (n - 1)) ** 0.5)
    diff = stat["deterministic"]["mean"] - stat["any"]["mean"]
    se = (sum(v["std"] ** 2 for v in stat.values()) / n) ** 0.5
    print(f"{what}: cuDNN deterministic vs any algorithm, {n} steps each "
          f"interleaved: {stat['deterministic']['mean']:.3f} ms (std "
          f"{stat['deterministic']['std']:.3f}) vs {stat['any']['mean']:.3f}"
          f" ms (std {stat['any']['std']:.3f}); difference {diff:.3f} ms "
          f"({100 * diff / stat['any']['mean']:.1f}%), standard error "
          f"{se:.3f} ms")
    return dict(stat, diff_ms=diff, se_ms=se)


def grouped_learner(torch, inputs, kind):
    """A one-process bfloat16 learner of ``kind`` and its batch of 4 (the
    augmentation on, no distances, as its CLI's)."""
    learner = cae_dp_learner(torch, inputs, kind, torch.bfloat16, None,
                             os.path.join(tempfile.gettempdir(), "grouped"),
                             distances=False)
    return learner, cae_dp_batch(torch, inputs, kind, grouped_sharding(),
                                 torch.bfloat16)


def grouped_step_profiles(torch, inputs):
    """(e), its profiles: each learner's one-process bfloat16 step with the
    switch off and on, device busy ms and kernels in a profile of one.
    Run while (b)'s witness keeps the host's cores busy: the kernels' device
    time and count do not follow the host's load (the profile's host ms
    does)."""
    res = {}
    for kind in CAE_DP_LEARNERS:
        learner, batch = grouped_learner(torch, inputs, kind)
        for name, switch in (("off", "0"), ("on", "1")):
            os.environ[GROUPED_SWITCH] = switch
            res[(kind, name)] = cae_profile_step(
                torch, learner, batch,
                f"cae grouped: {kind} bfloat16 step, switch {name}")
    os.environ[GROUPED_SWITCH] = "1"
    return res


def grouped_step_times(torch, inputs, busy):
    """(e): each learner's one-process bfloat16 step with the switch off
    and on: ms per step (GROUPED_TIMED_STEPS back to back) beside ``busy``
    (:func:`grouped_step_profiles`).  Phase 1's and phase 2's, switch off,
    are timed by :func:`cudnn_cost` instead (the cost of cuDNN's
    deterministic algorithms; the step's ms its deterministic side's)."""
    res = {}
    for kind in CAE_DP_LEARNERS:
        learner, batch = grouped_learner(torch, inputs, kind)

        def step():
            learner.train_step(batch, CAE_DP_FACTOR[kind])

        for name, switch in (("off", "0"), ("on", "1")):
            os.environ[GROUPED_SWITCH] = switch
            what = f"cae grouped: {kind} bfloat16 step, switch {name}"
            if switch == "0" and kind in ("phase1", "prediction"):
                cost = cudnn_cost(torch, step, CUDNN_COST_STEPS, what)
                res[(kind, name)] = dict(
                    step_ms=cost["deterministic"]["mean"],
                    std=cost["deterministic"]["std"], cudnn=cost)
            else:
                mean, std, _ = time_steps(torch, step, GROUPED_TIMED_STEPS,
                                          what)
                res[(kind, name)] = dict(step_ms=mean, std=std)
            res[(kind, name)]["busy"] = busy[(kind, name)]
    os.environ[GROUPED_SWITCH] = "1"
    return res


def cae_grouped_phase(torch, work):
    """Structure batching on the card: (a) :func:`grouped_kernels`, (b)
    :func:`grouped_steps_vs_f64`, (c) :func:`grouped_testers`, (d)
    :func:`grouped_ranks`, (e) :func:`grouped_step_times`; (b)'s witness
    runs in the witnesses' pool from the start, beside the parts that time
    nothing on the host's clock ((a), (c), (d)'s one-process steps, (e)'s
    profiles); the switch restored after."""
    before = os.environ.get(GROUPED_SWITCH)
    os.environ[GROUPED_SWITCH] = "1"
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    try:
        witness_step = witness(grouped_witness)
        inputs = part("inputs", grouped_inputs)
        torch.save(inputs, os.path.join(work, "grouped_inputs.pt"))
        kernels = part("a", grouped_kernels, inputs)
        testers = part("c", grouped_testers, work, inputs)
        one = part("d, one process", grouped_one_process, inputs)
        busy = part("e, profiles", grouped_step_profiles, inputs)
        out = dict(kernels=kernels, testers=testers,
                   vs_f64=part("b", grouped_steps_vs_f64, inputs,
                               witness_step),
                   ranks=part("d", grouped_ranks, work, one),
                   times=part("e", grouped_step_times, inputs, busy))
        print(f"cae grouped: seconds by part {seconds}")
        return out
    finally:
        if before is None:
            os.environ.pop(GROUPED_SWITCH, None)
        else:
            os.environ[GROUPED_SWITCH] = before


# The rest of the space axis: the four CAE learners, their eval and the
# 4-scale U-Net with H sharded over the ranks, four ranks on cuda:0 over
# gloo, on the CAE data-parallel phase's global batch of 4 (28x128x128
# masks, the CTP images padded to 68x168x168, each cut by its own block
# rule) and weights: (a) each learner's float64, float32 and bfloat16
# rank-step at {data: 2, space: 2} (the float32 and bfloat16 steps
# recorded), two float64 controls and phase 1's float64 step with its
# augmentation on; (b) eval_step at {data: 1, space: 4} on the CAE training
# phase's trained CAE, float64 (HD bit for bit) and float32 (recorded);
# (c) a float64 and a bfloat16 LargeUnet3D step at {2, 2} on 116x220x220
# patches; (d) the launches, exchanges and bfloat16 ms of a phase-1
# rank-step; (e) K4's repeat checks: each rank runs the U-Net spatial
# rank-step of the spatial phase and the phase-1 CAE rank-step three times
# with every K4 call's inputs and outputs hashed, then K4 and K2 at their
# rank-step shapes with their partials filled with NaN before each launch.
SPATIAL_CAE_MESH = (2, 2)
SPATIAL_CAE_EVAL_MESH = (1, 4)
SPATIAL_CAE_SIDES = ("float64", "float32", "bfloat16")
SPATIAL_CAE_CONTROLS = ("float64, padding per block",
                        "float64, draws over the block")
# a float64 CAE rank-step against the one-process float64 step (loss,
# gradients, statistics), as one process sums them in another order; the
# 4-scale U-Net's at DP_F64_REL: its gradients sum over ~10M voxels, and
# reordered they moved 1.10e-13 of a layer's largest on an NVIDIA H100
# 80GB HBM3 (700 W)
SPATIAL_F64_REL = 1e-13
LARGE_SPATIAL_DHW = (116, 220, 220)   # the large U-Net tester's volume
LARGE_SPATIAL_BATCH = 2
LARGE_SPATIAL_SIDES = ("float64", "bfloat16")
SPATIAL_REPEATS = 3                  # (e): rank-steps run again, hashed
K4_REPEATS = 200                     # (e): launches at K4_REPEAT_SHAPE
# where a recorded U-Net rank-step's K4 once gave two results on the same
# inputs (L8 of a rank's block, C_out 32)
K4_REPEAT_SHAPE = (3, 18, 19, 36, 32)
KERNEL_REPEATS = 10                  # (e): launches at each rank-step shape


def block_padding(real):
    """``spatial.conv_rows`` with the classic fault of a padded conv: each
    rank pads its own block, so its neighbours' rows inside the volume read
    as zeros (a control)."""
    def conv_rows(x, h_in, stride=1, pad=0):
        import torch

        from stroke_prediction_tpu_torch.parallel import spatial

        got, h_out = real(x, h_in, stride, pad)
        if not pad:
            return got, h_out
        lo, _ = spatial.own_block(h_out)
        o_lo, o_hi = spatial.own_block(h_in)
        rows = stride * lo - pad + torch.arange(got.shape[2],
                                                device=got.device)
        keep = ((rows >= o_lo) & (rows < o_hi)) | (rows < 0) | (rows >= h_in)
        return got * keep.to(got.dtype).reshape(1, 1, -1, 1, 1), h_out
    return conv_rows


def local_draws(generator, labels):
    """The CAE draws over this rank's block of H alone (a control)."""
    import torch

    from stroke_prediction_tpu_torch.data.augment import random_flip_mask
    from stroke_prediction_tpu_torch.ops.warp import (
        elastic_fields, elastic_noise)
    from stroke_prediction_tpu_torch.parallel.mesh import current

    sharding = current()
    n = sharding.global_size(labels.shape[0])
    flip = random_flip_mask(generator, n)
    noise = elastic_noise(generator, n, tuple(labels.shape[1:4]),
                          labels.dtype)
    fields = torch.stack([elastic_fields(x) for x in sharding.take(noise)])
    return sharding.take(flip), fields


def spatial_cae_batch(torch, inputs, kind, mesh, dtype):
    """This rank's rows and block of H (each array by its own H) of
    ``kind``'s global batch on the card."""
    from stroke_prediction_tpu_torch.parallel.mesh import shard_batch

    wide = torch.promote_types(dtype, torch.float32)
    got = shard_batch(mesh, inputs["data"][kind], spatial=True)
    return {k: None if v is None else v.contiguous().to("cuda", wide)
            for k, v in got.items()}


def spatial_cae_step(torch, inputs, kind, side, mesh=None, record=False,
                     augment=False, evaluate=False):
    """One training step of ``kind`` in ``side`` (a SPATIAL_CAE_SIDES or
    SPATIAL_CAE_CONTROLS entry; float64 with the plain versions of K1-K4)
    on this rank's rows and block of H under a spatial ``mesh`` (the whole
    batch without one), augmentation off unless ``augment``; ``evaluate``:
    ``eval_step`` on the trained CAE instead; ``record``: every K1-K4 and
    edt_sites call against plain (:func:`cae_recorded`) -> ({loss, grads,
    stats, metrics, calls, sites, worst, exchanges}, learner, calls)."""
    from stroke_prediction_tpu_torch.data import augment as aug
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.parallel import collectives, spatial
    from stroke_prediction_tpu_torch.parallel.mesh import batch_sharding

    dtype = getattr(torch, side.split(",")[0])
    learner = cae_dp_learner(torch, inputs, kind, dtype, mesh,
                             os.path.join(tempfile.gettempdir(),
                                          "spatial_cae"))
    if evaluate:
        learner._model.load_state_dict(inputs["states"]["cae"])
    if not (augment or "draws" in side):
        learner.augment = lambda batch: batch
    sharding = batch_sharding(mesh, spatial=True)
    batch = spatial_cae_batch(torch, inputs, kind, mesh, dtype)
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    conv_rows, draws = spatial.conv_rows, aug._cae_draws
    got = []

    def run():
        with sharding.active():
            got.append(learner.eval_step(batch) if evaluate else
                       learner.train_step(batch, CAE_DP_FACTOR[kind]))

    calls, sites, worst = {}, {}, {}
    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        if "padding" in side:
            spatial.conv_rows = block_padding(conv_rows)
        if "draws" in side:
            aug._cae_draws = local_draws
        collectives.reset_exchange_counts()
        if record:
            calls, sites, worst = cae_recorded(torch, run, grad=not evaluate)
        else:
            run()
            torch.cuda.synchronize()
        exchanges = dict(collectives.EXCHANGE_COUNTS)
    finally:
        for n in names:
            setattr(cm, n, real[n])
        spatial.conv_rows, aug._cae_draws = conv_rows, draws
    metrics = got[0]
    model = learner._model
    counts = {k: sum(n for key, n in calls.items() if key[0] == k)
              for k in CAE_KERNELS}
    return dict(loss=float(metrics["loss"]),
                grads={k: p.grad.cpu().double()
                       for k, p in model.named_parameters()
                       if p.grad is not None},
                stats={k: b.cpu().double() for k, b in model.named_buffers()},
                metrics={k: float(v) for k, v in metrics.items()},
                calls=counts, sites=sites, worst=worst,
                exchanges=exchanges), learner, calls


def large_spatial_inputs(torch):
    """Seeded ``LargeUnet3D`` weights (LARGE_CHANNELS) and a global batch
    of LARGE_SPATIAL_BATCH 116x220x220 patches: images in [0, 4), labels
    two overlapping balls at the output's 28x132x132."""
    from stroke_prediction_tpu_torch.models.unet3d import (
        LargeUnet3D, unet_output_spatial)

    gen = torch.Generator().manual_seed(9)
    model = LargeUnet3D(LARGE_CHANNELS, generator=gen)
    images = torch.rand(LARGE_SPATIAL_BATCH, *LARGE_SPATIAL_DHW, 2,
                        generator=gen) * 4
    out = unet_output_spatial(LARGE_SPATIAL_DHW, n_scales=4)
    grid = torch.stack(torch.meshgrid(*(torch.linspace(-1, 1, n)
                                        for n in out), indexing="ij"))
    r = grid.pow(2).sum(0).sqrt()
    labels = torch.stack([r < 0.5, r < 0.8], -1).float()
    labels = labels[None].expand(LARGE_SPATIAL_BATCH, *labels.shape)
    return {"state": model.state_dict(), "images": images,
            "labels": labels.contiguous()}


def large_spatial_step(torch, inputs, side, mesh=None):
    """One ``LargeUnet3D`` training step of ``side`` (float64 with the plain
    versions of K1-K4, or bfloat16) on this rank's rows and block of H (the
    whole batch without ``mesh``) -> {loss, grads, stats, metrics,
    launches, exchanges}."""
    import types

    from stroke_prediction_tpu_torch.models.unet3d import LargeUnet3D
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm
    from stroke_prediction_tpu_torch.parallel import collectives
    from stroke_prediction_tpu_torch.parallel.mesh import (
        batch_sharding, shard_batch)
    from stroke_prediction_tpu_torch.train.optim import make_optimizer
    from stroke_prediction_tpu_torch.train.unet_learner import (
        UnetSegmentationLearner)

    dtype = getattr(torch, side)
    wide = torch.promote_types(dtype, torch.float32)
    model = LargeUnet3D(LARGE_CHANNELS, compute_dtype=dtype)
    model.load_state_dict(inputs["state"])
    model.to("cuda", wide)
    learner = UnetSegmentationLearner(
        types.SimpleNamespace(batch_size=LARGE_SPATIAL_BATCH), None, model,
        make_optimizer(model.parameters(), 1e-3, betas=(0.99, 0.999),
                       weight_decay=1e-5), None, 1,
        patch_whd=LARGE_SPATIAL_DHW[::-1], pad_xyz=LARGE_PAD,
        device=torch.device("cuda", torch.cuda.current_device()), mesh=mesh)
    local = shard_batch(mesh, {k: inputs[k] for k in ("images", "labels")},
                        spatial=True)
    names = ("conv3x3", "conv3x3_bwd_fused", "conv3x3_bwd_dx",
             "conv3x3_bwd_dw")
    real = {n: getattr(cm, n) for n in names}
    try:
        if dtype == torch.float64:
            for n in names:
                setattr(cm, n, getattr(cm, n + "_plain"))
        reset_launches()
        collectives.reset_exchange_counts()
        with batch_sharding(mesh, spatial=True).active():
            metrics = learner.train_patches(
                local["images"].contiguous().to("cuda", wide),
                local["labels"].contiguous().to("cuda", wide))
        torch.cuda.synchronize()
        launches = read_launches()
        exchanges = dict(collectives.EXCHANGE_COUNTS)
    finally:
        for n in names:
            setattr(cm, n, real[n])
    return dict(loss=float(metrics["loss"]),
                grads={k: p.grad.cpu().double()
                       for k, p in model.named_parameters()},
                stats={k: b.cpu().double() for k, b in model.named_buffers()},
                metrics={k: float(v) for k, v in metrics.items()},
                launches=launches, exchanges=exchanges)


def k4_hashes(torch, run):
    """``run()`` with every K4 call's inputs (x, g, y) and outputs (dk, db)
    hashed (sha1 of their bytes), in call order -> [(shape, input hash,
    output hash)]."""
    import hashlib

    from stroke_prediction_tpu_torch.ops import conv3x3 as cm

    real, seen = cm.conv3x3_bwd_dw, []

    def digest(*ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        return h.hexdigest()

    def k4(x, g, y, *args, **kw):
        out = real(x, g, y, *args, **kw)
        torch.cuda.synchronize()
        seen.append((tuple(x.shape) + (g.shape[-1],), digest(x, g, y),
                     digest(*out)))
        return out

    k4.launches = 0
    cm.conv3x3_bwd_dw = k4
    try:
        run()
        torch.cuda.synchronize()
    finally:
        cm.conv3x3_bwd_dw = real
    return seen


def repeat_hashes(torch, mesh, dp_inputs, inputs):
    """(e): the spatial phase's U-Net bfloat16 rank-step and the phase-1
    bfloat16 CAE rank-step, SPATIAL_REPEATS times each from the same
    weights and batch, every K4 call hashed -> {name: [runs]}."""
    out = {}
    for name, step in (
            ("unet", lambda: spatial_step(torch, dp_inputs, "bfloat16",
                                          mesh)),
            ("cae phase1", lambda: spatial_cae_step(
                torch, inputs, "phase1", "bfloat16", mesh))):
        out[name] = [k4_hashes(torch, step) for _ in range(SPATIAL_REPEATS)]
    return out


def spatial_cae_rank(rank, coordinator, inputs_path, outdir):
    """One rank of the spatial CAE phase, on cuda:0 over gloo: (a) each
    learner's SPATIAL_CAE_SIDES rank-steps at SPATIAL_CAE_MESH (float32 and
    bfloat16 recorded), the two controls and phase 1's augmented float64
    step; (d) the phase-1 bfloat16 rank-step timed; (e) the repeated
    rank-steps, hashed; (c) the LargeUnet3D steps; (b) eval_step at
    SPATIAL_CAE_EVAL_MESH -> outdir/rank<rank>.pt."""
    import torch

    from stroke_prediction_tpu_torch.parallel import distributed
    from stroke_prediction_tpu_torch.parallel.mesh import (
        batch_sharding, make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(coordinator, SPATIAL_WORLD, rank, backend="gloo",
                           device="cuda")
    mesh = make_mesh(*SPATIAL_CAE_MESH)
    paths = torch.load(inputs_path)
    inputs = torch.load(paths["cae"])
    out = {"steps": {}, "calls": {}}
    for kind in CAE_DP_LEARNERS:
        for side in SPATIAL_CAE_SIDES:
            torch.cuda.empty_cache()
            got, _, calls = spatial_cae_step(
                torch, inputs, kind, side, mesh,
                record=side != "float64")
            out["steps"][(kind, side)] = got
            if calls:
                out["calls"][(kind, side)] = calls
    for side in SPATIAL_CAE_CONTROLS:
        out["steps"][("phase1", side)] = spatial_cae_step(
            torch, inputs, "phase1", side, mesh)[0]
    out["steps"][("phase1", "float64, augmented")] = spatial_cae_step(
        torch, inputs, "phase1", "float64", mesh, augment=True)[0]

    learner = cae_dp_learner(torch, inputs, "phase1", torch.bfloat16, mesh,
                             os.path.join(tempfile.gettempdir(),
                                          "spatial_cae_time"),
                             distances=False)
    sharding = batch_sharding(mesh, spatial=True)
    batch = spatial_cae_batch(torch, inputs, "phase1", mesh, torch.bfloat16)

    def step():
        with sharding.active():
            learner.train_step(batch, CAE_DP_FACTOR["phase1"])

    out["timing"] = rank_step_times(torch, step)
    del learner, batch
    out["repeats"] = repeat_hashes(torch, mesh, torch.load(paths["unet"]),
                                   inputs)
    large = torch.load(paths["large"])
    out["large"] = {side: large_spatial_step(torch, large, side, mesh)
                    for side in LARGE_SPATIAL_SIDES}
    del large
    torch.cuda.empty_cache()
    eval_mesh = make_mesh(*SPATIAL_CAE_EVAL_MESH)
    out["eval"] = {"float64": spatial_cae_step(
        torch, inputs, "phase1", "float64", eval_mesh, evaluate=True)[0]}
    got, _, calls = spatial_cae_step(torch, inputs, "phase1", "float32",
                                     eval_mesh, record=True, evaluate=True)
    out["eval"]["float32"], out["eval_calls"] = got, calls
    out["device"] = str(torch.cuda.current_device())
    distributed.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def nan_partials(torch):
    """``conv3x3._dw_buffers`` with the dW and db partials filled with NaN
    before the kernel writes them: a partial row that no block writes then
    reaches dk or db."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm

    real = cm._dw_buffers

    def buffers(*args):
        dk, db, part, dbp, n = real(*args)
        part.fill_(float("nan"))
        dbp.fill_(float("nan"))
        return dk, db, part, dbp, n

    return real, buffers


def kernel_repeats(torch, kernel, key, n):
    """``n`` launches of K4 (or K2) at a recorded call's ``key`` on fixed
    inputs, partials NaN before each: every result bit-equal to the first
    and finite, the first within DW_REL of plain -> max|err| vs plain."""
    from stroke_prediction_tpu_torch.ops import conv3x3 as cm

    _, b, d, h, w, ci, co, mode, table, act, dname = key
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(b, d, h, w, ci, device="cuda", generator=gen).to(dtype)
    k = (torch.randn(3, 3, 3, ci, co, device="cuda", generator=gen)
         / (27 * ci) ** 0.5).to(dtype)
    bias = torch.randn(*((cm._out_depth(d, mode), co) if table else (co,)),
                       device="cuda", generator=gen)
    y = cm.conv3x3_plain(x, k, bias, act, 0.01, mode).to(dtype)
    g = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
    real, buffers = nan_partials(torch)
    cm._dw_buffers = buffers
    try:
        if kernel == "K4":
            runs = [cm.conv3x3_bwd_dw(x, g, y, act, 0.01, mode, table)
                    for _ in range(n)]
            ref = cm.conv3x3_bwd_dw_plain(x, g, y, act, 0.01, mode, table)
        else:
            runs = [cm.conv3x3_bwd_fused(x, g, y, k, act, 0.01, mode,
                                         table)[1:] for _ in range(n)]
            ref = cm.conv3x3_bwd_fused_plain(x, g, y, k, act, 0.01, mode,
                                             table)[1:]
        torch.cuda.synchronize()
    finally:
        cm._dw_buffers = real
    for i, r in enumerate(runs):
        if not all(torch.equal(p, q) for p, q in zip(r, runs[0])):
            raise AssertionError(f"spatial cae: {kernel} {key}: launch {i} "
                                 f"differs from launch 0")
    if not all(bool(torch.isfinite(t).all()) for t in runs[0]):
        raise AssertionError(f"spatial cae: {kernel} {key}: a NaN partial "
                             f"reached the result")
    errs = [rel_err(p, q) for p, q in zip(runs[0], ref)]
    if max(errs) > DW_REL:
        raise AssertionError(f"spatial cae: {kernel} {key}: {errs} of "
                             f"max|ref| off plain")
    return max(float((p - q).abs().max()) for p, q in zip(runs[0], ref))


def k4_repeat_check(torch, ranks):
    """(e) in this process: K4 (bfloat16 and float32) K4_REPEATS times at
    K4_REPEAT_SHAPE, then K4 and K2 KERNEL_REPEATS times at each of
    their shapes in the recorded rank-steps, partials NaN before each
    launch; and the ranks' repeated rank-steps, every K4 call's inputs and
    outputs equal from run to run -> summary."""
    b, d, h, w, c = K4_REPEAT_SHAPE
    res = {"repeat_shape": {}, "shapes": {}, "runs": {}}
    for dname in ("bfloat16", "float32"):
        key = ("K4", b, d, h, w, c, c, "v", False, "leaky_relu", dname)
        res["repeat_shape"][dname] = kernel_repeats(torch, "K4", key,
                                                  K4_REPEATS)
    keys = {key for r in ranks for calls in r["calls"].values()
            for key in calls if key[0] in ("K2", "K4")}
    for key in sorted(keys, key=str):
        res["shapes"][key] = kernel_repeats(torch, key[0], key,
                                            KERNEL_REPEATS)
    for r, got in enumerate(ranks):
        for name, runs in got["repeats"].items():
            first = runs[0]
            for i, run in enumerate(runs[1:], 1):
                if len(run) != len(first):
                    raise AssertionError(f"spatial cae: rank {r} {name}: "
                                         f"run {i} has {len(run)} K4 calls, "
                                         f"run 0 {len(first)}")
                for j, (a, bb) in enumerate(zip(first, run)):
                    if a[1] != bb[1]:
                        raise AssertionError(
                            f"spatial cae: rank {r} {name}: run {i}'s K4 "
                            f"call {j} at {a[0]} had other inputs than run "
                            f"0's")
                    if a[2] != bb[2]:
                        raise AssertionError(
                            f"spatial cae: rank {r} {name}: run {i}'s K4 "
                            f"call {j} at {a[0]} gave another result on "
                            f"the same inputs")
            res["runs"][(r, name)] = len(first) * len(runs)
    n_launches = (2 * K4_REPEATS + KERNEL_REPEATS * len(keys)
                  + sum(res["runs"].values()))
    print(f"spatial cae: (e) K4 repeat check: {K4_REPEATS} launches a type "
          f"at {K4_REPEAT_SHAPE} (C_out {c}) bit-equal, partials NaN before "
          f"each, max|err| vs plain {res['repeat_shape']}; K2 / K4 at "
          f"{len(keys)} rank-step shapes x {KERNEL_REPEATS} bit-equal; "
          f"{SPATIAL_REPEATS} runs of each rank's U-Net and CAE rank-step: "
          f"every K4 call's inputs and outputs equal ({res['runs']} calls); "
          f"{n_launches} launches in all")
    res["launches"] = n_launches
    return res


def spatial_cae_phase(torch, work, dp, cae_dp):
    """(a)-(e) on the CAE data-parallel phase's inputs and one-process card
    steps (and the data-parallel phase's U-Net inputs for (e))."""
    one, path = cae_dp["one"], cae_dp["inputs"]
    inputs = torch.load(path)
    # one-process references this phase adds: phase 1's augmented float64
    # step, the trained CAE's eval_step, and the LargeUnet3D steps
    one[("phase1", "float64, augmented")] = spatial_cae_step(
        torch, inputs, "phase1", "float64", augment=True)[0]
    ev_one = {"float64": spatial_cae_step(torch, inputs, "phase1", "float64",
                                          evaluate=True)[0],
              "float32": spatial_cae_step(torch, inputs, "phase1", "float32",
                                          evaluate=True)[0]}
    large = large_spatial_inputs(torch)
    large_path = os.path.join(work, "spatial_large_inputs.pt")
    torch.save(large, large_path)
    large_one = {side: large_spatial_step(torch, large, side)
                 for side in LARGE_SPATIAL_SIDES}
    del large
    paths = os.path.join(work, "spatial_cae_inputs.pt")
    torch.save({"cae": path, "unet": dp["inputs"], "large": large_path},
               paths)
    ranks = run_ranks(torch, spatial_cae_rank, paths,
                      os.path.join(work, "spatial_cae_ranks"), "spatial cae",
                      world=SPATIAL_WORLD)

    res = {"ranks": [], "one_process_vs_f64": cae_dp["one_process_vs_f64"]}
    sites_want = {(CAE_DP_BATCH // SPATIAL_CAE_MESH[0], *CAE_DHW):
                  CAE_EDT_PER_CASE}
    for r, got in enumerate(ranks):
        entry = {"vs_f64": {}, "calls": {}}
        for kind in CAE_DP_LEARNERS:
            f64 = one[(kind, "float64")]
            d = {side: dp_distance(got["steps"][(kind, side)], f64,
                                   cae_dp_layer_of)
                 for side in SPATIAL_CAE_SIDES}
            if kind == "phase1":
                d.update({side: dp_distance(got["steps"][("phase1", side)],
                                            f64, cae_dp_layer_of)
                          for side in SPATIAL_CAE_CONTROLS[:1]})
                aug = one[("phase1", "float64, augmented")]
                for side in ("float64, augmented", SPATIAL_CAE_CONTROLS[1]):
                    d[side] = dp_distance(got["steps"][("phase1", side)],
                                          aug, cae_dp_layer_of)
            for side, dd in d.items():
                print(f"spatial cae: {kind} rank {r} {side} vs the "
                      f"one-process float64 step: {dd}")
            for side in ("float64", "float64, augmented"):
                if side not in d:
                    continue
                dd = d[side]
                if (max(dd["loss"], dd["element"], dd["layer"], dd["stats"])
                        > SPATIAL_F64_REL or dd["metrics"] > DP_F64_REL
                        or dd["assd"] > DP_ASSD_REL):
                    raise AssertionError(f"spatial cae: {kind} rank {r}'s "
                                         f"{side} step is off the "
                                         f"one-process step: {dd}")
            for side in SPATIAL_CAE_CONTROLS if kind == "phase1" else ():
                if d[side]["element"] <= SPATIAL_F64_REL:
                    raise AssertionError(f"spatial cae: rank {r}: the "
                                         f"control '{side}' passes: "
                                         f"{d[side]}")
            want = cae_dp_want(kind)
            one_f64 = cae_dp["one_process_vs_f64"][kind]
            for side in SPATIAL_CAE_SIDES[1:]:
                limit = {m: DP_FACTOR * one_f64[side][m] + DP_FLOOR
                         for m in ("loss", "element", "layer", "stats")}
                over = {m: d[side][m] for m in limit if d[side][m] > limit[m]}
                step = got["steps"][(kind, side)]
                print(f"spatial cae: {kind} rank {r} {side}: limits {limit};"
                      f" calls {step['calls']} (one process, route rule "
                      f"{want}), edt_sites {step['sites']}; max|err| vs "
                      f"plain {step['worst']}; exchanges "
                      f"{step['exchanges']}")
                if over:
                    print(f"spatial cae: {kind} {side} rank {r}: worst "
                          f"layers {layer_errors(step, f64, cae_dp_layer_of)[:6]}")
                    raise AssertionError(f"spatial cae: {kind} rank {r} "
                                         f"{side} beyond {limit}: {over}")
                if step["calls"] != {k: want.get(k, 0) for k in CAE_KERNELS} \
                        or step["sites"] != sites_want:
                    raise AssertionError(f"spatial cae: {kind} rank {r} "
                                         f"{side}: calls {step['calls']}, "
                                         f"edt_sites {step['sites']}")
            entry["vs_f64"][kind] = {s: {m: v[m] for m in (
                "loss", "element", "layer", "stats", "metrics", "assd")}
                for s, v in d.items()}
            entry["calls"][kind] = got["steps"][(kind, "bfloat16")]["calls"]
        ex = got["steps"][("phase1", "bfloat16")]["exchanges"]
        t = got["timing"]
        print(f"spatial cae: rank {r} phase-1 bfloat16 rank-step (rows "
              f"{CAE_DP_BATCH // SPATIAL_CAE_MESH[0]} a rank, H "
              f"{CAE_DHW[1]} over {SPATIAL_CAE_MESH[1]}, {SPATIAL_WORLD} "
              f"ranks on the one card, augmentation on): "
              f"{t['step_ms']:.3f} ms; instrumented "
              f"{t['instrumented_ms']:.3f} ms, of it exchange_rows "
              f"{t['exchange_ms']:.3f} ms ({t['exchange_calls']:.0f} "
              f"transfers) and all_reduce {t['collective_ms']:.3f} ms "
              f"({t['calls']:.0f} calls); {ex['exchanges']} exchanges + "
              f"{ex['adjoints']} adjoints a step, {ex['bytes']} bytes "
              f"received against {ex['all_gather_bytes']} for an all-gather "
              f"of the same tensors")
        entry.update(timing=t, exchanges=ex, recorded={
            side: {k: max(got["steps"][(kind, side)]["worst"][k]
                          for kind in CAE_DP_LEARNERS) for k in CAE_KERNELS}
            for side in SPATIAL_CAE_SIDES[1:]})

        # (b) eval at SPATIAL_CAE_EVAL_MESH
        for dname, ev in got["eval"].items():
            ref = ev_one[dname]["metrics"]
            gap = {k: abs(ev["metrics"][k] - v) / max(abs(v), 1e-30)
                   for k, v in ref.items() if math.isfinite(v)}
            hd = {k: (ev["metrics"][k], v) for k, v in ref.items()
                  if k.endswith("_hd")}
            print(f"spatial cae: rank {r} {dname} eval_step at "
                  f"{SPATIAL_CAE_EVAL_MESH} vs one process: worst relative "
                  f"gap {max(gap.values()):.3e} ({max(gap, key=gap.get)}); "
                  f"HD (rank, one process) {hd}; exchanges "
                  f"{ev['exchanges']}")
            if dname == "float64":
                if any(a != b for a, b in hd.values()) or not all(
                        math.isfinite(b) for _, b in hd.values()):
                    raise AssertionError(f"spatial cae: rank {r}: float64 "
                                         f"HD at {SPATIAL_CAE_EVAL_MESH} "
                                         f"not bit-equal to one process: "
                                         f"{hd}")
                if max(v for k, v in gap.items()
                       if not k.endswith("_assd")) > DP_F64_REL or max(
                           v for k, v in gap.items()
                           if k.endswith("_assd")) > DP_ASSD_REL:
                    raise AssertionError(f"spatial cae: rank {r}: float64 "
                                         f"eval measures off one process: "
                                         f"{gap}")
        entry["eval"] = {dname: ev["metrics"]
                         for dname, ev in got["eval"].items()}
        ev_calls = {k: sum(n for key, n in got["eval_calls"].items()
                           if key[0] == k) for k in CAE_KERNELS}
        if ev_calls["K1"] != cae_step_launches()["K1"]:
            raise AssertionError(f"spatial cae: rank {r} eval K1 calls "
                                 f"{ev_calls}")
        entry["eval_k1"] = ev_calls["K1"]
        entry["eval_edt"] = got["eval"]["float32"]["sites"]

        # (c) LargeUnet3D at SPATIAL_CAE_MESH
        lf64 = large_one["float64"]
        ld = {side: dp_distance(got["large"][side], lf64)
              for side in LARGE_SPATIAL_SIDES}
        one_bf16 = dp_distance(large_one["bfloat16"], lf64)
        limit = {m: DP_FACTOR * one_bf16[m] + DP_FLOOR
                 for m in ("loss", "element", "layer", "stats")}
        print(f"spatial cae: rank {r} LargeUnet3D {LARGE_SPATIAL_DHW} "
              f"float64 vs one process {ld['float64']}; bfloat16 vs float64 "
              f"{ld['bfloat16']} (one process {one_bf16}, limits {limit}); "
              f"launches {got['large']['bfloat16']['launches']} (one process"
              f" {large_one['bfloat16']['launches']}); exchanges "
              f"{got['large']['bfloat16']['exchanges']}")
        f = ld["float64"]
        if max(f["loss"], f["element"], f["layer"], f["stats"],
               f["metrics"]) > DP_F64_REL:
            raise AssertionError(f"spatial cae: rank {r} LargeUnet3D float64 "
                                 f"off one process: {f}")
        over = {m: ld["bfloat16"][m] for m in limit
                if ld["bfloat16"][m] > limit[m]}
        if over or got["large"]["bfloat16"]["launches"] != \
                large_one["bfloat16"]["launches"]:
            raise AssertionError(f"spatial cae: rank {r} LargeUnet3D "
                                 f"bfloat16 beyond {limit}: {over}, or "
                                 f"launches differ")
        entry["large"] = {s: {m: v[m] for m in ("loss", "element", "layer",
                                                 "stats")}
                          for s, v in ld.items()}
        res["ranks"].append(entry)

    for kind in CAE_DP_LEARNERS:
        for side in SPATIAL_CAE_SIDES:
            a = ranks[0]["steps"][(kind, side)]
            for b in ranks[1:]:
                b = b["steps"][(kind, side)]
                if a["loss"] != b["loss"] or any(
                        not torch.equal(a["grads"][k], b["grads"][k])
                        for k in a["grads"]):
                    raise AssertionError(f"spatial cae: {kind} {side}: the "
                                         f"ranks' losses or gradients "
                                         f"differ")
    res["repeat"] = k4_repeat_check(torch, ranks)
    res["times"] = {dname: cae_step_kernel_times(
        torch, ranks[0]["calls"][("phase1", dname)], cae_dp_want("phase1"),
        f"spatial cae: phase 1 rank-step ({dname})")
        for dname in ("bfloat16", "float32")}
    return res


# CUDA graphs of the planned epoch (train/learner.py), the default path of a
# single-process run: each (phase, group) step captured after its first,
# eager, step and replayed.  run_phases pins the phases above to the eager
# loop (STROKE_TPU_DEVICE_CACHE=0): they count each kernel's launches at its
# wrapper and record its calls, which a replay makes without the wrapper.
GRAPH_SWITCH = "STROKE_TPU_DEVICE_CACHE"
GRAPH_EPOCHS = 3                 # (a): the U-Net's and phase 1's CLI runs
GRAPH_OTHER_EPOCHS = 2           # (d): the other learners' (replays: epoch 2)
GRAPH_LRSTEPS = ("--lrsteps", "1")   # an lr milestone inside every run
GRAPH_CURVE_REL = 1e-6           # where two eager runs differ: the
#                                  --distributed rule (PERF.md §2)
GRAPH_TIMED_STEPS = 10           # (b): steps timed a side, in turns ABBA
GRAPH_MAX_HOST_LAUNCHES = 3      # (b): host launches a replayed step
GRAPH_TRACED_STEPS = 3           # (b): steps a trace of each side holds
# CUDA API calls that put work on the card (torch.profiler's
# names), the host launches of (b)
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def graph_factor(epoch):
    """Phase 1's loss factor in the graph phase's runs: nonzero from the
    first epoch and moving each epoch (the CLI's curriculum starts at epoch
    26, past a short run)."""
    return 0.2 + 0.15 * epoch


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` for the body."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name = value`` for the body."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def graph_cli_run(torch, cli, argv, base, graphed, patch=None):
    """One training CLI run, planned and graphed or eager (the switch),
    under ``patch`` (a context manager factory) -> (learner, seconds)."""
    with env_set(GRAPH_SWITCH, "1" if graphed else "0"), (
            patch() if patch else contextlib.nullcontext()):
        t0 = time.perf_counter()
        learner = cli.train(argv(base))
        torch.cuda.synchronize()
    return learner, time.perf_counter() - t0


def same_files(a, b, files):
    """Which of ``files`` (suffixes) differ between bases ``a`` and ``b``."""
    return [f for f in files if not filecmp.cmp(a + f, b + f, shallow=False)]


def graph_equality(torch, work, what, cli, argv, files, patch=None,
                   eager_runs=2, epochs=GRAPH_EPOCHS):
    """(a) / (d): ``eager_runs`` eager CLI runs and one graphed run of the
    same seed and arguments.  Where two eager runs are bit-equal (files:
    the curves JSON, the .model and .optim files), the graphed run must
    equal them byte for byte; else (or with one eager run) its curves must
    be within GRAPH_CURVE_REL of the eager run's.  The graphed run must have
    replayed its steps, with the eager run's step counts."""
    runs = {}
    for tag in ["eager", "eager again"][:eager_runs] + ["graphed"]:
        base = os.path.join(work, f"graph_{what}_{tag.replace(' ', '_')}")
        runs[tag] = (*graph_cli_run(torch, cli, argv, base,
                                    tag == "graphed", patch), base)
    (eager, _, e_base), (graphed, g_s, g_base) = runs["eager"], \
        runs["graphed"]
    bit = eager_runs > 1 and not same_files(e_base, runs["eager again"][2],
                                            files)
    differ = same_files(e_base, g_base, files)
    gap = curve_gap(graphed, eager)
    replays = graphed.graph_replays
    print(f"graph {what}: {epochs} epochs; eager {runs['eager'][1]:.2f} s, "
          f"graphed {g_s:.2f} s; steps {graphed.step_counts} (eager "
          f"{eager.step_counts}); graphs {sorted(graphed._planned)}; "
          f"replays {replays}; two eager runs "
          + ("bit-equal" if bit else "not bit-equal" if eager_runs > 1
             else "(one run)")
          + f"; graphed vs eager: files differing {differ}, largest curve "
            f"gap {gap:.3e}")
    if graphed.step_counts != eager.step_counts or not replays:
        raise AssertionError(f"graph {what}: steps {graphed.step_counts} vs "
                             f"{eager.step_counts}, {replays} replays")
    if bit and differ:
        raise AssertionError(f"graph {what}: the eager runs are bit-equal "
                             f"and the graphed run's {differ} differ")
    if gap > GRAPH_CURVE_REL:
        raise AssertionError(f"graph {what}: curves {gap:.3e} off the "
                             f"eager run's (limit {GRAPH_CURVE_REL})")
    return dict(learner=graphed, eager=eager, base=g_base, bit=bit,
                rule="bit-equal" if bit else
                f"curves within {GRAPH_CURVE_REL}", differ=differ, gap=gap,
                seconds=g_s, eager_seconds=runs["eager"][1],
                replays=replays, steps=dict(graphed.step_counts))


def graph_control(torch, work, what, cli, argv, files, eager_base, eager,
                  patch, bit):
    """A control run, graphed under ``patch``, that must fail (a):
    capture raising, or its files (where the eager runs are bit-equal) or
    curves differing from the eager run's."""
    base = os.path.join(work, f"graph_control_{what}")
    try:
        learner, _ = graph_cli_run(torch, cli, argv, base, True, patch)
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"graph control {what}: the capture raised "
              f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
        return dict(raised=str(e).splitlines()[0][:200])
    differ = same_files(eager_base, base, files)
    gap = curve_gap(learner, eager)
    print(f"graph control {what}: {learner.graph_replays} "
          f"replays; files differing {differ}; largest curve gap {gap:.3e}")
    if (bit and not differ) or gap <= GRAPH_CURVE_REL:
        raise AssertionError(f"graph control {what}: it equals the eager "
                             f"run (files differing {differ}, gap {gap})")
    return dict(differ=differ, gap=gap)


def graph_step(torch, learner, training=True):
    """``learner``'s training (or validation) step of its loader's first
    group, as the planned pass runs it (a plan for one more epoch where
    the learner has none) -> ``step(eager=False)``: one step, replayed
    (eagerly with ``eager``), of a block that repeats the plan's first
    row vector as many times as the runner's buffer holds vectors, the
    cursor moving on as in a pass (back to 0, a seek, after the last)."""
    loader = (learner._dataloader_training if training
              else learner._dataloader_validation)
    if not learner._plans:
        learner._device_cache = True
        learner._n_epochs += 1
    plan = learner._plan_of(loader, learner._n_epochs - 1)
    run = learner._runner(loader, plan, training, 0)
    i, j, size = plan["bounds"][0]
    room = learner.PLAN_BLOCK * (j - i)
    first = plan["blocks"][0][0].view(-1, size + 1)[:1]
    block = first.expand(room, size + 1).reshape(room, 1, size + 1)
    at = {"k": 0}

    def step(eager=False):
        run(block, at["k"], eager)
        at["k"] = (at["k"] + 1) % room

    step.at = at
    return step


def kernel_of(name):
    """The hand kernel (K1-K5) that a profiler kernel name belongs to, or
    None."""
    group = next((g for frag, g in PROFILE_GROUPS if frag in name), "")
    return group.split()[0] if group.startswith("K") else None


def traced_steps(torch, run, what, reps=GRAPH_TRACED_STEPS):
    """``reps`` calls of ``run()`` in one torch.profiler trace -> (device
    busy ms a call, {kernel name: launches a call}, {host call that puts
    work on the card: calls a call}), the host calls read from the
    trace's CUDA API events (HOST_LAUNCH_CALLS)."""
    from torch.autograd import DeviceType

    prof = profiled(torch, lambda: (lead_in(torch),
                                    [run() for _ in range(reps)]), what)
    events = prof.key_averages()
    # the kernels, copies and sets, not the device spans of annotations
    # nor the lead-in's spin kernel
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and EDT_MARK not in e.key]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / reps
    kernels = {e.key: e.count / reps for e in device}
    # less the lead-in's own launch
    host = {e.key: (e.count - (e.key == "cudaLaunchKernel")) / reps
            for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith(HOST_LAUNCH_CALLS)}
    return busy, kernels, {k: n for k, n in host.items() if n}


def hand_kernels(kernels):
    """{K1-K5 kernel name: launches a call} of :func:`traced_steps`'s."""
    return {k: n for k, n in kernels.items() if kernel_of(k)}


def graph_vs_eager_trace(torch, what, step):
    """Traces of GRAPH_TRACED_STEPS calls of ``step`` replayed and run
    eagerly (:func:`graph_step`), each trace after one step outside it
    that sets the cursor to 0, so that the traced steps move it on as a
    pass does; traced again, up to PROFILE_ATTEMPTS times, while their
    K1-K5 launches by kernel name differ (a trace on the card's machine
    now and then lacks events, see :func:`device_ms`) -> ({side: (busy ms,
    kernels, host calls)}, {K: kernels a step}).  Raises if the counts
    never agree or no hand kernel ran: then a replay did not launch what
    the eager step does."""
    def traced(eager):
        step.at["k"] = 0
        step(eager)
        torch.cuda.synchronize()
        return traced_steps(torch, lambda: step(eager),
                            f"{what} ({'eager' if eager else 'graphed'})")

    for attempt in range(PROFILE_ATTEMPTS):
        sides = {"eager": traced(True), "graphed": traced(False)}
        hand = {side: hand_kernels(t[1]) for side, t in sides.items()}
        if hand["eager"] == hand["graphed"] and hand["eager"]:
            break
        print(f"{what}: K1-K5 launches a step differ between the traces "
              f"(eager {sum(hand['eager'].values()):g}, graphed "
              f"{sum(hand['graphed'].values()):g})"
              + (", tracing again" if attempt + 1 < PROFILE_ATTEMPTS
                 else ""))
    else:
        raise AssertionError(f"{what}: K1-K5 launches a step by kernel, "
                             f"eager {hand['eager']}, graphed "
                             f"{hand['graphed']}")
    by_kernel = {}
    for name, n in hand["graphed"].items():
        by_kernel[kernel_of(name)] = by_kernel.get(kernel_of(name), 0) + n
    other = {k: (sides["eager"][1].get(k, 0), sides["graphed"][1].get(k, 0))
             for k in set(sides["eager"][1]) | set(sides["graphed"][1])
             if sides["eager"][1].get(k, 0) != sides["graphed"][1].get(k, 0)}
    print(f"{what}: K1-K5 launches a step equal by kernel name in the "
          f"eager and the replayed step ({len(hand['graphed'])} names; "
          + ", ".join(f"{k} {n:g}" for k, n in sorted(by_kernel.items()))
          + f"); kernels a step eager "
            f"{sum(sides['eager'][1].values()):g}, graphed "
            f"{sum(sides['graphed'][1].values()):g}; other kernels whose "
            f"count differs (eager, graphed): "
          + ("; ".join(f"{k[:80]} {e:g}, {g:g}"
                       for k, (e, g) in sorted(other.items())) or "none"))
    for side, (_, _, host) in sides.items():
        print(f"{what}: host calls a step ({side}): "
              + (", ".join(f"{k} {n:g}" for k, n in sorted(host.items()))
                 or "none in the trace"))
    return sides, by_kernel


def graph_times(torch, what, learner):
    """(b): ``learner``'s graphed training step (a replay) against the
    same step run eagerly on the same rows, GRAPH_TIMED_STEPS each in turns
    (eager, graphed, graphed, eager): ms a step by CUDA events and host
    clock; from traces of each, the device's busy share, kernels a step,
    the K1-K5 launches by kernel name (equal on both sides, K1 among
    them; likewise in a traced validation step, K1 and K5 among them),
    and the host calls a step that put work on the card (one graph launch,
    at most GRAPH_MAX_HOST_LAUNCHES in all)."""
    step = graph_step(torch, learner)
    step()                         # warm-up and capture, where not yet made
    torch.cuda.synchronize()
    steps = {"eager": lambda: step(eager=True), "graphed": step}
    times = {k: [] for k in steps}
    for side in ("eager", "graphed", "graphed", "eager"):
        times[side].append(time_steps(torch, steps[side], GRAPH_TIMED_STEPS,
                                      f"graph {what} ({side})"))
    traces, by_kernel = graph_vs_eager_trace(
        torch, f"graph {what} train step", step)
    e_step = graph_step(torch, learner, training=False)
    e_step()
    torch.cuda.synchronize()
    _, eval_kernels = graph_vs_eager_trace(
        torch, f"graph {what} validation step", e_step)
    out = {}
    for side, ts in times.items():
        busy, kernels, host = traces[side]
        mean = sum(t[0] for t in ts) / len(ts)
        host_ms = sum(t[2] for t in ts) / len(ts)
        out[side] = dict(ms=mean, host_ms=host_ms,
                         ms_runs=[round(t[0], 4) for t in ts],
                         busy_ms=busy, busy_share=busy / host_ms,
                         kernels=sum(kernels.values()),
                         host_launches=sum(host.values()),
                         host_calls=host)
    out["hand_kernels"] = by_kernel
    out["eval_hand_kernels"] = eval_kernels
    graphed = out["graphed"]
    print(f"graph {what}: ms a step (CUDA events / host) eager "
          f"{out['eager']['ms']:.3f} / {out['eager']['host_ms']:.3f}, "
          f"graphed {graphed['ms']:.3f} / {graphed['host_ms']:.3f}; busy "
          f"{100 * out['eager']['busy_share']:.1f}% / "
          f"{100 * graphed['busy_share']:.1f}%; kernels a step "
          f"{out['eager']['kernels']:g} / {graphed['kernels']:g}; host "
          f"calls a step {out['eager']['host_launches']:g} / "
          f"{graphed['host_launches']:g}")
    if "K1" not in by_kernel or not {"K1", "K5"} <= set(eval_kernels):
        raise AssertionError(f"graph {what}: the replayed training step's "
                             f"{sorted(by_kernel)} lack K1, or the "
                             f"validation step's {sorted(eval_kernels)} "
                             f"lack K1 / K5")
    if graphed["host_calls"].get("cudaGraphLaunch") != 1:
        raise AssertionError(f"graph {what}: {graphed['host_calls']} host "
                             f"calls a replayed step, not one graph launch")
    if graphed["host_launches"] > GRAPH_MAX_HOST_LAUNCHES:
        raise AssertionError(f"graph {what}: {graphed['host_launches']:g} "
                             f"host launches a replayed step")
    return out


def graph_syncs(torch, what, learner):
    """(c): one eager run of the planned step's body (what the graphs
    captured), training and validation, under the sync debug mode "error":
    a host synchronisation in it raises."""
    phases = [True] + [False] * (learner._dataloader_validation
                                 is not None)
    for training in phases:
        step = graph_step(torch, learner, training)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(eager=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print(f"graph {what}: sync debug mode \"error\" over one eager run of "
          f"the planned step's body: "
          + ", ".join("training" if t else "validation" for t in phases)
          + " without a host synchronisation")
    return len(phases)


def graph_phase(torch, work, large_learner):
    """The planned epoch's CUDA graphs on the card.  (a) the U-Net CLI
    (reference width, bfloat16, batch 6, ``--profile``) and the phase-1 CLI
    (reference width, bfloat16, batch 4, the loss factor
    :func:`graph_factor`), GRAPH_EPOCHS epochs across an lr milestone (and
    phase 1's beta1 ramp), twice eagerly and once graphed
    (:func:`graph_equality`); the graphed run's trace holds its
    ``train_step`` ranges and K1; two U-Net controls that must fail: the
    learning rate kept a Python float (a capture bakes it in), the
    generator not registered with the graphs.  (b) ms a step graphed
    against eager (U-Net, phase 1, the 4-scale U-Net).  (c) the sync debug
    mode over each graphed learner's step body.  (d) the step learner,
    phase 2, the CTP CAE and phase 1 with structure batching, one eager and
    one graphed run each."""
    from stroke_prediction_tpu_torch.cli import (
        train_interpolationstep_after_reconstruction as step_cli)
    from stroke_prediction_tpu_torch.cli import (
        train_shape_prediction, train_shape_reconstruction)
    from stroke_prediction_tpu_torch.cli import (
        train_shape_reconstruction_with_ctp as ctp_cli)
    from stroke_prediction_tpu_torch.cli import train_unet_segmentation
    from stroke_prediction_tpu_torch.train import cae_learners
    from stroke_prediction_tpu_torch.train import learner as learner_mod
    from stroke_prediction_tpu_torch.utils.args import (
        get_args_shape_prediction_training, get_args_shape_training,
        get_args_step_training, get_args_unet_training)

    common = ["--synthetic", "--fold", *map(str, TRAIN_FOLD),
              "--validsetsize", "0.25", *GRAPH_LRSTEPS]
    cae_common = [*common, "--batchsize", str(CAE_TRAIN_BATCH)]

    def unet_argv(base):
        return get_args_unet_training(
            [os.path.join(work, "unused.model"), *common, "--batchsize",
             str(TRAIN_BATCH), "--epochs", str(GRAPH_EPOCHS), "--device",
             "cuda", "--channels", *map(str, CHANNELS), "--profile",
             base + "_profile", "--outbasepath", base])

    def cae_argv(base):
        return get_args_shape_training(
            [*cae_common, "--epochs", str(GRAPH_EPOCHS), "--outbasepath",
             base])

    def factored():
        return patched(cae_learners.CaeReconstructionLearner, "loss_factor",
                       lambda self, epoch: graph_factor(epoch))

    res = {}
    unet_files = ["_unet.json", "_unet.model", "_unet.optim",
                  "_unet_final.model"]
    res["unet"] = graph_equality(torch, work, "unet", train_unet_segmentation,
                                 unet_argv, unet_files)
    check_trace(res["unet"]["base"] + "_profile", "graph unet",
                res["unet"]["steps"]["train"] // GRAPH_EPOCHS)
    res["cae"] = graph_equality(
        torch, work, "cae", train_shape_reconstruction, cae_argv,
        ["_cae1.json", "_cae1.model", "_cae1.optim", "_cae1_final.model"],
        patch=factored)
    lr = float(res["cae"]["learner"]._optimizer.param_groups[0]["lr"])
    print(f"graph cae: loss factors "
          f"{[graph_factor(e) for e in range(GRAPH_EPOCHS)]}, final lr {lr:g}")

    # (b) and (c) on the learners of (a) and the 4-scale U-Net's
    res["times"] = {what: graph_times(torch, what, learner) for what, learner
                    in (("unet", res["unet"]["learner"]),
                        ("cae", res["cae"]["learner"]),
                        ("large unet", large_learner))}
    res["syncs"] = {what: graph_syncs(torch, what, learner) for what, learner
                    in (("unet", res["unet"]["learner"]),
                        ("cae", res["cae"]["learner"]),
                        ("large unet", large_learner))}

    # (d) the learners that share the planned path
    cae1 = os.path.join(work, "shape_train_cae1.model")
    width = [*map(str, CAE_CHANNELS)]
    short = ["--epochs", str(GRAPH_OTHER_EPOCHS)]
    others = {
        "step": (step_cli, lambda base: get_args_step_training(
            [cae1, *cae_common, *short, "--channelscae", *width,
             "--outbasepath", base]),
            ["_cae1step.json", "_cae1step.model", "_cae1step.optim"], None),
        "prediction": (train_shape_prediction,
                       lambda base: get_args_shape_prediction_training(
                           [cae1, *cae_common, *short, "--channelsenc",
                            *width, "--initbycae", "--outbasepath", base]),
                       ["_cae2.json", "_cae2_enc.model", "_cae2.optim"],
                       None),
        "ctp": (ctp_cli, lambda base: get_args_shape_training(
            [*cae_common, *short, "--channelscae", *map(str, CTP_CHANNELS),
             "--outbasepath", base]),
            ["_cae1.json", "_cae1.model", "_cae1.optim"], None),
        "grouped": (train_shape_reconstruction,
                    lambda base: get_args_shape_training(
                        [*cae_common, *short, "--outbasepath", base]),
                    ["_cae1.json", "_cae1.model", "_cae1.optim"],
                    lambda: env_set(GROUPED_SWITCH, "1"))}
    for what, (cli, argv, files, patch) in others.items():
        res[what] = graph_equality(torch, work, what, cli, argv, files,
                                   patch=patch, eager_runs=1,
                                   epochs=GRAPH_OTHER_EPOCHS)
        res["syncs"][what] = graph_syncs(torch, what, res[what]["learner"])

    # (a)'s controls, last: a failed capture leaves nothing for later
    def lr_as_float(optimizer, lr):
        for group in optimizer.param_groups:
            group["lr"] = float(lr)

    unet = res["unet"]
    controls = {
        "lr a Python float": lambda: patched(
            learner_mod, "set_learning_rate", lr_as_float),
        "generator not registered": lambda: patched(
            learner_mod.Learner, "_register_generators",
            lambda self, graph: None)}
    res["controls"] = {
        name: graph_control(torch, work, name.replace(" ", "_"),
                            train_unet_segmentation, unet_argv, unet_files,
                            os.path.join(work, "graph_unet_eager"),
                            unet["eager"], patch, unet["bit"])
        for name, patch in controls.items()}
    for what in ("unet", "cae", *others):
        for key in ("learner", "eager"):
            res[what].pop(key)
    return res


def host_cpu():
    """The host CPU's model name and the ISA extensions that set the CPU
    witnesses' sums (AVX-512, AMX)."""
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read()
    except OSError:
        return "unknown"
    names = [line.split(":", 1)[1].strip() for line in info.splitlines()
             if line.startswith("model name")]
    flags = [x for x in ("avx512f", "amx_tile") if f" {x}" in info]
    return f"{names[0] if names else 'unknown'} ({' '.join(flags) or '-'})"


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}; host CPU "
          f"{host_cpu()}, {os.cpu_count()} cores, CPU kernels "
          f"{torch.backends.cpu.get_cpu_capability()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stroke_prediction_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    start_witnesses()
    try:
        return run_phases(torch)
    finally:
        stop_witnesses()


def run_phases(torch):
    """The phases after the kernel build, the CPU witnesses' checks, the
    summary lines, the kernels line and the last line."""
    phase_s = {}

    def timed(name, phase, *args):
        t_phase = time.perf_counter()
        out = phase(torch, *args)
        phase_s[name] = round(time.perf_counter() - t_phase, 1)
        return out

    # the phases before the graph phase run the eager loop (see GRAPH_SWITCH)
    os.environ[GRAPH_SWITCH] = "0"
    k1 = timed("kernels (tester)", kernel_phase)
    k5 = timed("edt", edt_phase)
    train_k, s_err = timed("kernels (training)", train_kernel_phase)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        t_launches, case_ms, edt_case = timed("tester", slice_phase, work)
        cae = timed("cae tester", cae_phase, work)
        launches, step_ms, learner = timed("train", train_phase, work)
        step = timed("train step vs cpu", step_vs_cpu, learner)
        cae_tr = timed("cae train", cae_train_phase, work)
        cae_ln = timed("cae learners", cae_learners_phase, work, cae_tr)
        ctp = timed("cae ctp", cae_ctp_phase, work)
        sdm = timed("sdm", sdm_phase, work)
        large = timed("large unet", large_unet_phase, work)
        dp = timed("data parallel", dp_phase, work)
        spatial = timed("spatial", spatial_phase, work, dp)
        cae_dp = timed("cae data parallel", cae_dp_phase, work)
        spatial_cae = timed("spatial cae", spatial_cae_phase, work, dp,
                            cae_dp)
        grouped = timed("cae grouped", cae_grouped_phase, work)
        graphs = timed("graphs", graph_phase, work,
                       large["train"].pop("learner"))
        timed("cpu witnesses (waited for)", resolve_witnesses)

    def per_step(key, dtype="bfloat16"):
        """Sums over the layers whose route runs ``key`` in one step."""
        runs = {"K1": ("dw", "fused", "split"), "K2": ("fused",),
                "K3": ("split",), "K4": ("dw", "split")}[key]
        rows = [r for r in train_k[dtype] if r["route"] in runs]
        t_ops = sum(r["ops"][key] for r in rows) / PEAK_FLOPS[
            peak_key(key, dtype)]
        t_bytes = sum(r["bytes"][key] for r in rows) / PEAK_BYTES
        f64 = [r["f64"][key] for r in rows if key in r["f64"]]
        f64_dw = [r["f64"][key + " dW"] for r in rows
                  if key + " dW" in r["f64"]]
        return dict(
            {"max_rel_err_f64": max(f64)} if f64 else {},
            **({"max_rel_err_f64_dw": max(f64_dw)} if f64_dw else {}),
            max_abs_err=max(r["err"][key] for r in rows),
            max_abs_err_f32=max(r["err"][key] for r in train_k["float32"]
                                if key in r["err"]),
            ms=sum(r["ms"][key] for r in rows),
            plain_ms=sum(r["plain"][key] for r in rows),
            library_ms=sum(r["lib"][key] for r in rows),
            bound_ms=sum(r["bound"][key][0] for r in rows),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            gflop=sum(r["ops"][key] for r in rows) / 1e9,
            layers=[r["layer"] for r in rows])

    for dtype in ("float32", "bfloat16"):
        print(f"per training step, {dtype}, summed over the layers each "
              f"kernel runs on (ms kernel / plain / cuDNN / bound; float32 "
              f"K1-K4 bound in 3xTF32): " +
              "; ".join(f"{key} {v['ms']:.4f} / {v['plain_ms']:.4f} / "
                        f"{v['library_ms']:.4f} / {v['bound_ms']:.4f} "
                        f"({v['bound_by']}, {v['gflop']:.2f} GFLOP, "
                        f"L{v['layers']})"
                        for key, v in ((key, per_step(key, dtype))
                                       for key in ("K1", "K2", "K3", "K4"))))
    wrapper_of = {"K1": "conv3x3", "K2": "conv3x3_bwd_fused",
                  "K3": "conv3x3_bwd_dx", "K4": "conv3x3_bwd_dw"}

    def cae_train_use(key):
        """A kernel's use on the CAE training path: its launches in the CLI
        run and a step, and per step in each type the layers' sums."""
        return {"launches": cae_tr["launches"][wrapper_of[key]],
                "launches_per_step": cae_tr["per_step"][key],
                **{dname: dict({f: cae_tr["times"][dname][key][f] for f in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "gflop")}, max_abs_err=cae_tr["recorded"][dname][key])
                   for dname in ("bfloat16", "float32")},
                "per": f"one CAE training step (batch {CAE_TRAIN_BATCH}, "
                       f"channels 1 16 24 32 100 200 1, 28x128x128 masks, "
                       f"3 encodes + 4 decodes): each layer's time times "
                       f"its calls; max_abs_err: every call of one step on "
                       f"its own inputs vs plain; bound_ms in bf16 or "
                       f"3xTF32; launches: the CLI run's {cae_tr['steps']}"}

    def ctp_use(key):
        """A kernel's use on the CTP training path: its launches in the CLI
        run and a step, per step in each type the layers' sums, and at
        the entry conv (C_in 3) its own times where it runs there."""
        use = {"launches": ctp["launches"][wrapper_of[key]],
               "launches_per_step": ctp["per_step"][key],
               **{dname: dict({f: ctp["times"][dname][key][f] for f in (
                   "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "gflop")}, max_abs_err=ctp["recorded"][dname][key])
                  for dname in ("bfloat16", "float32")},
               "per": f"one CTP training step (batch {CAE_TRAIN_BATCH}, "
                      f"channels 3 16 24 32 100 200 1, 28x128x128 masks "
                      f"with CBV and TTD cropped from 68x168x168): each "
                      f"layer's time times its calls; max_abs_err: every "
                      f"call of one step on its own inputs vs plain; "
                      f"launches: the CLI run's {ctp['steps']}"}
        entry = {dname: {f: t[key][f] for f in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "bound_by")}
                 for dname, t in ctp["entry_times"].items() if key in t}
        if entry:
            use["entry_conv_c_in_3"] = dict(entry, per="the entry conv "
                                            "(3 -> 16, 4x28x128x128, once a "
                                            "step per encode: x3)")
        return use

    def learner_use(key, kind):
        """A kernel's use on a CAE learner's path (step learning or phase
        2): its launches in the CLI run and a step, and per step the
        layers' sums (both storage types)."""
        r = cae_ln[kind]
        t = r["times"][key]
        return {"launches": r["launches"][wrapper_of[key]],
                "launches_per_step": r["per_step"].get(key, 0),
                "launches_per_step_by_type": {
                    dt: n for (k, dt), n in r["per_step_by_type"].items()
                    if k == key},
                **{f: t[f] for f in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "gflop")},
                "max_abs_err": r["worst"][key],
                "per": f"one {kind} training step (batch "
                       f"{CAE_TRAIN_BATCH}, channels 1 16 24 32 100 200 1, "
                       f"28x128x128; "
                       + ("the whole CAE bfloat16, frozen but the step "
                          "head: K3 alone at the interpolation decode"
                          if kind == "step" else
                          "a bfloat16 encoder on two inputs, the frozen "
                          "float32 CAE: K3 alone at its three inputs "
                          "decodes")
                       + "): each layer's time times its calls; "
                       f"max_abs_err: every call of one step on its own "
                       f"inputs vs plain; launches: the CLI run's "
                       f"{r['steps']}"}

    def large_use(key):
        """A kernel's use on the 4-scale U-Net's path: its launches in the
        training run and a step, per step in each type the layers' sums,
        the widths it ran at; K1 also per tester case."""
        tr = large["train"]
        use = {"launches": tr["launches"][wrapper_of[key]],
               "launches_per_step": tr["per_step"][key],
               "widths_c_in_c_out": tr["widths"].get(key, []),
               **{dname: dict({f: tr["times"][dname][key][f] for f in (
                   "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "gflop")}, max_abs_err=tr["recorded"][dname][key])
                  for dname in ("bfloat16", "float32")},
               "per": f"one LargeUnet3D training step (channels "
                      f"{' '.join(map(str, LARGE_CHANNELS))}, batch "
                      f"{TRAIN_BATCH}, patch 116x124x124): each layer's "
                      f"time times its calls; max_abs_err: every call of one "
                      f"step on its own inputs vs plain; launches: the "
                      f"learner's {LARGE_EPOCHS} epochs"}
        if key == "K1":
            t = large["tester"]["k1"]
            use["tester"] = dict(
                {f: t[f] for f in ("launches", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "max_rel_err_f64")},
                launches_in_cli_run=large["tester"]["launches"]["conv3x3"],
                gflop=t["ops"] / 1e9,
                widths_c_in_c_out=large["tester"]["widths"],
                per="one large U-Net tester case (float32, batch 1, "
                    "116x220x220 -> 28x132x132; each layer's time times its "
                    "calls; bound_ms in 3xTF32)")
        return use

    def dp_use(key):
        """A kernel's use on the data-parallel path: its launches in the
        --distributed CLI run (NCCL, rank 0 of 1), a rank's launches a step
        in (b), and per step at a rank's batch the layers' sums (both
        types)."""
        return {"launches": dp["cli"]["launches"][wrapper_of[key]],
                "launches_per_step_per_rank": [
                    r["launches_per_step"][wrapper_of[key]]
                    for r in dp["ranks"]],
                **{side: dict({f: dp["times"][side][key][f] for f in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "gflop")}, max_abs_err=dp["recorded"][side][key])
                   for side in ("bfloat16", "float32")},
                "per": f"one data-parallel training step of one rank "
                       f"({DP_WORLD} ranks, global batch {TRAIN_BATCH}, "
                       f"{TRAIN_BATCH // DP_WORLD} a rank, patch 68x104x104):"
                       f" each layer's time times its calls; max_abs_err: "
                       f"every call of one step at a rank's shapes vs "
                       f"plain; launches: the --distributed CLI run's "
                       f"{DP_EPOCHS} epochs"}

    def spatial_use(key):
        """A kernel's use on the spatial path: a rank's launches a bfloat16
        rank-step, its largest error against plain over every call of a
        float32 and a bfloat16 rank-step, and per rank-step at rank 0's
        shapes the layers' sums (both types)."""
        return {"launches_per_step_per_rank": [
                    r["launches_per_step"][wrapper_of[key]]
                    for r in spatial["ranks"]],
                **{side: dict({f: spatial["times"][side][key][f] for f in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "gflop")}, max_abs_err=max(
                        r["recorded"][side][key] for r in spatial["ranks"]))
                   for side in ("bfloat16", "float32")},
                "per": f"one training step of one rank at {{data: "
                       f"{SPATIAL_MESH[0]}, space: {SPATIAL_MESH[1]}}} "
                       f"(global batch {TRAIN_BATCH}, patch 68x104x104, "
                       f"rank 0's rows and block of H with its halo rows): "
                       f"each layer's time times its calls; max_abs_err: "
                       f"every call of a float32 and a bfloat16 rank-step "
                       f"on every rank vs plain"}

    def spatial_cae_use(key):
        """A kernel's use on the spatial CAE path: each learner's launches
        a bfloat16 rank-step (rank 0; every rank's equal one process's),
        its largest error against plain over every call of the four
        learners' float32 and bfloat16 rank-steps on every rank, per
        phase-1 rank-step at rank 0's shapes the layers' sums (both
        types), and K4's and K2's repeat checks."""
        use = {"launches_per_rank_step": {
                   kind: spatial_cae["ranks"][0]["calls"][kind][key]
                   for kind in CAE_DP_LEARNERS},
               **{side: dict({f: spatial_cae["times"][side][key][f]
                              for f in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "gflop")},
                             max_abs_err=max(
                                 r["recorded"][side][key]
                                 for r in spatial_cae["ranks"]))
                  for side in ("bfloat16", "float32")},
               "per": f"one phase-1 training step of one rank at {{data: "
                      f"{SPATIAL_CAE_MESH[0]}, space: {SPATIAL_CAE_MESH[1]}"
                      f"}} (global batch {CAE_DP_BATCH}, 28x128x128, rank "
                      f"0's rows and block of H with its halo rows): each "
                      f"layer's time times its calls; max_abs_err: every "
                      f"call of the four learners' float32 and bfloat16 "
                      f"rank-steps on every rank vs plain"}
        rep = spatial_cae["repeat"]
        if key == "K4":
            use["repeat_check"] = {
                "launches": rep["launches"],
                "repeat_shape_max_abs_err": rep["repeat_shape"],
                "per": f"{K4_REPEATS} launches a type at {K4_REPEAT_SHAPE} "
                       f"and {KERNEL_REPEATS} at each K2 / K4 rank-step "
                       f"shape, partials NaN before each, bit-equal; the "
                       f"rank-steps' K4 calls over {SPATIAL_REPEATS} runs"}
        return use

    def grouped_use(key):
        """A kernel's use on the grouped CAE path (structure batching on):
        its launches in one unrecorded phase-1 step, per step in each type
        and per rank's batch of 2 the layers' sums, and K2 at the entry
        convs (C_in 1 and 3)."""
        g = grouped["kernels"]
        fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "gflop")
        use = {"launches": g["launches"][wrapper_of[key]],
               "launches_per_step": GROUPED_STEP[key],
               "bfloat16": dict({f: g["times"][key][f] for f in fields},
                                max_abs_err=g["worst"]["bfloat16"][key]),
               "float32": {"max_abs_err": g["worst"]["float32"][key]},
               "rank_step": {f: g["rank_times"][key][f] for f in fields},
               "per": f"one grouped phase-1 training step (batch "
                      f"{CAE_DP_BATCH}, channels 1 16 24 32 100 200 1, "
                      f"28x128x128; one encode of 3 structures, one decode "
                      f"of 4), bfloat16: each layer's time times its calls; "
                      f"rank_step: the same at a rank's batch of 2; "
                      f"max_abs_err: every call of a phase-1 and a CTP step "
                      f"in the type vs plain; launches: the wrappers' count "
                      f"in one unrecorded bfloat16 step"}
        if key == "K2":
            for c_in in (1, 3):
                use[f"entry_conv_c_in_{c_in}"] = {
                    dname: dict({f: g["entry"][(c_in, dname)]["K2"][f]
                                 for f in fields[:5]},
                                gflop=g["entry"][(c_in, dname)]["K2"]["ops"]
                                / 1e9)
                    for dname in ("bfloat16", "float32")}
        return use

    def graphed_use(key):
        """``key``'s kernels a replayed step by trace (graph phase (b)),
        each equal to the same step body's run eagerly."""
        return {"per": "kernels of this hand kernel a replayed step, read "
                       "from torch.profiler traces of three replays, equal "
                       "by kernel name to the step body run eagerly",
                **{phase: {what: t[field].get(key, 0)
                           for what, t in graphs["times"].items()}
                   for phase, field in (("train", "hand_kernels"),
                                        ("validation",
                                         "eval_hand_kernels"))}}

    csrc = "stroke_prediction_tpu_torch/ops/csrc/"
    s2d = "stroke_prediction_tpu/ops/pallas/s2d.py:"
    step_per = (f"one training step (bfloat16, batch {TRAIN_BATCH}, patch "
                f"68x104x104): the layers the route sends here")
    f32_step_per = (f"one float32 training step (batch {TRAIN_BATCH}, patch "
                    f"68x104x104): the layers the route sends here; "
                    f"bound_ms in 3xTF32")
    kernels = [
        dict({"name": "conv3x3_fwd", "route": "cuda",
              "source": csrc + "conv3x3_fwd_tc.cu", "replaces": s2d + "387",
              "launches": launches["conv3x3"]}, **per_step("K1"),
             source_float32=csrc + "conv3x3_fwd_f32_tc.cu",
             per=step_per + " (all 10)",
             tester={"launches": t_launches["conv3x3"], "ms": k1["ms"],
                     "plain_ms": k1["plain_ms"],
                     "library_ms": k1["library_ms"],
                     "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
                     "bound_ms_cuda_cores": k1["bound_ms_cuda_cores"],
                     "max_abs_err": k1["max_abs_err"],
                     "max_rel_err_f64": k1["max_rel_err_f64"],
                     "per": "one tester case (float32, batch 1; bound_ms "
                            "in 3xTF32)"},
             cae={"launches": cae["launches"]["conv3x3"],
                  "launches_per_case": cae["k1"]["launches"],
                  "gflop": cae["k1"]["ops"] / 1e9,
                  **{key: cae["k1"][key] for key in (
                      "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                      "max_abs_err", "max_rel_err_f64")},
                  "in_case_device_ms": cae["k1_busy"][0],
                  "per": "one CAE tester case (float32, batch 1, channels "
                         "1 16 24 32 100 200 1, 28x128x128 masks; each "
                         "layer's time times its calls; bound_ms in "
                         "3xTF32; launches: the CLI run's 3 cases; "
                         "in_case_device_ms: K1 inside the profiled "
                         "cases)"},
             cae_curve={"launches": cae["k1_curve"]["launches"],
                        "gflop": cae["k1_curve"]["ops"] / 1e9,
                        **{key: cae["k1_curve"][key] for key in (
                            "ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "max_abs_err", "max_rel_err_f64")},
                        "per": "the curve tester's three sweeps of one case "
                               "(core and penumbra at batch 1, the 6, 9 "
                               "and 11 interpolations decoded as one "
                               "batch each); each layer's time times its "
                               "calls; bound_ms in 3xTF32"},
             cae_train=cae_train_use("K1"),
             cae_step=learner_use("K1", "step"),
             cae_prediction=learner_use("K1", "prediction"),
             cae_ctp=ctp_use("K1"), large_unet=large_use("K1"),
             data_parallel=dp_use("K1"), spatial=spatial_use("K1"),
             spatial_cae=spatial_cae_use("K1"),
             cae_data_parallel=cae_dp_use(cae_dp, "K1"),
             cae_grouped=grouped_use("K1"), graphed=graphed_use("K1")),
        dict({"name": "conv3x3_bwd_fused", "route": "cuda",
              "source": csrc + "conv3x3_bwd_tc.cu", "replaces": s2d + "491",
              "launches": launches["conv3x3_bwd_fused"]}, **per_step("K2"),
             source_float32=csrc + "conv3x3_bwd_f32_tc.cu", per=step_per,
             float32=dict(per_step("K2", "float32"), per=f32_step_per),
             cae_train=cae_train_use("K2"),
             cae_prediction=learner_use("K2", "prediction"),
             cae_ctp=ctp_use("K2"),
             large_unet={"launches": large["train"]["launches"][
                 "conv3x3_bwd_fused"], "launches_per_step": 0,
                 "per": "K2 does not run on LargeUnet3D: every 3^3 conv but "
                        "the entry is over FUSED_DW_BYTES (split route), "
                        "the entry conv takes dW only"},
             data_parallel=dp_use("K2"), spatial=spatial_use("K2"),
             spatial_cae=spatial_cae_use("K2"),
             cae_data_parallel=cae_dp_use(cae_dp, "K2"),
             cae_grouped=grouped_use("K2"), graphed=graphed_use("K2")),
        dict({"name": "conv3x3_bwd_dx", "route": "cuda",
              "source": csrc + "conv3x3_bwd_dx_tc.cu",
              "replaces": s2d + "589",
              "launches": launches["conv3x3_bwd_dx"]}, **per_step("K3"),
             source_float32=csrc + "conv3x3_bwd_dx_f32_tc.cu", per=step_per,
             float32=dict(per_step("K3", "float32"), per=f32_step_per),
             cae_train=cae_train_use("K3"),
             cae_step=learner_use("K3", "step"),
             cae_prediction=learner_use("K3", "prediction"),
             cae_ctp=ctp_use("K3"), large_unet=large_use("K3"),
             data_parallel=dp_use("K3"), spatial=spatial_use("K3"),
             spatial_cae=spatial_cae_use("K3"),
             cae_data_parallel=cae_dp_use(cae_dp, "K3"),
             cae_grouped=grouped_use("K3"), graphed=graphed_use("K3")),
        dict({"name": "conv3x3_bwd_dw", "route": "cuda",
              "source": csrc + "conv3x3_bwd_dw_tc.cu",
              "replaces": s2d + "623",
              "launches": launches["conv3x3_bwd_dw"]}, **per_step("K4"),
             source_float32=csrc + "conv3x3_bwd_dw_f32_tc.cu", per=step_per,
             float32=dict(per_step("K4", "float32"), per=f32_step_per),
             cae_train=cae_train_use("K4"),
             cae_prediction=learner_use("K4", "prediction"),
             cae_ctp=ctp_use("K4"), large_unet=large_use("K4"),
             data_parallel=dp_use("K4"), spatial=spatial_use("K4"),
             spatial_cae=spatial_cae_use("K4"),
             cae_data_parallel=cae_dp_use(cae_dp, "K4"),
             cae_grouped=grouped_use("K4"), graphed=graphed_use("K4")),
        {"name": "edt_sites", "route": "cuda",
         "source": csrc + "edt_sites.cu",
         "replaces": "stroke_prediction_tpu/ops/edt.py:80",
         "launches": launches["edt_sites"],
         "graphed": graphed_use("K5"),
         "max_abs_err": k5["max_abs_err"],
         "ms": EDT_PER_STEP * k5[EDT_VALID]["ms"],
         "plain_ms": EDT_PER_STEP * k5[EDT_VALID]["plain_ms"],
         "bound_ms": EDT_PER_STEP * k5[EDT_VALID]["bound_ms"],
         "bound_by": k5[EDT_VALID]["bound_by"], "library_ms": None,
         "parent_ms": EDT_PER_STEP * k5[EDT_VALID]["parent_ms"],
         "kernels_per_call": k5[EDT_VALID]["kernels"],
         "parent_kernels_per_call": k5[EDT_VALID]["parent_kernels"],
         "per": f"one validation step: {EDT_PER_STEP} x one measured "
                f"{EDT_VALID} EDT (two kernels a call), device time; "
                f"parent = the parent composition (its scan, copies and "
                f"sqrt around today's single pass); bound = the bytes, "
                f"5 a voxel, or an exact O(n) envelope's operations",
         "tester": {"launches": t_launches["edt_sites"],
                    "ms": EDT_PER_STEP * k5[EDT_TESTER]["ms"],
                    "plain_ms": EDT_PER_STEP * k5[EDT_TESTER]["plain_ms"],
                    "bound_ms": EDT_PER_STEP * k5[EDT_TESTER]["bound_ms"],
                    "parent_ms": EDT_PER_STEP * k5[EDT_TESTER]["parent_ms"],
                    "in_case_ms_and_kernels": edt_case,
                    "per": f"one tester case: {EDT_PER_STEP} x one measured "
                           f"{EDT_TESTER} EDT; in_case: the EDT per case "
                           f"inside the tester's own profiled cases"},
         "cae": {"launches": cae["launches"]["edt_sites"],
                 "per": f"the CAE shape tester CLI's 3 cases, "
                        f"{CAE_EDT_PER_CASE} a case"},
         "cae_train": {"launches": cae_tr["launches"]["edt_sites"],
                       "max_abs_err": 0.0,
                       **{key: CAE_EDT_PER_CASE * k5[EDT_CAE_VALID][key]
                          for key in ("ms", "plain_ms", "bound_ms")},
                       "bound_by": k5[EDT_CAE_VALID]["bound_by"],
                       "per": f"one CAE training validation batch: "
                              f"{CAE_EDT_PER_CASE} x one measured "
                              f"{EDT_CAE_VALID} EDT, device time; "
                              f"max_abs_err: the batch's "
                              f"{CAE_EDT_PER_CASE} calls on their own "
                              f"masks vs plain (equal); launches: the CLI "
                              f"run's validation batches"},
         "cae_learners": {kind: {
             "launches": cae_ln[kind]["launches"]["edt_sites"],
             "launches_per_validation_batch": CAE_EDT_PER_CASE,
             "max_abs_err": 0.0,
             "per": f"the {kind} CLI run's validation batches; every call "
                    f"of one batch on its own masks vs plain (equal)"}
             for kind in ("step", "prediction")},
         "cae_ctp": {"launches": ctp["launches"]["edt_sites"],
                     "launches_per_validation_batch": CAE_EDT_PER_CASE,
                     "max_abs_err": 0.0,
                     "per": "the CTP CLI run's validation batches; every "
                            "call of one batch on its own masks vs plain "
                            "(equal)"},
         "sdm": {"launches": sum(r["launches"]["edt_sites"]
                                 for r in sdm["runs"].values()),
                 "launches_per_case": sdm["k5"]["launches"],
                 "max_abs_err": 0.0,
                 **{key: sdm["k5"][key] for key in (
                     "ms", "plain_ms", "bound_ms", "bound_by")},
                 "library_ms": None,
                 "per": f"one SDM tester case: the edt_sites calls at "
                        f"{sdm['k5']['shapes']} (the SDM's four EDTs, the "
                        f"three measures' two directions), device time; "
                        f"max_abs_err: every call of the CLI runs' cases on "
                        f"its own masks vs plain (equal); launches: the "
                        f"three CLI runs' {len(SDM_FOLD) + 2} cases"},
         "large_unet": {
             "launches": (large["tester"]["launches"]["edt_sites"]
                          + large["train"]["launches"]["edt_sites"]),
             "launches_per_case": EDT_PER_STEP, "max_abs_err": 0.0,
             "per": f"the large U-Net tester's 3 cases and the learner's "
                    f"validation steps, {EDT_PER_STEP} a case or step; "
                    f"every call of one tester case at (1, 28, 132, 132) "
                    f"vs plain (equal)"},
         "spatial_cae": {
             "launches_per_rank_step": CAE_EDT_PER_CASE,
             "eval_launches_per_rank": [
                 sum(r["eval_edt"].values()) for r in spatial_cae["ranks"]],
             "max_abs_err": 0.0,
             "per": f"each rank's CAE training steps and eval_step at "
                    f"{SPATIAL_CAE_EVAL_MESH}: the masks' whole H gathered, "
                    f"{CAE_EDT_PER_CASE} calls on the global volume of the "
                    f"rank's rows; every call on its own masks vs plain "
                    f"(equal)"},
         "data_parallel": {
             "launches": dp["cli"]["launches"]["edt_sites"],
             "launches_per_step_per_rank": [
                 r["launches_per_step"]["edt_sites"] for r in dp["ranks"]],
             "per": f"the --distributed CLI run's validation steps, "
                    f"{EDT_PER_STEP} a step; in (b) each rank's training "
                    f"step with distances, the maximum reduced over the "
                    f"ranks"},
         "cae_data_parallel": {
             "launches": sum(r["launches"]["edt_sites"]
                             for r in cae_dp["cli"].values()),
             "launches_per_rank_step": CAE_EDT_PER_CASE, "max_abs_err": 0.0,
             "per": f"the phase-1 and phase-2 --distributed CLI runs' "
                    f"validation batches, {CAE_EDT_PER_CASE} a batch; in (b) "
                    f"each rank's training step with distances, every call "
                    f"on its own masks vs plain (equal), the maximum reduced "
                    f"over the ranks"},
         "single_pass": {"name": "edt_parabola",
                         "launches": launches["edt_parabola"],
                         "ms": k5[(3584, 64)]["ms"],
                         "host_ms": k5[(3584, 64)]["host_ms"],
                         "plain_ms": k5[(3584, 64)]["plain_ms"],
                         "bound_ms": k5[(3584, 64)]["bound_ms"],
                         "bound_by": k5[(3584, 64)]["bound_by"],
                         "per": "one (3584, 64) pass (kernel B without the "
                                "sqrt), device time"}},
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(f"tester ms per case (card, after the first case): {case_ms:.2f}")
    print(f"CAE tester ms per case (card, after the first case): "
          f"{cae['infer_ms']:.2f} to metrics, {cae['total_ms']:.2f} with the "
          f"dumps; device busy {cae['busy_ms']:.3f} ms; K1 "
          f"{cae['k1']['launches']} launches a case, {cae['k1']['ms']:.4f} ms "
          f"(plain {cae['k1']['plain_ms']:.4f}, cuDNN "
          f"{cae['k1']['library_ms']:.4f}, bound {cae['k1']['bound_ms']:.4f});"
          f" curve sweeps (steps, ms) {cae['sweeps']}")
    print(f"training ms per step (card, bfloat16, mean of {TIMED_STEPS} "
          f"back to back, CUDA events): {step_ms:.3f}; card vs CPU float32 "
          f"step {step}; 's', 3 -> 4 and 192 -> 64 cases max|err| (and the "
          f"float32 K2, K3 and K4 vs f64, of max|ref|) {s_err}")
    print(f"CAE training ms per step (card, bfloat16, batch "
          f"{CAE_TRAIN_BATCH}, mean of {CAE_TIMED_STEPS} back to back, CUDA "
          f"events): {cae_tr['step_ms']['mean']:.3f} (host "
          f"{cae_tr['step_ms']['host']:.3f}); device busy "
          f"{cae_tr['busy']['busy_ms']:.3f} ms in {cae_tr['busy']['kernels']}"
          f" kernels a step; card vs CPU CAE step {cae_tr['vs_cpu']}")
    for kind in ("step", "prediction"):
        r = cae_ln[kind]
        print(f"CAE {kind} learner ms per step (card, bfloat16, batch "
              f"{CAE_TRAIN_BATCH}, mean of {CAE_TIMED_STEPS} back to back, "
              f"CUDA events): {r['step_ms']['mean']:.3f} (std "
              f"{r['step_ms']['std']:.3f}, host {r['step_ms']['host']:.3f}); "
              f"device busy {r['busy']['busy_ms']:.3f} ms in "
              f"{r['busy']['kernels']} kernels a step; K1-K4 per step "
              + "; ".join(f"{k} x{t['launches']} {t['ms']:.4f} ms (plain "
                          f"{t['plain_ms']:.4f}, cuDNN {t['library_ms']:.4f},"
                          f" bound {t['bound_ms']:.4f})"
                          for k, t in r["times"].items() if t["launches"])
              + f"; card vs CPU float32 step {cae_ln['vs_cpu'][kind]}")
    print(f"CTP CAE training ms per step (card, bfloat16, batch "
          f"{CAE_TRAIN_BATCH}, mean of {CAE_TIMED_STEPS} back to back, CUDA "
          f"events): {ctp['step_ms']['mean']:.3f} (std "
          f"{ctp['step_ms']['std']:.3f}, host {ctp['step_ms']['host']:.3f}); "
          f"device busy {ctp['busy']['busy_ms']:.3f} ms in "
          f"{ctp['busy']['kernels']} kernels a step; K1-K4 per step "
          + "; ".join(f"{k} x{t['launches']} {t['ms']:.4f} ms (plain "
                      f"{t['plain_ms']:.4f}, cuDNN {t['library_ms']:.4f}, "
                      f"bound {t['bound_ms']:.4f})"
                      for k, t in ctp["times"]["bfloat16"].items()
                      if t["launches"])
          + f"; the entry conv (C_in 3) {ctp['entry_times']}; card vs CPU "
          f"float32 step {ctp['vs_cpu']}")
    print("SDM tester per case (card): " + "; ".join(
        f"{name}: {r['to_measures_ms']:.2f} ms to the measures, "
        f"{r['with_dumps_ms']:.2f} ms with the dumps"
        for name, r in sdm["runs"].items())
        + f"; one case device busy {sdm['case']['busy_ms']:.3f} ms in "
        f"{sdm['case']['kernels']} kernels (host {sdm['case']['wall_ms']:.2f}"
        f" ms); edt_sites {sdm['k5']}")
    lt, ltr = large["tester"], large["train"]
    print(f"large U-Net (channels {' '.join(map(str, LARGE_CHANNELS))}): "
          f"tester {lt['infer_ms']:.2f} ms a case to the measures, "
          f"{lt['total_ms']:.2f} with the dumps (a case's dumps by codec, s: "
          f"{lt['dump_s']}); K1 {lt['k1']['launches']} launches a case, "
          f"{lt['k1']['ms']:.4f} ms (plain {lt['k1']['plain_ms']:.4f}, cuDNN "
          f"{lt['k1']['library_ms']:.4f}, bound {lt['k1']['bound_ms']:.4f}); "
          f"card vs CPU 92^3 {lt['vs_cpu']:.3e}; training ms per step "
          f"(bfloat16, batch {TRAIN_BATCH}, mean of {LARGE_TIMED_STEPS} back "
          f"to back, CUDA events) {ltr['step_ms']['mean']:.3f} (std "
          f"{ltr['step_ms']['std']:.3f}, host {ltr['step_ms']['host']:.3f}); "
          f"device busy {ltr['busy']['busy_ms']:.3f} ms in "
          f"{ltr['busy']['kernels']} kernels a step; "
          f"{ltr['step_rate']:.2f} volumes/s by those steps; the learner's "
          f"[throughput] line {ltr['throughput']:.2f} volumes/sec/chip (one "
          f"traced pass of one step); K1/K3/K4 per step "
          + "; ".join(f"{k} x{t['launches']} {t['ms']:.4f} ms (plain "
                      f"{t['plain_ms']:.4f}, cuDNN {t['library_ms']:.4f}, "
                      f"bound {t['bound_ms']:.4f})"
                      for k, t in ltr["times"]["bfloat16"].items()
                      if t["launches"])
          + f"; card vs CPU float32 step {ltr['vs_cpu']}; nifti codec: "
          f"{nifti_codec()}")
    print(f"data parallel: --distributed CLI (NCCL) curves vs plain "
          f"{dp['cli']['curve_gap']:.3e} (two plain runs "
          f"{dp['cli']['curve_spread']:.3e}); {DP_WORLD} gloo ranks on the "
          f"one card: " + "; ".join(
              f"rank {i} float64 vs one process {r['vs_f64']['float64']}, "
              f"bfloat16 step {r['timing']['step_ms']:.3f} ms (collectives "
              f"{r['timing']['collective_ms']:.3f} of "
              f"{r['timing']['instrumented_ms']:.3f} ms instrumented, "
              f"{r['timing']['calls']:.0f} all_reduce a step)"
              for i, r in enumerate(dp["ranks"])))
    print("CAE data parallel: --distributed CLIs (NCCL) curves vs plain "
          + "; ".join(f"{k} {r['curve_gap']:.3e} (two plain runs of "
                      f"phase 2 {r['curve_spread']:.3e} apart)"
                      if k == "prediction" else f"{k} {r['curve_gap']:.3e}"
                      for k, r in cae_dp["cli"].items())
          + f"; {DP_WORLD} gloo ranks on the one card, bfloat16 ms per "
          f"rank-step (batch {CAE_DP_BATCH // DP_WORLD} a rank; collectives "
          f"ms of instrumented ms, all_reduce calls a step): " + "; ".join(
              f"rank {i} " + ", ".join(
                  f"{kind} {t['step_ms']:.3f} ({t['collective_ms']:.3f} of "
                  f"{t['instrumented_ms']:.3f}, {t['calls']:.0f})"
                  for kind, t in r["timing"].items())
              for i, r in enumerate(cae_dp["ranks"])))
    print(f"spatial (H over the ranks, {SPATIAL_WORLD} gloo ranks on the one "
          f"card): " + "; ".join(
              f"rank {i} {SPATIAL_MESH} float64 vs one process "
              f"{r['vs_f64']['float64']['element']:.3e}, float32 "
              f"{r['vs_f64']['float32']['element']:.3e}, bfloat16 "
              f"{r['vs_f64']['bfloat16']['element']:.3e} (controls "
              f"{r['vs_f64'][SPATIAL_SIDES[3]]['element']:.3e}, "
              f"{r['vs_f64'][SPATIAL_SIDES[4]]['element']:.3e}); bfloat16 "
              f"rank-step {r['timing']['step_ms']:.3f} ms (exchange_rows "
              f"{r['timing']['exchange_ms']:.3f}, all_reduce "
              f"{r['timing']['collective_ms']:.3f} of "
              f"{r['timing']['instrumented_ms']:.3f} ms instrumented), "
              f"{r['exchanges']['exchanges']} + {r['exchanges']['adjoints']} "
              f"exchanges, {r['exchanges']['bytes']} bytes (all-gather "
              f"{r['exchanges']['all_gather_bytes']})"
              for i, r in enumerate(spatial["ranks"]))
          + f"; forward at {SPATIAL_FORWARD_MESH} "
          f"{spatial['forward']['rel_err']:.3e} of max|ref| off one process "
          f"(bit-equal {spatial['forward']['bit_equal']})")
    print(f"spatial cae (the CAE learners, their eval and LargeUnet3D, "
          f"{SPATIAL_WORLD} gloo ranks on the one card): " + "; ".join(
              f"rank {i} {SPATIAL_CAE_MESH} float64 vs one process "
              + ", ".join(f"{kind} {v['float64']['element']:.3e}"
                          for kind, v in r["vs_f64"].items())
              + f"; phase-1 bfloat16 rank-step {r['timing']['step_ms']:.3f} "
              f"ms (exchange_rows {r['timing']['exchange_ms']:.3f}, "
              f"all_reduce {r['timing']['collective_ms']:.3f} of "
              f"{r['timing']['instrumented_ms']:.3f} ms instrumented), "
              f"{r['exchanges']['exchanges']} + {r['exchanges']['adjoints']}"
              f" exchanges, {r['exchanges']['bytes']} bytes (all-gather "
              f"{r['exchanges']['all_gather_bytes']}); LargeUnet3D "
              f"{r['large']}"
              for i, r in enumerate(spatial_cae["ranks"]))
          + f"; K4 repeat check {spatial_cae['repeat']['launches']} "
          f"launches bit-equal")
    gv, gt, gr = grouped["vs_f64"], grouped["testers"], grouped["ranks"]
    print(f"CAE grouped (STROKE_TPU_CAE_BATCH=1): float32 step vs float64 "
          f"(of its layer's largest gradient) grouped "
          f"{gv['grouped card float32']['grad_rel']:.3e}, sequential "
          f"{gv['card float32']['grad_rel']:.3e}, entry-dx control "
          f"{gv['grouped card float32, entry dx dropped']['grad_rel']:.3e}; "
          f"tester measures on vs off {gt['worst']:.3e}, K1 a case / sweeps "
          f"off {gt['k1']['0']} on {gt['k1']['1']}; rank 0 bfloat16 "
          f"rank-steps, switch on (ms, collectives ms of instrumented, "
          f"all_reduce; off: the CAE data-parallel line's): "
          + "; ".join(f"{kind} {t['step_ms']:.3f} ("
                      f"{t['collective_ms']:.3f} of {t['instrumented_ms']:.3f}"
                      f", {t['calls']:.0f})"
                      for kind, t in gr["timing"].items())
          + "; one-process bfloat16 steps (ms, busy ms, kernels): "
          + "; ".join(f"{kind} {name} {t['step_ms']:.3f}"
                      + (f" ({t['busy']['busy_ms']:.3f}, "
                         f"{t['busy']['kernels']})" if t["busy"] else "")
                      for (kind, name), t in grouped["times"].items())
          + "; cuDNN deterministic less any algorithm (ms, standard "
            "error): " + "; ".join(
              f"{kind} {t['cudnn']['diff_ms']:.3f} ({t['cudnn']['se_ms']:.3f})"
              for (kind, _), t in grouped["times"].items() if "cudnn" in t))
    print(f"CUDA graphs of the planned epoch ({GRAPH_SWITCH} on; ms by "
          f"CUDA events / host clock a step, busy share, kernels and host "
          f"launches a step from traces, K1-K5 launches a replayed "
          f"training and validation step): " + "; ".join(
              f"{what} eager {t['eager']['ms']:.3f} / "
              f"{t['eager']['host_ms']:.3f} ms, "
              f"{100 * t['eager']['busy_share']:.1f}%, "
              f"{t['eager']['kernels']:g} kernels, "
              f"{t['eager']['host_launches']:g} host launches; graphed "
              f"{t['graphed']['ms']:.3f} / {t['graphed']['host_ms']:.3f} ms, "
              f"{100 * t['graphed']['busy_share']:.1f}%, "
              f"{t['graphed']['kernels']:g} kernels, "
              f"{t['graphed']['host_launches']:g} host launches "
              f"({t['graphed']['host_calls']}); K1-K5 {t['hand_kernels']}, "
              f"validation {t['eval_hand_kernels']}"
              for what, t in graphs["times"].items())
          + "; graphed vs eager: " + "; ".join(
              f"{what} {graphs[what]['rule']} (files differing "
              f"{graphs[what]['differ']}, curve gap "
              f"{graphs[what]['gap']:.3e}, {graphs[what]['replays']} "
              f"replays)" for what in ("unet", "cae", "step", "prediction",
                                       "ctp", "grouped"))
          + f"; controls {graphs['controls']}")
    print(f"phase seconds: {phase_s}")
    print(f"CAE learners' visual forward vs one forward a step: "
          f"{cae_ln['vis']}; U-Net bfloat16 step card vs CPU "
          f"{step['bfloat16']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
