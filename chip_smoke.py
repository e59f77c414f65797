#!/usr/bin/env python3
"""Smoke run of the PyTorch port (oaprogressionmmf_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel of the main path from ops/csrc/, with
     ptxas's report;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (and the with_gap=false length 2432), in float32
     without TF32 and in bfloat16; times of the kernel, the plain version
     and the one PyTorch call computing the same function (library_ms, a
     yardstick the port never calls), beside the least time the card
     could take (bound_ms); K1 also at head widths 32-128 and 276
     (DenseNet-161 FeaTs; 48 and 276 it pads), bf16 also at N = 25, 65 and
     129 (one 32-key tile; a last 64-row tile of one row) and in both of
     its bf16 layouts (64 and 128 query rows a block, each timed), and D =
     276 at N = 65 timed beside SDPA;
 3c. the fused stem kernel K4 (BatchNorm(eval) + ReLU + 3x3/2 max pool)
     against its plain version bit for bit at the flagship's three stems,
     the JAX script's design point (4096 slices of 160²), a 96-channel
     DenseNet stem and a 20-channel map of odd height and width (the
     scalar path), in float32 (no TF32) and bf16; NaNs planted in its
     input come out (at DESS also at a band's halo row and a column
     strip's edge); bf16 against the unfused F.batch_norm → relu →
     max_pool2d; times of the kernel, the plain version and the unfused
     three library calls (no single PyTorch call computes this function)
     beside the bound, and of the float32 flagship stems (int8 requests);
 3d. the int8 implicit-GEMM convolution K5 with its fused epilogue
     (scale, BatchNorm, residual, ReLU, requantize) against its plain
     version (the int32 sums of a float64 convolution of the int8 values,
     exact, then the eager float32 ops) bit for bit at every conv of the
     flagship's quantized FEs at batch 4 (DESS 256 and T2 100 slices of
     160² through ResNet50, the X-ray at 350² through ResNeXt50-32x4d with
     32 groups: the 7x7/s2 stems, the 3x3/s1 and 3x3/s2 convs and the 1x1
     conv1, conv3 and downsample convs), each with the epilogue the model
     gives it, and every epilogue at three shapes; a planted ±127 input
     against overflow; times of the kernel, the plain version and two
     labelled library yardsticks (torch._int_mm on an explicit im2col, or
     on the input itself for a 1x1: the GEMM alone; the bf16
     channels_last F.conv2d of the same shape) beside the bound, per call
     and per request (159 launches, and the 51 3x3 and 7x7 ones);
  4. the flagship XR1MR2C1CnnTrf inference slice at the full width of
     bench.py's config: random weights from bench_param_spec.json (seeded,
     bench.py's recipe), carried across with from_jax_variables and loaded
     with strict=True; a few requests of raw batch-4 inputs through
     make_predictor in bfloat16 (replays of its CUDA graph after the
     warm-up), then as many under a profiler, its kernels counted on the
     device by name (12 K1 and 3 K4 launches per request);
     probabilities checked; the bf16 run's tokens into the final FeaT, its
     states and its logits compared with a float32 (no TF32) run of the
     port on the same inputs, beside how far knees and slices differ in the
     same quantities; one float32 MRI ResNet50 through K4 against its own
     children run unfused;
 4c. int8 serving of the same flagship at full width: the port's
     export_serving_bundle calibrates on the card with one batch and
     writes an int8-all bundle (and an int8 one) in the JAX layout to a
     temporary directory, load_serving_bundle reads it back, and a few
     batch-4 requests run, then as many with their kernels counted on the
     device (159 K5, 12 K1 and 3 K4 per request in both modes; the
     int8 mode's FeaTs stay bf16); probabilities finite; the final FeaT's
     tokens and states, less their mean over knees, within CENTRED_RTOL of
     the bf16 request's input-driven part; ms per request, knees/s, device
     busy time and idle share beside the bf16 request, with a profiler
     breakdown;
 4g. the predictor's CUDA graphs: MR1CnnTrf in bf16 at batch 1 and the
     flagship int8-all (calibrated in memory on one batch) at batch 16,
     each over GRAPH_INPUTS distinct inputs answered eagerly by eval_step
     first; then through one predictor the first two inputs (eager, then
     captured under a profiler) and all of them again (replayed): every
     answer equal to the eager one bit for bit, every earlier answer
     still equal after each call; the wrappers' launch counters moved by
     the eager call's launches (MR1 K1 4, K4 1; the flagship K1 12, K4 3,
     K5 159), twice that by the capturing call and not by a replay; on
     the device, by kernel name in a profiler trace, the capturing call
     and each of GRAPH_REPLAYS_TRACED replays launch the eager call's
     kernels; ``counts`` eager 1, captured 1, the rest replayed; ms per
     request eager and replayed;
 4b. the five other families at the full width of their YAML configs
     (XR 700² → ResNeXt50-32x4d at 350², or ResNet50 for XR1Cnn; DESS
     320²×128 → 64 slices of 160²; COR IW TSE 320²×32 → 32 slices) with
     random weights from a seeded host recipe, loaded with strict=True
     through make_predictor: batch-4 requests in bf16 with their exact K4
     and K1 launch counts on the device, and logits and probabilities against a float32
     run; then MR1CnnTrf with each extra encoder (squeezenet1_0, vgg16,
     densenet161, inception_v3) as its fe.arch at batch 2;
 3b. the flash backward kernels K2 (dq) and K3 (dk, dv) against their
     plain PyTorch versions on the same inputs and the same (O, lse) from
     K1, at the training step's shapes (B, H) = (8, 8), D = 256, N in
     {25, 64, 92, 2432}, and D in {32, 48, 64, 128, 276} for correctness
     (48 and 276, DenseNet-161's heads, run padded; 276 also timed); bf16
     (the tensor-core route) also at N = 65 and 129, whose last 64-row
     tile holds one row, and float32 (the CUDA-core route) at 5e-4; times
     of each kernel, the plain versions, the backward of
     F.scaled_dot_product_attention on a retained graph (library_ms, a
     yardstick the port never calls) and the bound;
  5. the flagship training step at full width: the same weights loaded
     into TrainRuntime (float32 parameters, bf16 autocast), raw batch-8
     inputs, focal loss, Adam with coupled weight decay under the warmup
     schedule; warm-up steps, then timed steps with every launch count set
     to 0 just before and read just after (12 launches of each of K1, K2
     and K3 per step, none of K4: train mode keeps the unfused stem);
     losses finite, every parameter and BN running
     statistic moved and finite; ms per step, knees/s, peak memory and a
     profiler breakdown of one step;
 5b. one float32 (no TF32, deterministic cuDNN) step at batch 2 without
     dropout through K1/K2/K3 against the same step with every Attention
     on the plain attention: loss and every parameter's Adam first moment
     (0.1 of its gradient) compared;
  6. the training loop, ProgressionTrainer.fit, on the full-width flagship
     in bf16 with prog_fus.yaml's training and validation settings, over
     an in-memory dataset of 32 synthetic knees at the prepared sizes (16
     to train, batch 8; 16 to validate, batch 16): trainer A trains epoch
     0 (2 steps, 1 validation batch) and writes its checkpoint (~4.8 GB,
     the JAX layout) to a temporary directory; trainer B resumes from it
     at epoch 1 with every parameter, BatchNorm statistic and Adam moment
     equal to A's bit for bit, then trains epoch 1 with every launch count
     set to 0 just before and read just after (K1 36, K2 24, K3 24, K4 3,
     K5 0); the inputs of the first K1 and K4 launch at each shape of that
     epoch (K1 at (8, 8, N, 256) for the steps and (16, 8, N, 256) for the
     validation batch, N in {25, 64, 92}; K4 at the batch-16 stems, bf16
     with the float32 BatchNorm of an autocast model) are kept and each
     kernel is held against its plain version on them, as in phases 3
     and 3c; ms per step inside fit against phase 5's bare step, the
     loader's wait, validation ms per batch, checkpoint bytes and write
     and read seconds, peak device memory;
  7. fold evaluation in phase 6's experiment directory, whose two folds
     hold full-width flagship weights (fold 0 trainer B's epoch-1
     checkpoint, fold 1 trainer A's epoch-0 one, a hard link made before
     B saved): 20 synthetic test knees of their own at prog_fus.yaml's
     testing batch 16 (a full batch and a padded one of 4 valid rows)
     through eval_prog_fus.run in bf16 three times (regime=eval with
     profile=time, regime=explain, testing.quant=int8), then
     export_serving.run for fold 0 (int8-all, one validation batch of
     calibration) and one test batch served from its bundle; every launch
     count set to 0 just before each run and read just after, and held
     exactly to the count its forwards give (12 K1 and 3 K4 a forward,
     159 K5 an int8-all forward; a no-op global forward hook keeps these
     runs' predictors eager, so the wrappers see every forward); the eval
     run once more without the hook, as users run it, each fold's
     predictor replaying its CUDA graph, its answers equal bit for bit to
     the eager run's; the pickles' names and keys as the JAX
     package writes them; the ensemble equal to the double softmax of the
     fold-wise pickle; each fold's first batch equal to make_predictor on
     its weights (bf16 and int8-all on the evaluator's calibration); the
     explain attributions against a recomputation; int8 against bf16
     (phase 4's logit and probability bars; the centred errors reported:
     phase 6's weights leave the MRI tokens' input-driven share at ~1%);
     K1, K4 and K5 against their plain versions on the phase's own
     inputs, full and padded batches; per-knee latency, seconds per fold,
     restore, explain, calibration and export times, bundle bytes, peak
     device memory;
  8. data preparation: one knee's three MRI series at OAI's sizes written
     as DICOM with the port's dcmwrite (a SAG 3D DESS of 160 slices of
     384², explicit VR; a COR IW TSE of 37, implicit VR; a SAG MESE of 27
     slice locations × 7 echoes, TE 10-70 ms, with a known T2 of 0.01-0.09
     s per pixel, seeded amplitudes and noise, a block of zero pixels and
     a slice location without EchoTime) through
     run/prepare_data_mri_oai.handle_series with no device argument, so
     the T2 map is fitted on the card; the fit held against the same fit
     on the CPU (1e-4 relative and 1e-5 s where both are valid; a pixel
     valid in one only where its float64 fit lies within 1e-4·0.1 s of a
     clamp bound), 0 at the zero block and the slice without EchoTime, and
     within 5e-3 of the known T2 elsewhere; each image.nii.gz read back as
     the dataset reads it, equal to the array that went into the writer,
     at least the dataset's min_shape, DESS ≤ 255; the seconds of each
     stage per series, the fit's device ms beside its memory bound, the
     bytes written and the native gzip route (built with libdeflate or
     zlib, or unavailable and Python's codec);
  9. parallelism and the paths the port added last, at the flagship's
     full width with prog_fus.yaml's training config, on a single-rank
     NCCL process group (parallel.dcn.initialize_distributed): (e) the
     global BatchNorm's kernels (ops/csrc/global_bn.cu) at every
     BatchNorm of a bf16 DP step at 4 knees a rank (a four-card rank's),
     against the plain version, with the device ms of the step's layers
     forward and backward (kernels, the plain version, torch's
     SyncBatchNorm function as the yardstick) beside the bound of 8
     passes over each activation, and the host's ms to launch them; (a)
     float32
     batch-2 steps without dropout (phase 5b's config) through the
     data-parallel step (global BatchNorm, the global loss, the gradient
     all-reduce) against TrainRuntime.train_step, each step from the same
     state on the same draws (loss 1e-5 relative, every parameter within
     Adam's per-step bound), one float64 step of each with the plain
     attention (Adam's first moment 1e-6 of its largest entry), then four
     DP steps on knees of their own and a validation batch with every
     launch count set to 0 just before and read just after (K1 60, K2 48,
     K3 48, K4 3; the global BatchNorm's kernels 4 a layer a step; the
     float64 steps take its plain version, the kernels taking float32
     and bf16), and two timed bf16 DP steps at batch 8 with a
     validation batch (K1 36, K2 24, K3 24, K4 3); (d) that float32
     runtime saved with ckpt_backend: orbax (a torch.distributed.checkpoint
     directory), read back and restored, every tensor torch.equal; (c)
     training.augment_full_res=false: a bf16 step at batch 8 after a
     warm-up step, timed, and a validation batch (K1 24, K2 12, K3 12, K4
     3); (b) a dp×tp = 1×2 grid in two processes on the card (gloo, which
     takes CUDA tensors; NCCL refuses two ranks on one device): the FeaTs
     split over the tensor group (4 local heads through K1-K3), (a)'s four
     float32 steps and a validation batch, held against (a)'s DP run with
     __graft_entry__.py's bars (losses rtol 5e-3, atol 1e-5; parameters
     rtol 2e-2, atol 2e-3), launches per rank as (a)'s; then one float64
     step of the grid with the plain attention, its gathered Adam first
     moment against (a)'s float64 DP step's at (a)'s bar (1e-6 of each
     tensor's largest entry): the parameter bar cannot see a wrong
     gradient after 4 steps at lr 1e-5, this one does.

``python3 chip_smoke.py dp-cards N`` (not part of the default run, which
needs one card) trains data-parallel over N cards, one NCCL process each
(``dp-worker``): the first float32 step of N × 2 knees against one
process's step on all of them (loss 1e-5 relative, each parameter within
Adam's per-step bound), 12 launches of each of K1-K3 and 4 of the global
BatchNorm's kernels a layer on every rank, then bf16 DP steps at batch 8
a card, timed against one process's batch-8 step.

Prints progress lines, then a JSON line of kernel records (with the
per-length times behind each sum), the card line,
and as its last line {"ok": true, "device": {...}}. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()
BATCH = 4
WARMUP_REQUESTS = 2
REQUESTS = 5

# bench.py's flagship config (bf16 path, no int8)
MODALS = ["xr_pa", "sag_3d_dess", "sag_t2_map", "clin"]
MODEL_CFG = {
    "name": "XR1MR2C1CnnTrf",
    "input_size": [[700, 700], [320, 320, 128], [320, 320, 25], [16]],
    "downscale": [[0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 1.0], [1.0]],
    "input_channels": 1,
    "output_channels": 2,
    "output_type": "dict",
    "debug": False,
    "restore_weights": False,
    "fe": {
        "xr": {"arch": "resnext50_32x4d", "pretrained": False,
               "with_gap": True, "dropout": 0.0},
        "mr": {"arch": "resnet50", "pretrained": False,
               "with_gap": True, "dropout": 0.0},
        "clin": {"dim_in": 9, "dim_out": 2048, "dropout": 0.1},
    },
    "agg": {"num_slices": [1, 64, 25, 1], "depth": 4, "heads": 8,
            "emb_dropout": 0.1, "mlp_dim": 2048, "mlp_dropout": 0.1},
}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit; int8 in
# operations per second)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

# flash-attention forward: the FeaT shapes of one flagship forward
FLASH_BH = (BATCH, 8)
FLASH_D = 256
FLASH_SCALE = 2048 ** -0.5          # full-width scale, emb_dim 2048
MAIN_PATH_N = {64: 4, 25: 4, 92: 4}  # tokens → launches per forward
CHECK_N = (25, 64, 92, 2432)
# bf16 K1, K2 and K3 also at lengths that leave ragged 64-row tiles
# (correctness)
BWD_RAGGED_N = (65, 129)
# bf16 K1 at its other widths also with one 32-key tile and ragged tiles
FWD_BF16_N = (25,) + BWD_RAGGED_N
# K1's two bf16 layouts (launch_fwd): 64 query rows a block (at D = 256
# two warpgroups of 128 columns each), 128 rows a block (two warpgroups of
# 64 rows); the port takes 128 where that grid has a block for every SM
FWD_LAYOUTS = {1: "64 rows", 2: "128 rows"}
# the two routes of K1, dispatched by type (csrc/flash_fwd.cu)
FWD_DESIGN = {
    "bfloat16": "tensor cores: wgmma m64nNk16 (bf16 in, float32 "
                "accumulators), K and V in 64-key "
                "tiles (32 when N <= 32) through two-stage cp.async rings, "
                "K a tile ahead of V; S = Q·Kᵀ from shared memory, the "
                "online softmax in registers (exp2f), P in bf16 from "
                "registers into O += P·V, the next tile's S right behind it; "
                "128 query rows a block (a warpgroup's 64 rows × all "
                "columns, m64n256k16 at D = 256) where that grid has a block "
                "for every SM, else 64 rows with the columns split between "
                "warpgroups (at D = 288 the last 32 a block of their own)",
    "float32": "CUDA cores: float32 FMAs (no TF32), 16 query rows a block, "
               "32-key tiles staged as float32"}
# ~0.1 s of device-side sleep: longer than the host takes to queue a
# timing loop, so the loop's launches run back to back on the card
SLEEP_CYCLES = 200_000_000
# phase 3d queues at most 20 calls of a few launches each behind its
# sleeps (4 timings at each of 87 conv shapes): ~15 ms covers that
K5_SLEEP_CYCLES = 30_000_000
# |O − O_plain| ≤ min(out, out_rel · max|O_plain|) and |lse − lse_plain|
# ≤ lse: bf16 output rounding alone is 2^-9 of |O|, so 2e-2 of max|O|
# leaves some 5× headroom and still catches a 25% error at N = 2432
TOL = {torch.float32: {"out": 2e-5, "out_rel": 1.0, "lse": 2e-5},
       torch.bfloat16: {"out": 3e-2, "out_rel": 2e-2, "lse": 1e-4}}
# bf16 serving against the float32 run of the same weights and inputs:
# |Δlogit| ≤ 5e-2 · max(1, max|logit|), |Δprob| ≤ 2e-2; per token segment
# of the final FeaT's input and output, the part the inputs drive (less
# its mean over knees) within CENTRED_RTOL of its largest value
LOGIT_RTOL = 5e-2
PROB_ATOL = 2e-2
CENTRED_RTOL = 0.25

# flash backward (K2, K3) at the training step's shapes: batch 8, 8 heads
BWD_BH = (8, 8)
# |dX − dX_plain| bars: float32 5e-4, the JAX package's gradient bar
# (tests/test_ops_attention_t2.py:47); bf16 min(4e-2, 2e-2·max|plain|):
# 4e-2 is the JAX bf16 gradient bar (:50). In bf16 both the kernels and
# the plain versions round P and dS to bf16 before the products that use
# them (dS·K, Pᵀ·dO, dSᵀ·Q: the tensor cores' operands), so they differ
# only by float32 reassociation, a P or dS that the two round to
# neighbouring bf16 values (2^-8 of one term), and the final bf16 rounding
# (2^-8 of a value): 2e-2 of the largest grad is ample
BWD_TOL = {torch.float32: {"abs": 5e-4, "rel": None},
           torch.bfloat16: {"abs": 4e-2, "rel": 2e-2}}

# the two routes of K2 and K3, dispatched by type (csrc/flash_bwd.cu)
BWD_DESIGN = {
    kern: {"bfloat16": f"tensor cores: wgmma m64nNk16 (bf16 in, float32 "
                       f"accumulators), 64 {rows} a block, the other side "
                       "in 64-row tiles (32 at D = 288, and at D = 256 when "
                       "N <= 32) through a two-stage cp.async ring; "
                       f"{products}",
           "float32": "CUDA cores: float32 FMAs (no TF32), 16 rows a block, "
                      "32-row tiles staged as float32"}
    for kern, rows, products in (
        ("dq", "query rows", "S, dP and dS·K, dS in bf16 from registers"),
        ("dkv", "keys", "Sᵀ, dPᵀ, Pᵀ·dO and dSᵀ·Q, Pᵀ and dSᵀ in bf16 from "
                        "registers"))}

# K4, the fused stem: conv outputs (N, C, H, W) of the flagship's three
# stems at batch 4, the JAX script's design point and a DenseNet-161 stem
STEM_SHAPES = (
    ("xr", (BATCH, 64, 175, 175)),            # X-ray 350² → 175²
    ("dess", (BATCH * 64, 64, 80, 80)),       # 64 DESS slices of 160²
    ("t2", (BATCH * 25, 64, 80, 80)),         # 25 T2 slices of 160²
    ("design", (4096, 64, 80, 80)),           # scripts/exp_fused_stem.py
    ("densenet", (BATCH * 64, 96, 80, 80)),   # DenseNet-161 on DESS
    ("scalar", (2, 20, 33, 31)),              # C % 8 != 0: the scalar path
)
FLAGSHIP_STEMS = ("xr", "dess", "t2")
# NaNs planted at (image, channel, row, column) of a conv output, and the
# pooled outputs whose windows hold one: at DESS (the vector path) rows
# 10-11 x cols 16-17, output (0, 0), and rows 7-8 x cols 19-20, where input
# row 15 is the halo row of the band from output row 8 and input column 39
# the left edge of the column strip from output column 20; on the scalar
# path output (0, 0) and rows 8-9 x cols 7-8
STEM_NAN = {"dess": (((0, 5, 21, 33), (1, 3, 0, 0), (2, 7, 15, 39)), 9),
            "scalar": (((0, 3, 0, 0), (1, 7, 17, 15)), 5)}
STEM_DESIGN = ("vector path (C a multiple of 8): 8 channels of one output "
               "column a thread, one 16-byte load in bf16 (two in float32), "
               "the folded affine in registers; a block walks a band of "
               "output rows (8, fewer while the grid has fewer than 4 blocks "
               "an SM) two input rows at a time, the next pair's loads in "
               "flight, each input read once and transformed once, column "
               "2j - 1 from the left neighbour (or the strip's halo threads) "
               "through shared memory, row 2i + 1's max kept in registers; "
               "scalar path otherwise: a thread per output reading its 3x3 "
               "window")
# K4 against its plain version: float32 within 1e-6 of max|out|, bf16
# within one bf16 ulp of each value (the two round every operation alike,
# so both should be 0); against the unfused bf16 batch_norm → relu →
# max_pool2d, which applies the affine in bf16, within 1e-2 of max|out|
# (scripts/exp_fused_stem.py:69-73)
STEM_F32_RTOL = 1e-6
STEM_UNFUSED_RTOL = 1e-2
# one float32 MRI ResNet50 through K4 against its children run unfused
FE_RTOL = 5e-4

# phase 4b: the other five families at their YAML configs' full width
FAMILY_SIZES = {"xr": ([700, 700], [0.5, 0.5]),
                "dess": ([320, 320, 128], [0.5, 0.5, 0.5]),
                "tse": ([320, 320, 32], [0.5, 0.5, 1.0])}
FAMILY_MODALS = {"xr": "xr_pa", "dess": "sag_3d_dess", "tse": "cor_iw_tse"}
# family → (branches, K4 and K1 launches per request)
FAMILIES = {
    "XR1Cnn": (("xr",), 1, 0),
    "MR1CnnTrf": (("dess",), 1, 4),
    "MR2CnnTrf": (("dess", "tse"), 2, 4),
    "XR1MR1CnnTrf": (("xr", "dess"), 2, 4),
    "XR1MR2CnnTrf": (("xr", "dess", "tse"), 3, 12),
}
ENCODERS = ("squeezenet1_0", "vgg16", "densenet161", "inception_v3")
FAMILY_REQUESTS = 3
ENCODER_BATCH = 2

# phase 3d: K5 at the flagship's int8 convs; phase 4c: int8 serving
K5_PER_REQUEST = 159      # 53 convs (stem, 16 3x3, 32 1x1, 4 downsample) x 3
K5_SUBSET = 51            # of them the stems and 3x3s (k > 1)
# the epilogues: (BatchNorm, residual, ReLU, int8 output)
K5_VARIANTS = {
    "bn_relu_int8": (True, None, True, True),             # conv1, conv2
    "bn_f32": (True, None, False, False),                 # downsample
    "bn_res_f32_relu_int8": (True, "f32", True, True),    # conv3 after a ds
    "bn_res_int8_relu_int8": (True, "int8", True, True),  # conv3, identity
    "scale_f32": (False, None, False, False),             # the stem
}
# every epilogue also at these convs
K5_VARIANT_SHAPES = ("dess stage1 conv3 1x1 +id", "xr stage1 conv2 3x3/s1",
                     "dess stage3 conv2 3x3/s1")
K5_DESIGN = ("tensor cores: wgmma m64nNk32 s8 (N = 64 or 128), 128 pixels a "
             "block in two warpgroups, K in 128-byte stages through a "
             "three-stage cp.async ring, A gathered from the NHWC map in "
             "16-byte channel runs (8 or 4 bytes for groups of 8 or 4 and "
             "the stem), narrow groups block-diagonal in 64-channel tiles; "
             "scale and BatchNorm on the int32 accumulators, then residual, "
             "ReLU and requantize on 16-channel runs through shared memory "
             "before the one store")
INT8_MODES = ("int8-all", "int8")
# phase 4g: distinct inputs per predictor, and the cases: (label, family
# config or None for the flagship, quant, batch, launches per request)
GRAPH_INPUTS = 8
GRAPH_REPLAYS_TRACED = 3
GRAPH_CASES = (("MR1CnnTrf bf16", "MR1CnnTrf", None, 1,
                {"K1": 4, "K2": 0, "K3": 0, "K4": 1, "K5": 0}),
               ("flagship int8-all", None, "int8-all", 16,
                {"K1": 12, "K2": 0, "K3": 0, "K4": 3,
                 "K5": K5_PER_REQUEST}))
# DenseNet-161 FeaT heads (2208 / 8), the width K2/K3 now pad to 288; its
# MR1CnnTrf FeaT holds 64 slice tokens and a CLS token
PAD_D = 276
PAD_N = 65

# the training step: prog_fus.yaml's training config
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
STEPS_PER_EPOCH = 100      # epoch 0 of the warmup: lr 1e-5 in every step
TRAIN_CFG = {
    "loss": {"name": "FocalLoss", "params": {"reduction": "mean",
                                             "gamma": 2.0}},
    "optim": {"name": "Adam", "lr_init": 1e-4, "weight_decay": 1e-4},
    "sched": {"name": "CustomWarmupStaticDecayLR",
              "params": {"epochs_warmup": 5, "epochs_static": 100,
                         "epochs_decay": 1}},
    "batch_size": TRAIN_BATCH,
    "augment_full_res": True,
    "steps_per_dispatch": 1,
}
# phase 5b: a float32 step through the kernels against the same step
# through the plain attention. The two differ only by float32
# reassociation inside attention; the bars leave ~100× room for it.
CHECK_BATCH = 2
GRAD_RTOL = 1e-3           # |Δ exp_avg| ≤ GRAD_RTOL · max|exp_avg| per tensor
LOSS_RTOL = 1e-5
# parameters the loss does not reach (the per-MRI FeaTs' heads, whose
# outputs the flagship discards): zero grads, so only the weight decay
# moves them, and a tensor that is all zeros stays where it is
UNREACHED = ("_agg_1.mlp_head0.", "_agg_2.mlp_head0.")

# phase 6: ProgressionTrainer.fit with prog_fus.yaml's training and
# validation subtrees (the folds, epochs and paths set for the run)
FIT_TRAIN_KNEES = 16
FIT_VAL_KNEES = 16
FIT_SEED = 11
FIT_CONFIG = {
    "data": {"modals_all": MODALS,
             "sets": {"n0": {"name": "oai", "modals": MODALS,
                             "frac_classw": 1.0}},
             "target": "prog_kl_48", "exclude_surg": False,
             "exclude_inj": False, "ignore_cache": False, "debug": False},
    "training": {
        "loss": {"name": "FocalLoss",
                 "params": {"reduction": "mean", "gamma": 2.0}},
        "optim": {"name": "Adam", "lr_init": 1e-4, "weight_decay": 1e-4},
        "sched": {"name": "CustomWarmupStaticDecayLR",
                  "params": {"epochs_warmup": 5, "epochs_static": 100,
                             "epochs_decay": 1}},
        "sampler": "weighted", "batch_size": 8, "epochs": {"num": 1},
        "folds": {"num": 5, "idx": 0, "ignore": None}, "debug": False,
        "augment_full_res": True, "ckpt_backend": "msgpack",
        "steps_per_dispatch": 1},
    "validation": {"criterion": "avg_precision", "batch_size": 16,
                   "debug": False},
    "testing": {"batch_size": 16},
    "runtime": {"compute_dtype": "bfloat16"},
    "num_workers": 8, "loader_backend": "threads",
    "seed_trainval_test": 0, "seed_train_val": 0, "site_test": "D",
}
# launches over trainer B's epoch: 2 training steps (K1, K2, K3 12 each)
# and 1 validation batch (K1 12, K4 3, the eval stems)
FIT_LAUNCHES = {"K1": 12 * 3, "K2": 12 * 2, "K3": 12 * 2, "K4": 3, "K5": 0}
# tags the JAX package's ProgressionTrainer writes for each epoch
FIT_TAGS = ("fold_0/loss_prog_batch/train", "fold_0/loss_prog_batch/val",
            "fold_0/train/loss_prog", "fold_0/val/loss_prog",
            "fold_0/val/avg_precision", "fold_0/val/roc_auc",
            "fold_0/learning_rate")

# phase 9: data parallelism over NCCL (one rank), a DCP checkpoint, the
# post-downscale augmentation and a dp×tp = 1×2 grid. The float32 DP run
# (phase 5b's config: batch 2, no dropout) takes PAR_STEPS steps; its
# first PAR_CHECK_STEPS are held against TrainRuntime's (phase 5b's bars),
# all of them against the grid's (__graft_entry__.py's dp×tp bars)
PAR_STEPS = 4
PAR_CHECK_STEPS = 2
# Adam moves a parameter by at most ~lr (1e-5 in these steps) in the sign
# of its gradient: two paths a step apart differ by at most two such moves
PAR_PARAM_ATOL = 2 * 1.0014 * 1e-5 + 1e-6
# float64 gradients of the two paths, per tensor against its largest
# entry; both take the loss on float32 logits (an ulp, 6e-8 relative)
PAR_MOMENT_RTOL = 1e-6
PAR_BF16_STEPS = 2
PAR_SEED = 500
PAR_TP = 2
PAR_TP_TIMEOUT_S = 600
# 9a's backend; 9b's ranks share the one card, which NCCL refuses: gloo,
# which all-reduces CUDA tensors
DP_BACKEND = "nccl"
TP_BACKEND = "gloo"
TP_DEVICE = "cuda:0"
GRID_LOSS = dict(rtol=5e-3, atol=1e-5)
GRID_PARAM = dict(rtol=2e-2, atol=2e-3)
# 9e: the global BatchNorm kernels (ops/csrc/global_bn.cu) at every
# BatchNorm of a four-card rank's step (GBN_RANK_BATCH knees, bf16
# autocast, channels_last), each distinct layer timed over GBN_ITERS
# forward-and-backward calls; the host's launch of a whole step's layers
# (a synchronized loop) the least of GBN_HOST_REPEATS
GBN_RANK_BATCH = 4
GBN_ITERS = 10
GBN_HOST_REPEATS = 3
# a gross fault, not a tolerance (tests/test_torch_port_global_bn.py
# holds the kernels to theirs): y and dx against the plain version, over
# each one's largest entry
GBN_GROSS = 2.0 ** -6
GBN_DESIGN = ("four kernels around the all-gather and the all-reduce: "
              "statistics (Welford per thread, Chan's merge over threads "
              "and blocks, the last block of a channel tile merging the "
              "partials in order), normalisation with the merge and the "
              "running statistics, the backward's two sums, dx; 16-byte "
              "loads along C (NHWC) or H·W (NCHW), 4 rows in flight")

# phase 7: fold evaluation over phase 6's experiment directory (fold 0:
# trainer B's epoch-1 checkpoint; fold 1: trainer A's epoch-0 one, a hard
# link): 20 test knees of their own, batch 16 (a full batch and a padded
# one of 4 valid rows)
EVAL_KNEES = 20
EVAL_SEED = 23
EVAL_FOLDS = 2
EVAL_TESTING = {"batch_size": 16, "folds": {"idx": -1, "ignore": None},
                "use_cached": False, "describe_data": False,
                "regime": "eval", "metrics_foldw": True,
                "ensemble_foldw": True, "metrics_ensemble": True,
                "explain_fn": "modal_abl", "debug": False, "profile": "time",
                "quant": "none"}
EVAL_SERVING = {"quant": "int8-all", "calib_batches": 1, "out": None}
# phase 7's runs: (name, testing overrides)
EVAL_RUNS = (("eval", {}), ("explain", {"regime": "explain"}),
             ("int8", {"quant": "int8"}))
# the keys of the pickles as the JAX package writes them (its
# train/evaluator.py); the fold-wise eval pickle under profile=time
EVAL_KEYS = ("exam_knee_id", "target", "predict", "predict_proba",
             "time_per_sample", "time_per_sample_p50", "time_per_sample_p95")
EVAL_ENS_KEYS = ("exam_knee_id", "target", "predict__0", "predict_proba__0",
                 "predict__1", "predict_proba__1", "predict_proba",
                 "predict")
EXPLAIN_KEYS = ("exam_knee_id", "target", "modal_names", "modal_abl_attrs",
                "modal_abl_percent")
EXPLAIN_ENS_KEYS = ("exam_knee_id", "target", "modal_names",
                    "modal_abl_attrs__0", "modal_abl_percent__0",
                    "modal_abl_attrs__1", "modal_abl_percent__1",
                    "modal_abl_percent")
METRIC_KEYS = ("sample_size", "num_pos", "num_neg", "prevalence", "roc_auc",
               "avg_precision", "avg_ppv_calib", "avg_npv", "cutoff",
               "youdens_index", "b_accuracy")
# each fold's first-batch probabilities against make_predictor on its
# weights (the same kernels on the same inputs), and the fold ensemble
# against the double softmax recomputed from the fold-wise pickle
EVAL_PROB_ATOL = 1e-5
ENSEMBLE_ATOL = 1e-12

# phase 8 (data preparation): one knee's three MRI series at OAI's sizes,
# written as DICOM, prepared by run/prepare_data_mri_oai.handle_series
PREP_SEED = 31
PREP_ROOT = ("0.C.2", "9000001", "20050101")   # <release>/<patient>/<date>
PREP_DESS = (384, 384, 160)        # rows, cols, slices; explicit VR
PREP_TSE = (384, 384, 37)          # implicit VR
PREP_MESE = (27, 7, 384)           # slice locations, echoes, rows = cols
PREP_TES_MS = np.linspace(10.0, 70.0, PREP_MESE[1])
PREP_T2 = (0.01, 0.09)             # s, the known T2 per pixel
PREP_AMP = (30000.0, 60000.0)
PREP_NOISE = 1.0                   # Gaussian σ, in counts
PREP_ZERO = (slice(150, 200), slice(100, 180))   # a block of zero pixels
PREP_NO_TE = 13                    # the slice location without EchoTime
T2_VAL_HIGH = 0.1                  # fit_t2_map's clamp bounds: [0, 0.1] s
T2_RTOL, T2_ATOL = 1e-4, 1e-5      # the card's fit against the CPU's
T2_FLIP_BAND = 1e-4                # × val_high: where a validity flip may be
T2_TRUE_RTOL = 5e-3                # against the known T2
                                   # (tests/test_ops_attention_t2.py:117)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Device ms of one call: CUDA events around ``iters`` calls queued
    behind a device-side sleep, so the card runs them back to back and the
    host's launch cost does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def roofline_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations over
    the type's peak, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def flash_bound_ms(n: int, d: int, dtype) -> tuple[float, str]:
    """Least time for one call at FLASH_BH: q, k, v read once, O and lse
    written once; two N×N×d products at the type's peak."""
    b, h = FLASH_BH
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * n * d * elt + b * h * n * 4
    flops = 4 * b * h * n * n * d
    return roofline_ms(nbytes, flops, dtype)


def bwd_bound_ms(kernel: str, n: int, dtype) -> tuple[float, str]:
    """Least time for one call at BWD_BH, D = FLASH_D. K2 reads q, k, v, O,
    dO and lse and writes dQ and delta; its three N×N×D products are S, dP
    and dS·K. K3 reads q, k, v, dO, lse and delta and writes dK and dV; its
    four are S, dP, Pᵀ·dO and dSᵀ·Q."""
    b, h = BWD_BH
    elt = torch.tensor([], dtype=dtype).element_size()
    tensors, rows, products = {"dq": (6, 2, 3), "dkv": (6, 2, 4)}[kernel]
    nbytes = tensors * b * h * n * FLASH_D * elt + rows * b * h * n * 4
    flops = products * 2 * b * h * n * n * FLASH_D
    return roofline_ms(nbytes, flops, dtype)


def phase_build():
    from oaprogressionmmf_torch.ops import _build
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(sources)) as pool:
        results = list(pool.map(_build.build, sources))
    log(f"[build] {len(sources)} source(s) {sources} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (path, report) in zip(sources, results):
        log(f"[build] {name} -> {path.relative_to(REPO)}")
        for line in report.splitlines():
            if "Compiling entry function" in line:
                log(f"[build]  {line.split(chr(39))[1]}")
            elif ("registers" in line or "spill" in line or "smem" in line
                  or "Performance" in line):
                log(f"[build]   {line.strip()}")


def check_flash(q, k, v, scale, layout=None) -> float:
    """Kernel against its plain version on the same card and inputs;
    returns max|dO| and exits if O or lse is outside its tolerance.
    ``layout``: launch K1 in this layout (``launch_fwd``) instead of the
    port's own choice."""
    fa = flash_module()
    if layout is None:
        out, lse = fa.flash_attention(q, k, v, scale)
    else:
        out, lse = fa.launch_fwd(q, k, v, scale, layout)
    want, want_lse = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    tol = TOL[q.dtype]
    peak = want.float().abs().max().item()
    tol_out = min(tol["out"], tol["out_rel"] * peak)
    ok = err <= tol_out and err_lse <= tol["lse"]
    placed = "" if layout is None else f" {FWD_LAYOUTS[layout]}"
    log(f"[flash] {str(q.dtype)[6:]:8s} (B,H,N,D)={tuple(q.shape)}{placed} "
        f"scale={scale:.4f} max|dO|={err:.3e} (tol {tol_out:.3e}, "
        f"max|O| {peak:.3e}) max|dlse|={err_lse:.3e} (tol "
        f"{tol['lse']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("flash kernel disagrees with its plain version")
    return err


def phase_flash():
    fa = flash_module()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h = FLASH_BH

    def qkv(n, d, dtype):
        return tuple(torch.randn(b, h, n, d, device=dev,
                                 generator=gen).to(dtype) for _ in range(3))

    # the other head widths the kernel takes, for correctness only: 48 and
    # 276 (a DenseNet-161 FeaT's 2208 / 8) run padded to 64 and 288; bf16
    # also with one 32-key tile, where the last 64-row tile holds one row,
    # and in the 128-row layout
    for d in (32, 48, 64, 128, PAD_D):
        for dtype in (torch.float32, torch.bfloat16):
            lengths = (92, 130) + (FWD_BF16_N if dtype == torch.bfloat16
                                   else ())
            for n in lengths:
                q, k, v = qkv(n, d, dtype)
                check_flash(q, k, v, d ** -0.5)
                if dtype == torch.bfloat16 and n > 64 and d <= FLASH_D:
                    check_flash(q, k, v, d ** -0.5, 2)

    record = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "max_abs_err": 0.0, "per_n": []}
    bound_parts = {"bytes": 0.0, "operations": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        lengths = CHECK_N + (BWD_RAGGED_N if dtype == torch.bfloat16 else ())
        for n in lengths:
            q, k, v = qkv(n, FLASH_D, dtype)
            for scale in (FLASH_SCALE, FLASH_D ** -0.5):
                err = check_flash(q, k, v, scale)
                if dtype == torch.bfloat16 and n in MAIN_PATH_N \
                        and scale == FLASH_SCALE:
                    record["max_abs_err"] = max(record["max_abs_err"], err)
            if dtype != torch.bfloat16:
                continue
            # both layouts where both run (128 rows need N > 64)
            layouts = [lay for lay in FWD_LAYOUTS if lay == 1 or n > 64]
            for lay in layouts:
                check_flash(q, k, v, FLASH_SCALE, lay)
            if n in BWD_RAGGED_N:
                continue
            iters = 10 if n > 1000 else 200
            t_k, t_p, t_l = (time_ms(fn, iters) for fn in (
                lambda: fa.flash_attention(q, k, v, FLASH_SCALE),
                lambda: fa.flash_attention_plain(q, k, v, FLASH_SCALE),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=FLASH_SCALE)))
            by_layout = {FWD_LAYOUTS[lay]: time_ms(
                lambda: fa.launch_fwd(q, k, v, FLASH_SCALE, lay), iters)
                for lay in layouts}
            bound, by = flash_bound_ms(n, FLASH_D, dtype)
            log(f"[flash] bf16 N={n:5d} (B,H,D)=({b},{h},{FLASH_D}) device: "
                f"kernel {t_k:.4f} ms (by layout: "
                f"{', '.join(f'{k} {t:.4f}' for k, t in by_layout.items())})"
                f"  plain {t_p:.4f} ms  sdpa {t_l:.4f} ms  bound "
                f"{bound:.5f} ms ({by})")
            record["per_n"].append(dict(n=n, ms=t_k, ms_by_layout=by_layout,
                                        plain_ms=t_p, library_ms=t_l,
                                        bound_ms=bound, bound_by=by))
            if n in MAIN_PATH_N:
                reps = MAIN_PATH_N[n]
                record["ms"] += reps * t_k
                record["plain_ms"] += reps * t_p
                record["library_ms"] += reps * t_l
                record["bound_ms"] += reps * bound
                bound_parts[by] += reps * bound
    record["bound_by"] = max(bound_parts, key=bound_parts.get)
    log(f"[flash] per flagship forward (12 launches, bf16): kernel "
        f"{record['ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, sdpa "
        f"{record['library_ms']:.4f} ms, bound {record['bound_ms']:.5f} ms")

    # DenseNet-161's FeaT: D = 276 (padded to 288) over 65 tokens
    q, k, v = qkv(PAD_N, PAD_D, torch.bfloat16)
    scale = (8 * PAD_D) ** -0.5
    rec = {"n": PAD_N, "d": PAD_D}
    rec["ms"], rec["plain_ms"], rec["library_ms"] = (
        time_ms(fn, 200) for fn in (
            lambda: fa.flash_attention(q, k, v, scale),
            lambda: fa.flash_attention_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
    rec["bound_ms"], rec["bound_by"] = flash_bound_ms(PAD_N, PAD_D,
                                                      torch.bfloat16)
    log(f"[flash] bf16 D={PAD_D} (padded to 288), N={PAD_N} (B,H)={(b, h)}: "
        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms")
    record["d276"] = rec
    return record


def flash_module():
    """The flash-attention module (the package re-exports its function
    under the same name)."""
    return importlib.import_module(
        "oaprogressionmmf_torch.ops.flash_attention")


def check_flash_bwd(q, k, v, do, scale) -> dict:
    """K2 and K3 against their plain versions on the same inputs and the
    same (O, lse) from K1; returns each kernel's max|dX| over its grads
    ({"dq": ..., "dkv": ...}) and exits if a grad is outside its bar."""
    fa = flash_module()
    out, lse = fa.flash_attention(q, k, v, scale)
    dq, delta = fa.launch_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = fa.launch_bwd_dkv(q, k, v, do, lse, delta, scale)
    want_dq, want_delta = fa.bwd_dq_plain(q, k, v, out, lse, do, scale)
    want_dk, want_dv = fa.bwd_dkv_plain(q, k, v, do, lse, want_delta, scale)
    torch.cuda.synchronize()
    tol = BWD_TOL[q.dtype]
    worst, failed, parts = {"dq": 0.0, "dkv": 0.0}, [], []
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv),
                            ("delta", delta, want_delta)):
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        bar = tol["abs"] if tol["rel"] is None else min(tol["abs"],
                                                         tol["rel"] * peak)
        if name != "delta":
            kern = "dq" if name == "dq" else "dkv"
            worst[kern] = max(worst[kern], err)
        elif q.dtype == torch.float32:
            bar = 1e-5 * max(1.0, peak)    # a float32 row sum
        else:
            bar = 1e-4 * max(1.0, peak)    # the same sum of widened bf16
        parts.append(f"{name} {err:.2e}/{bar:.1e}")
        if err > bar:
            failed.append(name)
    log(f"[flash_bwd] {str(q.dtype)[6:]:8s} (B,H,N,D)={tuple(q.shape)} "
        f"scale={scale:.4f} max|d|/bar: {', '.join(parts)} "
        f"{'ok' if not failed else 'FAIL'}")
    if failed:
        raise SystemExit(f"flash backward kernels disagree with their plain "
                         f"versions: {failed}")
    return worst


def sdpa_backward(q, k, v, do, scale):
    """A callable that runs the backward of F.scaled_dot_product_attention
    on a retained graph, and the name of the longest kernel it launches
    (which SDPA backend served it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)

    def run():
        return torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    top = max(kernels, key=lambda e: e.self_device_time_total).key \
        if kernels else "not measured"
    return run, top


def phase_flash_bwd() -> dict:
    fa = flash_module()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h = BWD_BH

    def inputs(n, d, dtype):
        return tuple(torch.randn(b, h, n, d, device=dev,
                                 generator=gen).to(dtype) for _ in range(4))

    records = {kern: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bound_ms": 0.0, "max_abs_err": 0.0, "per_n": [],
                      "parts": {"bytes": 0.0, "operations": 0.0},
                      "d276": {"n": PAD_N, "d": PAD_D}}
               for kern in ("dq", "dkv")}
    # the other head widths, for correctness: 48 and 276 (a DenseNet-161
    # FeaT's 2208 / 8, at its full-width scale) run padded to 64 and 288;
    # bf16 also where the last 64-row tile holds one row
    for d in (32, 48, 64, 128, PAD_D):
        scale = (8 * d) ** -0.5 if d == PAD_D else d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            lengths = (92, 130) + (BWD_RAGGED_N if dtype == torch.bfloat16
                                   else ())
            for n in lengths:
                errs = check_flash_bwd(*inputs(n, d, dtype), scale)
                if d != PAD_D:
                    continue
                for kern, err in errs.items():
                    key = f"max_abs_err_{str(dtype)[6:]}"
                    rec = records[kern]["d276"]
                    rec[key] = max(rec.get(key, 0.0), err)
    q, k, v, do = inputs(PAD_N, PAD_D, torch.bfloat16)
    scale = (8 * PAD_D) ** -0.5
    out, lse = fa.flash_attention(q, k, v, scale)
    _, delta = fa.launch_bwd_dq(q, k, v, out, lse, do, scale)
    for kern, (kernel_fn, plain_fn) in {
            "dq": (lambda: fa.launch_bwd_dq(q, k, v, out, lse, do, scale),
                   lambda: fa.bwd_dq_plain(q, k, v, out, lse, do, scale)),
            "dkv": (lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta, scale),
                    lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta,
                                             scale))}.items():
        rec = records[kern]["d276"]
        rec["ms"], rec["plain_ms"] = time_ms(kernel_fn, 100), time_ms(
            plain_fn, 100)
        log(f"[flash_bwd] bf16 {kern} at D={PAD_D} (padded to 288), N={PAD_N}"
            f" (B,H)={(b, h)}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms")
    for n in BWD_RAGGED_N:
        check_flash_bwd(*inputs(n, FLASH_D, torch.bfloat16), FLASH_SCALE)
    for dtype in (torch.float32, torch.bfloat16):
        for n in CHECK_N:
            q, k, v, do = inputs(n, FLASH_D, dtype)
            for scale in (FLASH_SCALE, FLASH_D ** -0.5):
                errs = check_flash_bwd(q, k, v, do, scale)
                if dtype == torch.bfloat16 and n in MAIN_PATH_N \
                        and scale == FLASH_SCALE:
                    for kern, rec in records.items():
                        rec["max_abs_err"] = max(rec["max_abs_err"],
                                                 errs[kern])
            if dtype != torch.bfloat16:
                continue
            out, lse = fa.flash_attention(q, k, v, FLASH_SCALE)
            _, delta = fa.launch_bwd_dq(q, k, v, out, lse, do, FLASH_SCALE)
            iters = 5 if n > 1000 else 200
            sdpa, backend = sdpa_backward(q, k, v, do, FLASH_SCALE)
            t_lib = time_ms(sdpa, iters)
            fns = {
                "dq": (lambda: fa.launch_bwd_dq(q, k, v, out, lse, do,
                                                FLASH_SCALE),
                       lambda: fa.bwd_dq_plain(q, k, v, out, lse, do,
                                               FLASH_SCALE)),
                "dkv": (lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta,
                                                  FLASH_SCALE),
                        lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 FLASH_SCALE)),
            }
            line = []
            for kern, (kernel_fn, plain_fn) in fns.items():
                t_k, t_p = time_ms(kernel_fn, iters), time_ms(plain_fn, iters)
                bound, by = bwd_bound_ms(kern, n, dtype)
                rec = records[kern]
                rec["per_n"].append(dict(n=n, ms=t_k, plain_ms=t_p,
                                         library_ms=t_lib, bound_ms=bound,
                                         bound_by=by, sdpa_backend=backend))
                line.append(f"{kern} {t_k:.4f} ms (plain {t_p:.4f}, bound "
                            f"{bound:.5f} {by})")
                if n in MAIN_PATH_N:
                    reps = MAIN_PATH_N[n]
                    rec["ms"] += reps * t_k
                    rec["plain_ms"] += reps * t_p
                    rec["library_ms"] += reps * t_lib
                    rec["bound_ms"] += reps * bound
                    rec["parts"][by] += reps * bound
            log(f"[flash_bwd] bf16 N={n:5d} (B,H,D)=({b},{h},{FLASH_D}) "
                f"device: {'; '.join(line)}; sum "
                f"{sum(r['per_n'][-1]['ms'] for r in records.values()):.4f}"
                f" ms; sdpa backward {t_lib:.4f} ms ({backend[:60]})")
    for kern, rec in records.items():
        parts = rec.pop("parts")
        rec["bound_by"] = max(parts, key=parts.get)
        log(f"[flash_bwd] {kern} per training step (12 launches, bf16): "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.5f} ms; sdpa backward (dq, dk, dv) "
            f"{rec['library_ms']:.4f} ms")
    return records


def stem_module():
    """The fused-stem module (K4)."""
    return importlib.import_module("oaprogressionmmf_torch.ops.fused_stem")


def gbn_module():
    """The global BatchNorm kernels' module."""
    return importlib.import_module("oaprogressionmmf_torch.ops.global_bn")


def global_bns(model) -> list:
    from oaprogressionmmf_torch.parallel.mesh import GlobalBatchNorm2d
    return [m for m in model.modules() if isinstance(m, GlobalBatchNorm2d)]


def plain_global_bn(model) -> None:
    """Every GlobalBatchNorm2d of ``model`` on its plain version, on any
    device: the float64 checks' (the kernels take float32 and bf16)."""
    from oaprogressionmmf_torch.parallel.mesh import global_batch_norm_plain

    def forward(m, x):
        if not m.training:
            return torch.nn.BatchNorm2d.forward(m, x)
        return global_batch_norm_plain(
            x, m.weight, m.bias, m.running_mean, m.running_var,
            m.num_batches_tracked, m.momentum, m.eps, m.group)

    for m in global_bns(model):
        m.forward = functools.partial(forward, m)


def stem_inputs(shape, dtype, gen):
    """A channels_last (N, C, H, W) conv output and BatchNorm weight,
    bias, running mean and variance in ``dtype`` (a bf16 model holds its
    BatchNorm in bf16)."""
    n, c, h, w = shape
    dev = torch.device("cuda")
    y = torch.randn(n, h, w, c, device=dev, generator=gen).to(dtype)
    params = (torch.rand(c, device=dev, generator=gen) + 0.5,
              torch.randn(c, device=dev, generator=gen) * 0.3,
              torch.randn(c, device=dev, generator=gen) * 0.3,
              torch.rand(c, device=dev, generator=gen) + 0.5)
    return y.permute(0, 3, 1, 2), tuple(p.to(dtype) for p in params)


def unfused_stem(y, weight, bias, mean, var, eps: float = 1e-5):
    """The eager stem: three library calls."""
    z = F.batch_norm(y, mean, var, weight, bias, False, 0.0, eps)
    return F.max_pool2d(F.relu(z), 3, 2, 1)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits), in float32."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_stem(name: str, y, params, eps: float = 1e-5, got=None) -> float:
    """K4 against its plain version (and, in bf16, the unfused stem) on the
    same card and inputs; returns max|Δ| and exits outside a bar. ``got``:
    K4's output on these inputs from an earlier launch (else K4 is
    launched here)."""
    fs = stem_module()
    out = fs.fused_bn_relu_pool(y, *params, eps) if got is None else got
    want = fs.bn_relu_pool_plain(y, *params, eps)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    peak = want.float().abs().max().item()
    if y.dtype == torch.float32:
        bar = f"{STEM_F32_RTOL * peak:.3e}"
        ok = err <= STEM_F32_RTOL * peak
    else:
        bar = "one bf16 ulp"
        ok = bool((diff <= bf16_ulp(want)).all())
    del diff
    ok = ok and out.shape == want.shape and out.is_contiguous(
        memory_format=torch.channels_last)
    line = (f"[stem] {str(y.dtype)[6:]:8s} {name:8s} (N,C,H,W)="
            f"{tuple(y.shape)} -> {tuple(out.shape)} BatchNorm "
            f"{str(params[0].dtype)[6:]} max|d|={err:.3e} "
            f"(bar {bar}, max|out| {peak:.3e})")
    if y.dtype == torch.bfloat16:
        err_u = (out.float() - unfused_stem(y, *params, eps).float()) \
            .abs().max().item()
        ok = ok and err_u <= STEM_UNFUSED_RTOL * peak
        line += (f"; unfused bf16 stem max|d|={err_u:.3e} (bar "
                 f"{STEM_UNFUSED_RTOL * peak:.3e})")
    log(f"{line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the fused stem kernel disagrees at {name}")
    return err


def check_stem_nan(name: str, y, params) -> None:
    """A NaN in the window gives NaN, as the plain version's relu and
    max_pool2d propagate it: STEM_NAN[name]'s plants."""
    fs = stem_module()
    plants, expected = STEM_NAN[name]
    y = y.clone()
    for at in plants:
        y[at] = float("nan")
    out = fs.fused_bn_relu_pool(y, *params)
    want = fs.bn_relu_pool_plain(y, *params)
    nan = torch.isnan(out)
    n_nan = int(nan.sum().item())
    same_nan = torch.equal(nan, torch.isnan(want))
    got, want = out[~nan].float(), want[~nan].float()
    if y.dtype == torch.float32:
        close = (got - want).abs().max() <= STEM_F32_RTOL * want.abs().max()
    else:
        close = ((got - want).abs() <= bf16_ulp(want)).all()
    ok = n_nan == expected and same_nan and bool(close)
    log(f"[stem] {str(y.dtype)[6:]:8s} {name:8s} NaN planted at "
        f"{len(plants)} inputs: {n_nan} NaN outputs (expected {expected}, "
        f"where the plain version has them) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused stem kernel does not propagate NaN")


def stem_bound_ms(y, c: int, dtype) -> tuple[float, str]:
    """Least time for one call: y and the four (C,) arrays read once, the
    pooled map written once; a multiply, an add and a ReLU per input value
    and eight maxima per output, float32 on the CUDA cores."""
    n, _, h, w = y.shape
    elt = torch.tensor([], dtype=dtype).element_size()
    n_out = n * c * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1)
    nbytes = (y.numel() + n_out + 4 * c) * elt
    return roofline_ms(nbytes, 3 * y.numel() + 8 * n_out, torch.float32)


def phase_stem() -> dict:
    fs = stem_module()
    gen = torch.Generator(device="cuda").manual_seed(4)
    record = {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0,
              "bound_ms": 0.0, "f32_ms": 0.0, "f32_bound_ms": 0.0,
              "max_abs_err": 0.0, "per_shape": []}
    parts = {"bytes": 0.0, "operations": 0.0}
    f32 = {}  # flagship stem → (float32 kernel ms, its bound)
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape in STEM_SHAPES:
            y, params = stem_inputs(shape, dtype, gen)
            record["max_abs_err"] = max(record["max_abs_err"],
                                        check_stem(name, y, params))
            if name in STEM_NAN:
                check_stem_nan(name, y, params)
            iters = 5 if name == "design" else 50
            if dtype == torch.float32:
                # the int8 requests' stems run in float32
                if name in FLAGSHIP_STEMS:
                    f32[name] = time_ms(
                        lambda: fs.fused_bn_relu_pool(y, *params), iters), \
                        stem_bound_ms(y, shape[1], dtype)[0]
                del y, params
                torch.cuda.empty_cache()
                continue
            t_k, t_p, t_u = (time_ms(fn, iters) for fn in (
                lambda: fs.fused_bn_relu_pool(y, *params),
                lambda: fs.bn_relu_pool_plain(y, *params),
                lambda: unfused_stem(y, *params)))
            bound, by = stem_bound_ms(y, shape[1], dtype)
            shape_rec = dict(name=name, shape=list(shape), ms=t_k,
                             plain_ms=t_p, unfused_ms=t_u, bound_ms=bound,
                             bound_by=by)
            line = (f"[stem] bf16 {name:8s} (N,C,H,W)={shape} device: kernel "
                    f"{t_k:.4f} ms  plain {t_p:.4f} ms  unfused (3 library "
                    f"calls) {t_u:.4f} ms  bound {bound:.5f} ms ({by})")
            if name in f32:
                shape_rec["f32_ms"], shape_rec["f32_bound_ms"] = f32[name]
                line += (f"; float32 kernel {f32[name][0]:.4f} ms, bound "
                         f"{f32[name][1]:.5f} ms")
            log(line)
            record["per_shape"].append(shape_rec)
            if name in FLAGSHIP_STEMS:
                for key, t in (("ms", t_k), ("plain_ms", t_p),
                               ("unfused_ms", t_u), ("bound_ms", bound)):
                    record[key] += t
                record["f32_ms"] += f32[name][0]
                record["f32_bound_ms"] += f32[name][1]
                parts[by] += bound
            del y, params
            torch.cuda.empty_cache()
    record["bound_by"] = max(parts, key=parts.get)
    log(f"[stem] per flagship request (3 launches, bf16): kernel "
        f"{record['ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, unfused "
        f"{record['unfused_ms']:.4f} ms, bound {record['bound_ms']:.5f} ms; "
        f"float32 (int8 requests) kernel {record['f32_ms']:.4f} ms, bound "
        f"{record['f32_bound_ms']:.5f} ms")
    return record


def int8_module():
    """The int8 convolution module (K5)."""
    return importlib.import_module("oaprogressionmmf_torch.ops.int8_conv")


def resnet_int8_convs(fe: str, n: int, size: int, groups: int = 1,
                      base_width: int = 64) -> list:
    """The K5 convs of one int8 ResNet50 (ResNeXt50 with ``groups``) FE on
    n grayscale images of size²: [(label, x shape NHWC, Cout, k, stride,
    pad, groups, epilogue, launches per request)]."""
    convs = [(f"{fe} stem 7x7/s2", (n, size, size, 1), 64, 7, 2, 3, 1,
              "scale_f32", 1)]
    s = ((size + 1) // 2 + 1) // 2            # conv1 /2, max pool /2
    in_ch = 64
    for i, blocks in enumerate((3, 4, 6, 3)):
        w = int(64 * 2 ** i * base_width / 64) * groups
        out = 256 * 2 ** i
        stride = 2 if i > 0 else 1
        so = (s + 1) // 2 if i > 0 else s
        st = f"{fe} stage{i + 1}"
        convs += [
            (f"{st}.0 conv1 1x1", (n, s, s, in_ch), w, 1, 1, 0, 1,
             "bn_relu_int8", 1),
            (f"{st}.0 conv2 3x3/s{stride}", (n, s, s, w), w, 3, stride, 1,
             groups, "bn_relu_int8", 1),
            (f"{st}.0 downsample 1x1/s{stride}", (n, s, s, in_ch), out, 1,
             stride, 0, 1, "bn_f32", 1),
            (f"{st}.0 conv3 1x1 +ds", (n, so, so, w), out, 1, 1, 0, 1,
             "bn_res_f32_relu_int8", 1),
            (f"{st} conv1 1x1", (n, so, so, out), w, 1, 1, 0, 1,
             "bn_relu_int8", blocks - 1),
            (f"{st} conv2 3x3/s1", (n, so, so, w), w, 3, 1, 1, groups,
             "bn_relu_int8", blocks - 1),
            (f"{st} conv3 1x1 +id", (n, so, so, w), out, 1, 1, 0, 1,
             "bn_res_int8_relu_int8", blocks - 1)]
        in_ch, s = out, so
    return convs


def flagship_int8_convs() -> list:
    """Every K5 conv of one batch-4 int8 flagship request: the X-ray
    through ResNeXt50-32x4d at 350², 64 DESS and 25 T2 slices per knee
    through ResNet50 at 160²."""
    convs = (resnet_int8_convs("xr", BATCH, 350, groups=32, base_width=4)
             + resnet_int8_convs("dess", BATCH * 64, 160)
             + resnet_int8_convs("t2", BATCH * 25, 160))
    assert sum(c[-1] for c in convs) == K5_PER_REQUEST
    assert sum(c[-1] for c in convs if c[3] > 1) == K5_SUBSET
    return convs


def int8_conv_inputs(xshape, cout, k, stride, pad, groups, variant, gen):
    """Random int8 input and weights and the epilogue's float32 inputs of
    one conv, scaled as a calibrated FE's are (|t| of order 1 before the
    requantize at amax 4): ((x, w, sc), keyword arguments of
    int8_conv2d)."""
    use_bn, res_kind, relu, int8_out = K5_VARIANTS[variant]
    dev = "cuda"

    def rand(shape, lo, hi):
        return torch.rand(shape, device=dev, generator=gen) * (hi - lo) + lo

    x = torch.randint(-127, 128, xshape, dtype=torch.int8, device=dev,
                      generator=gen)
    w = torch.randint(-127, 128, (cout, xshape[3] // groups, k, k),
                      dtype=torch.int8, device=dev, generator=gen)
    s_x = torch.tensor(2.0 ** -6, device=dev)
    w_scale = rand(cout, 0.5, 1.5) * (64 / (73 ** 2 * w[0].numel() ** 0.5))
    kw = {"relu": relu}
    if use_bn:
        var, weight = rand(cout, 0.5, 2.0), rand(cout, 0.5, 1.5)
        kw["bn"] = (torch.randn(cout, device=dev, generator=gen) * 0.3,
                    torch.rsqrt(var + 1e-5) * weight,
                    torch.randn(cout, device=dev, generator=gen) * 0.3)
    oshape = (xshape[0], (xshape[1] + 2 * pad - k) // stride + 1,
              (xshape[2] + 2 * pad - k) // stride + 1, cout)
    if res_kind == "f32":
        kw["res"] = torch.randn(oshape, device=dev, generator=gen)
    elif res_kind == "int8":
        kw["res"] = torch.randint(-127, 128, oshape, dtype=torch.int8,
                                  device=dev, generator=gen)
        kw["res_scale"] = torch.tensor(3.0, device=dev) / 127
    if int8_out:
        kw["out_scale"] = torch.tensor(4.0, device=dev) / 127
    return (x, w, s_x * w_scale), kw


def check_int8_conv(label, args, stride, pad, groups, kw, got=None,
                    quiet: bool = False) -> float:
    """K5 against its plain version: equal bit for bit, or exit; returns
    the largest difference (0). ``got``: K5's output on these inputs from
    an earlier launch (else K5 is launched here); ``quiet`` logs a failure
    only."""
    ic = int8_module()
    x, w, sc = args
    if got is None:
        got = ic.int8_conv2d(x, w, sc, stride, pad, groups, **kw)
    want = ic.int8_conv2d_fused_plain(x, w, sc, stride, pad, groups, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit(f"K5 gave {got.dtype} {tuple(got.shape)} at {label}, "
                         f"its plain version {want.dtype} "
                         f"{tuple(want.shape)}")
    bits = ((got.view(torch.int32) != want.view(torch.int32))
            if got.dtype == torch.float32 else got != want)
    n_diff = int(bits.sum().item())
    err = (got.float() - want.float()).abs().max().item()
    if not quiet or n_diff:
        log(f"[int8_conv] {label:30s} x{tuple(x.shape)} w{tuple(w.shape)} "
            f"s{stride} g{groups} -> {got.dtype} {tuple(got.shape)}: "
            f"{n_diff} values differ from the plain version in any bit "
            f"(max|d| {err:.3e}, max|y| "
            f"{want.float().abs().max().item():.4g}) "
            f"{'ok' if n_diff == 0 else 'FAIL'}")
    if n_diff != 0:
        raise SystemExit(f"K5 disagrees with its plain version at {label}")
    return err


def touched(size: int, k: int, stride: int, pad: int, out: int) -> int:
    """How many of ``size`` input rows (or columns) the ``out`` windows of
    width ``k`` read: all for k ≥ stride, every stride-th for a strided
    1x1."""
    rows = set()
    for o in range(out):
        rows.update(range(max(o * stride - pad, 0),
                          min(o * stride - pad + k, size)))
    return len(rows)


def int8_conv_bound_ms(x, w, out, kw, stride, pad) -> tuple[float, str]:
    """Least time for one call: the int8 input pixels the windows touch,
    the weights, the epilogue's per-channel vectors and the residual read
    once, the output (int8 or float32) written once; 2 operations per int8
    product the conv needs (a group's channels only) at the int8 dense
    peak."""
    n, h, wd, c = x.shape
    k = w.shape[-1]
    x_bytes = (n * c * touched(h, k, stride, pad, out.shape[1])
               * touched(wd, k, stride, pad, out.shape[2]))
    nbytes = (x_bytes + w.numel() + 4 * w.shape[0] * (
        1 + 3 * ("bn" in kw)) + out.numel() * out.element_size())
    if "res" in kw:
        nbytes += kw["res"].numel() * kw["res"].element_size()
    ops = 2 * out.numel() * w[0].numel()
    return roofline_ms(nbytes, ops, torch.int8)


def im2col_int8(x, w, stride, pad, groups):
    """The library yardstick's operands: an explicit (M, K) int8 im2col of
    x (for a 1x1, x itself at the stride) and the (Cout, K) int8 weight,
    K padded to a multiple of 8; a grouped weight becomes its
    block-diagonal dense form (the JAX package's)."""
    k = w.shape[-1]
    if k == 1 and groups == 1:
        a = x[:, ::stride, ::stride].reshape(-1, x.shape[-1])
    else:
        cols = F.unfold(x.permute(0, 3, 1, 2).float(), k, padding=pad,
                        stride=stride)                  # (N, C*k*k, L)
        a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
        del cols
    if groups > 1:
        cout, cg = w.shape[:2]
        dense = torch.zeros(cout, cg * groups, k, k, dtype=torch.int8,
                            device=w.device)
        for g in range(groups):
            rows = slice(g * cout // groups, (g + 1) * cout // groups)
            dense[rows, g * cg:(g + 1) * cg] = w[rows]
        w = dense
    b = w.reshape(w.shape[0], -1)
    kp = -(-a.shape[1] // 8) * 8
    if kp != a.shape[1]:
        a = F.pad(a, (0, kp - a.shape[1]))
        b = F.pad(b, (0, kp - b.shape[1]))
    return a.contiguous(), b.contiguous()


def phase_int8_conv() -> dict:
    """Phase 3d: K5 bit for bit against its plain version at every conv of
    the flagship's quantized FEs with its epilogue, every epilogue at
    K5_VARIANT_SHAPES, a planted ±127 input, and times."""
    ic = int8_module()
    gen = torch.Generator(device="cuda").manual_seed(5)
    keys = ("ms", "plain_ms", "library_ms", "library_bf16_conv_ms",
            "bound_ms")
    record = {key: 0.0 for key in keys}
    record.update(max_abs_err=0.0, per_shape=[],
                  subset={key: 0.0 for key in keys})
    parts = {"bytes": 0.0, "operations": 0.0}
    for label, xshape, cout, k, stride, pad, groups, variant, reps in \
            flagship_int8_convs():
        args, kw = int8_conv_inputs(xshape, cout, k, stride, pad, groups,
                                    variant, gen)
        x, w, sc = args
        err = check_int8_conv(f"{label} [{variant}]", args, stride, pad,
                              groups, kw)
        if label in K5_VARIANT_SHAPES:
            for other in sorted(K5_VARIANTS):
                if other != variant:
                    oargs, okw = int8_conv_inputs(xshape, cout, k, stride,
                                                  pad, groups, other, gen)
                    err = max(err, check_int8_conv(
                        f"{label} [{other}]", oargs, stride, pad, groups,
                        okw))
                    del oargs, okw
        record["max_abs_err"] = max(record["max_abs_err"], err)
        out = ic.int8_conv2d(x, w, sc, stride, pad, groups, **kw)
        a, b = im2col_int8(x, w, stride, pad, groups)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)     # channels_last
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w_packed = ic.pack_int8_conv_weight(w, groups)   # as the FEs hold it
        t_k = time_ms(lambda: ic.int8_conv2d(x, w, sc, stride, pad, groups,
                                             w_packed=w_packed, **kw), 20,
                      K5_SLEEP_CYCLES)
        t_p = time_ms(lambda: ic.int8_conv2d_fused_plain(
            x, w, sc, stride, pad, groups, **kw), 2, K5_SLEEP_CYCLES)
        t_l = time_ms(lambda: torch._int_mm(a, b.t()), 20, K5_SLEEP_CYCLES)
        t_b = time_ms(lambda: F.conv2d(xb, wb, None, stride, pad, 1, groups),
                      20, K5_SLEEP_CYCLES)
        bound, by = int8_conv_bound_ms(x, w, out, kw, stride, pad)
        log(f"[int8_conv] {label:30s} x{xshape} Cout {cout} k{k} s{stride} "
            f"g{groups} {variant} ({reps}/request): kernel {t_k:.4f} ms  "
            f"plain {t_p:.4f} ms  int_mm {t_l:.4f} ms  bf16 conv "
            f"{t_b:.4f} ms  bound {bound:.5f} ms ({by})")
        record["per_shape"].append(dict(
            name=label, x=list(xshape), cout=cout, k=k, stride=stride,
            groups=groups, epilogue=variant, per_request=reps, ms=t_k,
            plain_ms=t_p, library_ms=t_l, library_bf16_conv_ms=t_b,
            bound_ms=bound, bound_by=by))
        for key, t in zip(keys, (t_k, t_p, t_l, t_b, bound)):
            record[key] += reps * t
            if k > 1:
                record["subset"][key] += reps * t
        parts[by] += reps * bound
        del args, kw, x, w, sc, out, a, b, xb, wb, w_packed
        torch.cuda.empty_cache()
    # a planted ±127 input and weight at the deepest reduction (9 x 512):
    # int32 sums up to 74e6, past float32's 2**24, in both stores
    x = torch.full((BATCH * 64, 5, 5, 512), 127, dtype=torch.int8,
                   device="cuda")
    x[::2] = -127
    w = torch.full((512, 512, 3, 3), 127, dtype=torch.int8, device="cuda")
    w[1::3] = -127
    for variant in ("scale_f32", "bn_relu_int8"):
        args, kw = int8_conv_inputs((1, 1, 1, 512), 512, 3, 1, 1, 1, variant,
                                    gen)
        if variant == "bn_relu_int8":    # |t| up to ~200: spread, not clipped
            kw["out_scale"] = torch.tensor(300.0, device="cuda") / 127
        kw.pop("res", None)
        check_int8_conv(f"planted +-127 [{variant}]", (x, w, args[2]), 1, 1,
                        1, kw)
    record["bound_by"] = max(parts, key=parts.get)
    sub = record["subset"]
    log(f"[int8_conv] per flagship request ({K5_PER_REQUEST} launches): "
        f"kernel {record['ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, "
        f"int_mm {record['library_ms']:.4f} ms, bf16 conv "
        f"{record['library_bf16_conv_ms']:.4f} ms, bound "
        f"{record['bound_ms']:.5f} ms ({record['bound_by']}); the "
        f"{K5_SUBSET} stems and 3x3s: kernel {sub['ms']:.4f} ms, int_mm "
        f"{sub['library_ms']:.4f} ms, bf16 conv "
        f"{sub['library_bf16_conv_ms']:.4f} ms, bound {sub['bound_ms']:.5f}"
        f" ms")
    return record


def synth_state_dict():
    """bench.py's parameter recipe over bench_param_spec.json (params and
    batch_stats; the int8 quant_acts are not part of the bf16 path)."""
    from oaprogressionmmf_torch.utils.convert import from_jax_variables
    spec = json.loads((REPO / "bench_param_spec.json").read_text())
    rng = np.random.RandomState(1234)
    tree: dict = {}
    for entry in spec:
        keys, shape = entry["path"], tuple(entry["shape"])
        if keys[0] == "quant_acts":
            continue
        name = keys[-1]
        if name in ("scale", "var"):
            arr = np.ones(shape, np.float32)
        elif name in ("bias", "mean"):
            arr = np.zeros(shape, np.float32)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)),
                             shape).astype(np.float32)
        else:
            arr = rng.normal(0.0, 0.02, shape).astype(np.float32)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[name] = arr.astype(np.dtype(entry["dtype"]))
    return from_jax_variables(MODEL_CFG["name"], tree)


def raw_inputs(batch: int = BATCH, seed: int = 0):
    """Raw inputs at bench.py's sizes and types, ``batch`` knees: uint8 XR and
    DESS, float T2 maps, float clinical values. bench.py's uniform noise
    is dimmed to a tenth in some 100² blocks of each X-ray, a share that
    grows from knee to knee, and scaled by an amplitude drawn for each MRI
    slice, so that knees and slices differ in their tokens (per-knee
    min-max scaling would erase one amplitude per knee)."""
    rng = np.random.RandomState(seed)
    dark = (rng.rand(batch, 1, 7, 1, 7, 1)
            < np.linspace(0.1, 0.9, batch)[:, None, None, None, None, None])
    xr = (rng.randint(0, 256, (batch, 1, 7, 100, 7, 100)).astype(np.float32)
          * np.where(dark, 0.1, 1.0).astype(np.float32))
    dess = (rng.randint(0, 256, (batch, 1, 320, 320, 128))
            .astype(np.float32)
            * rng.uniform(0.1, 1.0, (batch, 1, 1, 1, 128)).astype(np.float32))
    t2 = (rng.randint(0, 1000, (batch, 1, 320, 320, 25)).astype(np.float32)
          * 1e-4
          * rng.uniform(0.1, 1.0, (batch, 1, 1, 1, 25)).astype(np.float32))
    return (xr.reshape(batch, 1, 700, 700).astype(np.uint8),
            dess.astype(np.uint8), t2,
            rng.rand(batch, 1, 9).astype(np.float32))


def labels(batch: int, seed: int = 1) -> np.ndarray:
    """Progression targets in {0, 1}, from their own numpy seed."""
    return np.random.RandomState(seed).randint(0, 2, batch).astype(np.int64)


def capture(predictor, xs) -> dict:
    """One forward: logits, the token sequence into the final FeaT and its
    output states, in float32."""
    seen = {}

    def hook(module, args, out):
        seen["tokens"] = args[0].float()
        seen["states"] = out[1].float()

    handle = predictor.model._agg_final.register_forward_hook(hook)
    seen["logits"] = predictor.logits(xs)
    handle.remove()
    return seen


def token_segments(model) -> dict:
    """Modality → (first, last + 1) of its tokens in the final FeaT's
    input."""
    counts = model._token_counts(model._shapes(3), n_mr=2)
    counts.append(int(MODEL_CFG["agg"]["num_slices"][3]))
    bounds = np.cumsum([0] + counts)
    return {name: (int(bounds[i]), int(bounds[i + 1])) for i, name in
            enumerate(("xr", "dess", "t2", "clin"))}


def centred_error(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(B, ...) bf16 and float32 readings → (max|Δ| / max|want|, the
    input-driven share max|dev| / max|want|, max|Δ − mean Δ| / max|dev|).

    dev is ``want`` less its mean over the knees: what the inputs put into
    the quantity, with weights, positions and CLS tokens taken out. The
    last ratio says how well the bf16 run carries that part. A mix-up of
    knees, slices or modalities, or a dropped modality, makes it about 1
    or more."""
    diff = got - want
    dev = want - want.mean(dim=0, keepdim=True)
    peak, dev_peak = want.abs().max().item(), dev.abs().max().item()
    centred = (diff - diff.mean(dim=0, keepdim=True)).abs().max().item()
    return diff.abs().max().item() / peak, dev_peak / peak, centred / dev_peak


def compare_dtypes(got: dict, want: dict, segments: dict) -> None:
    """bf16 run against the float32 run: the logits at LOGIT_RTOL and
    PROB_ATOL, and each token segment of the final FeaT's input and output
    at CENTRED_RTOL of its input-driven part."""
    failed = []
    for key in ("tokens", "states"):
        offset = 1 if key == "states" else 0   # the CLS token comes first
        for name, (lo, hi) in segments.items():
            rel, share, centred = centred_error(
                got[key][:, lo + offset:hi + offset],
                want[key][:, lo + offset:hi + offset])
            ok = centred <= CENTRED_RTOL
            log(f"[slice] {key:6s} {name:5s} ({hi - lo:2d} tokens): "
                f"max|d|/max|f32| {rel:.4e}, input-driven share "
                f"{share:.4e}, centred error {centred:.4e} (tol "
                f"{CENTRED_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{key}/{name}")
    logits_16, logits_32 = got["logits"], want["logits"]
    d_logit = (logits_16 - logits_32).abs().max().item()
    scale = max(1.0, logits_32.abs().max().item())
    d_prob = (torch.softmax(logits_16, -1)
              - torch.softmax(logits_32, -1)).abs().max().item()
    _, share, centred = centred_error(logits_16, logits_32)
    log(f"[slice] logits: max|d|={d_logit:.4e} (tol {LOGIT_RTOL}·{scale:.3f})"
        f", max|dprob|={d_prob:.4e} (tol {PROB_ATOL}); spread over knees "
        f"max|dev| {share * logits_32.abs().max().item():.4e}, centred "
        f"error {centred:.4e} (not held to a limit)")
    log(f"[slice] float32 logits {logits_32.cpu().numpy().tolist()}")
    log(f"[slice] bf16 logits {logits_16.cpu().numpy().tolist()}")
    if d_logit > LOGIT_RTOL * scale or d_prob > PROB_ATOL:
        failed.append("logits")
    if failed:
        raise SystemExit(f"bf16 serving disagrees with the float32 run: "
                         f"{failed}")


# kernel-name substrings → category of the device-time breakdown (first
# match wins)
KERNEL_CATEGORIES = (
    ("fused stem (bn_relu_pool)", ("bn_relu_pool",)),
    ("int8 conv (K5)", ("int8_conv",)),
    ("attention backward (flash_bwd)", ("flash_bwd_dq", "flash_bwd_dkv")),
    ("attention (flash_fwd)", ("flash_fwd",)),
    ("copies", ("memcpy", "memset")),
    ("collectives (NCCL)", ("nccl",)),
    ("resize", ("upsample",)),
    ("rotation (grid_sample)", ("grid_sampler", "affine_grid")),
    ("optimizer (Adam)", ("adam", "multi_tensor_apply")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "winograd", "cudnn")),
    ("matmul (cuBLAS, cuDNN 1x1)", ("gemm", "cutlass", "xmma", "nvjet")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("max pool", ("max_pool",)),
    ("reductions", ("reduce",)),
)


def device_breakdown(fn, latency_ms: float, what: str = "request") -> None:
    """Profile one call of ``fn`` and print its device time by kernel
    category, the top kernels, and the card's idle share of the
    unprofiled latency of one ``what``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    # user annotations (e.g. Optimizer.step#Adam.step) also carry device
    # time: the span of the kernels inside them, which are counted already
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launched = sum(e.count for e in kernels)
    nccl = sum(e.count for e in kernels if "nccl" in e.key.lower())
    if busy == 0:
        log("[profile] the profiler saw no device time: breakdown not "
            "measured")
        return None
    by_cat: dict = {}
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in name for k in keys)), "elementwise/other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    log(f"[profile] one {what}: device busy {busy:.3f} ms of "
        f"{latency_ms:.3f} ms unprofiled latency (idle share "
        f"{max(0.0, 1 - busy / latency_ms):.3f}); {launched} kernels, "
        f"{nccl} of them NCCL's")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {cat:30s} {ms:9.3f} ms  {ms / busy:6.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   top: {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return busy


def phase_slice(card: str, sd: dict):
    from oaprogressionmmf_torch.serving import make_predictor

    xs = raw_inputs()

    t0 = time.perf_counter()
    predictor = make_predictor(MODEL_CFG, sd, MODALS, MODEL_CFG["downscale"],
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[slice] strict load of the full-width flagship, bf16 on "
        f"{predictor.device}: {time.perf_counter() - t0:.1f} s")

    for _ in range(WARMUP_REQUESTS):
        predictor(xs).cpu()
    torch.cuda.reset_peak_memory_stats()

    latencies = []
    for _ in range(REQUESTS):
        t = time.perf_counter()
        probs = predictor(xs).cpu()
        latencies.append(time.perf_counter() - t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = device_launches(lambda: predictor(xs).cpu(), REQUESTS)
    launches, stem_launches = moved["K1"], moved["K4"]
    if moved["K5"]:
        raise SystemExit("the bf16 request launched the int8 conv K5")

    log(f"[slice] {REQUESTS} requests of batch {BATCH} (replayed: "
        f"{predictor.counts}), on the device: flash launches {launches} "
        f"({launches / REQUESTS:g} per forward), fused stem launches "
        f"{stem_launches} ({stem_launches / REQUESTS:g} per forward)")
    if launches != 12 * REQUESTS or stem_launches != 3 * REQUESTS:
        raise SystemExit(f"expected 12 flash and 3 fused stem launches per "
                         f"forward, got {launches} and {stem_launches} over "
                         f"{REQUESTS}")
    if probs.shape != (BATCH, 2) or not torch.isfinite(probs).all():
        raise SystemExit(f"bad probabilities {probs}")
    if (probs.sum(-1) - 1).abs().max().item() > 1e-5:
        raise SystemExit(f"probabilities do not sum to 1: {probs}")
    lat = np.asarray(latencies) * 1e3
    log(f"[slice] latency per request (raw host arrays -> probs on host): "
        f"mean {lat.mean():.2f} ms, min {lat.min():.2f}, max "
        f"{lat.max():.2f}; {BATCH * 1e3 / lat.mean():.1f} knees/s; peak "
        f"device memory {peak_gb:.2f} GB  [{card}]")
    busy = device_breakdown(lambda: predictor(xs).cpu(), float(lat.mean()))

    segments = token_segments(predictor.model)
    got = capture(predictor, xs)
    del predictor
    torch.cuda.empty_cache()
    predictor32 = make_predictor(MODEL_CFG, sd, MODALS,
                                 MODEL_CFG["downscale"], dtype=torch.float32)
    log("[slice] bf16 against a float32 (no TF32) run of the same weights "
        "and inputs:")
    compare_dtypes(got, capture(predictor32, xs), segments)
    check_fe_stem(predictor32.model._fe1)
    bf16 = {"capture": got, "segments": segments, "ms": float(lat.mean()),
            "busy_ms": busy}
    return launches, stem_launches, bf16


def check_fe_stem(fe) -> None:
    """One float32 MRI ResNet50 in eval mode through K4 against the same
    module's children run unfused (conv1 → bn1 → relu → maxpool →
    layer1..4), on 16 slices of 160² and with bn1 given random statistics."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bn1 = fe[1]
    with torch.no_grad():
        for t in (bn1.weight, bn1.running_var):
            t.copy_(torch.rand(t.shape, device=t.device, generator=gen) + 0.5)
        for t in (bn1.bias, bn1.running_mean):
            t.copy_(torch.randn(t.shape, device=t.device, generator=gen) * 0.3)
    x = torch.randn(16, 1, 160, 160, device="cuda", generator=gen)
    fs = stem_module()
    with torch.inference_mode():
        before = fs.fused_bn_relu_pool.launches
        got = fe(x)
        fused = fs.fused_bn_relu_pool.launches - before
        want = x
        for layer in fe:
            want = layer(want)
        want = want.mean(dim=(2, 3))
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    ok = fused == 1 and err <= FE_RTOL * peak
    log(f"[slice] float32 ResNet50 FE, eval: through K4 ({fused} launch) "
        f"against its children unfused: max|d| {err:.3e} (bar "
        f"{FE_RTOL * peak:.3e}, max|out| {peak:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the FE through the fused stem disagrees with the "
                         "unfused FE")


def compare_int8(got: dict, want: dict, segments: dict, label: str,
                 hold_centred: bool = True) -> None:
    """int8 serving against the bf16 request: each token segment of the
    final FeaT's input and output at CENTRED_RTOL of its input-driven part
    (the bar of compare_dtypes); the logits are reported. Without
    ``hold_centred`` (weights whose tokens hardly depend on the inputs)
    the centred errors are reported, and the logits and probabilities are
    held to phase 4's bars instead (LOGIT_RTOL, PROB_ATOL)."""
    failed = []
    for key in ("tokens", "states"):
        offset = 1 if key == "states" else 0   # the CLS token comes first
        for name, (lo, hi) in segments.items():
            rel, share, centred = centred_error(
                got[key][:, lo + offset:hi + offset],
                want[key][:, lo + offset:hi + offset])
            ok = centred <= CENTRED_RTOL
            verdict = ("ok" if ok else "FAIL") if hold_centred else \
                "not held"
            log(f"[int8] {label} {key:6s} {name:5s} ({hi - lo:2d} tokens): "
                f"max|d|/max|bf16| {rel:.4e}, input-driven share "
                f"{share:.4e}, centred error {centred:.4e} (tol "
                f"{CENTRED_RTOL}) {verdict}")
            if not ok and hold_centred:
                failed.append(f"{key}/{name}")
    d_logit = (got["logits"] - want["logits"]).abs().max().item()
    d_prob = (torch.softmax(got["logits"], -1)
              - torch.softmax(want["logits"], -1)).abs().max().item()
    scale = max(1.0, want["logits"].abs().max().item())
    if hold_centred:
        held = "not held to a limit"
    else:
        held = f"tol {LOGIT_RTOL}·{scale:.3f} and {PROB_ATOL}"
        if d_logit > LOGIT_RTOL * scale or d_prob > PROB_ATOL:
            failed.append("logits")
    log(f"[int8] {label} logits against bf16: max|d| {d_logit:.4e}, "
        f"max|dprob| {d_prob:.4e} ({held}); int8 logits "
        f"{got['logits'].cpu().numpy().tolist()[:4]}...")
    if failed:
        raise SystemExit(f"{label} serving disagrees with the bf16 run: "
                         f"{failed}")


def phase_int8_serving(card: str, sd: dict, bf16: dict) -> dict:
    """Phase 4c: each int8 mode exported to a bundle (calibrated on the
    card with one batch), loaded back and served; returns per mode the
    launch counts, ms per request and busy time."""
    from oaprogressionmmf_torch.serving import (export_serving_bundle,
                                                load_serving_bundle)
    xs = raw_inputs()
    results = {}
    with tempfile.TemporaryDirectory(prefix="int8_bundles_") as tmp:
        for quant in INT8_MODES:
            path = Path(tmp) / quant
            t0 = time.perf_counter()
            export_serving_bundle(path, MODEL_CFG, MODALS,
                                  MODEL_CFG["downscale"], sd,
                                  calib_batches=[xs], quant=quant,
                                  dtype=torch.bfloat16, source="chip_smoke")
            t_export = time.perf_counter() - t0
            size_gb = (path / "bundle.msgpack").stat().st_size / 1e9
            t0 = time.perf_counter()
            predictor = load_serving_bundle(path)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            log(f"[int8] {quant}: calibrated on {predictor.device} and "
                f"exported ({size_gb:.2f} GB bundle) in {t_export:.1f} s, "
                f"loaded back strictly in {t_load:.1f} s")
            for _ in range(WARMUP_REQUESTS):
                predictor(xs).cpu()
            latencies = []
            for _ in range(REQUESTS):
                t = time.perf_counter()
                probs = predictor(xs).cpu()
                latencies.append(time.perf_counter() - t)
            moved = device_launches(lambda: predictor(xs).cpu(), REQUESTS)
            counts = {k: moved[k] for k in ("K5", "K1", "K4")}
            want = {"K5": K5_PER_REQUEST, "K1": 12, "K4": 3}
            log(f"[int8] {quant}: {REQUESTS} requests of batch {BATCH} "
                f"({predictor.counts}): launches per request on the device "
                f"{ {k: v / REQUESTS for k, v in counts.items()} } (want "
                f"{want})")
            if any(counts[k] != want[k] * REQUESTS for k in want):
                raise SystemExit(f"{quant}: launch counts {counts} over "
                                 f"{REQUESTS} requests, want {want} each")
            if probs.shape != (BATCH, 2) or not torch.isfinite(probs).all():
                raise SystemExit(f"{quant}: bad probabilities {probs}")
            lat = np.asarray(latencies) * 1e3
            log(f"[int8] {quant}: latency per request (raw host arrays -> "
                f"probs on host): mean {lat.mean():.2f} ms, min "
                f"{lat.min():.2f}, max {lat.max():.2f}; "
                f"{BATCH * 1e3 / lat.mean():.1f} knees/s; the bf16 request "
                f"of this run {bf16['ms']:.2f} ms ("
                f"{BATCH * 1e3 / bf16['ms']:.1f} knees/s)  [{card}]")
            busy = device_breakdown(lambda: predictor(xs).cpu(),
                                    float(lat.mean()))
            log(f"[int8] {quant}: device busy {busy} ms against the bf16 "
                f"request's {bf16['busy_ms']} ms")
            compare_int8(capture(predictor, xs), bf16["capture"],
                         bf16["segments"], quant)
            results[quant] = dict(launches=counts, ms=float(lat.mean()),
                                  min_ms=float(lat.min()),
                                  max_ms=float(lat.max()), busy_ms=busy)
            shutil.rmtree(path)          # ~1.6 GB of float32 weights
            del predictor
            gc.collect()
            torch.cuda.empty_cache()
    return results


def graph_predictor(family, quant, sd: dict):
    """Phase 4g's predictor, in bf16: a family at full width with its own
    weights, or the flagship on ``sd`` calibrated in memory on one batch
    of 16 for ``quant``."""
    from oaprogressionmmf_torch.serving import (calibrate_quant_acts,
                                                make_predictor,
                                                quantized_model_config)
    if family is not None:
        cfg = family_cfg(family)
        return cfg, make_predictor(cfg, synth_family_state_dict(cfg),
                                   [FAMILY_MODALS[b]
                                    for b in FAMILIES[family][0]],
                                   cfg["downscale"], dtype=torch.bfloat16)
    calib = make_predictor(
        quantized_model_config(MODEL_CFG, "calib", include_agg=True), sd,
        MODALS, MODEL_CFG["downscale"], dtype=torch.bfloat16)
    acts = calibrate_quant_acts(calib,
                                [graph_inputs(MODEL_CFG, 16, -1)])
    del calib
    torch.cuda.empty_cache()
    return MODEL_CFG, make_predictor(
        quantized_model_config(MODEL_CFG, quant), sd, MODALS,
        MODEL_CFG["downscale"], dtype=torch.bfloat16, quant_acts=acts)


def graph_inputs(cfg: dict, batch: int, i: int) -> tuple:
    """Input ``i`` of phase 4g, on a seed of its own: uint8 X-rays and
    DESS volumes, T2 maps in [0, 0.1) s and clinical values in [0, 1) as
    float32."""
    rng = np.random.default_rng(200 + i)
    xs = [rng.integers(0, 256, (batch, 1, *size), dtype=np.uint8)
          for size in cfg["input_size"]]
    if cfg is MODEL_CFG:
        xs[2] = rng.random(xs[2].shape, dtype=np.float32) * 0.1
        xs[3] = rng.random((batch, 1, 9), dtype=np.float32)
    return tuple(xs)


def phase_graph(card: str, sd: dict) -> dict:
    """Phase 4g: the predictor's CUDA graphs against its eager path."""
    from oaprogressionmmf_torch.train.trainer import eval_step
    zero = dict.fromkeys(KERNEL_IDS.values(), 0)
    results = {}
    for label, family, quant, batch, want in GRAPH_CASES:
        cfg, predictor = graph_predictor(family, quant, sd)
        knees = [graph_inputs(cfg, batch, i) for i in range(GRAPH_INPUTS)]

        def eager(xs):
            return eval_step(predictor.model, predictor.preprocess,
                             predictor.to_device(xs))

        eager(knees[0])[1].cpu()                  # builds, cuDNN's choices
        wants, eager_ms = [], []
        for xs in knees:
            before = kernel_launches()
            t = time.perf_counter()
            logits, probs = eager(xs)
            probs = probs.cpu()
            eager_ms.append((time.perf_counter() - t) * 1e3)
            moved = {k: v - before[k] for k, v in kernel_launches().items()}
            if moved != want:
                raise SystemExit(f"[graph] {label}: the eager call launched "
                                 f"{moved}, want {want}")
            wants.append((logits.cpu(), probs))

        held, graph_ms = [], []

        def call(i, j):
            """Call ``i`` of the predictor on input ``j``; every answer held
            so far still equal to its eager one."""
            before = kernel_launches()
            t = time.perf_counter()
            got = predictor(knees[j])
            got.cpu()
            graph_ms.append((time.perf_counter() - t) * 1e3)
            held.append((j, got))
            bad = [k for k, (jj, p) in enumerate(held)
                   if not torch.equal(p.cpu(), wants[jj][1])]
            if bad:
                raise SystemExit(f"[graph] {label}: after call {i} the "
                                 f"answers of calls {bad} differ from the "
                                 f"eager ones")
            return {k: v - before[k] for k, v in kernel_launches().items()}

        # the wrappers count what Python issues: the eager call's launches,
        # the capturing call's twice (its eager run, then the capture's
        # record), a replay's none
        wrapped = [call(0, 0)]
        on_device = device_launches(lambda: wrapped.append(call(1, 1)))
        wrapped += [call(i + 2, j) for i, j in enumerate(range(len(knees)))]
        twice = {k: 2 * v for k, v in want.items()}
        if wrapped != [want, twice] + [zero] * len(knees):
            raise SystemExit(f"[graph] {label}: the wrappers counted "
                             f"{wrapped}, want {want}, {twice}, then none")
        # on the card: the capturing call (under a profiler) launches its
        # eager run's kernels, a replay the eager call's
        if on_device != want:
            raise SystemExit(f"[graph] {label}: the capturing call launched "
                             f"{on_device} on the device, want {want}")
        replays = device_launches(
            lambda: predictor(knees[-1]).cpu(), GRAPH_REPLAYS_TRACED)
        per_call = {k: v * GRAPH_REPLAYS_TRACED for k, v in want.items()}
        if replays != per_call:
            raise SystemExit(f"[graph] {label}: {GRAPH_REPLAYS_TRACED} "
                             f"replays launched {replays} on the device, "
                             f"want {per_call}")
        if not torch.equal(predictor.logits(knees[0]).cpu(), wants[0][0]):
            raise SystemExit(f"[graph] {label}: replayed logits differ")
        n = len(knees) + GRAPH_REPLAYS_TRACED + 1
        if predictor.counts != {"eager": 1, "captured": 1, "replayed": n}:
            raise SystemExit(f"[graph] {label}: counts {predictor.counts}")
        replay_ms = graph_ms[2:]
        results[label] = dict(eager_ms=float(np.median(eager_ms)),
                              replay_ms=float(np.median(replay_ms)),
                              counts=predictor.counts)
        log(f"[graph] {label}: batch {batch}, {len(knees)} distinct inputs; "
            f"replays equal the eager answers bit for bit and held answers "
            f"stay; launches on the device per call {want} (the capturing "
            f"call, under a profiler, and {GRAPH_REPLAYS_TRACED} replays); "
            f"counts {predictor.counts}; ms per request (host arrays in, "
            f"probabilities on the host) eager median "
            f"{np.median(eager_ms):.3f} (min {min(eager_ms):.3f}), replayed "
            f"median {np.median(replay_ms):.3f} (min {min(replay_ms):.3f})  "
            f"[{card}]")
        del predictor, held, wants
        gc.collect()
        torch.cuda.empty_cache()
    return results


def family_cfg(name: str, mr_arch: str = "resnet50") -> dict:
    """The family's YAML config (run/conf/model/*.yaml) at full width:
    ResNeXt50-32x4d for the X-ray of the fusion families, ResNet50 for
    XR1Cnn's X-ray and every MRI branch (or ``mr_arch``)."""
    branches = FAMILIES[name][0]
    agg = {"depth": 4, "heads": 8, "emb_dropout": 0.1, "mlp_dim": 2048,
           "mlp_dropout": 0.1}
    fe = {"pretrained": False, "with_gap": True, "dropout": 0.0}
    if name == "XR1Cnn":
        fe_cfg, agg = dict(fe, arch="resnet50"), {"hidden_size": 512,
                                                  "dropout": 0.5}
    elif name.startswith("XR"):
        fe_cfg = {"xr": dict(fe, arch="resnext50_32x4d"),
                  "mr": dict(fe, arch=mr_arch)}
        agg["num_slices"] = [1, 64, 32][:len(branches)]
    else:
        fe_cfg = dict(fe, arch=mr_arch, dims_view="rc")
        agg["num_slices"] = [64, 32] if name == "MR2CnnTrf" else None
    return {"name": name, "input_channels": 1, "output_channels": 2,
            "output_type": "dict", "debug": False, "restore_weights": False,
            "input_size": [FAMILY_SIZES[b][0] for b in branches],
            "downscale": [FAMILY_SIZES[b][1] for b in branches],
            "fe": fe_cfg, "agg": agg}


def synth_family_state_dict(cfg: dict) -> dict:
    """Random weights for any family by the recipe of synth_state_dict, on
    the port's own parameter shapes (seeded on the host): norm scales and
    variances 1, biases and means 0, weights normal with std 1/√fan_in
    (fan_in the input width of a conv or linear layer, the leading extents
    of a CLS token or positional embedding, as in the JAX layout)."""
    from oaprogressionmmf_torch.models import dict_models
    with torch.device("meta"):
        model = dict_models[cfg["name"]](cfg)
    rng = np.random.default_rng(1234)
    sd = {}
    for key, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[key] = torch.tensor(0)
            continue
        if leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
            arr = np.ones(shape, np.float32)
        elif leaf in ("bias", "running_mean"):
            arr = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1] if leaf in ("cls_token",
                                                       "pos_embedding")
                                 else shape[1:]))
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= np.float32(1.0 / np.sqrt(max(fan_in, 1)))
        sd[key] = torch.from_numpy(arr)
    return sd


def family_inputs(cfg: dict, batch: int) -> tuple:
    """Raw uint8 X-rays and MRI volumes at the config's input sizes; each
    knee and MRI slice scaled by its own amplitude, as raw_inputs does."""
    rng = np.random.default_rng(5)
    xs = []
    for size in cfg["input_size"]:
        x = rng.integers(0, 256, (batch, 1, *size), dtype=np.uint8)
        amp = rng.uniform(0.1, 1.0, (batch, 1) + (1,) * (len(size) - 1)
                          + ((size[-1],) if len(size) == 3 else (1,)))
        amp = amp.astype(np.float32)
        xs.append((x * amp).astype(np.uint8))
    return tuple(xs)


def run_family(card: str, cfg: dict, modals, batch: int, requests: int,
               want_k4: int, want_k1: int, label: str) -> float:
    """Serve ``cfg`` in bf16: ``requests`` timed requests with exact launch
    counts, then its logits and probabilities against a float32 run of
    the same weights and inputs; returns the mean request ms."""
    from oaprogressionmmf_torch.serving import make_predictor
    sd = synth_family_state_dict(cfg)
    xs = family_inputs(cfg, batch)
    predictor = make_predictor(cfg, sd, modals, cfg["downscale"],
                               dtype=torch.bfloat16)
    predictor(xs).cpu()                       # warm-up
    latencies = []
    for _ in range(requests):
        t = time.perf_counter()
        probs = predictor(xs).cpu()
        latencies.append(time.perf_counter() - t)
    moved = device_launches(lambda: predictor(xs).cpu(), requests)
    k4, k1 = moved["K4"], moved["K1"]
    logits16 = predictor.logits(xs)
    del predictor
    torch.cuda.empty_cache()
    logits32 = make_predictor(cfg, sd, modals, cfg["downscale"],
                              dtype=torch.float32).logits(xs)
    torch.cuda.empty_cache()
    d_logit = (logits16 - logits32).abs().max().item()
    scale = max(1.0, logits32.abs().max().item())
    d_prob = (torch.softmax(logits16, -1)
              - torch.softmax(logits32, -1)).abs().max().item()
    lat = float(np.mean(latencies) * 1e3)
    ok = (k4 == want_k4 * requests and k1 == want_k1 * requests
          and probs.shape == (batch, 2) and bool(torch.isfinite(probs).all())
          and d_logit <= LOGIT_RTOL * scale and d_prob <= PROB_ATOL)
    log(f"[family] {label}: batch {batch}, {requests} requests, mean "
        f"{lat:.2f} ms per request (min {min(latencies) * 1e3:.2f}) "
        f"[{card}]; launches per request K4 {k4 / requests:g} (want "
        f"{want_k4}), K1 {k1 / requests:g} (want {want_k1}); bf16 against "
        f"float32: max|dlogit| {d_logit:.3e} (tol {LOGIT_RTOL}·{scale:.3f}), "
        f"max|dprob| {d_prob:.3e} (tol {PROB_ATOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label} failed its launch counts or its bf16 "
                         f"against float32 check")
    return lat


def phase_families(card: str) -> dict:
    """Phase 4b: the five other families at full width, then MR1CnnTrf
    with each extra encoder."""
    ms = {}
    for name, (branches, k4, k1) in FAMILIES.items():
        modals = [FAMILY_MODALS[b] for b in branches]
        ms[name] = run_family(card, family_cfg(name), modals, BATCH,
                              FAMILY_REQUESTS, k4, k1, name)
    for arch in ENCODERS:
        label = f"MR1CnnTrf[{arch}]"
        ms[label] = run_family(
            card, family_cfg("MR1CnnTrf", mr_arch=arch), ["sag_3d_dess"],
            ENCODER_BATCH, 1, int(arch == "densenet161"), 4, label)
    return ms


def launch_counts() -> tuple:
    fa = flash_module()
    return (fa.flash_attention.launches, fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv)


def kernel_launches() -> dict:
    """K1-K5's launch counts since the last reset."""
    k1, k2, k3 = launch_counts()
    return {"K1": k1, "K2": k2, "K3": k3,
            "K4": stem_module().fused_bn_relu_pool.launches,
            "K5": int8_module().int8_conv2d.launches}


# K1-K5 by kernel name in a device trace: the port's kernels live in an
# anonymous namespace, PyTorch's own flash kernels do not
DEVICE_KERNELS = re.compile(r"\(anonymous namespace\)::(?:\w+::)*"
                            r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv|"
                            r"bn_relu_pool|int8_conv)_\w+\s*[<(]")
KERNEL_IDS = {"flash_fwd": "K1", "flash_bwd_dq": "K2", "flash_bwd_dkv": "K3",
              "bn_relu_pool": "K4", "int8_conv": "K5"}


def device_launches(fn, calls: int = 1) -> dict:
    """K1-K5's launches on the device over ``calls`` calls of ``fn``,
    counted by kernel name in a profiler trace of the card: a replayed
    CUDA graph runs no Python, so the wrappers' counters miss it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNEL_IDS.values(), 0)
    for e in prof.key_averages():
        m = DEVICE_KERNELS.search(e.key)
        if m:
            counts[KERNEL_IDS[m.group(1)]] += e.count
    return counts


def reset_launch_counts() -> None:
    fa = flash_module()
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    stem_module().fused_bn_relu_pool.launches = 0
    int8_module().int8_conv2d.launches = 0
    gbn_module().global_batch_norm.launches = 0


def train_runtime(sd: dict, model_cfg: dict, dtype):
    from oaprogressionmmf_torch.train.trainer import TrainRuntime
    return TrainRuntime({"model": model_cfg, "training": TRAIN_CFG}, MODALS,
                        model_cfg["downscale"], STEPS_PER_EPOCH,
                        state_dict=sd, dtype=dtype)


def phase_train(card: str, sd: dict) -> tuple:
    """The full-width bf16 training step (phase 5); returns the launch
    counts of the timed steps and their mean ms per step."""
    t0 = time.perf_counter()
    rt = train_runtime(sd, MODEL_CFG, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[train] strict load into TrainRuntime, float32 parameters on "
        f"{rt.device}, bf16 autocast: {time.perf_counter() - t0:.1f} s")
    xs, ys = raw_inputs(TRAIN_BATCH), labels(TRAIN_BATCH)
    gen = torch.Generator(device=rt.device).manual_seed(0)  # augmentation
    torch.manual_seed(0)                                     # dropout
    params0 = {n: p.detach().clone() for n, p in rt.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in rt.model.named_buffers()
              if n.endswith(("running_mean", "running_var"))}

    for _ in range(TRAIN_WARMUP):
        rt.train_step(xs, ys, gen)[0].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    latencies, losses = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss, logits = rt.train_step(xs, ys, gen)
        losses.append(loss.item())
        latencies.append(time.perf_counter() - t)
    counts = launch_counts()
    stem_launches = stem_module().fused_bn_relu_pool.launches
    k5 = int8_module().int8_conv2d.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"[train] {TRAIN_STEPS} steps of batch {TRAIN_BATCH}: launches K1 "
        f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]} (per step "
        f"{[c / TRAIN_STEPS for c in counts]}), K4 {stem_launches}, K5 {k5}; "
        f"losses {losses}")
    if counts != (12 * TRAIN_STEPS,) * 3 or stem_launches != 0 or k5 != 0:
        raise SystemExit(f"expected 12 launches of each of K1, K2 and K3 and "
                         f"none of K4 and K5 per step, got {counts}, "
                         f"{stem_launches} and {k5} over {TRAIN_STEPS}")
    if not all(np.isfinite(losses)) or logits.shape != (TRAIN_BATCH, 2) \
            or not torch.isfinite(logits).all():
        raise SystemExit(f"non-finite loss or bad logits: {losses}")
    stuck, bad = [], []
    for n, p in rt.model.named_parameters():
        if not torch.isfinite(p).all():
            bad.append(n)
        elif torch.equal(p, params0[n]) and not (
                n.startswith(UNREACHED) and not p.any()):
            stuck.append(n)
    for n, b in rt.model.named_buffers():
        if n in stats0:
            if not torch.isfinite(b).all():
                bad.append(n)
            elif torch.equal(b, stats0[n]):
                stuck.append(n)
    n_zero = sum(1 for n, p in rt.model.named_parameters()
                 if n.startswith(UNREACHED) and not p.any())
    log(f"[train] {len(params0)} parameter tensors and {len(stats0)} BN "
        f"running statistics: {len(stuck)} unmoved, {len(bad)} non-finite "
        f"({n_zero} all-zero tensors the loss does not reach may stay)")
    if stuck or bad:
        raise SystemExit(f"unmoved {stuck[:5]}, non-finite {bad[:5]}")
    del params0, stats0

    lat = np.asarray(latencies) * 1e3
    log(f"[train] ms per step (raw host arrays -> loss on host): mean "
        f"{lat.mean():.2f}, min {lat.min():.2f}, max {lat.max():.2f}; "
        f"{TRAIN_BATCH * 1e3 / lat.mean():.2f} knees/s; peak device memory "
        f"{peak_gb:.2f} GB  [{card}]")
    device_breakdown(lambda: rt.train_step(xs, ys, gen)[0].item(),
                     float(lat.mean()), what="training step")
    return counts, float(lat.mean())


def phase_train_check(sd: dict) -> None:
    """One float32 step through K1/K2/K3 against the same step through the
    plain attention (phase 5b)."""
    from oaprogressionmmf_torch.models.feat import Attention
    cfg = copy.deepcopy(MODEL_CFG)
    cfg["fe"]["clin"]["dropout"] = 0.0
    cfg["agg"].update(emb_dropout=0.0, mlp_dropout=0.0)
    torch.backends.cudnn.deterministic = True
    xs, ys = raw_inputs(CHECK_BATCH), labels(CHECK_BATCH)
    runs = {}
    draws = None
    for impl in ("flash", "reference"):
        rt = train_runtime(sd, cfg, torch.float32)
        if draws is None:
            draws = rt.sample_draws(
                torch.Generator(device=rt.device).manual_seed(2), CHECK_BATCH)
        for m in rt.model.modules():
            if isinstance(m, Attention):
                m.attn_impl = impl
        reset_launch_counts()
        loss, _ = rt.train_step(xs, ys, draws=draws)
        runs[impl] = (loss.item(), launch_counts(),
                      {n: rt.optimizer.state[p]["exp_avg"]
                       for n, p in rt.model.named_parameters()})
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    (loss_k, counts_k, mom_k), (loss_r, counts_r, mom_r) = (
        runs["flash"], runs["reference"])
    worst_name, worst = "", 0.0
    failed = []
    for n, m_r in mom_r.items():
        peak = m_r.abs().max().item()
        err = (mom_k[n] - m_r).abs().max().item()
        ratio = err / peak if peak else (0.0 if err == 0 else float("inf"))
        if ratio > worst:
            worst_name, worst = n, ratio
        if ratio > GRAD_RTOL:
            failed.append(n)
    d_loss = abs(loss_k - loss_r) / abs(loss_r)
    log(f"[train-check] float32 batch {CHECK_BATCH}, no dropout: kernels "
        f"(launches {counts_k}) against plain attention (launches "
        f"{counts_r}): loss {loss_k:.8f} vs {loss_r:.8f} (rel {d_loss:.2e}, "
        f"tol {LOSS_RTOL}); largest max|dm|/max|m| over {len(mom_r)} "
        f"tensors {worst:.3e} ({worst_name}; tol {GRAD_RTOL}) "
        f"{'ok' if not failed and d_loss <= LOSS_RTOL else 'FAIL'}")
    if counts_k != (12, 12, 12) or counts_r != (0, 0, 0):
        raise SystemExit(f"launch counts {counts_k} (kernels) and {counts_r} "
                         f"(plain attention); expected 12 each and none")
    if failed or d_loss > LOSS_RTOL:
        raise SystemExit(f"the kernel step disagrees with the plain-attention "
                         f"step: loss rel {d_loss:.2e}, tensors {failed[:8]}")


class SynthKnees:
    """An in-memory dataset of synthetic knees at the prepared sizes of
    ``model_cfg`` (the flagship's: XR 700² and DESS 320²×128 uint8, T2
    320²×25 float32, 9 clinical values). Sample ``idx`` is drawn in
    ``get`` from ``default_rng([seed, idx])``; the labels are a seeded
    permutation with half of each class."""

    def __init__(self, seed: int, count: int, model_cfg: dict):
        self.seed = seed
        self.count = count
        self.sizes = [tuple(s) for s in model_cfg["input_size"]]
        self.labels = np.random.default_rng([seed, count]).permutation(
            np.arange(count) % 2).astype(np.int32)

    def __len__(self):
        return self.count

    def targets(self) -> np.ndarray:
        return self.labels

    def get(self, idx: int, epoch: int = 0) -> dict:
        rng = np.random.default_rng([self.seed, idx])
        xr, dess, t2, _ = self.sizes
        clin = rng.standard_normal((1, 9), dtype=np.float32)
        return {
            "image__xr_pa": rng.integers(0, 256, (1, *xr), dtype=np.uint8),
            "image__sag_3d_dess": rng.integers(0, 256, (1, *dess),
                                               dtype=np.uint8),
            "image__sag_t2_map": rng.random((1, *t2),
                                            dtype=np.float32) * 0.1,
            "image__clin": clin, "clin_vec": clin[0],
            "target": self.labels[idx:idx + 1],
            "exam_knee_id": f"synth{self.seed}__{idx:03d}"}


def fit_state(trainer) -> dict:
    """Every parameter, buffer (BatchNorm statistics) and optimizer moment
    of a trainer's runtime, by name, on the card."""
    rt = trainer.runtime
    state = dict(rt.model.state_dict())
    for key, tensors in rt.optimizer_state().items():
        state.update({f"{key}:{n}": t for n, t in tensors.items()})
    return state


@contextlib.contextmanager
def kernel_inputs(tag=None):
    """Keep a copy of the inputs of the first K1, K4 and K5 launch at each
    shape and type the path gives them: the FeaT's and the FEs' calls of
    the wrappers are wrapped in turn (the wrappers and their counts stay as
    they are). K5 keeps images 0 and N - 1 of its input (and residual) with
    the rows the launch wrote there: a conv maps each image on its own.
    ``tag``, a one-element list, adds its current value to each key (phase
    7 marks full and padded batches); with it K4 too keeps images 0 and
    N - 1 and its output's, so that a timed batch copies a few MB, not
    the stems' GB. A global forward pre-hook, a no-op, is registered
    meanwhile: a Predictor call that a hook must see runs eagerly (a
    replayed CUDA graph runs no Python), so every forward passes through
    the wrappers. Yields {(kernel, shape, types, ...): inputs}."""
    from oaprogressionmmf_torch.models import feat, resnet
    fa, fs, ic = flash_module(), stem_module(), int8_module()
    real = (feat.flash_attention, resnet.stem_epilogue,
            resnet.fused_bn_relu_pool, resnet.int8_conv2d)
    real_flash, real_stem, real_pool, real_conv = real
    seen = {}

    def key_of(*key):
        return key if tag is None else key + (tag[0],)

    def ends(t):
        # images 0 and N - 1 by slices: an index list would copy it to the
        # card and hold the host until the card catches up
        return torch.cat((t[:1], t[-1:]))

    def flash(q, k, v, scale=None):
        before = fa.flash_attention.launches
        out = real_flash(q, k, v, scale)
        key = key_of("K1", tuple(q.shape), q.dtype)
        if fa.flash_attention.launches > before and key not in seen:
            seen[key] = tuple(t.detach().clone() for t in (q, k, v)) \
                + (scale,)
        return out

    def keep_stem(before, y, params, eps, out):
        key = key_of("K4", tuple(y.shape), y.dtype, params[0].dtype)
        if fs.fused_bn_relu_pool.launches > before and key not in seen:
            params = tuple(t.detach().clone() for t in params)
            if tag is None:
                seen[key] = (y.detach().clone(), params, eps, None)
            else:
                cl = torch.channels_last
                seen[key] = (ends(y).contiguous(memory_format=cl), params,
                             eps, ends(out).contiguous(memory_format=cl))

    def stem(y, bn, relu, pool):
        before = fs.fused_bn_relu_pool.launches
        out = real_stem(y, bn, relu, pool)
        keep_stem(before, y, (bn.weight, bn.bias, bn.running_mean,
                              bn.running_var), bn.eps, out)
        return out

    def pool(y, weight, bias, running_mean, running_var, eps=1e-5):
        # the int8 FEs' stem: K5 to float32, then K4
        before = fs.fused_bn_relu_pool.launches
        out = real_pool(y, weight, bias, running_mean, running_var, eps)
        keep_stem(before, y, (weight, bias, running_mean, running_var), eps,
                  out)
        return out

    def conv(x, w, sc, stride=1, padding=0, groups=1, **kw):
        before = ic.int8_conv2d.launches
        out = real_conv(x, w, sc, stride, padding, groups, **kw)
        res = kw.get("res")
        key = key_of("K5", tuple(x.shape), tuple(w.shape), stride, padding,
                     groups, kw.get("bn") is not None,
                     None if res is None else res.dtype,
                     bool(kw.get("relu")), kw.get("out_scale") is not None)
        if ic.int8_conv2d.launches > before and key not in seen:
            kept = {}
            for name, value in kw.items():
                if name == "w_packed" or value is None:
                    continue
                if name == "bn":
                    value = tuple(t.clone() for t in value)
                elif name == "res":
                    value = ends(value)
                elif isinstance(value, torch.Tensor):
                    value = value.clone()
                kept[name] = value
            seen[key] = ((ends(x), w.clone(), sc.clone()), stride, padding,
                         groups, kept, ends(out))
        return out

    (feat.flash_attention, resnet.stem_epilogue, resnet.fused_bn_relu_pool,
     resnet.int8_conv2d) = flash, stem, pool, conv
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, args: None)
    try:
        yield seen
    finally:
        hook.remove()
        (feat.flash_attention, resnet.stem_epilogue,
         resnet.fused_bn_relu_pool, resnet.int8_conv2d) = real


def check_fit_inputs(seen: dict) -> dict:
    """K1 and K4 against their plain versions on the inputs that trainer
    B's epoch gave them (kernel_inputs): K1 at the training steps' and the
    validation batch's (B, 8, N, 256), K4 at the validation batch's three
    stems. Returns each kernel's largest max|Δ|; exits outside a bar or
    where a shape the path should give is missing."""
    batches = (FIT_CONFIG["training"]["batch_size"],
               FIT_CONFIG["validation"]["batch_size"])
    want = {(b, 8, n, FLASH_D) for b in batches for n in MAIN_PATH_N}
    got = {key[1] for key in seen if key[0] == "K1"}
    stems = [key for key in seen if key[0] == "K4"]
    if got != want or len(stems) != len(FLAGSHIP_STEMS):
        raise SystemExit(f"phase 6 gave K1 {sorted(got)} (want "
                         f"{sorted(want)}) and K4 {stems}")
    errs = {"K1": 0.0, "K4": 0.0}
    with torch.inference_mode():
        for key, args in sorted(seen.items(),
                                key=lambda item: str(item[0])):
            if key[0] == "K1":
                errs["K1"] = max(errs["K1"], check_flash(*args))
            else:
                y, params, eps, _ = args
                errs["K4"] = max(errs["K4"], check_stem("fit", y, params,
                                                        eps))
    return errs


def phase_fit(card: str, train_ms: float, root: str) -> tuple:
    """Train, checkpoint and resume the full-width flagship through
    ProgressionTrainer.fit (phase 6) in the experiment directory ``root``;
    trainer A's checkpoint is also fold 1's (a hard link), trainer B's
    stays fold 0's. Returns the launch counts of the resumed epoch and K1's
    and K4's max|Δ| on that epoch's inputs."""
    from oaprogressionmmf_torch.train.trainer import ProgressionTrainer
    datasets = {"train": SynthKnees(FIT_SEED, FIT_TRAIN_KNEES, MODEL_CFG),
                "val": SynthKnees(FIT_SEED + 1, FIT_VAL_KNEES, MODEL_CFG)}
    datasets["test"] = datasets["val"]
    for name in ("train", "val"):
        if set(datasets[name].targets()) != {0, 1}:
            raise SystemExit(f"the {name} knees lack a class")
    cfg = copy.deepcopy(FIT_CONFIG)
    cfg["model"] = copy.deepcopy(MODEL_CFG)
    cfg["path_experiment_root"] = root
    log(f"[fit] checkpoints in {root}: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB free")
    t0 = time.perf_counter()
    first = ProgressionTrainer(cfg, 0, datasets=datasets)
    summary = first.fit()
    torch.cuda.synchronize()
    log(f"[fit] trainer A: epoch 0 in {time.perf_counter() - t0:.1f} s "
        f"(construction included): {first.timing['train_steps']} steps, "
        f"{first.timing['val_batches']} validation batch; best "
        f"{summary['criterion']} {summary['best']} at epoch "
        f"{summary['epoch']}")
    ckpts = sorted(first.path_weights_fold.iterdir())
    want = [f"{MODEL_CFG['name']}__fold_0__epoch_000.ckpt"]
    if [p.name for p in ckpts] != want or summary["epoch"] != 0:
        raise SystemExit(f"checkpoints {ckpts}, want {want}")
    records = [json.loads(line) for line in
               (first.path_logs_fold / "scalars.jsonl").read_text()
               .splitlines()]
    missing = sorted(set(FIT_TAGS) - {r["tag"] for r in records})
    if missing or not all(np.isfinite(r["value"]) for r in records):
        raise SystemExit(f"scalars.jsonl lacks {missing} or holds a "
                         f"non-finite value")

    # fold 1 of phase 7: A's weights, before B's save removes the file
    fold_1 = Path(root) / "weights" / "prog" / "fold_1"
    fold_1.mkdir(parents=True)
    os.link(ckpts[0],
            fold_1 / f"{MODEL_CFG['name']}__fold_1__epoch_000.ckpt")

    cfg["training"]["epochs"]["num"] = 2
    t0 = time.perf_counter()
    resumed = ProgressionTrainer(cfg, 0, datasets=datasets)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    want_state, got_state = fit_state(first), fit_state(resumed)
    differ = [n for n, t in want_state.items()
              if not torch.equal(t, got_state[n])]
    n_moments = sum(1 for n in want_state if ":" in n)
    log(f"[fit] trainer B: resumed at epoch {resumed.start_epoch}, step "
        f"{resumed.runtime.step}, in {t_resume:.1f} s; "
        f"{len(want_state)} tensors ({n_moments} Adam moments) against "
        f"A's: {len(differ)} differ (torch.equal on the card)")
    if (resumed.start_epoch != 1 or resumed.runtime.step != 2 or differ
            or set(want_state) != set(got_state)):
        raise SystemExit(f"resume: epoch {resumed.start_epoch}, step "
                         f"{resumed.runtime.step}, differ {differ[:8]}")
    ckpt_bytes = first.timing["ckpt_bytes"]
    write_s, read_s = first.timing["ckpt_write"], \
        resumed.timing["ckpt_read"]
    # A's freed blocks stay in the allocator's cache for B's steps
    del first, want_state, got_state
    gc.collect()

    step_ms = []
    bare_step = resumed.runtime.train_step

    def timed_step(*args, **kwargs):
        t = time.perf_counter()
        out = bare_step(*args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    resumed.runtime.train_step = timed_step
    epoch_s = {"train": 0.0, "val": 0.0}

    def timed_epoch(kind, bare):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = bare(*args, **kwargs)
            epoch_s[kind] += time.perf_counter() - t
            return out
        return run

    resumed.train_epoch = timed_epoch("train", resumed.train_epoch)
    resumed.val_epoch = timed_epoch("val", resumed.val_epoch)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with kernel_inputs() as seen:
        summary = resumed.fit()
    torch.cuda.synchronize()
    counts = kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = resumed.timing
    log(f"[fit] trainer B: epoch 1 ({tm['train_steps']} steps, "
        f"{tm['val_batches']} validation batch) launches {counts} (want "
        f"{FIT_LAUNCHES}); best {summary['criterion']} "
        f"{summary['best']} at epoch {summary['epoch']}")
    if counts != FIT_LAUNCHES or summary["epoch"] != 1 \
            or not np.isfinite(summary["best"]):
        raise SystemExit(f"fit: launches {counts}, summary {summary}")
    errs = check_fit_inputs(seen)
    del seen
    steps = tm["train_steps"]
    loop_ms = (epoch_s["train"] - tm["loader_wait"]) / steps * 1e3
    log(f"[fit] ms per training step inside fit: the loop less the "
        f"loader wait {loop_ms:.2f}, each step {step_ms} (synchronized) "
        f"against phase 5's bare step {train_ms:.2f}; loader wait per "
        f"step {tm['loader_wait'] / steps * 1e3:.2f} ms; validation "
        f"{epoch_s['val'] / tm['val_batches'] * 1e3:.2f} ms per batch of 16 "
        f"(loader and metrics included); peak device memory "
        f"{peak_gb:.2f} GB  [{card}]")
    t0 = time.perf_counter()
    resumed._ckpt_payload()
    payload_s = time.perf_counter() - t0
    log(f"[fit] checkpoint {ckpt_bytes} bytes: write {write_s:.2f} s "
        f"(epoch 1's {tm['ckpt_write']:.2f} s, of which the payload's "
        f"transposes and copies to the host {payload_s:.2f} s), read and "
        f"restore {read_s:.2f} s  [{card}]")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    return counts, errs


def eval_config(root: str) -> dict:
    """Phase 6's config with prog_fus.yaml's testing and serving subtrees
    (profile=time, one calibration batch), two folds."""
    cfg = copy.deepcopy(FIT_CONFIG)
    cfg["model"] = copy.deepcopy(MODEL_CFG)
    cfg["path_experiment_root"] = root
    cfg["path_logs"] = str(Path(root) / "logs")
    cfg["training"]["folds"]["num"] = EVAL_FOLDS
    cfg["testing"] = copy.deepcopy(EVAL_TESTING)
    cfg["serving"] = dict(EVAL_SERVING)
    cfg["runtime"] = {"compute_dtype": "bfloat16", "n_devices": None,
                      "distributed": {"enable": False}}
    return cfg


def eval_launches(run: str) -> dict:
    """Launches of one phase 7 run, from its forwards: 12 K1 and 3 K4 a
    forward, 159 K5 an int8-all forward. profile=time runs each fold's
    first batch once more; explain runs 1 + 4 forwards a batch; the
    calibration graph (its FEs record float activations and pool unfused)
    runs K1 alone; the export calibrates on 1 validation batch and its
    bundle serves one test batch."""
    batches = -(-EVAL_KNEES // EVAL_TESTING["batch_size"])
    per_fold = batches + (EVAL_TESTING["profile"] == "time")
    if run == "eval":
        bf16, calib, int8 = EVAL_FOLDS * per_fold, 0, 0
    elif run == "explain":
        bf16, calib, int8 = EVAL_FOLDS * batches * (1 + len(MODALS)), 0, 0
    elif run == "int8":
        bf16, calib, int8 = 0, EVAL_FOLDS, EVAL_FOLDS * per_fold
    else:
        bf16, calib, int8 = 0, EVAL_SERVING["calib_batches"], 1
    k1, k4 = sum(MAIN_PATH_N.values()), len(FLAGSHIP_STEMS)
    return {"K1": k1 * (bf16 + calib + int8), "K4": k4 * (bf16 + int8),
            "K5": K5_PER_REQUEST * int8}


def kernel_counts() -> dict:
    return {"K1": flash_module().flash_attention.launches,
            "K4": stem_module().fused_bn_relu_pool.launches,
            "K5": int8_module().int8_conv2d.launches}


@contextlib.contextmanager
def tagged_batches(tag: list):
    """Set ``tag[0]`` to "full" or "padded" as each batch of a loader is
    handed over (for kernel_inputs)."""
    from oaprogressionmmf_torch.data.pipeline import BatchLoader
    real = BatchLoader.epoch

    def epoch(self, epoch_idx: int = 0):
        batches = real(self, epoch_idx)
        try:
            for batch in batches:
                tag[0] = ("padded" if batch["_n_valid"] < self.batch_size
                          else "full")
                yield batch
        finally:
            batches.close()

    BatchLoader.epoch = epoch
    try:
        yield
    finally:
        BatchLoader.epoch = real


@contextlib.contextmanager
def timed(owner, names, record: dict, keep=(), keep_args=()):
    """Wrap ``owner``'s attributes ``names`` (methods or functions): each
    call's seconds, the card synchronized, go to ``record[name]``; the
    results of those in ``keep`` to ``record[name + ":out"]``, the
    arguments (args, kwargs) of those in ``keep_args`` to
    ``record[name + ":in"]``."""
    real = {n: getattr(owner, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            if name in keep_args:
                record.setdefault(name + ":in", []).append((args, kwargs))
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t0)
            if name in keep:
                record.setdefault(name + ":out", []).append(out)
            return out
        return call

    for n, fn in real.items():
        setattr(owner, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(owner, n, fn)


def check_eval_inputs(seen: dict) -> dict:
    """K1, K4 and K5 against their plain versions on the inputs phase 7
    gave them (kernel_inputs), full and padded batches of 16: K1 at (16,
    8, N, 256) bf16; K4 at the three stems in bf16 (eval) and float32 (the
    int8 FEs) and K5 at every conv of the int8 FEs, both on images 0 and
    N - 1 of the launch, the outputs the path got against the plain
    versions (K4 within one bf16 ulp or 1e-6·max|out|, K5 bit for bit).
    Exits outside a bar or where a shape is missing."""
    tags = ("full", "padded")
    heads = MODEL_CFG["agg"]["heads"]
    want = {(EVAL_TESTING["batch_size"], heads, n, FLASH_D, t)
            for n in MAIN_PATH_N for t in tags}
    got = {key[1] + (key[-1],) for key in seen if key[0] == "K1"}
    stems = {(key[2], key[-1]) for key in seen if key[0] == "K4"}
    k5 = [key for key in seen if key[0] == "K5"]
    k5_shapes = {key[1:-1] for key in k5}
    if got != want or len(stems) != 4 or len(
            [key for key in seen if key[0] == "K4"]) != 12 \
            or {key[-1] for key in k5} != set(tags) \
            or len(k5) != 2 * len(k5_shapes):
        raise SystemExit(f"phase 7 gave K1 {sorted(got)} (want "
                         f"{sorted(want)}), K4 {sorted(stems)} and K5 at "
                         f"{len(k5)} keys over {len(k5_shapes)} shapes")
    errs = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
    with torch.inference_mode():
        for key, args in sorted(seen.items(),
                                key=lambda item: str(item[0])):
            if key[0] == "K1":
                errs["K1"] = max(errs["K1"], check_flash(*args[:4]))
            elif key[0] == "K4":
                y, params, eps, out = args
                errs["K4"] = max(errs["K4"], check_stem(
                    f"eval {key[-1]}", y, params, eps, got=out))
            else:
                xs, stride, pad, groups, kw, out = args
                errs["K5"] = max(errs["K5"], check_int8_conv(
                    f"eval {key[-1]}", xs, stride, pad, groups, kw, got=out,
                    quiet=True))
    log(f"[eval] K5 bit for bit its plain version at {len(k5)} launches "
        f"({len(k5_shapes)} conv shapes, full and padded batches; images 0 "
        f"and N - 1 of each)")
    return errs


def softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.amax(x, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def check_keys(what: str, tree: dict, keys) -> None:
    if tuple(tree) != tuple(keys):
        raise SystemExit(f"{what}: keys {list(tree)}, want {list(keys)}")


def explain_recomputed(predictor, xs, ys) -> tuple:
    """Batch attributions by hand: the target's logit less its logit with
    each modality's preprocessed input zeroed; and max|logit|."""
    with torch.inference_mode():
        inputs = predictor.preprocess(predictor.to_device(xs))
        idx = torch.as_tensor(ys).long().to(predictor.device)[:, None]
        out = []
        for m in range(-1, len(inputs)):
            abl = tuple(torch.zeros_like(x) if i == m else x
                        for i, x in enumerate(inputs))
            logits = predictor.model(*abl)
            logits = (logits["main"] if isinstance(logits, dict)
                      else logits).float()
            out.append(logits)
        base = out[0].gather(1, idx)[:, 0]
        attrs = torch.stack([base - o.gather(1, idx)[:, 0]
                             for o in out[1:]], dim=1)
        return attrs.cpu().numpy(), out[0].abs().max().item()


def users_eval_run(cfg: dict, datasets: dict, logs: Path,
                   pickles: dict) -> list:
    """Phase 7's eval run once more as users run it, without
    ``kernel_inputs``' hook, so that each fold's predictor replays its CUDA
    graph from its third call (explain calls the model itself and stays
    eager): every fold-wise answer equal bit for bit to the eager run's in
    ``pickles``. Returns the predictors' counts."""
    import pickle

    from oaprogressionmmf_torch.run import eval_prog_fus
    from oaprogressionmmf_torch.train import evaluator as ev_module

    real, made = ev_module.make_predictor, []

    def kept(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    ev_module.make_predictor = kept
    try:
        eval_prog_fus.run(copy.deepcopy(cfg), datasets=datasets)
    finally:
        ev_module.make_predictor = real
    got = pickle.loads((logs / "eval_fus_raw_foldw.pkl").read_bytes())
    want = pickles["eval"]["eval_fus_raw_foldw"]
    bad = [(k, key) for k in range(EVAL_FOLDS)
           for key in ("predict", "predict_proba")
           if not np.array_equal(np.asarray(got[k][key]),
                                 np.asarray(want[k][key]))]
    counts = [p.counts for p in made]
    log(f"[eval] eval as users run it (predictors' counts {counts}): "
        f"predict and predict_proba of both folds equal to the eager "
        f"run's bit for bit: {not bad}")
    if bad or not all(c["replayed"] for c in counts):
        raise SystemExit(f"phase 7 eval without the hook: answers {bad} "
                         f"differ from the eager run's, or a predictor "
                         f"never replayed: {counts}")
    del made
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_eval(card: str, root: str) -> tuple:
    """Fold evaluation of phase 6's two folds at full width (phase 7):
    eval_prog_fus.run in bf16 with profile=time, with regime=explain and
    with testing.quant=int8, then export_serving.run for fold 0 and one
    test batch served from its bundle; returns each run's launch counts
    and K1's, K4's and K5's max|Δ| on the phase's inputs."""
    import pickle

    from oaprogressionmmf_torch import serving
    from oaprogressionmmf_torch.run import eval_prog_fus, export_serving
    from oaprogressionmmf_torch.train import evaluator as ev_module
    from oaprogressionmmf_torch.train.trainer import _modality_xs

    t_phase = time.perf_counter()
    datasets = {"train": SynthKnees(FIT_SEED, FIT_TRAIN_KNEES, MODEL_CFG),
                "val": SynthKnees(FIT_SEED + 1, FIT_VAL_KNEES, MODEL_CFG),
                "test": SynthKnees(EVAL_SEED, EVAL_KNEES, MODEL_CFG)}
    if set(datasets["test"].targets()) != {0, 1}:
        raise SystemExit("the test knees lack a class")
    cfg = eval_config(root)
    logs = Path(root) / "logs_eval" / "incid"
    Evaluator = ev_module.ProgressionEvaluator
    methods = ("_restore_fold", "eval_epoch", "explain_epoch",
               "_quant_predictor")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tag = ["none"]
    counts, records, pickles, seconds = {}, {}, {}, {}
    with kernel_inputs(tag) as seen, tagged_batches(tag):
        for run, overrides in EVAL_RUNS:
            c = copy.deepcopy(cfg)
            c["testing"].update(overrides)
            records[run] = rec = {}
            # the eval run's restored weights and the int8 run's
            # calibrations are kept for the checks
            keep = {"eval": ("_restore_fold",),
                    "int8": ("calibrate_quant_acts",)}.get(run, ())
            with timed(Evaluator, methods, rec, keep), \
                    timed(ev_module, ("calibrate_quant_acts",), rec, keep):
                reset_launch_counts()
                t0 = time.perf_counter()
                eval_prog_fus.run(c, datasets=datasets)
                torch.cuda.synchronize()
                seconds[run] = time.perf_counter() - t0
                counts[run] = kernel_counts()
            stem = "explain_fus" if run == "explain" else "eval_fus"
            pickles[run] = {
                p.stem: pickle.loads(p.read_bytes())
                for p in sorted(logs.glob(f"{stem}_*.pkl"))}
            gc.collect()
            torch.cuda.empty_cache()
        c = copy.deepcopy(cfg)
        c["testing"]["folds"]["idx"] = 0
        records["export"] = rec = {}
        with timed(serving, ("calibrate_quant_acts",), rec):
            reset_launch_counts()
            t0 = time.perf_counter()
            paths = export_serving.run(c, datasets=datasets)
            torch.cuda.synchronize()
            seconds["export"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            bundle = serving.load_serving_bundle(paths[0])
            seconds["load"] = time.perf_counter() - t0
            loader = datasets["test"]
            batch = [loader.get(i) for i in range(EVAL_TESTING["batch_size"])]
            xs1 = _modality_xs({k: np.stack([b[k] for b in batch])
                                for k in batch[0] if k.startswith("image__")},
                               MODALS)
            served = bundle(xs1).cpu()
            counts["export"] = kernel_counts()
    users_eval_run(cfg, datasets, logs, pickles)
    bundle_bytes = sum(f.stat().st_size for f in paths[0].iterdir())
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # launches, exact
    for run in counts:
        want = eval_launches(run)
        log(f"[eval] {run}: launches {counts[run]} (want {want})")
        if counts[run] != want:
            raise SystemExit(f"phase 7 {run}: launches {counts[run]}, want "
                             f"{want}")

    # the pickles: JAX's names and keys
    ev, ex, q8 = pickles["eval"], pickles["explain"], pickles["int8"]
    names = {"eval": ["eval_fus_metrics_ens", "eval_fus_metrics_foldw",
                      "eval_fus_raw_ens", "eval_fus_raw_foldw"],
             "explain": ["explain_fus_raw_ens", "explain_fus_raw_foldw"]}
    for run in EVAL_RUNS:
        want = names["explain" if run[0] == "explain" else "eval"]
        if sorted(pickles[run[0]]) != want:
            raise SystemExit(f"{run[0]} pickles {sorted(pickles[run[0]])}, "
                             f"want {want}")
    folds = list(range(EVAL_FOLDS))
    for k in folds:
        check_keys(f"eval fold {k}", ev["eval_fus_raw_foldw"][k], EVAL_KEYS)
        check_keys(f"int8 fold {k}", q8["eval_fus_raw_foldw"][k], EVAL_KEYS)
        check_keys(f"explain fold {k}", ex["explain_fus_raw_foldw"][k],
                   EXPLAIN_KEYS)
        for run in (ev, q8):
            check_keys(f"metrics fold {k}", run["eval_fus_metrics_foldw"][k],
                       METRIC_KEYS)
    for run in (ev, q8):
        check_keys("ensemble", run["eval_fus_raw_ens"], EVAL_ENS_KEYS)
        check_keys("ensemble metrics", run["eval_fus_metrics_ens"],
                   METRIC_KEYS)
    check_keys("explain ensemble", ex["explain_fus_raw_ens"],
               EXPLAIN_ENS_KEYS)
    raw = ev["eval_fus_raw_foldw"]
    ids = [f"synth{EVAL_SEED}__{i:03d}" for i in range(EVAL_KNEES)]
    for run in (ev, q8):
        for k in folds:
            r = run["eval_fus_raw_foldw"][k]
            p = np.asarray(r["predict_proba"])
            if r["exam_knee_id"] != ids or p.shape != (EVAL_KNEES, 2) \
                    or not np.isfinite(p).all() \
                    or r["target"] != datasets["test"].targets().tolist():
                raise SystemExit(f"fold {k}: knees, targets or "
                                 f"probabilities wrong: {p.shape}")

    # the ensemble: the double softmax of the fold-wise probabilities
    ens_errs = []
    for run in (ev, q8):
        probs = np.stack([np.asarray(run["eval_fus_raw_foldw"][k]
                                     ["predict_proba"]) for k in folds], 1)
        want = softmax_np(np.mean(probs, axis=1))
        got = np.asarray(run["eval_fus_raw_ens"]["predict_proba"])
        ens_errs.append(float(np.abs(got - want).max()))
        if ens_errs[-1] > ENSEMBLE_ATOL or run["eval_fus_raw_ens"][
                "predict"] != np.argmax(want, axis=1).tolist():
            raise SystemExit(f"the ensemble is not the double softmax: "
                             f"{ens_errs[-1]:.3e}")
    log(f"[eval] ensembles (bf16, int8) against the double softmax of the "
        f"fold-wise pickle: max|d| {ens_errs} (tol {ENSEMBLE_ATOL}); "
        f"ensemble roc_auc {ev['eval_fus_metrics_ens']['roc_auc']}, int8 "
        f"{q8['eval_fus_metrics_ens']['roc_auc']}")

    # each fold's first batch against make_predictor on its weights (bf16,
    # and int8-all on the evaluator's calibration); the explain
    # attributions against a recomputation on that predictor; int8 against
    # bf16 at phase 4c's centred bar
    ys1 = datasets["test"].targets()[:EVAL_TESTING["batch_size"]]
    int8_cfg = serving.quantized_model_config(MODEL_CFG, "int8-all")
    for k, sd, quant_acts in zip(
            folds, records["eval"]["_restore_fold:out"],
            records["int8"]["calibrate_quant_acts:out"]):
        predictor = serving.make_predictor(MODEL_CFG, sd, MODALS,
                                           MODEL_CFG["downscale"])
        want = predictor(xs1).cpu().numpy()
        got = np.asarray(raw[k]["predict_proba"][:len(want)])
        err = float(np.abs(got - want).max())
        attrs, peak = explain_recomputed(predictor, xs1, ys1)
        got_attrs = np.asarray(ex["explain_fus_raw_foldw"][k]
                               ["modal_abl_attrs"][:len(attrs)])
        err_attrs = float(np.abs(got_attrs - attrs).max())
        bar = LOGIT_RTOL * max(1.0, peak)
        seen_bf16 = capture(predictor, xs1)
        segments = token_segments(predictor.model)
        del predictor
        predictor = serving.make_predictor(
            int8_cfg, sd, MODALS, MODEL_CFG["downscale"],
            quant_acts=quant_acts)
        want_q = predictor(xs1).cpu().numpy()
        got_q = np.asarray(q8["eval_fus_raw_foldw"][k]["predict_proba"]
                           [:len(want_q)])
        err_q = float(np.abs(got_q - want_q).max())
        log(f"[eval] fold {k}: batch 1 probabilities against make_predictor "
            f"max|d| {err:.3e} bf16, {err_q:.3e} int8-all (tol "
            f"{EVAL_PROB_ATOL}; equal {np.array_equal(got, want)}, "
            f"{np.array_equal(got_q, want_q)}); explain attributions against "
            f"the recomputation max|d| {err_attrs:.3e} (tol {bar:.3e}); mean "
            f"attribution per modality {attrs.mean(axis=0).tolist()}")
        if max(err, err_q) > EVAL_PROB_ATOL or err_attrs > bar:
            raise SystemExit(f"fold {k}: the evaluator disagrees with "
                             f"make_predictor ({err:.3e}, {err_q:.3e}) or the "
                             f"explain recomputation ({err_attrs:.3e})")
        # phase 6's weights leave the MRI tokens' input-driven share at
        # ~1% (measured on an H100), below int8's rounding: the centred bar
        # is reported, the logits held to phase 4's bars
        compare_int8(capture(predictor, xs1), seen_bf16, segments,
                     f"phase 7 fold {k}", hold_centred=False)
        del predictor, seen_bf16
    del records["eval"]["_restore_fold:out"], sd
    gc.collect()
    torch.cuda.empty_cache()
    if np.array_equal(raw[0]["predict_proba"], raw[1]["predict_proba"]):
        raise SystemExit("the two folds gave the same probabilities")
    d_prob = max(float(np.abs(np.asarray(q8["eval_fus_raw_foldw"][k]
                                         ["predict_proba"])
                              - np.asarray(raw[k]["predict_proba"])).max())
                 for k in folds)
    log(f"[eval] int8 against bf16 over the {EVAL_KNEES} knees of both "
        f"folds: max|dprob| {d_prob:.4e} (not held to a limit)")
    if not torch.isfinite(served).all() or \
            (served.sum(dim=1) - 1).abs().max().item() > 1e-5:
        raise SystemExit(f"the served bundle's probabilities: {served}")

    errs = check_eval_inputs(seen)
    del seen

    for run in ("eval", "int8"):
        raw_run = pickles[run]["eval_fus_raw_foldw"]
        lat = {key: [raw_run[k][key] * 1e3 for k in folds]
               for key in EVAL_KEYS[4:]}
        log(f"[eval] {run}: ms per knee at batch 16 (per fold, warm-up "
            f"excluded; the padded batch's 4 knees carry its time): "
            f"{json.dumps(lat)}  [{card}]")
    for run in ("eval", "explain", "int8"):
        rec = records[run]
        restore = rec["_restore_fold"]
        epoch = rec.get("explain_epoch" if run == "explain"
                        else "eval_epoch")
        log(f"[eval] {run}: {seconds[run]:.2f} s in all; per fold, restore "
            f"included, {[round(a + b, 3) for a, b in zip(restore, epoch)]}"
            f" s; restore {[round(t, 3) for t in restore]} s  [{card}]")
    batches = -(-EVAL_KNEES // EVAL_TESTING["batch_size"])
    per_batch = [round(t / batches * 1e3, 2)
                 for t in records["explain"]["explain_epoch"]]
    log(f"[eval] explain: {per_batch} ms per batch of 16 (5 forwards; per "
        f"fold)  [{card}]")
    log(f"[eval] int8 calibration (first 16 rows of the first test batch): "
        f"{[round(t, 3) for t in records['int8']['calibrate_quant_acts']]} "
        f"s; calibration and the int8 model's build "
        f"{[round(t, 3) for t in records['int8']['_quant_predictor']]} s  "
        f"[{card}]")
    log(f"[eval] export_serving (fold 0, int8-all, 1 calibration batch): "
        f"{seconds['export']:.2f} s (calibration "
        f"{records['export']['calibrate_quant_acts'][0]:.3f} s), bundle "
        f"{bundle_bytes} bytes, loaded in {seconds['load']:.2f} s; served "
        f"probabilities of knee 0 {served[0].tolist()}  [{card}]")
    log(f"[eval] peak device memory {peak_gb:.2f} GB; phase 7 "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return counts, errs


def write_prep_series(root: Path) -> tuple:
    """Write phase 8's three series under ``root`` with the port's dcmwrite
    in the ``<release>/<patient>/<date>/<series>`` layout; returns their
    directories and the MESE's known T2 map (slices, rows, cols)."""
    from oaprogressionmmf_torch.utils.dicom import dcmwrite

    rng = np.random.default_rng(PREP_SEED)
    base = root.joinpath(*PREP_ROOT)

    def write(sdir, i, pix, series, explicit=True, **extra):
        sdir.mkdir(parents=True, exist_ok=True)
        elements = {
            "PatientID": PREP_ROOT[1], "SeriesDescription": series,
            "Rows": pix.shape[0], "Columns": pix.shape[1],
            "BitsAllocated": 16, "PixelRepresentation": 0,
            "SamplesPerPixel": 1, "PixelSpacing": [0.36, 0.36],
            "PhotometricInterpretation": "MONOCHROME2",
            "BodyPartExamined": "KNEE", "InstanceNumber": i + 1,
            "PixelData": pix.astype(np.uint16).tobytes(), **extra}
        dcmwrite(sdir / f"{i:04d}.dcm", elements, explicit=explicit)

    def phantom(rows, cols, level, spread):
        """A smooth field with noise, as an MR slice is smoother than
        noise (its compression is closer to a real scan's)."""
        r, c = np.meshgrid(np.linspace(-1, 1, rows), np.linspace(-1, 1, cols),
                           indexing="ij")
        field = level * np.exp(-(r * r + c * c)) + spread * np.cos(3 * r) * c
        return field + rng.normal(0.0, spread / 8, (rows, cols))

    dess = base / "10001"
    rows, cols, n = PREP_DESS
    for i in range(n):   # sagittal: rows along +y (P), cols along -z (I)
        pix = np.clip(phantom(rows, cols, 1500.0, 300.0), 0, 2040)
        write(dess, i, pix, "SAG_3D_DESS_RIGHT", SliceThickness=0.7,
              ImagePositionPatient=[-0.7 * i, 0.0, 0.0],
              ImageOrientationPatient=[0, 1, 0, 0, 0, -1])
    tse = base / "10002"
    rows, cols, n = PREP_TSE
    for i in range(n):   # coronal: rows along -x (R), cols along -z (I)
        pix = np.clip(phantom(rows, cols, 20000.0, 4000.0), 0, 65535)
        write(tse, i, pix, "COR_IW_TSE_RIGHT", explicit=False,
              SliceThickness=3.0, ImagePositionPatient=[0.0, -3.0 * i, 0.0],
              ImageOrientationPatient=[-1, 0, 0, 0, 0, -1])
    mese = base / "10003"
    n, echoes, size = PREP_MESE
    t2 = rng.uniform(*PREP_T2, (n, size, size))
    amp = rng.uniform(*PREP_AMP, (n, size, size))
    for s in range(n):
        for e in range(echoes):
            pix = amp[s] * np.exp(-(PREP_TES_MS[e] / 1e3) / t2[s])
            pix = np.clip(np.rint(pix + rng.normal(0.0, PREP_NOISE,
                                                   pix.shape)), 0, 65535)
            pix[PREP_ZERO] = 0
            te = {} if s == PREP_NO_TE else {"EchoTime": PREP_TES_MS[e]}
            write(mese, s * echoes + e, pix, "SAG_T2_MAP_RIGHT",
                  SliceThickness=3.0, SliceLocation=float(s),
                  EchoNumbers=e + 1,
                  ImageOrientationPatient=[0, 1, 0, 0, 0, -1], **te)
    return (dess, tse, mese), t2


def unclamped_t2_f64(ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """-1/B of fit_t2_map's normal equations in float64 (numpy); the echo
    times ``xs`` broadcast against the samples ``ys`` (echoes last)."""
    xs = xs.astype(np.float64)
    ys = ys.astype(np.float64)
    with np.errstate(all="ignore"):
        lny = np.log(ys)
        s_x2_y = (xs * xs * ys).sum(-1)
        s_y_lny = (ys * lny).sum(-1)
        s_x_y = (xs * ys).sum(-1)
        s_x_y_lny = (xs * ys * lny).sum(-1)
        s_y = ys.sum(-1)
        b = (s_y * s_x_y_lny - s_x_y * s_y_lny) / (s_y * s_x2_y
                                                   - s_x_y * s_x_y)
        return -1.0 / b


def check_t2_fit(got: np.ndarray, vol: np.ndarray, tes: np.ndarray,
                 t2_true: np.ndarray) -> dict:
    """The card's fit against the CPU's on the same float32 volume (1e-4
    relative and 1e-5 s, both, where both are valid; a validity flip only
    where the float64 fit lies within T2_FLIP_BAND·val_high of a clamp
    bound), the slice without EchoTime and the zero block 0, and the known
    T2 within T2_TRUE_RTOL on the pixels with signal. Exits outside a
    bar."""
    from oaprogressionmmf_torch.ops.t2_fit import fit_t2_map
    t0 = time.perf_counter()
    cpu = fit_t2_map(vol, tes, device="cpu")
    cpu_s = time.perf_counter() - t0
    valid_g, valid_c = got != 0, cpu != 0
    both = valid_g & valid_c
    diff = np.abs(got[both] - cpu[both])
    rel = diff / np.abs(cpu[both])
    flips = valid_g != valid_c
    t64 = unclamped_t2_f64(vol[flips], tes[np.nonzero(flips)[0]])
    near = np.minimum(np.abs(t64), np.abs(t64 - T2_VAL_HIGH))
    signal = np.ones(got.shape, bool)
    signal[PREP_NO_TE] = False
    signal[(slice(None),) + PREP_ZERO] = False
    rel_true = np.abs(got[signal] - t2_true[signal]) / t2_true[signal]
    out = {"max_abs_err_vs_cpu": float(diff.max(initial=0.0)),
           "max_rel_err_vs_cpu": float(rel.max(initial=0.0)),
           "validity_flips": int(flips.sum()),
           "max_flip_distance_s": float(near.max(initial=0.0)),
           "max_rel_err_vs_known": float(rel_true.max()),
           "valid_pixels": int(valid_g.sum()), "pixels": int(got.size),
           "cpu_fit_s": round(cpu_s, 3)}
    log(f"[prep] T2 fit: the card against the CPU and the known T2: "
        f"{json.dumps(out)}")
    if (np.any(diff > T2_ATOL) or np.any(rel > T2_RTOL)
            or not np.all(near <= T2_FLIP_BAND * T2_VAL_HIGH)  # NaN fails
            or got[~signal].any() or cpu[~signal].any()
            or rel_true.max() > T2_TRUE_RTOL):
        raise SystemExit(f"T2 fit outside its bars: {out}")
    return out


def gzip_routes(paths: dict, card: str, reps: int = 3) -> dict:
    """The native gzip route against Python's codec on the prepared files:
    ``nifti_to_numpy`` as the dataset reads each (inflate) and
    ``write_nifti`` of the same array (deflate), timed with the route as
    it is and with ``utils/formats.py``'s native call switched off (the
    branch it takes when the library is unavailable); best of ``reps``.
    Both routes must give the same array and the same inflated bytes."""
    import gzip

    from oaprogressionmmf_torch.data.dataset import _SEQ_SPEC
    from oaprogressionmmf_torch.utils import formats

    def best(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3, res

    out = {}
    native = (formats.inflate_gz, formats.deflate_gz)
    python = (lambda path: None, lambda data, path, level=6: False)
    for seq, path in paths.items():
        remap = {"ipr": {"ras_to_ipr": True},
                 "irp": {"ras_to_irp": True}}[_SEQ_SPEC[seq]["reader"]]
        data, affine = formats.read_nifti(path, preserve_dtype=True)
        want, _ = formats.nifti_to_numpy(path, preserve_dtype=True, **remap)
        with gzip.open(path, "rb") as f:
            want_bytes = f.read()
        rec = out[seq] = {}
        for name, route in (("native", native), ("python", python)):
            dst = Path(path).with_name(f"{name}.nii.gz")
            formats.inflate_gz, formats.deflate_gz = route
            try:
                rec[f"read_ms_{name}"], (back, _) = best(
                    lambda: formats.nifti_to_numpy(path, preserve_dtype=True,
                                                   **remap))
                rec[f"write_ms_{name}"], _ = best(
                    lambda: formats.write_nifti(data, dst, affine=affine))
            finally:
                formats.inflate_gz, formats.deflate_gz = native
            rec[f"bytes_{name}"] = dst.stat().st_size
            with gzip.open(dst, "rb") as f:
                if f.read() != want_bytes or not np.array_equal(back, want):
                    raise SystemExit(f"{seq}: the {name} gzip route gave "
                                     f"other bytes or another array")
    log(f"[prep] gzip, native route against Python's codec (ms, best of "
        f"{reps}; read = nifti_to_numpy as the dataset reads, write = "
        f"write_nifti; the native route deflates only in a libdeflate "
        f"build, at level 6, Python's codec at level 9): {json.dumps(out)}"
        f"  [{card}]")
    return out


def phase_prep(card: str) -> dict:
    """Data preparation (phase 8): phase 8's DICOM series through the
    port's prepare_data_mri_oai.handle_series with no device argument (the
    T2 fit on the card); the fit held against the CPU's and the known T2;
    each written image.nii.gz read back as the dataset reads it, equal to
    the array that went into the writer and at least the dataset's
    min_shape. Returns the phase's record."""
    from oaprogressionmmf_torch.data.dataset import _SEQ_SPEC
    from oaprogressionmmf_torch.ops.t2_fit import fit_t2_map_torch
    from oaprogressionmmf_torch.run import prepare_data_mri_oai as prep
    from oaprogressionmmf_torch.utils import native_io
    from oaprogressionmmf_torch.utils.formats import nifti_to_numpy

    t_phase = time.perf_counter()
    route = native_io.route()
    log(f"[prep] native gzip: {route} (the library built with g++ from "
        f"oaprogressionmmf_torch/native/fast_inflate.cpp; 'unavailable' "
        f"means Python's gzip codec both ways)")
    stages = ("_read_series_slices", "assemble_4d_mese", "reorient_to",
              "preproc_compress_series", "fit_t2_map", "numpy_to_nifti")
    record = {}
    with tempfile.TemporaryDirectory(prefix="prep_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        series, t2_true = write_prep_series(root / "raw")
        log(f"[prep] wrote {sum(len(list(d.iterdir())) for d in series)} "
            f"DICOM files (DESS {PREP_DESS}, TSE {PREP_TSE}, MESE "
            f"{PREP_MESE[0]} slices x {PREP_MESE[1]} echoes of "
            f"{PREP_MESE[2]}²) in {time.perf_counter() - t0:.2f} s")
        config = {"dir_root_output": str(root / "out")}
        per_series = {}
        for sdir in series:
            rec = {}
            with timed(prep, stages, rec, keep=("fit_t2_map",),
                       keep_args=("fit_t2_map", "numpy_to_nifti")):
                t0 = time.perf_counter()
                meta = prep.handle_series(config, str(sdir))
                total = time.perf_counter() - t0
            if meta is None:
                raise SystemExit(f"handle_series skipped {sdir}")
            per_series[meta["sequence"]] = (meta, rec, total)

        out = {"native_route": route, "series": {}}
        for seq, (meta, rec, total) in per_series.items():
            (stack, path), kw = rec["numpy_to_nifti:in"][0]
            spec = _SEQ_SPEC[seq]
            remap = {"ipr": {"ras_to_ipr": True},
                     "irp": {"ras_to_irp": True}}[spec["reader"]]
            back, spacings = nifti_to_numpy(path, preserve_dtype=True,
                                            **remap)
            shape_ok = all(a >= b for a, b in zip(back.shape,
                                                  spec["min_shape"]))
            if (back.dtype != stack.dtype or back.shape != stack.shape
                    or not np.array_equal(back, stack) or not shape_ok
                    or (seq == "SAG_3D_DESS" and back.max() > 255)):
                raise SystemExit(
                    f"{seq}: read back {back.dtype} {back.shape} against "
                    f"the writer's {stack.dtype} {stack.shape} (equal: "
                    f"{np.array_equal(back, stack)}), min_shape "
                    f"{spec['min_shape']}")
            secs = {k: round(sum(v), 3) for k, v in rec.items()
                    if not k.endswith((":in", ":out"))}
            out["series"][seq] = s_rec = {
                "shape": list(back.shape), "dtype": str(back.dtype),
                "bytes_written": Path(path).stat().st_size,
                "bytes_raw": int(back.nbytes), "seconds": secs,
                "seconds_total": round(total, 3)}
            log(f"[prep] {seq}: {json.dumps(s_rec)}; read back equal to "
                f"the writer's array, min_shape {spec['min_shape']} met  "
                f"[{card}]")
        out["gzip"] = gzip_routes(
            {seq: rec["numpy_to_nifti:in"][0][0][1]
             for seq, (_, rec, _) in per_series.items()}, card)

        # the fit: the path's volume and its map from the card
        meta, rec, _ = per_series["SAG_T2_MAP"]
        (vol, tes), kw = rec["fit_t2_map:in"][0]
        # where handle_series with no device argument resolves: the card
        if kw.get("device") != prep.resolve_device() \
                or vol.dtype != np.float32:
            raise SystemExit(f"the fit was asked for device "
                             f"{kw.get('device')} with a {vol.dtype} volume")
        fit = check_t2_fit(rec["fit_t2_map:out"][0], vol, tes, t2_true)
        vol_d = torch.from_numpy(vol).cuda()
        tes_d = torch.from_numpy(tes).cuda()
        dev_ms = time_ms(lambda: fit_t2_map_torch(vol_d, tes_d), 20)
        nbytes = vol.nbytes + tes.nbytes + vol[..., 0].nbytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fit.update(device_ms=dev_ms, bound_ms=bound_ms, bound_by="bytes",
                   call_s=round(sum(rec["fit_t2_map"]), 4),
                   volume=list(vol.shape))
        out["t2_fit"] = fit
        log(f"[prep] T2 fit on the card: {dev_ms:.4f} ms of device time "
            f"for a {list(vol.shape)} float32 volume, against a "
            f"{bound_ms:.4f} ms bound (the volume read once, the map "
            f"written once, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); the "
            f"path's call, copies in and out included, "
            f"{fit['call_s'] * 1e3:.1f} ms  [{card}]")
        del vol_d, tes_d
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"[prep] phase 8 {out['seconds']} s  [{card}]")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def par_config(dropout: bool) -> dict:
    """The flagship's config; without dropout for the runs held against
    each other (phase 5b's)."""
    cfg = copy.deepcopy(MODEL_CFG)
    if not dropout:
        cfg["fe"]["clin"]["dropout"] = 0.0
        cfg["agg"].update(emb_dropout=0.0, mlp_dropout=0.0)
    return cfg


def par_runtime(sd: dict, model_cfg: dict, dtype, training=None, **kw):
    from oaprogressionmmf_torch.train.trainer import TrainRuntime
    return TrainRuntime({"model": model_cfg,
                         "training": dict(TRAIN_CFG, **(training or {}))},
                        MODALS, model_cfg["downscale"], STEPS_PER_EPOCH,
                        state_dict=sd, dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def par_batch(batch: int, k: int) -> tuple:
    """Step k's knees of phase 9's float32 runs: raw inputs and labels of
    their own seeds, so that each step sees other knees."""
    return raw_inputs(batch, seed=PAR_SEED + k), labels(batch, seed=1 + k)


def par_steps(rt, data, steps: int, first: int = 0) -> tuple:
    """``steps`` training steps, step k on the knees ``data(k)`` (raw
    inputs, labels), its augmentation drawn from seed PAR_SEED + k and its
    dropout from seed k; returns the losses and each step's synchronized
    ms."""
    losses, ms = [], []
    for k in range(first, first + steps):
        xs, ys = data(k)      # this rank's knees
        batch = len(ys)
        gen = torch.Generator(device=rt.device).manual_seed(PAR_SEED + k)
        torch.manual_seed(k)
        t = time.perf_counter()
        loss, _ = rt.train_step(xs, ys, draws=rt.sample_draws(gen, batch))
        losses.append(loss.item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms


def f64_moments(sd: dict, cfg: dict, data, dp=None, tp=None) -> dict:
    """Adam's first moment (0.1 of the gradient) after one step of the
    float64 model with the plain attention and (``dp``) the global
    BatchNorm's plain version, on the host; with ``tp`` the grid's moments
    made whole (``parallel.tp.unshard``)."""
    from oaprogressionmmf_torch.models.feat import Attention
    from oaprogressionmmf_torch.parallel.tp import unshard
    rt = par_runtime(sd, cfg, torch.float32, dp=dp, tp=tp)
    for m in rt.model.modules():
        if isinstance(m, Attention):
            m.attn_impl = "reference"
    plain_global_bn(rt.model)
    rt.model.double()
    par_steps(rt, data, 1)
    out = {n: rt.optimizer.state[p]["exp_avg"]
           for n, p in rt.model.named_parameters()}
    if tp is not None:
        out = unshard(out, tp)
    out = {n: m.cpu() for n, m in out.items()}
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_validate(rt, xs) -> torch.Tensor:
    """One validation batch as ``fit`` runs it: eval mode, inference
    mode, the runtime's autocast; K1 12 and K4 3 launches."""
    from oaprogressionmmf_torch.train.trainer import make_preprocess_fn
    pre = make_preprocess_fn(MODALS, MODEL_CFG["downscale"], train=False)
    autocast = (torch.autocast(rt.device.type, dtype=rt.dtype)
                if rt.dtype != torch.float32 else contextlib.nullcontext())
    rt.model.eval()
    try:
        with torch.inference_mode(), autocast:
            out = rt.model(*pre(rt.to_device(xs)))["main"].float()
    finally:
        rt.model.train()
    if not torch.isfinite(out).all():
        raise SystemExit("a non-finite validation logit")
    return out


def want_launches(steps: int, validations: int = 1) -> dict:
    return {"K1": 12 * (steps + validations), "K2": 12 * steps,
            "K3": 12 * steps, "K4": 3 * validations, "K5": 0}


def tp_worker(path_plan: str, rank: int) -> int:
    """One rank of phase 9b's dp×tp = 1×2 grid (``python3 chip_smoke.py
    tp-worker PLAN RANK``): gloo on the one card, phase 9a's float32 DP
    run's steps, then a validation forward; rank 0 saves the unsharded
    parameters. Then one float64 step of the grid with the plain
    attention: rank 0 holds its unsharded Adam first moment against 9a's
    float64 DP step's (saved at ``plan["m64"]``) and saves each tensor's
    max|dm|/max|m|."""
    import torch.distributed as dist

    from oaprogressionmmf_torch.parallel.mesh import DataParallel
    from oaprogressionmmf_torch.parallel.tp import (create_grid,
                                                    full_state_dict)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    plan = json.loads(Path(path_plan).read_text())
    # not initialize_distributed: it takes NCCL on the card, which refuses
    # two ranks on one device
    torch.cuda.set_device(TP_DEVICE)
    dist.init_process_group(TP_BACKEND, init_method=f"tcp://{plan['addr']}",
                            world_size=PAR_TP, rank=rank)
    dp_group, tp_group = create_grid(1, PAR_TP)
    sd = torch.load(plan["sd"], map_location="cpu", weights_only=True,
                    mmap=True)
    from oaprogressionmmf_torch.models.feat import Attention
    rt = par_runtime(sd, par_config(False), torch.float32,
                     dp=DataParallel(dp_group), tp=tp_group)
    heads = sorted({m.heads for m in rt.model.modules()
                    if isinstance(m, Attention)})
    data = functools.partial(par_batch, CHECK_BATCH)
    reset_launch_counts()
    losses, ms = par_steps(rt, data, PAR_STEPS)
    par_validate(rt, data(0)[0])
    torch.cuda.synchronize()
    out = {"losses": losses, "ms": ms, "launches": kernel_launches(),
           "gbn": gbn_module().global_batch_norm.launches,
           "layers": len(global_bns(rt.model)),
           "heads": heads, "rank": dist.get_rank(tp_group)}
    full = full_state_dict(rt.model, tp_group)
    if rank == 0:
        names = [n for n, _ in rt.model.named_parameters()]
        out["params"] = {n: full[n].cpu() for n in names}
    del rt, full
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = f64_moments(sd, par_config(False), data,
                      dp=DataParallel(dp_group), tp=tp_group)
    out["f64_s"] = time.perf_counter() - t0
    if rank == 0:
        want = torch.load(plan["m64"], map_location="cpu", weights_only=True,
                          mmap=True)
        if set(got) != set(want):
            raise SystemExit(f"grid moments: names differ, e.g. "
                             f"{sorted(set(got) ^ set(want))[:4]}")
        out["moment_ratio"] = {
            n: ((got[n] - m).abs().max()
                / m.abs().max().clamp_min(1e-300)).item()
            for n, m in want.items()}
    torch.save(out, f"{plan['out']}.{rank}")
    dist.destroy_process_group()
    return 0


def worker_command(mode: str, path_plan: str, rank: int) -> list:
    return [sys.executable, str(REPO / "chip_smoke.py"), mode, path_plan,
            str(rank)]


def run_workers(mode: str, plan: dict, tmp: str, n: int) -> tuple:
    """Start ``n`` processes of ``python3 chip_smoke.py MODE PLAN RANK``,
    wait for them, and return each rank's saved result and the wall
    seconds; a rank that fails stops the run with its output."""
    Path(f"{tmp}/plan.json").write_text(json.dumps(plan))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        worker_command(mode, f"{tmp}/plan.json", r), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=PAR_TP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"{mode} rank {r} exited {p.returncode}:\n"
                             f"{text[-6000:]}")
    return ([torch.load(f"{plan['out']}.{r}", weights_only=False)
             for r in range(n)], time.perf_counter() - t0)


def gbn_layers(sd: dict, dp) -> list:
    """The input of every train-mode BatchNorm of one bf16 DP step at
    GBN_RANK_BATCH knees a rank, in call order: (shape, dtype, channels
    last, the BatchNorm's parameter dtype)."""
    rt = par_runtime(sd, MODEL_CFG, torch.bfloat16, dp=dp)
    seen = []

    def hook(m, args):
        x = args[0]
        seen.append((tuple(x.shape), x.dtype,
                     x.is_contiguous(memory_format=torch.channels_last)
                     and not x.is_contiguous(), m.weight.dtype))

    handles = [m.register_forward_pre_hook(hook) for m in global_bns(rt.model)]
    xs, ys = raw_inputs(GBN_RANK_BATCH), labels(GBN_RANK_BATCH)
    par_steps(rt, lambda k: (xs, ys), 1)
    for h in handles:
        h.remove()
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return seen


def gbn_call(fn, x, dy, params):
    """One train-mode forward and backward of a global BatchNorm version
    ``fn`` (the kernels' or the plain version's arguments) with gradients
    returned, not accumulated."""
    xi, w, b, rm, rv, tracked = params
    y = fn(xi, w, b, rm, rv, tracked, 0.1, 1e-5, None)
    return (y,) + torch.autograd.grad(y, (xi, w, b), dy)


def sync_batch_norm_call(x, dy, params):
    """The same through torch's SyncBatchNorm function, its exchange
    included (a yardstick; the port never calls it)."""
    import torch.distributed as dist
    from torch.nn.modules._functions import SyncBatchNorm
    xi, w, b, rm, rv, _ = params
    y = SyncBatchNorm.apply(xi, w, b, rm, rv, 1e-5, 0.1, dist.group.WORLD,
                            dist.get_world_size())
    return (y,) + torch.autograd.grad(y, (xi, w, b), dy)


def phase_global_bn(card: str, sd: dict, dp) -> dict:
    """Phase 9e: the global BatchNorm kernels at every BatchNorm of a
    four-card rank's step, on the one-rank NCCL group: against the plain
    version (a gross-fault check; tests/test_torch_port_global_bn.py holds
    the tolerances), the device ms of a step's layers forward and backward
    (kernels with their two collectives, the plain version, torch's
    SyncBatchNorm), beside the bound (8 passes over each activation at the
    memory rate), and the host's ms to launch a step's layers."""
    from oaprogressionmmf_torch.parallel.mesh import global_batch_norm_plain
    gbn = gbn_module().global_batch_norm
    layers = gbn_layers(sd, dp)
    distinct: dict = {}
    for key in layers:
        distinct[key] = distinct.get(key, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(9)
    made: dict = {}

    def inputs(key):
        shape, dtype, nhwc, pdtype = key
        if key not in made:
            fmt = torch.channels_last if nhwc else torch.contiguous_format
            x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5
                 ).to(dtype).contiguous(memory_format=fmt)
            dy = torch.randn(shape, device="cuda", generator=gen).to(
                dtype).contiguous(memory_format=fmt)
            c = shape[1]
            params = (x.requires_grad_(),
                      (torch.rand(c, device="cuda", generator=gen) + 0.5).to(
                          pdtype).requires_grad_(),
                      torch.randn(c, device="cuda", generator=gen).to(
                          pdtype).requires_grad_(),
                      torch.zeros(c, device="cuda", dtype=pdtype),
                      torch.ones(c, device="cuda", dtype=pdtype),
                      torch.zeros((), device="cuda", dtype=torch.int64))
            made[key] = (x, dy, params)
        return made[key]

    versions = {"ms": lambda x, dy, p: gbn_call(gbn, x, dy, p),
                "plain_ms": lambda x, dy, p: gbn_call(
                    global_batch_norm_plain, x, dy, p),
                "library_ms": sync_batch_norm_call}
    rec = dict.fromkeys(versions, 0.0)
    rec.update(bound_ms=0.0, worst_y=0.0, worst_dx=0.0, per_shape=[],
               layers=len(layers), distinct=len(distinct))
    for key, count in distinct.items():
        x, dy, params = inputs(key)
        got, want = (versions[v](x, dy, params) for v in ("ms", "plain_ms"))
        errs = [((g.float() - w.float()).abs().max()
                 / w.float().abs().max().clamp_min(1e-30)).item()
                for g, w in zip(got[:2], want[:2])]
        rec["worst_y"] = max(rec["worst_y"], errs[0])
        rec["worst_dx"] = max(rec["worst_dx"], errs[1])
        times = {v: time_ms(lambda: fn(x, dy, params), GBN_ITERS)
                 for v, fn in versions.items()}
        bound = 8 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        for v, t in times.items():
            rec[v] += t * count
        rec["bound_ms"] += bound * count
        rec["per_shape"].append(dict(shape=list(key[0]), dtype=str(key[1]),
                                     channels_last=key[2], layers=count,
                                     bound_ms=bound, **times))
        if max(errs) > GBN_GROSS:
            raise SystemExit(f"global BatchNorm at {key}: y, dx against the "
                             f"plain version {errs}")
    # the host: a step's layers in call order, launched and synchronized
    host = {}
    for v in ("ms", "plain_ms"):
        best = float("inf")
        for _ in range(GBN_HOST_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for key in layers:
                versions[v](*inputs(key))
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        host[v] = best
    rec["host_ms"], rec["plain_host_ms"] = host["ms"], host["plain_ms"]
    # the wrapper's own count over these synthetic layers (a self-check;
    # the kernel record's launches a step come from 9a's DP steps)
    before = gbn.launches
    for key in layers:
        versions["ms"](*inputs(key))
    wrapper_launches = gbn.launches - before
    made.clear()
    torch.cuda.empty_cache()
    log(f"[global-bn] 9e one rank's step of {rec['layers']} BatchNorms "
        f"({rec['distinct']} distinct, batch {GBN_RANK_BATCH}, "
        f"{sorted({str(k[1]) for k in layers})}), forward and backward, "
        f"device ms: kernels {rec['ms']:.3f} (with their collectives), "
        f"plain {rec['plain_ms']:.3f}, SyncBatchNorm {rec['library_ms']:.3f}"
        f", bound {rec['bound_ms']:.3f} (8 passes at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); host ms to launch and finish "
        f"them: kernels {rec['host_ms']:.2f}, plain "
        f"{rec['plain_host_ms']:.2f}; the wrapper counted "
        f"{wrapper_launches} launches (want {4 * rec['layers']}); largest y, dx gap over their peak "
        f"{rec['worst_y']:.2e}, {rec['worst_dx']:.2e}  [{card}]")
    for r in sorted(rec["per_shape"], key=lambda r: -r["ms"] * r["layers"]):
        log(f"[global-bn]   {r['shape']} {r['dtype']} channels_last "
            f"{r['channels_last']} x{r['layers']}: kernels {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f}, SyncBatchNorm {r['library_ms']:.4f}"
            f", bound {r['bound_ms']:.4f}")
    if wrapper_launches != 4 * rec["layers"]:
        raise SystemExit(f"global BatchNorm launches {wrapper_launches}")
    return rec


def phase_parallel(card: str, sd: dict, train_ms: float) -> dict:
    """Phase 9: data parallelism over NCCL (a single-rank group), a DCP
    checkpoint of its state, the post-downscale augmentation, and a 1×2
    dp×tp grid in two processes on the card (gloo)."""
    import torch.distributed as dist

    from oaprogressionmmf_torch.parallel.dcn import initialize_distributed
    from oaprogressionmmf_torch.parallel.mesh import DataParallel
    from oaprogressionmmf_torch.utils import checkpoint
    t_phase = time.perf_counter()
    out: dict = {"launches": {}}
    torch.backends.cudnn.deterministic = True
    shard = initialize_distributed({"distributed": {
        "enable": True, "coordinator_address": f"127.0.0.1:{free_port()}",
        "num_processes": 1, "process_id": 0}})
    if shard != (0, 1) or dist.get_backend() != DP_BACKEND:
        raise SystemExit(f"process group {shard}, {dist.get_backend()}")
    dp = DataParallel()
    out["global_bn"] = phase_global_bn(card, sd, dp)
    cfg = par_config(False)
    data = functools.partial(par_batch, CHECK_BATCH)

    # 9a: the DP step against the plain step. Each float32 step starts
    # from the same state on the same draws: the losses, and each
    # parameter within Adam's bound of the step (a gradient near 0 may
    # take either sign, as in tests/test_torch_port_train_step.py). The
    # gradients (Adam's first moment) are held in float64 with the plain
    # attention (the flash kernels take float32 and bf16): in float32 a
    # batch-2 step's gradients are no stable function of the inputs, and
    # BatchNorm's sums in another order part the two paths by ~0.5% in
    # the stems (measured on the CPU; in float64 they agree to 5e-14)
    ref = par_runtime(sd, cfg, torch.float32)
    rt = par_runtime(sd, cfg, torch.float32, dp=dp)
    worst_name, worst, failed, d_loss = "", 0.0, [], 0.0
    check = []
    for k in range(PAR_CHECK_STEPS):
        if k:
            rt.model.load_state_dict(ref.model.state_dict())
            rt.load_optimizer_state(ref.optimizer_state(), ref.step)
        (want_loss,), _ = par_steps(ref, data, 1, first=k)
        (got_loss,), _ = par_steps(rt, data, 1, first=k)
        check.append((got_loss, want_loss))
        d_loss = max(d_loss, abs(got_loss - want_loss) / abs(want_loss))
        for (n, p), q in zip(rt.model.named_parameters(),
                             ref.model.parameters()):
            err = (p - q).abs().max().item()
            if err > worst:
                worst_name, worst = n, err
            if err > PAR_PARAM_ATOL:
                failed.append((k, n))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    moments = [f64_moments(sd, cfg, data, dp=d) for d in (None, dp)]
    worst_m_name, worst_m = "", 0.0
    for n, m_r in moments[0].items():
        ratio = ((moments[1][n] - m_r).abs().max()
                 / m_r.abs().max().clamp_min(1e-300)).item()
        if ratio > worst_m:
            worst_m_name, worst_m = n, ratio
        if ratio > PAR_MOMENT_RTOL:
            failed.append(("float64", n))
    # the DP step's float64 moments: 9b's grid is held against them
    dp_moments = moments[1]
    del moments
    # the free DP run from the initial state: PAR_STEPS steps, then a
    # validation batch, launches counted
    rt.model.load_state_dict(sd)
    rt.optimizer.state.clear()
    rt.step = 0
    reset_launch_counts()
    losses, _ = par_steps(rt, data, PAR_STEPS)
    par_validate(rt, data(0)[0])
    torch.cuda.synchronize()
    out["launches"]["dp_float32"] = counts = kernel_launches()
    n_bn = len(global_bns(rt.model))
    out["launches"]["gbn"] = {"layers": n_bn, "dp_float32":
                              gbn_module().global_batch_norm.launches}
    log(f"[parallel] 9a {DP_BACKEND}, one rank: float32 batch "
        f"{CHECK_BATCH}, no dropout, {PAR_CHECK_STEPS} DP steps against "
        f"TrainRuntime's, each from the same state on the same draws: "
        f"losses (DP, plain) {check} (largest rel {d_loss:.2e}, tol "
        f"{LOSS_RTOL}); largest |dp| {worst:.3e} ({worst_name}; tol "
        f"{PAR_PARAM_ATOL:.3e}); one float64 step (plain attention): "
        f"largest max|dm|/max|m| {worst_m:.3e} ({worst_m_name}; tol "
        f"{PAR_MOMENT_RTOL}); then {PAR_STEPS} DP steps from the start, "
        f"losses {losses}, and a validation batch launched {counts} (want "
        f"{want_launches(PAR_STEPS)}), the global BatchNorm's kernels "
        f"{out['launches']['gbn']['dp_float32']} (want 4 × {n_bn} layers × "
        f"{PAR_STEPS}) "
        f"{'ok' if not failed and d_loss <= LOSS_RTOL else 'FAIL'}")
    if failed or d_loss > LOSS_RTOL or counts != want_launches(PAR_STEPS) \
            or out["launches"]["gbn"]["dp_float32"] != 4 * n_bn * PAR_STEPS:
        raise SystemExit(f"DP against TrainRuntime: loss rel {d_loss:.2e}, "
                         f"tensors {failed[:8]}, launches {counts}, "
                         f"{out['launches']['gbn']}")
    out["dp_losses"] = losses
    dp_params = {n: p.detach().cpu() for n, p in rt.model.named_parameters()}

    # 9d: its state as a DCP checkpoint (ckpt_backend: orbax), restored
    with tempfile.TemporaryDirectory(prefix="dcp_") as root:
        handler = checkpoint.make_checkpoint_handler(root, backend="orbax")
        t0 = time.perf_counter()
        path = handler.save_new_ckpt(
            checkpoint.runtime_payload(MODEL_CFG["name"], rt),
            MODEL_CFG["name"], 0, 0)
        save_s = time.perf_counter() - t0
        nbytes = checkpoint.ckpt_bytes(path)
        other = par_runtime(sd, par_config(True), torch.bfloat16, dp=dp)
        t0 = time.perf_counter()
        checkpoint.load_runtime_payload(MODEL_CFG["name"], other,
                                        checkpoint.load_ckpt(path))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    want, got = fit_state(SimpleNamespace(runtime=rt)), \
        fit_state(SimpleNamespace(runtime=other))
    differ = [n for n, t in want.items() if not torch.equal(t, got[n])]
    log(f"[parallel] 9d DCP checkpoint of 9a's runtime ({path.name}): "
        f"{nbytes} bytes written in {save_s:.2f} s, read and restored in "
        f"{load_s:.2f} s into a bf16 runtime; {len(want)} tensors, "
        f"{len(differ)} differ (torch.equal), step {other.step}  [{card}]")
    if differ or set(want) != set(got) or other.step != rt.step:
        raise SystemExit(f"DCP restore: differ {differ[:8]}")
    out["dcp"] = {"bytes": nbytes, "save_s": round(save_s, 3),
                  "load_s": round(load_s, 3)}
    del rt, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # 9a: bf16 DP steps at the training batch, timed
    xs8, ys8 = raw_inputs(TRAIN_BATCH), labels(TRAIN_BATCH)

    def data8(k):
        return xs8, ys8

    par_steps(other, data8, 1)
    reset_launch_counts()
    losses, ms = par_steps(other, data8, PAR_BF16_STEPS, first=1)
    par_validate(other, xs8)
    torch.cuda.synchronize()
    out["launches"]["dp_bf16"] = counts = kernel_launches()
    out["launches"]["gbn"]["dp_bf16"] = gbn = \
        gbn_module().global_batch_norm.launches
    out["dp_bf16_ms"] = ms
    log(f"[parallel] 9a {DP_BACKEND}, one rank: bf16 batch {TRAIN_BATCH} "
        f"DP steps "
        f"{[round(v, 2) for v in ms]} ms (synchronized; phase 5's bare "
        f"step {train_ms:.2f}), losses {losses}; with a validation batch "
        f"launched {counts} (want {want_launches(PAR_BF16_STEPS)}), the "
        f"global BatchNorm's kernels {gbn} (want 4 × {n_bn} × "
        f"{PAR_BF16_STEPS})  [{card}]")
    if counts != want_launches(PAR_BF16_STEPS) \
            or gbn != 4 * n_bn * PAR_BF16_STEPS \
            or not all(np.isfinite(losses)):
        raise SystemExit(f"bf16 DP: launches {counts}, losses {losses}")
    device_breakdown(lambda: par_steps(other, data8, 1, first=3),
                     float(np.mean(ms)), what="DP training step")
    del other
    gc.collect()
    torch.cuda.empty_cache()

    # 9c: training.augment_full_res=false, one bf16 step at batch 8
    rt = par_runtime(sd, MODEL_CFG, torch.bfloat16,
                     training={"augment_full_res": False})
    warm, warm_ms = par_steps(rt, data8, 1)
    reset_launch_counts()
    losses, ms = par_steps(rt, data8, 1, first=1)
    par_validate(rt, xs8)
    torch.cuda.synchronize()
    out["launches"]["post_downscale"] = counts = kernel_launches()
    out["post_downscale_ms"] = ms
    log(f"[parallel] 9c augment_full_res=false, bf16 batch {TRAIN_BATCH}: "
        f"a step {ms[0]:.2f} ms after a warm-up step of {warm_ms[0]:.2f} "
        f"(synchronized) against phase 5's default step {train_ms:.2f}; "
        f"losses {warm + losses}; with a validation batch launched "
        f"{counts} (want {want_launches(1)})  [{card}]")
    if counts != want_launches(1) or not all(np.isfinite(warm + losses)):
        raise SystemExit(f"post-downscale step: launches {counts}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # 9b: dp×tp = 1×2, two processes on the card over gloo
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        torch.save(sd, f"{tmp}/sd.pt")
        torch.save(dp_moments, f"{tmp}/m64.pt")
        del dp_moments
        plan = {"addr": f"127.0.0.1:{free_port()}", "sd": f"{tmp}/sd.pt",
                "m64": f"{tmp}/m64.pt", "out": f"{tmp}/out"}
        ranks, wall_s = run_workers("tp-worker", plan, tmp, PAR_TP)
    # the grid's gradients: one float64 step's Adam first moment against
    # DP's, per tensor against its largest entry (9a's bar)
    ratios = ranks[0]["moment_ratio"]
    worst_m_name = max(ratios, key=ratios.get)
    worst_m = ratios[worst_m_name]
    failed_m = [n for n, r in ratios.items() if not r <= PAR_MOMENT_RTOL]
    log(f"[parallel] 9b dp×tp = 1×{PAR_TP}: one float64 step (plain "
        f"attention) against 9a's float64 DP step: largest max|dm|/max|m| "
        f"{worst_m:.3e} ({worst_m_name}; tol {PAR_MOMENT_RTOL}) over "
        f"{len(ratios)} tensors; {max(r['f64_s'] for r in ranks):.1f} s "
        f"{'ok' if not failed_m else 'FAIL'}")
    if failed_m:
        raise SystemExit(f"dp×tp gradients against DP: {failed_m[:8]}")
    worst_name, worst, failed = "", 0.0, []
    rtol, atol = GRID_PARAM["rtol"], GRID_PARAM["atol"]
    for n, want_p in dp_params.items():
        got_p = ranks[0]["params"][n]
        excess = ((got_p - want_p).abs() - rtol * want_p.abs()).max().item()
        if excess > worst:
            worst_name, worst = n, excess
        if excess > atol:
            failed.append(n)
    loss_ok = all(np.allclose(r["losses"], out["dp_losses"], **GRID_LOSS)
                  for r in ranks)
    out["launches"]["tp"] = [r["launches"] for r in ranks]
    out["launches"]["gbn"]["tp_ranks"] = [r["gbn"] for r in ranks]
    out["tp_ms"] = [r["ms"] for r in ranks]
    log(f"[parallel] 9b dp×tp = 1×{PAR_TP}, gloo on the card: "
        f"{PAR_STEPS} float32 steps, local heads {ranks[0]['heads']}, "
        f"losses {[r['losses'] for r in ranks]} against 9a's DP "
        f"{out['dp_losses']} ({GRID_LOSS}); params: largest "
        f"|Δ| − rtol·|p| {worst:.3e} ({worst_name}; atol {atol}, rtol "
        f"{rtol}); ms per step {out['tp_ms']}; launches per rank "
        f"{out['launches']['tp']} (want {want_launches(PAR_STEPS)}), the "
        f"global BatchNorm's kernels {[r['gbn'] for r in ranks]} (want 4 × "
        f"{ranks[0]['layers']} × {PAR_STEPS}); "
        f"{wall_s:.1f} s with the processes' start  [{card}]")
    if failed or not loss_ok or any(
            r["launches"] != want_launches(PAR_STEPS)
            or r["gbn"] != 4 * r["layers"] * PAR_STEPS
            or r["heads"] != [MODEL_CFG["agg"]["heads"] // PAR_TP]
            for r in ranks):
        raise SystemExit(f"dp×tp against DP: params {failed[:8]}, losses "
                         f"ok {loss_ok}")
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"[parallel] phase 9 {out['seconds']} s  [{card}]")
    return out


def dp_worker(path_plan: str, rank: int) -> int:
    """One rank of ``dp_cards`` (``python3 chip_smoke.py dp-worker PLAN
    RANK``): NCCL on ``cuda:RANK``; one float32 DP step on this rank's 2
    knees of the global batch, then bf16 DP steps at batch 8, timed."""
    import torch.distributed as dist

    from oaprogressionmmf_torch.parallel.dcn import initialize_distributed
    from oaprogressionmmf_torch.parallel.mesh import DataParallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    plan = json.loads(Path(path_plan).read_text())
    world = plan["world"]
    initialize_distributed({"distributed": {
        "enable": True, "coordinator_address": plan["addr"],
        "num_processes": world, "process_id": rank}})
    dp = DataParallel()
    sd = torch.load(plan["sd"], map_location="cpu", weights_only=True,
                    mmap=True)
    rows = dp.rows(CHECK_BATCH)

    def data(k):
        xs, ys = par_batch(CHECK_BATCH * world, k)
        return tuple(x[rows] for x in xs), ys[rows]

    rt = par_runtime(sd, par_config(False), torch.float32, dp=dp)
    reset_launch_counts()
    losses, _ = par_steps(rt, data, 1)
    out = {"losses": losses, "launches": kernel_launches(),
           "gbn": gbn_module().global_batch_norm.launches,
           "layers": len(global_bns(rt.model)),
           "device": f"cuda:{torch.cuda.current_device()}",
           "backend": dist.get_backend()}
    if rank == 0:
        out["params"] = {n: p.detach().cpu()
                         for n, p in rt.model.named_parameters()}
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    rt = par_runtime(sd, MODEL_CFG, torch.bfloat16, dp=dp)
    xs8, ys8 = raw_inputs(TRAIN_BATCH, seed=rank), labels(TRAIN_BATCH)

    def data8(k):
        return xs8, ys8

    par_steps(rt, data8, 1)
    reset_launch_counts()
    out["bf16_losses"], out["bf16_ms"] = par_steps(rt, data8,
                                                   PAR_BF16_STEPS, first=1)
    out["bf16_launches"] = kernel_launches()
    out["bf16_gbn"] = gbn_module().global_batch_norm.launches
    torch.save(out, f"{plan['out']}.{rank}")
    dist.destroy_process_group()
    return 0


def dp_cards(n: int) -> int:
    """Data parallelism over ``n`` cards, one process each over NCCL
    (``python3 chip_smoke.py dp-cards 4`` on a machine with 4 cards): the
    first float32 step of the global batch (2 knees a card, no dropout)
    against ``TrainRuntime``'s one-process step on all of it (loss 1e-5,
    each parameter within Adam's per-step bound), K1-K3 launched on every
    rank, then bf16 DP steps at batch 8 a card timed against the
    one-process bf16 step at batch 8."""
    if torch.cuda.device_count() < n:
        raise SystemExit(f"dp-cards {n}: {torch.cuda.device_count()} cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    card = card_line()
    log(card)
    phase_build()
    sd = synth_state_dict()
    with tempfile.TemporaryDirectory(prefix="dp_") as tmp:
        torch.save(sd, f"{tmp}/sd.pt")
        plan = {"addr": f"127.0.0.1:{free_port()}", "sd": f"{tmp}/sd.pt",
                "out": f"{tmp}/out", "world": n}
        ranks, wall_s = run_workers("dp-worker", plan, tmp, n)
    rt = par_runtime(sd, par_config(False), torch.float32)
    (want,), _ = par_steps(rt, functools.partial(par_batch,
                                                 CHECK_BATCH * n), 1)
    worst_name, worst = "", 0.0
    for name, p in rt.model.named_parameters():
        err = (p.detach().cpu() - ranks[0]["params"][name]).abs().max().item()
        if err > worst:
            worst_name, worst = name, err
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    rt = par_runtime(sd, MODEL_CFG, torch.bfloat16)
    xs8, ys8 = raw_inputs(TRAIN_BATCH), labels(TRAIN_BATCH)
    par_steps(rt, lambda k: (xs8, ys8), 1)
    _, plain_ms = par_steps(rt, lambda k: (xs8, ys8), PAR_BF16_STEPS, first=1)
    d_loss = max(abs(r["losses"][0] - want) / abs(want) for r in ranks)
    want_f32 = want_launches(1, 0)
    want_bf16 = want_launches(PAR_BF16_STEPS, 0)
    ok = (d_loss <= LOSS_RTOL and worst <= PAR_PARAM_ATOL
          and all(r["launches"] == want_f32
                  and r["bf16_launches"] == want_bf16
                  and r["gbn"] == 4 * r["layers"]
                  and r["bf16_gbn"] == 4 * r["layers"] * PAR_BF16_STEPS
                  for r in ranks)
          and [r["device"] for r in ranks] == [f"cuda:{i}" for i in range(n)]
          and {r["backend"] for r in ranks} == {"nccl"})
    log(f"[dp-cards] {n} cards over NCCL, one process each "
        f"({[r['device'] for r in ranks]}): the float32 step of {n} × "
        f"{CHECK_BATCH} knees, losses {[r['losses'][0] for r in ranks]} "
        f"against one process's {want} (largest rel {d_loss:.2e}, tol "
        f"{LOSS_RTOL}); largest |dp| {worst:.3e} ({worst_name}; tol "
        f"{PAR_PARAM_ATOL:.3e}); launches {[r['launches'] for r in ranks]}, "
        f"global BatchNorm {[(r['gbn'], r['bf16_gbn']) for r in ranks]} "
        f"(want 4 × {ranks[0]['layers']} layers × 1 and × "
        f"{PAR_BF16_STEPS}); "
        f"bf16 DP steps at batch {TRAIN_BATCH} a card (global "
        f"{TRAIN_BATCH * n}) {[r['bf16_ms'] for r in ranks]} ms against "
        f"one process's batch-{TRAIN_BATCH} step {plain_ms} ms; "
        f"{wall_s:.1f} s with the processes' start "
        f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        raise SystemExit("dp-cards: DP over the cards disagrees")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mark(phase: str) -> None:
    log(f"[time] phase {phase} ends at {time.perf_counter() - T_START:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; TF32 off for float32 matmuls and convs")

    card = card_line()
    log(card)
    phase_build()
    mark("build")
    flash = phase_flash()
    mark("3")
    bwd = phase_flash_bwd()
    mark("3b")
    stem = phase_stem()
    mark("3c")
    k5 = phase_int8_conv()
    mark("3d")

    t0 = time.perf_counter()
    sd = synth_state_dict()
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith("num_batches_tracked"))
    log(f"[slice] synthesized {n_params} parameters + BN statistics in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, stem_launches, bf16 = phase_slice(card, sd)
    mark("4")
    gc.collect()                 # the inference predictors are freed
    torch.cuda.empty_cache()
    int8 = phase_int8_serving(card, sd, bf16)
    mark("4c")
    gc.collect()
    torch.cuda.empty_cache()
    graph = phase_graph(card, sd)
    mark("4g")
    family_ms = phase_families(card)
    mark("4b")
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train_ms = phase_train(card, sd)
    mark("5")
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_check(sd)
    mark("5b")
    gc.collect()
    torch.cuda.empty_cache()
    # phases 6 and 7 share one experiment directory (two ~4.8 GB
    # checkpoints and a ~1.6 GB bundle)
    with tempfile.TemporaryDirectory(prefix="fit_") as root:
        fit_counts, fit_errs = phase_fit(card, train_ms, root)
        mark("6")
        eval_counts, eval_errs = phase_eval(card, root)
        mark("7")
    launches_eval = {k: {run: c[k] for run, c in eval_counts.items()}
                     for k in ("K1", "K4", "K5")}
    gc.collect()
    torch.cuda.empty_cache()
    prep = phase_prep(card)
    mark("8")
    gc.collect()
    parallel = phase_parallel(card, sd, train_ms)
    mark("9")
    del sd
    par = parallel["launches"]

    def par_launches(k: str) -> dict:
        return {"dp_float32": par["dp_float32"][k],
                "dp_bf16": par["dp_bf16"][k],
                "post_downscale": par["post_downscale"][k],
                "tp_ranks": [c[k] for c in par["tp"]]}

    src = "oaprogressionmmf_torch/ops/csrc/"
    kernels = [dict(
        name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
        design=FWD_DESIGN,
        replaces="oaprogressionmmf_tpu/ops/flash_attention.py:54",
        launches=launches, launches_train=train_counts[0],
        launches_fit=fit_counts["K1"], launches_eval=launches_eval["K1"],
        launches_parallel=par_launches("K1"),
        max_abs_err=flash["max_abs_err"], max_abs_err_fit=fit_errs["K1"],
        max_abs_err_eval=eval_errs["K1"],
        ms=flash["ms"],
        plain_ms=flash["plain_ms"], bound_ms=flash["bound_ms"],
        bound_by=flash["bound_by"], library_ms=flash["library_ms"],
        per_n=flash["per_n"], d276=flash["d276"])]
    for kern, line, count, fit, k in (
            ("dq", 155, train_counts[1], fit_counts["K2"], "K2"),
            ("dkv", 193, train_counts[2], fit_counts["K3"], "K3")):
        rec = bwd[kern]
        kernels.append(dict(
            name=f"flash_bwd_{kern}", route="cuda", source=src + "flash_bwd.cu",
            design=BWD_DESIGN[kern],
            replaces=f"oaprogressionmmf_tpu/ops/flash_attention.py:{line}",
            launches=count, launches_fit=fit,
            launches_parallel=par_launches(k),
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            library_computes="dq, dk and dv (the whole SDPA backward)",
            per_n=rec["per_n"], d276=rec["d276"]))
    kernels.append(dict(
        name="bn_relu_pool", route="cuda", source=src + "bn_pool.cu",
        design=STEM_DESIGN,
        replaces="oaprogressionmmf_tpu/ops/fused_stem.py:34",
        launches=stem_launches, launches_per_request=stem_launches / REQUESTS,
        launches_train=0, launches_fit=fit_counts["K4"],
        launches_eval=launches_eval["K4"],
        launches_parallel=par_launches("K4"),
        max_abs_err=stem["max_abs_err"], max_abs_err_fit=fit_errs["K4"],
        max_abs_err_eval=eval_errs["K4"],
        ms=stem["ms"],
        plain_ms=stem["plain_ms"], unfused_ms=stem["unfused_ms"],
        unfused_computes="F.batch_norm (eval), F.relu, F.max_pool2d: three "
                         "library calls; no single PyTorch call computes "
                         "this function",
        bound_ms=stem["bound_ms"], bound_by=stem["bound_by"],
        library_ms=None, f32_ms=stem["f32_ms"],
        f32_bound_ms=stem["f32_bound_ms"], per_shape=stem["per_shape"]))
    k5_launches = int8["int8-all"]["launches"]["K5"]
    kernels.append(dict(
        name="int8_conv2d", route="cuda", source=src + "int8_conv.cu",
        replaces="scripts/exp_pallas_conv.py:28", design=K5_DESIGN,
        launches=k5_launches, launches_per_request=k5_launches / REQUESTS,
        launches_int8_mode=int8["int8"]["launches"]["K5"],
        launches_fit=fit_counts["K5"], launches_eval=launches_eval["K5"],
        launches_parallel=par_launches("K5"),
        max_abs_err=k5["max_abs_err"], max_abs_err_eval=eval_errs["K5"],
        ms=k5["ms"], plain_ms=k5["plain_ms"],
        bound_ms=k5["bound_ms"], bound_by=k5["bound_by"],
        library_ms=k5["library_ms"],
        library_computes="torch._int_mm on an explicit int8 im2col (a 1x1: "
                         "on the input itself): the GEMM alone, no "
                         "epilogue, the im2col not timed",
        library_bf16_conv_ms=k5["library_bf16_conv_ms"],
        library_bf16_conv_computes="F.conv2d in bf16, channels_last, the "
                                   "same shape, no epilogue",
        stems_and_3x3s=dict(launches_per_request=K5_SUBSET,
                            **k5["subset"]),
        per_shape=k5["per_shape"]))
    gbn = parallel["global_bn"]
    kernels.append(dict(
        name="global_bn", route="cuda", source=src + "global_bn.cu",
        design=GBN_DESIGN, replaces=None,
        replaces_note="no Pallas kernel: the JAX package leaves BatchNorm "
                      "under the mesh to XLA",
        layers=gbn["layers"],
        launches_per_step=par["gbn"]["dp_bf16"] // PAR_BF16_STEPS,
        launches_parallel=par["gbn"], max_rel_err_y=gbn["worst_y"],
        max_rel_err_dx=gbn["worst_dx"], ms=gbn["ms"],
        plain_ms=gbn["plain_ms"], bound_ms=gbn["bound_ms"],
        bound_by="bytes", library_ms=gbn["library_ms"],
        library_computes="torch.nn.SyncBatchNorm's function with its "
                         "all-gather, forward and backward",
        host_ms=gbn["host_ms"], plain_host_ms=gbn["plain_host_ms"],
        per_shape=gbn["per_shape"]))
    log(f"[int8] ms per request: {json.dumps(int8)}")
    log(f"[graph] {json.dumps(graph)}")
    log(f"[family] ms per request: {json.dumps(family_ms)}")
    log(f"[prep] {json.dumps(prep)}")
    # the global BatchNorm's record is the kernel table's
    par_log = {k: v for k, v in parallel.items() if k != "global_bn"}
    log(f"[parallel] {json.dumps(par_log)}")
    log(f"[env] chip_smoke.py ran {time.perf_counter() - T_START:.1f} s "
        f"(from after its imports of numpy and torch)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["tp-worker"]:
        sys.exit(tp_worker(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["dp-worker"]:
        sys.exit(dp_worker(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["dp-cards"]:
        sys.exit(dp_cards(int(sys.argv[2])))
    sys.exit(main())
