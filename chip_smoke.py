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
     make_predictor in bfloat16 with every launch count set to 0 just
     before and read just after (12 K1 and 3 K4 launches per request);
     probabilities checked; the bf16 run's tokens into the final FeaT, its
     states and its logits compared with a float32 (no TF32) run of the
     port on the same inputs, beside how far knees and slices differ in the
     same quantities; one float32 MRI ResNet50 through K4 against its own
     children run unfused;
 4c. int8 serving of the same flagship at full width: the port's
     export_serving_bundle calibrates on the card with one batch and
     writes an int8-all bundle (and an int8 one) in the JAX layout to a
     temporary directory, load_serving_bundle reads it back, and a few
     batch-4 requests run with every launch count set to 0 just before and
     read just after (159 K5, 12 K1 and 3 K4 per request in both modes; the
     int8 mode's FeaTs stay bf16); probabilities finite; the final FeaT's
     tokens and states, less their mean over knees, within CENTRED_RTOL of
     the bf16 request's input-driven part; ms per request, knees/s, device
     busy time and idle share beside the bf16 request, with a profiler
     breakdown;
 4b. the five other families at the full width of their YAML configs
     (XR 700² → ResNeXt50-32x4d at 350², or ResNet50 for XR1Cnn; DESS
     320²×128 → 64 slices of 160²; COR IW TSE 320²×32 → 32 slices) with
     random weights from a seeded host recipe, loaded with strict=True
     through make_predictor: batch-4 requests in bf16 with their exact K4
     and K1 launch counts, and logits and probabilities against a float32
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
     and read seconds, peak device memory.

Prints progress lines, then a JSON line of kernel records (with the
per-length times behind each sum), the card line,
and as its last line {"ok": true, "device": {...}}. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Device ms of one call: CUDA events around ``iters`` calls queued
    behind a device-side sleep, so the card runs them back to back and the
    host's launch cost does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
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


def check_stem(name: str, y, params, eps: float = 1e-5) -> float:
    """K4 against its plain version (and, in bf16, the unfused stem) on the
    same card and inputs; returns max|Δ| and exits outside a bar."""
    fs = stem_module()
    out = fs.fused_bn_relu_pool(y, *params, eps)
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


def check_int8_conv(label, args, stride, pad, groups, kw) -> float:
    """K5 against its plain version: equal bit for bit, or exit; returns
    the largest difference (0)."""
    ic = int8_module()
    x, w, sc = args
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
    log(f"[int8_conv] {label:30s} x{tuple(x.shape)} w{tuple(w.shape)} "
        f"s{stride} g{groups} -> {got.dtype} {tuple(got.shape)}: {n_diff} "
        f"values differ from the plain version in any bit (max|d| {err:.3e}, "
        f"max|y| {want.float().abs().max().item():.4g}) "
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
                                             w_packed=w_packed, **kw), 20)
        t_p = time_ms(lambda: ic.int8_conv2d_fused_plain(
            x, w, sc, stride, pad, groups, **kw), 2)
        t_l = time_ms(lambda: torch._int_mm(a, b.t()), 20)
        t_b = time_ms(lambda: F.conv2d(xb, wb, None, stride, pad, 1, groups),
                      20)
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


def raw_inputs(batch: int = BATCH):
    """Raw inputs at bench.py's sizes and types, ``batch`` knees: uint8 XR and
    DESS, float T2 maps, float clinical values. bench.py's uniform noise
    is dimmed to a tenth in some 100² blocks of each X-ray, a share that
    grows from knee to knee, and scaled by an amplitude drawn for each MRI
    slice, so that knees and slices differ in their tokens (per-knee
    min-max scaling would erase one amplitude per knee)."""
    rng = np.random.RandomState(0)
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


def labels(batch: int) -> np.ndarray:
    """Progression targets in {0, 1}, from their own numpy seed."""
    return np.random.RandomState(1).randint(0, 2, batch).astype(np.int64)


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
    ("resize", ("upsample",)),
    ("rotation (grid_sample)", ("grid_sampler", "affine_grid")),
    ("optimizer (Adam)", ("adam", "multi_tensor_apply")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "winograd", "cudnn")),
    ("matmul (cuBLAS, cuDNN 1x1)", ("gemm", "cutlass", "xmma", "nvjet")),
    ("batch norm", ("batch_norm", "bn_fw")),
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
        f"{max(0.0, 1 - busy / latency_ms):.3f})")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {cat:30s} {ms:9.3f} ms  {ms / busy:6.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   top: {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return busy


def phase_slice(card: str, sd: dict):
    from oaprogressionmmf_torch.ops.flash_attention import flash_attention
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

    reset_launch_counts()
    latencies = []
    for _ in range(REQUESTS):
        t = time.perf_counter()
        probs = predictor(xs).cpu()
        latencies.append(time.perf_counter() - t)
    launches = flash_attention.launches
    stem_launches = stem_module().fused_bn_relu_pool.launches
    if int8_module().int8_conv2d.launches:
        raise SystemExit("the bf16 request launched the int8 conv K5")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"[slice] {REQUESTS} requests of batch {BATCH}: flash launches "
        f"{launches} ({launches / REQUESTS:g} per forward), fused stem "
        f"launches {stem_launches} ({stem_launches / REQUESTS:g} per "
        f"forward)")
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

    model = predictor.model
    counts = model._token_counts(model._shapes(3), n_mr=2)
    counts.append(int(MODEL_CFG["agg"]["num_slices"][3]))
    bounds = np.cumsum([0] + counts)
    segments = {name: (int(bounds[i]), int(bounds[i + 1])) for i, name in
                enumerate(("xr", "dess", "t2", "clin"))}
    got = capture(predictor, xs)
    del predictor, model
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


def compare_int8(got: dict, want: dict, segments: dict, label: str) -> None:
    """int8 serving against the bf16 request: each token segment of the
    final FeaT's input and output at CENTRED_RTOL of its input-driven part
    (the bar of compare_dtypes); the logits are reported."""
    failed = []
    for key in ("tokens", "states"):
        offset = 1 if key == "states" else 0   # the CLS token comes first
        for name, (lo, hi) in segments.items():
            rel, share, centred = centred_error(
                got[key][:, lo + offset:hi + offset],
                want[key][:, lo + offset:hi + offset])
            ok = centred <= CENTRED_RTOL
            log(f"[int8] {label} {key:6s} {name:5s} ({hi - lo:2d} tokens): "
                f"max|d|/max|bf16| {rel:.4e}, input-driven share "
                f"{share:.4e}, centred error {centred:.4e} (tol "
                f"{CENTRED_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{key}/{name}")
    d_logit = (got["logits"] - want["logits"]).abs().max().item()
    d_prob = (torch.softmax(got["logits"], -1)
              - torch.softmax(want["logits"], -1)).abs().max().item()
    log(f"[int8] {label} logits against bf16: max|d| {d_logit:.4e}, "
        f"max|dprob| {d_prob:.4e} (not held to a limit); int8 logits "
        f"{got['logits'].cpu().numpy().tolist()}")
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
            reset_launch_counts()
            latencies = []
            for _ in range(REQUESTS):
                t = time.perf_counter()
                probs = predictor(xs).cpu()
                latencies.append(time.perf_counter() - t)
            counts = {"K5": int8_module().int8_conv2d.launches,
                      "K1": flash_module().flash_attention.launches,
                      "K4": stem_module().fused_bn_relu_pool.launches}
            want = {"K5": K5_PER_REQUEST, "K1": 12, "K4": 3}
            log(f"[int8] {quant}: {REQUESTS} requests of batch {BATCH}: "
                f"launches per request "
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
    reset_launch_counts()
    latencies = []
    for _ in range(requests):
        t = time.perf_counter()
        probs = predictor(xs).cpu()
        latencies.append(time.perf_counter() - t)
    k4 = stem_module().fused_bn_relu_pool.launches
    k1 = flash_module().flash_attention.launches
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


def reset_launch_counts() -> None:
    fa = flash_module()
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    stem_module().fused_bn_relu_pool.launches = 0
    int8_module().int8_conv2d.launches = 0


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
def kernel_inputs():
    """Keep a copy of the inputs of the first K1 and K4 launch at each
    shape and type the path gives them. The FeaT's and the stems' calls
    of the wrappers are wrapped in turn (the wrappers and their counts
    stay as they are); yields {(kernel, shape, types): inputs}."""
    from oaprogressionmmf_torch.models import feat, resnet
    fa, fs = flash_module(), stem_module()
    real_flash, real_stem = feat.flash_attention, resnet.stem_epilogue
    seen = {}

    def flash(q, k, v, scale=None):
        before = fa.flash_attention.launches
        out = real_flash(q, k, v, scale)
        key = ("K1", tuple(q.shape), q.dtype)
        if fa.flash_attention.launches > before and key not in seen:
            seen[key] = tuple(t.detach().clone() for t in (q, k, v)) \
                + (scale,)
        return out

    def stem(y, bn, relu, pool):
        before = fs.fused_bn_relu_pool.launches
        out = real_stem(y, bn, relu, pool)
        key = ("K4", tuple(y.shape), y.dtype, bn.weight.dtype)
        if fs.fused_bn_relu_pool.launches > before and key not in seen:
            params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
            seen[key] = (y.detach().clone(),
                         tuple(t.detach().clone() for t in params), bn.eps)
        return out

    feat.flash_attention, resnet.stem_epilogue = flash, stem
    try:
        yield seen
    finally:
        feat.flash_attention, resnet.stem_epilogue = real_flash, real_stem


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
                y, params, eps = args
                errs["K4"] = max(errs["K4"], check_stem("fit", y, params,
                                                        eps))
    return errs


def phase_fit(card: str, train_ms: float) -> tuple:
    """Train, checkpoint and resume the full-width flagship through
    ProgressionTrainer.fit (phase 6); returns the launch counts of the
    resumed epoch and K1's and K4's max|Δ| on that epoch's inputs."""
    from oaprogressionmmf_torch.train.trainer import ProgressionTrainer
    datasets = {"train": SynthKnees(FIT_SEED, FIT_TRAIN_KNEES, MODEL_CFG),
                "val": SynthKnees(FIT_SEED + 1, FIT_VAL_KNEES, MODEL_CFG)}
    datasets["test"] = datasets["val"]
    for name in ("train", "val"):
        if set(datasets[name].targets()) != {0, 1}:
            raise SystemExit(f"the {name} knees lack a class")
    with tempfile.TemporaryDirectory(prefix="fit_") as tmp:
        cfg = copy.deepcopy(FIT_CONFIG)
        cfg["model"] = copy.deepcopy(MODEL_CFG)
        cfg["path_experiment_root"] = tmp
        log(f"[fit] checkpoints in {tmp}: "
            f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free")
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
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with kernel_inputs() as seen:
            summary = resumed.fit()
        torch.cuda.synchronize()
        fa = flash_module()
        counts = {"K1": fa.flash_attention.launches,
                  "K2": fa.flash_attention_bwd.launches_dq,
                  "K3": fa.flash_attention_bwd.launches_dkv,
                  "K4": stem_module().fused_bn_relu_pool.launches,
                  "K5": int8_module().int8_conv2d.launches}
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
        loop_ms = (tm["train"] - tm["loader_wait"]) / steps * 1e3
        log(f"[fit] ms per training step inside fit: the loop less the "
            f"loader wait {loop_ms:.2f}, each step {step_ms} (synchronized) "
            f"against phase 5's bare step {train_ms:.2f}; loader wait per "
            f"step {tm['loader_wait'] / steps * 1e3:.2f} ms; validation "
            f"{tm['val'] / tm['val_batches'] * 1e3:.2f} ms per batch of 16 "
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
    flash = phase_flash()
    bwd = phase_flash_bwd()
    stem = phase_stem()
    k5 = phase_int8_conv()

    t0 = time.perf_counter()
    sd = synth_state_dict()
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith("num_batches_tracked"))
    log(f"[slice] synthesized {n_params} parameters + BN statistics in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, stem_launches, bf16 = phase_slice(card, sd)
    gc.collect()                 # the inference predictors are freed
    torch.cuda.empty_cache()
    int8 = phase_int8_serving(card, sd, bf16)
    gc.collect()
    torch.cuda.empty_cache()
    family_ms = phase_families(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train_ms = phase_train(card, sd)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_check(sd)
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    fit_counts, fit_errs = phase_fit(card, train_ms)

    src = "oaprogressionmmf_torch/ops/csrc/"
    kernels = [dict(
        name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
        design=FWD_DESIGN,
        replaces="oaprogressionmmf_tpu/ops/flash_attention.py:54",
        launches=launches, launches_train=train_counts[0],
        launches_fit=fit_counts["K1"],
        max_abs_err=flash["max_abs_err"], max_abs_err_fit=fit_errs["K1"],
        ms=flash["ms"],
        plain_ms=flash["plain_ms"], bound_ms=flash["bound_ms"],
        bound_by=flash["bound_by"], library_ms=flash["library_ms"],
        per_n=flash["per_n"], d276=flash["d276"])]
    for kern, line, count, fit in (
            ("dq", 155, train_counts[1], fit_counts["K2"]),
            ("dkv", 193, train_counts[2], fit_counts["K3"])):
        rec = bwd[kern]
        kernels.append(dict(
            name=f"flash_bwd_{kern}", route="cuda", source=src + "flash_bwd.cu",
            design=BWD_DESIGN[kern],
            replaces=f"oaprogressionmmf_tpu/ops/flash_attention.py:{line}",
            launches=count, launches_fit=fit,
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
        max_abs_err=stem["max_abs_err"], max_abs_err_fit=fit_errs["K4"],
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
        launches_fit=fit_counts["K5"],
        max_abs_err=k5["max_abs_err"], ms=k5["ms"], plain_ms=k5["plain_ms"],
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
    log(f"[int8] ms per request: {json.dumps(int8)}")
    log(f"[family] ms per request: {json.dumps(family_ms)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
