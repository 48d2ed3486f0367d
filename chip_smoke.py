"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the port's
   CUDA kernels from ``mde_tpu_torch/ops/kernels/csrc`` with ``nvcc`` for
   sm_90a and prints each kernel's registers and spills (ptxas) and the
   shared memory a block takes (K1, K2, K3's and K4's tiled bodies and K5
   fwd and bwd as their sources count it).
2. Kernel phases: each of the ten kernels against its plain PyTorch version
   on the card at its main path's shapes, in bf16 and in f32 with TF32 off;
   its device time (CUDA events around calls queued behind a busy kernel;
   a warning where the host took longer to queue them than the card slept),
   the plain version's, one PyTorch call's as a
   yardstick where one computes the same function (for K4 none does: the
   port's unfused chain is timed beside it), and the least time the card
   could take (bytes over 3.35 TB/s, operations over the 989 TFLOP/s bf16
   peak). The forwards at the serving shapes (batch 8), the backwards at
   the train step's (batch 4). K2's backward is timed (and checked in
   bf16) a second time on windows whose depth indices are all equal. K1 is
   also timed at the KSA decoder's head dim 16 and its backward at the
   train step's stage 3, where 18 of the flagship's 24 backward launches
   run; K1 also at the ODA encoder's 144-token windows (12x12, head dim
   32: forward at stage 1, (1024, 144, 192)/6 masked and unmasked, and at
   stage 4, (16, 144, 1536)/48 unmasked; backward at stage 1, batch 4,
   masked, through the fused and the q|k + v entries), each against SDPA
   (and its backward) with bias + mask as one float mask; K3 also at the
   train step's batch 4; K5 and its backward also at
   the KSA decoder's stages 1 and 2 (128 and 256 channels). Which body K3
   dw took (tiled or gather) is logged. Each kernel is also timed with
   its calls following a synchronisation, so that any host gaps between
   them count (``host_ms``).
3. Flagship serving at full width: ``oda2_red_order_swin2`` (Swin-B, red33
   neck, ordered head) with seeded random weights. In f32 at batch 1 on
   224x448 (not resized), with
   seeded statistics in the FFs' BatchNorms so that K4's folded affine is
   not the identity, the card's forward is held against the same forward
   with its six FFs fused (K4) and against the same model on the CPU
   (plain versions); both are
   fed the card's index maps so that a flipped depth bucket cannot hide a
   fault (flips are counted). In bf16 at batch 8 ``Predictor.predict`` runs
   on 352x704 images with every launch count at 0 before and exactly 24
   K1, 6 K2 and 6 K3 forward launches after; then with the six FFs fused
   (24 K1, 6 K2, 6 K4, no K3); each is timed and profiled.
4. Flagship training at full width: one f32 train step at batch 1 on
   224x448 (encoder depths ``SHALLOW``, one repeat of the head,
   ``ONE_REPEAT``), card against CPU (fed the card's index maps), comparing
   the loss, the
   gradient norm, every gradient, the BatchNorm statistics and the
   parameters after AdamW. Then the bf16 train step at batch 4 on 352x704
   images (``make_train_step``, AdamW + OneCycle + clip 0.1, stochastic
   depth 0.2): its launch counts, finite logs and moved parameters, 5 timed
   steps after 2 warm-up, peak memory, one profiled step. The recompute
   policies: the same step with ``use_checkpoint`` under each
   ``MDE_REMAT_POLICY`` (``full``, ``save_sa``, ``save_sa_conv``, the
   default, and ``save_sa_conv_glu``), each with its exact launches
   (``REMAT_LAUNCHES``: K3's forward runs once a step where the conv's
   output is kept), img/s (5 timed steps after 2 warm-up) and peak memory,
   a line each beside the step without recompute; and in f32 at the check
   size above, each policy's step against the step without recompute, both
   on the card. Data parallelism: a one-rank NCCL group (a ``FileStore`` in
   a temporary directory, destroyed after the phase), the f32
   ``make_train_step_shard_map`` step at the check size against
   ``make_train_step`` from the same weights and generator, the bf16
   shard_map step at batch 4 with its exact launches, and the time of
   ``all_reduce_tensors`` (mean) over a gradient of the flagship's size on
   that one rank: the concatenation and the division around a collective
   that crosses no link, not a collective's rate. JAX's default
   ``train.spmd``, ``make_train_step_gspmd`` (global-batch BatchNorm,
   dropout masks and loss): on the one NCCL rank in f32 at the check size
   (batch 2, two microbatches, dropout 0.1) against ``make_train_step``;
   in bf16 at batch 4 beside ``make_train_step`` on one model, each with
   exact launches (``CHECKPOINT_LAUNCHES``) and the gspmd step with the
   all-reduces derived from the model (``gspmd_all_reduces``), peak
   memory, img/s in turns and one profiled step each; then on two gloo
   ranks spawned on the one card (NCCL refuses two ranks on one device),
   the f32 step at the check size against one process's
   ``make_train_step`` on the whole batch.
5. The flagship at KITTI's test shape: the f32 forward of one 352x1216
   image (resized to 448x1536, where every Swin stage pads its token grid
   to whole windows) on the card against the CPU, fed the card's index
   maps, with the windows each kernel sees logged and checked, the encoder
   at depths (2, 2, 2, 2) (``SHALLOW``) and one repeat of the head
   (``ONE_REPEAT``: 2 K2 and 2 K3 launches) to keep the CPU side short.
6. The driver: a synthetic KITTI tree (16 train and 4 test samples of
   375x1242, written with the port's PNG codec) in a temporary directory,
   then ``train.driver.Trainer`` on the flagship as ``bench.py`` pins it
   (bf16, batch 4, ``use_checkpoint`` on as in JAX): the loader's rate
   alone (``host_only``), ``fit(max_steps=4)`` with its exact launch
   counts (four recomputing steps and one validation forward at
   352x1216), finite losses and metrics and a ``step_4`` checkpoint, its
   img/s with the loader feeding it against the bare step's, its peak
   memory; a second ``Trainer`` resumed from the checkpoint (step, best
   value, every parameter, statistic and moment equal bit for bit);
   ``predict`` (4 uint16 PNGs equal to ``Predictor.predict`` x 256,
   truncated); validate's time at 352x1216; one profiled fit step (the
   loader's next batch and the step).
7. ``oda2_ksa_reg`` at full width (Swin-L, KSA decoder at dec_dim 512, the
   build's defaults, ``use_checkpoint`` on): the f32 batch-1 forward card
   against CPU; bf16 serving at batch 8 (32 K1 and 6 K5 launches), timed
   and profiled; the f32 train step card against CPU at 224x448 (encoder
   depths ``SHALLOW``), at batch 2 with ``freeze_bn`` and at batch 4 with
   batch statistics (see
   ``ksa_train_f32_check``); the bf16 train step at batch 4 on 352x704
   (56 K1 forward and 32 backward, 6 K5 forward and 6 backward), timed and
   profiled.
8. NewCRFs ``large07`` at full width (Swin-L zero-padded, PSP 512, four
   CRF stages of head dim 32; images not resized): K1's q|k + separate-v
   entry and its backward at crf0 (serving batch 4 at 352x1216, the train
   step's batch 4 at 352x704) against their plain versions, timed with
   their bounds and SDPA yardsticks (K1's ``other_shapes``); the f32
   forward card against CPU at KITTI's 352x1216 and NYU's 480x640 with the
   windows each entry sees checked; bf16 serving through ``Predictor`` at
   batch 4 at 352x1216 (32 K1 launches, 8 through the new entry); the f32
   train step card against CPU at 224x448 on 2 colour-cast images; the
   bf16 train step at batch 4 at 352x704 (32 K1 forward and 32 backward,
   8 and 8 through the new entry), timed and profiled; and
   ``Trainer.fit(max_steps=2)`` with one validation on the synthetic KITTI
   tree, its launches and its second step's img/s against the bare step's.

9. The five ODA2 reduction siblings at full width (Swin-B, dec_dim 512, 8
   heads; the ordered ones 3 repeats, num_emb 128, reduction ratio 8 or
   window 8; the JAX builds' defaults otherwise): ``oda2_red_order_reg``
   and ``_cls`` (reduction SAs, DWConv-GLU FFs on K3), ``oda2_red_order_swin``
   (gen-1: bias-free window SAs on K2), ``oda2_red_reg`` (incremental
   reduction SAs, PreNormFFs) and ``oda2_conv`` (PPM and conv pyramid).
   For each: the f32 forward at batch 1 on 352x704 (reg and cls on
   224x448) card against CPU, the encoder at depths ``SHALLOW`` (the reg
   and gen-1 CPU runs fed the card's index maps); bf16 serving at batch
   8 through ``Predictor`` with exact launches (K1 24, and K3 6 for reg and
   cls, K2 6 bias-free for gen-1), timed and profiled, reg also with its
   FFs fused (K1 24, K4 6); the bf16 train step at batch 4 with
   ``use_checkpoint`` (K1 48 and 24 backward, and K3 6 / dxdw 6 or K2 6 /
   bwd 6), timed and profiled. The f32 train step card against CPU at
   224x448, batch 2, for ``oda2_red_order_reg`` and ``oda2_red_order_swin``
   at one repeat of the head (``ONE_REPEAT``).
   K2's backward is also checked and timed bias-free at the gen-1 train
   shape (1568, 64, 512)/8, one depth value, beside SDPA's backward.
10. The ODA2 Luna half at full width (Swin-B, dec_dim 512, 8 heads, 256 aux
   tokens; ``LUNAS``): ``oda2_luna_reg`` and ``_cls`` (Luna-gated pyramid,
   PPM) and ``oda2_red_luna_reg`` (stacked split-Luna over the reduction
   neck, 4 layers). For each: the f32 forward at batch 1 on 352x704 card
   against CPU (encoder depths ``SHALLOW``, as the f32 train steps of 9 and
   10), every gate's zero-initialised ``o_cross2`` seeded on both
   sides (the map, the cls bin centers, red-Luna's eight attention
   weights); bf16 serving at batch 8 through ``Predictor`` (K1 24 only: the
   Luna attentions are plain einsums), timed and profiled; the bf16 train
   step at batch 4 with ``use_checkpoint`` (K1 48 and 24 backward; the cls
   model with the chamfer loss at 0.1), timed and profiled. The f32 train
   step card against CPU at 224x448, batch 2, for ``oda2_luna_cls``
   (chamfer 0.1, ``freeze_bn``) and ``oda2_red_luna_reg``, each checking
   that the loss took the depth map (and the cls centers), not red-Luna's
   attention weights.

11. AdaBins and Depthformer v1-v5 at full width (EfficientNet-B5;
   ``ADABINS``: 256 bins on NYU's 416x544, depth to 10 m, trained with the
   chamfer loss at 0.1 and the encoder at a tenth of the learning rate;
   ``DEPTHFORMERS``: hidden width 512, 8 heads, KITTI 352x704, dropout 0.1,
   v3 100 bins with the chamfer loss at 0.1, v5 key-query width 512). For
   each: the f32 forward at batch 1 card against CPU (the depth, and the
   bin edges and attention weights each returns); bf16 serving at batch 8
   through ``Predictor`` and the bf16 train step at batch 4, each timed and
   profiled with its peak memory, every kernel's launch count exactly 0
   (no kernel of the port lies on these paths). The f32 train step card
   against CPU at batch 2 for ``adabins`` at 288x480 and ``depthformer_v3``
   built for 224x448, each at chamfer 0.1, the CPU fed the sides of the
   card's ReLU and LeakyReLU kinks (``KinkReplay``), checking the maps and
   bin centers the loss took.
12. The ODA family and Depthformer v6-v8 at full width (``LUNA_FAMILY``):
   ``oda_conv``, ``oda_luna``, ``oda_luna_cls`` and ``oda_bins`` on the
   Swin-L/384 window-12 encoder behind the 384-multiple resize (352x704 ->
   384x768; decoder_channels 1024, 256 aux tokens of 256, 8 heads, 256
   bins), and v6, v7 and v8 (hidden 512, 8 heads, 256 aux tokens, v7 the
   1/32 grid's 242, 256 bins). For each: the f32 forward at batch 1 card
   against CPU (ODA at 384x384, the encoder at depths ``SHALLOW`` from PR 18,
   K1 8; v6-v8 at 352x704: the depth, the bins, the
   aux tokens and every Luna weight); bf16 serving at batch 8 on 352x704
   through ``Predictor`` and the bf16 train step at batch 4, timed and
   profiled with peak memory, with exact launches: ODA K1 24 serving and
   24 + 24 backward a step (no recompute), v6-v8 none; the bin models
   train with the chamfer loss at 0.1. Then ``oda_luna_cls``'s f32 train
   step card against CPU at batch 2 on 384x384 (chamfer 0.1, batch
   statistics), whose encoder runs K1's f32 forward and backward at 144
   tokens.
13. The last three ODA models at full width (``ODA_LAST``, the JAX builds'
   defaults): ``oda_lion`` (decoder_channels 2048: axial channel
   attention, 8 f32 weights returned; built for the size it runs at, its
   position embedding taking that 1/32 grid), ``oda_lime`` (256 channels,
   16 layers over a 2048-wide memory; resized by the model; depth at 1/4)
   and ``oda_jeju`` (2048, 128 aux tokens, 64 heads; grouped 5x5 FFs). Each
   as in 12: the f32 forward at batch 1 on 384x384 card against CPU
   (``SHALLOW``; the
   depth, every weight, Jeju's aux tokens), bf16 serving at batch 8 and the
   bf16 train step at batch 4 on 352x704 (resized to 384x768), timed and
   profiled with peak memory, K1 24 serving and 24 + 24 backward a step,
   the loss taking the depth map in every step (J1: JAX's adapter would
   hand it Lion's weights).

14. The rest of the JAX package's surface: each forward kernel's operator
   (``torch.ops.mde.*``: K1 fused qkv and q|k + v, K2, K3, K4, K5) against
   its direct launch at its main-path shape, bit-equal, with device and host
   ms a launch of both; the flagship's forward FLOPs (``utils/flops``) beside
   the serving img/s; the serving model exported (``tools/torch_export.py``:
   bf16, batch 8 at 352x704), loaded in a fresh process and run there (K1
   24, K2 6, K3 6, bit-equal to the eager call; its time to the first output
   against building the model), and in f32 at batch 2 against its eager
   call; the same model with ``return_weights`` (K1 24, K2 0, K3 6, six f32
   weights); and tensor-parallel FFs on a (data=1, model=2) grid of the
   two gloo ranks of the data-parallel phase (``tp_check``: f32 and bf16
   recomputing steps at batch 4 on 224x448 against one process, each
   rank's K3 on 1024 channels, the all-reduces as derived, each rank's
   peak memory).

Each phase group logs its seconds ("seconds: <group> <s>"), and before the
result lines one line sums them, with the model builds' and the profiled
calls' share.

Any failure exits non-zero before the result lines. The last three lines
are the card, the ``kernels`` JSON line and the ``ok`` JSON line. The
``kernels`` line takes the launches of K1, K2 and K3 and their backward
kernels from the driver's ``fit``; K1's and K1 bwd's entries also carry
NewCRFs' launches (``newcrfs_launches``), every other model's that
launches it by model and path (``sibling_launches``: the siblings, the
ODA2 Luna half and the ODA family, Lion, Lime and Jeju included).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

START = time.perf_counter()

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # dense tensor-core peak; the kernels are timed in bf16
SLEEP_CYCLES = 100_000_000  # ~50 ms of the card's clock, ahead of each timed run
BATCH = 8  # serving
TRAIN_BATCH = 4
F32_TOL = 1e-5
# bf16 tolerance relative to max(1, max |plain|); see tests/test_torch_port_gpu.py
BF16_REL = {"window_attention": 3e-2, "ordered_attention": 3e-2, "depthwise_conv2d": 5e-2,
            "window_attention_bwd": 3e-2, "ordered_attention_bwd": 3e-2,
            "depthwise_conv2d_dxdw": 1e-2, "depthwise_conv2d_dw": 1e-4, "glu_ff": 5e-2,
            "channel_attention": 3e-2, "channel_attention_bwd": 3e-2}
# f32 card vs CPU forward, depth in metres (maps scaled by max_depth 80)
MODEL_F32_TOL = 1e-2
# f32 train step, card vs CPU: the loss and norms within 1e-4 of their size;
# each gradient within 5e-4 of that tensor's max |g| (or of 1% of the largest
# |g| of any tensor, where a tensor's gradient is 0 in exact arithmetic);
# BatchNorm statistics within 1e-4 of their size; the parameters within
# lr0 / 4: Adam's first update is about lr0 * sign(g), so where g is near 0
# the two devices may move a parameter either way, by up to lr0 (1 + wd |p|).
# One H100 run measured 3.9e-5, 4.2e-7 and 1.2e-7 for the three (PERF.md).
STEP_LOG_TOL, STEP_GRAD_TOL, STEP_STATS_TOL = 1e-4, 5e-4, 1e-4
LR0 = 1e-4 / 25
STEP_PARAM_TOL = 0.25 * LR0
SOURCES = {
    "window_attention": ("mde_tpu_torch/ops/kernels/csrc/window_attention.cu",
                         "mde_tpu/ops/pallas/window_attention.py:139"),
    "window_attention_bwd": ("mde_tpu_torch/ops/kernels/csrc/window_attention_bwd.cu",
                             "mde_tpu/ops/pallas/window_attention.py:235"),
    "ordered_attention": ("mde_tpu_torch/ops/kernels/csrc/ordered_attention.cu",
                          "mde_tpu/ops/pallas/ordered_attention.py:254"),
    "ordered_attention_bwd": ("mde_tpu_torch/ops/kernels/csrc/ordered_attention_bwd.cu",
                              "mde_tpu/ops/pallas/ordered_attention.py:403"),
    "depthwise_conv2d": ("mde_tpu_torch/ops/kernels/csrc/depthwise.cu",
                         "mde_tpu/ops/pallas/depthwise.py:405"),
    "depthwise_conv2d_dxdw": ("mde_tpu_torch/ops/kernels/csrc/depthwise_dxdw.cu",
                              "mde_tpu/ops/pallas/depthwise.py:322"),
    "depthwise_conv2d_dw": ("mde_tpu_torch/ops/kernels/csrc/depthwise_dw.cu",
                            "mde_tpu/ops/pallas/depthwise.py:189"),
    "glu_ff": ("mde_tpu_torch/ops/kernels/csrc/glu_ff.cu", "mde_tpu/ops/pallas/glu_ff.py:150"),
    "channel_attention": ("mde_tpu_torch/ops/kernels/csrc/channel_attention.cu",
                          "mde_tpu/ops/pallas/channel_attention.py:70"),
    "channel_attention_bwd": ("mde_tpu_torch/ops/kernels/csrc/channel_attention_bwd.cu",
                              "mde_tpu/ops/pallas/channel_attention.py:137"),
}
FLAGSHIP = {"name": "oda2_red_order_swin2", "encoder_type": "base", "dec_dim": 512,
            "num_heads": 8, "num_repeats": 3, "num_emb": 128, "window_size": 8,
            "neck_type": "red33"}
# bench.py:74-98: the JAX package's flagship train step
TRAIN_OPT = {"model": FLAGSHIP,
             "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True, "si_weight": 1.0},
             "optimizer": {"lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 0.1,
                           "eps": 1e-6, "same_lr": True},
             "scheduler": {"name": "onecycle"},
             "train": {"num_accum": 1, "grad_norm": 0.1}}
TRAIN_TOTAL_STEPS = 1000
# launches of one optimizer step on the card (every train step): the fused
# AdamW's norm pass, update pass and finish (ops/kernels/adamw.py), for the
# models of up to 640 parameter tensors that the fixed expectations below
# count (the flagship's 520, NewCRFs' 478, oda_luna_cls's 470); train_run
# derives each model's (optimizer_launches)
OPTIMIZER_LAUNCHES = {"adamw": 3}
# launches of one train step with use_checkpoint off, derived from the code:
# 24 Swin blocks (K1), 3 repeats of 2 ordered SAs (K2) and 2 FFs (K3), each
# forward once and backward once; K3's dw alone never runs (x needs a grad)
TRAIN_LAUNCHES = {"window_attention": 24, "window_attention_bwd": 24,
                  "ordered_attention": 6, "ordered_attention_bwd": 6,
                  "depthwise_conv2d": 6, "depthwise_conv2d_dxdw": 6, "depthwise_conv2d_dw": 0}
# launches of the recomputing step (use_checkpoint) under each
# MDE_REMAT_POLICY (mde_tpu_torch/ops/remat.py), derived from the code: every
# checkpointed block (24 Swin blocks, 3 ordered head repeats) runs its
# forward again in the backward pass. The attentions run again under every
# policy: o_proj's weight gradient needs K1's and K2's outputs, which no
# policy keeps (K1 48, K2 12; the kept sa_out spares no work). A FF's conv
# runs again unless its output (dw_conv) is kept: K3 12 under full and
# save_sa, 6 under save_sa_conv and save_sa_conv_glu, where K3 dxdw takes
# the recomputed GLU output (or the kept one) and the weight. No backward
# kernel runs twice. The other recomputing paths below (KSA, the siblings,
# the Luna half) recompute Swin blocks only, whose one tag is sa_out: their
# launches are the same under every policy
REMAT_POLICIES = ("full", "save_sa", "save_sa_conv", "save_sa_conv_glu")
REMAT_LAUNCHES = dict.fromkeys(("full", "save_sa"), dict(
    TRAIN_LAUNCHES, window_attention=48, ordered_attention=12, depthwise_conv2d=12))
REMAT_LAUNCHES.update(dict.fromkeys(("save_sa_conv", "save_sa_conv_glu"), dict(
    REMAT_LAUNCHES["full"], depthwise_conv2d=6)))
# the default policy, JAX's (ops/remat.DEFAULT_POLICY)
CHECKPOINT_LAUNCHES = REMAT_LAUNCHES["save_sa_conv"]
# one serving forward with the six FFs fused: K4 takes K3's place
FUSED_SERVE_LAUNCHES = {"window_attention": 24, "ordered_attention": 6, "glu_ff": 6}
# oda2_ksa_reg as the JAX build makes it from dec_dim alone (ksa.py:326-341):
# Swin-L, decoder depths (2, 2, 2, 2), heads (4, 8, 16, 32), window 7,
# use_checkpoint on the encoder
KSA = {"name": "oda2_ksa_reg", "dec_dim": 512}
KSA_TRAIN_OPT = dict(TRAIN_OPT, model=KSA)
# launches derived from the code: 24 Swin-L blocks and 2 decoder Swin blocks
# (K1), and in each of the 6 KSA blocks one kernel-window attention (K5) and
# one W-MSA (K1). In the train step use_checkpoint runs the 24 encoder
# blocks' forwards twice; the decoder is not recomputed.
KSA_SERVE_LAUNCHES = {"window_attention": 32, "channel_attention": 6}
KSA_TRAIN_LAUNCHES = {"window_attention": 56, "window_attention_bwd": 32,
                      "channel_attention": 6, "channel_attention_bwd": 6}
# NewCRFs large07 as the JAX build makes it (mde_tpu/models/newcrfs/model.py:
# 185-193), NeW CRFs' published KITTI setting: Swin-L, window 7, PSP 512, CRF
# widths 128/256/512/1024 with 4/8/16/32 heads of dim 32, bilinear x4 up, no
# recompute. Launches derived from the code: 24 Swin-L blocks through K1's
# fused entry and 8 CRF blocks through its q|k + v entry, forward and, in the
# train step, backward; the images are not resized
NEWCRFS = {"name": "newcrfs", "version": "large07"}
NEWCRFS_TRAIN_OPT = dict(TRAIN_OPT, model=NEWCRFS)
NEWCRFS_SERVE_LAUNCHES = {"window_attention": 32}
NEWCRFS_TRAIN_LAUNCHES = {"window_attention": 32, "window_attention_bwd": 32}
NEWCRFS_SERVE_ENTRIES = {"window_attention_qk_v": 8}
NEWCRFS_TRAIN_ENTRIES = {"window_attention_qk_v": 8, "window_attention_qk_v_bwd": 8}
NEWCRFS_BATCH = 4  # serving at the KB crop, and training at 352x704
NYU_HW = (480, 640)
# crf0's token grid padded to whole 7x7 windows, by windows an image: 88x304
# at the KB crop (572), 88x176 at the train crop 352x704 (338)
CRF0_GRIDS = {572: (91, 308), 338: (91, 182)}
# the five ODA2 reduction siblings at bench.py's decoder widths (bench.py:74-78)
# with the name swapped and the JAX builds' defaults otherwise: Swin-B,
# reduction ratio 8, window 8 (gen-1), use_checkpoint on the encoder only
ORDERED_SIBLING = {"encoder_type": "base", "dec_dim": 512, "num_heads": 8, "num_repeats": 3,
                   "num_emb": 128}
SIBLINGS = {"oda2_red_order_reg": dict(ORDERED_SIBLING, name="oda2_red_order_reg"),
            "oda2_red_order_cls": dict(ORDERED_SIBLING, name="oda2_red_order_cls"),
            "oda2_red_order_swin": dict(ORDERED_SIBLING, name="oda2_red_order_swin"),
            "oda2_red_reg": {"name": "oda2_red_reg", "encoder_type": "base", "dec_dim": 512,
                             "num_heads": 8},
            "oda2_conv": {"name": "oda2_conv", "encoder_type": "base", "dec_dim": 512}}
# launches derived from the code: the 24 Swin-B blocks (K1); the reg and cls
# heads' 3 blocks of 2 DWConv-GLU FFs (K3, or K4 when fused); gen-1's 3 blocks
# of 2 bias-free window SAs (K2); the reduction SAs, PreNormFFs, PPM and convs
# are PyTorch's. The train step recomputes the encoder (K1 48 forward).
SIBLING_SERVE_LAUNCHES = {
    "oda2_red_order_reg": {"window_attention": 24, "depthwise_conv2d": 6},
    "oda2_red_order_cls": {"window_attention": 24, "depthwise_conv2d": 6},
    "oda2_red_order_swin": {"window_attention": 24, "ordered_attention": 6},
    "oda2_red_reg": {"window_attention": 24}, "oda2_conv": {"window_attention": 24}}
SIBLING_FUSED_SERVE_LAUNCHES = {"window_attention": 24, "glu_ff": 6}
ENCODER_TRAIN_LAUNCHES = {"window_attention": 48, "window_attention_bwd": 24}
SIBLING_TRAIN_LAUNCHES = {
    "oda2_red_order_reg": dict(ENCODER_TRAIN_LAUNCHES, depthwise_conv2d=6,
                               depthwise_conv2d_dxdw=6),
    "oda2_red_order_cls": dict(ENCODER_TRAIN_LAUNCHES, depthwise_conv2d=6,
                               depthwise_conv2d_dxdw=6),
    "oda2_red_order_swin": dict(ENCODER_TRAIN_LAUNCHES, ordered_attention=6,
                                ordered_attention_bwd=6),
    "oda2_red_reg": ENCODER_TRAIN_LAUNCHES, "oda2_conv": ENCODER_TRAIN_LAUNCHES}
# the f32 forward's image and maps: one 352x704 image (resized to 448x896), or
# for reg and cls one 224x448 image (not resized; their CPU forwards took 15 s
# a model at 352x704); the ordered heads' 4 maps at 1/4 scale, red_reg's at
# 1/4 less 2 px, conv's at 1/2
SIBLING_MAPS = {"oda2_red_order_reg": ((224, 448), 4, (1, 56, 112, 1)),
                "oda2_red_order_cls": ((224, 448), 4, (1, 56, 112, 1)),
                "oda2_red_order_swin": ((352, 704), 4, (1, 112, 224, 1)),
                "oda2_red_reg": ((352, 704), 1, (1, 110, 222, 1)),
                "oda2_conv": ((352, 704), 1, (1, 224, 448, 1))}
# the ODA2 Luna half at bench.py's decoder widths with the name swapped and the
# JAX builds' defaults otherwise (luna.py:277-292, red_luna.py:221-234):
# Swin-B, dec_dim 512 (the gated decoders' decoder_channels), 8 heads, 256 aux
# tokens (of 256 in the gated decoders, of dec_dim in red-Luna), red-Luna 4
# layers; the gated decoders train with dropout 0.1, as JAX builds them.
# name -> (config, serving launches, train-step launches, the map of one
# 352x704 image): the 24 Swin-B blocks run K1, the Luna attentions are plain
# einsums (no kernel), the train step recomputes the encoder; the maps are at
# 1/4 scale, red-Luna's less 2 px
LUNA_DECODER = {"encoder_type": "base", "dec_dim": 512, "num_heads": 8, "num_aux": 256}
LUNAS = {
    "oda2_luna_reg": (dict(LUNA_DECODER, name="oda2_luna_reg", aux_dim=256),
                      {"window_attention": 24}, ENCODER_TRAIN_LAUNCHES, (1, 112, 224, 1)),
    "oda2_luna_cls": (dict(LUNA_DECODER, name="oda2_luna_cls", aux_dim=256),
                      {"window_attention": 24}, ENCODER_TRAIN_LAUNCHES, (1, 112, 224, 1)),
    "oda2_red_luna_reg": (dict(LUNA_DECODER, name="oda2_red_luna_reg", num_layers=4),
                          {"window_attention": 24}, ENCODER_TRAIN_LAUNCHES, (1, 110, 222, 1))}
# attention weights (probabilities; red-Luna's, Depthformer's), card against
# CPU: the maps' tolerance in units of the depth range (80 m)
WEIGHTS_TOL = MODEL_F32_TOL / 80.0
# AdaBins as the reference's json/nyu/adabins/adabins_cham_per_batch.json
# (tools/bench_families.py:93-97): EfficientNet-B5, 256 bins, NYU's train crop
# 416x544, depth 1e-3 to 10 m; it trains with the chamfer loss at 0.1 and the
# encoder at a tenth of the learning rate (same_lr false)
ADABINS = {"name": "adabins", "num_bins": 256, "bn_momentum": 0.1}
ADABINS_HW, ADABINS_MAX_DEPTH = (416, 544), 10.0
ADABINS_TRAIN_OPT = dict(TRAIN_OPT, model=ADABINS,
                         loss=dict(TRAIN_OPT["loss"], chamfer_weight=0.1),
                         optimizer=dict(TRAIN_OPT["optimizer"], same_lr=False))
# Depthformer v1-v5 at the v2 decoder's hidden width 512 and 8 heads (SURVEY.md
# section 2.4), KITTI 352x704, depth 1e-3 to 80 m, the builds' dropout of 0.1
# and 0.1; v3 100 bins and the chamfer loss at 0.1, v5 key-query width 512.
# name -> (config, the depth map of one 352x704 image and the shapes of the
# other outputs: v1 four (B, 8, 242, 242) weights at the 1/32 grid of 11x22; v2,
# v3, v5 the 1/8, 1/16 and 1/32 grids' (B, heads, N, N), heads 2, 4, 8; v3's
# edges first; v4 the cls token's (B, 8, N) at each scale from 1/32 to 1/2).
# No kernel of the port lies on these paths: every launch count stays 0
DEPTHFORMER = {"hidden_dim": 512, "num_heads": 8, "img_size": (352, 704)}
DF_GRIDS = [(2, 3872), (4, 968), (8, 242)]
DEPTHFORMERS = {
    "depthformer": (dict(DEPTHFORMER, name="depthformer"), [(1, 8, 242, 242)] * 4),
    "depthformer_v2": (dict(DEPTHFORMER, name="depthformer_v2"),
                       [(1, h, n, n) for h, n in DF_GRIDS]),
    "depthformer_v3": (dict(DEPTHFORMER, name="depthformer_v3", num_bins=100),
                       [(1, 101)] + [(1, h, n, n) for h, n in DF_GRIDS]),
    "depthformer_v4": (dict(DEPTHFORMER, name="depthformer_v4"),
                       [(1, 8, n) for n in (242, 968, 3872, 15488, 61952)]),
    "depthformer_v5": (dict(DEPTHFORMER, name="depthformer_v5", key_query_dim=512),
                       [(1, h, n, n) for h, n in DF_GRIDS])}
# the ODA family as the JAX builds make it (mde_tpu/models/oda/models.py;
# no reference config is in the repo): the Swin-L/384 window-12 encoder behind
# the 384-multiple resize (352x704 -> 384x768), decoder_channels 1024, 256 aux
# tokens of 256, 8 heads, 256 bins, KITTI depth to 80 m; Depthformer v6-v8 at
# DEPTHFORMER's widths with 256 aux tokens (v7: the 1/32 grid's 242) and 256
# bins, the builds' dropout of 0.1 and 0.1.
# name -> (config, f32 check image size, serving launches, train-step launches,
# the number of tensors after the depth map): the 24 Swin-L blocks run K1 (the
# encoder does not recompute, as JAX's), the Luna attentions are plain einsums;
# v6-v8 launch no kernel
ODA_LUNA = {"decoder_channels": 1024, "num_aux": 256, "aux_dim": 256, "num_heads": 8}
ODA_SERVE_LAUNCHES = {"window_attention": 24}
# the ODA models' f32 card-vs-CPU forwards run their encoder at depths
# SHALLOW: one launch a block
ODA_F32_LAUNCHES = {"window_attention": 8}
ODA_TRAIN_LAUNCHES = {"window_attention": 24, "window_attention_bwd": 24}
LUNA_FAMILY = {
    "oda_conv": (dict(name="oda_conv", decoder_channels=1024), (384, 384), ODA_SERVE_LAUNCHES,
                 ODA_TRAIN_LAUNCHES, 0),
    "oda_luna": (dict(ODA_LUNA, name="oda_luna"), (384, 384), ODA_SERVE_LAUNCHES,
                 ODA_TRAIN_LAUNCHES, 9),
    "oda_luna_cls": (dict(ODA_LUNA, name="oda_luna_cls", num_bins=256), (384, 384),
                     ODA_SERVE_LAUNCHES, ODA_TRAIN_LAUNCHES, 10),
    "oda_bins": (dict(name="oda_bins", decoder_channels=1024, num_bins=256), (384, 384),
                 ODA_SERVE_LAUNCHES, ODA_TRAIN_LAUNCHES, 1),
    "depthformer_v6": (dict(DEPTHFORMER, name="depthformer_v6", num_aux=256, num_bins=256),
                       (352, 704), {}, {}, 9),
    "depthformer_v7": (dict(DEPTHFORMER, name="depthformer_v7", num_aux=256, num_bins=256),
                       (352, 704), {}, {}, 9),
    "depthformer_v8": (dict(DEPTHFORMER, name="depthformer_v8", num_aux=256, num_bins=256),
                       (352, 704), {}, {}, 9)}
# the chamfer loss at 0.1 where a model returns bins (centers or edges)
LUNA_CHAMFER = ("oda_luna_cls", "oda_bins", "depthformer_v7", "depthformer_v8")
# the last three ODA models as the JAX builds make them (mde_tpu/models/oda/
# {lion,lime,jeju}.py; no reference config or weights are in the repo): the
# same encoder and resize; oda_lion decoder_channels 2048 (PPM-v2 proj 512),
# oda_lime 256 and 16 layers (the model resizes; its depth is at 1/4 scale),
# oda_jeju 2048, 128 aux tokens, 64 heads; dropout 0.1, attention dropout 0,
# sigmoid heads. In LUNA_FAMILY's layout: lion returns 8 weights, lime 16, jeju
# its aux tokens and 8 weights; the encoder runs K1, the decoders no kernel
ODA_LAST = {
    "oda_lion": (dict(name="oda_lion", decoder_channels=2048), (384, 384), ODA_SERVE_LAUNCHES,
                 ODA_TRAIN_LAUNCHES, 8),
    "oda_lime": (dict(name="oda_lime", decoder_channels=256, decoder_layers=16), (384, 384),
                 ODA_SERVE_LAUNCHES, ODA_TRAIN_LAUNCHES, 16),
    "oda_jeju": (dict(name="oda_jeju", decoder_channels=2048, num_aux=128, num_heads=64),
                 (384, 384), ODA_SERVE_LAUNCHES, ODA_TRAIN_LAUNCHES, 9)}
# the depth map's scale of the (resized) input where it is not 1/2
DEPTH_SCALE = {"oda_lime": 4}
# the earlier paths' f32 CPU references (the flagship at 352x1216, the siblings'
# and the ODA2 Luna models' forwards and train steps, from PR 18 the ODA models'
# forwards) run a Swin of depths (2, 2, 2, 2) on both devices: full width, cut
# depth, to keep the CPU side short
SHALLOW = {"depths": (2, 2, 2, 2)}
# the ordered heads' f32 references at 352x1216 and in the flagship's and the
# ordered siblings' f32 train steps run one repeat of three (full width, cut
# depth): the plain K3 of the 2048-channel FFs took most of their CPU time
# (with three repeats, on an H100's host: the 352x1216 forward 32.6 s,
# oda2_red_order_reg's step 33.6 s; PERF.md)
ONE_REPEAT = {"num_repeats": 1}
# one eval forward of the flagship (no gradient, so nothing recomputes)
EVAL_LAUNCHES = {"window_attention": 24, "ordered_attention": 6, "depthwise_conv2d": 6}
# KITTI's test images after the KB-crop; the flagship resizes them to 448x1536
EVAL_HW = (352, 1216)
# 7x7 windows an image at each Swin stage of 448x1536: token grids 112x384,
# 56x192, 28x96 and 14x48, each padded to whole windows (stage depths 2, 2,
# 2, 2 in the f32 check, SHALLOW); K2 sees 14x48 windows of 8x8 at 1/4 scale,
# K3 (B, 112, 384, 2048)
EVAL_WINDOWS = [880] * 2 + [224] * 2 + [56] * 2 + [14] * 2
# the driver phase's synthetic KITTI tree: raw images and depth maps of the
# camera's shape, and the focal column of the split lists
KITTI_RAW_HW = (375, 1242)
DRIVER_TRAIN, DRIVER_TEST, DRIVER_STEPS = 16, 4, 4


def log(*args):
    print(*args, flush=True)


# seconds by phase group, and the count and seconds of the model builds and
# profiles inside them, for the line before the result lines
SECONDS: dict = {}
OVERHEAD = {"builds": [0, 0.0], "profiles": [0, 0.0]}


@contextlib.contextmanager
def timed(label: str, group: bool = False):
    """Log the seconds the block took ("seconds: <label> <s>"); a ``group``
    adds them to ``SECONDS`` under its label."""
    t0 = time.perf_counter()
    yield
    s = time.perf_counter() - t0
    if group:
        SECONDS[label] = SECONDS.get(label, 0.0) + s
    log(f"seconds: {label} {s:.1f}")


def count_builds() -> None:
    """Make ``mde_tpu_torch.models.build_model`` add its calls and seconds to
    ``OVERHEAD`` (every phase imports it at call time)."""
    from mde_tpu_torch import models
    real = models.build_model

    def build_model(*args, **kwargs):
        t0 = time.perf_counter()
        model = real(*args, **kwargs)
        OVERHEAD["builds"][0] += 1
        OVERHEAD["builds"][1] += time.perf_counter() - t0
        return model

    models.build_model = build_model


def log_seconds() -> None:
    """The seconds of each phase group, their sum, the builds' and
    profiles' share of it, and the script's own clock."""
    total = sum(SECONDS.values())
    (nb, sb), (np_, sp) = OVERHEAD["builds"], OVERHEAD["profiles"]
    log(f"seconds by group: {json.dumps({k: round(v, 1) for k, v in SECONDS.items()})}; "
        f"sum {total:.1f} s (model builds {nb} in {sb:.1f} s, profiled calls {np_} in "
        f"{sp:.1f} s); the script's clock {time.perf_counter() - START:.1f} s")


def free_garbage() -> None:
    """Collect the reference cycles an earlier phase left behind, so that
    the next peak memory counts only what its own run holds: a finished
    train step's frames stay in cycles until a collection, and with them
    the model and optimizer state they reference."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """Device ms of one call of ``fn``: the calls are queued behind a kernel
    that keeps the card busy for ~50 ms, so that the host's time between
    them (Python wrappers, launches) opens no gap in the timed span. On a
    busy host that time can exceed a short kernel's own. Warns where the
    host took longer to queue the calls than the card slept (gaps may then
    be counted). With ``queued=False``, the calls follow a synchronisation
    instead, and any gaps between them count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end, slept = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    if queued:
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if queued and host_ms > slept.elapsed_time(start):
        log(f"  warning: the host took {host_ms:.2f} ms to queue {iters} calls, longer than "
            f"the card's {slept.elapsed_time(start):.2f} ms sleep: gaps may be timed")
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms the card could take, what binds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def window_phase(stage: str, bw: int, c: int, heads: int, nw: int, masked: bool, dev):
    from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention,
                                                            window_attention)
    from mde_tpu_torch.ops.window import shifted_window_attn_mask
    g = torch.Generator(device=dev).manual_seed(1)
    n = 49
    mask = shifted_window_attn_mask(*WINDOW_GRIDS[nw], 7, 3, dev) if masked else None
    bias = torch.randn(heads, n, n, generator=g, device=dev)

    def make(dtype):
        qkv = torch.randn(bw, n, 3 * c, generator=g, device=dev).to(dtype)
        return qkv, bias, mask, heads, (c // heads) ** -0.5

    def plain(qkv, *rest):
        return plain_window_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], *rest)

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2)
                   for t in args[0].split(c, dim=-1))
        add = window_mask(bias, mask, bw, q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=args[-1])

    def cost(args, outs):
        return nbytes(*args[:3], *outs), 4 * bw * n * n * c

    name = f"K1 {stage} ({bw},{n},{c})/{heads}{' masked' if masked else ''}"
    return kernel_phase("window_attention", name, window_attention, plain, make, library, cost)


# the (H, W) token grid of each Swin stage at 448x896, by its number of 7x7 windows
WINDOW_GRIDS = {512: (112, 224), 128: (56, 112), 32: (28, 56), 8: (14, 28)}


def window_mask(bias, mask, bw, dtype):
    """(bw, heads, N, N) additive mask of bias + shift mask, for SDPA."""
    add = bias[None] if mask is None else bias[None] + mask[:, None]
    add = add.expand(bw // add.shape[0], *add.shape).reshape(bw, *bias.shape)
    return add.to(dtype).contiguous()


def ordered_phase(with_table: bool, dev):
    from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention,
                                                             plain_ordered_attention)
    g = torch.Generator(device=dev).manual_seed(2)
    bw, n, c, heads, e = 392 * BATCH, 64, 512, 8, 128
    idx = torch.randint(0, e, (bw, n), generator=g, device=dev, dtype=torch.int32)
    table = torch.randn(2 * e - 1, heads, generator=g, device=dev) if with_table else None

    def make(dtype):
        q, k, v = (torch.randn(bw, n, c, generator=g, device=dev).to(dtype) for _ in range(3))
        return q, k, v, idx, table, heads, (c // heads) ** -0.5, e

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2) for t in args[:3])
        add = ordered_mask(idx, table, e, q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=args[-2])

    def cost(args, outs):
        return nbytes(*args[:3], idx if with_table else None, table, *outs), 4 * bw * n * n * c

    name = f"K2 ({bw},{n},{c})/{heads} {'with table' if with_table else 'bias-free'}"
    return kernel_phase("ordered_attention", name, ordered_attention, plain_ordered_attention,
                        make, library, cost)


def ordered_mask(idx, table, e, dtype):
    """(bw, heads, N, N) depth-bias mask T[i_q - i_k + E - 1], for SDPA."""
    if table is None:
        return None
    rel = idx[:, :, None].long() - idx[:, None, :].long() + e - 1
    return table.t()[:, rel].permute(1, 0, 2, 3).to(dtype).contiguous()


def depthwise_phase(dev, batch: int = BATCH):
    """K3 at the FF shape of serving (or, with ``batch``, of the train step)."""
    from mde_tpu_torch.ops.kernels.depthwise import depthwise_conv2d, plain_depthwise_conv2d
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (batch, 112, 224, 2048)

    def make(dtype):
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        w = (torch.randn(5, 5, shape[-1], generator=g, device=dev) * 0.2).to(dtype)
        return x, w

    def library(args):
        x, w = args
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(2, 0, 1)[:, None].contiguous()
        return lambda: F.conv2d(F.pad(xc, (2, 2, 2, 2), mode="replicate"), wc,
                                groups=shape[-1])

    def cost(args, outs):
        return nbytes(*args, *outs), 2 * outs[0].numel() * 25

    return kernel_phase("depthwise_conv2d", f"K3 {shape} 5x5", depthwise_conv2d,
                        plain_depthwise_conv2d, make, library, cost)


def window_bwd_phase(stage: str, bw: int, c: int, heads: int, nw: int, dev):
    """K1 backward at one of the train step's SW-MSA shapes."""
    from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention_bwd,
                                                            window_attention_bwd)
    from mde_tpu_torch.ops.window import shifted_window_attn_mask
    g = torch.Generator(device=dev).manual_seed(4)
    n = 49
    mask = shifted_window_attn_mask(*WINDOW_GRIDS[nw], 7, 3, dev)
    bias = torch.randn(heads, n, n, generator=g, device=dev)

    def make(dtype):
        qkv = torch.randn(bw, n, 3 * c, generator=g, device=dev).to(dtype)
        dout = torch.randn(bw, n, c, generator=g, device=dev).to(dtype)
        return qkv, dout, bias, mask, heads, (c // heads) ** -0.5

    def plain(qkv, dout, *rest):
        dq, dk, dv, dbias = plain_window_attention_bwd(
            qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], dout, *rest)
        return torch.cat([dq, dk, dv], dim=-1), dbias

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2).detach()
                   .requires_grad_() for t in args[0].split(c, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=window_mask(bias, mask, bw,
                                                                              q.dtype),
                                             scale=args[-1])
        grad = args[1].reshape(bw, n, heads, c // heads).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)

    def cost(args, outs):
        return nbytes(*args[:4], *outs), 10 * bw * n * n * c

    return kernel_phase("window_attention_bwd", f"K1 bwd {stage} ({bw},{n},{c})/{heads} masked",
                        window_attention_bwd, plain, make, library, cost, relative=True)


def window_indices(pattern: str, bw: int, e: int, g, dev) -> torch.Tensor:
    """(bw, 64) int32 depth indices in [0, e): drawn uniformly ("uniform"),
    or one index a window ("one_bucket": every dS of a window in one dT
    bucket)."""
    if pattern == "uniform":
        return torch.randint(0, e, (bw, 64), generator=g, device=dev, dtype=torch.int32)
    base = torch.randint(0, e, (bw, 1), generator=g, device=dev, dtype=torch.int32)
    return base.expand(bw, 64).contiguous()


def ordered_bwd_phase(dev, pattern: str = "uniform", with_table: bool = True):
    """K2 backward at the train step's shape: with the table, on indices of
    ``pattern`` (``window_indices``), as the flagship runs it, or bias-free
    with one depth value, as the gen-1 head (``oda2_red_order_swin``) does."""
    from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention_bwd,
                                                             plain_ordered_attention_bwd)
    g = torch.Generator(device=dev).manual_seed(5)
    bw, n, c, heads, e = 392 * TRAIN_BATCH, 64, 512, 8, 128 if with_table else 1
    idx = window_indices(pattern, bw, e, g, dev) if with_table else None
    table = torch.randn(2 * e - 1, heads, generator=g, device=dev) if with_table else None

    def make(dtype):
        q, k, v, dout = (torch.randn(bw, n, c, generator=g, device=dev).to(dtype)
                         for _ in range(4))
        return q, k, v, dout, idx, table, heads, (c // heads) ** -0.5, e

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2).detach()
                   .requires_grad_() for t in args[:3])
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=ordered_mask(idx, table, e,
                                                                               q.dtype),
                                             scale=args[-2])
        grad = args[3].reshape(bw, n, heads, c // heads).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)

    def cost(args, outs):
        return nbytes(*args[:6], *outs), 10 * bw * n * n * c

    name = (f"K2 bwd ({bw},{n},{c})/{heads} "
            + (f"with table, {pattern} indices" if with_table else "bias-free (gen-1)"))
    # with one index a window a dT entry sums many dS that cancel (each row of
    # dS sums to 0, so the exact dT is 0), and the f32 dT of both versions is
    # rounding of those sums in different orders: that pattern is checked in
    # bf16 only, where the tolerance allows for it
    dtypes = (torch.float32, torch.bfloat16) if pattern == "uniform" else (torch.bfloat16,)
    return kernel_phase("ordered_attention_bwd", name, ordered_attention_bwd,
                        plain_ordered_attention_bwd, make, library, cost, relative=True,
                        dtypes=dtypes)


def depthwise_bwd_phase(dev, dxdw: bool):
    """K3 dxdw (or dw alone) at the train step's FF shape."""
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.ops.kernels.depthwise import (depthwise_dw, depthwise_dxdw,
                                                     plain_depthwise_dw, plain_depthwise_dxdw)
    g = torch.Generator(device=dev).manual_seed(6)
    shape = (TRAIN_BATCH, 112, 224, 2048)

    def make(dtype):
        x, dout = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(2))
        w = (torch.randn(5, 5, shape[-1], generator=g, device=dev) * 0.2).to(dtype)
        return x, dout, w

    def library(args):
        x, dout, w = args
        x = x.detach().requires_grad_()
        wc = w.permute(2, 0, 1)[:, None].contiguous().requires_grad_()
        gc = dout.permute(0, 3, 1, 2)
        if dxdw:
            out = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate"), wc,
                           groups=shape[-1])
            return lambda: torch.autograd.grad(out, (x, wc), gc, retain_graph=True)
        xp = F.pad(x.detach().permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
        return lambda: torch.nn.grad.conv2d_weight(xp, wc.shape, gc, groups=shape[-1])

    def cost(args, outs):
        per = 4 if dxdw else 2  # multiply-adds of dx and dw, or of dw alone
        return nbytes(*(args if dxdw else args[:2]), *outs), per * 25 * args[0].numel()

    if dxdw:
        return kernel_phase("depthwise_conv2d_dxdw", f"K3 dxdw {shape} 5x5", depthwise_dxdw,
                            plain_depthwise_dxdw, make, library, cost, relative=True)
    bodies = []

    def make_dw(dtype):  # and note the body that the C entry point picks for them
        x, dout, w = make(dtype)
        tiled = kernels.library().mde_depthwise_conv2d_dw_tiled(
            x.data_ptr(), dout.data_ptr(), x.shape[-1], w.shape[0], kernels.dtype_code(x))
        bodies.append("tiled" if tiled else "gather")
        return x, dout, w

    result = kernel_phase("depthwise_conv2d_dw", f"K3 dw {shape} 5x5", depthwise_dw,
                          lambda x, dout, w: plain_depthwise_dw(x, dout, 5, 5), make_dw,
                          library, cost, relative=True)
    result["body"] = bodies[-1]
    log(f"K3 dw {shape} 5x5: the {result['body']} body ran")
    return result


def glu_phase(dev):
    """K4 at the flagship's serving FF shape; no single PyTorch call computes
    it, so the port's unfused chain (gate, K3, BatchNorm, GELU) on the same
    input is timed beside it."""
    from mde_tpu_torch.ops.kernels.depthwise import depthwise_conv2d
    from mde_tpu_torch.ops.kernels.glu_ff import glu_ff, plain_glu_ff
    from mde_tpu_torch.ops.tnn import BatchNorm, gelu
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (BATCH, 112, 224, 2048)

    def make(dtype):
        ab = torch.randn(*shape[:3], 2 * shape[-1], generator=g, device=dev).to(dtype)
        w = (torch.randn(5, 5, shape[-1], generator=g, device=dev) * 0.2).to(dtype)
        s = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
        return ab, w, s, 0.1 * torch.randn(shape[-1], generator=g, device=dev)

    def unfused(args):
        ab, w = args[:2]
        bn = BatchNorm(shape[-1]).to(dev).eval()
        a, b = ab.chunk(2, dim=-1)
        return lambda: gelu(bn(depthwise_conv2d((a * torch.sigmoid(b)).contiguous(), w)))

    def cost(args, outs):
        # the taps' multiply-adds, and ~14 operations per output for the
        # gate, the affine and the erf GELU
        return nbytes(*args, *outs), (2 * 25 + 14) * outs[0].numel()

    return kernel_phase("glu_ff", f"K4 {shape[:3] + (2 * shape[-1],)} -> {shape[-1]} 5x5",
                        glu_ff, plain_glu_ff, make, None, cost,
                        extra={"unfused_chain_ms": unfused})


def channel_sdpa(q, k, v, heads, grad=None):
    """One ``F.scaled_dot_product_attention`` call computing K5 (or, given
    the output gradient ``grad``, its backward) on transposed tensors:
    channels as the sequence, the N tokens as the head dim. Returns (the
    timed callable, the name of the SDPA backend that took head dim N)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    bw, n, c = q.shape
    ec = k.shape[-1]

    def t(x, ch):
        return x.reshape(bw, n, heads, ch // heads).permute(0, 2, 3, 1).contiguous()

    qt, kt, vt = t(q, c), t(k, ec), t(v, ec)
    if grad is not None:
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
    scale = (1.0 / n) ** 0.5
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:  # the yardstick takes the first backend that accepts these shapes
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
                if grad is not None:
                    gt = t(grad, c)
                    torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
        except RuntimeError:
            continue
        if grad is None:
            def call(backend=backend):
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        else:
            def call(backend=backend, out=out, gt=gt):
                with sdpa_kernel(backend):
                    return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
        return call, backend.name
    raise RuntimeError("no SDPA backend took the channel-attention yardstick")


def channel_phase(dev, backward: bool, c: int = 64):
    """K5 forward at the KSA decoder's stage-0 serving shape (batch 8), or
    its backward at the train step's (batch 4): 49 tokens, 64 channels on
    both sides, 4 heads of 16. With ``c`` 128 or 256, stage 1 or 2: a
    quarter or a sixteenth of the windows, heads of 16."""
    from mde_tpu_torch.ops.kernels.channel_attention import (channel_attention,
                                                             channel_attention_bwd,
                                                             plain_channel_attention,
                                                             plain_channel_attention_bwd)
    g = torch.Generator(device=dev).manual_seed(8 + backward)
    bw = 512 * (TRAIN_BATCH if backward else BATCH) * 64 * 64 // (c * c)
    n, heads = 49, c // 16
    scale = (1.0 / n) ** 0.5
    names = {}

    def make(dtype):
        q = torch.randn(bw, n, c, generator=g, device=dev).to(dtype)
        kv = torch.randn(bw, n, 2 * c, generator=g, device=dev).to(dtype)
        if backward:
            return q, kv, torch.randn(bw, n, c, generator=g, device=dev).to(dtype), heads, scale
        return q, kv, heads, scale

    def plain(q, kv, *rest):
        k, v = kv[..., :c], kv[..., c:]
        if not backward:
            return plain_channel_attention(q, k, v, *rest)
        dq, dk, dv = plain_channel_attention_bwd(q, k, v, *rest)
        return dq, torch.cat([dk, dv], dim=-1)

    def library(args):
        q, kv = args[:2]
        call, names["library"] = channel_sdpa(q, kv[..., :c], kv[..., c:], heads,
                                              args[2] if backward else None)
        return call

    def cost(args, outs):
        products = 5 if backward else 2  # S, P.v; and dP, dv, dq, dk
        return nbytes(*args[:3 if backward else 2], *outs), 2 * products * bw * n * c * c // heads

    kernel = "channel_attention_bwd" if backward else "channel_attention"
    result = kernel_phase(kernel, f"K5{' bwd' if backward else ''} ({bw},{n},{c})/{heads}",
                          channel_attention_bwd if backward else channel_attention, plain,
                          make, library, cost, relative=backward)
    result["library"] = f"SDPA ({names['library']}) on the transposed tensors"
    log(f"  K5{' bwd' if backward else ''} yardstick: {result['library']}")
    return result


def kernel_phase(kernel, name, fn, plain, make, library, cost, relative=False,
                 extra=None, dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """Check ``fn`` against ``plain`` in each of ``dtypes``, bf16 last (each
    output: within F32_TOL, relative to max(1, max |plain|) when
    ``relative``, or BF16_REL of that); time both, the library yardstick
    (None where there is none) and each of ``extra``'s callables in bf16."""
    from mde_tpu_torch.ops import kernels
    result = {"phase": name, "kernel": kernel}
    for dtype in dtypes:
        args = make(dtype)
        before = kernels.launch_counts[kernel]
        outs = as_tuple(fn(*args))
        torch.cuda.synchronize()
        if kernels.launch_counts[kernel] != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch its kernel")
        refs = as_tuple(plain(*args))
        err = 0.0
        tag = "f32" if dtype == torch.float32 else "bf16"
        for out, ref in zip(outs, refs):
            if ref is None or out is None:  # an output the call does not make (dT bias-free)
                if out is not ref:
                    raise RuntimeError(f"{name}: the kernel and its plain version return "
                                       f"different outputs")
                continue
            e = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            tol = (F32_TOL * (scale if relative else 1.0) if dtype == torch.float32
                   else BF16_REL[kernel] * scale)
            log(f"{name} {tag}: max_abs_err {e:.3e} (tolerance {tol:.3e}, output "
                f"{tuple(out.shape)})")
            if not (torch.isfinite(out.float()).all() and e <= tol):
                raise RuntimeError(f"{name} {tag}: kernel disagrees with its plain version")
            err = max(err, e)
        result[f"max_abs_err_{tag}"] = err
        del refs
    result["ms"] = time_ms(lambda: fn(*args))
    result["host_ms"] = time_ms(lambda: fn(*args), queued=False)
    result["plain_ms"] = time_ms(lambda: plain(*args), iters=3, warmup=1)
    result["library_ms"] = None if library is None else time_ms(library(args))
    for key, make_call in (extra or {}).items():
        result[key] = time_ms(make_call(args))
    b, ops = cost(args, outs)
    result["bound_ms"], result["bound_by"] = bound(b, ops)
    result["bytes"], result["flops"] = b, ops
    others = "".join(f", {key} {result[key]:.4f}" for key in extra or {})
    lib = "none" if library is None else f"{result['library_ms']:.4f} ms"
    log(f"{name} bf16: kernel {result['ms']:.4f} ms (host clock {result['host_ms']:.4f}), plain {result['plain_ms']:.4f} ms, "
        f"library {lib}{others}, bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}: {b / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
    torch.cuda.empty_cache()
    return result


class IndexReplay:
    """Record the depth-index maps an ordered head quantises on the card
    (the flagship's ``_quantize_logit``, or ``attr`` of ``module``, the
    function that head calls), and hand the same maps to a later run (on
    the CPU, or on the card along another path), counting where that run's
    own maps differ (a bucket rounded the other way)."""

    def __init__(self, module=None, attr: str = "_quantize_logit"):
        if module is None:
            import mde_tpu_torch.models.oda2.red_order_swin2 as module
        self.module, self.attr, self.real = module, attr, getattr(module, attr)
        self.card, self.flips = [], []

    def record(self):
        def quantize(logit, num_emb):
            self.card.append(self.real(logit, num_emb))
            return self.card[-1]
        setattr(self.module, self.attr, quantize)

    def replay(self):
        maps = iter(list(self.card))

        def quantize(logit, num_emb):
            own, card = self.real(logit, num_emb), next(maps).to(logit.device)
            self.flips.append(int((own != card).sum()))
            return card
        setattr(self.module, self.attr, quantize)

    def restore(self):
        setattr(self.module, self.attr, self.real)


def sibling_replay() -> IndexReplay:
    """The index replay of a sibling's quantising head (the reg and gen-1
    heads share their loop, in ``red_order_reg``; the others quantise
    nothing and replay no map)."""
    import mde_tpu_torch.models.oda2.red_order_reg as reg
    return IndexReplay(reg, "_logit_to_indices")


def fuse_ffs(model) -> int:
    """Set every DWConv-GLU FF of ``model`` to the fused path (K4); return
    how many."""
    from mde_tpu_torch.ops.mlp import PreNormDWConvFF
    ffs = [m for m in model.modules() if isinstance(m, PreNormDWConvFF)]
    for m in ffs:
        m.ff_impl = "fused"
    return len(ffs)


def perturb_ff_bns(model, seed: int) -> None:
    """Seeded running statistics, scale and shift for the BatchNorm of every
    DWConv-GLU FF of ``model``. A fresh model's are 0, 1, 1, 0, where the
    fused path's fold (s = weight / sqrt(var + eps), t = bias - mean * s)
    is the same arithmetic as the unfused BatchNorm's whatever its faults."""
    from mde_tpu_torch.ops.mlp import PreNormDWConvFF
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, PreNormDWConvFF):
            c = m.bn2.num_features
            values = {"running_mean": 0.2 * rng.randn(c), "running_var": rng.uniform(0.5, 2.0, c),
                      "weight": rng.uniform(0.5, 1.5, c), "bias": 0.2 * rng.randn(c)}
            with torch.no_grad():
                for name, value in values.items():
                    getattr(m.bn2, name).copy_(torch.from_numpy(value.astype(np.float32)))


def model_f32_check(dev) -> None:
    """Full-width f32 forward at batch 1 on 224x448 (not resized; the CPU
    forward took 25 s at 352x704), the FFs' BatchNorms given seeded
    statistics: the card's default forward against the card's forward with
    the six FFs fused (K4), and against the CPU."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 224, 448, 3).astype(np.float32))
    replay = IndexReplay()
    try:
        replay.record()
        model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, use_checkpoint=False)
        perturb_ff_bns(model, 7)
        with torch.no_grad():
            out, outs = model(x.to(dev))
        torch.cuda.synchronize()
        gpu_outs = [o.cpu() for o in outs]
        if fuse_ffs(model) != 6:
            raise RuntimeError("the flagship should hold six DWConv-GLU FFs")
        replay.replay()
        kernels.reset_launch_counts()
        with torch.no_grad():
            _, fused_outs = model(x.to(dev))
        torch.cuda.synchronize()
        fused = dict(dict.fromkeys(kernels.KERNELS, 0), **FUSED_SERVE_LAUNCHES)
        if kernels.launch_counts != fused:
            raise RuntimeError(f"fused forward: expected {fused} launches, got "
                               f"{kernels.launch_counts}")
        fused_errs = [(a.cpu() - b).abs().max().item() for a, b in zip(fused_outs, gpu_outs)]
        log(f"flagship f32 batch 1 at 224x448 on the card, seeded FF BatchNorms, fused FFs "
            f"(K4) vs default: max_abs_err per map {fused_errs} m (tolerance "
            f"{MODEL_F32_TOL}); index flips per repeat {replay.flips} (the fused run was fed "
            f"the default run's indices)")
        if len(fused_errs) != FLAGSHIP["num_repeats"] + 1 or max(fused_errs) > MODEL_F32_TOL:
            raise RuntimeError("flagship f32 forward with fused FFs disagrees with the default")
        del model, out, outs, fused_outs
        cpu_model = build_model(FLAGSHIP, 0.001, 80.0, device="cpu", seed=0,
                                use_checkpoint=False)
        perturb_ff_bns(cpu_model, 7)
        replay.flips = []
        replay.replay()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, ref_outs = cpu_model(x)
        log(f"flagship f32 CPU forward (plain versions): {time.perf_counter() - t0:.1f} s")
    finally:
        replay.restore()
    errs = [(a - b).abs().max().item() for a, b in zip(gpu_outs, ref_outs)]
    log(f"flagship f32 batch 1 at 224x448, card vs CPU: max_abs_err per map {errs} m "
        f"(tolerance {MODEL_F32_TOL}); index flips per repeat {replay.flips} of "
        f"{replay.card[0].numel()} (the CPU run was fed the card's indices)")
    if len(errs) != FLAGSHIP["num_repeats"] + 1 or max(errs) > MODEL_F32_TOL:
        raise RuntimeError("flagship f32 forward on the card disagrees with the CPU")


def luna_family_opt(name: str) -> dict:
    """The train config of an ODA or Depthformer v6-v8 model: the flagship's,
    and the chamfer loss at 0.1 where the model returns bins."""
    opt = dict(TRAIN_OPT, model={**LUNA_FAMILY, **ODA_LAST}[name][0])
    if name in LUNA_CHAMFER:
        opt["loss"] = dict(opt["loss"], chamfer_weight=0.1)
    return opt


def sized(name: str, hw: tuple) -> dict:
    """Build overrides for inputs of ``hw``: ``oda_lion``'s position
    embedding takes the 1/32 grid of the size it is built for."""
    return {"img_size": hw} if name == "oda_lion" else {}


def luna_family_f32_check(dev, name: str, seed: int) -> dict:
    """An ODA (``LUNA_FAMILY``, ``ODA_LAST``) or Depthformer v6-v8 model's
    full-width f32 forward at batch 1 (the ODA models at 384x384, their
    Swin-L encoder at depths ``SHALLOW``, K1 8; v6-v8 at 352x704): the card
    against the CPU, the depth map and the bin centers or edges in metres,
    the aux tokens at WEIGHTS_TOL of their size, the attention weights as
    probabilities. Returns the card's launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    cfg, hw, serving, _, rest_count = {**LUNA_FAMILY, **ODA_LAST}[name]
    # the ODA models (those that run K1) at cut depth, as the other f32 checks
    shallow = {"encoder_kwargs": SHALLOW} if serving else {}
    expect = ODA_F32_LAUNCHES if serving else {}
    scale = DEPTH_SCALE.get(name, 2)
    x = torch.from_numpy(np.random.RandomState(seed).rand(1, *hw, 3).astype(np.float32))
    outs = []
    # one build, moved to the card and back: build_model draws the weights
    # on the CPU whatever the device
    model = build_model(cfg, 0.001, 80.0, device="cpu", seed=0, **sized(name, hw), **shallow)
    for device in (dev, torch.device("cpu")):
        model.to(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            depth, rest = split_outputs(model(x.to(device)))
        if device.type == "cuda":
            torch.cuda.synchronize()
            counts = dict(kernels.launch_counts)
        else:
            log(f"{name} f32 CPU forward (plain versions): {time.perf_counter() - t0:.1f} s")
        outs.append((depth.cpu(), [t.cpu() for t in rest]))
        del depth, rest
        free_garbage()
    del model
    (depth, rest), (ref, ref_rest) = outs
    err = (depth - ref).abs().max().item()
    errs, tols = [], []
    for a, b in zip(rest, ref_rest):
        errs.append((a - b).abs().max().item())
        tols.append(MODEL_F32_TOL if b.dim() == 2 else WEIGHTS_TOL if b.dim() == 4
                    else WEIGHTS_TOL * max(1.0, b.abs().max().item()))
    log(f"{name} f32 batch 1 at {hw[0]}x{hw[1]}, card vs CPU: launches {counts}; depth "
        f"{tuple(depth.shape)} in [{ref.min().item():.3f}, {ref.max().item():.3f}] m, "
        f"max_abs_err {err:.3e} m (tolerance {MODEL_F32_TOL}); then "
        f"{[tuple(t.shape) for t in rest]} max_abs_err {[f'{e:.2e}' for e in errs]} "
        f"(tolerances: bins in m {MODEL_F32_TOL}, aux tokens {WEIGHTS_TOL} of their size, "
        f"weights {WEIGHTS_TOL})")
    if (tuple(depth.shape) != (1, hw[0] // scale, hw[1] // scale, 1) or err > MODEL_F32_TOL
            or counts != dict(dict.fromkeys(kernels.KERNELS, 0), **expect)
            or len(rest) != rest_count
            or [t.shape for t in rest] != [t.shape for t in ref_rest]
            or not all(torch.isfinite(t).all() for t in [depth] + rest)
            or any(e > tol for e, tol in zip(errs, tols))):
        raise RuntimeError(f"{name} f32 forward on the card disagrees with the CPU")
    return counts


@contextlib.contextmanager
def loss_inputs():
    """While active, every ``DepthLoss`` a train step builds appends (the
    shapes of the maps it took, of the bin centers or None) to the yielded
    list at each call."""
    import mde_tpu_torch.train.step as step_module
    seen, real = [], step_module.DepthLoss

    class Record(real):
        def __call__(self, outputs, gt, bin_centers=None):
            seen.append(([tuple(m.shape) for m in outputs], None if bin_centers is None
                         else tuple(bin_centers.shape)))
            return super().__call__(outputs, gt, bin_centers)

    step_module.DepthLoss = Record
    try:
        yield seen
    finally:
        step_module.DepthLoss = real


def oda_train_f32_check(dev, seed: int) -> None:
    """``oda_luna_cls``'s full-width f32 train step at batch 2 on 384x384
    (chamfer 0.1, batch statistics, dropout and stochastic depth off): the
    card, whose encoder runs K1's f32 forward and backward at 144 tokens,
    against the CPU. The loss must take the depth map and the bin centers."""
    from mde_tpu_torch.ops import kernels
    name = "oda_luna_cls"
    batch = train_batch(2, seed, hw=(384, 384))
    tag = f"{name} f32 train step batch 2 at 384x384 (chamfer 0.1)"
    kw = dict(drop_prob=0.0, encoder_kwargs={"drop_prob": 0.0, "path_drop_prob": 0.0})
    with loss_inputs() as seen:
        kernels.reset_launch_counts()
        card = one_train_step(dev, batch, luna_family_opt(name), **kw)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        free_garbage()
        t0 = time.perf_counter()
        cpu = one_train_step("cpu", batch, luna_family_opt(name), **kw)
        log(f"{tag}: card launches {counts}; CPU step (plain versions) "
            f"{time.perf_counter() - t0:.1f} s; the loss took maps {seen[0][0]} and bin "
            f"centers {seen[0][1]}")
    want = ([(2, 192, 192, 1)], (2, 256))
    if (seen != [want, want] or not card[0]["loss_chamfer"] > 0
            or counts != dict(dict.fromkeys(kernels.KERNELS, 0), **ODA_TRAIN_LAUNCHES,
                              **OPTIMIZER_LAUNCHES)):
        raise RuntimeError(f"{tag}: the loss took {seen}, expected {want} on both devices; "
                           f"launches {counts}")
    compare_steps(tag, card, cpu)


def luna_family_runs(dev, models: dict, seed: int) -> dict:
    """Every phase of ``models`` (``LUNA_FAMILY`` or ``ODA_LAST``): the f32
    forward card vs CPU, bf16 serving at batch 8 and the bf16 train step at
    batch 4 at 352x704 (each counted, timed, with peak memory and a
    profile; the maps each step's loss took are checked: the depth map,
    whatever else the model returns). Returns {name: {path: launches}}."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    runs = {}
    hw = (352, 704)
    for i, (name, (cfg, _, serving, training, _)) in enumerate(models.items()):
        with timed(f"{name} f32 forward"):
            runs[name] = {"f32_forward": luna_family_f32_check(dev, name, seed + i)}
        resized = " (resized to 384x768)" if name.startswith("oda") else ""
        with timed(f"{name} serving"):
            model = build_model(cfg, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16,
                                **sized(name, hw))
            images = torch.from_numpy(np.random.RandomState(seed + 10 + i).rand(
                BATCH, *hw, 3).astype(np.float32)).to(dev)
            _, runs[name]["serving"] = serve_run(f"{name} bf16 batch {BATCH}{resized}",
                                                 Predictor(model), images, serving)
            del model, images
            free_garbage()
        tag = f"{name} bf16 train step batch {TRAIN_BATCH}{resized}"
        with timed(f"{name} train step"), loss_inputs() as seen:
            runs[name]["train_step"], _, _ = train_run(tag, luna_family_opt(name), dev, training,
                                                    warmup=2, timed=3, profile=True,
                                                    **sized(name, hw))
        free_garbage()
        rh, rw = (384, 768) if name.startswith("oda") else hw
        scale = DEPTH_SCALE.get(name, 2)
        maps = [(TRAIN_BATCH, rh // scale, rw // scale, 1)]
        log(f"{tag}: the loss took maps {seen[0][0]} and bin centers {seen[0][1]} in each of "
            f"{len(seen)} steps")
        if any(s[0] != maps for s in seen) or len({repr(s) for s in seen}) != 1:
            raise RuntimeError(f"{tag}: the loss took {seen}, expected the maps {maps}")
    return runs


def serve_run(tag, predictor, images, expect, entries=None) -> tuple:
    """One counted ``predict`` (every launch count from 0, then exactly
    ``expect``, every other kernel 0, and exactly ``entries`` of them
    through second entries, none by default), its peak memory, 5 timed
    calls and a profile. Returns (img/s, the counted launches)."""
    from mde_tpu_torch.ops import kernels
    predictor.predict(images)  # warm-up
    torch.cuda.synchronize()
    free_garbage()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    pred = predictor.predict(images)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    log(f"{tag} serving launches: {counts}, through second entries "
        f"{kernels.entry_counts}")
    expect = dict(dict.fromkeys(kernels.KERNELS, 0), **expect)
    if counts != expect or kernels.entry_counts != (entries or {}):
        raise RuntimeError(f"{tag}: expected {expect} kernel launches per forward ("
                           f"{entries or {}} through second entries), got {counts} "
                           f"({kernels.entry_counts})")
    b, h, w = images.shape[:3]
    if pred.shape != (b, h, w, 1) or not torch.isfinite(pred).all() or pred.min() < 0:
        raise RuntimeError(f"{tag}: bad prediction {tuple(pred.shape)}")
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor.predict(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = b / float(np.median(times))
    log(f"{tag} at {h}x{w}: {rate:.2f} img/s (median of {len(times)} calls, "
        f"{[round(t * 1e3, 2) for t in times]} ms), peak memory {peak / 2 ** 30:.2f} GiB, "
        f"depth range [{pred.min().item():.3f}, {pred.max().item():.3f}] m")
    profile_call(lambda: predictor.predict(images))
    return rate, counts


def model_bf16_run(dev, card: str) -> dict:
    """Full-width bf16 serving at batch 8: the default FFs, with the
    forward's FLOPs a second (``utils/flops``); the same model exported and
    loaded again (``export_round_trip``) and with ``return_weights``
    (``weights_serve_run``); then the six FFs fused (K4), each counted,
    timed and profiled. Returns the fused run's launch counts."""
    from mde_tpu_torch.utils.flops import flagship_forward_flops
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16,
                        use_checkpoint=False)
    predictor = Predictor(model)
    images = torch.from_numpy(
        np.random.RandomState(1).rand(BATCH, 352, 704, 3).astype(np.float32)).to(dev)
    default, _ = serve_run(f"flagship bf16 batch {BATCH} (resized to 448x896)", predictor,
                           images, dict(window_attention=24, ordered_attention=6,
                                        depthwise_conv2d=6))
    flops = flagship_forward_flops(352, 704)
    log(f"flagship forward: {flops / 1e12:.4f} TFLOP an image (utils/flops, 352x704 resized to "
        f"448x896): {flops * default / 1e12:.2f} TFLOP/s at {default:.2f} img/s ({card})")
    with timed("flagship export round trip"):
        export_round_trip(dev, model, images, card)
    with torch.no_grad():
        plain_out = model(images)[0]
    with timed("flagship return_weights serving"):
        weights_serve_run(dev, model, images, plain_out)
    del plain_out
    free_garbage()
    fuse_ffs(model)
    fused, counts = serve_run(f"flagship bf16 batch {BATCH} with fused FFs (K4)", predictor,
                              images, FUSED_SERVE_LAUNCHES)
    log(f"flagship bf16 batch {BATCH} serving: fused FFs {fused:.2f} img/s against the default "
        f"{default:.2f} img/s in this run; {flops * fused / 1e12:.2f} TFLOP/s fused")
    return counts


def train_batch(size: int, seed: int, hw=(352, 704), max_depth: float = 80.0) -> dict:
    """Images and depths in [0.5, 0.75 max_depth) m, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(size, *hw, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 0.75 * max_depth, (size, *hw, 1)).astype(np.float32)}


def one_train_step(dev, batch: dict, opt=TRAIN_OPT, freeze_bn: bool = False,
                   max_depth: float = 80.0, prepare=None, make_step=None, seed=None,
                   **overrides):
    """One train step of a fresh model of ``opt`` (seed 0), ``prepare``d
    (a callable given the model) where given, by ``make_step`` (default
    ``make_train_step``), its stochastic depth drawn from a generator of
    ``seed`` where given: (logs, gradients, state dict), all on the CPU."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step
    make_step = make_step or make_train_step
    generator = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
    model = build_model(opt["model"], 0.001, max_depth, device=dev, seed=0, **overrides)
    if prepare is not None:
        prepare(model)
    state = TrainState.create(model, opt, TRAIN_TOTAL_STEPS)
    grads = {}
    update = state.optimizer.update

    def keep(g):
        grads.update({n: t.detach().cpu() for n, t in g.items()})
        update(g)

    state.optimizer.update = keep
    _, logs = make_step(opt, 0.001, max_depth, freeze_bn=freeze_bn)(state, batch, generator)
    return ({k: float(v) for k, v in logs.items()}, grads,
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def train_f32_check(dev) -> None:
    """Full-width f32 train step at batch 1 on 224x448 (a quarter of the
    pixels of 448x896, the encoder depth SHALLOW and one repeat of the head,
    ``ONE_REPEAT``, keep the CPU step short): the card against the CPU."""
    batch = train_batch(1, 2, hw=(224, 448))
    opt = dict(TRAIN_OPT, model=dict(FLAGSHIP, **ONE_REPEAT))
    replay = IndexReplay()
    try:
        replay.record()
        kw = dict(path_drop_prob=0.0, use_checkpoint=False, encoder_kwargs=SHALLOW)
        card = one_train_step(dev, batch, opt, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        replay.replay()
        t0 = time.perf_counter()
        cpu = one_train_step("cpu", batch, opt, **kw)
        log(f"flagship f32 CPU train step (plain versions): {time.perf_counter() - t0:.1f} s")
    finally:
        replay.restore()
    log(f"flagship f32 train step batch 1 at 224x448: index flips per repeat {replay.flips} "
        f"(the CPU run was fed the card's indices)")
    compare_steps("flagship f32 train step batch 1 at 224x448", card, cpu)


def compare_steps(tag, card, cpu, labels=("card", "CPU")) -> None:
    """Hold one train step on the card against the same step on the CPU
    (or, as ``labels`` name them, one step against another)."""
    (logs, grads, weights), (ref_logs, ref_grads, ref_weights) = card, cpu
    log(f"{tag}: {labels[0]} {logs}, {labels[1]} {ref_logs}")
    bad = [k for k in ("loss", "loss_si", "grad_norm", "param_norm")
           if abs(logs[k] - ref_logs[k]) > STEP_LOG_TOL * max(1.0, abs(ref_logs[k]))]
    floor = 1e-2 * max(g.abs().max().item() for g in ref_grads.values())
    grad_errs = sorted(((grads[n] - g).abs().max().item() / max(g.abs().max().item(), floor), n)
                       for n, g in ref_grads.items())
    stat_errs, param_errs = [], []
    for name, value in ref_weights.items():
        if not value.is_floating_point():
            continue
        diff = (weights[name] - value).abs().max().item()
        if "running" in name:
            stat_errs.append((diff / max(1.0, value.abs().max().item()), name))
        else:
            param_errs.append((diff, name))
    stat_errs.sort()
    param_errs.sort()
    log(f"  worst gradient errors (relative to the tensor's max |g|, floor {floor:.3e}): "
        f"{grad_errs[-3:]} (tolerance {STEP_GRAD_TOL})")
    log(f"  worst BatchNorm statistics errors: {stat_errs[-2:]} (tolerance {STEP_STATS_TOL})")
    log(f"  worst parameter errors after AdamW: {param_errs[-2:]} (tolerance "
        f"{STEP_PARAM_TOL:.2e})")
    if (bad or len(grads) != len(ref_grads) or grad_errs[-1][0] > STEP_GRAD_TOL
            or stat_errs[-1][0] > STEP_STATS_TOL or param_errs[-1][0] > STEP_PARAM_TOL):
        raise RuntimeError(f"{tag}: the {labels[0]} step disagrees with the {labels[1]} one "
                           f"(logs {bad})")


def optimizer_launches(model) -> dict:
    """The fused AdamW's launches a step over ``model``'s parameters: 3 up to
    640 tensors, two more a window of 640 past them (depthformer_v6-v8 and
    oda_lime: 5)."""
    from mde_tpu_torch.ops.kernels.adamw import launches
    return {"adamw": launches(len(dict(model.named_parameters())))}


def train_run(tag, opt, dev, expect, warmup, timed, profile, entries=None, hw=(352, 704),
              max_depth: float = 80.0, make_step=None, **overrides) -> tuple:
    """Full-width bf16 train steps at batch 4 of a fresh model of ``opt``
    by ``make_step`` (default ``make_train_step``): one counted step (every
    launch count from 0, then exactly ``expect``, every other kernel 0, and
    ``entries`` of them through second entries, none by default; finite
    logs, moved parameters), more warm-up steps up to ``warmup``, ``timed``
    timed steps, peak memory and, with ``profile``, one profiled step.
    Returns (the counted launches, img/s, peak bytes)."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(TRAIN_BATCH, 3, hw, max_depth).items()}
    step = (make_step or make_train_step)(opt, 0.001, max_depth)
    generator = torch.Generator(device=dev).manual_seed(0)
    model = build_model(opt["model"], 0.001, max_depth, device=dev, seed=0,
                        dtype=torch.bfloat16, **overrides)
    state = TrainState.create(model, opt, TRAIN_TOTAL_STEPS)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    free_garbage()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _, logs = step(state, batch, generator)
    torch.cuda.synchronize()
    run = dict(kernels.launch_counts)
    log(f"{tag} launches: {run}, through second entries {kernels.entry_counts}")
    expect = dict(dict.fromkeys(kernels.KERNELS, 0), **expect, **optimizer_launches(model))
    if run != expect or kernels.entry_counts != (entries or {}):
        raise RuntimeError(f"{tag}: expected {expect} kernel launches per train step "
                           f"({entries or {}} through second entries), got {run} "
                           f"({kernels.entry_counts})")
    logs = {k: float(v) for k, v in logs.items()}
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())
    log(f"  logs of the first step: {logs}; {moved} of {len(before)} parameters moved")
    if not all(np.isfinite(v) for v in logs.values()) or moved == 0:
        raise RuntimeError(f"{tag}: bad train step: logs {logs}, {moved} parameters moved")
    del before
    times = []
    for _ in range(warmup - 1 + timed):
        t0 = time.perf_counter()
        _, logs = step(state, batch, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times = times[warmup - 1:]
    peak = torch.cuda.max_memory_allocated()
    rate = TRAIN_BATCH / float(np.median(times))
    log(f"{tag} at {hw[0]}x{hw[1]}: {rate:.2f} img/s (median of "
        f"{len(times)} steps after {warmup} warm-up, {[round(t * 1e3, 2) for t in times]} ms), "
        f"peak memory {peak / 2 ** 30:.2f} GiB, loss {float(logs['loss']):.4f}")
    if profile:
        profile_call(lambda: step(state, batch, generator))
    del state, model
    torch.cuda.empty_cache()
    return run, rate, peak


def train_bf16_run(dev) -> tuple:
    """The flagship's bf16 train step at batch 4 without recompute.
    Returns its counted launches, img/s and peak bytes."""
    return train_run(f"flagship bf16 train step batch {TRAIN_BATCH} (resized to 448x896, "
                     f"use_checkpoint=False)", TRAIN_OPT, dev, TRAIN_LAUNCHES, warmup=3,
                     timed=5, profile=True, use_checkpoint=False)


@contextlib.contextmanager
def remat_policy(name: str):
    """``MDE_REMAT_POLICY`` set to ``name`` for the block, as it was after."""
    old = os.environ.get("MDE_REMAT_POLICY")
    os.environ["MDE_REMAT_POLICY"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["MDE_REMAT_POLICY"]
        else:
            os.environ["MDE_REMAT_POLICY"] = old


def remat_runs(dev, card: str, plain: tuple) -> dict:
    """The flagship's recomputing bf16 train step at batch 4 under each
    ``MDE_REMAT_POLICY``: exact launches (``REMAT_LAUNCHES``), img/s (median
    of 5 after 2 warm-up steps), peak memory and one profiled step, beside
    ``plain``, the step without recompute. Then in f32 at the check size of ``train_f32_check``
    (batch 1 at 224x448, ``SHALLOW``, ``ONE_REPEAT``, stochastic depth 0.2
    from one seeded generator), each policy's step on the card against the
    step without recompute on the card. Returns {policy: (launches, img/s,
    peak bytes)}."""
    runs = {}
    for policy in REMAT_POLICIES:
        with remat_policy(policy):
            runs[policy] = train_run(
                f"flagship bf16 train step batch {TRAIN_BATCH} (resized to 448x896, "
                f"use_checkpoint=True, MDE_REMAT_POLICY={policy})", TRAIN_OPT, dev,
                REMAT_LAUNCHES[policy], warmup=2, timed=5, profile=True, use_checkpoint=True)
        free_garbage()
    for name, (_, rate, peak) in [("none", plain)] + list(runs.items()):
        log(f"recompute {name}: flagship bf16 train step batch {TRAIN_BATCH} {rate:.2f} img/s, "
            f"peak memory {peak / 2 ** 30:.2f} GiB ({card})")
    batch = train_batch(1, 2, hw=(224, 448))
    opt = dict(TRAIN_OPT, model=dict(FLAGSHIP, **ONE_REPEAT))
    ref = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, use_checkpoint=False, seed=7)
    for policy in REMAT_POLICIES:
        with remat_policy(policy):
            step = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, use_checkpoint=True,
                                  seed=7)
        compare_steps(f"flagship f32 train step batch 1 at 224x448, MDE_REMAT_POLICY={policy} "
                      f"against no recompute (both on the card)", step, ref,
                      ("recomputing", "plain"))
    return runs


def gspmd_all_reduces(model, num_accum: int = 1) -> int:
    """The all-reduces of one ``make_train_step_gspmd`` step of the
    flagship ``model``, derived from the code: in each microbatch every
    BatchNorm sums its statistics over the ranks in the forward and their
    gradients in the backward, and those of a recomputed block (the
    ordered head's repeats, with ``use_checkpoint``) sum them again in its
    replay; the loss's SILog term of each map (the head's repeats and its
    last map, per image) sums in the forward and the backward; then one
    all-reduce averages the (f32) gradients."""
    from mde_tpu_torch.models.oda2.red_order_swin2 import OrderedSwinRegHead
    from mde_tpu_torch.ops.tnn import BatchNorm
    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    heads = [m for m in model.modules() if isinstance(m, OrderedSwinRegHead)]
    replayed = sum(isinstance(m, BatchNorm) for h in heads if h.use_checkpoint
                   for m in h.attn_layers.modules())
    maps = sum(len(h.attn_layers) + 1 for h in heads)
    return num_accum * (2 * norms + replayed + 2 * maps) + 1


def gspmd_turns(dev, mesh, card: str) -> dict:
    """The flagship's bf16 recomputing train step at batch 4 (352x704
    resized to 448x896, ``MDE_REMAT_POLICY`` the default) by
    ``make_train_step`` and by ``make_train_step_gspmd`` on the one rank
    of ``mesh``, one model and state: a counted step of each (K1-K3
    launches exactly ``CHECKPOINT_LAUNCHES``, the gspmd step's all-reduces
    exactly ``gspmd_all_reduces``, none for the plain step; peak memory),
    then img/s in turns (plain, gspmd, gspmd, plain; 2 timed steps after a
    warm-up each, host clock), then one profiled gspmd step: busy ms, idle
    share and NCCL's kernels (the plain step's profile is the recompute
    phase's under ``save_sa_conv``). Returns the gspmd step's launches."""
    from mde_tpu_torch.core import dist
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step, make_train_step_gspmd
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(TRAIN_BATCH, 3).items()}
    model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
    state = TrainState.create(model, TRAIN_OPT, TRAIN_TOTAL_STEPS)
    generator = torch.Generator(device=dev).manual_seed(0)
    steps = {"make_train_step": make_train_step(TRAIN_OPT, 0.001, 80.0),
             "gspmd": make_train_step_gspmd(TRAIN_OPT, 0.001, 80.0, mesh)}
    derived = gspmd_all_reduces(model)
    tag = f"flagship bf16 train step batch {TRAIN_BATCH} (resized to 448x896, use_checkpoint)"
    counts, peaks = {}, {}
    for name, step in steps.items():
        torch.cuda.synchronize()
        free_garbage()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dist.reset_collective_counts()
        _, logs = step(state, batch, generator)
        torch.cuda.synchronize()
        counts[name] = dict(kernels.launch_counts)
        reduces = dist.collective_counts["all_reduce"]
        peaks[name] = torch.cuda.max_memory_allocated()
        logs = {k: float(v) for k, v in logs.items()}
        log(f"data parallel: {tag} by {name}: launches {counts[name]}, all-reduces {reduces} "
            f"(derived {derived if name == 'gspmd' else 0}), peak memory "
            f"{peaks[name] / 2 ** 30:.2f} GiB, logs {logs}")
        expect = dict(dict.fromkeys(kernels.KERNELS, 0), **CHECKPOINT_LAUNCHES,
                      **OPTIMIZER_LAUNCHES)
        if (counts[name] != expect or kernels.entry_counts
                or reduces != (derived if name == "gspmd" else 0)
                or not all(np.isfinite(v) for v in logs.values())):
            raise RuntimeError(f"{tag} by {name}: expected {expect} launches and "
                               f"{derived if name == 'gspmd' else 0} all-reduces, got "
                               f"{counts[name]} ({kernels.entry_counts}) and {reduces}; "
                               f"logs {logs}")
    times = {name: [] for name in steps}
    for name in ("make_train_step", "gspmd", "gspmd", "make_train_step"):
        for i in range(3):
            t0 = time.perf_counter()
            steps[name](state, batch, generator)
            torch.cuda.synchronize()
            if i:
                times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        log(f"data parallel: {tag} by {name} in turns: "
            f"{TRAIN_BATCH / float(np.median(ts)):.2f} img/s (median of {len(ts)} steps, "
            f"{[round(t * 1e3, 2) for t in ts]} ms) ({card})")
    busy, wall, rows = profile_call(lambda: steps["gspmd"](state, batch, generator))
    nccl = [(ms, n) for ms, n, key in rows if "nccl" in key.lower()]
    log(f"data parallel: {tag} by gspmd: device busy {busy:.2f} ms of {wall:.2f} ms, NCCL "
        f"kernels {sum(ms for ms, _ in nccl):.3f} ms in {sum(n for _, n in nccl)} ({card})")
    del state, model
    free_garbage()
    return counts["gspmd"]


def gloo_rank(rank: int, root: str, batch: dict, opt: dict, tp_batch: dict,
              tp_opt: dict) -> None:
    """Rank ``rank`` of a two-rank gloo group on the one card (a
    ``FileStore`` in ``root``): the f32 ``make_train_step_gspmd`` step of
    ``one_train_step`` (weights from seed 0 on both ranks, stochastic depth
    from a generator of seed 13) on the whole ``batch``, saved to
    ``root/rank{rank}.pt``; then, on the (data=1, model=2) grid of the same
    two ranks, the tensor-parallel steps of ``tp_steps`` on ``tp_batch``,
    saved to ``root/tp_rank{rank}.pt``."""
    import torch.distributed as tdist
    from mde_tpu_torch.parallel.mesh import make_mesh
    from mde_tpu_torch.train.step import make_train_step_gspmd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tdist.init_process_group("gloo", store=tdist.FileStore(os.path.join(root, "store"), 2),
                             rank=rank, world_size=2)
    try:
        mesh = make_mesh(torch.device("cuda"))
        out = one_train_step(mesh.device, batch, opt, encoder_kwargs=SHALLOW, seed=13,
                             make_step=lambda o, lo, hi, **kw: make_train_step_gspmd(
                                 o, lo, hi, mesh, **kw))
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        del out
        free_garbage()
        torch.save(tp_steps(tp_batch, tp_opt), os.path.join(root, f"tp_rank{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def gloo_pair_run(dev, card: str, timeout: float = 300.0) -> None:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), spawned once for two phases. The data-parallel one: the f32
    gspmd step at the check size (batch 2 at 224x448, one image a rank,
    ``SHALLOW``, ``ONE_REPEAT``, stochastic depth 0.2, dropout 0.1) on
    each, against one process's ``make_train_step`` on the whole batch from
    the same weights and generator; the ranks' states the same. Then the
    tensor-parallel one (``tp_steps``, ``tp_check``)."""
    import torch.multiprocessing as mp
    batch = train_batch(2, 5, hw=(224, 448))
    opt = dict(TRAIN_OPT, model=dict(FLAGSHIP, **ONE_REPEAT, drop_prob=0.1))
    ref = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, seed=13)
    tp_batch, tp_opt, tp_refs = tp_references(dev)
    with tempfile.TemporaryDirectory() as root:
        ctx = mp.start_processes(gloo_rank, args=(root, batch, opt, tp_batch, tp_opt),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.perf_counter() + timeout
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join(10)
                raise RuntimeError(f"the gloo ranks were still running after {timeout} s")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(2)]
        tp_ranks = [torch.load(os.path.join(root, f"tp_rank{r}.pt")) for r in range(2)]
    for r, step in enumerate(ranks):
        compare_steps(f"flagship f32 train step batch 2 at 224x448: make_train_step_gspmd on "
                      f"gloo rank {r} of 2 on one card against make_train_step", step, ref,
                      ("gspmd", "make_train_step"))
    (logs0, _, weights0), (logs1, _, weights1) = ranks
    if logs0 != logs1 or not all(torch.equal(weights0[k], weights1[k]) for k in weights0):
        raise RuntimeError("the two gloo ranks ended with different states")
    log("data parallel: the two gloo ranks ended with the same logs and state")
    tp_check(tp_ranks, tp_refs, card)


def data_parallel_run(dev, card: str) -> dict:
    """A one-rank NCCL data group (``parallel.mesh.make_mesh`` with a
    ``FileStore`` in a temporary directory), destroyed before the script
    goes on: the flagship's f32 ``make_train_step_shard_map`` step at the
    check size (batch 1 at 224x448, ``SHALLOW``, ``ONE_REPEAT``, stochastic
    depth 0.2) against ``make_train_step`` from the same weights and
    generator; then the bf16 shard_map step at batch 4, recomputing under
    the default policy, with its launches exactly the plain step's
    (``CHECKPOINT_LAUNCHES``), and the time of ``all_reduce_tensors``
    (mean) over a gradient the flagship's size (every parameter's, f32) on
    one rank: the concatenation and division it adds, with no link crossed.
    Then ``make_train_step_gspmd``: in f32 at the check size with two
    microbatches of one image and dropout 0.1 on, against
    ``make_train_step``; and in bf16 (``gspmd_turns``); on two gloo ranks
    it runs in ``gloo_pair_run``. Returns the gspmd step's counted
    launches."""
    import torch.distributed as tdist
    from mde_tpu_torch.core import dist
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.parallel.mesh import make_mesh
    from mde_tpu_torch.train.step import (make_train_step, make_train_step_gspmd,
                                          make_train_step_shard_map)
    with tempfile.TemporaryDirectory() as root:
        mesh = make_mesh(dev, rank=0, world_size=1,
                         store=tdist.FileStore(os.path.join(root, "store"), 1))
        try:
            log(f"data parallel: a {tdist.get_backend()} group of {mesh.size} rank on {dev}")

            def shard_map(opt, lo, hi, **kw):
                return make_train_step_shard_map(opt, lo, hi, mesh, **kw)

            batch = train_batch(1, 2, hw=(224, 448))
            opt = dict(TRAIN_OPT, model=dict(FLAGSHIP, **ONE_REPEAT))
            ref = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, seed=9)
            step = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, seed=9,
                                  make_step=shard_map)
            compare_steps("flagship f32 train step batch 1 at 224x448: make_train_step_shard_map "
                          "on one NCCL rank against make_train_step", step, ref,
                          ("shard_map", "make_train_step"))
            counts, _, _ = train_run(
                f"flagship bf16 make_train_step_shard_map batch {TRAIN_BATCH} on one NCCL rank "
                f"(resized to 448x896, use_checkpoint=True)", TRAIN_OPT, dev,
                CHECKPOINT_LAUNCHES, warmup=1, timed=1, profile=False, make_step=shard_map,
                use_checkpoint=True)
            model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0)
            grads = [torch.ones_like(p) for p in model.parameters()]
            del model
            size = sum(g.numel() for g in grads)
            ms = time_ms(lambda: dist.all_reduce_tensors(grads, "mean"), iters=10)
            log(f"data parallel: all_reduce_tensors (mean) of {size} f32 values in "
                f"{len(grads)} tensors on one rank: {ms:.3f} ms of concatenation and "
                f"division, no link crossed, not a collective's rate ({card})")
            del grads

            def accum(make):
                return lambda o, lo, hi, **kw: make(o, lo, hi, num_accum=2, **kw)

            batch = train_batch(2, 2, hw=(224, 448))
            opt = dict(TRAIN_OPT, model=dict(FLAGSHIP, **ONE_REPEAT, drop_prob=0.1))
            ref = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, seed=11,
                                 make_step=accum(make_train_step))
            step = one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, seed=11,
                                  make_step=accum(lambda o, lo, hi, **kw: make_train_step_gspmd(
                                      o, lo, hi, mesh, **kw)))
            compare_steps("flagship f32 train step batch 2 at 224x448, 2 microbatches, dropout "
                          "0.1: make_train_step_gspmd on one NCCL rank against make_train_step",
                          step, ref, ("gspmd", "make_train_step"))
            with timed("gspmd bf16 step in turns"):
                counts = gspmd_turns(dev, mesh, card)
        finally:
            tdist.destroy_process_group()
        free_garbage()
    return counts


def ksa_f32_check(dev) -> None:
    """``oda2_ksa_reg``'s full-width f32 forward at batch 1: card against CPU."""
    from mde_tpu_torch.models import build_model
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 352, 704, 3).astype(np.float32))
    model = build_model(KSA, 0.001, 80.0, device=dev, seed=0)
    with torch.no_grad():
        out, _ = model(x.to(dev))
    torch.cuda.synchronize()
    out = out.cpu()
    del model
    torch.cuda.empty_cache()
    cpu_model = build_model(KSA, 0.001, 80.0, device="cpu", seed=0)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref, _ = cpu_model(x)
    log(f"oda2_ksa_reg f32 CPU forward (plain versions): {time.perf_counter() - t0:.1f} s")
    err = (out - ref).abs().max().item()
    log(f"oda2_ksa_reg f32 batch 1 at 352x704 (resized to 448x896), card vs CPU: output "
        f"{tuple(out.shape)}, max_abs_err {err:.3e} m (tolerance {MODEL_F32_TOL})")
    if out.shape != (1, 110, 222, 1) or not torch.isfinite(out).all() or err > MODEL_F32_TOL:
        raise RuntimeError("oda2_ksa_reg f32 forward on the card disagrees with the CPU")


def ksa_serve_run(dev) -> dict:
    """``oda2_ksa_reg``'s bf16 serving at batch 8, counted, timed and
    profiled. Returns the counted launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    model = build_model(KSA, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
    images = torch.from_numpy(
        np.random.RandomState(5).rand(BATCH, 352, 704, 3).astype(np.float32)).to(dev)
    _, counts = serve_run(f"oda2_ksa_reg bf16 batch {BATCH} (resized to 448x896)",
                          Predictor(model), images, KSA_SERVE_LAUNCHES)
    del model
    torch.cuda.empty_cache()
    return counts


def ppm_spread(dev, images) -> float:
    """How far the PPM's 1x1 pooled BatchNorm is from cancelling on
    ``images``: the median over channels of its input's std across the
    batch over its rms, from the card's f32 forward of a fresh model."""
    from mde_tpu_torch.models import build_model
    model = build_model(KSA, 0.001, 80.0, device=dev, seed=0)
    seen = []
    model.decoder.ppm32.conv_reduce_layers[0][1].register_forward_pre_hook(
        lambda module, args: seen.append(args[0].flatten(1)))
    with torch.no_grad():
        model(torch.from_numpy(images).to(dev))
    x = seen[0]
    return float((x.std(0) / x.pow(2).mean(0).sqrt()).median())


def ksa_train_f32_check(dev, size: int, freeze_bn: bool) -> None:
    """``oda2_ksa_reg``'s f32 train step, card against CPU, at full width on
    ``size`` images of 224x448 (a quarter of the pixels and the encoder
    depth SHALLOW keep the CPU step short), with batch statistics or with
    ``freeze_bn``.

    The PPM's 1x1 pooled BatchNorm normalises one value per image. At two
    images its output is +-1 whatever their spread. Random images of one
    distribution, darkened or not (the encoder's LayerNorms take out
    brightness), pool to nearly the same features, whose variance
    E[x^2] - E[x]^2 cancels in f32: the gradient into its 1x1 conv is then
    rounding noise that reaches the whole encoder. With batch statistics
    the check therefore gives the 4 images colour casts of their own, which
    the LayerNorms keep, and logs the pooled features' spread."""
    batch = train_batch(size, 6, hw=(224, 448))
    if not freeze_bn:
        batch["image"] *= np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
                                    [1.0, 1.0, 1.0]], np.float32)[:size, None, None]
    tag = (f"oda2_ksa_reg f32 train step batch {size} at 224x448 "
           f"({'freeze_bn' if freeze_bn else 'batch statistics, colour casts'})")
    log(f"{tag}: the 1x1 pooled BatchNorm's input, std across the batch over rms "
        f"(median over channels): {ppm_spread(dev, batch['image']):.4f}")
    kw = dict(freeze_bn=freeze_bn, path_drop_prob=0.0, encoder_kwargs=SHALLOW)
    card = one_train_step(dev, batch, KSA_TRAIN_OPT, **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = one_train_step("cpu", batch, KSA_TRAIN_OPT, **kw)
    log(f"{tag}: CPU step (plain versions, use_checkpoint=True) {time.perf_counter() - t0:.1f} s")
    compare_steps(tag, card, cpu)


def window_qk_v_phase(tag: str, bw: int, c: int, heads: int, windows: int, dev):
    """K1's q|k + separate-v entry at a NewCRFs CRF stage with the SW-MSA
    mask (``windows`` an image; CRF0_GRIDS gives the padded token grid)."""
    from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention,
                                                            window_attention_qk_v)
    from mde_tpu_torch.ops.window import shifted_window_attn_mask
    g = torch.Generator(device=dev).manual_seed(11)
    n = 49
    mask = shifted_window_attn_mask(*CRF0_GRIDS[windows], 7, 3, dev)
    bias = torch.randn(heads, n, n, generator=g, device=dev)

    def make(dtype):
        qk = torch.randn(bw, n, 2 * c, generator=g, device=dev).to(dtype)
        v = torch.randn(bw, n, c, generator=g, device=dev).to(dtype)
        return qk, v, bias, mask, heads, (c // heads) ** -0.5

    def plain(qk, v, *rest):
        return plain_window_attention(qk[..., :c], qk[..., c:], v, *rest)

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2)
                   for t in (*args[0].split(c, dim=-1), args[1]))
        add = window_mask(bias, mask, bw, q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=args[-1])

    def cost(args, outs):
        return nbytes(*args[:2], *outs), 4 * bw * n * n * c

    return kernel_phase("window_attention", f"K1 q|k+v {tag} ({bw},{n},{c})/{heads} masked",
                        window_attention_qk_v, plain, make, library, cost)


def window_qk_v_bwd_phase(tag: str, bw: int, c: int, heads: int, windows: int, dev):
    """K1 backward through the q|k + separate-v entry, as window_qk_v_phase."""
    from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention_bwd,
                                                            window_attention_qk_v_bwd)
    from mde_tpu_torch.ops.window import shifted_window_attn_mask
    g = torch.Generator(device=dev).manual_seed(12)
    n = 49
    mask = shifted_window_attn_mask(*CRF0_GRIDS[windows], 7, 3, dev)
    bias = torch.randn(heads, n, n, generator=g, device=dev)

    def make(dtype):
        qk = torch.randn(bw, n, 2 * c, generator=g, device=dev).to(dtype)
        v, dout = (torch.randn(bw, n, c, generator=g, device=dev).to(dtype) for _ in range(2))
        return qk, v, dout, bias, mask, heads, (c // heads) ** -0.5

    def plain(qk, v, dout, *rest):
        dq, dk, dv, dbias = plain_window_attention_bwd(qk[..., :c], qk[..., c:], v, dout, *rest)
        return torch.cat([dq, dk], dim=-1), dv, dbias

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2).detach()
                   .requires_grad_() for t in (*args[0].split(c, dim=-1), args[1]))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=window_mask(bias, mask, bw,
                                                                              q.dtype),
                                             scale=args[-1])
        grad = args[2].reshape(bw, n, heads, c // heads).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)

    def cost(args, outs):
        return nbytes(*args[:3], *outs), 10 * bw * n * n * c

    return kernel_phase("window_attention_bwd",
                        f"K1 bwd q|k+v {tag} ({bw},{n},{c})/{heads} masked",
                        window_attention_qk_v_bwd, plain, make, library, cost, relative=True)


# 12x12 windows (144 tokens) an image of each stage of the ODA encoder at
# 384x768 (the 384-multiple resize of KITTI's 352x704): token grids 96x192,
# 48x96, 24x48 and 12x24; stage 4 is one window high, so its blocks run
# unshifted (shift_collapse)
ODA_WINDOWS = {1: 128, 2: 32, 3: 8, 4: 2}


def oda_window_phase(stage: int, batch: int, c: int, heads: int, masked: bool, dev,
                     backward: bool = False, qk_v: bool = False):
    """K1 (``backward``: K1 bwd) at an ODA encoder stage: 144-token windows
    at head dim 32, through the fused qkv entry or (``qk_v``) the q|k +
    separate-v entry, with the SW-MSA mask where ``masked``; SDPA with bias
    + mask as one float mask (and its backward) is the yardstick."""
    from mde_tpu_torch.ops.kernels import window_attention as wa
    from mde_tpu_torch.ops.window import shifted_window_attn_mask
    g = torch.Generator(device=dev).manual_seed(13 + stage + 2 * backward + 4 * qk_v)
    r, windows = 12, ODA_WINDOWS[stage]
    n, bw, hd = r * r, windows * batch, c // heads
    k = math.isqrt(windows // 2)
    mask = shifted_window_attn_mask(r * k, 2 * r * k, r, r // 2, dev) if masked else None
    bias = torch.randn(heads, n, n, generator=g, device=dev)
    nin = 2 if qk_v else 1  # tensors that hold q, k, v

    def make(dtype):
        fused = torch.randn(bw, n, (2 if qk_v else 3) * c, generator=g, device=dev).to(dtype)
        ins = (fused, torch.randn(bw, n, c, generator=g, device=dev).to(dtype))[:nin]
        dout = (torch.randn(bw, n, c, generator=g, device=dev).to(dtype),) if backward else ()
        return (*ins, *dout, bias, mask, heads, hd ** -0.5)

    def split(args):
        return (*args[0].split(c, dim=-1), *args[1:nin])

    def plain(*args):
        q, k_, v = split(args)
        if not backward:
            return wa.plain_window_attention(q, k_, v, *args[nin:])
        dq, dk, dv, dbias = wa.plain_window_attention_bwd(q, k_, v, *args[nin:])
        return ((torch.cat([dq, dk], dim=-1), dv, dbias) if qk_v
                else (torch.cat([dq, dk, dv], dim=-1), dbias))

    def library(args):
        q, k_, v = (t.reshape(bw, n, heads, hd).transpose(1, 2).detach().requires_grad_(backward)
                    for t in split(args))
        add = window_mask(bias, mask, bw, q.dtype)
        if not backward:
            return lambda: F.scaled_dot_product_attention(q, k_, v, attn_mask=add,
                                                          scale=args[-1])
        out = F.scaled_dot_product_attention(q, k_, v, attn_mask=add, scale=args[-1])
        grad = args[nin].reshape(bw, n, heads, hd).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k_, v), grad, retain_graph=True)

    def cost(args, outs):
        return (nbytes(*args[:nin + backward], *outs),
                (10 if backward else 4) * bw * n * n * c)

    fn = {(False, False): wa.window_attention, (False, True): wa.window_attention_qk_v,
          (True, False): wa.window_attention_bwd, (True, True): wa.window_attention_qk_v_bwd}
    name = (f"K1{' bwd' if backward else ''}{' q|k+v' if qk_v else ''} ODA stage {stage} "
            f"({bw},{n},{c})/{heads}{' masked' if masked else ''}")
    return kernel_phase("window_attention_bwd" if backward else "window_attention", name,
                        fn[backward, qk_v], plain, make, library, cost, relative=backward)


def oda_window_phases(dev) -> dict:
    """K1's phases at the ODA encoder's 144-token windows: forward at stage
    1 (serving batch 8) masked and unmasked and at stage 4 (48 heads,
    collapsed: unmasked), backward at stage 1 (train batch 4) masked
    through both entries."""
    return {"window_attention": [oda_window_phase(1, BATCH, 192, 6, True, dev),
                                 oda_window_phase(1, BATCH, 192, 6, False, dev),
                                 oda_window_phase(4, BATCH, 1536, 48, False, dev)],
            "window_attention_bwd": [oda_window_phase(1, TRAIN_BATCH, 192, 6, True, dev,
                                                      backward=True),
                                     oda_window_phase(1, TRAIN_BATCH, 192, 6, True, dev,
                                                      backward=True, qk_v=True)]}


def crf_windows(h: int, w: int) -> tuple:
    """7x7 windows an image of each Swin block and each CRF block of NewCRFs
    at an h x w image (depths 2, 2, 18, 2; two CRF blocks a stage, crf3
    first): token grids at strides 4 to 32, padded to whole windows."""
    grids = []
    for _ in range(4):
        h, w = -(-h // (4 if not grids else 2)), -(-w // (4 if not grids else 2))
        grids.append(-(-h // 7) * -(-w // 7))
    return ([grids[0]] * 2 + [grids[1]] * 2 + [grids[2]] * 18 + [grids[3]] * 2,
            [grids[3]] * 2 + [grids[2]] * 2 + [grids[1]] * 2 + [grids[0]] * 2)


def newcrfs_f32_check(dev, hw) -> None:
    """NewCRFs large07's f32 forward of one ``hw`` image, the card against
    the CPU, with the windows each K1 entry sees checked."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.models.newcrfs.layers import CRFWindowAttention
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.ops.attention import WindowAttention
    x = torch.from_numpy(np.random.RandomState(13).rand(1, *hw, 3).astype(np.float32))
    model = build_model(NEWCRFS, 0.001, 80.0, device=dev, seed=0)
    seen = {WindowAttention: [], CRFWindowAttention: []}
    handles = [m.register_forward_pre_hook(
        lambda module, args: seen[type(module)].append(args[0].shape[0]))
        for m in model.modules() if type(m) in seen]
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = model(x.to(dev))
    torch.cuda.synchronize()
    counts, entries = dict(kernels.launch_counts), dict(kernels.entry_counts)
    for h in handles:
        h.remove()
    out = out.cpu()
    del model
    free_garbage()
    tag = f"NewCRFs large07 f32 batch 1 at {hw[0]}x{hw[1]}"
    log(f"{tag}: launches {counts}, through the q|k + v entry {entries}; K1 windows an image "
        f"by block: encoder {seen[WindowAttention]}, CRF {seen[CRFWindowAttention]}")
    if (counts != dict(dict.fromkeys(kernels.KERNELS, 0), **NEWCRFS_SERVE_LAUNCHES)
            or entries != NEWCRFS_SERVE_ENTRIES
            or (seen[WindowAttention], seen[CRFWindowAttention]) != crf_windows(*hw)):
        raise RuntimeError(f"{tag}: the kernels did not run at the expected shapes")
    cpu_model = build_model(NEWCRFS, 0.001, 80.0, device="cpu", seed=0)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu_model(x)
    log(f"{tag}: CPU forward (plain versions) {time.perf_counter() - t0:.1f} s")
    del cpu_model
    err = (out - ref).abs().max().item()
    log(f"{tag}, card vs CPU: output {tuple(out.shape)}, depth range [{ref.min().item():.3f}, "
        f"{ref.max().item():.3f}] m, max_abs_err {err:.3e} m (tolerance {MODEL_F32_TOL})")
    if out.shape != (1, *hw, 1) or not torch.isfinite(out).all() or err > MODEL_F32_TOL:
        raise RuntimeError(f"{tag}: the card disagrees with the CPU")


def newcrfs_serve_run(dev) -> tuple:
    """NewCRFs large07's bf16 serving through ``Predictor`` at batch 4 at
    the KB crop, counted, timed and profiled. Returns (img/s, launches)."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    model = build_model(NEWCRFS, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
    images = torch.from_numpy(np.random.RandomState(14).rand(
        NEWCRFS_BATCH, *EVAL_HW, 3).astype(np.float32)).to(dev)
    result = serve_run(f"NewCRFs large07 bf16 batch {NEWCRFS_BATCH}", Predictor(model), images,
                       NEWCRFS_SERVE_LAUNCHES, NEWCRFS_SERVE_ENTRIES)
    del model, images
    free_garbage()
    return result


def newcrfs_train_f32_check(dev) -> None:
    """NewCRFs large07's f32 train step, card against CPU, on 2 images of
    224x448 with colour casts of their own (the PSP's BatchNorms take batch
    statistics of 2x2, 3x3 and 6x6 pooled maps: on like images they cancel
    in f32, see ksa_train_f32_check), stochastic depth off."""
    batch = train_batch(2, 15, hw=(224, 448))
    batch["image"] *= np.array([[1.0, 0.2, 0.2], [0.2, 0.2, 1.0]], np.float32)[:, None, None]
    tag = "NewCRFs large07 f32 train step batch 2 at 224x448 (batch statistics, colour casts)"
    card = one_train_step(dev, batch, NEWCRFS_TRAIN_OPT, path_drop_prob=0.0)
    torch.cuda.synchronize()
    free_garbage()
    t0 = time.perf_counter()
    cpu = one_train_step("cpu", batch, NEWCRFS_TRAIN_OPT, path_drop_prob=0.0)
    log(f"{tag}: CPU step (plain versions) {time.perf_counter() - t0:.1f} s")
    compare_steps(tag, card, cpu)


def sibling_maps(out) -> tuple:
    """The depth maps of a sibling's output: the ordered heads' ``outs``,
    else the one map."""
    return tuple(out[1]) if isinstance(out[1], tuple) and out[1][0] is not None else (out[0],)


def sibling_f32_check(dev, name: str, seed: int) -> None:
    """A sibling's full-width f32 forward (encoder depth SHALLOW) at batch
    1 on the image of ``SIBLING_MAPS``: the card against the CPU, the CPU
    fed the card's index maps (reg and gen-1)."""
    from mde_tpu_torch.models import build_model
    cfg = SIBLINGS[name]
    hw, count, shape = SIBLING_MAPS[name]
    x = torch.from_numpy(np.random.RandomState(seed).rand(1, *hw, 3).astype(np.float32))
    replay = sibling_replay()
    try:
        replay.record()
        model = build_model(cfg, 0.001, 80.0, device=dev, seed=0, use_checkpoint=False,
                            encoder_kwargs=SHALLOW)
        with torch.no_grad():
            card = [m.cpu() for m in sibling_maps(model(x.to(dev)))]
        torch.cuda.synchronize()
        del model
        free_garbage()
        cpu_model = build_model(cfg, 0.001, 80.0, device="cpu", seed=0, use_checkpoint=False,
                                encoder_kwargs=SHALLOW)
        replay.replay()
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = sibling_maps(cpu_model(x))
        log(f"{name} f32 CPU forward (plain versions): {time.perf_counter() - t0:.1f} s")
    finally:
        replay.restore()
    errs = [(a - b).abs().max().item() for a, b in zip(card, ref)]
    log(f"{name} f32 batch 1 at {hw[0]}x{hw[1]}, card vs CPU: {count} maps of "
        f"{shape}, max_abs_err per map {errs} m (tolerance {MODEL_F32_TOL}); index flips per "
        f"repeat {replay.flips} (the CPU run was fed the card's indices)")
    if (len(card) != count or any(tuple(m.shape) != shape or not torch.isfinite(m).all()
                                  for m in card) or max(errs) > MODEL_F32_TOL):
        raise RuntimeError(f"{name} f32 forward on the card disagrees with the CPU")


def sibling_serve_run(dev, name: str, seed: int) -> dict:
    """A sibling's bf16 serving at batch 8 through ``Predictor``, counted,
    timed and profiled; ``oda2_red_order_reg`` also with its six FFs fused
    (K4). Returns {"serving": launches[, "serving_fused": launches]}."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    model = build_model(SIBLINGS[name], 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
    predictor = Predictor(model)
    images = torch.from_numpy(
        np.random.RandomState(seed).rand(BATCH, 352, 704, 3).astype(np.float32)).to(dev)
    tag = f"{name} bf16 batch {BATCH} (resized to 448x896)"
    rate, counts = serve_run(tag, predictor, images, SIBLING_SERVE_LAUNCHES[name])
    runs = {"serving": counts}
    if name == "oda2_red_order_reg":
        if fuse_ffs(model) != 6:
            raise RuntimeError(f"{name} should hold six DWConv-GLU FFs")
        fused, runs["serving_fused"] = serve_run(tag + " with fused FFs (K4)", predictor,
                                                 images, SIBLING_FUSED_SERVE_LAUNCHES)
        log(f"{name} bf16 batch {BATCH} serving: fused FFs {fused:.2f} img/s against the "
            f"default {rate:.2f} img/s in this run")
    del model, predictor, images
    free_garbage()
    return runs


def sibling_train_f32_check(dev, name: str, seed: int) -> None:
    """A sibling's full-width f32 train step (encoder depth SHALLOW, one
    repeat of the ordered head, ``ONE_REPEAT``) at batch 2 on 224x448, the
    card against the CPU (fed the card's index maps), stochastic depth and
    recompute off."""
    batch = train_batch(2, seed, hw=(224, 448))
    opt = dict(TRAIN_OPT, model=dict(SIBLINGS[name], **ONE_REPEAT))
    tag = f"{name} f32 train step batch 2 at 224x448"
    replay = sibling_replay()
    try:
        replay.record()
        kw = dict(path_drop_prob=0.0, use_checkpoint=False, encoder_kwargs=SHALLOW)
        card = one_train_step(dev, batch, opt, **kw)
        torch.cuda.synchronize()
        free_garbage()
        replay.replay()
        t0 = time.perf_counter()
        cpu = one_train_step("cpu", batch, opt, **kw)
        log(f"{tag}: CPU step (plain versions) {time.perf_counter() - t0:.1f} s; index flips "
            f"per repeat {replay.flips} (the CPU run was fed the card's indices)")
    finally:
        replay.restore()
    compare_steps(tag, card, cpu)


def sibling_runs(dev) -> dict:
    """Every phase of the five siblings. Returns {name: {path: launches}}."""
    runs = {}
    for i, name in enumerate(SIBLINGS):
        with timed(f"{name} f32 forward"):
            sibling_f32_check(dev, name, 20 + i)
        free_garbage()
        with timed(f"{name} serving"):
            runs[name] = sibling_serve_run(dev, name, 30 + i)
        with timed(f"{name} train step"):
            runs[name]["train_step"], _, _ = train_run(
                f"{name} bf16 train step batch {TRAIN_BATCH} (resized to 448x896, "
                f"use_checkpoint=True)", dict(TRAIN_OPT, model=SIBLINGS[name]), dev,
                SIBLING_TRAIN_LAUNCHES[name], warmup=2, timed=3, profile=True)
        free_garbage()
    for i, name in enumerate(("oda2_red_order_reg", "oda2_red_order_swin")):
        with timed(f"{name} f32 train step"):
            sibling_train_f32_check(dev, name, 40 + i)
        free_garbage()
    return runs


def luna_opt(name: str) -> dict:
    """The train config of a Luna model: the flagship's, and for the cls
    model the chamfer loss at 0.1, so that its bin centers reach it."""
    opt = dict(TRAIN_OPT, model=LUNAS[name][0])
    if name == "oda2_luna_cls":
        opt["loss"] = dict(opt["loss"], chamfer_weight=0.1)
    return opt


def perturb_o_cross2(model, seed: int) -> int:
    """Seeded weights and biases for every Luna gate's ``o_cross2``, which
    starts at zero: at init the gate is sigmoid(0) = 0.5 everywhere and a
    fault in the pixels' attention over the aux tokens would not show.
    Returns how many it set."""
    from mde_tpu_torch.models.oda2.luna import ODA2LunaLayer
    rng = np.random.RandomState(seed)
    layers = [m for m in model.modules() if isinstance(m, ODA2LunaLayer)]
    with torch.no_grad():
        for m in layers:
            for t in (m.o_cross2.weight, m.o_cross2.bias):
                t.copy_(torch.from_numpy((0.05 * rng.randn(*t.shape)).astype(np.float32)))
    return len(layers)


def luna_f32_check(dev, name: str, seed: int) -> None:
    """A Luna model's full-width f32 forward (encoder depth SHALLOW) at
    batch 1 on 352x704, the gates' ``o_cross2`` seeded on both sides: the
    card against the CPU, the map, the cls bin centers, red-Luna's eight
    attention weights."""
    from mde_tpu_torch.models import build_model
    cfg, _, _, shape = LUNAS[name]
    x = torch.from_numpy(np.random.RandomState(seed).rand(1, 352, 704, 3).astype(np.float32))
    outs = []
    for device in (dev, torch.device("cpu")):
        model = build_model(cfg, 0.001, 80.0, device=device, seed=0, use_checkpoint=False,
                            encoder_kwargs=SHALLOW)
        gates = perturb_o_cross2(model, 9)
        t0 = time.perf_counter()
        with torch.no_grad():
            out, second = model(x.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
        else:
            log(f"{name} f32 CPU forward (plain versions): {time.perf_counter() - t0:.1f} s")
        second = (() if second is None else (second,) if torch.is_tensor(second)
                  else tuple(second))
        outs.append((out.cpu(), [t.cpu() for t in second]))
        del model, out, second
        free_garbage()
    (out, second), (ref, ref_second) = outs
    err = (out - ref).abs().max().item()
    errs = [(a - b).abs().max().item() for a, b in zip(second, ref_second)]
    tol = MODEL_F32_TOL if name == "oda2_luna_cls" else WEIGHTS_TOL
    log(f"{name} f32 batch 1 at 352x704 (resized to 448x896), {gates} gates' o_cross2 seeded, "
        f"card vs CPU: map {tuple(out.shape)} max_abs_err {err:.3e} m (tolerance "
        f"{MODEL_F32_TOL}); second output {[tuple(t.shape) for t in second]} max_abs_err "
        f"{errs} (tolerance {tol})")
    want = {"oda2_luna_reg": 0, "oda2_luna_cls": 1, "oda2_red_luna_reg": 8}[name]
    if (tuple(out.shape) != shape or not torch.isfinite(out).all() or err > MODEL_F32_TOL
            or len(second) != want or any(e > tol for e in errs)
            or not all(torch.isfinite(t).all() for t in second)):
        raise RuntimeError(f"{name} f32 forward on the card disagrees with the CPU")


def luna_train_f32_check(dev, name: str, seed: int) -> None:
    """A Luna model's full-width f32 train step (encoder depth SHALLOW) at
    batch 2 on 224x448, the card against the CPU, dropout, stochastic depth
    and recompute off.
    ``oda2_luna_cls`` takes the chamfer loss at 0.1 and ``freeze_bn``: its
    PPM's 1x1 pooled BatchNorm normalises two values, whose gradient is
    rounding noise with batch statistics (``ksa_train_f32_check``).
    ``oda2_red_luna_reg``'s loss must take its depth map: the maps that the
    train step hands the loss are recorded and checked."""
    import mde_tpu_torch.train.step as step_module
    batch = train_batch(2, seed, hw=(224, 448))
    freeze_bn = name == "oda2_luna_cls"
    tag = (f"{name} f32 train step batch 2 at 224x448"
           f"{' (chamfer 0.1, freeze_bn)' if freeze_bn else ''}")
    seen, real = [], step_module.default_adapter

    def record(out):
        maps, centers = real(out)
        seen.append(([tuple(m.shape) for m in maps], None if centers is None
                     else tuple(centers.shape)))
        return maps, centers

    step_module.default_adapter = record
    try:
        kw = dict(freeze_bn=freeze_bn, path_drop_prob=0.0, use_checkpoint=False, drop_prob=0.0,
                  encoder_kwargs=SHALLOW)
        card = one_train_step(dev, batch, luna_opt(name), **kw)
        torch.cuda.synchronize()
        free_garbage()
        t0 = time.perf_counter()
        cpu = one_train_step("cpu", batch, luna_opt(name), **kw)
        log(f"{tag}: CPU step (plain versions) {time.perf_counter() - t0:.1f} s; the loss took "
            f"maps {seen[0][0]} and bin centers {seen[0][1]}")
    finally:
        step_module.default_adapter = real
    want = ([(2, 54, 110, 1)], None) if name == "oda2_red_luna_reg" else (
        [(2, 56, 112, 1)], (2, 256))
    if seen != [want, want] or (name == "oda2_luna_cls" and not card[0]["loss_chamfer"] > 0):
        raise RuntimeError(f"{tag}: the loss took {seen}, expected {want} on both devices")
    compare_steps(tag, card, cpu)


def luna_runs(dev) -> dict:
    """Every phase of the three Luna models. Returns {name: {path: launches}}."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    runs = {}
    for i, (name, (cfg, serving, training, _)) in enumerate(LUNAS.items()):
        with timed(f"{name} f32 forward"):
            luna_f32_check(dev, name, 50 + i)
        with timed(f"{name} serving"):
            model = build_model(cfg, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
            images = torch.from_numpy(np.random.RandomState(60 + i).rand(
                BATCH, 352, 704, 3).astype(np.float32)).to(dev)
            _, counts = serve_run(f"{name} bf16 batch {BATCH} (resized to 448x896)",
                                  Predictor(model), images, serving)
            runs[name] = {"serving": counts}
            del model, images
            free_garbage()
        with timed(f"{name} train step"):
            runs[name]["train_step"], _, _ = train_run(
                f"{name} bf16 train step batch {TRAIN_BATCH} (resized to 448x896, "
                f"use_checkpoint=True)", luna_opt(name), dev, training, warmup=2, timed=3,
                profile=True)
        free_garbage()
    for i, name in enumerate(("oda2_luna_cls", "oda2_red_luna_reg")):
        with timed(f"{name} f32 train step"):
            luna_train_f32_check(dev, name, 70 + i)
        free_garbage()
    return runs


def split_outputs(out) -> tuple:
    """A model's output as (the depth map, [every other tensor in order]; a
    None, ``oda_conv``'s second, left out)."""
    rest = []
    for item in out[1:]:
        rest += [] if item is None else [item] if torch.is_tensor(item) else list(item)
    return out[0], rest


def efficientnet_models() -> dict:
    """name -> (config, train config, image size, max depth, the shapes of
    one image's outputs after the depth map) of phase 11."""
    models = {"adabins": (ADABINS, ADABINS_TRAIN_OPT, ADABINS_HW, ADABINS_MAX_DEPTH,
                          [(1, ADABINS["num_bins"] + 1)])}
    for name, (cfg, shapes) in DEPTHFORMERS.items():
        opt = dict(TRAIN_OPT, model=cfg)
        if name == "depthformer_v3":
            opt["loss"] = dict(opt["loss"], chamfer_weight=0.1)
        models[name] = (cfg, opt, cfg["img_size"], 80.0, shapes)
    return models


def efficientnet_f32_check(dev, name: str, seed: int) -> None:
    """An AdaBins or Depthformer model's full-width f32 forward at batch 1:
    the card against the CPU, the depth map and bin edges in metres, the
    attention weights as probabilities."""
    from mde_tpu_torch.models import build_model
    cfg, _, hw, max_depth, shapes = efficientnet_models()[name]
    x = torch.from_numpy(np.random.RandomState(seed).rand(1, *hw, 3).astype(np.float32))
    outs = []
    # one build, moved to the card and back, as in luna_family_f32_check
    model = build_model(cfg, 0.001, max_depth, device="cpu", seed=0)
    for device in (dev, torch.device("cpu")):
        model.to(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            depth, rest = split_outputs(model(x.to(device)))
        if device.type == "cuda":
            torch.cuda.synchronize()
        else:
            log(f"{name} f32 CPU forward: {time.perf_counter() - t0:.1f} s")
        outs.append((depth.cpu(), [t.cpu() for t in rest]))
        del depth, rest
        free_garbage()
    del model
    (depth, rest), (ref, ref_rest) = outs
    err = (depth - ref).abs().max().item()
    errs = [(a - b).abs().max().item() for a, b in zip(rest, ref_rest)]
    tols = [MODEL_F32_TOL if t.dim() == 2 else WEIGHTS_TOL for t in rest]
    log(f"{name} f32 batch 1 at {hw[0]}x{hw[1]}, card vs CPU: depth {tuple(depth.shape)} in "
        f"[{ref.min().item():.3f}, {ref.max().item():.3f}] m, max_abs_err {err:.3e} m "
        f"(tolerance {MODEL_F32_TOL}); then {[tuple(t.shape) for t in rest]} max_abs_err "
        f"{errs} (tolerances {sorted(set(tols))}: edges in m, weights)")
    if (tuple(depth.shape) != (1, hw[0] // 2, hw[1] // 2, 1) or err > MODEL_F32_TOL
            or [tuple(t.shape) for t in rest] != shapes
            or not all(torch.isfinite(t).all() for t in [depth] + rest)
            or any(e > tol for e, tol in zip(errs, tols))):
        raise RuntimeError(f"{name} f32 forward on the card disagrees with the CPU")


class KinkReplay:
    """The sides of AdaBins' kinks (its transformer FFs' ReLU, the
    decoder's and regressor's LeakyReLUs): recorded where the card's train
    step takes them (``record``) and handed to the CPU's step (``replay``),
    which counts the elements whose own sign differs (``flips``). A
    pre-activation within f32 rounding of 0 falls on either side on the two
    devices, and a weight gradient summed over N pixels of random-signed
    terms then moves by about 1/sqrt(N): ~1.5% of a decoder conv's at 1/8
    scale. A full-width step held as is missed by 2%, its card and CPU each
    2% from an f64 step, the gradients equal to 1.5e-5 up to the first
    LeakyReLU on the way back and 17% apart (of their largest) after it
    (PERF.md)."""

    def __init__(self):
        self.masks, self.flips = [], []

    @staticmethod
    def _kinks(model):
        from mde_tpu_torch.models.adabins.model import TransformerEncoderLayer
        for m in model.modules():
            if isinstance(m, TransformerEncoderLayer):
                yield m, "activation", 0.0
            elif isinstance(m, torch.nn.LeakyReLU):
                yield m, "forward", m.negative_slope

    def record(self, model) -> None:
        for m, attr, _ in list(self._kinks(model)):
            def kink(x, real=getattr(m, attr)):
                self.masks.append((x > 0).cpu())
                return real(x)

            setattr(m, attr, kink)

    def replay(self, model) -> None:
        masks = iter(self.masks)
        for m, attr, slope in list(self._kinks(model)):
            def kink(x, slope=slope):
                mask = next(masks)
                self.flips.append(int(((x > 0) != mask).sum()))
                return torch.where(mask, x, x * slope)

            setattr(m, attr, kink)


def efficientnet_train_f32_check(dev, name: str, hw: tuple, seed: int) -> None:
    """A full-width f32 train step at batch 2 on ``hw``, dropout off, the
    card against the CPU: ``adabins`` (chamfer 0.1, ``same_lr`` false) and
    ``depthformer_v3`` (chamfer 0.1, built for ``hw``). The loss must take
    the depth map and the bin centers: the maps and centers that the train
    step hands ``DepthLoss`` are recorded and checked."""
    import mde_tpu_torch.train.step as step_module
    cfg, opt, _, max_depth, _ = efficientnet_models()[name]
    if name != "adabins":
        opt = dict(opt, model=dict(cfg, img_size=hw))
    batch = train_batch(2, seed, hw, max_depth)
    tag = f"{name} f32 train step batch 2 at {hw[0]}x{hw[1]} (chamfer 0.1)"
    seen, real = [], step_module.DepthLoss

    class Record(real):
        def __call__(self, outputs, gt, bin_centers=None):
            seen.append(([tuple(m.shape) for m in outputs], None if bin_centers is None
                         else tuple(bin_centers.shape)))
            return super().__call__(outputs, gt, bin_centers)

    step_module.DepthLoss = Record
    kw = dict(drop_prob=0.0) if name == "adabins" else dict(drop_prob=0.0, attn_drop_prob=0.0)
    kinks = KinkReplay()
    try:
        card = one_train_step(dev, batch, opt, max_depth=max_depth, prepare=kinks.record, **kw)
        torch.cuda.synchronize()
        free_garbage()
        t0 = time.perf_counter()
        cpu = one_train_step("cpu", batch, opt, max_depth=max_depth, prepare=kinks.replay, **kw)
        log(f"{tag}: CPU step {time.perf_counter() - t0:.1f} s; the loss took maps "
            f"{seen[0][0]} and bin centers {seen[0][1]}; flips per kink {kinks.flips} of "
            f"{sum(m.numel() for m in kinks.masks)} elements (the CPU run was fed the card's "
            f"sides)")
    finally:
        step_module.DepthLoss = real
    bins = ADABINS["num_bins"] if name == "adabins" else cfg["num_bins"]
    want = ([(2, hw[0] // 2, hw[1] // 2, 1)], (2, bins))
    if seen != [want, want] or not card[0]["loss_chamfer"] > 0:
        raise RuntimeError(f"{tag}: the loss took {seen}, expected {want} on both devices")
    compare_steps(tag, card, cpu)


def efficientnet_runs(dev) -> None:
    """Every phase of AdaBins and Depthformer v1-v5 (phase 11): no launch of
    any port kernel on any of their paths."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    for i, (name, (cfg, opt, hw, max_depth, _)) in enumerate(efficientnet_models().items()):
        with timed(f"{name} f32 forward"):
            efficientnet_f32_check(dev, name, 80 + i)
        with timed(f"{name} serving"):
            model = build_model(cfg, 0.001, max_depth, device=dev, seed=0,
                                dtype=torch.bfloat16)
            images = torch.from_numpy(
                np.random.RandomState(90 + i).rand(BATCH, *hw, 3).astype(np.float32)).to(dev)
            serve_run(f"{name} bf16 batch {BATCH}", Predictor(model), images, {})
            del model, images
            free_garbage()
        with timed(f"{name} train step"):
            train_run(f"{name} bf16 train step batch {TRAIN_BATCH}", opt, dev, {}, warmup=2,
                      timed=3, profile=True, hw=hw, max_depth=max_depth)
        free_garbage()
    for name, hw, seed in (("adabins", (288, 480), 100), ("depthformer_v3", (224, 448), 101)):
        with timed(f"{name} f32 train step"):
            efficientnet_train_f32_check(dev, name, hw, seed)
        free_garbage()


def kernel_inputs(model) -> tuple:
    """Record the input shape of every module of ``model`` that launches K1
    (windows, tokens, channels), K2 (an image's map before its windows) or
    K3: (records, hook handles)."""
    from mde_tpu_torch.ops.attention import WindowAttention
    from mde_tpu_torch.ops.depthwise import DepthwiseConv2d
    from mde_tpu_torch.ops.ordered_attention import PreNormOrderedSwinSA
    kinds = {WindowAttention: "K1", PreNormOrderedSwinSA: "K2", DepthwiseConv2d: "K3"}
    seen = {"K1": [], "K2": [], "K3": []}
    handles = [m.register_forward_pre_hook(
        lambda module, args, kind=kinds[type(m)]: seen[kind].append(tuple(args[0].shape)))
        for m in model.modules() if type(m) in kinds]
    return seen, handles


def eval_shape_f32_check(dev) -> None:
    """The flagship's f32 forward of one 352x1216 image (KITTI's test shape,
    resized to 448x1536) at the encoder depth SHALLOW and one repeat of the
    head (``ONE_REPEAT``: 2 K2 and 2 K3 launches): the card against the
    CPU, fed the card's index maps, with the windows K1, K2 and K3 see at
    this shape checked."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    x = torch.from_numpy(np.random.RandomState(9).rand(1, *EVAL_HW, 3).astype(np.float32))
    replay = IndexReplay()
    try:
        replay.record()
        model = build_model(dict(FLAGSHIP, **ONE_REPEAT), 0.001, 80.0, device=dev, seed=0,
                            use_checkpoint=False, encoder_kwargs=SHALLOW)
        seen, handles = kernel_inputs(model)
        kernels.reset_launch_counts()
        with torch.no_grad():
            _, outs = model(x.to(dev))
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        for h in handles:
            h.remove()
        gpu_outs = [o.cpu() for o in outs]
        del model, outs
        torch.cuda.empty_cache()
        windows = [s[0] for s in seen["K1"]]
        log(f"flagship f32 batch 1 at {EVAL_HW[0]}x{EVAL_HW[1]} (resized to 448x1536): "
            f"launches {counts}; K1 windows an image by block {windows} (of 49 tokens: "
            f"{sorted({s[1] for s in seen['K1']})}); K2 inputs {sorted(set(seen['K2']))} "
            f"({seen['K2'][0][1] * seen['K2'][0][2] // 64} windows of 8x8); K3 inputs "
            f"{sorted(set(seen['K3']))}")
        if (counts != dict(dict.fromkeys(kernels.KERNELS, 0), window_attention=len(EVAL_WINDOWS),
                           ordered_attention=2, depthwise_conv2d=2)
                or windows != EVAL_WINDOWS or set(seen["K2"]) != {(1, 112, 384, 512)}
                or set(seen["K3"]) != {(1, 112, 384, 2048)}):
            raise RuntimeError("the flagship at 352x1216 did not run the kernels at the "
                               "expected shapes")
        cpu_model = build_model(dict(FLAGSHIP, **ONE_REPEAT), 0.001, 80.0, device="cpu", seed=0,
                                use_checkpoint=False, encoder_kwargs=SHALLOW)
        replay.replay()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, ref_outs = cpu_model(x)
        log(f"flagship f32 CPU forward at {EVAL_HW[0]}x{EVAL_HW[1]} (plain versions): "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        replay.restore()
    errs = [(a - b).abs().max().item() for a, b in zip(gpu_outs, ref_outs)]
    log(f"flagship f32 batch 1 at {EVAL_HW[0]}x{EVAL_HW[1]}, card vs CPU: output "
        f"{tuple(gpu_outs[-1].shape)}, max_abs_err per map {errs} m (tolerance "
        f"{MODEL_F32_TOL}); index flips per repeat {replay.flips} of "
        f"{replay.card[0].numel()} (the CPU run was fed the card's indices)")
    if (len(errs) != ONE_REPEAT["num_repeats"] + 1 or max(errs) > MODEL_F32_TOL
            or gpu_outs[-1].shape != (1, 112, 384, 1) or not torch.isfinite(gpu_outs[-1]).all()):
        raise RuntimeError("flagship f32 forward at 352x1216 on the card disagrees with the CPU")


def write_kitti_tree(root: str, seed: int = 0) -> dict:
    """A synthetic KITTI tree under ``root``: DRIVER_TRAIN train and
    DRIVER_TEST test samples, 375x1242 8-bit RGB under ``data/raw/`` and
    uint16 depth x 256 (about 30% zeros) under ``data/gts/``, every PNG
    Paeth-filtered (``paeth_png``; the slowest filter to decode), and the
    Eigen split lists with a focal column under ``splits/KITTI/``, for
    ``MDE_SPLIT_DIR``. Returns the config's ``dataset`` section."""
    rng = np.random.RandomState(seed)
    h, w = KITTI_RAW_HW
    rows = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    for mode, n in (("train", DRIVER_TRAIN), ("test", DRIVER_TEST)):
        lines = []
        for i in range(n):
            img = f"2011_09_26/2011_09_26_drive_{mode}_sync/image_02/data/{i:010d}.png"
            gt = f"2011_09_26_drive_{mode}_sync/proj_depth/groundtruth/image_02/{i:010d}.png"
            image = (255 * np.clip(0.6 * rows + 0.4 * rng.rand(h, w, 3), 0, 1)).astype(np.uint8)
            depth = (rng.uniform(1.0, 80.0, (h, w)) * 256).astype(np.uint16)
            depth[rng.rand(h, w) < 0.3] = 0
            for sub, rel, arr in (("raw", img, image), ("gts", gt, depth)):
                path = os.path.join(root, "data", sub, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(paeth_png(arr))
            lines.append(f"{img} {gt} 721.5377")
        os.makedirs(os.path.join(root, "splits", "KITTI"), exist_ok=True)
        with open(os.path.join(root, "splits", "KITTI", f"kitti_eigen_{mode}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"data_type": "KITTI", "data_path": os.path.join(root, "data")}


def paeth_png(image: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 RGB or (H, W) uint16 gray image with
    every row Paeth-filtered, as encoders that pick filters by row (libpng's,
    Pillow's) often write KITTI's files; the port's writer uses Up only."""
    import struct
    import zlib
    from mde_tpu_torch.data.png import PAETH, SIGNATURE
    h, w = image.shape[:2]
    if image.dtype == np.uint16:
        rows, bpp, header = image.astype(">u2").view(np.uint8).reshape(h, -1), 2, (16, 0)
    else:
        rows, bpp, header = image.reshape(h, -1), 3, (8, 2)
    x = np.zeros((h + 1, rows.shape[1] + bpp), np.int16)
    x[1:, bpp:] = rows
    a, b, c = x[1:, :-bpp], x[:-1, bpp:], x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = PAETH
    filtered[:, 1:] = (rows - pred) & 0xFF

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, *header, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filtered.tobytes())) + chunk(b"IEND", b""))


def png_decode_rates(card: str) -> None:
    """Decode of one 375x1242 RGB image with the port's codec: written
    Up-filtered (the port's writer) and Paeth-filtered, serially, and the
    Paeth file also in 4 threads at once (the loader's decode pool); each
    must read back the image."""
    from concurrent.futures import ThreadPoolExecutor
    from mde_tpu_torch.data.png import decode_png, encode_png
    rng = np.random.RandomState(1)
    h, w = KITTI_RAW_HW
    rows = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    image = (255 * np.clip(0.6 * rows + 0.4 * rng.rand(h, w, 3), 0, 1)).astype(np.uint8)
    for name, data in (("Up", encode_png(image)), ("Paeth", paeth_png(image))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = decode_png(data)
            times.append(time.perf_counter() - t0)
        if not np.array_equal(out, image):
            raise RuntimeError(f"the PNG codec misread a {name}-filtered image")
        log(f"driver: decode of a {h}x{w} RGB PNG, every row {name}-filtered, one thread: "
            f"{1e3 * min(times):.1f} ms ({1 / min(times):.1f} img/s; {card})")
    with ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        outs = list(pool.map(decode_png, [data] * 32))
        took = time.perf_counter() - t0
    if not all(np.array_equal(o, image) for o in outs):
        raise RuntimeError("the PNG codec misread a Paeth-filtered image in a thread")
    log(f"driver: decode of 32 such Paeth-filtered PNGs in 4 threads: {len(outs) / took:.1f} "
        f"img/s ({card})")


def driver_opt(root: str, dataset: dict, **changes) -> dict:
    """The flagship's train config as ``bench.py`` pins it, on KITTI, batch 4
    with 4 workers, one epoch, print_freq 2, valid_freq 4, the Garg crop."""
    return dict(dict(TRAIN_OPT, output_dir=os.path.join(root, "run"), checkpoint="",
                     wandb={"mode": "disabled"}, dataset=dataset,
                     dataloader={"batch_size": TRAIN_BATCH, "num_workers": 4},
                     train=dict(TRAIN_OPT["train"], epoch=1, print_freq=2,
                                valid_freq=DRIVER_STEPS),
                     eval={"garg_crop": True, "eigen_crop": False, "flip_eval": False,
                           "min_depth_eval": 1e-3, "max_depth_eval": 80.0}), **changes)


def same_state(a, b) -> bool:
    """Two train states hold the same bits: parameters, BatchNorm
    statistics, moments and update count."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer, b.optimizer
    return (list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
            and oa.count == ob.count and oa.names == ob.names
            and all(torch.equal(x, y) for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu)))


@contextlib.contextmanager
def kitti_split_dir():
    """A temporary directory for a synthetic KITTI tree, with
    ``MDE_SPLIT_DIR`` pointing at its split lists while the block runs;
    removed, and the variable restored, after it."""
    root = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    split_env = os.environ.get("MDE_SPLIT_DIR")
    os.environ["MDE_SPLIT_DIR"] = os.path.join(root, "splits")
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if split_env is None:
            del os.environ["MDE_SPLIT_DIR"]
        else:
            os.environ["MDE_SPLIT_DIR"] = split_env


def watch_steps(trainer) -> tuple:
    """Wrap ``trainer``'s step (BatchNorm live) so that each step's logs and
    an event recorded after it on the card are kept, without a read:
    (the unwrapped step, the logs, the events)."""
    step, seen, events = trainer._get_step(False), [], []

    def watched(state, batch, generator):
        state, logs = step(state, batch, generator)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        seen.append(logs)
        return state, logs

    trainer._steps[False] = watched
    return step, seen, events


def driver_run(dev, card: str, bare_rate: float) -> dict:
    """The driver on a synthetic KITTI tree: the loader alone, ``fit``
    (counted, timed by events between its steps), resume, ``predict``,
    validate's time, one profiled fit step. Returns fit's launch counts."""
    from mde_tpu_torch.core.config import load_config
    from mde_tpu_torch.data.augment import normalize_eval_batch
    from mde_tpu_torch.data.loader import DataLoader
    from mde_tpu_torch.data.png import read_png
    from mde_tpu_torch.data.splits import parse_split_line
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.serve import Predictor
    from mde_tpu_torch.train.driver import Trainer
    with kitti_split_dir() as root:
        t0 = time.perf_counter()
        dataset = write_kitti_tree(root)
        log(f"driver: synthetic KITTI tree of {DRIVER_TRAIN} train and {DRIVER_TEST} test "
            f"samples at {KITTI_RAW_HW[0]}x{KITTI_RAW_HW[1]} written in "
            f"{time.perf_counter() - t0:.1f} s")
        png_decode_rates(card)
        trainer = Trainer(load_config(driver_opt(root, dataset)), dtype=torch.bfloat16)
        trainer.init_state()

        host = DataLoader(trainer.train_loader.dataset, TRAIN_BATCH, shuffle=True,
                          num_workers=4, host_only=True)
        t0 = time.perf_counter()
        n = sum(b["image"].shape[0] for b in host.epoch(0))
        log(f"driver: the loader alone (host_only, 4 threads, decode of Paeth-filtered PNGs, "
            f"KB-crop, stacking): {n / (time.perf_counter() - t0):.2f} img/s over {n} "
            f"images ({card})")

        step, seen, events = watch_steps(trainer)
        free_garbage()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = trainer.fit(max_steps=DRIVER_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = dict(kernels.launch_counts)
        test_batches = len(trainer.test_loader)
        expect = {k: DRIVER_STEPS * (CHECKPOINT_LAUNCHES.get(k, 0)
                                     + OPTIMIZER_LAUNCHES.get(k, 0))
                  + test_batches * EVAL_LAUNCHES.get(k, 0) for k in kernels.KERNELS}
        log(f"driver: fit({DRIVER_STEPS} steps) launches {counts} (expected {DRIVER_STEPS} "
            f"recomputing steps and {test_batches} eval forward: {expect})")
        if counts != expect:
            raise RuntimeError(f"driver fit: expected {expect} launches, got {counts}")
        losses = torch.stack([lg["loss"] for lg in seen]).tolist()
        gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        rate = TRAIN_BATCH / (float(np.median(gaps)) / 1e3)
        peak = torch.cuda.max_memory_allocated()
        log(f"driver: fit in {fit_s:.1f} s, losses {losses}, metrics {metrics}")
        log(f"driver: fit steps with the loader feeding them: {rate:.2f} img/s (median of the "
            f"{len(gaps)} gaps between step ends on the card, {[round(g, 2) for g in gaps]} "
            f"ms) against the bare recomputing step's {bare_rate:.2f} img/s; peak memory "
            f"{peak / 2 ** 30:.2f} GiB ({card})")
        ckpt_dir = os.path.join(root, "run", "checkpoints")
        if (len(losses) != DRIVER_STEPS or not all(np.isfinite(losses)) or len(metrics) != 9
                or not all(np.isfinite(v) for v in metrics.values())
                or os.listdir(ckpt_dir) != [f"step_{DRIVER_STEPS}"]):
            raise RuntimeError(f"driver fit: losses {losses}, metrics {metrics}, checkpoints "
                               f"{os.listdir(ckpt_dir)}")

        resumed = Trainer(load_config(driver_opt(root, dataset, checkpoint=ckpt_dir)),
                          dtype=torch.bfloat16, seed=1)
        resumed.init_state()
        same = same_state(trainer.state, resumed.state)
        log(f"driver: resumed at step {resumed.global_step}, best value {resumed.best_value} "
            f"(fit's {trainer.best_value}); parameters, statistics and moments equal: {same}")
        if (resumed.global_step != DRIVER_STEPS or resumed.best_value != trainer.best_value
                or not same):
            raise RuntimeError("driver: the resumed state differs from the saved one")
        del resumed
        free_garbage()

        out = os.path.join(root, "predictions")
        written = trainer.predict(out)
        ds, predictor = trainer.test_loader.dataset, Predictor(trainer.model)
        for i in range(len(ds)):
            rel = os.path.splitext(parse_split_line(ds.filenames[i], "KITTI")[0])[0] + ".png"
            got = read_png(os.path.join(out, rel))
            image = normalize_eval_batch(torch.from_numpy(ds.load_raw(i)[0][None]).to(dev))
            want = (predictor.predict(image)[0, ..., 0].cpu().numpy() * 256.0).astype(np.uint16)
            if got.shape != EVAL_HW or not np.array_equal(got, want):
                raise RuntimeError(f"driver predict: {rel} {got.shape} differs from "
                                   f"Predictor x 256")
        log(f"driver: predict wrote {written} uint16 PNGs of {EVAL_HW[0]}x{EVAL_HW[1]}, each "
            f"equal to Predictor.predict x 256, truncated")

        t0 = time.perf_counter()
        trainer.validate()
        val_s = time.perf_counter() - t0
        log(f"driver: validate at {EVAL_HW[0]}x{EVAL_HW[1]} (resized to 448x1536, bf16, batch "
            f"{TRAIN_BATCH}, decode included): {val_s * 1e3:.1f} ms for {len(ds)} images, "
            f"{len(ds) / val_s:.2f} img/s ({card})")

        batches = trainer.train_loader.epoch(1)
        next(batches)
        generator = torch.Generator(device=dev).manual_seed(5)
        log("driver: one profiled fit step (the loader's next batch to the card, its "
            "augmentation, the step):")
        profile_call(lambda: step(trainer.state, next(batches), generator))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(batches)
        log(f"driver: the loader's next batch after it, on the host clock (its decode done, "
            f"its pinning, copy and augmentation queued): {(time.perf_counter() - t0) * 1e3:.1f} "
            f"ms ({card})")
        batches.close()
        del trainer
        free_garbage()
        return counts


def newcrfs_driver_run(dev, card: str, bare_rate: float) -> dict:
    """``Trainer.fit(max_steps=2)`` with one validation on the synthetic
    KITTI tree with NewCRFs large07 (bf16, batch 4): its exact launches,
    finite losses and metrics, and its img/s against the bare step's.
    Returns fit's launch counts."""
    from mde_tpu_torch.core.config import load_config
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.driver import Trainer
    steps = 2
    with kitti_split_dir() as root:
        dataset = write_kitti_tree(root)
        opt = driver_opt(root, dataset, model=NEWCRFS,
                         train=dict(TRAIN_OPT["train"], epoch=1, print_freq=steps,
                                    valid_freq=steps))
        trainer = Trainer(load_config(opt), dtype=torch.bfloat16)
        trainer.init_state()
        _, seen, events = watch_steps(trainer)
        free_garbage()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = trainer.fit(max_steps=steps)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts, entries = dict(kernels.launch_counts), dict(kernels.entry_counts)
        evals = len(trainer.test_loader)
        expect = {k: steps * (NEWCRFS_TRAIN_LAUNCHES.get(k, 0) + OPTIMIZER_LAUNCHES.get(k, 0))
                  + evals * NEWCRFS_SERVE_LAUNCHES.get(k, 0) for k in kernels.KERNELS}
        expect_entries = {k: steps * v + evals * NEWCRFS_SERVE_ENTRIES.get(k, 0)
                          for k, v in NEWCRFS_TRAIN_ENTRIES.items()}
        log(f"driver (NewCRFs): fit({steps} steps) launches {counts}, through the q|k + v "
            f"entry {entries} (expected {steps} steps and {evals} eval forward: {expect}, "
            f"{expect_entries})")
        if counts != expect or entries != expect_entries:
            raise RuntimeError(f"driver fit (NewCRFs): expected {expect} launches, got {counts}")
        losses = torch.stack([lg["loss"] for lg in seen]).tolist()
        gap = events[0].elapsed_time(events[1])
        peak = torch.cuda.max_memory_allocated()
        log(f"driver (NewCRFs): fit in {fit_s:.1f} s (validation at {EVAL_HW[0]}x{EVAL_HW[1]} "
            f"included), losses {losses}, metrics {metrics}")
        log(f"driver (NewCRFs): the second fit step with the loader feeding it: "
            f"{TRAIN_BATCH / (gap / 1e3):.2f} img/s (the gap between the step ends on the "
            f"card, {gap:.2f} ms) against the bare step's {bare_rate:.2f} img/s; peak memory "
            f"{peak / 2 ** 30:.2f} GiB ({card})")
        if (len(losses) != steps or not all(np.isfinite(losses)) or len(metrics) != 9
                or not all(np.isfinite(v) for v in metrics.values())):
            raise RuntimeError(f"driver fit (NewCRFs): losses {losses}, metrics {metrics}")
        del trainer
        free_garbage()
        return counts


def profile_call(call) -> tuple:
    """Device time by kernel over one profiled call, and the device's busy
    share of that call's host-clock time. The profiler records the card's
    activity alone: the host's ops, which nothing here reads, took 3-4x as
    long to sum up and lengthened the profiled call itself (PERF.md).
    Returns (busy ms, host-clock ms, [(ms, count, name)] by kernel)."""
    from mde_tpu_torch.utils.profiling import profiler
    t_start = time.perf_counter()
    torch.cuda.synchronize()
    with profiler(host=False) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels and copies on the card only
            continue
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy_ms = sum(r[0] for r in rows)
    OVERHEAD["profiles"][0] += 1
    OVERHEAD["profiles"][1] += time.perf_counter() - t_start
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return busy_ms, wall_ms, rows
    log(f"profile of one call: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms host clock "
        f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on, the card's activity only)")
    # the 25 largest, and the port's own kernels wherever they rank
    ours = ("window_attention", "ordered_attention", "depthwise", "glu_ff", "channel_attention")
    for i, (ms, count, key) in enumerate(sorted(rows, reverse=True)):
        if i < 25 or any(name in key for name in ours):
            log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<4d} {key[:110]}")
    return busy_ms, wall_ms, rows


def ptxas_entries(report: str) -> list:
    """(source, kernel, registers, spill bytes stored and loaded) of every
    kernel in the build's ``-Xptxas -v`` report."""
    rows, src, entry, spills = [], None, None, (0, 0)
    for line in report.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            entry, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            rows.append((src, kernel_name(entry), int(m.group(1)), spills))
            entry = None
    return rows


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    if not m:
        return mangled
    size, rest = int(m.group(1)), m.group(2)
    name, rest = rest[:size], rest[size:]
    arg = r"13__nv_bfloat16|f|L[ib]\d+E"
    if m := re.match(rf"I((?:{arg})+)E", rest):
        names = {"13__nv_bfloat16": "bf16", "f": "float"}
        name += "<" + ",".join(names.get(a, a[2:-1]) for a in re.findall(arg, m.group(1))) + ">"
    return name


def build_report(kernels) -> dict:
    """Registers and spills (ptxas) of every kernel in the sources of K1,
    K1 bwd, K3, K3 dxdw, K3 dw, K4, K5 and K5 bwd, and the shared memory a
    block takes as the kernels' sources count it (K1 at N 49 and 144 with the
    bias;
    K3's and K4's tiled bodies by kernel size; K5 and K5 bwd at the KSA
    decoder's three stages, bf16 on the tensor cores and f32 on the CUDA
    cores), by kernel, for the ``kernels`` line; logs the shared memory."""
    lib, rows = kernels.library(), ptxas_entries(kernels.ptxas_report())
    dtypes = (("bf16", 1), ("f32", 0))
    k1_shapes = ((49, 16), (49, 32), (144, 32))
    smem = {"window_attention": {f"N {n} hd {hd} {tag}": lib.mde_window_attention_smem(
                n, 4 * hd, 4, code) for n, hd in k1_shapes for tag, code in dtypes},
            "window_attention_bwd": {f"N {n} hd {hd} {tag}": lib.mde_window_attention_bwd_smem(
                n, 4 * hd, 4, 1, code) for n, hd in k1_shapes for tag, code in dtypes},
            "depthwise_conv2d": {f"{k}x{k} {tag}": lib.mde_depthwise_conv2d_smem(k, code)
                                 for k in (3, 5, 7) for tag, code in dtypes},
            "depthwise_conv2d_dxdw": {f"{k}x{k} {tag}": lib.mde_depthwise_conv2d_dxdw_smem(k, code)
                                      for k in (3, 5, 7) for tag, code in dtypes},
            "depthwise_conv2d_dw": {f"{k}x{k} {tag}": lib.mde_depthwise_conv2d_dw_smem(k, code)
                                    for k in (3, 5, 7) for tag, code in dtypes},
            "glu_ff": {f"{k}x{k} {tag}": lib.mde_glu_ff_smem(k, code)
                       for k in (3, 5, 7) for tag, code in dtypes},
            "channel_attention": {f"N 49 C {c}/{c // 16} {tag}": lib.mde_channel_attention_smem(
                49, c, c, c // 16, code) for c in (64, 128, 256) for tag, code in dtypes},
            "channel_attention_bwd": {
                f"N 49 C {c}/{c // 16} {tag}": lib.mde_channel_attention_bwd_smem(
                    49, c, c, c // 16, code) for c in (64, 128, 256) for tag, code in dtypes}}
    out = {}
    for name, sizes in smem.items():
        log(f"{name}: shared memory a block: " +
            ", ".join(f"{k} {v} B" for k, v in sizes.items()))
        src = SOURCES[name][0].rsplit("/", 1)[1]
        out[name] = {"ptxas": [{"kernel": e, "registers": r, "spill_bytes": st + ld}
                               for s, e, r, (st, ld) in rows if s == src],
                     "smem_bytes": sizes}
    return out


# -- PR 18: the kernels as operators, the exported serving forward,
#    return_weights, tensor-parallel FFs ------------------------------------

# the forward entries that are operators of the mde namespace (the module
# under mde_tpu_torch/ops/kernels/, the kernel it launches)
OPS = {"window_attention": ("window_attention", "window_attention"),
       "window_attention_qk_v": ("window_attention", "window_attention"),
       "ordered_attention": ("ordered_attention", "ordered_attention"),
       "depthwise_conv2d": ("depthwise", "depthwise_conv2d"),
       "glu_ff": ("glu_ff", "glu_ff"),
       "channel_attention": ("channel_attention", "channel_attention")}
# each kernel's binding in the kernels line: every entry, forward and
# backward, is an operator of the mde namespace
BINDINGS = {k: f"custom op mde.{k}" for k in SOURCES}
BINDINGS["window_attention"] = ("custom ops mde.window_attention and "
                                "mde.window_attention_qk_v")
BINDINGS["window_attention_bwd"] = ("custom ops mde.window_attention_bwd and "
                                    "mde.window_attention_qk_v_bwd")
# a flagship serving call with return_weights: the ordered SAs on JAX's
# einsum path, which K2 does not serve (it computes no weights)
WEIGHTS_SERVE_LAUNCHES = {"window_attention": 24, "depthwise_conv2d": 6}
# the tensor-parallel steps: (data=1, model=2) on two gloo ranks on the one
# card, at the check size with every head repeat
TP_MODEL = dict(FLAGSHIP, tp_axis="model")
TP_HW = (224, 448)
TP_DTYPES = (torch.float32, torch.bfloat16)


def op_inputs(dev) -> dict:
    """Each operator's bf16 inputs at its main-path shape: K1 at the
    flagship's stage 1 (masked) and NewCRFs' crf0, K2 with the table, K3
    and K4 at the flagship's FF, K5 at the KSA decoder's stage 0."""
    g = torch.Generator(device=dev).manual_seed(18)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def mask(nw, n):
        return torch.where(torch.rand((nw, n, n), generator=g, device=dev) < 0.2, -100.0, 0.0)

    idx = torch.randint(0, 128, (3136, 64), generator=g, device=dev, dtype=torch.int32)
    return {
        "window_attention": (rand(512 * BATCH, 49, 384), rand(4, 49, 49, dtype=torch.float32),
                             mask(512, 49), 4, 32 ** -0.5),
        "window_attention_qk_v": (rand(572 * NEWCRFS_BATCH, 49, 256),
                                  rand(572 * NEWCRFS_BATCH, 49, 128),
                                  rand(4, 49, 49, dtype=torch.float32), mask(572, 49), 4,
                                  32 ** -0.5),
        "ordered_attention": (rand(3136, 64, 512), rand(3136, 64, 512), rand(3136, 64, 512),
                              idx, rand(255, 8, scale=0.1, dtype=torch.float32), 8, 64 ** -0.5,
                              128),
        "depthwise_conv2d": (rand(BATCH, 112, 224, 2048), rand(5, 5, 2048, scale=0.2)),
        "glu_ff": (rand(BATCH, 112, 224, 4096), rand(5, 5, 2048, scale=0.2),
                   rand(2048, dtype=torch.float32), rand(2048, dtype=torch.float32)),
        "channel_attention": (rand(512 * BATCH, 49, 64), rand(512 * BATCH, 49, 128), 4, 0.25),
    }


def custom_op_phase(dev, card: str) -> dict:
    """Each forward operator (``torch.ops.mde.*``) against its direct
    launch (``direct_*``, the same check and launch without the
    dispatcher) on the same inputs: bit-equal, one launch each; then
    device ms per launch (queued) and host ms per launch (after a
    synchronisation) of both. Returns {op: (op device ms, op host ms,
    direct host ms)}."""
    import importlib
    from mde_tpu_torch.ops import kernels
    inputs = op_inputs(dev)
    out = {}
    for name, (module_name, kernel) in OPS.items():
        module = importlib.import_module(f"mde_tpu_torch.ops.kernels.{module_name}")
        op, direct = getattr(torch.ops.mde, name), getattr(module, f"direct_{name}")
        args = inputs[name]
        kernels.reset_launch_counts()
        a = op(*args)
        b = direct(*args)
        torch.cuda.synchronize()
        launched = kernels.launch_counts[kernel]
        if not torch.equal(a, b) or launched != 2:
            raise RuntimeError(f"mde.{name}: the operator's output differs from the direct "
                               f"launch's (max {(a.float() - b.float()).abs().max().item()}) "
                               f"or {launched} launches of {kernel} for the two calls")
        ms = time_ms(lambda: op(*args))
        host = time_ms(lambda: op(*args), queued=False)
        direct_ms = time_ms(lambda: direct(*args))
        direct_host = time_ms(lambda: direct(*args), queued=False)
        out[name] = (ms, host, direct_host)
        log(f"custom op mde.{name} {tuple(args[0].shape)} bf16: bit-equal to its direct launch; "
            f"device {ms:.4f} ms (direct {direct_ms:.4f}), host {host:.4f} ms a launch "
            f"(direct {direct_host:.4f}; the dispatch {1e3 * (host - direct_host):.1f} us) "
            f"({card})")
    del inputs
    torch.cuda.empty_cache()
    return out


def set_return_weights(model, flag: bool) -> None:
    """``return_weights`` on the flagship and each of its modules that
    takes it (the head, its blocks, their ordered SAs)."""
    for m in model.modules():
        if hasattr(m, "return_weights"):
            m.return_weights = flag


def weights_serve_run(dev, model, images, plain_out) -> None:
    """The serving model with ``return_weights``: one counted call (K1 24,
    K2 0, K3 6: the ordered SAs take the einsum path), six f32 (B * 392, 8,
    64, 64) weights whose rows sum to 1, and the depth map against the
    default call's (K2). The two paths round the attention differently, so
    the maps are not the same bits: in bf16 the sigmoid's maps are bf16,
    whose step near 1 is 2^-8 (0.3125 m at 80 m), and the map is held
    within two of them; in f32 (batch 2, the same model) within the
    card-vs-CPU tolerance."""
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.step import default_adapter
    set_return_weights(model, True)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.no_grad():
            result = model(images)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        model.dtype = torch.float32
        with torch.no_grad():
            f32_out = model(images[:2])[0]
        set_return_weights(model, False)
        with torch.no_grad():
            f32_diff = (model(images[:2])[0] - f32_out).abs().max().item()
    finally:
        set_return_weights(model, False)
        model.dtype = torch.bfloat16
    out, outs, weights = result
    expect = dict(dict.fromkeys(kernels.KERNELS, 0), **WEIGHTS_SERVE_LAUNCHES)
    shape = (BATCH * 392, 8, 64, 64)
    rows = max((w.sum(-1) - 1).abs().max().item() for w in weights)
    diff = (out - plain_out).abs().max().item()
    moved = int((out != plain_out).sum())
    log(f"flagship bf16 batch {BATCH} with return_weights: launches {counts}; weights "
        f"{len(weights)} x {tuple(weights[0].shape)} {weights[0].dtype}, rows sum to 1 within "
        f"{rows:.2e}; depth map against the default call's (K2): {diff:.4f} m at most, "
        f"{moved} of {out.numel()} pixels differ; in f32 at batch 2 {f32_diff:.3e} m")
    maps, _ = default_adapter(result)
    if (counts != expect or len(weights) != 6 or any(tuple(w.shape) != shape
                                                     or w.dtype != torch.float32
                                                     for w in weights)
            or rows > 1e-5 or diff > 2 * 80.0 * 2 ** -8 or f32_diff > MODEL_F32_TOL
            or len(maps) != 4 or any(m is not o for m, o in zip(maps, outs))):
        raise RuntimeError(f"return_weights serving call: expected {expect} launches and six "
                           f"{shape} f32 weights, the adapter taking the maps; got {counts}, "
                           f"{[tuple(w.shape) for w in weights]}, depth {diff}")
    del result, weights


EXPORT_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path[:0] = ["tools", "."]
import torch
import torch_export
from mde_tpu_torch.ops import kernels
images = torch.load(sys.argv[2])
t1 = time.perf_counter()
module = torch_export.load(sys.argv[1])
t2 = time.perf_counter()
kernels.reset_launch_counts()
with torch.no_grad():
    pred = module(images.cuda())
torch.cuda.synchronize()
t3 = time.perf_counter()
counts = dict(kernels.launch_counts)
torch.save(pred.cpu(), sys.argv[3])
from mde_tpu_torch.models import build_model
from mde_tpu_torch.serve import Predictor
t4 = time.perf_counter()
model = build_model(json.loads(sys.argv[4]), 0.001, 80.0, seed=0, dtype=torch.bfloat16,
                    use_checkpoint=False)
with torch.no_grad():
    model.eval()(images.cuda())
torch.cuda.synchronize()
t5 = time.perf_counter()
print(json.dumps({"launches": counts, "start_s": t1 - t0, "load_s": t2 - t1,
                  "first_call_s": t3 - t2, "build_and_first_call_s": t5 - t4}))
"""


def export_round_trip(dev, model, images, card: str) -> None:
    """``tools/torch_export.py`` on the serving model (bf16, batch 8 at
    352x704, the default FFs): export and save, then load the program in a
    fresh process and run it on the same images, with its launches (K1
    24, K2 6, K3 6), its output bit-equal to the eager call's, and its time
    to the first output against building and initialising the model in
    that process. Then the same model in f32 (batch 2), exported and run
    here, against its eager call."""
    root_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root_dir, "tools"))
    import torch_export
    with torch.no_grad():
        eager = model(images)[0]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        torch_export.export(os.path.join(root, "bf16"), "train", BATCH, "base", model=model)
        export_s = time.perf_counter() - t0
        paths = [os.path.join(root, n) for n in ("bf16", "images.pt", "pred.pt")]
        torch.save(images.cpu(), paths[1])
        child = subprocess.run([sys.executable, "-c", EXPORT_CHILD, *paths,
                                json.dumps(FLAGSHIP)], capture_output=True, text=True,
                               timeout=300, cwd=root_dir)
        if child.returncode != 0:
            raise RuntimeError(f"loading the exported program failed:\n{child.stderr[-4000:]}")
        report = json.loads(child.stdout.strip().splitlines()[-1])
        pred = torch.load(paths[2]).to(dev)
        with open(os.path.join(paths[0], "meta.json")) as f:
            meta = json.load(f)
        size = os.path.getsize(os.path.join(paths[0], "flagship_train.pt2"))
        log(f"export: flagship bf16 batch {BATCH} at 352x704 exported and saved in "
            f"{export_s:.1f} s ({size / 2 ** 20:.0f} MiB); meta {meta}")
        expect = dict(dict.fromkeys(report["launches"], 0), window_attention=24,
                      ordered_attention=6, depthwise_conv2d=6)
        diff = (pred - eager).abs().max().item()
        same = "bit-equal" if torch.equal(pred, eager) else "not bit-equal"
        log(f"export: the loaded program in a fresh process: launches {report['launches']}, "
            f"against the eager call max |d| {diff:.3e} m ({same}); process start and "
            f"imports {report['start_s']:.1f} s, load {report['load_s']:.1f} s, first output "
            f"{report['first_call_s']:.2f} s after the load; building and initialising the "
            f"model and its first output {report['build_and_first_call_s']:.1f} s ({card})")
        if report["launches"] != expect or not torch.equal(pred, eager):
            raise RuntimeError(f"the loaded program launched {report['launches']} (expected "
                               f"{expect}) or differs from the eager call by {diff}")
    # f32: the same model exported at batch 2 and run here, not saved
    model.dtype = torch.float32
    try:
        x = images[:2]
        with torch.no_grad():
            eager32 = model(x)[0]
            t0 = time.perf_counter()
            program = torch.export.export(torch_export.ServingForward(model), (x,))
            f32_s = time.perf_counter() - t0
            pred32 = program.module()(x)
    finally:
        model.dtype = torch.bfloat16
    diff32 = (pred32 - eager32).abs().max().item()
    log(f"export: flagship f32 batch 2 exported in {f32_s:.1f} s and run here: against the "
        f"eager call max |d| {diff32:.3e} m")
    if diff32 > 1e-4:
        raise RuntimeError(f"the f32 exported program differs from the eager call by {diff32}")
    del eager, pred
    free_garbage()


def tp_all_reduces(model, num_accum: int = 1) -> int:
    """The all-reduces of one GSPMD step of the flagship ``model`` whose
    FFs split over a model axis of more than one rank: those of
    ``gspmd_all_reduces``, and in each microbatch for each FF its partial
    products summed in the forward, its input's gradient summed in the
    backward and its partial products summed again in its block's replay;
    the gradient then takes two (the replicated parameters' mean, the
    slices' sum) and the slices' running statistics one."""
    from mde_tpu_torch.ops.mlp import PreNormDWConvFF
    ffs = sum(isinstance(m, PreNormDWConvFF) for m in model.modules())
    return gspmd_all_reduces(model, num_accum) + num_accum * 3 * ffs + 2


def tp_steps(batch: dict, opt: dict) -> list:
    """On a rank of the two gloo ranks of ``gloo_rank``, as the (data=1,
    model=2) grid: one recomputing GSPMD step of the flagship with
    ``tp_axis`` in f32, then one in bf16 (each a fresh model, weights from
    seed 0, stochastic depth from a generator of seed 17) on the whole
    ``batch``. Returns for each (logs, gradients, state, launches, the
    channels of each K3 forward and dxdw launch, all-reduces, peak bytes,
    the rank's place)."""
    from mde_tpu_torch.core import dist
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.ops.kernels import depthwise
    from mde_tpu_torch.parallel.mesh import make_mesh
    from mde_tpu_torch.train.step import make_train_step_gspmd
    channels = {"fwd": [], "dxdw": []}
    for key, name in (("fwd", "direct_depthwise_conv2d"), ("dxdw", "depthwise_dxdw")):
        real = getattr(depthwise, name)

        def record(x, *args, real=real, key=key):
            channels[key].append(x.shape[-1])
            return real(x, *args)

        setattr(depthwise, name, record)
    mesh = make_mesh(torch.device("cuda"), n_model=2)

    def make_step(o, lo, hi, **kw):
        return make_train_step_gspmd(o, lo, hi, mesh, **kw)

    results = []
    for dtype in TP_DTYPES:
        for v in channels.values():
            v.clear()
        free_garbage()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dist.reset_collective_counts()
        out = one_train_step(mesh.device, batch, opt, encoder_kwargs=SHALLOW, seed=17,
                             dtype=dtype, make_step=make_step)
        torch.cuda.synchronize()
        results.append((*out, dict(kernels.launch_counts),
                        {k: list(v) for k, v in channels.items()},
                        dist.collective_counts["all_reduce"],
                        torch.cuda.max_memory_allocated(), (mesh.rank, mesh.model_rank)))
    return results


def tp_references(dev) -> tuple:
    """The tensor-parallel phase's batch (4 at 224x448), config (the
    flagship with ``tp_axis``) and one process's ``make_train_step`` of each
    of ``TP_DTYPES`` on it (``one_train_step``, seed 17)."""
    # as the ranks: f32 convolutions without TF32 (cuDNN's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = train_batch(TRAIN_BATCH, 19, hw=TP_HW)
    opt = dict(TRAIN_OPT, model=TP_MODEL)
    refs = []
    for dtype in TP_DTYPES:
        refs.append(one_train_step(dev, batch, opt, encoder_kwargs=SHALLOW, seed=17,
                                   dtype=dtype))
        free_garbage()
    return batch, opt, refs


def tp_check(ranks: list, refs: list, card: str) -> None:
    """Tensor-parallel FFs on a (data=1, model=2) grid of two gloo ranks on
    the one card (``tp_steps``): the flagship's recomputing GSPMD step
    (``tp_axis`` "model", ``save_sa_conv``) at batch 4 on 224x448 (encoder
    ``SHALLOW``, 3 repeats, stochastic depth 0.2), in f32 and in bf16,
    each rank's FFs on 1024 of the 2048 hidden channels, against one
    process's ``make_train_step`` on the whole batch from the same weights
    and generator (``tp_references``): f32 within ``compare_steps``'
    tolerances, bf16 the logs within 2e-2 of their size (the partial
    products are summed in bf16); the ranks' states bit-equal, the
    all-reduces as derived (``tp_all_reduces``), each rank's K3 launches
    and peak memory."""
    from mde_tpu_torch.models import build_model
    derived = tp_all_reduces(build_model(TP_MODEL, 0.001, 80.0, device="cpu",
                                         encoder_kwargs=SHALLOW))
    for i, (dtype, ref) in enumerate(zip(TP_DTYPES, refs)):
        tag = (f"flagship {dtype} recomputing train step batch {TRAIN_BATCH} at "
               f"{TP_HW[0]}x{TP_HW[1]}, tp_axis on (data=1, model=2)")
        for r in range(2):
            logs, grads, state, counts, channels, reduces, peak, place = ranks[r][i]
            log(f"tensor parallel: {tag}, rank {r} at {place}: K3 forward launches at "
                f"{channels['fwd']} channels, K3 dxdw at {channels['dxdw']}; launches {counts}; "
                f"all-reduces {reduces} (derived {derived}); peak memory "
                f"{peak / 2 ** 30:.2f} GiB ({card})")
            if (reduces != derived or channels["fwd"] != [1024] * 6
                    or channels["dxdw"] != [1024] * 6):
                raise RuntimeError(f"{tag}, rank {r}: {reduces} all-reduces (derived "
                                   f"{derived}), K3 channels {channels}")
            if dtype == torch.float32:
                compare_steps(f"{tag}, rank {r} against one process's make_train_step",
                              (logs, grads, state), ref, ("TP rank", "make_train_step"))
            else:
                bad = {k: (logs[k], ref[0][k]) for k in ("loss", "loss_si", "grad_norm")
                       if abs(logs[k] - ref[0][k]) > 2e-2 * max(1.0, abs(ref[0][k]))}
                log(f"{tag}, rank {r}: logs {logs}, one process {ref[0]}")
                if bad:
                    raise RuntimeError(f"{tag}: the logs differ from one process's: {bad}")
        (logs0, _, state0, *_), (logs1, _, state1, *_) = ranks[0][i], ranks[1][i]
        if logs0 != logs1 or not all(torch.equal(state0[k], state1[k]) for k in state0):
            raise RuntimeError(f"{tag}: the two ranks ended with different states")
        log(f"tensor parallel: {tag}: the two ranks ended with the same logs and state")


# -- the optimizer: the fused AdamW kernels (ops/kernels/adamw.py) ------------

# the benchmark's two configurations (benchmark/configs/), whose parameter
# sets the optimizer phase updates
OPTIMIZER_MODELS = {"flagship": FLAGSHIP,
                    "oda_conv": {"name": "oda_conv", "decoder_channels": 1024}}
# f32 bytes an updated parameter: g read for the norm, then g, p, mu, nu read
# and p, mu, nu written
OPTIMIZER_BYTES = 32


def optimizer_phase(dev, card: str) -> dict:
    """The fused AdamW on each of ``OPTIMIZER_MODELS``' parameter sets
    (shapes from a build on the meta device, random f32 values, gradients
    at the clip's scale) with ``TRAIN_OPT``'s options: one step against the
    plain version from the same state (the update's largest difference
    over its largest size; the norms against the f64 sums), then device ms a
    step (queued), ms after a synchronisation, the host's issue time a step
    (the card asleep), the bound (``OPTIMIZER_BYTES`` a parameter at 3.35
    TB/s) and the plain version's ms. Returns {config: result}.

    The update is compared beyond p's own rounding: an update a few ulps
    apart (an FMA contracted in one and not the other, the clip's norm
    summed in f64 against f32) can round p + u to the next f32 of p, which
    at lr 4e-6 is thousandths of the update; two ulps of p are allowed."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.optim import AdamW, build_lr_schedule
    out = {}
    lr = build_lr_schedule(TRAIN_OPT, TRAIN_TOTAL_STEPS)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.1, max_norm=0.1)
    for name, cfg in OPTIMIZER_MODELS.items():
        with torch.device("meta"):
            shapes = {n: p.shape for n, p in
                      build_model(cfg, 0.001, 80.0, device="meta").named_parameters()}
        g = torch.Generator(device=dev).manual_seed(23)
        params = {n: torch.randn(s, generator=g, device=dev) * 0.05 for n, s in shapes.items()}
        grads = {n: torch.randn(s, generator=g, device=dev) * 1e-4 for n, s in shapes.items()}
        n_params = sum(p.numel() for p in params.values())
        fused = AdamW(params, lr, **kw)
        plain = AdamW({n: p.clone() for n, p in params.items()}, lr, **kw)
        plain._fused = None  # the plain version, on the card
        start = [p.clone() for p in fused.params]
        kernels.reset_launch_counts()
        fused.update(grads)
        torch.cuda.synchronize()
        launched = kernels.launch_counts["adamw"]
        plain.update(grads)
        err = max(((a - b).abs() - 2 ** -22 * b.abs()).max().item()
                  for a, b in zip(fused.params, plain.params))
        size = max((b - p0).abs().max().item() for b, p0 in zip(plain.params, start))
        exact = [float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))
                 for ts in (grads.values(), fused.params)]
        norms = [(float(fused.grad_norm), float(plain.grad_norm)),
                 (float(fused.param_norm), float(plain.param_norm))]
        del start
        err = max(err, 0.0)
        ms = time_ms(lambda: fused.update(grads))
        host_ms = time_ms(lambda: fused.update(grads), queued=False)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(10):
            fused.update(grads)
        issue_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: plain.update(grads), iters=3, warmup=1, queued=False)
        bound_ms = OPTIMIZER_BYTES * n_params / HBM_BYTES_PER_S * 1e3
        out[name] = {"tensors": len(shapes), "parameters": n_params, "launches": launched,
                     "ms": ms, "host_ms": host_ms, "issue_ms": issue_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "update_err": err / size, "norms": norms,
                     "f64_norms": exact}
        log(f"optimizer {name}: {len(shapes)} tensors, {n_params} parameters: fused AdamW "
            f"{ms:.4f} ms a step on the card ({launched} launches; {100 * bound_ms / ms:.1f}% of "
            f"the bound {bound_ms:.4f} ms, {OPTIMIZER_BYTES} B a parameter at 3.35 TB/s), "
            f"{host_ms:.4f} ms after a synchronisation, the host's issue {issue_ms:.4f} ms; "
            f"plain {plain_ms:.4f} ms; one step against the plain version: the update "
            f"{err / size:.2e} of its largest beyond two ulps of p, grad_norm {norms[0]} "
            f"(f64 {exact[0]:.7g}), param_norm {norms[1]} (f64 {exact[1]:.7g}) ({card})")
        if (launched != 3 or not err <= 1e-5 * size
                or any(abs(a - e) > 1e-5 * e or abs(b - e) > 1e-5 * e
                       for (a, b), e in zip(norms, exact))):
            raise RuntimeError(f"optimizer {name}: the fused AdamW disagrees with its plain "
                               f"version or launched {launched} kernels")
        del fused, plain, params, grads
        free_garbage()
    return out


def kernel_phases(kernels, dev) -> tuple:
    """Build the kernels, log their registers and shared memory, and run
    every kernel phase. Returns (the main phases, the other shapes by
    kernel, the build report)."""
    t0 = time.perf_counter()
    kernels.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for src, entry, regs, (stores, loads) in ptxas_entries(kernels.ptxas_report()):
        log(f"{src}: {entry}: {regs} registers, spills {stores} B stored, {loads} B loaded")
    build = build_report(kernels)
    # K2 at the flagship's N 64, 512 channels, 8 heads, 128 depth values, with
    # the table, in f32 (code 0) and bf16 (1), as the kernels' sources count it
    lib = kernels.library()
    k2 = {(bwd, code): (lib.mde_ordered_attention_bwd_smem if bwd
                        else lib.mde_ordered_attention_smem)(64, 512, 8, 128, 1, code)
          for bwd in (False, True) for code in (0, 1)}
    log(f"dynamic shared memory per block: K1 bf16 "
        f"{build['window_attention']['smem_bytes']['N 49 hd 32 bf16']} B (tensor cores, "
        f"128 threads; N 49, head dim 32), K1 bwd bf16 "
        f"{build['window_attention_bwd']['smem_bytes']['N 49 hd 32 bf16']} B (with the "
        f"bias), K2 bf16 {k2[False, 1]} B (N 64, "
        f"head dim 64, with the table; f32 {k2[False, 0]} B), K2 bwd bf16 "
        f"{k2[True, 1]} B (f32 {k2[True, 0]} B), K3 bf16 5x5 "
        f"{build['depthwise_conv2d']['smem_bytes']['5x5 bf16']} B and K3 dxdw bf16 5x5 "
        f"{build['depthwise_conv2d_dxdw']['smem_bytes']['5x5 bf16']} B and K4 bf16 5x5 "
        f"{build['glu_ff']['smem_bytes']['5x5 bf16']} B and K3 dw bf16 5x5 "
        f"{build['depthwise_conv2d_dw']['smem_bytes']['5x5 bf16']} B (tiled bodies), K5 bf16 "
        f"{build['channel_attention']['smem_bytes']['N 49 C 64/4 bf16']} B and K5 bwd bf16 "
        f"{build['channel_attention_bwd']['smem_bytes']['N 49 C 64/4 bf16']} B (tensor cores, "
        f"one warp, N 49, 4 heads of 16; K5 bwd f32 "
        f"{build['channel_attention_bwd']['smem_bytes']['N 49 C 64/4 f32']} B on the CUDA "
        f"cores)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [window_phase("stage 1", 512 * BATCH, 128, 4, 512, False, dev),
              window_phase("stage 1", 512 * BATCH, 128, 4, 512, True, dev),
              window_phase("stage 3", 32 * BATCH, 512, 16, 32, True, dev),
              ordered_phase(True, dev), ordered_phase(False, dev),
              depthwise_phase(dev),
              window_bwd_phase("stage 1", 512 * TRAIN_BATCH, 128, 4, 512, dev),
              ordered_bwd_phase(dev),
              depthwise_bwd_phase(dev, dxdw=True), depthwise_bwd_phase(dev, dxdw=False),
              glu_phase(dev), channel_phase(dev, backward=False),
              channel_phase(dev, backward=True)]
    one = ordered_bwd_phase(dev, "one_bucket")
    phases[7]["one_bucket_ms"] = one["ms"]
    log(f"K2 bwd by index pattern: uniform {phases[7]['ms']:.4f} ms, one index a window "
        f"{one['ms']:.4f} ms ({one['ms'] / phases[7]['ms']:.2f}x)")
    # K1 at the ODA encoder's 144-token windows (the wide tensor-core bodies)
    oda = oda_window_phases(dev)
    # K1 at the other shapes of its paths: the KSA decoder's head dim 16
    # (stage 0, serving) and the train step's stage 3, where 18 of the
    # flagship's 24 backward launches run; K3 at the train step's batch
    # and K1's q|k + v entry at NewCRFs' crf0: serving at the KB crop (572
    # windows an image) and the train step at 352x704 (338)
    more = {"window_attention": [phases[0], phases[2],
                                 window_phase("KSA decoder stage 0", 512 * BATCH, 64, 4,
                                              512, True, dev),
                                 window_qk_v_phase("NewCRFs crf0", 572 * NEWCRFS_BATCH, 128,
                                                   4, 572, dev),
                                 *oda["window_attention"]],
            "window_attention_bwd": [window_bwd_phase("stage 3", 32 * TRAIN_BATCH, 512, 16,
                                                      32, dev),
                                     window_qk_v_bwd_phase("NewCRFs crf0",
                                                           338 * TRAIN_BATCH, 128, 4, 338,
                                                           dev),
                                     *oda["window_attention_bwd"]],
            "ordered_attention_bwd": [ordered_bwd_phase(dev, with_table=False)],
            "depthwise_conv2d": [depthwise_phase(dev, TRAIN_BATCH)],
            "channel_attention": [channel_phase(dev, False, c) for c in (128, 256)],
            "channel_attention_bwd": [channel_phase(dev, True, c) for c in (128, 256)]}
    for p in (phases[1], phases[6], *more["window_attention"],
              *more["window_attention_bwd"], phases[4], phases[7],
              *more["ordered_attention_bwd"], phases[11], *more["channel_attention"],
              phases[12], *more["channel_attention_bwd"]):
        log(f"{p['phase']}: {p['ms'] / p['library_ms']:.2f}x the SDPA yardstick, "
            f"{p['ms'] / p['bound_ms']:.2f}x the bound")
    for p in (phases[5], *more["depthwise_conv2d"], phases[8], phases[9]):
        log(f"{p['phase']}: {p['ms'] / p['library_ms']:.2f}x the cuDNN yardstick, "
            f"{p['ms'] / p['bound_ms']:.2f}x the bound")
    torch.cuda.empty_cache()
    return phases, more, build


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mde_tpu_torch.ops import kernels
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    count_builds()
    with timed("kernel phases", group=True):
        phases, more, build = kernel_phases(kernels, dev)
    with timed("custom ops", group=True):
        op_times = custom_op_phase(dev, card)
    with timed("optimizer", group=True):
        optimizer = optimizer_phase(dev, card)
    with timed("flagship", group=True):
        with timed("flagship f32 forward"):
            model_f32_check(dev)
        torch.cuda.empty_cache()
        with timed("flagship serving"):
            fused_counts = model_bf16_run(dev, card)
        torch.cuda.empty_cache()
        with timed("flagship f32 train step"):
            train_f32_check(dev)
        torch.cuda.empty_cache()
        with timed("flagship train steps"):
            plain = train_bf16_run(dev)
            counts = plain[0]
        with timed("flagship recompute policies"):
            remat = remat_runs(dev, card, plain)
            bare_rate = remat["save_sa_conv"][1]
        with timed("flagship data parallel"):
            data_parallel_run(dev, card)
        with timed("flagship data and tensor parallel on two gloo ranks"):
            gloo_pair_run(dev, card)
        free_garbage()
        with timed("flagship f32 at 352x1216"):
            eval_shape_f32_check(dev)
        torch.cuda.empty_cache()
    with timed("driver", group=True):
        driver_counts = driver_run(dev, card, bare_rate)
    with timed("KSA", group=True):
        with timed("KSA f32 forward"):
            ksa_f32_check(dev)
        with timed("KSA serving"):
            ksa_serve_run(dev)
        with timed("KSA f32 train steps"):
            ksa_train_f32_check(dev, 2, freeze_bn=True)
            ksa_train_f32_check(dev, 4, freeze_bn=False)
        torch.cuda.empty_cache()
        with timed("KSA train step"):
            ksa_counts, _, _ = train_run(
                f"oda2_ksa_reg bf16 train step batch {TRAIN_BATCH} (resized to 448x896, "
                f"use_checkpoint=True)", KSA_TRAIN_OPT, dev, KSA_TRAIN_LAUNCHES, warmup=2,
                timed=5, profile=True)
        free_garbage()
    with timed("NewCRFs", group=True):
        with timed("NewCRFs f32 forwards"):
            newcrfs_f32_check(dev, EVAL_HW)
            newcrfs_f32_check(dev, NYU_HW)
        with timed("NewCRFs serving"):
            _, newcrfs_serve_counts = newcrfs_serve_run(dev)
        with timed("NewCRFs f32 train step"):
            newcrfs_train_f32_check(dev)
        free_garbage()
        with timed("NewCRFs train step"):
            newcrfs_counts, newcrfs_rate, _ = train_run(
                f"NewCRFs large07 bf16 train step batch {TRAIN_BATCH} (352x704, "
                f"use_checkpoint=False)", NEWCRFS_TRAIN_OPT, dev, NEWCRFS_TRAIN_LAUNCHES,
                warmup=2, timed=5, profile=True, entries=NEWCRFS_TRAIN_ENTRIES)
        free_garbage()
        with timed("NewCRFs driver"):
            newcrfs_fit_counts = newcrfs_driver_run(dev, card, newcrfs_rate)
        free_garbage()
    with timed("siblings", group=True):
        siblings = sibling_runs(dev)
    with timed("Luna", group=True):
        siblings.update(luna_runs(dev))
    with timed("EfficientNet", group=True):
        efficientnet_runs(dev)
    with timed("ODA/Luna family", group=True):
        siblings.update(luna_family_runs(dev, LUNA_FAMILY, 110))
        with timed("oda_luna_cls f32 train step"):
            oda_train_f32_check(dev, 130)
        free_garbage()
    with timed("ODA Lion/Lime/Jeju", group=True):
        siblings.update(luna_family_runs(dev, ODA_LAST, 140))

    # the line reports each kernel at its main-path shape in bf16 (K1 at
    # stage 1 with the shift mask, K2 with the table) and its launches in
    # one run of the path that carries it
    report = {p["kernel"]: p for p in (phases[1], phases[3], phases[5], *phases[6:])}
    paths = dict.fromkeys(report, (f"Trainer.fit, {DRIVER_STEPS} steps with use_checkpoint "
                                   f"and one validation at 352x1216", driver_counts))
    paths["depthwise_conv2d_dw"] = ("flagship bf16 train step", counts)
    paths["glu_ff"] = ("flagship bf16 serving with fused FFs", fused_counts)
    for name in ("channel_attention", "channel_attention_bwd"):
        paths[name] = ("oda2_ksa_reg bf16 train step", ksa_counts)
    # K1's launches on NewCRFs' paths, of them through the q|k + v entry
    newcrfs = {"window_attention": {
        "serving": newcrfs_serve_counts["window_attention"],
        "train_step": newcrfs_counts["window_attention"],
        "fit": newcrfs_fit_counts["window_attention"],
        "qk_v_entry": {"serving": NEWCRFS_SERVE_ENTRIES["window_attention_qk_v"],
                       "train_step": NEWCRFS_TRAIN_ENTRIES["window_attention_qk_v"]}},
        "window_attention_bwd": {
        "train_step": newcrfs_counts["window_attention_bwd"],
        "fit": newcrfs_fit_counts["window_attention_bwd"],
        "qk_v_entry": {"train_step": NEWCRFS_TRAIN_ENTRIES["window_attention_qk_v_bwd"]}}}
    # each kernel's launches on the siblings' paths, where it has any
    sibling_launches = {name: {model: {path: counts[name] for path, counts in runs.items()
                                       if counts[name]}
                               for model, runs in siblings.items()} for name in report}
    sibling_launches = {name: {m: v for m, v in by_model.items() if v}
                        for name, by_model in sibling_launches.items()}
    line = {"kernels": [dict({
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": paths[name][1][name],
        "path": paths[name][0], "max_abs_err": p["max_abs_err_bf16"], "ms": p["ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "library_ms": p["library_ms"], "host_ms": p["host_ms"], "binding": BINDINGS[name]},
        **({"custom_op": {"ms": op_times[name][0], "host_ms": op_times[name][1],
                          "direct_host_ms": op_times[name][2]}} if name in op_times else {}),
        **{k: p[k] for k in ("library", "unfused_chain_ms", "one_bucket_ms", "body") if k in p},
        **build.get(name, {}),
        **({"newcrfs_launches": newcrfs[name]} if name in newcrfs else {}),
        **({"sibling_launches": sibling_launches[name]} if sibling_launches[name] else {}),
        **({"other_shapes": [{k: q[k] for k in ("phase", "ms", "library_ms", "bound_ms",
                                                 "plain_ms", "host_ms", "max_abs_err_bf16")}
                             for q in more[name]]} if name in more else {}))
        for name, p in report.items()]}
    o = optimizer["flagship"]
    line["kernels"].append({
        "name": "adamw", "route": "cuda", "source": "mde_tpu_torch/ops/kernels/csrc/adamw.cu",
        "replaces": "none: optax's clip_by_global_norm + adamw ran under XLA",
        "launches": counts["adamw"], "path": "flagship bf16 train step",
        "max_abs_err": o["update_err"], "ms": o["ms"], "plain_ms": o["plain_ms"],
        "bound_ms": o["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "host_ms": o["host_ms"], "issue_ms": o["issue_ms"], "binding": "ctypes, AdamW.update",
        "other_shapes": [dict(optimizer["oda_conv"], phase="oda_conv parameters")]})
    log_seconds()
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
