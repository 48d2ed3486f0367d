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
   run; K3 also at the train step's batch 4; K5 and its backward also at
   the KSA decoder's stages 1 and 2 (128 and 256 channels). Which body K3
   dw took (tiled or gather) is logged. Each kernel is also timed with
   its calls following a synchronisation, so that any host gaps between
   them count (``host_ms``).
3. Flagship serving at full width: ``oda2_red_order_swin2`` (Swin-B, red33
   neck, ordered head) with seeded random weights. In f32 at batch 1, with
   seeded statistics in the FFs' BatchNorms so that K4's folded affine is
   not the identity, the card's forward is held against the same forward
   with its six FFs fused (K4) and against the same model on the CPU
   (plain versions); both are
   fed the card's index maps so that a flipped depth bucket cannot hide a
   fault (flips are counted). In bf16 at batch 8 ``Predictor.predict`` runs
   on 352x704 images with every launch count at 0 before and exactly 24
   K1, 6 K2 and 6 K3 forward launches after; then with the six FFs fused
   (24 K1, 6 K2, 6 K4, no K3); each is timed and profiled.
4. Flagship training at full width: one f32 train step at batch 1, card
   against CPU (fed the card's index maps), comparing the loss, the
   gradient norm, every gradient, the BatchNorm statistics and the
   parameters after AdamW. Then the bf16 train step at batch 4 on 352x704
   images (``make_train_step``, AdamW + OneCycle + clip 0.1, stochastic
   depth 0.2): its launch counts, finite logs and moved parameters, 5 timed
   steps after 2 warm-up, peak memory, one profiled step, and one run with
   ``use_checkpoint``.
5. ``oda2_ksa_reg`` at full width (Swin-L, KSA decoder at dec_dim 512, the
   build's defaults, ``use_checkpoint`` on): the f32 batch-1 forward card
   against CPU; bf16 serving at batch 8 (32 K1 and 6 K5 launches), timed
   and profiled; the f32 train step card against CPU at 224x448, at batch 2
   with ``freeze_bn`` and at batch 4 with batch statistics (see
   ``ksa_train_f32_check``); the bf16 train step at batch 4 on 352x704
   (56 K1 forward and 32 backward, 6 K5 forward and 6 backward), timed and
   profiled.

Any failure exits non-zero before the result lines. The last three lines
are the card, the ``kernels`` JSON line and the ``ok`` JSON line.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time

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
# launches of one train step with use_checkpoint off, derived from the code:
# 24 Swin blocks (K1), 3 repeats of 2 ordered SAs (K2) and 2 FFs (K3), each
# forward once and backward once; K3's dw alone never runs (x needs a grad)
TRAIN_LAUNCHES = {"window_attention": 24, "window_attention_bwd": 24,
                  "ordered_attention": 6, "ordered_attention_bwd": 6,
                  "depthwise_conv2d": 6, "depthwise_conv2d_dxdw": 6, "depthwise_conv2d_dw": 0}
# with use_checkpoint every checkpointed block runs its forward twice
CHECKPOINT_LAUNCHES = dict(TRAIN_LAUNCHES, window_attention=48, ordered_attention=12,
                           depthwise_conv2d=12)
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


def log(*args):
    print(*args, flush=True)


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


def ordered_bwd_phase(dev, pattern: str = "uniform"):
    """K2 backward, with the table, at the train step's shape, on indices of
    ``pattern`` (``window_indices``)."""
    from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention_bwd,
                                                             plain_ordered_attention_bwd)
    g = torch.Generator(device=dev).manual_seed(5)
    bw, n, c, heads, e = 392 * TRAIN_BATCH, 64, 512, 8, 128
    idx = window_indices(pattern, bw, e, g, dev)
    table = torch.randn(2 * e - 1, heads, generator=g, device=dev)

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

    name = f"K2 bwd ({bw},{n},{c})/{heads} with table, {pattern} indices"
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
    """Record the depth-index maps the flagship's head quantises on the
    card, and hand the same maps to a later run (on the CPU, or on the card
    along another path), counting where that run's own maps differ (a
    bucket rounded the other way)."""

    def __init__(self):
        import mde_tpu_torch.models.oda2.red_order_swin2 as flagship
        self.module, self.real = flagship, flagship._quantize_logit
        self.card, self.flips = [], []

    def record(self):
        def quantize(logit, num_emb):
            self.card.append(self.real(logit, num_emb))
            return self.card[-1]
        self.module._quantize_logit = quantize

    def replay(self):
        maps = iter(list(self.card))

        def quantize(logit, num_emb):
            own, card = self.real(logit, num_emb), next(maps).to(logit.device)
            self.flips.append(int((own != card).sum()))
            return card
        self.module._quantize_logit = quantize

    def restore(self):
        self.module._quantize_logit = self.real


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
    """Full-width f32 forward at batch 1, the FFs' BatchNorms given seeded
    statistics: the card's default forward against the card's forward with
    the six FFs fused (K4), and against the CPU."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 352, 704, 3).astype(np.float32))
    replay = IndexReplay()
    try:
        replay.record()
        model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0)
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
        log(f"flagship f32 batch 1 on the card, seeded FF BatchNorms, fused FFs (K4) vs "
            f"default: max_abs_err per map {fused_errs} m (tolerance {MODEL_F32_TOL}); index "
            f"flips per repeat {replay.flips} (the fused run was fed the default run's "
            f"indices)")
        if len(fused_errs) != FLAGSHIP["num_repeats"] + 1 or max(fused_errs) > MODEL_F32_TOL:
            raise RuntimeError("flagship f32 forward with fused FFs disagrees with the default")
        del model, out, outs, fused_outs
        cpu_model = build_model(FLAGSHIP, 0.001, 80.0, device="cpu", seed=0)
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
    log(f"flagship f32 batch 1, card vs CPU: max_abs_err per map {errs} m "
        f"(tolerance {MODEL_F32_TOL}); index flips per repeat {replay.flips} of "
        f"{replay.card[0].numel()} (the CPU run was fed the card's indices)")
    if len(errs) != FLAGSHIP["num_repeats"] + 1 or max(errs) > MODEL_F32_TOL:
        raise RuntimeError("flagship f32 forward on the card disagrees with the CPU")


def serve_run(tag, predictor, images, expect) -> tuple:
    """One counted ``predict`` (every launch count from 0, then exactly
    ``expect``, every other kernel 0), its peak memory, 5 timed calls and a
    profile. Returns (img/s, the counted launches)."""
    from mde_tpu_torch.ops import kernels
    predictor.predict(images)  # warm-up
    torch.cuda.synchronize()
    free_garbage()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    pred = predictor.predict(images)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    log(f"{tag} serving launches: {counts}")
    expect = dict(dict.fromkeys(kernels.KERNELS, 0), **expect)
    if counts != expect:
        raise RuntimeError(f"{tag}: expected {expect} kernel launches per forward, got {counts}")
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


def model_bf16_run(dev) -> dict:
    """Full-width bf16 serving at batch 8: the default FFs, then the six FFs
    fused (K4), each counted, timed and profiled. Returns the fused run's
    launch counts."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.serve import Predictor
    model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
    predictor = Predictor(model)
    images = torch.from_numpy(
        np.random.RandomState(1).rand(BATCH, 352, 704, 3).astype(np.float32)).to(dev)
    default, _ = serve_run(f"flagship bf16 batch {BATCH} (resized to 448x896)", predictor,
                           images, dict(window_attention=24, ordered_attention=6,
                                        depthwise_conv2d=6))
    fuse_ffs(model)
    fused, counts = serve_run(f"flagship bf16 batch {BATCH} with fused FFs (K4)", predictor,
                              images, FUSED_SERVE_LAUNCHES)
    log(f"flagship bf16 batch {BATCH} serving: fused FFs {fused:.2f} img/s against the default "
        f"{default:.2f} img/s in this run")
    return counts


def train_batch(size: int, seed: int, hw=(352, 704)) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(size, *hw, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 60.0, (size, *hw, 1)).astype(np.float32)}


def one_train_step(dev, batch: dict, opt=TRAIN_OPT, freeze_bn: bool = False, **overrides):
    """One train step of a fresh model of ``opt`` (seed 0): (logs,
    gradients, state dict), all on the CPU."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step
    model = build_model(opt["model"], 0.001, 80.0, device=dev, seed=0, **overrides)
    state = TrainState.create(model, opt, TRAIN_TOTAL_STEPS)
    grads = {}
    update = state.optimizer.update

    def keep(g):
        grads.update({n: t.detach().cpu() for n, t in g.items()})
        update(g)

    state.optimizer.update = keep
    _, logs = make_train_step(opt, 0.001, 80.0, freeze_bn=freeze_bn)(state, batch)
    return ({k: float(v) for k, v in logs.items()}, grads,
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def train_f32_check(dev) -> None:
    """Full-width f32 train step at batch 1: the card against the CPU."""
    batch = train_batch(1, 2)
    replay = IndexReplay()
    try:
        replay.record()
        card = one_train_step(dev, batch, path_drop_prob=0.0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        replay.replay()
        t0 = time.perf_counter()
        cpu = one_train_step("cpu", batch, path_drop_prob=0.0)
        log(f"flagship f32 CPU train step (plain versions): {time.perf_counter() - t0:.1f} s")
    finally:
        replay.restore()
    log(f"flagship f32 train step batch 1: index flips per repeat {replay.flips} (the CPU run "
        f"was fed the card's indices)")
    compare_steps("flagship f32 train step batch 1", card, cpu)


def compare_steps(tag, card, cpu) -> None:
    """Hold one train step on the card against the same step on the CPU."""
    (logs, grads, weights), (ref_logs, ref_grads, ref_weights) = card, cpu
    log(f"{tag}: card {logs}, CPU {ref_logs}")
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
        raise RuntimeError(f"{tag} on the card disagrees with the CPU (logs {bad})")


def train_run(tag, opt, dev, expect, warmup, timed, profile, **overrides) -> dict:
    """Full-width bf16 train steps at batch 4 of a fresh model of ``opt``:
    one counted step (every launch count from 0, then exactly ``expect``,
    every other kernel 0; finite logs, moved parameters), more warm-up
    steps up to ``warmup``, ``timed`` timed steps, peak memory and, with
    ``profile``, one profiled step. Returns the counted launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(TRAIN_BATCH, 3).items()}
    step = make_train_step(opt, 0.001, 80.0)
    generator = torch.Generator(device=dev).manual_seed(0)
    model = build_model(opt["model"], 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16,
                        **overrides)
    state = TrainState.create(model, opt, TRAIN_TOTAL_STEPS)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    free_garbage()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _, logs = step(state, batch, generator)
    torch.cuda.synchronize()
    run = dict(kernels.launch_counts)
    log(f"{tag} launches: {run}")
    expect = dict(dict.fromkeys(kernels.KERNELS, 0), **expect)
    if run != expect:
        raise RuntimeError(f"{tag}: expected {expect} kernel launches per train step, got {run}")
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
    log(f"{tag} at 352x704: {TRAIN_BATCH / float(np.median(times)):.2f} img/s (median of "
        f"{len(times)} steps after {warmup} warm-up, {[round(t * 1e3, 2) for t in times]} ms), "
        f"peak memory {peak / 2 ** 30:.2f} GiB, loss {float(logs['loss']):.4f}")
    if profile:
        profile_call(lambda: step(state, batch, generator))
    del state, model
    torch.cuda.empty_cache()
    return run


def train_bf16_run(dev) -> dict:
    """The flagship's bf16 train step at batch 4, then one recomputing run.
    Returns the first run's counted launches."""
    tag = f"flagship bf16 train step batch {TRAIN_BATCH} (resized to 448x896, use_checkpoint="
    counts = train_run(tag + "False)", TRAIN_OPT, dev, TRAIN_LAUNCHES, warmup=3, timed=5,
                       profile=True, use_checkpoint=False)
    train_run(tag + "True)", TRAIN_OPT, dev, CHECKPOINT_LAUNCHES, warmup=2, timed=2,
              profile=False, use_checkpoint=True)
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
    ``size`` images of 224x448 (a quarter of the pixels keeps the CPU step
    short), with batch statistics or with ``freeze_bn``.

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
    card = one_train_step(dev, batch, KSA_TRAIN_OPT, freeze_bn=freeze_bn, path_drop_prob=0.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = one_train_step("cpu", batch, KSA_TRAIN_OPT, freeze_bn=freeze_bn, path_drop_prob=0.0)
    log(f"{tag}: CPU step (plain versions, use_checkpoint=True) {time.perf_counter() - t0:.1f} s")
    compare_steps(tag, card, cpu)


def profile_call(call) -> None:
    """Device time by kernel over one profiled call, and the device's busy
    share of that call's host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile of one call: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms host clock "
        f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")
    # the 25 largest, and the port's own kernels wherever they rank
    ours = ("window_attention", "ordered_attention", "depthwise", "glu_ff", "channel_attention")
    for i, (ms, count, key) in enumerate(sorted(rows, reverse=True)):
        if i < 25 or any(name in key for name in ours):
            log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<4d} {key[:110]}")


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
    block takes as the kernels' sources count it (K1 at N 49 with the bias;
    K3's and K4's tiled bodies by kernel size; K5 and K5 bwd at the KSA
    decoder's three stages, bf16 on the tensor cores and f32 on the CUDA
    cores), by kernel, for the ``kernels`` line; logs the shared memory."""
    lib, rows = kernels.library(), ptxas_entries(kernels.ptxas_report())
    dtypes = (("bf16", 1), ("f32", 0))
    smem = {"window_attention": {f"N 49 hd {hd} {tag}": lib.mde_window_attention_smem(
                49, 4 * hd, 4, code) for hd in (16, 32) for tag, code in dtypes},
            "window_attention_bwd": {f"N 49 hd {hd} {tag}": lib.mde_window_attention_bwd_smem(
                49, 4 * hd, 4, 1, code) for hd in (16, 32) for tag, code in dtypes},
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
    # K1 at the other shapes of its paths: the KSA decoder's head dim 16
    # (stage 0, serving) and the train step's stage 3, where 18 of the
    # flagship's 24 backward launches run; K3 at the train step's batch
    more = {"window_attention": [phases[0], phases[2],
                                 window_phase("KSA decoder stage 0", 512 * BATCH, 64, 4,
                                              512, True, dev)],
            "window_attention_bwd": [window_bwd_phase("stage 3", 32 * TRAIN_BATCH, 512, 16,
                                                      32, dev)],
            "depthwise_conv2d": [depthwise_phase(dev, TRAIN_BATCH)],
            "channel_attention": [channel_phase(dev, False, c) for c in (128, 256)],
            "channel_attention_bwd": [channel_phase(dev, True, c) for c in (128, 256)]}
    for p in (phases[1], phases[6], *more["window_attention"],
              *more["window_attention_bwd"], phases[11], *more["channel_attention"],
              phases[12], *more["channel_attention_bwd"]):
        log(f"{p['phase']}: {p['ms'] / p['library_ms']:.2f}x the SDPA yardstick, "
            f"{p['ms'] / p['bound_ms']:.2f}x the bound")
    for p in (phases[5], *more["depthwise_conv2d"], phases[8], phases[9]):
        log(f"{p['phase']}: {p['ms'] / p['library_ms']:.2f}x the cuDNN yardstick, "
            f"{p['ms'] / p['bound_ms']:.2f}x the bound")
    torch.cuda.empty_cache()

    model_f32_check(dev)
    torch.cuda.empty_cache()
    fused_counts = model_bf16_run(dev)
    torch.cuda.empty_cache()
    train_f32_check(dev)
    torch.cuda.empty_cache()
    counts = train_bf16_run(dev)
    ksa_f32_check(dev)
    ksa_serve_run(dev)
    ksa_train_f32_check(dev, 2, freeze_bn=True)
    ksa_train_f32_check(dev, 4, freeze_bn=False)
    torch.cuda.empty_cache()
    ksa_counts = train_run(f"oda2_ksa_reg bf16 train step batch {TRAIN_BATCH} (resized to "
                           f"448x896, use_checkpoint=True)", KSA_TRAIN_OPT, dev,
                           KSA_TRAIN_LAUNCHES, warmup=2, timed=5, profile=True)

    # the line reports each kernel at its main-path shape in bf16 (K1 at
    # stage 1 with the shift mask, K2 with the table) and its launches in
    # one run of the path that carries it
    report = {p["kernel"]: p for p in (phases[1], phases[3], phases[5], *phases[6:])}
    paths = dict.fromkeys(report, ("flagship bf16 train step", counts))
    paths["glu_ff"] = ("flagship bf16 serving with fused FFs", fused_counts)
    for name in ("channel_attention", "channel_attention_bwd"):
        paths[name] = ("oda2_ksa_reg bf16 train step", ksa_counts)
    line = {"kernels": [dict({
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": paths[name][1][name],
        "path": paths[name][0], "max_abs_err": p["max_abs_err_bf16"], "ms": p["ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "library_ms": p["library_ms"], "host_ms": p["host_ms"]},
        **{k: p[k] for k in ("library", "unfused_chain_ms", "one_bucket_ms", "body") if k in p},
        **build.get(name, {}),
        **({"other_shapes": [{k: q[k] for k in ("phase", "ms", "library_ms", "bound_ms",
                                                 "plain_ms", "host_ms", "max_abs_err_bf16")}
                             for q in more[name]]} if name in more else {}))
        for name, p in report.items()]}
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
