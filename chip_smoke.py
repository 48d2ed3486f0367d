"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the port's
   CUDA kernels from ``mde_tpu_torch/ops/kernels/csrc`` with ``nvcc`` for
   sm_90a and prints each kernel's registers and shared memory.
2. Kernel phases: each of the seven kernels against its plain PyTorch
   version on the card at the flagship's main-path shapes, in bf16 and in
   f32 with TF32 off; its time (CUDA events), the plain version's, one
   PyTorch call's as a yardstick, and the least time the card could take
   (bytes over 3.35 TB/s, operations over the 989 TFLOP/s bf16 peak). The
   forwards at the serving shapes (batch 8, 448x896), the backwards at the
   train step's (batch 4).
3. Serving at full width: the flagship ``oda2_red_order_swin2`` (Swin-B,
   red33 neck, ordered head) with seeded random weights. In f32 at batch 1
   the card's forward is held against the same model on the CPU (plain
   versions, fed the card's index maps so that a flipped depth bucket cannot
   hide a fault; flips are counted). In bf16 at batch 8 ``Predictor.predict``
   runs once on 352x704 images with every launch count at 0 before and
   exactly 24 K1, 6 K2 and 6 K3 forward launches (and no backward) after;
   then it is timed and profiled.
4. Training at full width: one f32 train step at batch 1, card against CPU
   (fed the card's index maps), comparing the loss, the gradient norm,
   every gradient, the BatchNorm statistics and the parameters after AdamW.
   Then the bf16 train step at batch 4 on 352x704 images (``make_train_step``,
   AdamW + OneCycle + clip 0.1, stochastic depth 0.2): its launch counts,
   finite logs and moved parameters, 5 timed steps after 2 warm-up, peak
   memory, one profiled step, and one run with ``use_checkpoint``.

Any failure exits non-zero before the result lines. The last three lines
are the card, the ``kernels`` JSON line and the ``ok`` JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # dense tensor-core peak; the kernels are timed in bf16
BATCH = 8  # serving
TRAIN_BATCH = 4
F32_TOL = 1e-5
# bf16 tolerance relative to max(1, max |plain|); see tests/test_torch_port_gpu.py
BF16_REL = {"window_attention": 3e-2, "ordered_attention": 3e-2, "depthwise_conv2d": 5e-2,
            "window_attention_bwd": 3e-2, "ordered_attention_bwd": 3e-2,
            "depthwise_conv2d_dxdw": 1e-2, "depthwise_conv2d_dw": 1e-4}
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


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
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
    hw = {512: (112, 224), 128: (56, 112), 32: (28, 56), 8: (14, 28)}[nw]
    mask = shifted_window_attn_mask(*hw, 7, 3, dev) if masked else None
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


def depthwise_phase(dev):
    from mde_tpu_torch.ops.kernels.depthwise import depthwise_conv2d, plain_depthwise_conv2d
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (BATCH, 112, 224, 2048)

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


def window_bwd_phase(dev):
    """K1 backward at the train step's stage-1 SW-MSA shape."""
    from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention_bwd,
                                                            window_attention_bwd)
    from mde_tpu_torch.ops.window import shifted_window_attn_mask
    g = torch.Generator(device=dev).manual_seed(4)
    bw, n, c, heads = 512 * TRAIN_BATCH, 49, 128, 4
    mask = shifted_window_attn_mask(112, 224, 7, 3, dev)
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

    return kernel_phase("window_attention_bwd", f"K1 bwd stage 1 ({bw},{n},{c})/{heads} masked",
                        window_attention_bwd, plain, make, library, cost, relative=True)


def ordered_bwd_phase(dev):
    """K2 backward, with the table, at the train step's shape."""
    from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention_bwd,
                                                             plain_ordered_attention_bwd)
    g = torch.Generator(device=dev).manual_seed(5)
    bw, n, c, heads, e = 392 * TRAIN_BATCH, 64, 512, 8, 128
    idx = torch.randint(0, e, (bw, n), generator=g, device=dev, dtype=torch.int32)
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

    return kernel_phase("ordered_attention_bwd", f"K2 bwd ({bw},{n},{c})/{heads} with table",
                        ordered_attention_bwd, plain_ordered_attention_bwd, make, library, cost,
                        relative=True)


def depthwise_bwd_phase(dev, dxdw: bool):
    """K3 dxdw (or dw alone) at the train step's FF shape."""
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
    return kernel_phase("depthwise_conv2d_dw", f"K3 dw {shape} 5x5", depthwise_dw,
                        lambda x, dout, w: plain_depthwise_dw(x, dout, 5, 5), make, library,
                        cost, relative=True)


def kernel_phase(kernel, name, fn, plain, make, library, cost, relative=False) -> dict:
    """Check ``fn`` against ``plain`` in f32 and bf16 (each output: within
    F32_TOL, relative to max(1, max |plain|) when ``relative``, or BF16_REL
    of that); time both and the library yardstick in bf16."""
    from mde_tpu_torch.ops import kernels
    result = {"phase": name, "kernel": kernel}
    for dtype in (torch.float32, torch.bfloat16):
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
    result["plain_ms"] = time_ms(lambda: plain(*args), iters=3, warmup=1)
    result["library_ms"] = time_ms(library(args))
    b, ops = cost(args, outs)
    result["bound_ms"], result["bound_by"] = bound(b, ops)
    result["bytes"], result["flops"] = b, ops
    log(f"{name} bf16: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, "
        f"library {result['library_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}: {b / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
    torch.cuda.empty_cache()
    return result


class IndexReplay:
    """Record the depth-index maps the flagship's head quantises on the
    card, and hand the same maps to a later run on the CPU, counting where
    the CPU's own maps differ (a bucket rounded the other way)."""

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
            own, card = self.real(logit, num_emb), next(maps).cpu()
            self.flips.append(int((own != card).sum()))
            return card
        self.module._quantize_logit = quantize

    def restore(self):
        self.module._quantize_logit = self.real


def model_f32_check(dev) -> None:
    """Full-width f32 forward at batch 1: the card against the CPU."""
    from mde_tpu_torch.models import build_model
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 352, 704, 3).astype(np.float32))
    replay = IndexReplay()
    try:
        replay.record()
        model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0)
        with torch.no_grad():
            out, outs = model(x.to(dev))
        torch.cuda.synchronize()
        gpu_outs = [o.cpu() for o in outs]
        del model, out, outs
        cpu_model = build_model(FLAGSHIP, 0.001, 80.0, device="cpu", seed=0)
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


def model_bf16_run(dev) -> dict:
    """Full-width bf16 serving at batch 8: one counted call, then timing."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.serve import Predictor
    model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16)
    predictor = Predictor(model)
    images = torch.from_numpy(
        np.random.RandomState(1).rand(BATCH, 352, 704, 3).astype(np.float32)).to(dev)
    predictor.predict(images)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    pred = predictor.predict(images)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    log(f"flagship bf16 batch {BATCH} serving launches: {counts}")
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update(window_attention=24, ordered_attention=6, depthwise_conv2d=6)
    if counts != expect:
        raise RuntimeError(f"expected {expect} kernel launches per forward, got {counts}")
    if pred.shape != (BATCH, 352, 704, 1) or not torch.isfinite(pred).all() or pred.min() < 0:
        raise RuntimeError(f"bad prediction: {tuple(pred.shape)}")
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor.predict(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"flagship bf16 batch {BATCH} at 352x704 (resized to 448x896): "
        f"{BATCH / float(np.median(times)):.2f} img/s (median of {len(times)} calls, "
        f"{[round(t * 1e3, 2) for t in times]} ms), peak memory {peak / 2 ** 30:.2f} GiB, "
        f"depth range [{pred.min().item():.3f}, {pred.max().item():.3f}] m")
    profile_call(lambda: predictor.predict(images))
    return counts


def train_batch(size: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(size, 352, 704, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 60.0, (size, 352, 704, 1)).astype(np.float32)}


def one_train_step(dev, batch: dict, **overrides):
    """One train step of a fresh flagship (seed 0): (logs, gradients, state
    dict), all on the CPU."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step
    model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, **overrides)
    state = TrainState.create(model, TRAIN_OPT, TRAIN_TOTAL_STEPS)
    grads = {}
    update = state.optimizer.update

    def keep(g):
        grads.update({n: t.detach().cpu() for n, t in g.items()})
        update(g)

    state.optimizer.update = keep
    _, logs = make_train_step(TRAIN_OPT, 0.001, 80.0)(state, batch)
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
    (logs, grads, weights), (ref_logs, ref_grads, ref_weights) = card, cpu
    log(f"flagship f32 train step batch 1: card {logs}, CPU {ref_logs}; index flips per "
        f"repeat {replay.flips} (the CPU run was fed the card's indices)")
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
        raise RuntimeError(f"flagship f32 train step on the card disagrees with the CPU "
                           f"(logs {bad})")


def train_bf16_run(dev) -> dict:
    """Full-width bf16 train step at batch 4: one counted step, timing, one
    profiled step, then one recomputing run. Returns the counted launches."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.ops import kernels
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(TRAIN_BATCH, 3).items()}
    step = make_train_step(TRAIN_OPT, 0.001, 80.0)
    generator = torch.Generator(device=dev).manual_seed(0)
    counts = None
    for use_checkpoint in (False, True):
        model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0, dtype=torch.bfloat16,
                            use_checkpoint=use_checkpoint)
        state = TrainState.create(model, TRAIN_OPT, TRAIN_TOTAL_STEPS)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        _, logs = step(state, batch, generator)
        torch.cuda.synchronize()
        run = dict(kernels.launch_counts)
        tag = f"use_checkpoint={use_checkpoint}"
        log(f"flagship bf16 train step batch {TRAIN_BATCH} ({tag}) launches: {run}")
        expect = CHECKPOINT_LAUNCHES if use_checkpoint else TRAIN_LAUNCHES
        if run != expect:
            raise RuntimeError(f"expected {expect} kernel launches per train step, got {run}")
        logs = {k: float(v) for k, v in logs.items()}
        moved = sum(not torch.equal(p.detach(), before[n])
                    for n, p in model.named_parameters())
        log(f"  logs of the first step: {logs}; {moved} of {len(before)} parameters moved")
        if not all(np.isfinite(v) for v in logs.values()) or moved == 0:
            raise RuntimeError(f"bad train step: logs {logs}, {moved} parameters moved")
        del before
        times = []
        for i in range(7 if not use_checkpoint else 3):
            t0 = time.perf_counter()
            _, logs = step(state, batch, generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        timed = times[2:] if not use_checkpoint else times[1:]
        peak = torch.cuda.max_memory_allocated()
        log(f"flagship bf16 train step batch {TRAIN_BATCH} at 352x704 (resized to 448x896, "
            f"{tag}): {TRAIN_BATCH / float(np.median(timed)):.2f} img/s (median of "
            f"{len(timed)} steps after {len(times) - len(timed) + 1} warm-up, "
            f"{[round(t * 1e3, 2) for t in timed]} ms), peak memory {peak / 2 ** 30:.2f} GiB, "
            f"loss {float(logs['loss']):.4f}")
        if not use_checkpoint:
            counts = run
            profile_call(lambda: step(state, batch, generator))
        del state, model
        torch.cuda.empty_cache()
    return counts


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
    for ms, count, key in sorted(rows, reverse=True)[:25]:
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<4d} {key[:110]}")


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
    for line in kernels.ptxas_report().splitlines():
        if line.startswith("==") or "Compiling entry" in line or "registers" in line:
            log(line.strip())
    log(f"dynamic shared memory per block: K1 {kernels.head_smem_bytes(49, 32)} B "
        f"(N 49, head dim 32), K2 {kernels.head_smem_bytes(64, 64, 255 + 64)} B "
        f"(N 64, head dim 64, table and indices), K1 bwd "
        f"{kernels.head_smem_bytes(49, 32, 49 * 49, backward=True)} B, K2 bwd "
        f"{kernels.head_smem_bytes(64, 64, 2 * 255 + 64, backward=True)} B, K3 none")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [window_phase("stage 1", 512 * BATCH, 128, 4, 512, False, dev),
              window_phase("stage 1", 512 * BATCH, 128, 4, 512, True, dev),
              window_phase("stage 3", 32 * BATCH, 512, 16, 32, True, dev),
              ordered_phase(True, dev), ordered_phase(False, dev),
              depthwise_phase(dev),
              window_bwd_phase(dev), ordered_bwd_phase(dev),
              depthwise_bwd_phase(dev, dxdw=True), depthwise_bwd_phase(dev, dxdw=False)]
    torch.cuda.empty_cache()

    model_f32_check(dev)
    torch.cuda.empty_cache()
    model_bf16_run(dev)
    torch.cuda.empty_cache()
    train_f32_check(dev)
    torch.cuda.empty_cache()
    counts = train_bf16_run(dev)

    # the line reports each kernel at its main-path shape in bf16 (K1 at
    # stage 1 with the shift mask, K2 with the table) and its launches in
    # one bf16 train step
    report = {p["kernel"]: p for p in (phases[1], phases[3], phases[5], *phases[6:])}
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": counts[name],
        "max_abs_err": p["max_abs_err_bf16"], "ms": p["ms"], "plain_ms": p["plain_ms"],
        "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "library_ms": p["library_ms"]} for name, p in report.items()]}
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
