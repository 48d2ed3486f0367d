"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the port's
   CUDA kernels from ``mde_tpu_torch/ops/kernels/csrc`` with ``nvcc`` for
   sm_90a and prints each kernel's registers and shared memory.
2. Kernel phases: each kernel against its plain PyTorch version on the card
   at the flagship's main-path shapes (batch 8, 448x896), in bf16 and in f32
   with TF32 off; its time (CUDA events), the plain version's, one PyTorch
   call's as a yardstick, and the least time the card could take (bytes over
   3.35 TB/s, operations over the 989 TFLOP/s bf16 peak).
3. The slice at full width: the flagship ``oda2_red_order_swin2`` (Swin-B,
   red33 neck, ordered head) with seeded random weights. In f32 at batch 1
   the card's forward is held against the same model on the CPU (plain
   versions, fed the card's index maps so that a flipped depth bucket cannot
   hide a fault; flips are counted). In bf16 at batch 8 ``Predictor.predict``
   runs once on 352x704 images with every launch count at 0 before and
   exactly 24 K1, 6 K2 and 6 K3 launches after; then it is timed.

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
BATCH = 8
F32_TOL = 1e-5
# bf16 tolerance relative to max(1, max |plain|); see tests/test_torch_port_gpu.py
BF16_REL = {"window_attention": 3e-2, "ordered_attention": 3e-2, "depthwise_conv2d": 5e-2}
# f32 card vs CPU forward, depth in metres (maps scaled by max_depth 80)
MODEL_F32_TOL = 1e-2
SOURCES = {
    "window_attention": ("mde_tpu_torch/ops/kernels/csrc/window_attention.cu",
                         "mde_tpu/ops/pallas/window_attention.py:139"),
    "ordered_attention": ("mde_tpu_torch/ops/kernels/csrc/ordered_attention.cu",
                          "mde_tpu/ops/pallas/ordered_attention.py:254"),
    "depthwise_conv2d": ("mde_tpu_torch/ops/kernels/csrc/depthwise.cu",
                         "mde_tpu/ops/pallas/depthwise.py:405"),
}
FLAGSHIP = {"name": "oda2_red_order_swin2", "encoder_type": "base", "dec_dim": 512,
            "num_heads": 8, "num_repeats": 3, "num_emb": 128, "window_size": 8,
            "neck_type": "red33"}


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
        return (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, mask, heads,
                (c // heads) ** -0.5)

    def library(args):
        q, k, v = (t.reshape(bw, n, heads, c // heads).transpose(1, 2) for t in args[:3])
        add = bias[None] if mask is None else bias[None] + mask[:, None]
        add = add.expand(bw // add.shape[0], *add.shape).reshape(bw, heads, n, n)
        add = add.to(q.dtype).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                                      scale=args[-1])

    def cost(args, out):
        return nbytes(*args[:5], out), 4 * bw * n * n * c

    name = f"K1 {stage} ({bw},{n},{c})/{heads}{' masked' if masked else ''}"
    return kernel_phase("window_attention", name, window_attention, plain_window_attention,
                        make, library, cost)


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
        add = None
        if table is not None:
            rel = idx[:, :, None].long() - idx[:, None, :].long() + e - 1
            add = table.t()[:, rel].permute(1, 0, 2, 3).to(q.dtype).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                                      scale=args[-2])

    def cost(args, out):
        return nbytes(*args[:3], idx if with_table else None, table, out), 4 * bw * n * n * c

    name = f"K2 ({bw},{n},{c})/{heads} {'with table' if with_table else 'bias-free'}"
    return kernel_phase("ordered_attention", name, ordered_attention, plain_ordered_attention,
                        make, library, cost)


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

    def cost(args, out):
        return nbytes(*args, out), 2 * out.numel() * 25

    return kernel_phase("depthwise_conv2d", f"K3 {shape} 5x5", depthwise_conv2d,
                        plain_depthwise_conv2d, make, library, cost)


def kernel_phase(kernel, name, fn, plain, make, library, cost) -> dict:
    """Check ``fn`` against ``plain`` in f32 and bf16; time both and the
    library yardstick in bf16."""
    from mde_tpu_torch.ops import kernels
    result = {"phase": name, "kernel": kernel}
    for dtype in (torch.float32, torch.bfloat16):
        args = make(dtype)
        before = kernels.launch_counts[kernel]
        out = fn(*args)
        torch.cuda.synchronize()
        if kernels.launch_counts[kernel] != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch its kernel")
        ref = plain(*args)
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        tol = F32_TOL if dtype == torch.float32 else BF16_REL[kernel] * scale
        tag = "f32" if dtype == torch.float32 else "bf16"
        log(f"{name} {tag}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
        if not (torch.isfinite(out.float()).all() and err <= tol):
            raise RuntimeError(f"{name} {tag}: kernel disagrees with its plain version")
        result[f"max_abs_err_{tag}"] = err
        del ref
    result["ms"] = time_ms(lambda: fn(*args))
    result["plain_ms"] = time_ms(lambda: plain(*args), iters=3, warmup=1)
    result["library_ms"] = time_ms(library(args))
    b, ops = cost(args, out)
    result["bound_ms"], result["bound_by"] = bound(b, ops)
    result["bytes"], result["flops"] = b, ops
    log(f"{name} bf16: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, "
        f"library {result['library_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}: {b / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
    return result


def model_f32_check(dev) -> None:
    """Full-width f32 forward at batch 1: the card against the CPU."""
    import mde_tpu_torch.models.oda2.red_order_swin2 as flagship
    from mde_tpu_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 352, 704, 3).astype(np.float32))
    seen = []
    real = flagship._quantize_logit

    def record(logit, num_emb):
        seen.append(real(logit, num_emb))
        return seen[-1]

    flagship._quantize_logit = record
    try:
        model = build_model(FLAGSHIP, 0.001, 80.0, device=dev, seed=0)
        with torch.no_grad():
            out, outs = model(x.to(dev))
        torch.cuda.synchronize()
        gpu_outs = [o.cpu() for o in outs]
        gpu_idx = [i.cpu() for i in seen]
        del model, out, outs
        cpu_model = build_model(FLAGSHIP, 0.001, 80.0, device="cpu", seed=0)
        cpu_idx = []

        def feed(logit, num_emb):
            cpu_idx.append(real(logit, num_emb))
            return gpu_idx[len(cpu_idx) - 1]

        flagship._quantize_logit = feed
        t0 = time.perf_counter()
        with torch.no_grad():
            _, ref_outs = cpu_model(x)
        log(f"flagship f32 CPU forward (plain versions): {time.perf_counter() - t0:.1f} s")
    finally:
        flagship._quantize_logit = real
    flips = [int((a != b).sum()) for a, b in zip(gpu_idx, cpu_idx)]
    errs = [(a - b).abs().max().item() for a, b in zip(gpu_outs, ref_outs)]
    log(f"flagship f32 batch 1, card vs CPU: max_abs_err per map {errs} m "
        f"(tolerance {MODEL_F32_TOL}); index flips per repeat {flips} of "
        f"{gpu_idx[0].numel()} (the CPU run was fed the card's indices)")
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
    log(f"flagship bf16 batch {BATCH} main-path launches: {counts}")
    if counts != {"window_attention": 24, "ordered_attention": 6, "depthwise_conv2d": 6}:
        raise RuntimeError(f"expected 24/6/6 kernel launches per forward, got {counts}")
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
        f"(N 64, head dim 64, table and indices), K3 none")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [window_phase("stage 1", 512 * BATCH, 128, 4, 512, False, dev),
              window_phase("stage 1", 512 * BATCH, 128, 4, 512, True, dev),
              window_phase("stage 3", 32 * BATCH, 512, 16, 32, True, dev),
              ordered_phase(True, dev), ordered_phase(False, dev),
              depthwise_phase(dev)]
    torch.cuda.empty_cache()

    model_f32_check(dev)
    torch.cuda.empty_cache()
    counts = model_bf16_run(dev)

    # the line reports each kernel at its main-path shape in bf16: K1 at
    # stage 1 with the shift mask, K2 with the table, K3
    report = {p["kernel"]: p for p in (phases[1], phases[3], phases[5])}
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
