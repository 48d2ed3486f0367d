"""Measure how far the tiny ODA2 siblings' and Luna models' maps on the card
sit from the CPU's, and what a planted kernel fault reads on the same
scale.

    python3 tools/sibling_bf16_gaps.py

Builds each of the eight tiny models of ``tests/test_torch_port_gpu.py``
(``SIBLINGS_TINY``: five siblings and three Luna models, the custom Swin of
``TINY_KW``, 2 images of 64x96) on the card (TF32 off, as in those tests)
and on the CPU from one seed, the CPU fed the card's index maps, and
prints the largest and the mean gap over all maps that the loss takes
(and the cls Luna model's bin centers; m, depth range 80 m) in f32 and
bf16. Then it runs the card forward again in each dtype
with one planted fault in a kernel's output (the CPU side unchanged) and
prints those gaps too:

- ``K1 head 0 dropped``: every window attention's first head zeroed;
- ``K1 scale x1.1``: every window attention run with its scale 10% high;
- ``K2 head 0 dropped``: every ordered attention's first head zeroed;
- ``K3 1/8 channels dropped``: every depthwise conv's first eighth of
  channels zeroed.

Ends with one JSON line of all readings. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import mde_tpu_torch.models.oda2.red_order_reg as red_order_reg  # noqa: E402
import mde_tpu_torch.ops.attention as attention  # noqa: E402
import mde_tpu_torch.ops.depthwise as depthwise  # noqa: E402
import mde_tpu_torch.ops.ordered_attention as ordered  # noqa: E402
from mde_tpu_torch.models import build_model  # noqa: E402
from mde_tpu_torch.ops import kernels  # noqa: E402
from mde_tpu_torch.train.step import default_adapter  # noqa: E402

MAX_DEPTH = 80.0
TINY_KW = dict(resize_to_multiple=False, use_checkpoint=False, encoder_kwargs=dict(
    embed_dim=16, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4))
# name -> (config extras, the faults on its path)
SIBLINGS_TINY = {
    "oda2_red_order_reg": (dict(num_repeats=2, num_emb=16, reduction_ratio=4),
                           ("K1 head 0 dropped", "K1 scale x1.1", "K3 1/8 channels dropped")),
    "oda2_red_order_cls": (dict(num_repeats=2, num_emb=16, reduction_ratio=4),
                           ("K1 head 0 dropped", "K1 scale x1.1", "K3 1/8 channels dropped")),
    "oda2_red_order_swin": (dict(num_repeats=2, num_emb=16, window_size=4),
                            ("K1 head 0 dropped", "K1 scale x1.1", "K2 head 0 dropped")),
    "oda2_red_reg": ({}, ("K1 head 0 dropped", "K1 scale x1.1")),
    "oda2_conv": ({}, ("K1 head 0 dropped", "K1 scale x1.1")),
    "oda2_luna_reg": (dict(num_aux=8, aux_dim=16), ("K1 head 0 dropped", "K1 scale x1.1")),
    "oda2_luna_cls": (dict(num_aux=8, aux_dim=16), ("K1 head 0 dropped", "K1 scale x1.1")),
    "oda2_red_luna_reg": (dict(num_aux=6, num_layers=2), ("K1 head 0 dropped",
                                                          "K1 scale x1.1"))}


def _drop_first(out: torch.Tensor, parts: int) -> torch.Tensor:
    out = out.clone()
    out[..., :out.shape[-1] // parts] = 0
    return out


def _faulted(fault: str):
    """(module, attribute, the faulted wrapper, the kernel it must launch)."""
    if fault.startswith("K1"):
        real = attention.window_attention
        if fault == "K1 head 0 dropped":
            def wrapper(qkv, bias, mask, num_heads, scale):
                return _drop_first(real(qkv, bias, mask, num_heads, scale), num_heads)
        else:
            def wrapper(qkv, bias, mask, num_heads, scale):
                return real(qkv, bias, mask, num_heads, scale * 1.1)
        return attention, "window_attention", wrapper, "window_attention"
    if fault.startswith("K2"):
        real = ordered.ordered_attention

        def wrapper(q, k, v, idx, table, num_heads, scale, num_emb):
            return _drop_first(real(q, k, v, idx, table, num_heads, scale, num_emb), num_heads)
        return ordered, "ordered_attention", wrapper, "ordered_attention"
    real = depthwise.depthwise_conv2d

    def wrapper(x, w):
        return _drop_first(real(x, w), 8)
    return depthwise, "depthwise_conv2d", wrapper, "depthwise_conv2d"


def _maps(out) -> tuple:
    """The maps the loss takes, and the cls bin centers."""
    maps, centers = default_adapter(out)
    return maps + (() if centers is None else (centers,))


def gap(name: str, dtype: torch.dtype, fault: str = "") -> list:
    """[the largest, the mean] |card - CPU| over a tiny sibling's maps, in
    metres."""
    extra, _ = SIBLINGS_TINY[name]
    cfg = dict(extra, name=name, encoder_type="custom", dec_dim=32, num_heads=4)
    x = torch.from_numpy(np.random.RandomState(12).rand(2, 64, 96, 3).astype(np.float32))
    real_quantize = red_order_reg._logit_to_indices
    seen, outs = [], []
    try:
        for dev in (torch.device("cuda"), torch.device("cpu")):
            if dev.type == "cuda":
                red_order_reg._logit_to_indices = (
                    lambda logit, e: seen.append(real_quantize(logit, e)) or seen[-1])
            else:
                replay = iter(list(seen))
                red_order_reg._logit_to_indices = lambda logit, e: next(replay).cpu()
            model = build_model(cfg, 0.001, MAX_DEPTH, device=dev, seed=13, dtype=dtype,
                                **TINY_KW)
            patch = _faulted(fault) if fault and dev.type == "cuda" else None
            if patch is not None:
                module, attr, wrapper, kernel = patch
                real = getattr(module, attr)
                setattr(module, attr, wrapper)
            kernels.reset_launch_counts()
            try:
                with torch.no_grad():
                    out = model(x.to(dev))
            finally:
                if patch is not None:
                    setattr(module, attr, real)
            if patch is not None and kernels.launch_counts[kernel] == 0:
                raise RuntimeError(f"{name}: {fault} is off the path")
            outs.append([m.float().cpu() for m in _maps(out)])
    finally:
        red_order_reg._logit_to_indices = real_quantize
    for a, b in zip(*outs):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"{name} {dtype} {fault}: a map of shape {tuple(a.shape)} "
                               f"against {tuple(b.shape)}, or not finite")
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(*outs)])
    return [diffs.max().item(), diffs.mean().item()]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    kernels.build()
    # f32 convs and matmuls in full f32, as the card tests run them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = {}
    for name, (_, faults) in SIBLINGS_TINY.items():
        row = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            row[tag] = gap(name, dtype)
            for fault in faults:
                row[f"{tag}, {fault}"] = gap(name, dtype, fault)
        readings[name] = row
        for key, (top, mean) in row.items():
            print(f"{name} {key}: max {top!r} m, mean {mean!r} m", flush=True)
    for tag in ("f32", "bf16"):
        sound = max(row[tag][0] for row in readings.values())
        faulted = min(v[0] for row in readings.values() for k, v in row.items()
                      if k.startswith(tag + ","))
        print(f"{tag}: largest sound gap {sound!r} m; smallest planted-fault gap {faulted!r} m")
    print(json.dumps({"max_depth": MAX_DEPTH, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
