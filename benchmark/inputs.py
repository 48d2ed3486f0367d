"""What a run feeds the program and the reference, made from ``--seed``:
the weights, the images and the sparse depth. The same seed gives the
same bits on the same device.

Weights: one normal and one uniform draw over every tensor of the model,
on the device, in f32, each tensor cut from them and scaled to the
program's initialisation: dense weights and relative-position tables
truncated normal 0.02, convolutions lecun normal (truncated, variance
1/fan-in), depthwise taps normal with variance 2/k^2, the depth-bias
table -|r| u with u ~ U(0.01, 0.04) a head, norms one and zero, biases
zero, running statistics zero and one.

Images: KITTI-sized frames of ImageNet-normalised pixels, a smooth field
at 1/8 scale with pixel noise over it. Depth: a smooth field from 1 to
80 m, valid on a share ``depth_density`` of the pixels below the top
``sky_rows`` of each frame (a projected LiDAR sweep), 0 elsewhere.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of ``seed`` (any whole number)."""
    words = [seed % 2 ** 64] + [ord(ch) for ch in stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def make_weights(template: Dict[str, Tuple[tuple, torch.dtype]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A state dict for the (shape, dtype) of each name in ``template``; each
    tensor's values depend on the names and shapes only, not their order."""
    template = dict(sorted(template.items()))
    floats = [k for k, (_, dt) in template.items() if dt.is_floating_point]
    total = sum(math.prod(template[k][0]) for k in floats)
    g = generator(seed, "weights", device)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for key, (shape, dtype) in template.items():
        if not dtype.is_floating_point:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        size = math.prod(shape)
        n = normal[at:at + size].reshape(shape)
        u = uniform[at:at + size].reshape(shape)
        at += size
        out[key] = _init(key, shape, n, u)
    return out


def _init(key: str, shape: tuple, n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
        return torch.ones_like(n)
    if leaf in ("running_mean", "bias"):
        return torch.zeros_like(n)
    if leaf == "relative_position_bias_table" or (leaf == "weight" and len(shape) == 2):
        return torch.fmod(n, 2.0) * 0.02
    if leaf == "depth_embedding":
        e = (shape[0] + 1) // 2
        r = torch.arange(shape[0], device=n.device, dtype=torch.float32) - (e - 1)
        return -r.abs()[:, None] * (0.01 + 0.03 * u[0])[None, :]
    if leaf == "weight" and len(shape) == 4:
        if shape[1] == 1 and shape[0] > 1 and shape[2] > 1:  # depthwise taps
            return n * math.sqrt(2.0 / (shape[2] * shape[3]))
        fan_in = shape[1] * shape[2] * shape[3]
        return torch.fmod(n, 2.0) * math.sqrt(1.0 / fan_in)
    raise ValueError(f"no initialisation rule for {key} {tuple(shape)}")


def _smooth(shape_bchw, g: torch.Generator, device, coarse: int = 8) -> torch.Tensor:
    b, c, h, w = shape_bchw
    low = torch.rand(b, c, -(-h // coarse), -(-w // coarse), generator=g, device=device)
    return F.interpolate(low, size=(h, w), mode="bilinear", align_corners=True)


def make_images(count: int, batch: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(count, batch, h, w, 3) f32 normalised frames, every one distinct."""
    g = generator(seed, "images", device)
    x = 0.7 * _smooth((count * batch, 3, h, w), g, device)
    x = x + 0.3 * torch.rand(count * batch, 3, h, w, generator=g, device=device)
    mean = torch.tensor(MEAN, device=device)[:, None, None]
    std = torch.tensor(STD, device=device)[:, None, None]
    x = ((x - mean) / std).permute(0, 2, 3, 1)
    return x.reshape(count, batch, h, w, 3).contiguous()


def make_depths(count: int, batch: int, h: int, w: int, seed: int, device,
                density: float, sky_rows: float, max_depth: float) -> torch.Tensor:
    """(count, batch, h, w, 1) f32 sparse depth in metres, 0 where unknown."""
    g = generator(seed, "depths", device)
    field = 1.0 + (max_depth - 1.0) * _smooth((count * batch, 1, h, w), g, device, 16)
    keep = torch.rand(count * batch, 1, h, w, generator=g, device=device) < density
    keep[:, :, :int(sky_rows * h)] = False
    d = torch.where(keep, field, torch.zeros((), device=device))
    return d.permute(0, 2, 3, 1).reshape(count, batch, h, w, 1).contiguous()
