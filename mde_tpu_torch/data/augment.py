"""Training augmentation on the card, batched over B (``mde_tpu/data/augment.py``).

Two steps. ``draw_params`` draws every random value of a batch from one
``torch.Generator`` on the batch's device; ``apply`` does everything after
the draws, with the JAX package's order of operations (``:116-172``):

* rotation: uniform angle in [-degree, +degree] about the image centre,
  bilinear for the image, nearest (half to even) for the depth, zero fill;
* random crop to (h, w); 50% left-right flip;
* clip to [0, 1], then gamma U(0.9, 1.1); brightness U(0.75, 1.25) NYU or
  U(0.9, 1.1) KITTI, times a colour U(0.9, 1.1) a channel, clipped;
* ``clip_depth`` zeroing; ImageNet normalisation;
* band masks (the reference's ``RandomMasking``), with ``drop_edge``'s
  union of kept bands.

Neither step reads anything back to the host, so the loader can queue a
batch's augmentation behind the train step that runs before it. Rotation,
crop and flip are one gather: each output pixel takes its rotated sample at
its place in the input frame, the same value as rotating the whole input
first and cropping after.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    out_height: int
    out_width: int
    degree: float = 0.0            # 0 disables rotation
    data_type: str = "KITTI"
    clip_depth: float = 1e9
    height_drop: Tuple[float, int] = (0.0, 0)
    width_drop: Tuple[float, int] = (0.0, 0)
    drop_edge: bool = False


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std as f32 tensors on ``device``, copied there
    once: a copy from the host each batch would wait for the card."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation of NHWC images in [0, 1]."""
    mean, std = _imagenet_stats(images.device)
    return (images - mean) / std


def normalize_eval_batch(images: torch.Tensor) -> torch.Tensor:
    """Eval path: clip to [0, 1], then normalise."""
    return normalize_images(images.clamp(0.0, 1.0))


def _rand_int(u: torch.Tensor, maxval_inclusive) -> torch.Tensor:
    """``random.randint(0, m)`` from a uniform draw ``u``: floor(u * (m + 1))."""
    return torch.floor(u * (maxval_inclusive + 1)).to(torch.int32)


def _band_counts(cfg: AugmentConfig) -> Tuple[int, int]:
    hc, wc = int(cfg.height_drop[1]), int(cfg.width_drop[1])
    if cfg.drop_edge:
        hc, wc = min(hc, 1), min(wc, 1)
    return max(hc, 0), max(wc, 0)


def _bands(u: torch.Tensor, size: int, frac: float, invert: bool):
    """(lengths, starts), each (B, count), of the bands from their draws
    ``u`` (B, count, 2): a band drops up to ``frac`` of ``size`` (keeps up
    to 1 - ``frac`` when ``invert``)."""
    max_len = int((size - 1) * ((1.0 - frac) if invert else frac))
    length = _rand_int(u[..., 0], max_len)
    return length, _rand_int(u[..., 1], size - length)


def draw_params(cfg: AugmentConfig, batch: int, in_hw: Tuple[int, int],
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every random value of a batch of ``batch`` inputs of ``in_hw``, drawn
    on the generator's device by one call: ``angle`` (degrees), ``crop_y``,
    ``crop_x``, ``flip``, ``gamma``, ``bright``, ``color`` (B, 3) and the
    bands' ``h_len``, ``h_start``, ``w_len``, ``w_start`` (B, count)."""
    hc, wc = _band_counts(cfg)
    u = torch.rand(batch, 9 + 2 * (hc + wc), generator=generator,
                   device=generator.device)
    bright_lo, bright_hi = (0.75, 1.25) if cfg.data_type.upper() == "NYU" else (0.9, 1.1)
    params = {
        "angle": u[:, 0] * (2 * cfg.degree) - cfg.degree,
        "crop_y": _rand_int(u[:, 1], in_hw[0] - cfg.out_height),
        "crop_x": _rand_int(u[:, 2], in_hw[1] - cfg.out_width),
        "flip": u[:, 3] < 0.5,
        "gamma": u[:, 4] * 0.2 + 0.9,
        "bright": u[:, 5] * (bright_hi - bright_lo) + bright_lo,
        "color": u[:, 6:9] * 0.2 + 0.9,
    }
    bands = u[:, 9:].reshape(batch, hc + wc, 2)
    params["h_len"], params["h_start"] = _bands(bands[:, :hc], cfg.out_height,
                                                cfg.height_drop[0], cfg.drop_edge)
    params["w_len"], params["w_start"] = _bands(bands[:, hc:], cfg.out_width,
                                                cfg.width_drop[0], cfg.drop_edge)
    return params


def _source_coords(cfg: AugmentConfig, params, in_hw):
    """Each output pixel's place in the input frame, (B, h, w) f32 rows and
    columns, after the crop and the flip."""
    h, w = cfg.out_height, cfg.out_width
    dev = params["crop_y"].device
    rows = params["crop_y"][:, None] + torch.arange(h, device=dev, dtype=torch.int32)
    j = torch.arange(w, device=dev, dtype=torch.int32)
    j = torch.where(params["flip"][:, None], w - 1 - j, j)
    cols = params["crop_x"][:, None] + j
    return rows[:, :, None].expand(-1, h, w), cols[:, None, :].expand(-1, h, w)


def _gather(images: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """images[b, yi, xi] for (B, h, w) indices inside the image."""
    b = torch.arange(images.shape[0], device=images.device)[:, None, None]
    return images[b, yi.long(), xi.long()]


def _rotate(images, depths, rows, cols, angle_deg):
    """Rotation about the input's centre by the inverse map (output to
    source, counter-clockwise), sampled at (rows, cols) of the input frame:
    bilinear for ``images`` (taps outside weighted 0), nearest for
    ``depths``, zero outside."""
    h, w = images.shape[1], images.shape[2]
    theta = (angle_deg * (math.pi / 180.0))[:, None, None]
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = rows.float() - cy
    xx = cols.float() - cx
    sy = cy + (cos * yy + sin * xx)
    sx = cx + (-sin * yy + cos * xx)

    def inside(yi, xi):
        return (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)

    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    image = 0.0
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            yi, xi = (y0 + dy).to(torch.int32), (x0 + dx).to(torch.int32)
            valid = inside(yi, xi)
            val = _gather(images, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
            image = image + (wgt_y * wgt_x * valid)[..., None] * val
    yi, xi = torch.round(sy).to(torch.int32), torch.round(sx).to(torch.int32)
    valid = inside(yi, xi)
    depth = _gather(depths, yi.clamp(0, h - 1), xi.clamp(0, w - 1)) * valid[..., None]
    return image, depth


def _band_mask(size: int, lengths, starts, invert: bool) -> torch.Tensor:
    """(B, size) keep-mask: 1 outside every band, or (``invert``) inside the
    one band."""
    iota = torch.arange(size, device=lengths.device)[None, :]
    mask = torch.zeros if invert else torch.ones
    out = mask(lengths.shape[0], size, device=lengths.device)
    for i in range(lengths.shape[1]):
        band = (iota >= starts[:, i:i + 1]) & (iota < starts[:, i:i + 1] + lengths[:, i:i + 1])
        out = band.float() if invert else out * (~band).float()
    return out


def apply(cfg: AugmentConfig, params: Dict[str, torch.Tensor], images: torch.Tensor,
          depths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, 3) f32 in [0, 1], depths (B, H, W, 1) in metres, on
    the device of ``params`` -> the augmented, normalised (B, h, w, 3) and
    (B, h, w, 1)."""
    in_hw = (images.shape[1], images.shape[2])
    rows, cols = _source_coords(cfg, params, in_hw)
    if cfg.degree > 0:
        image, depth = _rotate(images, depths, rows, cols, params["angle"])
    else:
        image, depth = _gather(images, rows, cols), _gather(depths, rows, cols)

    # the gamma in f64, rounded once to f32: the same bits on the card and
    # the CPU, whose f32 powf differ by up to 4 ulps
    gamma = params["gamma"][:, None, None, None].double()
    image = (image.clamp(0.0, 1.0).double() ** gamma).float()
    image = (image * params["bright"][:, None, None, None]
             * params["color"][:, None, None, :]).clamp(0.0, 1.0)
    depth = torch.where(depth > cfg.clip_depth, torch.zeros_like(depth), depth)
    image = normalize_images(image)

    hc, wc = _band_counts(cfg)
    if hc or wc:
        h, w = cfg.out_height, cfg.out_width
        mh = _band_mask(h, params["h_len"], params["h_start"], cfg.drop_edge)
        mw = _band_mask(w, params["w_len"], params["w_start"], cfg.drop_edge)
        if cfg.drop_edge:  # union of the kept bands
            mask = torch.maximum(mh[:, :, None], mw[:, None, :])
        else:
            mask = mh[:, :, None] * mw[:, None, :]
        image = image * mask[..., None]
        depth = depth * mask[..., None]
    return image, depth


def device_augment_batch(cfg: AugmentConfig, generator: torch.Generator,
                         images: torch.Tensor, depths: torch.Tensor):
    """``apply`` on a batch's ``draw_params``."""
    params = draw_params(cfg, images.shape[0], (images.shape[1], images.shape[2]), generator)
    return apply(cfg, params, images, depths)
