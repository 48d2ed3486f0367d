"""Depth evaluation metrics and eval-crop masks (``mde_tpu/core/metrics.py``):
the Garg / Eigen crops and the nine standard errors per image, as masked
means over static shapes."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

METRIC_NAMES = ("a1", "a2", "a3", "abs_rel", "sq_rel", "rmse", "rmse_log", "silog", "log_10")

# Garg / Eigen crop fractions (rows top, bottom; columns left, right)
GARG_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)
EIGEN_CROP_KITTI = (0.3324324, 0.91351351, 0.0359477, 0.96405229)
EIGEN_CROP_NYU = (45, 471, 41, 601)  # absolute rows and columns


def eval_mask(opt_eval, shape: Tuple[int, int], data_type: str) -> np.ndarray:
    """Boolean (H, W) eval region for a ground-truth map of ``shape``.
    ``opt_eval`` is the config's ``eval`` section (``garg_crop`` /
    ``eigen_crop``)."""
    gt_height, gt_width = shape
    mask = np.zeros((gt_height, gt_width), dtype=bool)
    if opt_eval["garg_crop"]:
        t, b, l, r = GARG_CROP
        mask[int(t * gt_height):int(b * gt_height), int(l * gt_width):int(r * gt_width)] = True
    elif opt_eval["eigen_crop"]:
        if data_type in ("KITTI", "ONLINE"):
            t, b, l, r = EIGEN_CROP_KITTI
            mask[int(t * gt_height):int(b * gt_height),
                 int(l * gt_width):int(r * gt_width)] = True
        elif data_type == "NYU":
            t, b, l, r = EIGEN_CROP_NYU
            mask[t:b, l:r] = True
        else:
            raise ValueError(f"Unsupported data_type {data_type}.")
    else:
        raise ValueError("Unsupported crop configuration.")
    return mask


def compute_errors_per_image(gt: torch.Tensor, pred: torch.Tensor,
                             mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The nine metrics for each image of a batch, each a (B,) tensor, over
    the pixels of ``mask`` (validity and eval crop); ``count`` is each
    image's number of such pixels. ``silog`` is the metric (x100), not the
    loss. An image with no valid pixel gets well-defined placeholder values:
    the caller leaves it out."""
    b = gt.shape[0]
    mask = mask.reshape(b, -1).float()
    gt, pred = gt.reshape(b, -1), pred.reshape(b, -1)
    count = mask.sum(dim=1)
    denom = count.clamp_min(1.0)
    one = torch.ones((), dtype=gt.dtype, device=gt.device)
    gt_safe = torch.where(mask > 0, gt, one)
    pred_safe = torch.where(mask > 0, pred, one)

    def mmean(x):
        return (x * mask).sum(dim=1) / denom

    thresh = torch.maximum(gt_safe / pred_safe, pred_safe / gt_safe)
    diff = gt_safe - pred_safe
    log_gt, log_pred = torch.log(gt_safe), torch.log(pred_safe)
    err = log_pred - log_gt
    return dict(
        a1=mmean((thresh < 1.25).float()),
        a2=mmean((thresh < 1.25 ** 2).float()),
        a3=mmean((thresh < 1.25 ** 3).float()),
        abs_rel=mmean(diff.abs() / gt_safe),
        sq_rel=mmean(diff ** 2 / gt_safe),
        rmse=torch.sqrt(mmean(diff ** 2)),
        rmse_log=torch.sqrt(mmean((log_gt - log_pred) ** 2)),
        silog=torch.sqrt((mmean(err ** 2) - mmean(err) ** 2).clamp_min(0.0)) * 100,
        log_10=mmean((torch.log10(gt_safe) - torch.log10(pred_safe)).abs()),
        count=count)
