"""Training losses (``mde_tpu/train/loss.py``): SILog on every output map,
the log-depth gradient term, the chamfer bin loss, and ``DepthLoss``, which
combines them as the config's ``loss`` section says.

Masked means over static shapes, as the JAX versions compute them. Inside
a global-batch scope (``parallel.mesh.gspmd_scope``) every mean over the
batch is the global batch's, as JAX's GSPMD step computes it: each rank
sums its rows, the sums go over the ranks in one collective a term
(``core.dist.sum_over_ranks``), and every rank holds the global value.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import dist
from ..ops.resize import resize_bilinear

_EPS = 1e-7


def _batch_sums(*sums: torch.Tensor) -> List[torch.Tensor]:
    """Sums over this rank's rows -> sums over the global batch's."""
    return dist.sum_over_ranks(sums) if dist.global_batch() is not None else list(sums)


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of (B,) per-image values over the (global) batch."""
    scope = dist.global_batch()
    if scope is None:
        return x.mean()
    (total,) = dist.sum_over_ranks([x.sum()])
    return total / (x.shape[0] * scope.size)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp_min(1.0)


def silog_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               alpha: float = 10.0, beta: float = 0.15, per_image: bool = True) -> torch.Tensor:
    """Scale-invariant log loss ``alpha * sqrt(mean(d^2) - beta * mean(d)^2)``
    over valid pixels, d = log(pred) - log(gt); per image then averaged, or
    over the whole batch. pred/gt/mask: (B, H, W[, 1])."""
    b = pred.shape[0]
    pred, gt, mask = pred.reshape(b, -1), gt.reshape(b, -1), mask.reshape(b, -1)
    pred = pred.clamp_min(_EPS)
    gt_safe = torch.where(mask, gt, torch.ones_like(gt))
    d = torch.where(mask, torch.log(pred) - torch.log(gt_safe), torch.zeros_like(pred))
    if per_image:
        d2 = _masked_mean(d ** 2, mask, 1)
        d1 = _masked_mean(d, mask, 1)
        return alpha * _batch_mean(torch.sqrt((d2 - beta * d1 ** 2).clamp_min(_EPS)))
    m = mask.to(d.dtype)
    s2, s1, n = _batch_sums((d ** 2 * m).sum(), (d * m).sum(), m.sum())
    n = n.clamp_min(1.0)
    return alpha * torch.sqrt((s2 / n - beta * (s1 / n) ** 2).clamp_min(_EPS))


def sog_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gradient matching of log depth along W and H over valid neighbour
    pairs. pred/gt/mask: (B, H, W)."""
    b, h = pred.shape[0], pred.shape[1]
    lp = torch.log(pred.reshape(b, h, -1).clamp_min(_EPS))
    lg = torch.log(gt.reshape(b, h, -1).clamp_min(_EPS))
    mask = mask.reshape(b, h, -1)
    gx = (lp[:, :, 1:] - lp[:, :, :-1]) - (lg[:, :, 1:] - lg[:, :, :-1])
    mx = mask[:, :, 1:] & mask[:, :, :-1]
    gy = (lp[:, 1:, :] - lp[:, :-1, :]) - (lg[:, 1:, :] - lg[:, :-1, :])
    my = mask[:, 1:, :] & mask[:, :-1, :]
    mx, my = mx.to(gx.dtype), my.to(gy.dtype)
    sx, nx, sy, ny = _batch_sums((gx.abs() * mx).sum(), mx.sum(), (gy.abs() * my).sum(),
                                 my.sum())
    return sx / nx.clamp_min(1.0) + sy / ny.clamp_min(1.0)


def chamfer_bin_loss(bin_centers: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                     chunk: int = 4096) -> torch.Tensor:
    """Bidirectional chamfer distance between each image's bin centers
    (B, n_bins) and its set of valid ground-truth depths (B, H, W[, 1]).
    Pixels go through in chunks, so that no (B, pixels, bins) tensor is
    ever whole: the gt -> bin distances are summed, the bin -> gt ones kept
    as a running minimum."""
    b, nb = bin_centers.shape
    gt = gt.reshape(b, -1).float()
    mask = mask.reshape(b, -1).float()
    centers = bin_centers.float()
    big = torch.tensor(1e10, dtype=torch.float32, device=gt.device)
    sum_dgt = gt.new_zeros(b)
    cnt = gt.new_zeros(b)
    min_dbin = torch.full((b, nb), 1e10, dtype=torch.float32, device=gt.device)
    for start in range(0, gt.shape[1], chunk):
        g, m = gt[:, start:start + chunk], mask[:, start:start + chunk]
        dist2 = (g[:, :, None] - centers[:, None, :]) ** 2
        sum_dgt = sum_dgt + (dist2.min(dim=2).values * m).sum(dim=1)
        cnt = cnt + m.sum(dim=1)
        d_bin = torch.where(m[:, :, None] > 0, dist2, big).min(dim=1).values
        min_dbin = torch.minimum(min_dbin, d_bin)
    any_valid = cnt > 0
    zero = torch.zeros((), dtype=torch.float32, device=gt.device)
    loss_gt = torch.where(any_valid, sum_dgt / cnt.clamp_min(1.0), zero)
    loss_bin = torch.where(any_valid, min_dbin.mean(dim=1), zero)
    return _batch_mean(loss_gt + loss_bin)


class DepthLoss:
    """The config-driven loss of every model family: SILog on each output
    map after an align-corners resize to the ground truth; the maps are
    averaged uniformly, or the last at full weight and the earlier ones at
    ``oda_weight``; plus ``sog_weight`` times the gradient term on the last
    map and ``chamfer_weight`` times the chamfer bin loss."""

    def __init__(self, opt_loss, min_depth: float, max_depth: float):
        self.alpha = float(opt_loss.get("alpha", 10.0))
        self.beta = float(opt_loss.get("beta", 0.15))
        self.per_image = bool(opt_loss.get("per_image", True))
        self.si_weight = float(opt_loss.get("si_weight", 1.0))
        self.sog_weight = float(opt_loss.get("sog_weight", 0.0))
        self.chamfer_weight = float(opt_loss.get("chamfer_weight", 0.0))
        self.oda_weight = float(opt_loss.get("oda_weight", 0.0))
        self.min_depth = min_depth
        self.max_depth = max_depth

    def valid_mask(self, gt: torch.Tensor) -> torch.Tensor:
        return (gt > self.min_depth) & (gt <= self.max_depth)

    def __call__(self, outputs: Sequence[torch.Tensor], gt: torch.Tensor,
                 bin_centers: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """outputs: (B, h, w, 1) depth maps, the last the prediction; gt:
        (B, H, W, 1). Returns (total loss, logs)."""
        gt_hw = gt.shape[1:3]
        mask = self.valid_mask(gt)
        si_terms = [silog_loss(resize_bilinear(out, gt_hw, align_corners=True), gt, mask,
                               self.alpha, self.beta, self.per_image) for out in outputs]
        if len(si_terms) > 1 and self.oda_weight > 0:
            si = si_terms[-1] + self.oda_weight * sum(si_terms[:-1]) / (len(si_terms) - 1)
        else:
            si = sum(si_terms) / len(si_terms)
        total = self.si_weight * si
        logs = {"loss_si": si}
        if self.sog_weight > 0:
            pred = resize_bilinear(outputs[-1], gt_hw, align_corners=True)
            sog = sog_loss(pred[..., 0], gt[..., 0], mask[..., 0])
            total = total + self.sog_weight * sog
            logs["loss_sog"] = sog
        if self.chamfer_weight > 0 and bin_centers is not None:
            cham = chamfer_bin_loss(bin_centers, gt, mask)
            total = total + self.chamfer_weight * cham
            logs["loss_chamfer"] = cham
        logs["loss"] = total
        return total, logs
