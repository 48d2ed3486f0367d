"""Plain training of the reference models: the scale-invariant log loss,
the global-norm clip and AdamW under a one-cycle schedule, as the
configurations state them.

Loss: every output map is resized (align corners) to the ground truth;
over each image's valid pixels (min_depth < gt <= max_depth), with
d = log(max(pred, 1e-7)) - log(gt), alpha * sqrt(max(mean(d^2) - beta *
mean(d)^2, 1e-7)); the mean over the images, then over the maps.

Update: g scaled by max_norm / |g| where the global norm |g| >= max_norm;
mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2; u = mu / (1 - b1^t) /
(sqrt(nu / (1 - b2^t)) + eps) + wd * p; p -= lr(t - 1) * u, with lr the
one-cycle cosine schedule from peak / 25 up to the peak over the first
quarter of the steps and down to peak / 2500 at the end.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from .layers import resize, start_step

EPS = 1e-7


def silog(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, alpha: float,
          beta: float) -> torch.Tensor:
    b = pred.shape[0]
    pred, gt, mask = pred.reshape(b, -1), gt.reshape(b, -1), mask.reshape(b, -1)
    d = torch.log(pred.clamp_min(EPS)) - torch.log(torch.where(mask, gt, torch.ones_like(gt)))
    m = mask.float()
    n = m.sum(dim=1).clamp_min(1.0)
    d1 = (d * m).sum(dim=1) / n
    d2 = (d * d * m).sum(dim=1) / n
    return alpha * torch.sqrt((d2 - beta * d1 ** 2).clamp_min(EPS)).mean()


def depth_loss(outs: Sequence[torch.Tensor], gt: torch.Tensor, loss_opt: dict,
               min_depth: float, max_depth: float) -> torch.Tensor:
    mask = (gt > min_depth) & (gt <= max_depth)
    hw = gt.shape[1:3]
    terms = [silog(resize(o.float(), hw), gt, mask, float(loss_opt.get("alpha", 10.0)),
                   float(loss_opt.get("beta", 0.15))) for o in outs]
    return sum(terms) / len(terms)


def onecycle(total: int, peak: float, pct_start: float = 0.25, div: float = 25.0,
             final_div: float = 100.0):
    bounds = [0, int(pct_start * total), total]
    values = [peak / div, peak, peak / (div * final_div)]

    def lr(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2 * (
                    math.cos(math.pi * pct) + 1)
        return values[-1]

    return lr


class AdamW:
    def __init__(self, params: Dict[str, nn.Parameter], opt: dict, total_steps: int):
        o = opt["optimizer"]
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.b1, self.b2 = (float(b) for b in o.get("betas", (0.9, 0.999)))
        self.eps = float(o.get("eps", 1e-6))
        self.wd = float(o.get("weight_decay", 0.0))
        self.max_norm = float(opt.get("train", {}).get("grad_norm", 0.0) or 0.0)
        self.lr = onecycle(max(total_steps, 1), float(o["lr"]))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self) -> List[torch.Tensor]:
        """One step from the parameters' ``.grad``; returns the gradient the
        moments took (after the clip)."""
        g = [p.grad.float() if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.max_norm > 0:
            norm = torch.sqrt(sum((t.double() ** 2).sum() for t in g)).float()
            if norm >= self.max_norm:
                g = [t / norm * self.max_norm for t in g]
        t = self.count + 1
        lr = self.lr(self.count)
        for p, gi, mu, nu in zip(self.params, g, self.mu, self.nu):
            mu.mul_(self.b1).add_(gi, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(gi, gi, value=1 - self.b2)
            u = (mu / (1 - self.b1 ** t)) / (torch.sqrt(nu / (1 - self.b2 ** t)) + self.eps)
            p.add_(u + self.wd * p, alpha=-lr)
            p.grad = None
        self.count = t
        return g


def train_step(model: nn.Module, optimizer: AdamW, images: torch.Tensor, depths: torch.Tensor,
               opt: dict, min_depth: float, max_depth: float, generator) -> Dict:
    """One step in training mode; returns the loss and the clipped
    gradient the optimizer took."""
    model.train()
    start_step(model)
    out = model(images, generator)
    maps = out[1] if isinstance(out[1], (list, tuple)) else [out[0]]
    loss = depth_loss(maps, depths, opt["loss"], min_depth, max_depth)
    loss.backward()
    grads = optimizer.update()
    return {"loss": float(loss.detach()), "grads": grads}
