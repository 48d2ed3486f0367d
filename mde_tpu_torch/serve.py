"""The entry point that serves: depth maps for a batch of images.

Mirrors the compute of ``mde_tpu.train.driver.Trainer.predict``: forward in
eval mode, take the last map, resize it back to the input with
align_corners, clip at 0. ``train.driver.Trainer.predict`` runs it over a
dataset's split and writes the uint16 PNGs.

Under a ``torch.profiler`` profile a call is the span ``mde.serve.predict``
(counter ``images``) over ``mde.serve.h2d`` (the batch made on the
model's device; counter ``h2d_bytes`` where it came from elsewhere),
``mde.serve.forward`` and ``mde.serve.resize`` (``utils.profiling``).
"""

from __future__ import annotations

import torch
from torch import nn

from .ops.resize import resize_bilinear
from .utils.profiling import count, span


class Predictor:
    def __init__(self, model: nn.Module):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def predict(self, images) -> torch.Tensor:
        """images: (B, H, W, 3) f32 array or tensor -> (B, H, W, 1) f32 depth
        on the model's device."""
        with span("mde.serve.predict"):
            with span("mde.serve.h2d"):
                x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
                if not (torch.is_tensor(images) and images.device == x.device):
                    count("h2d_bytes", x.nbytes)
            count("images", x.shape[0])
            with span("mde.serve.forward"):
                # a model returns its map alone (NewCRFs) or first in a tuple
                # (``mde_tpu/train/driver.py:242-243``)
                out = self.model(x)
                pred = out[0] if isinstance(out, tuple) else out
            with span("mde.serve.resize"):
                pred = resize_bilinear(pred, (x.shape[1], x.shape[2]), align_corners=True)
                return pred.clamp_min(0.0)
