"""The frame that the ODA2 models share
(``mde_tpu/models/oda2/red_order_swin2.py`` and its siblings): a Swin
encoder behind the reference's input resize, and the parameter-free
upsample their decoders use."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.resize import resize_bilinear, upsample2d
from ..swin import swin_encoder


class Upsample2d(nn.Module):
    """Parameter-free bilinear x``scale`` upsample (align_corners)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2d(x, self.scale)


def _resize_policy(h: int, w: int, max_depth: float) -> Tuple[int, int]:
    """Input resize: KITTI (352, 704) -> (448, 896), (352, 1216) ->
    (448, 1536); NYU (480, 640) and (448, 608) -> (448, 672); otherwise each
    side to a multiple of 224 (ceil when max_depth > 40, else round)."""
    known = {(352, 704): (448, 896), (352, 1216): (448, 1536),
             (480, 640): (448, 672), (448, 608): (448, 672)}
    if (h, w) in known:
        return known[(h, w)]
    if max_depth > 40:
        return (max(224, -(-h // 224) * 224), max(224, -(-w // 224) * 224))
    return (max(224, round(h / 224) * 224), max(224, round(w / 224) * 224))


class SwinDepthModel(nn.Module):
    """The frame of the ODA2 models: a Swin encoder of ``encoder_type``
    (window 7, stochastic depth ``path_drop_prob``, each block recomputed
    in the backward pass with ``use_checkpoint``; ``encoder_kwargs``
    override), whose input is resized by ``_resize_policy`` when
    ``resize_to_multiple`` and cast to ``dtype``. A subclass adds its
    ``decoder`` and reads the encoder's maps from :meth:`features`."""

    def __init__(self, min_depth: float, max_depth: float, encoder_type: str,
                 path_drop_prob: float, use_checkpoint: bool, dtype: torch.dtype,
                 resize_to_multiple: bool, encoder_kwargs: Optional[dict]):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.dtype = dtype
        self.resize_to_multiple = resize_to_multiple
        kwargs = dict(window_size=7, path_drop_prob=path_drop_prob,
                      use_checkpoint=use_checkpoint)
        self.encoder = swin_encoder(encoder_type, **dict(kwargs, **(encoder_kwargs or {})))

    def features(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, ...]:
        if self.resize_to_multiple:
            x = resize_bilinear(x, _resize_policy(x.shape[1], x.shape[2], self.max_depth))
        return self.encoder(x.to(self.dtype), generator)
