"""The hand FLOP model of the flagship's forward pass
(``mde_tpu/utils/flops.py``), copied: the port imports nothing of the JAX
package.

Counts multiply-accumulates as 2 FLOPs, matmul and conv terms only
(elementwise, softmax, resize and normalization terms are <1% at flagship
shapes and are left out: a lower-bound estimate). All shape logic mirrors
``models/oda2/red_order_swin2.py`` and ``models/swin.py``, and the resize
is the port's ``_resize_policy``. ``chip_smoke.py`` divides it by the
serving phase's time to print TFLOP/s.
"""

from __future__ import annotations

from typing import Tuple

# Swin variants (embed_dim, depths, num_heads); window 7, mlp_ratio 4
_SWIN = {
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}


def _swin_encoder_flops(h: int, w: int, encoder_type: str,
                        window: int = 7) -> float:
    """Per-image forward FLOPs of the Swin encoder at post-resize (h, w)."""
    embed, depths, _heads = _SWIN[encoder_type]
    fl = 0.0
    # patch embed: 4x4 conv, stride 4, 3 -> embed
    h4, w4 = h // 4, w // 4
    fl += 2 * (4 * 4 * 3) * embed * (h4 * w4)
    c = embed
    hh, ww = h4, w4
    m = window * window
    for i, depth in enumerate(depths):
        n = hh * ww
        # per block: qkv 6NC^2 + proj 2NC^2 + mlp 16NC^2 + attention dots
        # 4NMC (QK^T and PV, M tokens per window; windows pad to multiples
        # of `window` — exact at flagship shapes)
        per_block = (6 + 2 + 16) * n * c * c + 4 * n * m * c
        fl += depth * per_block
        if i < len(depths) - 1:
            # patch merging: linear 4C -> 2C on N/4 tokens
            fl += 2 * (n // 4) * (4 * c) * (2 * c)
            c *= 2
            hh, ww = hh // 2, ww // 2
    return fl


def _neck_flops(h4: int, w4: int, enc_dims: Tuple[int, ...], dec_dim: int,
                neck_type: str) -> float:
    """red33 / red / fpn / segformer neck forward FLOPs (per image)."""
    fl = 0.0
    scales = [(h4, w4), (h4 // 2, w4 // 2), (h4 // 4, w4 // 4),
              (h4 // 8, w4 // 8)]
    if neck_type in ("red33", "red33r", "red33res"):
        for (hh, ww), cin in zip(scales, enc_dims):
            ch = dec_dim if neck_type != "red33r" else min(cin, dec_dim)
            n = hh * ww
            fl += 2 * 9 * cin * ch * n + 2 * 9 * ch * ch * n  # two 3x3 ConvBN
            if neck_type == "red33res":
                fl += 2 * cin * dec_dim * n  # 1x1 residual
        fl += 2 * (4 * dec_dim) * dec_dim * (h4 * w4)  # 1x1 enc_fuse
    elif neck_type == "red":
        for (hh, ww), cin in zip(scales, enc_dims):
            n = hh * ww
            fl += 2 * 9 * n * (cin * cin + cin * (dec_dim // 4)
                               + (dec_dim // 4) ** 2)
    elif neck_type == "segformer":
        for (hh, ww), cin in zip(scales, enc_dims):
            fl += 2 * cin * dec_dim * hh * ww
        fl += 2 * (4 * dec_dim) * dec_dim * (h4 * w4)
    else:  # fpn: 2x (3x3 dec_dim->dec_dim) per scale on concat inputs (approx)
        for (hh, ww), cin in zip(scales, enc_dims):
            n = hh * ww
            fl += 2 * 9 * n * ((cin + dec_dim) * dec_dim + dec_dim * dec_dim)
    # dec_linear: dec_dim -> dec_dim dense at 1/4 tokens
    fl += 2 * dec_dim * dec_dim * (h4 * w4)
    return fl


def _head_flops(h4: int, w4: int, dec_dim: int, num_repeats: int,
                num_heads: int, window: int, num_emb: int,
                bias_matmul: bool = False) -> float:
    """Ordered head forward FLOPs: (num_repeats + 1) conv heads +
    num_repeats OrderedSwinBlocks (2x SA + 2x DWConv-GLU FF + linear).

    ``bias_matmul``: count the one-hot Toeplitz bias matmuls of the JAX
    package's TPU kernel (``mde_tpu/ops/pallas/ordered_attention.py``).
    The port's K2 gathers the bias, as that kernel's fast path does, so the
    default leaves them out.
    """
    n = h4 * w4
    c = dec_dim
    fl = 0.0
    # conv heads: ConvBN C->C/4 (3x3), ConvBN C/4->C/4 (3x3), 1x1 -> 1
    per_head = (2 * 9 * c * (c // 4) * n + 2 * 9 * (c // 4) ** 2 * n
                + 2 * (c // 4) * n)
    fl += (num_repeats + 1) * per_head
    # per block: 2 SA + 2 FF + linear C^2
    m = window * window  # per-window tokens
    sa = 6 * n * c * c + 4 * n * m * c + 2 * n * c * c  # qkv + dots + proj
    if bias_matmul:
        # per window-pair: oh_q(N,E)@M(E,hE) + per-head (N,E)@(E,N)
        nw = n // m
        sa += nw * (2 * m * num_emb * num_heads * num_emb
                    + num_heads * 2 * m * num_emb * m)
    hidden = 4 * c
    ff = (2 * n * c * (2 * hidden)        # lin1 (GLU double width)
          + 2 * 25 * hidden * n           # 5x5 depthwise
          + 2 * n * hidden * c)           # lin3
    fl += num_repeats * (2 * sa + 2 * ff + 2 * n * c * c)
    return fl


def flagship_forward_flops(h: int, w: int, encoder_type: str = "base",
                           dec_dim: int = 512, num_repeats: int = 3,
                           num_heads: int = 8, window_size: int = 8,
                           num_emb: int = 128,
                           neck_type: str = "red33",
                           resize_to_multiple: bool = True) -> float:
    """Per-image forward FLOPs of ``oda2_red_order_swin2`` at input (h, w).

    Mirrors the resize policy (``_resize_policy``) when
    ``resize_to_multiple`` so the estimate matches what actually runs.
    """
    if resize_to_multiple:
        from ..models.oda2.base import _resize_policy
        h, w = _resize_policy(h, w, 80.0)
    embed = _SWIN[encoder_type][0]
    enc_dims = tuple(embed * 2 ** i for i in range(4))
    h4, w4 = h // 4, w // 4
    return (_swin_encoder_flops(h, w, encoder_type)
            + _neck_flops(h4, w4, enc_dims, dec_dim, neck_type)
            + _head_flops(h4, w4, dec_dim, num_repeats, num_heads,
                          window_size, num_emb))
