"""Model FLOPs of ``oda2_red_order_swin2``'s forward pass, an image:
multiply-accumulates as 2 FLOPs, matrix products and convolutions only
(elementwise, softmax, resize and normalisation terms are under 1% at the
flagship's shapes). Copied from the program's hand model
(``mde_tpu_torch/utils/flops.py``) with its resize policy, and extended
to encoder sizes given in ``encoder_kwargs``. 2.0107e12 at 352x704.
"""

from __future__ import annotations

from typing import Tuple

SWIN = {"base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
        "large": (192, (2, 2, 18, 2), (6, 12, 24, 48))}


def resize_policy(h: int, w: int, max_depth: float = 80.0) -> Tuple[int, int]:
    known = {(352, 704): (448, 896), (352, 1216): (448, 1536),
             (480, 640): (448, 672), (448, 608): (448, 672)}
    if (h, w) in known:
        return known[(h, w)]
    if max_depth > 40:
        return (max(224, -(-h // 224) * 224), max(224, -(-w // 224) * 224))
    return (max(224, round(h / 224) * 224), max(224, round(w / 224) * 224))


def swin_flops(h: int, w: int, embed: int, depths, window: int) -> float:
    """The Swin encoder at (h, w) after any resize: patch embedding; per
    block qkv 6NC^2, projection 2NC^2, MLP 16NC^2 and the attention's two
    products 4NMC (M tokens a window); patch merging 4C -> 2C."""
    hh, ww = h // 4, w // 4
    fl = 2.0 * (4 * 4 * 3) * embed * hh * ww
    c, m = embed, window * window
    for i, depth in enumerate(depths):
        n = hh * ww
        fl += depth * ((6 + 2 + 16) * n * c * c + 4 * n * m * c)
        if i < len(depths) - 1:
            fl += 2 * (n // 4) * (4 * c) * (2 * c)
            c *= 2
            hh, ww = hh // 2, ww // 2
    return fl


def encoder_sizes(model: dict):
    embed, depths, _ = SWIN.get(model["encoder_type"], (None, None, None))
    ek = model.get("encoder_kwargs") or {}
    return ek.get("embed_dim", embed), ek.get("depths", depths)


def forward_flops(model: dict, h: int, w: int, max_depth: float = 80.0) -> float:
    """An image at input (h, w), red33 neck."""
    if model.get("neck_type") != "red33":
        raise ValueError("counted for the red33 neck only")
    h, w = resize_policy(h, w, max_depth)
    embed, depths = encoder_sizes(model)
    d, reps = model["dec_dim"], model["num_repeats"]
    win = model.get("window_size", 8)
    h4, w4 = h // 4, w // 4
    fl = swin_flops(h, w, embed, depths, 7)
    # neck: two 3x3 ConvBNs at each scale, 1x1 fuse, dec_linear
    for i in range(4):
        n = (h4 >> i) * (w4 >> i)
        fl += 2 * 9 * (embed << i) * d * n + 2 * 9 * d * d * n
    n = h4 * w4
    fl += 2 * (4 * d) * d * n + 2 * d * d * n
    # head: (reps + 1) conv heads; reps blocks of 2 SA + 2 GLU-DWConv FF + linear
    fl += (reps + 1) * (2 * 9 * d * (d // 4) * n + 2 * 9 * (d // 4) ** 2 * n
                        + 2 * (d // 4) * n)
    sa = 6 * n * d * d + 4 * n * win * win * d + 2 * n * d * d
    hidden = 4 * d
    ff = 2 * n * d * (2 * hidden) + 2 * 25 * hidden * n + 2 * n * hidden * d
    fl += reps * (2 * sa + 2 * ff + 2 * n * d * d)
    return float(fl)
