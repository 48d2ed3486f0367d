"""Model FLOPs of ``oda_conv``'s forward pass, an image, counted from its
shapes as the flagship's are (matrix products and convolutions, 2 FLOPs a
multiply-accumulate): the Swin-L/384 window-12 encoder at the input
resized to multiples of 384, and the conv decoder at widths (c/8, c/4,
c/2, c). 0.5117e12 at 352x704 (resized to 384x768).
"""

from __future__ import annotations

from typing import Tuple

from .flagship import swin_flops


def resize_policy(h: int, w: int) -> Tuple[int, int]:
    return (max(384, round(h / 384) * 384), max(384, round(w / 384) * 384))


def forward_flops(model: dict, h: int, w: int, max_depth: float = 80.0) -> float:
    h, w = resize_policy(h, w)
    ek = dict(embed_dim=192, depths=(2, 2, 18, 2), window_size=12)
    ek.update(model.get("encoder_kwargs") or {})
    e = ek["embed_dim"]
    fl = swin_flops(h, w, e, ek["depths"], ek["window_size"])
    c = model["decoder_channels"]
    oc = [c // 8, c // 4, c // 2, c]
    n = [(h // 4 >> i) * (w // 4 >> i) for i in range(4)]  # 1/4 .. 1/32
    enc = [e << i for i in range(4)]

    def conv(cin, cout, k, pixels):
        return 2 * k * k * cin * cout * pixels

    # block32 .. block8: two 3x3 ConvBNs, upsample, a 1x1 ConvBN to the next width
    cin = enc[3]
    for s in (3, 2, 1):
        fl += conv(cin, oc[s], 3, n[s]) + conv(oc[s], oc[s], 3, n[s])
        fl += conv(oc[s], oc[s - 1], 1, n[s - 1])
        cin = oc[s - 1] + enc[s - 1]
    # block4: two 3x3 ConvBNs at 1/4; block2: a 3x3 ConvBN and the 1x1 head at 1/2
    fl += conv(cin, oc[0], 3, n[0]) + conv(oc[0], oc[0], 3, n[0])
    fl += conv(oc[0], oc[0], 3, 4 * n[0]) + conv(oc[0], 1, 1, 4 * n[0])
    return float(fl)
