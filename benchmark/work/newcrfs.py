"""Model FLOPs of NeW CRFs' forward pass, an image, counted from its shapes
as the other configurations' are (matrix products and convolutions, 2 FLOPs
a multiply-accumulate), on the grids the model computes on: the image
zero-padded to patch multiples, each block's tokens to window multiples
(the attention's products and its qkv or qk and output projections run on
the padded tokens, the MLP on the map's own), odd maps padded before a
merge. 0.80174e12 at 352x1216 (large07), equal to ``FlopCounterMode`` over
the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

LARGE = dict(embed_dim=192, depths=(2, 2, 18, 2), in_channels=(192, 384, 768, 1536),
             crf_dims=(128, 256, 512, 1024))
POOL_SCALES = (1, 2, 3, 6)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _padded(h: int, w: int, r: int) -> int:
    return _ceil(h, r) * r * _ceil(w, r) * r


def _conv(cin: int, cout: int, k: int, pixels: int) -> int:
    return 2 * k * k * cin * cout * pixels


def _attention_block(h: int, w: int, c: int, r: int, proj_in: int) -> int:
    """A (shifted-)window block of width c on an h x w map: ``proj_in`` c x c
    input projections (3: qkv; 2: qk), the two products and the output
    projection on the padded tokens, the MLP (ratio 4) on the map's."""
    padded = _padded(h, w, r)
    return ((2 * proj_in + 2) * padded * c * c + 4 * padded * r * r * c
            + 16 * h * w * c * c)


def stage_maps(h: int, w: int, stages: int = 4) -> Sequence[Tuple[int, int]]:
    """The encoder's maps at strides 4 to 32."""
    maps = [(_ceil(h, 4), _ceil(w, 4))]
    for _ in range(stages - 1):
        maps.append((_ceil(maps[-1][0], 2), _ceil(maps[-1][1], 2)))
    return maps


def forward_flops(model: dict, h: int, w: int, max_depth: float = 80.0) -> float:
    version = model["version"]
    r = int(version[-2:])
    sizes = dict(model["encoder_kwargs"]) if version[:-2] == "custom" else LARGE
    embed, depths = sizes["embed_dim"], sizes["depths"]
    ins, dims = sizes["in_channels"], sizes["crf_dims"]
    maps = stage_maps(h, w)
    fl = _conv(3, embed, 4, maps[0][0] * maps[0][1])  # 4x4 patches at stride 4
    for i, depth in enumerate(depths):
        hh, ww = maps[i]
        c = embed * 2 ** i
        fl += depth * _attention_block(hh, ww, c, r, 3)
        if i < len(depths) - 1:
            fl += 2 * maps[i + 1][0] * maps[i + 1][1] * (4 * c) * (2 * c)
    # PSP: a 1x1 conv at each pooled size, the 3x3 bottleneck over the concatenation
    psp = dims[3] // 2
    h3, w3 = maps[3]
    fl += sum(_conv(ins[3], psp, 1, s * s) for s in POOL_SCALES)
    fl += _conv(ins[3] + len(POOL_SCALES) * psp, psp, 3, h3 * w3)
    # CRF stages, coarsest first: each v is the PSP's output or the shuffled
    # output of the stage before, at twice that stage's map
    v_dims = (dims[1] // 4, dims[2] // 4, dims[3] // 4, psp)
    v_map = maps[3]
    for k in (3, 2, 1, 0):
        hh, ww = maps[k]
        d = dims[k]
        if ins[k] != d:
            fl += _conv(ins[k], d, 3, hh * ww)
        if v_dims[k] != d:
            fl += _conv(v_dims[k], d, 3, v_map[0] * v_map[1])
        fl += 2 * _attention_block(hh, ww, d, 7, 2)
        v_map = (2 * hh, 2 * ww)
    fl += _conv(dims[0], 1, 3, maps[0][0] * maps[0][1])
    return float(fl)
