"""Depth colouring (``mde_tpu/utils/visualize.py:16-36``; reference
``utils/visualize_utils.py``), with numpy only: the card's machine has no
matplotlib. ``colorize`` maps a depth map through matplotlib's ``magma``
colour map, whose 256 colours are stored here as the bytes matplotlib gives
for them, so the image is the JAX package's byte for byte.
``save_visualizations`` writes a batch of them with the port's PNG codec
(``data/png.py``; the card's machine has no Pillow either).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.png import write_png

# matplotlib's "magma" at N = 256: (lut * 255).astype(uint8), RGB, alpha 255
_MAGMA = np.frombuffer(bytes.fromhex(
    "00000300000400000601000701010901010b02020d02020f03031104031304041505041706051907051b0806"
    "1d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31120d33140d35150e38160e3a170f3c18"
    "0f3f1a10411b10441c10461e10491f114b20114d2211502311522511552611572811592a115c2b115e2d1060"
    "2f1062301065321067341068350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f"
    "774810784a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e5d177e5e"
    "177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e816f1e81711f81731f81742081"
    "7621817721817922817a22817c23817e24817f24818125818225818426818526818727818928818a28818c29"
    "808d29808f2a80912a80922b80942b80952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4"
    "307da6317da7317da9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070d0416fd1426ed342"
    "6dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66e14c66e24d65e44e64e55063e65162e7"
    "5262e85461ea5560eb5660ec585fed595fee5b5eee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685b"
    "f56a5bf56c5bf66e5bf6705bf7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb84"
    "60fb8660fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6bfd9f6cfd"
    "a16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37bfeb57cfeb77dfeb97ffebb80"
    "febc82febe83fec085fec286fec488fec689fec78bfec98dfecb8efdcd90fdcf92fdd193fdd295fdd497fdd6"
    "98fdd89afdda9cfddc9dfddd9ffddfa1fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fc"
    "f1b3fcf3b5fcf5b7fbf7b9fbf9bbfbfabdfbfcbf"
), np.uint8).reshape(256, 3)
_CMAPS = {"magma": _MAGMA, "magma_r": _MAGMA[::-1]}


def colorize(depth: np.ndarray, vmin: Optional[float] = None,
             vmax: Optional[float] = None, cmap: str = "magma_r") -> np.ndarray:
    """(H, W[, 1]) depth -> (H, W, 4) uint8 RGBA; values outside [vmin,
    vmax] and non-finite ones white (reference ``:10-29``)."""
    if cmap not in _CMAPS:
        raise ValueError(f"colour map {cmap!r} is not ported (ported: {sorted(_CMAPS)})")
    value = np.asarray(depth, np.float32)
    if value.ndim == 3:
        value = value[..., 0]
    vmin = np.nanmin(value) if vmin is None else vmin
    vmax = np.nanmax(value) if vmax is None else vmax
    invalid = (value < vmin) | (value > vmax) | ~np.isfinite(value)

    if vmax != vmin:
        norm = (value - vmin) / (vmax - vmin)
    else:
        norm = value * 0.0
    # matplotlib's lookup: index floor(x * N), x == 1 into the last colour
    x = np.clip(norm, 0, 1) * 256
    x[x == 256] = 255
    with np.errstate(invalid="ignore"):
        index = np.nan_to_num(x, nan=0.0).astype(int)
    img = np.full(value.shape + (4,), 255, np.uint8)
    img[..., :3] = _CMAPS[cmap][index]
    img[invalid] = 255  # over/under-range -> white (reference behavior)
    return img


def save_visualizations(preds: np.ndarray, paths, out_dir: str, vmin: float = 0.0,
                        vmax: Optional[float] = None, cmap: str = "magma_r") -> None:
    """Save the colourised predictions under ``out_dir``, at the relative
    dataset paths (``.png`` appended where a path lacks it;
    ``mde_tpu/utils/visualize.py:38-50``)."""
    for pred, rel in zip(preds, paths):
        dst = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        write_png(dst if dst.endswith(".png") else dst + ".png",
                  colorize(pred, vmin=vmin, vmax=vmax, cmap=cmap))
