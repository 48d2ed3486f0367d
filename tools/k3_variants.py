"""Time design variants of K3, the port's depthwise conv kernels, on one card.

    python3 tools/k3_variants.py

Each variant is a copy of ``csrc/depthwise.cu`` (the forward) or
``csrc/depthwise_dxdw.cu`` (dx and dw), with ``csrc/depthwise_tile.cuh``,
and one choice of the tiled body changed by a text edit: the rows staged
between two barriers and the rows of the staging ring, the warps of a
block and the blocks an SM it is compiled for, the columns a thread owns.
Other variants leave one part of the work out to see what it costs (the
multiply-adds, the copies after the first rows, dw's or dx's half of the
backward); those give wrong results and are timed only. Every variant is built with ``nvcc`` into its own library under
``build/k3_variants/`` (``k1_variants.build``), loaded with ``ctypes`` and
called through the port's C entry point at the shapes ``chip_smoke.py``
times (bf16, 5x5): the forward at (8, 112, 224, 2048), dxdw at (4, 112, 224,
2048). Times are device ms per call (``chip_smoke.time_ms``), each variant
twice, in turns; "err" is the largest difference from the built kernel's
output. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from k1_variants import build, compare, edit  # noqa: E402
from mde_tpu_torch.ops import kernels  # noqa: E402

CSRC = kernels.CSRC
OUT = ROOT / "build" / "k3_variants"
HEADER = "depthwise_tile.cuh"

SYNC = "static constexpr int SYNC = K;"
RING = "static constexpr int RING = 2 * SYNC;"
COLS = "static constexpr int COLS = K == 7 ? 2 : 4;"


def header(sync: str = "K", ring: str = "2 * SYNC", cols: int = 4) -> str:
    src = (CSRC / HEADER).read_text()
    src = edit(src, SYNC, SYNC.replace("= K;", f"= {sync};"))
    src = edit(src, RING, RING.replace("2 * SYNC", ring))
    return edit(src, COLS, COLS.replace(": 4", f": {cols}"))


def fwd_variant(warps=8, min_blocks=2, no_compute=False, no_loads=False, **head) -> tuple:
    src = (CSRC / "depthwise.cu").read_text()
    src = edit(src, "constexpr int FWD_WARPS = 8;", f"constexpr int FWD_WARPS = {warps};")
    src = edit(src, "return k == 7 ? 1 : 2;", f"return k == 7 ? 1 : {min_blocks};")
    if no_compute:  # keep the loads: the first staged column becomes the output
        src = edit(src, "for (int j = 0; j < K; ++j) fma_pair(acc[(u - i + K) % K][c], xv[c + j], "
                        "w[i][j]);",
                   "for (int j = 0; j < 1; ++j) acc[(u - i + K) % K][c] = xv[c + j];")
    if no_loads:  # the rows of the prologue only
        src = edit(src, "for (int r = 0; r < SYNC; ++r) stage(p + RING - SYNC + r);",
                   "for (int r = 0; r < SYNC; ++r) if (p < 0) stage(p + RING - SYNC + r);")
    return src, header(**head)


def dxdw_variant(warps=8, blocks=1, dx_only=False, dw_only=False, no_loads=False,
                 **head) -> tuple:
    src = (CSRC / "depthwise_dxdw.cu").read_text()
    src = edit(src, "static constexpr int WARPS = K == 7 ? 4 : 8;",
               f"static constexpr int WARPS = K == 7 ? 4 : {warps};")
    src = edit(src, "__launch_bounds__((DxdwTile<T, K>::THREADS), 1)",
               f"__launch_bounds__((DxdwTile<T, K>::THREADS), {blocks})")
    if dx_only:
        src = edit(src, "for (int c = 0; c < COLS; ++c) fma_pair(dw[i][j], xv[c + j], "
                        "gr[(u - i + K) % K][c]);",
                   "for (int c = 0; c < 1; ++c) dw[i][j] = xv[c + j];")
    if dw_only:
        src = edit(src, "for (int j = 0; j < K; ++j) fma_pair(acc[(u + i) % K][c], "
                        "gv[c + K - 1 - j], w[i][j]);",
                   "for (int j = 0; j < 1; ++j) acc[(u + i) % K][c] = gv[c];")
    if no_loads:
        src = edit(src, "    dxdw_stage<T, K>(ring, gb, xb, s + S::RING - S::SYNC + r,",
                   "    if (s < 0) dxdw_stage<T, K>(ring, gb, xb, s + S::RING - S::SYNC + r,")
    return src, header(**head)


FWD = {"as built (8 warps, 4 columns, a barrier every 5 rows, ring 10, 2 blocks an SM)":
           fwd_variant(),
       "a barrier every row, ring 8": fwd_variant(sync="1", ring="8"),
       "ring 15": fwd_variant(ring="3 * SYNC"),
       "4 warps, 4 blocks an SM": fwd_variant(warps=4, min_blocks=4),
       "2 columns, 2 blocks an SM": fwd_variant(cols=2),
       "no multiply-adds (wrong)": fwd_variant(no_compute=True),
       "no copies after the first rows (wrong)": fwd_variant(no_loads=True)}
DXDW = {"as built (8 + 8 warps, 4 columns, a barrier every 5 rows, ring 10, 1 block an SM)":
            dxdw_variant(),
        "4 + 4 warps, 2 blocks an SM": dxdw_variant(warps=4, blocks=2),
        "a barrier every row, ring 8": dxdw_variant(sync="1", ring="8"),
        "ring 15": dxdw_variant(ring="3 * SYNC"),
        "2 columns (strips of 16)": dxdw_variant(cols=2),
        "dx alone (wrong)": dxdw_variant(dx_only=True),
        "dw alone (wrong)": dxdw_variant(dw_only=True),
        "no copies after the first rows (wrong)": dxdw_variant(no_loads=True)}


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    fwd = build(FWD, "fwd", HEADER, "tiled", OUT)
    dxdw = build(DXDW, "dxdw", HEADER, "tiled", OUT)
    bf16 = kernels.dtype_code(torch.empty(0, dtype=torch.bfloat16))

    b, h, w, c = cs.BATCH, 112, 224, 2048
    x = torch.randn(b, h, w, c, generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn(5, 5, c, generator=g, device=dev) * 0.2).to(torch.bfloat16)

    def call_fwd(lib, outs):
        return lib.mde_depthwise_conv2d(x.data_ptr(), wt.data_ptr(), outs[0].data_ptr(), b, h, w,
                                        c, 5, 5, 1, bf16, stream)

    compare(f"fwd ({b}, {h}, {w}, {c}) 5x5", fwd, call_fwd, lambda: (torch.empty_like(x),))
    del x

    b = cs.TRAIN_BATCH
    x, dout = (torch.randn(b, h, w, c, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(2))
    # room for the partials of any variant's strips
    part = torch.empty(b * w, 5, 5, c, device=dev)

    def call_dxdw(lib, outs):
        return lib.mde_depthwise_conv2d_dxdw(x.data_ptr(), dout.data_ptr(), wt.data_ptr(),
                                             outs[0].data_ptr(), part.data_ptr(),
                                             outs[1].data_ptr(), b, h, w, c, 5, 1, bf16, stream)

    compare(f"dxdw ({b}, {h}, {w}, {c}) 5x5", dxdw, call_dxdw,
            lambda: (torch.empty_like(x), torch.empty(5, 5, c, device=dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
