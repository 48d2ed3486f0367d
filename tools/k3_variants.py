"""Time design variants of K3, the port's depthwise conv kernels, on one card.

    python3 tools/k3_variants.py [fwd] [dxdw] [dw]

Each variant is a copy of ``csrc/depthwise.cu`` (the forward),
``csrc/depthwise_dxdw.cu`` (dx and dw) or ``csrc/depthwise_dw.cu`` (dw
alone), with ``csrc/depthwise_tile.cuh`` and ``csrc/depthwise_bwd_tile.cuh``,
and one choice of the tiled body changed by a text edit: the rows staged
between two barriers and the rows of the staging ring, the warps of a
block and the blocks an SM it is compiled for (or, for dw, held to by its
shared memory), the columns a thread owns.
Other variants leave one part of the work out to see what it costs (the
multiply-adds, the copies after the first rows, dw's or dx's half of the
backward); those give wrong results and are timed only. Every variant is built with ``nvcc`` into its own library under
``build/k3_variants/`` (``k1_variants.build``), loaded with ``ctypes`` and
called through the port's C entry point at the shapes ``chip_smoke.py``
times (bf16, 5x5): the forward at (8, 112, 224, 2048), dxdw and dw at (4,
112, 224, 2048). Times are device ms per call (``chip_smoke.time_ms``),
each variant twice, in turns; "err" is the largest difference from the
built kernel's output. The arguments pick the kernels (default: all).
Needs a CUDA card and ``nvcc``.
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
BWD_HEADER = "depthwise_bwd_tile.cuh"

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


def bwd_header(warps=8, smem_factor=1, no_dw_compute=False, no_loads=False) -> str:
    """depthwise_bwd_tile.cuh with the warps of a role, a block's shared
    memory times ``smem_factor`` (fewer blocks an SM), and the dw role's
    multiply-adds or the copies after the first rows left out."""
    src = (CSRC / BWD_HEADER).read_text()
    src = edit(src, "static constexpr int WARPS = K == 7 ? 4 : 8;",
               f"static constexpr int WARPS = K == 7 ? 4 : {warps};")
    src = edit(src, "return ring_bytes() > red_bytes() ? ring_bytes() : red_bytes();",
               f"return {smem_factor} * (ring_bytes() > red_bytes() ? ring_bytes() : red_bytes());")
    if no_dw_compute:  # keep the loads: the first staged x becomes the sum
        src = edit(src, "for (int c = 0; c < COLS; ++c) fma_pair(dw[i][j], xv[c + j], "
                        "gr[(u - i + K) % K][c]);",
                   "for (int c = 0; c < 1; ++c) dw[i][j] = xv[c + j];")
    if no_loads:
        src = edit(src, "    bwd_stage<T, K, DX>(ring, gb, xb, s + S::RING - S::SYNC + r,",
                   "    if (s < 0) bwd_stage<T, K, DX>(ring, gb, xb, s + S::RING - S::SYNC + r,")
    return src


ZERO_DW = """#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) dw[i][j] = make_float2(0.f, 0.f);
"""
PROLOGUE = """  const int steps = H + K - 1;
  constexpr int RING = D::S::RING, SYNC = D::S::SYNC;
#pragma unroll
  for (int s = 0; s < RING - SYNC; s += SYNC) {
#pragma unroll
    for (int r = 0; r < SYNC; ++r)
      bwd_stage<T, K, true>(ring, g + img, x + img, s + r, steps, H, W, C, z0, c0);
    cp_async_commit();
  }
"""
# the same prologue as a function of the shared header
PROLOGUE_FN = """template <typename T, int K, bool DX>
__device__ __forceinline__ void bwd_prologue(T* ring, const T* gb, const T* xb, int H, int W,
                                             int C, int z0, int c0) {
  using S = typename BwdTile<T, K, DX>::S;
#pragma unroll
  for (int s = 0; s < S::RING - S::SYNC; s += S::SYNC) {
#pragma unroll
    for (int r = 0; r < S::SYNC; ++r)
      bwd_stage<T, K, DX>(ring, gb, xb, s + r, H + K - 1, H, W, C, z0, c0);
    cp_async_commit();
  }
}

"""


def dxdw_variant(warps=8, blocks=1, dx_only=False, dw_only=False, no_loads=False,
                 zero_in_sweep=False, prologue_fn=False, **head) -> tuple:
    """dxdw; with zero_in_sweep, dw zeroed inside dw_sweep, and with
    prologue_fn the first rows staged by a function of the shared header,
    where the kernel does both in its own body."""
    src = (CSRC / "depthwise_dxdw.cu").read_text()
    src = edit(src, "__launch_bounds__((DxdwTile<T, K>::THREADS), 1)",
               f"__launch_bounds__((DxdwTile<T, K>::THREADS), {blocks})")
    if dw_only:
        src = edit(src, "for (int j = 0; j < K; ++j) fma_pair(acc[(u + i) % K][c], "
                        "gv[c + K - 1 - j], w[i][j]);",
                   "for (int j = 0; j < 1; ++j) acc[(u + i) % K][c] = gv[c];")
    bwd = bwd_header(warps, no_dw_compute=dx_only, no_loads=no_loads)
    if zero_in_sweep:
        src = edit(src, "    float2 dw[K][K];\n" + ZERO_DW, "    float2 dw[K][K];\n")
        bwd = edit(bwd, "  const int steps = H + K - 1;\n  // gr[h % K]",
                   "  const int steps = H + K - 1;\n" + ZERO_DW.replace("\n  ", "\n") +
                   "  // gr[h % K]")
    if prologue_fn:
        src = edit(src, PROLOGUE, "  bwd_prologue<T, K, true>(ring, g + img, x + img, H, W, C, "
                                  "z0, c0);\n")
        bwd = edit(bwd, "// The dw role of dw warp cw", PROLOGUE_FN + "// The dw role of dw warp cw")
    return src, {HEADER: header(**head), BWD_HEADER: bwd}


def dw_variant(warps=8, blocks=2, smem_factor=1, no_compute=False, no_loads=False,
               **head) -> tuple:
    src = edit((CSRC / "depthwise_dw.cu").read_text(),
               "__launch_bounds__((DwTile<T, K>::THREADS), 2)",
               f"__launch_bounds__((DwTile<T, K>::THREADS), {blocks})")
    return src, {HEADER: header(**head),
                 BWD_HEADER: bwd_header(warps, smem_factor, no_compute, no_loads)}


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
        "dw zeroed inside dw_sweep": dxdw_variant(zero_in_sweep=True),
        "first rows staged by a function of the header": dxdw_variant(prologue_fn=True),
        "both": dxdw_variant(zero_in_sweep=True, prologue_fn=True),
        "no copies after the first rows (wrong)": dxdw_variant(no_loads=True)}
DW = {"as built (8 warps, 4 columns, a barrier every 5 rows, ring 10, 2 blocks an SM)":
          dw_variant(),
      "1 block an SM (its shared memory doubled)": dw_variant(blocks=1, smem_factor=2),
      "4 warps (strips of 16), 4 blocks an SM": dw_variant(warps=4, blocks=4),
      "16 warps (strips of 64), 1 block an SM": dw_variant(warps=16, blocks=1),
      "a barrier every row, ring 8": dw_variant(sync="1", ring="8"),
      "ring 15, 1 block an SM": dw_variant(blocks=1, ring="3 * SYNC"),
      "2 columns (strips of 16), 2 blocks an SM": dw_variant(cols=2),
      "no multiply-adds (wrong)": dw_variant(no_compute=True),
      "no copies after the first rows (wrong)": dw_variant(no_loads=True)}


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    parts = sys.argv[1:] or ["fwd", "dxdw", "dw"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = kernels.dtype_code(torch.empty(0, dtype=torch.bfloat16))

    b, h, w, c = cs.BATCH, 112, 224, 2048
    wt = (torch.randn(5, 5, c, generator=g, device=dev) * 0.2).to(torch.bfloat16)
    if "fwd" in parts:
        fwd = build(FWD, "fwd", HEADER, "tiled", OUT)
        x = torch.randn(b, h, w, c, generator=g, device=dev).to(torch.bfloat16)

        def call_fwd(lib, outs):
            return lib.mde_depthwise_conv2d(x.data_ptr(), wt.data_ptr(), outs[0].data_ptr(), b,
                                            h, w, c, 5, 5, 1, bf16, stream)

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

    def call_dw(lib, outs):
        return lib.mde_depthwise_conv2d_dw(x.data_ptr(), dout.data_ptr(), part.data_ptr(),
                                           outs[0].data_ptr(), b, h, w, c, 5, 1, bf16, stream)

    if "dxdw" in parts:
        compare(f"dxdw ({b}, {h}, {w}, {c}) 5x5", build(DXDW, "dxdw", HEADER, "tiled", OUT),
                call_dxdw, lambda: (torch.empty_like(x), torch.empty(5, 5, c, device=dev)))
    if "dw" in parts:
        compare(f"dw ({b}, {h}, {w}, {c}) 5x5", build(DW, "dw", HEADER, "tiled", OUT), call_dw,
                lambda: (torch.empty(5, 5, c, device=dev),))
    return 0


if __name__ == "__main__":
    sys.exit(main())
