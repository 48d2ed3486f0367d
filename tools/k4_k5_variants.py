"""Time design variants of K4 (the fused GLU feed-forward) and K5 (the KSA
channel attention, forward and backward) on one card.

    python3 tools/k4_k5_variants.py [K4] [K5] [K5bwd]

Each variant is a copy of ``csrc/glu_ff.cu`` (with ``csrc/depthwise_tile.cuh``)
or of ``csrc/channel_attention.cu`` (with ``csrc/attention_mma.cuh``) with
one choice changed by a text edit. K4: the sigmoid computed per element
rather than read from its table (exactly, or by ``__expf`` and
``__fdividef``, which round otherwise), the table read without its NaN
check, the bf16 gate element by element in f32 (the same bits), ``__expf``
in the sigmoid, the warps of a block and the blocks an SM it is compiled for, the scales
and shifts reloaded at each store; and one part of the work left out to
see what it costs (the gate, the taps' multiply-adds, the affine and GELU,
all three, the copies after the first rows). K5: the softmax's exp
(``__expf``), and the products left out (copies and stores alone). K5
backward (``csrc/channel_attention_bwd.cu``): q, k, dO and v staged as one
cp.async group rather than two (S waiting for dO and v), ``__expf`` in
the softmax, and the products left out (copies in, zeros stored). The
variants that leave work out give wrong results and are timed only. Every variant is built with ``nvcc`` into its own library
under ``build/k4_k5_variants/`` (``k1_variants.build``), loaded with
``ctypes`` and called through the port's C entry point at the shapes
``chip_smoke.py`` times (bf16): K4 at (8, 112, 224, 2 x 2048) -> 2048 5x5,
K5 at the KSA decoder's three serving stages (batch 8: 4096 windows of 49
tokens at 64 channels and 4 heads, 1024 at 128 and 8, 256 at 256 and 16),
its backward at the train step's (batch 4: 2048, 512 and 128 windows).
The arguments pick the kernels (default: all).
Times are device ms per call (``chip_smoke.time_ms``), each variant twice,
in turns; "err" is the largest difference from the built kernel's output.
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
OUT = ROOT / "build" / "k4_k5_variants"
TILE = "depthwise_tile.cuh"
MMA = "attention_mma.cuh"


def k4_variant(warps: int = 8, min_blocks: int = 2, fast_exp: bool = False,
               fast_sigmoid: bool = False,
               f32_product: bool = False, reload_affine: bool = False, no_table: bool = False,
               gate_part: str = "", no_gate: bool = False, no_taps: bool = False,
               no_epilogue: bool = False, no_loads: bool = False) -> tuple:
    src = (CSRC / "glu_ff.cu").read_text()
    src = edit(src, "constexpr int FF_WARPS = 8;", f"constexpr int FF_WARPS = {warps};")
    src = edit(src, "return k == 7 ? 1 : 2;", f"return k == 7 ? 1 : {min_blocks};")
    if fast_sigmoid:  # no table: __expf and the approximate division, without branches
        src = edit(src, "1.f / (1.f + expf(-b))", "__fdividef(1.f, 1.f + __expf(-b))")
        src = edit(src, "        ff_gate(av.v, bv.v, sg_tab);", "        ff_gate(av.v, bv.v);")
    if fast_exp:  # both bodies take ff_sigmoid
        src = edit(src, "1.f / (1.f + expf(-b))", "1.f / (1.f + __expf(-b))")
    if f32_product:  # bf16 gate element by element: f32 product, then two roundings
        src = edit(src, "  if constexpr (N % 2 == 0) {", "  if constexpr (N < 0) {")
        src = edit(src, "      a[e] = __hmul(a[e], __float2bfloat16(ff_sigmoid(__bfloat162float(b[e]))));",
                   "      a[e] = __float2bfloat16(__bfloat162float(a[e]) * round_to<__nv_bfloat16>("
                   "ff_sigmoid(__bfloat162float(b[e]))));")
    if no_table or f32_product:  # the tiled body computes every sigmoid, as the column body does
        src = edit(src, "        ff_gate(av.v, bv.v, sg_tab);", "        ff_gate(av.v, bv.v);")
    if reload_affine:  # the scales and shifts from L1 at each store
        src = edit(src, "make_float2(ff_out(o[c].x, s.x, t.x), ff_out(o[c].y, s.y, t.y))",
                   "make_float2(ff_out(o[c].x, sc[cc], sh[cc]), "
                   "ff_out(o[c].y, sc[cc + 1], sh[cc + 1]))")
    if gate_part:  # the tiled bf16 gate with a part of its work left out
        old = "*reinterpret_cast<const __nv_bfloat162*>(&sg)"
        new = {"no sigmoid": "__halves2bfloat162(b[e], b[e + 1])",
               "half": "__float2bfloat162_rn(0.5f)"}
        if gate_part == "no NaN check":
            src = edit(src, "  if (nan) {\n    ff_gate(a, b);", "  if (nan && N < 0) {\n    ff_gate(a, b);")
        else:
            src = edit(src, old, new[gate_part])
    if no_gate:
        src = edit(src, "    if (p >= steps) return;\n    T* da = ring + (p % (2 * K)) * NPX * TILE_CH;\n"
                        "    const T* db",
                   "    if (p >= 0) return;\n    T* da = ring + (p % (2 * K)) * NPX * TILE_CH;\n"
                   "    const T* db")
    if no_taps:  # keep the loads: the first staged column becomes the sum
        src = edit(src, "for (int j = 0; j < K; ++j) fma_pair(acc[(u - i + K) % K][c], xv[c + j], "
                        "w[i][j]);",
                   "for (int j = 0; j < 1; ++j) acc[(u - i + K) % K][c] = xv[c + j];")
    if no_epilogue:
        src = edit(src, "make_float2(ff_out(o[c].x, s.x, t.x), ff_out(o[c].y, s.y, t.y))",
                   "o[c]")
    if no_loads:  # the first group's copies only
        src = edit(src, "    for (int r = 0; r < K; ++r) stage(p0 + K + r);",
                   "    for (int r = 0; r < K; ++r) if (p0 < 0) stage(p0 + K + r);")
    return src, (CSRC / TILE).read_text()


def k5_variant(fast_exp: bool = False, no_products: bool = False) -> tuple:
    src = (CSRC / "channel_attention.cu").read_text()
    if fast_exp:
        src = edit(src, "auto kernel = channel_attention_mma_kernel<NT, ET>;",
                   "auto kernel = channel_attention_mma_kernel<NT, ET, true>;")
    if no_products:  # copies in, q's staged rows out
        src = edit(src, "  for (int d0 = 0; d0 < hd; d0 += 16) {",
                   "  for (int d0 = 0; d0 < hd && n < 0; d0 += 16) {")
    return src, (CSRC / MMA).read_text()


def k5_bwd_variant(one_group: bool = False, fast_exp: bool = False,
                   no_products: bool = False) -> tuple:
    src = (CSRC / "channel_attention_bwd.cu").read_text()
    if one_group:  # S waits for dO and v too
        src = edit(src, "      cp_async_wait<1>();", "      cp_async_wait<0>();")
    if fast_exp:
        src = edit(src, "mma_softmax<ET>(s, ne, inv0, inv1);",
                   "mma_softmax<ET, true>(s, ne, inv0, inv1);")
    if no_products:  # copies in, zeros stored
        src = edit(src, "  for (int d0 = 0; d0 < hd; d0 += 16) {",
                   "  cp_async_wait<0>();\n  __syncwarp();\n"
                   "  for (int d0 = 0; d0 < hd && n < 0; d0 += 16) {")
        src = edit(src, "        if (kt >= ne) break;\n        uint32_t fa[4];\n"
                        "        ldsm_x4<false>(fa, tile_a(sk",
                   "        if (kt >= ne || n > 0) break;\n        uint32_t fa[4];\n"
                   "        ldsm_x4<false>(fa, tile_a(sk")
        src = edit(src, "        if (kt >= nd) break;\n        uint32_t fa[4];\n"
                        "        ldsm_x4<false>(fa, tile_a(sa",
                   "        if (kt >= nd || n > 0) break;\n        uint32_t fa[4];\n"
                   "        ldsm_x4<false>(fa, tile_a(sa")
    return src, (CSRC / MMA).read_text()


K4 = {"as built (8 warps, 4 columns, 2 blocks an SM, packed bf16 gate, sigmoid table "
      "without a branch)": k4_variant(),
      "sigmoid computed per element (no table)": k4_variant(no_table=True),
      "gate element by element (f32 product, two roundings; no table)":
          k4_variant(f32_product=True),
      "__expf in the sigmoid (both bodies; table built with it)": k4_variant(fast_exp=True),
      "sigmoid per element by __expf and __fdividef (other numerics, no table)":
          k4_variant(fast_sigmoid=True),
      "4 warps, 4 blocks an SM": k4_variant(warps=4, min_blocks=4),
      "1 block an SM (no register cap)": k4_variant(min_blocks=1),
      "scales and shifts reloaded at each store": k4_variant(reload_affine=True),
      "gate without the NaN check (wrong for NaN b only)": k4_variant(gate_part="no NaN check"),
      "gate without the sigmoid: a * b (wrong)": k4_variant(gate_part="no sigmoid"),
      "gate as a * 0.5 (wrong)": k4_variant(gate_part="half"),
      "no gate (wrong)": k4_variant(no_gate=True),
      "no taps (wrong)": k4_variant(no_taps=True),
      "no affine and GELU (wrong)": k4_variant(no_epilogue=True),
      "copies alone: no gate, taps, affine or GELU (wrong)":
          k4_variant(no_gate=True, no_taps=True, no_epilogue=True),
      "no copies after the first rows (wrong)": k4_variant(no_loads=True)}
K5 = {"as built (a warp a block, one (window, head) each)": k5_variant(),
      "__expf in the softmax": k5_variant(fast_exp=True),
      "copies and stores alone (wrong)": k5_variant(no_products=True)}
K5_BWD = {"as built (a warp a block; q, k then dO, v in two cp.async groups)":
              k5_bwd_variant(),
          "one cp.async group": k5_bwd_variant(one_group=True),
          "__expf in the softmax": k5_bwd_variant(fast_exp=True),
          "copies in, zeros stored (wrong)": k5_bwd_variant(no_products=True)}


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_k5_variants: no CUDA device", file=sys.stderr)
        return 1
    parts = sys.argv[1:] or ["K4", "K5", "K5bwd"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = kernels.dtype_code(torch.empty(0, dtype=torch.bfloat16))
    n = 49
    if "K5bwd" in parts:
        k5_bwd = build(K5_BWD, "k5bwd", MMA, "mma", OUT)
        for ch in (64, 128, 256):
            bw, heads = 512 * cs.TRAIN_BATCH * 64 * 64 // (ch * ch), ch // 16
            q, dout = (torch.randn(bw, n, ch, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(2))
            kv = torch.randn(bw, n, 2 * ch, generator=g, device=dev).to(torch.bfloat16)

            def call_bwd(lib, outs):
                return lib.mde_channel_attention_bwd(
                    q.data_ptr(), kv.data_ptr(), dout.data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), bw, n, ch, ch, heads, n ** -0.5, bf16, stream)

            compare(f"K5 bwd ({bw}, {n}, {ch})/{heads}", k5_bwd, call_bwd,
                    lambda: (torch.empty_like(q), torch.empty_like(kv)))
    if "K4" not in parts and "K5" not in parts:
        return 0
    k4 = build(K4, "k4", TILE, "tiled", OUT) if "K4" in parts else {}
    k5 = build(K5, "k5", MMA, "mma", OUT) if "K5" in parts else {}

    b, h, w, c = cs.BATCH, 112, 224, 2048
    ab = torch.randn(b, h, w, 2 * c, generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn(5, 5, c, generator=g, device=dev) * 0.2).to(torch.bfloat16)
    sc = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    sh = 0.1 * torch.randn(c, generator=g, device=dev)

    def call_k4(lib, outs):
        return lib.mde_glu_ff(ab.data_ptr(), wt.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                              outs[0].data_ptr(), b, h, w, c, 5, 5, 1, bf16, stream)

    if k4:
        compare(f"K4 ({b}, {h}, {w}, {2 * c}) -> {c} 5x5", k4, call_k4,
                lambda: (torch.empty(b, h, w, c, dtype=torch.bfloat16, device=dev),))
    del ab

    for ch in (64, 128, 256) if k5 else ():
        bw, heads = 512 * cs.BATCH * 64 * 64 // (ch * ch), ch // 16
        q = torch.randn(bw, n, ch, generator=g, device=dev).to(torch.bfloat16)
        kv = torch.randn(bw, n, 2 * ch, generator=g, device=dev).to(torch.bfloat16)

        def call_k5(lib, outs):
            return lib.mde_channel_attention(q.data_ptr(), kv.data_ptr(), outs[0].data_ptr(),
                                             bw, n, ch, ch, heads, n ** -0.5, bf16, stream)

        compare(f"K5 ({bw}, {n}, {ch})/{heads}", k5, call_k5, lambda: (torch.empty_like(q),))
    return 0


if __name__ == "__main__":
    sys.exit(main())
