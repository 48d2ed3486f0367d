"""Time design variants of K1, the port's window attention kernels, on one card.

    python3 tools/k1_variants.py [narrow] [wide]

Each variant is a copy of ``csrc/window_attention.cu`` or
``csrc/window_attention_bwd.cu`` (and, where it says so, of
``csrc/attention_mma.cuh``) with one choice changed by a text edit, or one
part of the work left out to see what it costs (those give wrong results
and are timed only). Every variant is built with ``nvcc`` into its own
library under ``build/k1_variants/``, loaded with ``ctypes`` and called
through the same C entry point as the port, at the shapes ``chip_smoke.py``
times (bf16).

``narrow``: the n <= 128 bodies (the resident blocks an SM the kernel is
compiled for, the windows a block walks, the softmax's exp, double-buffered
loads, the float4s of the bias tile in flight while it is built; no bias
tile, no loads, no compute, no dbias atomics) at the flagship's stage 1
(unmasked and masked), stage 3 and the KSA decoder's head dim 16 at batch
8, the backward at stages 1 and 3 at batch 4.

``wide``: the 144-token bodies at the ODA encoder's stage 1 (masked and
unmasked) and stage 4 at batch 8, the backward at stage 1 masked at batch
4: the ring's depth, the backward's dbias sums all in registers, bulk row copies (``cp.async.bulk``, one 64-byte row
each, completing on the mbarrier) in place of the producer's ``cp.async``,
the bias tile filled once a run instead of once a mask slot, no bias tile,
no loads, no compute, the backward's rows pass alone, its keys pass as
two loops (dv, then dk and dbias), its tile fill with more loads in flight,
no dbias atomics, no dbias sums.

Times are device ms per call (``chip_smoke.time_ms``), each variant twice,
in turns; "err" is the largest difference from the built kernel's output.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mde_tpu_torch.ops import kernels  # noqa: E402
from mde_tpu_torch.ops.window import shifted_window_attn_mask  # noqa: E402

CSRC = kernels.CSRC
OUT = ROOT / "build" / "k1_variants"

FWD_LOOP = '''    mma_stage(sq, q + base, n, np, hd, ldg, ld);
    mma_stage(sk, k + base, n, np, hd, ldg, ld);
    mma_stage(sv, v + vbase, n, np, hd, ldv, ld);
    cp_async_commit();
    if (s != slot) {  // the last window's readers of sb passed the barrier below
      slot = s;
      mma_bias_tile(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n);
    }
    cp_async_wait<0>();
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();'''
# the same loop with the next window's q, k and v copied into a second
# buffer while the current one computes
FWD_LOOP_PREFETCH = '''    if (u == u0) {
      mma_stage(sq, q + base, n, np, hd, ldg, ld);
      mma_stage(sk, k + base, n, np, hd, ldg, ld);
      mma_stage(sv, v + vbase, n, np, hd, ldv, ld);
      cp_async_commit();
    }
    if (s != slot) {
      slot = s;
      mma_bias_tile(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n);
    }
    if (u + 1 < u1) {
      const int s1 = (u + 1) / images, w1 = s1 + (u + 1 - s1 * images) * slots;
      const size_t nb = (size_t)w1 * n * ldg + (size_t)h * hd;
      bf16* nq = sq0 + ((u + 1 - u0) & 1) * 3 * np * ld;
      mma_stage(nq, q + nb, n, np, hd, ldg, ld);
      mma_stage(nq + np * ld, k + nb, n, np, hd, ldg, ld);
      mma_stage(nq + 2 * np * ld, v + (size_t)w1 * n * ldv + (size_t)h * hd, n, np, hd, ldv,
                ld);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();'''
FWD_BUFFERS = '''  bf16* sq = reinterpret_cast<bf16*>(sb + np * np);
  bf16* sk = sq + np * ld;
  bf16* sv = sk + np * ld;'''
FWD_BUFFERS_PREFETCH = '''  bf16* sq0 = reinterpret_cast<bf16*>(sb + np * np);'''
FWD_WINDOW = '''    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    const size_t vbase = (size_t)w * n * ldv + (size_t)h * hd;
'''
FWD_WINDOW_PREFETCH = '''    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    const size_t vbase = (size_t)w * n * ldv + (size_t)h * hd;
    bf16* sq = sq0 + ((u - u0) & 1) * 3 * np * ld;
    bf16* sk = sq + np * ld;
    bf16* sv = sk + np * ld;
'''


TILE_UNROLL = ("  // a float4 of the tile at a time, in its order, two of them in flight\n"
               "#pragma unroll 2\n")


# the wide bodies' tile fill (even n): four float4s of the tile in flight
FILL_UNROLL = ("#pragma unroll 4\n    for (int j = 0; j < tiles; ++j) {\n"
               "      const int col = 8 * j + col0, k = col >> 1;")


def header(tile_unroll: int = 2, fill_inflight: int = 4) -> str:
    """attention_mma.cuh with the n <= 128 bodies' tile build's unroll and
    the wide bodies' tile fill's float4s in flight changed."""
    src = (CSRC / "attention_mma.cuh").read_text()
    src = edit(src, TILE_UNROLL, TILE_UNROLL.replace("unroll 2", f"unroll {tile_unroll}"))
    return edit(src, FILL_UNROLL, FILL_UNROLL.replace("unroll 4", f"unroll {fill_inflight}"))


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
    return src.replace(old, new)


def fwd_variant(min_blocks=7, run=8, exact_exp=False, prefetch=False, no_tile=False,
                no_loads=False, no_compute=False, tile_unroll=2) -> tuple:
    src = (CSRC / "window_attention.cu").read_text()
    src = edit(src, "nt <= 4 && dt <= 2 ? 7 : 1", f"nt <= 4 && dt <= 2 ? {min_blocks} : 1")
    src = edit(src, "balanced_windows_per_block(kernel, smem, bw, heads, 8)",
               f"balanced_windows_per_block(kernel, smem, bw, heads, {run})")
    if prefetch:
        src = edit(src, FWD_LOOP, FWD_LOOP_PREFETCH)
        src = edit(src, FWD_BUFFERS, FWD_BUFFERS_PREFETCH)
        src = edit(src, FWD_WINDOW, FWD_WINDOW_PREFETCH)
        src = edit(src, "3 * np * mma_ld(hd) * sizeof(bf16);",
                   "6 * np * mma_ld(hd) * sizeof(bf16);")
    if no_tile:
        src = edit(src, "    if (s != slot) {  //", "    if (s != slot && u < 0) {  //")
    if no_loads:  # the first window's copies only
        src = edit(src, "    mma_stage(sq, q + base, n, np, hd, ldg, ld);\n",
                   "    if (u == u0) mma_stage(sq, q + base, n, np, hd, ldg, ld);\n")
        src = edit(src, "    mma_stage(sk, k + base, n, np, hd, ldg, ld);\n",
                   "    if (u == u0) mma_stage(sk, k + base, n, np, hd, ldg, ld);\n")
        src = edit(src, "    mma_stage(sv, v + vbase, n, np, hd, ldv, ld);\n",
                   "    if (u == u0) mma_stage(sv, v + vbase, n, np, hd, ldv, ld);\n")
    if no_compute:
        src = edit(src, "    mma_head_attention<NT, DT, true>(",
                   "    if (n < 0) mma_head_attention<NT, DT, true>(")
    if exact_exp:
        src = edit(src, "mma_head_attention<NT, DT, true>(", "mma_head_attention<NT, DT>(")
    return src, header(tile_unroll)


def bwd_variant(run=16, exact_exp=False, no_tile=False, no_atomics=False,
                tile_unroll=2) -> tuple:
    src = (CSRC / "window_attention_bwd.cu").read_text()
    src = edit(src, "balanced_windows_per_block(kernel, smem, bw, heads, 16)",
               f"balanced_windows_per_block(kernel, smem, bw, heads, {run})")
    if exact_exp:
        src = edit(src, "mma_bwd_rows<NT, DT, true>(", "mma_bwd_rows<NT, DT>(")
    if no_tile:
        src = edit(src, "    if (s != slot) {  //", "    if (s != slot && u < 0) {  //")
    if no_atomics:
        src = edit(src, "      atomicAdd(dbias + (size_t)h * n * n + i, "
                        "sdb[frag_offset(row, col, np >> 3)]);",
                   "      if (sdb[frag_offset(row, col, np >> 3)] == 12345.f) dbias[i] = 0.f;")
    return src, header(tile_unroll)


FWD = {"as built": fwd_variant(), "exact expf": fwd_variant(exact_exp=True),
       "6 blocks an SM": fwd_variant(min_blocks=6), "runs of ~4": fwd_variant(run=4),
       "runs of ~16": fwd_variant(run=16),
       "double-buffered, 4 blocks an SM": fwd_variant(min_blocks=4, prefetch=True),
       "no bias tile (wrong)": fwd_variant(no_tile=True),
       "no loads (wrong)": fwd_variant(no_loads=True),
       "no compute (wrong)": fwd_variant(no_compute=True),
       "tile build 4 in flight": fwd_variant(tile_unroll=4),
       "tile build 8 in flight": fwd_variant(tile_unroll=8)}
BWD = {"as built": bwd_variant(), "exact expf": bwd_variant(exact_exp=True),
       "runs of ~8": bwd_variant(run=8), "runs of ~32": bwd_variant(run=32),
       "no bias tile (wrong)": bwd_variant(no_tile=True),
       "no dbias atomics (wrong)": bwd_variant(no_atomics=True),
       "tile build 4 in flight": bwd_variant(tile_unroll=4)}


# the wide forward's producer with one cp.async.bulk a row (the copies
# complete on the stage's mbarrier, which expects their bytes)
BULK_HELPERS = r"""
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_rows(bf16* dst, const bf16* src, int n, int hd, int ldg,
                                          int ld, uint64_t* bar, int lane) {
  for (int r = lane; r < n; r += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst + r * ld)), "l"(src + (size_t)r * ldg), "r"((unsigned)hd * 2),
        "r"(smem_addr(bar)) : "memory");
}
"""
WIDE_PRODUCER = """      warp_stage(dst, q + base, n, np, hd, ldg, ld, lane);
      warp_stage(dst + np * ld, k + base, n, np, hd, ldg, ld, lane);
      warp_stage(dst + 2 * np * ld, v + (size_t)w * n * ldv + (size_t)h * hd, n, np, hd, ldv,
                 ld, lane);
      cp_async_arrive(&full[st]);"""
WIDE_PRODUCER_BULK = """      if (lane == 0) mbar_expect(&full[st], 3u * n * hd * 2);
      __syncwarp();
      bulk_rows(dst, q + base, n, hd, ldg, ld, &full[st], lane);
      bulk_rows(dst + np * ld, k + base, n, hd, ldg, ld, &full[st], lane);
      bulk_rows(dst + 2 * np * ld, v + (size_t)w * n * ldv + (size_t)h * hd, n, hd, ldv, ld,
                &full[st], lane);"""
WIDE_RELEASE = "    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[st]);"


def wide_fwd_variant(stages=4, bulk=False, tile_once=False, no_tile=False, no_loads=False,
                     no_compute=False, inflight=4) -> tuple:
    """The 144-token forward. bulk: valid only where rows need no zero
    padding (n 144, head dims that are multiples of 16), as timed here."""
    src = (CSRC / "window_attention.cu").read_text()
    src = edit(src, "#define WIDE_FWD_STAGES 4", f"#define WIDE_FWD_STAGES {stages}")
    if bulk:
        src = edit(src, '#include "attention_mma.cuh"\n',
                   '#include "attention_mma.cuh"\n' + BULK_HELPERS)
        src = edit(src, WIDE_PRODUCER, WIDE_PRODUCER_BULK)
        src = edit(src, "mbar_init(&full[i], 32);", "mbar_init(&full[i], 1);")
        # the consumers' staged output comes before the next bulk copy
        src = edit(src, WIDE_RELEASE, '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: '
                   '"memory");\n' + WIDE_RELEASE)
    fill = "    if (s != slot) {\n      slot = s;\n      warp_bias_rows("
    if tile_once:
        src = edit(src, fill, fill.replace("s != slot", "slot < 0"))
    if no_tile:
        src = edit(src, fill, fill.replace("s != slot", "s != slot && n < 0"))
    if no_loads:  # the first R windows' copies only
        src = edit(src, WIDE_PRODUCER, WIDE_PRODUCER.replace("      warp_stage(",
                                                             "      if (i < R) warp_stage("))
    if no_compute:
        src = edit(src, "    bf16* sq = ring + st * stage;\n",
                   "    bf16* sq = ring + st * stage;\n    if (n > 0) {\n" + WIDE_RELEASE +
                   "\n      continue;\n    }\n")
    return src, header(fill_inflight=inflight)


# the backward's keys pass as two loops over the row tiles, dv and then dk
# and dbias, each recomputing P (the built kernel holds the dk and dv sums
# in one loop)
KEYS_TWO_LOOPS = """    {  // keys pass: warp kt = warp
      const int k0 = warp * 16;
      auto p_block = [&](int rt, float (&pb)[2][4]) {
        const int r0 = rt * 16;
        uint32_t fa[DT][4], fb[DT][4];
        load_rows<DT>(fa, sq, ld, r0, nd, lane);
        load_bt<DT>(fb, sk, ld, k0, nd, lane);
        mma_block<DT>(pb, fa, fb, nd);
        const float mx[2] = {smax[r0 + g], smax[r0 + g + 8]};
        const float iv[2] = {sinv[r0 + g], sinv[r0 + g + 8]};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float4 b = tile4[(rt * tiles + 2 * warp + jj) * 32 + lane];
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pb[jj][e] = softmax_exp<true>(pb[jj][e] + bv[e] - mx[e >> 1]) * iv[e >> 1];
        }
      };
      auto store_keys = [&](bf16* dst, size_t ldd, const float (&acc)[2 * DT][4]) {
#pragma unroll
        for (int dn = 0; dn < 2 * DT; ++dn) {
          if (8 * dn >= hd) break;
          const int col = 8 * dn + 2 * t;
          if (k0 + g < n)
            *reinterpret_cast<uint32_t*>(dst + (k0 + g) * ldd + col) =
                pack_bf16(acc[dn][0], acc[dn][1]);
          if (k0 + g + 8 < n)
            *reinterpret_cast<uint32_t*>(dst + (k0 + g + 8) * ldd + col) =
                pack_bf16(acc[dn][2], acc[dn][3]);
        }
      };
      {
        float gv[2 * DT][4];
#pragma unroll
        for (int j = 0; j < 2 * DT; ++j) gv[j][0] = gv[j][1] = gv[j][2] = gv[j][3] = 0.f;
#pragma unroll 3
        for (int rt = 0; rt < nk; ++rt) {
          float pb[2][4];
          p_block(rt, pb);
          uint32_t ap[4];
          a_of_transpose(ap, pb);
#pragma unroll
          for (int dn = 0; dn < DT; ++dn) {
            if (dn >= nd) break;
            uint32_t fb[4];
            ldsm_x4<true>(fb, tile_b(sdo, ld, rt * 16, dn * 16, lane));
            mma16816(gv[2 * dn], ap, fb[0], fb[1]);
            mma16816(gv[2 * dn + 1], ap, fb[2], fb[3]);
          }
        }
        store_keys(dv + (size_t)w * n * ldv + (size_t)h * hd, ldv, gv);
      }
      float gk[2 * DT][4];
#pragma unroll
      for (int j = 0; j < 2 * DT; ++j) gk[j][0] = gk[j][1] = gk[j][2] = gk[j][3] = 0.f;
#pragma unroll
      for (int rt = 0; rt < NT; ++rt) {
        if (rt >= nk) break;
        const int r0 = rt * 16;
        float pb[2][4], dp[2][4];
        p_block(rt, pb);
        {
          uint32_t fo[DT][4], fb[DT][4];
          load_rows<DT>(fo, sdo, ld, r0, nd, lane);
          load_bt<DT>(fb, sv, ld, k0, nd, lane);
          mma_block<DT>(dp, fo, fb, nd);
        }
        const float dt[2] = {sdot[r0 + g], sdot[r0 + g + 8]};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[jj][e] = pb[jj][e] * (dp[jj][e] - dt[e >> 1]);
          if (rt < WIDE_DB_REG_TILES) {
#pragma unroll
            for (int e = 0; e < 4; ++e) db[rt < WIDE_DB_REG_TILES ? rt : 0][jj][e] += dp[jj][e];
          } else {
            float4& a = dbs[((rt - WIDE_DB_REG_TILES) * 2 + jj) * blockDim.x];
            a = make_float4(a.x + dp[jj][0], a.y + dp[jj][1], a.z + dp[jj][2], a.w + dp[jj][3]);
          }
        }
        uint32_t ads[4];
        a_of_transpose(ads, dp);
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          if (dn >= nd) break;
          uint32_t fb[4];
          ldsm_x4<true>(fb, tile_b(sq, ld, r0, dn * 16, lane));
          mma16816(gk[2 * dn], ads, fb[0], fb[1]);
          mma16816(gk[2 * dn + 1], ads, fb[2], fb[3]);
        }
      }
      store_keys(dk + base, ldg, gk);
    }
  }
"""


def wide_bwd_variant(stages=2, reg_tiles=4, tile_once=False, no_loads=False,
                     no_compute=False, rows_only=False, no_atomics=False, two_loops=False,
                     inflight=4, no_dbias_sums=False) -> tuple:
    src = (CSRC / "window_attention_bwd.cu").read_text()
    src = edit(src, "#define WIDE_BWD_STAGES 2", f"#define WIDE_BWD_STAGES {stages}")
    src = edit(src, "#define WIDE_DB_REG_TILES 4", f"#define WIDE_DB_REG_TILES {reg_tiles}")
    if two_loops:
        start = src.index("    {  // keys pass: warp kt = warp")
        src = src[:start] + KEYS_TWO_LOOPS + src[src.index("  if (dbias) {\n    float* dh"):]
    if tile_once:
        src = edit(src, "    if (s != slot) {\n      // every warp is done",
                   "    if (slot < 0) {\n      // every warp is done")
    if no_dbias_sums:
        src = edit(src, "db[rt < WIDE_DB_REG_TILES ? rt : 0][jj][e] += dp[jj][e];", ";")
        src = edit(src, "a = make_float4(a.x + dp[jj][0], a.y + dp[jj][1], a.z + dp[jj][2], "
                        "a.w + dp[jj][3]);", "")
    if no_loads:  # the first R - 1 windows' copies only
        for dst in ("dst, q", "dst + np * ld, k", "dst + 2 * np * ld, v", "dst + 3 * np * ld, dout"):
            src = edit(src, f"    mma_stage({dst} + ", f"    if (j < R - 1) mma_stage({dst} + ")
    if no_compute or rows_only:
        src = edit(src, "    {  // keys pass: warp kt = warp", "    if (n < 0) {  // keys pass")
    if no_compute:
        src = edit(src, "    {  // rows pass: warp rt = warp", "    if (n < 0) {  // rows pass")
    if no_atomics:
        src = edit(src, "if (row < n && col < n) atomicAdd(dh + row * n + col, sum[e]);",
                   "if (row < n && col < n && sum[e] == 12345.f) dh[row * n + col] = 0;")
    return src, header(fill_inflight=inflight)


WIDE_FWD = {"as built (ring of 4)": wide_fwd_variant(),
            "ring of 2": wide_fwd_variant(stages=2), "ring of 3": wide_fwd_variant(stages=3),
            "bulk row copies": wide_fwd_variant(bulk=True),
            "tile fill 9 float4s in flight": wide_fwd_variant(inflight=9),
            "tile filled once a run (wrong)": wide_fwd_variant(tile_once=True),
            "no bias tile (wrong)": wide_fwd_variant(no_tile=True),
            "no loads (wrong)": wide_fwd_variant(no_loads=True),
            "no compute (wrong)": wide_fwd_variant(no_compute=True)}
WIDE_BWD = {"as built (ring of 2, 4 row tiles of dbias in registers)": wide_bwd_variant(),
            "ring of 3, all dbias in registers": wide_bwd_variant(stages=3, reg_tiles=9),
            "keys pass as two loops": wide_bwd_variant(two_loops=True),
            "tile fill 9 float4s in flight": wide_bwd_variant(inflight=9),
            "tile filled once a run (wrong)": wide_bwd_variant(tile_once=True),
            "no loads (wrong)": wide_bwd_variant(no_loads=True),
            "rows pass only (wrong)": wide_bwd_variant(rows_only=True),
            "no compute (wrong)": wide_bwd_variant(no_compute=True),
            "no dbias atomics (wrong)": wide_bwd_variant(no_atomics=True),
            "no dbias sums (wrong)": wide_bwd_variant(no_dbias_sums=True)}


def build(variants: dict, tag: str, header: str = "attention_mma.cuh",
          shown: str = "mma", out_dir: Path = OUT) -> dict:
    """Compile every variant, a (source, edited header) pair, into its own
    library under ``out_dir`` (all nvcc processes at once); return the loaded
    libraries by name and log the registers and spills of each kernel whose
    name holds ``shown``. The header is the text of ``header``, or a dict of
    texts by file name where a variant edits several."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, (src, head)) in enumerate(variants.items()):
        inc = out_dir / f"{tag}{i}_include"
        inc.mkdir(exist_ok=True)
        for fname, text in (head if isinstance(head, dict) else {header: head}).items():
            (inc / fname).write_text(text)
        path, lib = out_dir / f"{tag}{i}.cu", out_dir / f"lib{tag}{i}.so"
        path.write_text(src)
        procs.append((name, lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(inc),
             "-I", str(CSRC), str(path), "-o", str(lib)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{out[-3000:]}")
        for _, entry, regs, (stores, loads) in cs.ptxas_entries("== v\n" + out):
            if shown in entry:
                print(f"{tag} {name}: {entry} {regs} registers, spills {stores}/{loads} B")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in kernels._SIGNATURES.items():
            if hasattr(libs[name], fn):
                getattr(libs[name], fn).argtypes = argtypes
                getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def compare(tag: str, libs: dict, call, outputs) -> None:
    """Time every library's call twice, in turns, and print ms and err."""
    ref = outputs()
    if call(kernels.library(), ref) != 0:
        raise RuntimeError(f"{tag}: the built kernel failed to launch")
    times, errs = {}, {}
    order = list(libs.items())
    for turn in (order, order[::-1]):
        for name, lib in turn:
            out = outputs()
            if call(lib, out) != 0:
                raise RuntimeError(f"{tag} {name}: launch failed")
            torch.cuda.synchronize()
            errs[name] = max((a.float() - b.float()).abs().max().item() for a, b in zip(out, ref))
            times.setdefault(name, []).append(cs.time_ms(lambda: call(lib, out), iters=50))
    for name, _ in order:
        t = times[name]
        print(f"{tag}: {name}: {t[0]:.4f} {t[1]:.4f} ms, err {errs[name]:.3e}")


def fwd_call(bw, n, c, heads, mask, bias, qkv, stream):
    """mde_window_attention of a library on the fused qkv."""
    ptr, el = qkv.data_ptr(), qkv.element_size()

    def call(lib, outs):
        return lib.mde_window_attention(
            ptr, ptr + c * el, ptr + 2 * c * el, bias.data_ptr(),
            None if mask is None else mask.data_ptr(), outs[0].data_ptr(), bw, n, c, heads,
            3 * c, 3 * c, 0 if mask is None else mask.shape[0], (c // heads) ** -0.5, 1, stream)
    return call


def bwd_call(bw, n, c, heads, mask, bias, qkv, dout, stream):
    """mde_window_attention_bwd of a library on the fused qkv."""
    el = qkv.element_size()

    def call(lib, outs):
        outs[1].zero_()  # dbias is summed into a zeroed buffer, as the wrapper does
        q, dq = qkv.data_ptr(), outs[0].data_ptr()
        return lib.mde_window_attention_bwd(
            q, q + c * el, q + 2 * c * el, dout.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), dq, dq + c * el, dq + 2 * c * el,
            outs[1].data_ptr(), bw, n, c, heads, 3 * c, 3 * c,
            0 if mask is None else mask.shape[0], (c // heads) ** -0.5, 1, stream)
    return call


def run(variants_fwd, variants_bwd, tag, fwd_shapes, bwd_shapes, dev, stream) -> None:
    """Build both sets, then time each shape (tag, bw, n, c, heads, mask)."""
    g = torch.Generator(device=dev).manual_seed(1)
    shown = "wide" if tag else "mma"
    fwd = build(variants_fwd, f"{tag}fwd", shown=shown)
    bwd = build(variants_bwd, f"{tag}bwd", shown=shown)
    for name, bw, n, c, heads, mask in fwd_shapes:
        bias = torch.randn(heads, n, n, generator=g, device=dev)
        qkv = torch.randn(bw, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
        compare(name, fwd, fwd_call(bw, n, c, heads, mask, bias, qkv, stream),
                lambda: (torch.empty(bw, n, c, dtype=torch.bfloat16, device=dev),))
    for name, bw, n, c, heads, mask in bwd_shapes:
        bias = torch.randn(heads, n, n, generator=g, device=dev)
        qkv = torch.randn(bw, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(bw, n, c, generator=g, device=dev).to(torch.bfloat16)
        compare(name + " (with dbias zeroing)", bwd,
                bwd_call(bw, n, c, heads, mask, bias, qkv, dout, stream),
                lambda: (torch.empty_like(qkv), torch.zeros(heads, n, n, device=dev)))


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    groups = sys.argv[1:] or ["narrow", "wide"]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if "narrow" in groups:
        masks = {nw: shifted_window_attn_mask(*cs.WINDOW_GRIDS[nw], 7, 3, dev)
                 for nw in (512, 32)}
        run(FWD, BWD, "", (
            ("fwd stage 1", 512 * cs.BATCH, 49, 128, 4, None),
            ("fwd stage 1 masked", 512 * cs.BATCH, 49, 128, 4, masks[512]),
            ("fwd stage 3 masked", 32 * cs.BATCH, 49, 512, 16, masks[32]),
            ("fwd KSA hd 16 masked", 512 * cs.BATCH, 49, 64, 4, masks[512])), (
            ("bwd stage 1 masked", 512 * cs.TRAIN_BATCH, 49, 128, 4, masks[512]),
            ("bwd stage 3 masked", 32 * cs.TRAIN_BATCH, 49, 512, 16, masks[32])), dev, stream)
    if "wide" in groups:
        # the ODA encoder's stage 1 at 384x768: 8 x 16 windows of 12 x 12 an image
        mask = shifted_window_attn_mask(96, 192, 12, 6, dev)
        windows = cs.ODA_WINDOWS
        run(WIDE_FWD, WIDE_BWD, "wide", (
            ("fwd ODA stage 1 masked", windows[1] * cs.BATCH, 144, 192, 6, mask),
            ("fwd ODA stage 1", windows[1] * cs.BATCH, 144, 192, 6, None),
            ("fwd ODA stage 4", windows[4] * cs.BATCH, 144, 1536, 48, None)), (
            ("bwd ODA stage 1 masked", windows[1] * cs.TRAIN_BATCH, 144, 192, 6, mask),),
            dev, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
