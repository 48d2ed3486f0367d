"""Time design variants of K1, the port's window attention kernels, on one card.

    python3 tools/k1_variants.py

Each variant is a copy of ``csrc/window_attention.cu`` or
``csrc/window_attention_bwd.cu`` (and, where it says so, of
``csrc/attention_mma.cuh``) with one choice changed by a text edit (the
resident blocks an SM the kernel is compiled for, the windows a block
walks, the softmax's exp, double-buffered loads, the float4s of the bias
tile in flight while it is built, skipping the key tile that holds only
padding) or one part of the work
left out to see what it costs (the bias tile, the loads, the compute, the
dbias atomics; those give wrong results and are timed only). Every variant
is built with ``nvcc`` into its own library under ``build/k1_variants/``,
loaded with ``ctypes`` and called through the same C entry point as the
port, at the shapes ``chip_smoke.py`` times (bf16): the forward at the
flagship's stage 1 (unmasked and masked), stage 3 and the KSA decoder's
head dim 16 at batch 8, the backward at stages 1 and 3 at batch 4. Times
are device ms per call (``chip_smoke.time_ms``), each variant twice, in
turns; "err" is the largest difference from the built kernel's output.
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
    mma_stage(sv, v + base, n, np, hd, ldg, ld);
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
      mma_stage(sv, v + base, n, np, hd, ldg, ld);
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
      mma_stage(nq + 2 * np * ld, v + nb, n, np, hd, ldg, ld);
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
'''
FWD_WINDOW_PREFETCH = '''    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    bf16* sq = sq0 + ((u - u0) & 1) * 3 * np * ld;
    bf16* sk = sq + np * ld;
    bf16* sv = sk + np * ld;
'''


TILE_UNROLL = ("  // a float4 of the tile at a time, in its order, two of them in flight\n"
               "#pragma unroll 2\n")


# the edits that make the shared bodies skip the 8-key tiles that hold only
# padding (n = 49: keys 56-63): no products, no exps, P = 0 there
SKIP_PAD_EDITS = (
    ("const bf16* b, int ld, int r0, int nk, int nd,\n",
     "const bf16* b, int ld, int r0, int nk, int nj, int nd,\n"),
    ("      mma16816(s[2 * kt + 1], fa, fb[2], fb[3]);",
     "      if (2 * kt + 1 < nj) mma16816(s[2 * kt + 1], fa, fb[2], fb[3]);"),
    ("mma_softmax(float (&s)[2 * NT][4], int nk, float& inv0,",
     "mma_softmax(float (&s)[2 * NT][4], int nk, int nj, float& inv0,"),
    ("    if (j >= 2 * nk) break;\n    m0 = fmaxf", "    if (j >= nj) break;\n    m0 = fmaxf"),
    ("    if (j >= 2 * nk) break;\n    s[j][0] = softmax_exp",
     "    if (j >= 2 * nk) break;\n    if (j >= nj) {\n"
     "      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;\n      continue;\n    }\n"
     "    s[j][0] = softmax_exp"),
    ("    if (j >= 2 * nk) break;\n#pragma unroll\n    for (int e",
     "    if (j >= (n + 7) >> 3) break;\n#pragma unroll\n    for (int e"),
    ("    if (j >= 2 * nk) break;\n    const float4 b", "    if (j >= (n + 7) >> 3) break;\n    const float4 b"),
    ("  const int nk = mma_pad16(n) >> 4, nd = mma_pad16(hd) >> 4;\n"
     "  for (int rt = warp; rt < nk; rt += blockDim.x >> 5) {\n    const int r0 = rt * 16;\n"
     "    float s[2 * NT][4];\n    mma_rows_abt<NT, DT>(s, sq, sk, ld, r0, nk, nd, lane);",
     "  const int nk = mma_pad16(n) >> 4, nj = (n + 7) >> 3, nd = mma_pad16(hd) >> 4;\n"
     "  for (int rt = warp; rt < nk; rt += blockDim.x >> 5) {\n    const int r0 = rt * 16;\n"
     "    float s[2 * NT][4];\n    mma_rows_abt<NT, DT>(s, sq, sk, ld, r0, nk, nj, nd, lane);"),
    ("  const int np = mma_pad16(n), nk = np >> 4, nd = mma_pad16(hd) >> 4;\n"
     "  for (int rt = warp; rt < nk; rt += blockDim.x >> 5) {\n    const int r0 = rt * 16;\n"
     "    float s[2 * NT][4], dp[2 * NT][4];\n"
     "    mma_rows_abt<NT, DT>(s, sq, sk, ld, r0, nk, nd, lane);\n"
     "    mma_rows_abt<NT, DT>(dp, sdo, sv, ld, r0, nk, nd, lane);",
     "  const int np = mma_pad16(n), nk = np >> 4, nj = (n + 7) >> 3, nd = mma_pad16(hd) >> 4;\n"
     "  for (int rt = warp; rt < nk; rt += blockDim.x >> 5) {\n    const int r0 = rt * 16;\n"
     "    float s[2 * NT][4], dp[2 * NT][4];\n"
     "    mma_rows_abt<NT, DT>(s, sq, sk, ld, r0, nk, nj, nd, lane);\n"
     "    mma_rows_abt<NT, DT>(dp, sdo, sv, ld, r0, nk, nj, nd, lane);"),
)


def header(tile_unroll: int = 2, skip_pad_tiles: bool = False) -> str:
    """attention_mma.cuh with the tile build's unroll changed, and with
    skip_pad_tiles, skipping the 8-key tiles that hold only padding."""
    src = (CSRC / "attention_mma.cuh").read_text()
    src = edit(src, TILE_UNROLL, TILE_UNROLL.replace("unroll 2", f"unroll {tile_unroll}"))
    for old, new in SKIP_PAD_EDITS if skip_pad_tiles else ():
        src = edit(src, old, new)
    if skip_pad_tiles:
        src = src.replace("mma_softmax<NT, FAST_EXP>(s, nk, inv0, inv1);",
                          "mma_softmax<NT, FAST_EXP>(s, nk, nj, inv0, inv1);")
    return src


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
    return src.replace(old, new)


def fwd_variant(min_blocks=7, run=8, exact_exp=False, prefetch=False, no_tile=False,
                no_loads=False, no_compute=False, tile_unroll=2, skip_pad_tiles=False) -> tuple:
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
        src = edit(src, "    mma_stage(sv, v + base, n, np, hd, ldg, ld);\n",
                   "    if (u == u0) mma_stage(sv, v + base, n, np, hd, ldg, ld);\n")
    if no_compute:
        src = edit(src, "    mma_head_attention<NT, DT, true>(",
                   "    if (n < 0) mma_head_attention<NT, DT, true>(")
    if exact_exp:
        src = edit(src, "mma_head_attention<NT, DT, true>(", "mma_head_attention<NT, DT>(")
    return src, header(tile_unroll, skip_pad_tiles)


def bwd_variant(run=16, exact_exp=False, no_tile=False, no_atomics=False,
                tile_unroll=2, skip_pad_tiles=False) -> tuple:
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
    return src, header(tile_unroll, skip_pad_tiles)


FWD = {"as built": fwd_variant(), "exact expf": fwd_variant(exact_exp=True),
       "6 blocks an SM": fwd_variant(min_blocks=6), "runs of ~4": fwd_variant(run=4),
       "runs of ~16": fwd_variant(run=16),
       "double-buffered, 4 blocks an SM": fwd_variant(min_blocks=4, prefetch=True),
       "no bias tile (wrong)": fwd_variant(no_tile=True),
       "no loads (wrong)": fwd_variant(no_loads=True),
       "no compute (wrong)": fwd_variant(no_compute=True),
       "tile build 4 in flight": fwd_variant(tile_unroll=4),
       "tile build 8 in flight": fwd_variant(tile_unroll=8),
       "padding key tile skipped": fwd_variant(skip_pad_tiles=True)}
BWD = {"as built": bwd_variant(), "exact expf": bwd_variant(exact_exp=True),
       "runs of ~8": bwd_variant(run=8), "runs of ~32": bwd_variant(run=32),
       "no bias tile (wrong)": bwd_variant(no_tile=True),
       "no dbias atomics (wrong)": bwd_variant(no_atomics=True),
       "tile build 4 in flight": bwd_variant(tile_unroll=4),
       "padding key tile skipped": bwd_variant(skip_pad_tiles=True)}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    fwd, bwd = build(FWD, "fwd"), build(BWD, "bwd")
    for tag, bw, c, heads, nw, masked in (
            ("fwd stage 1", 512 * cs.BATCH, 128, 4, 512, False),
            ("fwd stage 1 masked", 512 * cs.BATCH, 128, 4, 512, True),
            ("fwd stage 3 masked", 32 * cs.BATCH, 512, 16, 32, True),
            ("fwd KSA hd 16 masked", 512 * cs.BATCH, 64, 4, 512, True)):
        n = 49
        mask = shifted_window_attn_mask(*cs.WINDOW_GRIDS[nw], 7, 3, dev) if masked else None
        bias = torch.randn(heads, n, n, generator=g, device=dev)
        qkv = torch.randn(bw, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
        ptr, el = qkv.data_ptr(), qkv.element_size()

        def call(lib, outs):
            return lib.mde_window_attention(
                ptr, ptr + c * el, ptr + 2 * c * el, bias.data_ptr(),
                None if mask is None else mask.data_ptr(), outs[0].data_ptr(), bw, n, c, heads,
                3 * c, 0 if mask is None else mask.shape[0], (c // heads) ** -0.5, 1, stream)

        compare(tag, fwd, call,
                lambda: (torch.empty(bw, n, c, dtype=torch.bfloat16, device=dev),))
    for tag, bw, c, heads, nw in (("bwd stage 1 masked", 512 * cs.TRAIN_BATCH, 128, 4, 512),
                                  ("bwd stage 3 masked", 32 * cs.TRAIN_BATCH, 512, 16, 32)):
        n = 49
        mask = shifted_window_attn_mask(*cs.WINDOW_GRIDS[nw], 7, 3, dev)
        bias = torch.randn(heads, n, n, generator=g, device=dev)
        qkv = torch.randn(bw, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(bw, n, c, generator=g, device=dev).to(torch.bfloat16)

        def call(lib, outs):
            outs[1].zero_()  # dbias is summed into a zeroed buffer, as the wrapper does
            return lib.mde_window_attention_bwd(
                qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), bw, n, c, heads, mask.shape[0],
                (c // heads) ** -0.5, 1, stream)

        compare(tag + " (with dbias zeroing)", bwd, call,
                lambda: (torch.empty_like(qkv), torch.zeros(heads, n, n, device=dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
