"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker ``gpu``) and skips without one.
The file imports nothing of JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest sets JAX up.) f32 comparisons run
with TF32 off and hold at 1e-5 (the backward ones relative to max(1, max
|plain|): their sums reach ~50); bf16 tolerances are stated in BF16_REL.
"""

import os

import numpy as np
import pytest
import torch

import mde_tpu_torch.models.oda2.red_order_reg as red_order_reg
import mde_tpu_torch.models.oda2.red_order_swin2 as flagship
from mde_tpu_torch.models import build_model
from mde_tpu_torch.ops import kernels
from mde_tpu_torch.ops.kernels.channel_attention import (channel_attention,
                                                         channel_attention_bwd,
                                                         plain_channel_attention,
                                                         plain_channel_attention_bwd)
from mde_tpu_torch.ops.kernels.depthwise import (depthwise_conv2d, depthwise_dw, depthwise_dxdw,
                                                 plain_depthwise_conv2d, plain_depthwise_dw,
                                                 plain_depthwise_dxdw)
from mde_tpu_torch.ops.kernels.glu_ff import glu_ff, plain_glu_ff
from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention,
                                                         ordered_attention_bwd,
                                                         plain_ordered_attention,
                                                         plain_ordered_attention_bwd)
from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention,
                                                        plain_window_attention_bwd,
                                                        window_attention,
                                                        window_attention_bwd,
                                                        window_attention_qk_v,
                                                        window_attention_qk_v_bwd)
from mde_tpu_torch.ops.tnn import bn_freeze_scope
from mde_tpu_torch.ops.window import shifted_window_attn_mask
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import default_adapter, make_train_step

TOL = 1e-5
# bf16, relative to max(1, max |plain|): the kernels keep the logits (K1, K2)
# and the running sums (K3) in f32 where the plain forwards round them to
# bf16. K3's plain forward rounds each of its 25 partial sums to bf16, half
# an ulp (2^-9 relative) each, so the two may differ by up to 25 * 2^-9 ~ 5%.
# The backward kernels and their plain versions both sum in f32 and round P,
# dS and the outputs to bf16 at the same places; sums in another order move
# a rounding by one ulp (2^-8), and a P or dS rounded the other way moves a
# gradient by a few, hence 3e-2 for the attentions and 1e-2 for K3's dx
# (dw is f32 from bf16 inputs: 1e-4). K4 sums its taps in f32 where its
# plain version (the JAX composite) sums them in bf16, as K3 against its
# plain forward, and GELU's slope is at most 1.13: 5e-2 as K3. K5 rounds P
# (and dS) to bf16 at the same places as its plain versions, whose scores
# are bf16 einsums: 3e-2 as the other attentions.
BF16_REL = {"window_attention": 3e-2, "ordered_attention": 3e-2, "depthwise_conv2d": 5e-2,
            "window_attention_bwd": 3e-2, "ordered_attention_bwd": 3e-2,
            "depthwise_conv2d_dxdw": 1e-2, "depthwise_conv2d_dw": 1e-4, "glu_ff": 5e-2,
            "channel_attention": 3e-2, "channel_attention_bwd": 3e-2}
NO_LAUNCHES = dict.fromkeys(kernels.KERNELS, 0)
# a train step's optimizer step on the card (ops/kernels/adamw.py)
OPTIMIZER_LAUNCHES = {"adamw": 3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _check(name, fn, plain, args, dtype, relative=False):
    before = kernels.launch_counts[name]
    outs = _as_tuple(fn(*args))
    torch.cuda.synchronize()
    assert kernels.launch_counts[name] == before + 1
    refs = _as_tuple(plain(*args))
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        if ref is None:
            assert out is None
            continue
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        tol = (TOL * (scale if relative else 1.0) if dtype == torch.float32
               else BF16_REL[name] * scale)
        assert torch.isfinite(out.float()).all()
        assert err <= tol, (name, dtype, err, tol)
    return outs


def _window_args(cuda, dtype, r, shifted, seed=0):
    rng = np.random.RandomState(seed)
    n, nh, c = r * r, 4, 128
    mask = shifted_window_attn_mask(2 * r, 4 * r, r, r // 2, cuda) if shifted else None
    bw = 3 * 8  # 3 images of 8 windows
    qkv = _randn(rng, bw, n, 3 * c).to(cuda, dtype)
    return qkv, _randn(rng, nh, n, n).to(cuda), mask, nh, (c // nh) ** -0.5


def _plain_window(qkv, bias, mask, nh, scale):
    c = qkv.shape[-1] // 3
    return plain_window_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, mask,
                                  nh, scale)


def _plain_window_bwd(qkv, dout, bias, mask, nh, scale):
    c = qkv.shape[-1] // 3
    dq, dk, dv, dbias = plain_window_attention_bwd(qkv[..., :c], qkv[..., c:2 * c],
                                                   qkv[..., 2 * c:], dout, bias, mask, nh,
                                                   scale)
    return torch.cat([dq, dk, dv], dim=-1), dbias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,shifted", [(7, False), (7, True), (4, True)])
def test_window_attention_kernel(cuda, dtype, r, shifted):
    _check("window_attention", window_attention, _plain_window,
           _window_args(cuda, dtype, r, shifted), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,shifted", [(7, False), (7, True), (4, True)])
def test_window_attention_bwd_kernel(cuda, dtype, r, shifted):
    qkv, bias, mask, nh, scale = _window_args(cuda, dtype, r, shifted, seed=6)
    dout = _randn(np.random.RandomState(7), *qkv.shape[:2], qkv.shape[2] // 3).to(cuda, dtype)
    _check("window_attention_bwd", window_attention_bwd, _plain_window_bwd,
           (qkv, dout, bias, mask, nh, scale), dtype, relative=True)


# (window side, heads, channels, images, bias, shifted[, windows an image,
# 8 if not given]): the KSA decoder's head dim 16; stage 3's 16 heads at C
# 512; bias only, mask only, neither; 144 tokens (a 12 x 12 window: the ODA
# encoder's), past the n <= 128 tensor-core bodies, on the wide ones
# (window_mma_wide in csrc/attention_mma.cuh: one block an SM, the bias
# tile filled once a mask slot, a ring of copy stages) at head dim 32 with
# both, at 16 with the mask alone, at 24 (columns 24-31 zero-filled), and
# unmasked at 48 heads of C 1536 (the ODA encoder's stage 4: 8 windows, and
# 2 windows an image at batch 1 and 8); 5 and 47 images, so that a block's
# run of windows ends inside a mask slot's images and dbias sums many
# blocks; the f32 backward there on the lean CUDA-core body (one n x n
# matrix, dbias by device atomics); 144 tokens at head dim 40, past the
# wide bodies' 32 (the CUDA-core bodies); head dim 12, not a multiple of 8
# (both on the CUDA-core body); and 47 images of 8 windows, so that a
# block's run of windows (2 or more here) crosses mask slots and dbias sums
# many windows a block
WINDOW_CASES = {"hd16": (7, 4, 64, 3, True, True), "heads16": (7, 16, 512, 3, True, True),
                "bias_only": (7, 4, 128, 3, True, False),
                "mask_only": (7, 4, 128, 3, False, True),
                "neither": (7, 4, 128, 3, False, False),
                "n144": (12, 4, 128, 3, True, True), "n144_hd16": (12, 4, 64, 3, False, True),
                "n144_heads48": (12, 48, 1536, 1, True, False),
                "n144_hd24": (12, 4, 96, 3, True, True),
                "n144_stage4_batch1": (12, 48, 1536, 1, True, False, 2),
                "n144_stage4_batch8": (12, 48, 1536, 8, True, False, 2),
                "n144_images5": (12, 6, 192, 5, True, True),
                "n144_images47": (12, 6, 192, 47, True, True),
                "n144_hd40": (12, 2, 80, 1, True, True),
                "hd12": (7, 3, 36, 3, True, True), "many_windows": (7, 4, 128, 47, True, True)}
WINDOW_BWD_CASES = list(WINDOW_CASES)


def _window_case_args(cuda, dtype, case, seed):
    r, nh, c, images, with_bias, shifted, *rest = WINDOW_CASES[case]
    windows = rest[0] if rest else 8
    rng = np.random.RandomState(seed)
    n = r * r
    mask = shifted_window_attn_mask(2 * r, 4 * r, r, r // 2, cuda) if shifted else None
    qkv = _randn(rng, windows * images, n, 3 * c).to(cuda, dtype)
    bias = _randn(rng, nh, n, n).to(cuda) if with_bias else None
    return qkv, bias, mask, nh, (c // nh) ** -0.5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_attention_kernel_shapes(cuda, dtype, case):
    _check("window_attention", window_attention, _plain_window,
           _window_case_args(cuda, dtype, case, 19), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WINDOW_BWD_CASES)
def test_window_attention_bwd_kernel_shapes(cuda, dtype, case):
    qkv, bias, mask, nh, scale = _window_case_args(cuda, dtype, case, 20)
    dout = _randn(np.random.RandomState(21), *qkv.shape[:2], qkv.shape[2] // 3).to(cuda, dtype)
    _check("window_attention_bwd", window_attention_bwd, _plain_window_bwd,
           (qkv, dout, bias, mask, nh, scale), dtype, relative=True)


@pytest.mark.gpu
def test_window_attention_kernels_refuse_misaligned_bf16_views(cuda):
    """A contiguous bf16 qkv or dout that does not start on 16 bytes is
    refused before any launch; autograd's backward copies such an output
    gradient and gives what the kernel gives on an aligned copy of it."""
    bw, n, c, nh = 8, 16, 32, 2
    qkv, bias, mask, _, scale = _window_args(cuda, torch.bfloat16, 4, True, seed=22)
    qkv, bias = qkv[:bw, :, :3 * c].contiguous(), bias[:nh]
    flat = torch.randn(bw * n * 3 * c + 1, device=cuda).to(torch.bfloat16)
    bad_qkv, bad_dout = flat[1:].view(bw, n, 3 * c), flat[1:bw * n * c + 1].view(bw, n, c)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="16-byte"):
        window_attention(bad_qkv, bias, mask, nh, scale)
    with pytest.raises(ValueError, match="16-byte"):
        window_attention_bwd(qkv, bad_dout, bias, mask, nh, scale)
    assert kernels.launch_counts == before
    x = qkv.clone().requires_grad_()
    out = window_attention(x, bias, mask, nh, scale)
    torch.cat([out.new_zeros(1), out.reshape(-1)]).backward(flat[:bw * n * c + 1])
    dqkv, _ = window_attention_bwd(qkv, bad_dout.clone(), bias, mask, nh, scale)
    assert torch.equal(x.grad, dqkv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_kernels_refuse_blocks_past_shared_memory(cuda, dtype):
    """A 14 x 14 window (196 tokens) at head dim 64, past the tensor-core
    bodies and too large for a block of the CUDA-core ones (or of the
    backward's lean body), is refused before any launch."""
    rng = np.random.RandomState(23)
    bw, n, c, nh = 2, 196, 128, 2
    qkv = _randn(rng, bw, n, 3 * c).to(cuda, dtype)
    bias = _randn(rng, nh, n, n).to(cuda)
    dout = _randn(rng, bw, n, c).to(cuda, dtype)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="shared memory"):
        window_attention(qkv, bias, None, nh, (c // nh) ** -0.5)
    with pytest.raises(ValueError, match="shared memory"):
        window_attention_bwd(qkv, dout, bias, None, nh, (c // nh) ** -0.5)
    assert kernels.launch_counts == before


# (n, heads, channels, num_emb, every index of a window equal): the
# flagship's window; the gen-1 head's (oda2_red_order_swin: one depth value,
# bias-free at its call); 49 tokens at head dim 32 (padded rows and keys); the
# tiny model's 16 tokens at head dim 8 (the k-dimension padded to 16); one
# dT bucket per window; 100 tokens at head dim 72, past the kernels' tiles
# for n and head dims up to 64 (padded to 112 rows and 80)
ORDERED_CASES = {"flagship": (64, 8, 512, 128, False), "n49": (49, 4, 128, 128, False),
                 "tiny": (16, 4, 32, 16, False), "one_bucket": (64, 8, 512, 128, True),
                 "n100": (100, 4, 288, 128, False), "gen1": (64, 8, 512, 1, True)}


def _ordered_args(cuda, dtype, with_table, seed=1, case="flagship"):
    n, nh, c, e, constant = ORDERED_CASES[case]
    rng = np.random.RandomState(seed)
    bw = 10
    q, k, v = (_randn(rng, bw, n, c).to(cuda, dtype) for _ in range(3))
    idx = rng.randint(0, e, (bw, 1 if constant else n)).astype(np.int32)
    idx = torch.from_numpy(np.repeat(idx, n // idx.shape[1], axis=1)).to(cuda)
    table = _randn(rng, 2 * e - 1, nh).to(cuda) if with_table else None
    return q, k, v, idx, table, nh, (c // nh) ** -0.5, e


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ORDERED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_table", [True, False])
def test_ordered_attention_kernel(cuda, dtype, with_table, case):
    _check("ordered_attention", ordered_attention, plain_ordered_attention,
           _ordered_args(cuda, dtype, with_table, case=case), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ORDERED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_table", [True, False])
def test_ordered_attention_bwd_kernel(cuda, dtype, with_table, case):
    q, k, v, idx, table, nh, scale, e = _ordered_args(cuda, dtype, with_table, seed=8,
                                                      case=case)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(cuda, dtype)
    args = (q, k, v, dout, idx, table, nh, scale, e)
    if not ORDERED_CASES[case][4] or table is None or dtype == torch.bfloat16:
        _check("ordered_attention_bwd", ordered_attention_bwd, plain_ordered_attention_bwd,
               args, dtype, relative=True)
        return
    # One bucket a window (one_bucket, and gen1's one depth value): every
    # row of dS sums to 0, so the exact dT is 0 and both versions' f32 dT
    # are rounding of a sum of ~40,000 terms that
    # cancel, in different orders (measured 6e-5 apart, against 1e-5 of
    # max(1, max |dT|)). dq, dk and dv are held as in every other case; dT
    # is held to 0 within 1e-5 of the sum of |dS| of its entry.
    _check("ordered_attention_bwd", lambda *a: ordered_attention_bwd(*a)[:3],
           lambda *a: plain_ordered_attention_bwd(*a)[:3], args, dtype, relative=True)
    dtable = ordered_attention_bwd(*args)[3]
    torch.cuda.synchronize()
    assert torch.isfinite(dtable).all()
    assert (dtable.abs() <= TOL * _ds_abs_sum(*args)).all()


def _ds_abs_sum(q, k, v, dout, idx, table, nh, scale, e):
    """(2E-1, heads) sums of |dS| over the pairs of each dT entry, in f32 as
    plain_ordered_attention_bwd computes dS."""
    bw, n, c = q.shape
    qh, kh, vh, doh = (t.float().reshape(bw, n, nh, c // nh) for t in (q * scale, k, v, dout))
    rel = idx[:, :, None].long() - idx[:, None, :].long() + e - 1
    p = (torch.einsum("bqhd,bkhd->bhqk", qh, kh)
         + table.t()[:, rel].permute(1, 0, 2, 3)).softmax(dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).abs()
    return torch.zeros(nh, 2 * e - 1, device=q.device).index_add_(
        1, rel.reshape(-1), ds.permute(1, 0, 2, 3).reshape(nh, -1)).t()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ordered_attention_kernels_refuse_windows_over_128(cuda, dtype):
    """144 tokens (a 12 x 12 window) is past what the kernels take: both
    wrappers raise before any launch, and nothing falls back."""
    q = torch.randn(2, 144, 64, device=cuda).to(dtype)
    idx = torch.zeros(2, 144, dtype=torch.int32, device=cuda)
    table = torch.randn(31, 4, device=cuda)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="144 tokens"):
        ordered_attention(q, q, q, idx, table, 4, 0.25, 16)
    with pytest.raises(ValueError, match="144 tokens"):
        ordered_attention_bwd(q, q, q, q, idx, table, 4, 0.25, 16)
    assert kernels.launch_counts == before


@pytest.mark.gpu
def test_ordered_attention_kernels_refuse_misaligned_bf16_views(cuda):
    """A contiguous bf16 view that does not start on 16 bytes (a slice of a
    flat buffer) is refused before any launch, since the tensor-core kernels
    copy 16-byte pieces; autograd's backward copies such an output gradient
    and gives what the kernel gives on an aligned copy of it."""
    bw, n, c, nh, e = 2, 16, 32, 4, 16
    flat = torch.randn(bw * n * c + 1, device=cuda).to(torch.bfloat16)
    bad = flat[1:].view(bw, n, c)
    ok = torch.randn(bw, n, c, device=cuda).to(torch.bfloat16)
    idx = torch.randint(0, e, (bw, n), dtype=torch.int32, device=cuda)
    table = torch.randn(2 * e - 1, nh, device=cuda)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="16-byte"):
        ordered_attention(bad, ok, ok, idx, table, nh, 0.25, e)
    with pytest.raises(ValueError, match="16-byte"):
        ordered_attention_bwd(ok, ok, ok, bad, idx, table, nh, 0.25, e)
    assert kernels.launch_counts == before
    q, k, v = (ok.clone().requires_grad_() for _ in range(3))
    out = ordered_attention(q, k, v, idx, table, nh, 0.25, e)
    torch.cat([out.new_zeros(1), out.reshape(-1)]).backward(flat)
    dq, dk, dv, _ = ordered_attention_bwd(ok, ok, ok, bad.clone(), idx, table, nh, 0.25, e)
    for got, want in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
        assert torch.equal(got, want)


# (x shape, kh, kw): odd sides, a side smaller than the kernel, one 16-byte
# vector or many; then for the two bodies of the forward (csrc/depthwise.cu):
# strips and rows that end inside the tile (19 rows, 37 columns, 136
# channels: two channel slices, the second one part full); sides smaller
# than the halo at both ends; C off the 64-channel slice and off the
# 16-byte vector (12 takes the tiled body in f32 only, 33 the column body
# in both, 2056 the tiled body); and kernels the tiled body is not compiled
# for (3x5, 9x9), which take the column body
DW_FWD_CASES = [((2, 7, 10, 12), 5, 5), ((2, 12, 24, 64), 5, 5), ((1, 5, 3, 2048), 5, 5),
                ((2, 19, 37, 136), 5, 5), ((2, 19, 37, 136), 3, 3), ((2, 19, 37, 136), 7, 7),
                ((1, 1, 1, 16), 5, 5), ((1, 1, 1, 16), 7, 7), ((1, 2, 3, 8), 5, 5),
                ((1, 2, 3, 8), 7, 7), ((2, 7, 10, 12), 7, 7), ((1, 6, 9, 33), 5, 5),
                ((1, 5, 21, 2056), 5, 5), ((2, 9, 13, 64), 3, 5), ((1, 11, 12, 16), 9, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kh,kw", DW_FWD_CASES)
def test_depthwise_kernel(cuda, dtype, shape, kh, kw):
    rng = np.random.RandomState(3)
    x = _randn(rng, *shape).to(cuda, dtype)
    w = _randn(rng, kh, kw, shape[-1]).to(cuda, dtype)
    out, = _check("depthwise_conv2d", depthwise_conv2d, plain_depthwise_conv2d, (x, w), dtype)
    # the kernel sums in f32 and rounds once: within one bf16 ulp of the f32 sum
    ref = plain_depthwise_conv2d(x.float(), w.float())
    assert ((out.float() - ref).abs() <= ref.abs() * 2 ** -8 + 1e-6).all()


# odd sides, sides smaller than the kernel (every tap clamps), one channel
# vector or two, and 3x3, 5x5, 7x7; then for the tiled dxdw body: strips and
# rows that end inside the tile, sides smaller than the halo at both ends, C
# off the 64-channel slice and off the 16-byte vector (12 and 33 take the
# gather body in bf16, 33 in f32 too)
DW_BWD_CASES = [((2, 7, 10, 12), 5), ((2, 12, 24, 64), 5), ((1, 5, 3, 2048), 5),
                ((2, 1, 2, 6), 5), ((1, 9, 11, 33), 3), ((2, 8, 9, 16), 7),
                ((2, 19, 37, 136), 5), ((2, 19, 37, 136), 3), ((2, 19, 37, 136), 7),
                ((1, 1, 1, 16), 5), ((1, 1, 1, 16), 7), ((1, 2, 3, 8), 5), ((1, 2, 3, 8), 7),
                ((1, 6, 9, 33), 5), ((1, 5, 21, 2056), 5), ((2, 5, 17, 12), 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", DW_BWD_CASES)
def test_depthwise_bwd_kernels(cuda, dtype, shape, k):
    rng = np.random.RandomState(10)
    x, g = (_randn(rng, *shape).to(cuda, dtype) for _ in range(2))
    w = (_randn(rng, k, k, shape[-1]) * 0.2).to(cuda, dtype)
    _check("depthwise_conv2d_dxdw", depthwise_dxdw, plain_depthwise_dxdw, (x, g, w), dtype,
           relative=True)
    _check("depthwise_conv2d_dw", depthwise_dw,
           lambda x, g, w: plain_depthwise_dw(x, g, k, k), (x, g, w), dtype, relative=True)


@pytest.mark.gpu
def test_depthwise_dxdw_is_deterministic(cuda):
    """dx and dw are the same bits on every run: per-(image, strip) partials
    summed in a fixed order, no atomics. dw alone's tiled body runs dxdw's
    dw role on the same strips, so it gives dxdw's dw bits."""
    rng = np.random.RandomState(11)
    for k in (5, 3, 7):
        for dtype in (torch.float32, torch.bfloat16):
            x, g = (_randn(rng, 2, 19, 37, 136).to(cuda, dtype) for _ in range(2))
            w = (_randn(rng, k, k, 136) * 0.2).to(cuda, dtype)
            assert kernels.library().mde_depthwise_conv2d_dw_tiled(
                x.data_ptr(), g.data_ptr(), 136, k, kernels.dtype_code(x)) == 1
            dx1, dw1 = depthwise_dxdw(x, g, w)
            dx2, dw2 = depthwise_dxdw(x, g, w)
            dw3, dw4 = depthwise_dw(x, g, w), depthwise_dw(x, g, w)
            torch.cuda.synchronize()
            assert torch.equal(dx1, dx2) and torch.equal(dw1, dw2)
            assert torch.equal(dw3, dw4) and torch.equal(dw3, dw1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernels_take_misaligned_views(cuda, dtype):
    """A contiguous view that does not start on 16 bytes (a slice of a flat
    buffer) is not refused: the forward, dxdw and dw launch their column and
    gather bodies, which take any alignment. The forward's two bodies sum in the same
    order, so the view gives the bits that an aligned copy gives through the
    tiled body; the backward's two bodies sum in other orders and agree
    within the stated tolerances."""
    shape, k = (2, 9, 14, 64), 5
    n = int(np.prod(shape))
    flat = torch.randn(2 * n + 1, device=cuda).to(dtype)
    bad_x, bad_g = flat[1:n + 1].view(shape), flat[n + 1:].view(shape)
    assert bad_x.data_ptr() % 16 != 0
    x, g = bad_x.clone(), bad_g.clone()
    w = (torch.randn(k, k, shape[-1], device=cuda) * 0.2).to(dtype)
    out = _check("depthwise_conv2d", depthwise_conv2d, plain_depthwise_conv2d, (bad_x, w),
                 dtype)[0]
    assert torch.equal(out, depthwise_conv2d(x, w))
    dx, dw = _check("depthwise_conv2d_dxdw", depthwise_dxdw, plain_depthwise_dxdw,
                    (bad_x, bad_g, w), dtype, relative=True)
    dx_tiled, dw_tiled = depthwise_dxdw(x, g, w)
    torch.cuda.synchronize()
    scale = max(1.0, dx_tiled.float().abs().max().item())
    tol = (TOL if dtype == torch.float32 else BF16_REL["depthwise_conv2d_dxdw"]) * scale
    assert (dx.float() - dx_tiled.float()).abs().max().item() <= tol
    scale = max(1.0, dw_tiled.abs().max().item())
    tol = (TOL if dtype == torch.float32 else BF16_REL["depthwise_conv2d_dw"]) * scale
    assert (dw - dw_tiled).abs().max().item() <= tol
    lib, code = kernels.library(), kernels.dtype_code(x)
    assert lib.mde_depthwise_conv2d_dw_tiled(bad_x.data_ptr(), bad_g.data_ptr(), shape[-1], k,
                                             code) == 0
    assert lib.mde_depthwise_conv2d_dw_tiled(x.data_ptr(), g.data_ptr(), shape[-1], k, code) == 1
    dw_gather = _check("depthwise_conv2d_dw", depthwise_dw,
                       lambda x, g, w: plain_depthwise_dw(x, g, k, k), (bad_x, bad_g, w), dtype,
                       relative=True)[0]
    assert torch.equal(depthwise_dw(x, g, w), dw_tiled)
    assert (dw_gather - dw_tiled).abs().max().item() <= tol


# (x shape, kernel): odd sides, a side smaller than the kernel, channels in
# one 16-byte vector or many, and C off the vector width (the scalar path);
# then for the two bodies of csrc/glu_ff.cu: strips, rings and channel
# slices that end inside the tile (70 columns: a last strip part full; 23
# rows: more than the ring of 10; 72 and 136 channels: a second 64-channel
# slice part full) at 3x3, 5x5 and 7x7, and sides smaller than the halo at
# both ends
GLU_CASES = [((2, 7, 10, 12), 5), ((2, 12, 24, 64), 5), ((1, 5, 3, 2048), 5),
             ((1, 9, 13, 16), 3), ((2, 6, 5, 10), 5), ((2, 23, 70, 72), 5),
             ((2, 23, 70, 72), 3), ((1, 23, 70, 72), 7), ((2, 19, 37, 136), 7),
             ((1, 2, 3, 8), 5), ((1, 2, 3, 8), 7)]


def _glu_args(cuda, dtype, shape, k, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    ab = _randn(rng, *shape[:3], 2 * c).to(cuda, dtype)
    w = (_randn(rng, k, k, c) * 0.2).to(cuda, dtype)
    return ab, w, (1 + 0.1 * _randn(rng, c)).to(cuda), (0.1 * _randn(rng, c)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", GLU_CASES)
def test_glu_ff_kernel(cuda, dtype, shape, k):
    _check("glu_ff", glu_ff, plain_glu_ff, _glu_args(cuda, dtype, shape, k), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((2, 23, 70, 72), 5), ((1, 9, 14, 64), 3),
                                     ((1, 9, 14, 64), 7)])
def test_glu_ff_bodies_give_the_same_bits(cuda, dtype, shape, k):
    """A contiguous ab that does not start on 16 bytes (a slice of a flat
    buffer) takes the column body, an aligned copy of it the tiled body: the
    two compute the same gate (the tiled body reads the bf16 sigmoid from a
    table of its computed values), sum the taps in the same order and run
    the same epilogue, so they give the same bits."""
    _, w, s, t = _glu_args(cuda, dtype, shape, k, seed=19)
    n = int(np.prod(shape[:3])) * 2 * shape[-1]
    flat = torch.randn(n + 1, device=cuda).to(dtype)
    bad_ab = flat[1:].view(*shape[:3], 2 * shape[-1])
    assert bad_ab.data_ptr() % 16 != 0
    out = _check("glu_ff", glu_ff, plain_glu_ff, (bad_ab, w, s, t), dtype)[0]
    tiled = glu_ff(bad_ab.clone(), w, s, t)
    torch.cuda.synchronize()
    assert torch.equal(out, tiled)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k", [((2, 7, 10, 12), 5), ((1, 9, 13, 64), 3)])
def test_glu_ff_grads_match_autograd_of_plain(cuda, shape, k):
    """The Function's backward (the composite recomputed through K3's
    kernels) against autograd of the plain version, both on the card."""
    ab, w, s, t = (x.requires_grad_() for x in _glu_args(cuda, torch.float32, shape, k, 15))
    g = torch.randn(ab.shape[:3] + (shape[-1],), generator=torch.Generator().manual_seed(16))
    g = g.to(cuda)
    kernels.reset_launch_counts()
    ours = torch.autograd.grad(glu_ff(ab, w, s, t), (ab, w, s, t), g)
    ref = torch.autograd.grad(plain_glu_ff(ab, w, s, t), (ab, w, s, t), g)
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(NO_LAUNCHES, glu_ff=1, depthwise_conv2d=1,
                                         depthwise_conv2d_dxdw=1)
    for a, b in zip(ours, ref):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


# (C, EC): square head dims, and rectangular either way (hd != ehd)
CHANNEL_CASES = [(64, 64), (32, 64), (48, 16)]


def _channel_args(cuda, dtype, c, ec, seed=0):
    rng = np.random.RandomState(seed)
    bw, n = 10, 49
    q = _randn(rng, bw, n, c).to(cuda, dtype)
    kv = _randn(rng, bw, n, 2 * ec).to(cuda, dtype)
    return q, kv, 4, n ** -0.5


def _plain_channel(q, kv, nh, scale):
    ec = kv.shape[-1] // 2
    return plain_channel_attention(q, kv[..., :ec], kv[..., ec:], nh, scale)


def _plain_channel_bwd(q, kv, dout, nh, scale):
    ec = kv.shape[-1] // 2
    dq, dk, dv = plain_channel_attention_bwd(q, kv[..., :ec], kv[..., ec:], dout, nh, scale)
    return dq, torch.cat([dk, dv], dim=-1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ec", CHANNEL_CASES)
def test_channel_attention_kernel(cuda, dtype, c, ec):
    _check("channel_attention", channel_attention, _plain_channel,
           _channel_args(cuda, dtype, c, ec), dtype)


# (n, C, EC, heads) for the forward's two bodies (csrc/channel_attention.cu):
# the KSA decoder's three stages (49 tokens, head dims 16 at 4, 8 and 16
# heads); a window off the 16-row tile (33 tokens); head dim 8 (the
# d- and e-tiles half padding); head dims 24 and 40 at 100 tokens (the
# larger tensor-core instantiation, both head dims padded); 128 tokens at
# head dim 64; 3 and 6 heads; bf16 at other shapes takes the CUDA-core
# body, as the CHANNEL_CASES' head dim 12 does
CHANNEL_SHAPES = {"ksa0": (49, 64, 64, 4), "ksa1": (49, 128, 128, 8),
                  "ksa2": (49, 256, 256, 16), "n33": (33, 64, 64, 4), "hd8": (49, 32, 32, 4),
                  "hd24x40": (100, 96, 160, 4), "n128hd64": (128, 128, 128, 2),
                  "heads3": (49, 48, 48, 3), "heads6": (49, 96, 96, 6)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CHANNEL_SHAPES))
def test_channel_attention_kernel_shapes(cuda, dtype, case):
    n, c, ec, nh = CHANNEL_SHAPES[case]
    rng = np.random.RandomState(20)
    q = _randn(rng, 6, n, c).to(cuda, dtype)
    kv = _randn(rng, 6, n, 2 * ec).to(cuda, dtype)
    _check("channel_attention", channel_attention, _plain_channel, (q, kv, nh, n ** -0.5),
           dtype)


@pytest.mark.gpu
def test_channel_attention_refuses_misaligned_bf16_views(cuda):
    """A contiguous bf16 q or kv that does not start on 16 bytes is refused
    before any launch (the tensor-core body copies 16-byte pieces)."""
    bw, n, c = 4, 49, 64
    q, kv, nh, scale = _channel_args(cuda, torch.bfloat16, c, c, seed=21)
    q, kv = q[:bw].contiguous(), kv[:bw].contiguous()
    flat = torch.randn(bw * n * 2 * c + 1, device=cuda).to(torch.bfloat16)
    bad_q, bad_kv = flat[1:bw * n * c + 1].view(bw, n, c), flat[1:].view(bw, n, 2 * c)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="16-byte"):
        channel_attention(bad_q, kv, nh, scale)
    with pytest.raises(ValueError, match="16-byte"):
        channel_attention(q, bad_kv, nh, scale)
    assert kernels.launch_counts == before
    _check("channel_attention", channel_attention, _plain_channel, (q, kv, nh, scale),
           torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CHANNEL_SHAPES))
def test_channel_attention_bwd_kernel_shapes(cuda, dtype, case):
    """The backward's two bodies (csrc/channel_attention_bwd.cu) at the
    forward's shapes: bf16 on the tensor cores, f32 on the CUDA cores (bf16
    on the CUDA cores: CHANNEL_CASES' head dim 12)."""
    n, c, ec, nh = CHANNEL_SHAPES[case]
    rng = np.random.RandomState(22)
    q = _randn(rng, 6, n, c).to(cuda, dtype)
    kv = _randn(rng, 6, n, 2 * ec).to(cuda, dtype)
    dout = _randn(rng, 6, n, c).to(cuda, dtype)
    _check("channel_attention_bwd", channel_attention_bwd, _plain_channel_bwd,
           (q, kv, dout, nh, n ** -0.5), dtype, relative=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ksa0", "hd24x40"])
def test_channel_attention_bwd_is_deterministic(cuda, case):
    """dq and dkv are the same bits on every run: no gradient is summed
    across (window, head), so neither body has atomics."""
    n, c, ec, nh = CHANNEL_SHAPES[case]
    rng = np.random.RandomState(23)
    for dtype in (torch.float32, torch.bfloat16):
        q, dout = (_randn(rng, 6, n, c).to(cuda, dtype) for _ in range(2))
        kv = _randn(rng, 6, n, 2 * ec).to(cuda, dtype)
        first = channel_attention_bwd(q, kv, dout, nh, n ** -0.5)
        second = channel_attention_bwd(q, kv, dout, nh, n ** -0.5)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_channel_attention_bwd_refuses_misaligned_bf16_views(cuda):
    """A contiguous bf16 q, kv or dout that does not start on 16 bytes is
    refused by the backward before any launch, as q and kv are by the
    forward; f32 views take the CUDA-core body at any alignment."""
    bw, n, c = 4, 49, 64
    nh, scale = 4, n ** -0.5
    flat = torch.randn(bw * n * 2 * c + 1, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        buf = flat.to(dtype)
        q, kv, dout = (buf[:bw * n * m].view(bw, n, m).clone() for m in (c, 2 * c, c))
        bad = {"q": buf[1:bw * n * c + 1].view(bw, n, c),
               "kv": buf[1:].view(bw, n, 2 * c),
               "dout": buf[1:bw * n * c + 1].view(bw, n, c)}
        for name, view in bad.items():
            assert view.data_ptr() % 16 != 0
            args = {"q": q, "kv": kv, "dout": dout}
            args[name] = view
            call = (args["q"], args["kv"], args["dout"], nh, scale)
            if dtype == torch.bfloat16:
                before = dict(kernels.launch_counts)
                with pytest.raises(ValueError, match="16-byte"):
                    channel_attention_bwd(*call)
                assert kernels.launch_counts == before
            else:
                _check("channel_attention_bwd", channel_attention_bwd, _plain_channel_bwd, call,
                       dtype, relative=True)
        _check("channel_attention_bwd", channel_attention_bwd, _plain_channel_bwd,
               (q, kv, dout, nh, scale), dtype, relative=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ec", CHANNEL_CASES)
def test_channel_attention_bwd_kernel(cuda, dtype, c, ec):
    q, kv, nh, scale = _channel_args(cuda, dtype, c, ec, seed=17)
    dout = _randn(np.random.RandomState(18), *q.shape).to(cuda, dtype)
    _check("channel_attention_bwd", channel_attention_bwd, _plain_channel_bwd,
           (q, kv, dout, nh, scale), dtype, relative=True)


def _grads_on_card_and_cpu(fn, inputs, grad_of, dout):
    """Gradients of ``fn`` with respect to the inputs at ``grad_of``, on the
    card (the kernels' Functions) and on copies on the CPU (the plain ones)."""
    out = []
    for dev in ("cuda", "cpu"):
        args = [t.detach().to(dev).requires_grad_(i in grad_of) if torch.is_tensor(t) else t
                for i, t in enumerate(inputs)]
        y = fn(*args)
        out.append(torch.autograd.grad(y, [args[i] for i in grad_of], dout.to(dev)))
    return out


@pytest.mark.gpu
def test_gradients_flow_through_every_wrapper(cuda):
    """Each kernel's Function gives the card the gradients that its plain
    version gives the CPU, launching its backward kernel once."""
    kernels.reset_launch_counts()
    qkv, bias, mask, nh, scale = _window_args(cuda, torch.float32, 7, True, seed=11)
    dout = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)
    card, cpu = _grads_on_card_and_cpu(window_attention, (qkv, bias, mask, nh, scale),
                                       (0, 1), dout)
    q, k, v, idx, table, nh, scale, e = _ordered_args(cuda, torch.float32, True, seed=12)
    card2, cpu2 = _grads_on_card_and_cpu(ordered_attention, (q, k, v, idx, table, nh, scale, e),
                                         (0, 1, 2, 4), torch.randn(q.shape))
    x = torch.randn(2, 9, 14, 64, device=cuda)
    w = torch.randn(5, 5, 64, device=cuda) * 0.2
    card3, cpu3 = _grads_on_card_and_cpu(depthwise_conv2d, (x, w), (0, 1), torch.randn(x.shape))
    card4, cpu4 = _grads_on_card_and_cpu(depthwise_conv2d, (x, w), (1,), torch.randn(x.shape))
    ab, w2, s, t = _glu_args(cuda, torch.float32, (2, 9, 14, 16), 5, seed=13)
    card5, cpu5 = _grads_on_card_and_cpu(glu_ff, (ab, w2, s, t), (0, 1, 2, 3),
                                         torch.randn(2, 9, 14, 16))
    q2, kv, nh2, scale2 = _channel_args(cuda, torch.float32, 32, 64, seed=14)
    card6, cpu6 = _grads_on_card_and_cpu(channel_attention, (q2, kv, nh2, scale2), (0, 1),
                                         torch.randn(q2.shape))
    torch.cuda.synchronize()
    # glu_ff's backward recomputes through K3: one more K3 forward and dxdw
    assert kernels.launch_counts == {
        "window_attention": 1, "window_attention_bwd": 1, "ordered_attention": 1,
        "ordered_attention_bwd": 1, "depthwise_conv2d": 3, "depthwise_conv2d_dxdw": 2,
        "depthwise_conv2d_dw": 1, "glu_ff": 1, "channel_attention": 1,
        "channel_attention_bwd": 1, "adamw": 0}
    for a, b in zip(card + card2 + card3 + card4 + card5 + card6,
                    cpu + cpu2 + cpu3 + cpu4 + cpu5 + cpu6):
        scale = max(1.0, b.abs().max().item())
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale


TINY = dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32, num_heads=4,
            num_repeats=2, num_emb=16, window_size=4, neck_type="red33")
TINY_KW = dict(resize_to_multiple=False, encoder_kwargs=dict(
    embed_dim=16, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4))


@pytest.mark.gpu
def test_tiny_flagship_on_card_matches_cpu(cuda):
    cpu_model = build_model(TINY, 0.001, 80.0, device="cpu", seed=4, use_checkpoint=False,
                            **TINY_KW)
    gpu_model = build_model(TINY, 0.001, 80.0, device=cuda, seed=4, use_checkpoint=False,
                            **TINY_KW)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 96, 3).astype(np.float32))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, outs = gpu_model(x.to(cuda))
        ref, _ = cpu_model(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(NO_LAUNCHES, window_attention=6, ordered_attention=4,
                                         depthwise_conv2d=4)
    assert (out.cpu() - ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_tiny_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One f32 train step on the card against the same step on the CPU,
    the CPU fed the card's depth-index maps (a bucket the two round apart
    would change the bias table's gradient). Loss and logs within 1e-4 of
    their size, gradients within 1e-3 of each tensor's max |g| (or of 1% of
    the largest one), BatchNorm statistics within 1e-4, and the new
    parameters within lr0 (Adam's first update is about lr0 * sign(g), so
    a gradient near 0 may move either way)."""
    opt = {"model": TINY, "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True},
           "optimizer": {"lr": 1e-4, "weight_decay": 0.1, "eps": 1e-6},
           "scheduler": {"name": "onecycle"}, "train": {"grad_norm": 0.1}}
    rng = np.random.RandomState(6)
    batch = {"image": rng.rand(2, 64, 96, 3).astype(np.float32),
             "depth": rng.uniform(0.5, 60.0, (2, 64, 96, 1)).astype(np.float32)}
    seen, real = [], flagship._quantize_logit
    results = []
    for dev in (cuda, torch.device("cpu")):
        model = build_model(TINY, 0.001, 80.0, device=dev, seed=7, path_drop_prob=0.0,
                            use_checkpoint=False, **TINY_KW)
        state = TrainState.create(model, opt, 100)
        grads = {}
        update = state.optimizer.update
        state.optimizer.update = lambda g, update=update: (grads.update(
            {n: t.detach().cpu().clone() for n, t in g.items()}), update(g))
        if dev.type == "cuda":
            quantize = lambda logit, e: seen.append(real(logit, e)) or seen[-1]  # noqa: E731
        else:
            replay = iter(seen)
            quantize = lambda logit, e: next(replay).cpu()  # noqa: E731
        monkeypatch.setattr(flagship, "_quantize_logit", quantize)
        kernels.reset_launch_counts()
        _, logs = make_train_step(opt, 0.001, 80.0)(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == dict(
                NO_LAUNCHES, window_attention=6, window_attention_bwd=6, ordered_attention=4,
                ordered_attention_bwd=4, depthwise_conv2d=4, depthwise_conv2d_dxdw=4,
                **OPTIMIZER_LAUNCHES)
        results.append(({k: float(v) for k, v in logs.items()}, grads,
                        {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    (logs, grads, weights), (ref_logs, ref_grads, ref_weights) = results
    for key in ("loss", "grad_norm", "param_norm"):
        assert abs(logs[key] - ref_logs[key]) <= 1e-4 * max(1.0, abs(ref_logs[key])), key
    floor = 1e-2 * max(g.abs().max().item() for g in ref_grads.values())
    for name, g in ref_grads.items():
        assert (grads[name] - g).abs().max().item() <= 1e-3 * max(g.abs().max().item(), floor)
    for name, value in ref_weights.items():
        tol = 1e-4 * max(1.0, value.abs().max().item()) if "running" in name else 1e-4 / 25
        if value.is_floating_point():
            assert (weights[name] - value).abs().max().item() <= tol, name


KSA_TINY = dict(name="oda2_ksa_reg", encoder_type="custom", dec_dim=64, depths=(2, 2, 2, 2),
                dec_num_heads=(2, 2, 4, 4), window_size=4)


@pytest.mark.gpu
def test_tiny_ksa_on_card_matches_cpu(cuda):
    """The tiny oda2_ksa_reg of the CPU tests: its forward on the card
    (K1 in the 6 encoder and 8 decoder blocks, K5 in the 6 KSA blocks)
    against the CPU's, and the gradients of a training-mode forward (with
    BatchNorm frozen: the PPM's 1x1 pooled BatchNorm over two images leaves
    its conv a gradient of rounding noise) within 1e-3 of each tensor's max
    |g| (or of 1% of the largest one)."""
    kw = dict(TINY_KW, path_drop_prob=0.0)
    cpu_model = build_model(KSA_TINY, 0.001, 80.0, device="cpu", seed=8, **kw)
    gpu_model = build_model(KSA_TINY, 0.001, 80.0, device=cuda, seed=8, **kw)
    x = torch.from_numpy(np.random.RandomState(9).rand(2, 64, 96, 3).astype(np.float32))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, _ = gpu_model(x.to(cuda))
        ref, _ = cpu_model(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(NO_LAUNCHES, window_attention=14, channel_attention=6)
    assert out.shape == (2, 14, 22, 1)
    assert (out.cpu() - ref).abs().max().item() <= 1e-3
    grads = []
    for model, dev in ((gpu_model, cuda), (cpu_model, torch.device("cpu"))):
        model.train()
        with bn_freeze_scope(model):
            pred, _ = model(x.to(dev))
            grads.append(torch.autograd.grad(pred.square().mean(), list(model.parameters())))
    assert kernels.launch_counts["channel_attention_bwd"] == 6
    floor = 1e-2 * max(g.abs().max().item() for g in grads[1])
    for a, b in zip(*grads):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * max(b.abs().max().item(), floor)


# the data path and the driver on the card (tests/test_torch_port_data.py and
# tests/test_torch_port_driver.py hold them against the JAX package on the CPU)
DRIVER_OPT = {
    "checkpoint": "", "wandb": {"mode": "disabled"}, "model": dict(TINY, num_repeats=1),
    "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True},
    "dataset": {"data_type": "NYU", "data_path": "/nonexistent", "img_size": [64, 64]},
    "dataloader": {"batch_size": 4, "num_workers": 2},
    "optimizer": {"lr": 1e-4, "weight_decay": 0.01},
    "scheduler": {"name": "onecycle", "pct_start": 0.25, "div_factor": 25,
                  "final_div_factor": 100},
    "train": {"print_freq": 2, "valid_freq": 2, "epoch": 1, "num_accum": 2, "grad_norm": 0.1},
    "eval": {"max_depth_eval": 10.0, "min_depth_eval": 0.001, "garg_crop": False,
             "eigen_crop": True, "flip_eval": False},
}


@pytest.mark.gpu
@pytest.mark.parametrize("drop_edge", [False, True], ids=["bands", "drop_edge"])
def test_augment_on_card_matches_cpu(cuda, drop_edge):
    """The same draws through ``apply`` on the card and on the CPU, for
    three seeds: the normalised images within 1e-6, depth equal. The gamma
    is computed in f64 and rounded once, so the two sides differ only where
    f64 ``pow``'s last-ulp error moves that rounding."""
    from mde_tpu_torch.data import augment
    cfg = augment.AugmentConfig(out_height=352, out_width=704, degree=1.0, data_type="KITTI",
                                clip_depth=70.0, height_drop=(0.3, 2), width_drop=(0.25, 2),
                                drop_edge=drop_edge)
    errs = []
    for seed in (3, 4, 5):
        rng = np.random.RandomState(10 + seed)
        images = torch.from_numpy(rng.rand(4, 352, 1216, 3).astype(np.float32))
        depths = torch.from_numpy((rng.rand(4, 352, 1216, 1) * 80).astype(np.float32))
        params = augment.draw_params(cfg, 4, (352, 1216),
                                     torch.Generator(device=cuda).manual_seed(seed))
        img, depth = augment.apply(cfg, params, images.to(cuda), depths.to(cuda))
        ref_img, ref_depth = augment.apply(cfg, {k: v.cpu() for k, v in params.items()},
                                           images, depths)
        errs.append((img.cpu() - ref_img).abs().max().item())
        assert torch.equal(depth.cpu(), ref_depth), seed
    print(f"augment, card vs CPU, max_abs_err by seed: {errs}")
    assert max(errs) <= 1e-6, errs


@pytest.mark.gpu
def test_loader_epoch_on_card(cuda):
    from mde_tpu_torch.data.dataset import DepthDataset
    from mde_tpu_torch.data.loader import DataLoader
    ds = DepthDataset("", "KITTI", "train", synthetic_len=8)
    batches = list(DataLoader(ds, 4, shuffle=True, num_workers=2).epoch(0))
    assert len(batches) == 2
    for b in batches:
        assert b["image"].device.type == "cuda" and b["image"].dtype == torch.float32
        assert b["image"].shape == (4, 352, 704, 3) and b["depth"].shape == (4, 352, 704, 1)
        assert torch.isfinite(b["image"]).all() and b["depth"].min() >= 0


@pytest.mark.gpu
def test_tiny_trainer_fit_on_card(cuda, tmp_path):
    from mde_tpu_torch.core.config import load_config
    from mde_tpu_torch.train.driver import Trainer
    opt = load_config(dict(DRIVER_OPT, output_dir=str(tmp_path)))
    trainer = Trainer(opt, model_overrides=dict(TINY_KW, use_checkpoint=False))
    kernels.reset_launch_counts()
    metrics = trainer.fit(max_steps=2)
    torch.cuda.synchronize()
    assert trainer.global_step == 2 and next(trainer.model.parameters()).is_cuda
    assert len(metrics) == 9 and all(np.isfinite(v) for v in metrics.values())
    assert kernels.launch_counts["window_attention_bwd"] == 2 * 2 * 6
    assert os.listdir(tmp_path / "checkpoints") == ["step_2"]


# K1's q|k + separate-v entry at the NewCRFs decoder's shapes: crf0 (C 128,
# 4 heads) and crf3 (C 1024, 32 heads), head dim 32, 7x7 windows; and at the
# ODA encoder's stage 1 (C 192, 6 heads, 12x12 windows: the wide bodies);
# 3 images of 8 windows, with and without the SW-MSA mask
QK_V_CASES = {"crf0": (128, 4, 7), "crf3": (1024, 32, 7), "oda_n144": (192, 6, 12)}


def _qk_v_args(cuda, dtype, case, shifted, seed):
    c, nh, r = QK_V_CASES[case]
    n = r * r
    rng = np.random.RandomState(seed)
    mask = shifted_window_attn_mask(2 * r, 4 * r, r, r // 2, cuda) if shifted else None
    qk = _randn(rng, 24, n, 2 * c).to(cuda, dtype)
    v = _randn(rng, 24, n, c).to(cuda, dtype)
    return qk, v, _randn(rng, nh, n, n).to(cuda), mask, nh, (c // nh) ** -0.5


def _plain_qk_v(qk, v, bias, mask, nh, scale):
    c = v.shape[-1]
    return plain_window_attention(qk[..., :c], qk[..., c:], v, bias, mask, nh, scale)


def _plain_qk_v_bwd(qk, v, dout, bias, mask, nh, scale):
    c = v.shape[-1]
    dq, dk, dv, dbias = plain_window_attention_bwd(qk[..., :c], qk[..., c:], v, dout, bias,
                                                   mask, nh, scale)
    return torch.cat([dq, dk], dim=-1), dv, dbias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(QK_V_CASES))
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_qk_v_kernel(cuda, dtype, case, shifted):
    _check("window_attention", window_attention_qk_v, _plain_qk_v,
           _qk_v_args(cuda, dtype, case, shifted, 23), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(QK_V_CASES))
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_qk_v_bwd_kernel(cuda, dtype, case, shifted):
    qk, v, bias, mask, nh, scale = _qk_v_args(cuda, dtype, case, shifted, 24)
    dout = _randn(np.random.RandomState(25), *v.shape).to(cuda, dtype)
    _check("window_attention_bwd", window_attention_qk_v_bwd, _plain_qk_v_bwd,
           (qk, v, dout, bias, mask, nh, scale), dtype, relative=True)


@pytest.mark.gpu
def test_window_attention_qk_v_refuses_bf16_rows_off_16_bytes(cuda):
    """bf16 qk and v whose rows do not start on 16 bytes (C 36) are refused
    before any launch; the same shapes in f32 run."""
    rng = np.random.RandomState(26)
    qk, v = _randn(rng, 8, 49, 72).to(cuda), _randn(rng, 8, 49, 36).to(cuda)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="16-byte"):
        window_attention_qk_v(qk.bfloat16(), v.bfloat16(), None, None, 3, 12 ** -0.5)
    assert kernels.launch_counts == before
    _check("window_attention", window_attention_qk_v, _plain_qk_v,
           (qk, v, None, None, 3, 12 ** -0.5), torch.float32)


NEWCRFS_TINY = dict(name="newcrfs", version="custom04")
NEWCRFS_KW = dict(path_drop_prob=0.0, encoder_kwargs=dict(
    embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), in_channels=(8, 16, 32, 64),
    crf_dims=(8, 16, 32, 64)))


@pytest.mark.gpu
def test_tiny_newcrfs_on_card_matches_cpu(cuda):
    """The tiny NewCRFs of the CPU tests at 57x90: its forward on the card
    (K1 in the 5 encoder blocks through the fused entry and in the 8 CRF
    blocks through the q|k + v entry) against the CPU's, and the gradients
    of a training-mode forward with BatchNorm frozen (K1 bwd 13 times)
    within 1e-3 of each tensor's max |g| (or of 1% of the largest one)."""
    cpu_model = build_model(NEWCRFS_TINY, 0.001, 10.0, device="cpu", seed=10, **NEWCRFS_KW)
    gpu_model = build_model(NEWCRFS_TINY, 0.001, 10.0, device=cuda, seed=10, **NEWCRFS_KW)
    x = torch.from_numpy(np.random.RandomState(11).rand(2, 57, 90, 3).astype(np.float32))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = gpu_model(x.to(cuda))
        ref = cpu_model(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(NO_LAUNCHES, window_attention=13)
    assert kernels.entry_counts == {"window_attention_qk_v": 8}
    assert out.shape == (2, 60, 92, 1)
    assert (out.cpu() - ref).abs().max().item() <= 1e-3
    grads = []
    for model, dev in ((gpu_model, cuda), (cpu_model, torch.device("cpu"))):
        model.train()
        with bn_freeze_scope(model):
            model(x.to(dev)).square().mean().backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention_bwd"] == 13
    assert kernels.entry_counts == {"window_attention_qk_v": 16, "window_attention_qk_v_bwd": 8}
    floor = 1e-2 * max(g.abs().max().item() for g in grads[1].values())
    for name, g in grads[1].items():
        assert (grads[0][name] - g).abs().max().item() <= 1e-3 * max(g.abs().max().item(),
                                                                      floor), name


# the tiny ODA2 siblings of tests/test_torch_port_oda2_red*.py on 64x96
# images, with the encoder of TINY_KW: (config, launches of one forward,
# the module whose _logit_to_indices the head calls, or None)
SIBLINGS_TINY = {
    "oda2_red_order_reg": (dict(num_repeats=2, num_emb=16, reduction_ratio=4),
                           dict(window_attention=6, depthwise_conv2d=4), red_order_reg),
    "oda2_red_order_cls": (dict(num_repeats=2, num_emb=16, reduction_ratio=4),
                           dict(window_attention=6, depthwise_conv2d=4), None),
    "oda2_red_order_swin": (dict(num_repeats=2, num_emb=16, window_size=4),
                            dict(window_attention=6, ordered_attention=4), red_order_reg),
    "oda2_red_reg": ({}, dict(window_attention=6), None),
    "oda2_conv": ({}, dict(window_attention=6), None),
    # the ODA2 Luna half: the Luna attentions are plain einsums
    "oda2_luna_reg": (dict(num_aux=8, aux_dim=16), dict(window_attention=6), None),
    "oda2_luna_cls": (dict(num_aux=8, aux_dim=16), dict(window_attention=6), None),
    "oda2_red_luna_reg": (dict(num_aux=6, num_layers=2), dict(window_attention=6), None)}
# bf16 maps, card against CPU, in metres (depth range 80 m): about three
# times the largest gap of each sound model on an H100 (tools/sibling_bf16_gaps.py:
# 0.3125, 0.0490, 0.4688, 0.1922, 0.0390 m for the siblings; 0.0098,
# 0.0043 (the cls bin centers included) and 0.2276 m for the Luna models).
# The kernels keep f32 sums where the plain versions round to bf16, and a
# bf16 sigmoid in [0.5, 1) moves in steps of 2^-8, 0.3125 m
SIBLING_BF16_TOL = {"oda2_red_order_reg": 1.0, "oda2_red_order_cls": 0.15,
                    "oda2_red_order_swin": 1.5, "oda2_red_reg": 0.6, "oda2_conv": 0.12,
                    "oda2_luna_reg": 0.03, "oda2_luna_cls": 0.013, "oda2_red_luna_reg": 0.7}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SIBLINGS_TINY))
def test_tiny_sibling_on_card_matches_cpu(cuda, name, dtype, monkeypatch):
    """A tiny sibling's forward on the card (exact launches) against the
    CPU's, the CPU fed the card's index maps: f32 within 1e-3 m, bf16
    within the model's SIBLING_BF16_TOL; the maps the loss takes
    (``default_adapter``), and the cls Luna model's bin centers."""
    extra, launches, module = SIBLINGS_TINY[name]
    cfg = dict(extra, name=name, encoder_type="custom", dec_dim=32, num_heads=4)
    kw = dict(TINY_KW, use_checkpoint=False, dtype=dtype)
    x = torch.from_numpy(np.random.RandomState(12).rand(2, 64, 96, 3).astype(np.float32))
    seen = []
    outs = []
    for dev in (cuda, torch.device("cpu")):
        if module is not None:
            real = module._logit_to_indices
            replay = iter(list(seen))
            monkeypatch.setattr(module, "_logit_to_indices", (
                (lambda logit, e: seen.append(real(logit, e)) or seen[-1]) if dev.type == "cuda"
                else (lambda logit, e: next(replay).cpu())))
        model = build_model(cfg, 0.001, 80.0, device=dev, seed=13, **kw)
        kernels.reset_launch_counts()
        with torch.no_grad():
            out = model(x.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == dict(NO_LAUNCHES, **launches)
        maps, centers = default_adapter(out)
        outs.append([m.cpu() for m in maps + (() if centers is None else (centers,))])
    tol = 1e-3 if dtype == torch.float32 else SIBLING_BF16_TOL[name]
    for a, b in zip(*outs):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= tol, (name, (a - b).abs().max().item())


# a train step's backward launches a microbatch of each sibling's decoder
# at DRIVER_OPT's one repeat: K2 bwd in gen-1's 2 SAs, K3 dxdw in reg's and
# cls's 2 FFs
SIBLING_DECODER_BWD = {"oda2_red_order_reg": ("depthwise_conv2d_dxdw", 2),
                       "oda2_red_order_cls": ("depthwise_conv2d_dxdw", 2),
                       "oda2_red_order_swin": ("ordered_attention_bwd", 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SIBLINGS_TINY))
def test_tiny_sibling_trainer_fit_on_card(cuda, name, tmp_path):
    """Two steps of ``Trainer.fit`` of a tiny sibling on the card (batch 4
    in two microbatches): the backward launches of 2 x 2 microbatches,
    finite metrics, the checkpoint."""
    from mde_tpu_torch.core.config import load_config
    from mde_tpu_torch.train.driver import Trainer
    model = dict(DRIVER_OPT["model"], name=name, reduction_ratio=4, num_aux=8, aux_dim=16,
                 num_layers=1)
    opt = load_config(dict(DRIVER_OPT, model=model, output_dir=str(tmp_path)))
    trainer = Trainer(opt, model_overrides=dict(TINY_KW, use_checkpoint=False))
    kernels.reset_launch_counts()
    metrics = trainer.fit(max_steps=2)
    torch.cuda.synchronize()
    assert trainer.global_step == 2 and next(trainer.model.parameters()).is_cuda
    assert len(metrics) == 9 and all(np.isfinite(v) for v in metrics.values())
    assert kernels.launch_counts["window_attention_bwd"] == 2 * 2 * 6
    kernel, per_micro = SIBLING_DECODER_BWD.get(name, ("ordered_attention_bwd", 0))
    assert kernels.launch_counts[kernel] == 2 * 2 * per_micro
    assert os.listdir(tmp_path / "checkpoints") == ["step_2"]


# one train step of the tiny KSA and gen-1 models at batch 2 (no recompute,
# stochastic depth off): (config, the kernel whose module leaves it for
# JAX's einsum path in training with attention dropout, launches of one
# step at rate 0). The KSA decoder's 8 W-MSAs leave K1 too; the encoder's
# 6 blocks keep it
DROPOUT_STEPS = {
    "oda2_ksa_reg": (KSA_TINY, dict(window_attention=14, window_attention_bwd=14,
                                    channel_attention=6, channel_attention_bwd=6),
                     dict(window_attention=6, window_attention_bwd=6)),
    "oda2_red_order_swin": (dict(name="oda2_red_order_swin", encoder_type="custom", dec_dim=32,
                                 num_heads=4, num_repeats=2, num_emb=16, window_size=4),
                            dict(window_attention=6, window_attention_bwd=6,
                                 ordered_attention=4, ordered_attention_bwd=4),
                            dict(window_attention=6, window_attention_bwd=6)),
    # the flagship: its encoder draws no dropout (JAX's build fixes it at 0),
    # its ordered SAs leave K2 at attention dropout; the FFs keep K3
    "oda2_red_order_swin2": (TINY, dict(window_attention=6, window_attention_bwd=6,
                                        ordered_attention=4, ordered_attention_bwd=4,
                                        depthwise_conv2d=4, depthwise_conv2d_dxdw=4),
                             dict(window_attention=6, window_attention_bwd=6,
                                  depthwise_conv2d=4, depthwise_conv2d_dxdw=4))}


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", list(DROPOUT_STEPS))
def test_attention_dropout_step_leaves_the_kernels_as_jax_does(cuda, name, rate):
    """A train step of the tiny KSA (K5 and the decoder's K1), gen-1 (K2)
    and flagship (K2) models at ``attn_drop_prob`` 0.1 takes JAX's einsum
    path: those kernels launch no time in it; at rate 0 exactly as usual.
    The logs are finite."""
    cfg, usual, dropping = DROPOUT_STEPS[name]
    cfg = dict(cfg, attn_drop_prob=rate)
    opt = {"model": cfg, "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True},
           "optimizer": {"lr": 1e-4, "weight_decay": 0.1, "eps": 1e-6},
           "scheduler": {"name": "onecycle"}, "train": {"grad_norm": 0.1}}
    rng = np.random.RandomState(14)
    batch = {"image": rng.rand(2, 64, 96, 3).astype(np.float32),
             "depth": rng.uniform(0.5, 60.0, (2, 64, 96, 1)).astype(np.float32)}
    model = build_model(cfg, 0.001, 80.0, device=cuda, seed=15, path_drop_prob=0.0,
                        use_checkpoint=False, **TINY_KW)
    state = TrainState.create(model, opt, 100)
    kernels.reset_launch_counts()
    _, logs = make_train_step(opt, 0.001, 80.0)(state, batch,
                                                torch.Generator(device=cuda).manual_seed(16))
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(NO_LAUNCHES, **(dropping if rate else usual),
                                         **OPTIMIZER_LAUNCHES)
    assert all(np.isfinite(float(v)) for v in logs.values())


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "save_sa", "save_sa_conv", "save_sa_conv_glu"])
def test_recompute_replays_the_global_generators_masks(cuda, policy, monkeypatch):
    """The tiny flagship's forward and backward at batch 2, stochastic
    depth 0.2, dropout 0.2 and attention dropout 0.1 drawn from the global
    CUDA generator (no ``generator``), recomputing under ``policy``: the
    gradients of the same step without recompute from the same seed within
    1e-4 of each tensor's max |g| (floor 1% of the largest), and the
    generator left where that step leaves it."""
    monkeypatch.setenv("MDE_REMAT_POLICY", policy)
    x = torch.from_numpy(np.random.RandomState(17).rand(2, 64, 96, 3).astype(np.float32))
    cfg = dict(TINY, drop_prob=0.2, attn_drop_prob=0.1)

    def step(use_checkpoint):
        model = build_model(cfg, 0.001, 80.0, device=cuda, seed=18, path_drop_prob=0.2,
                            use_checkpoint=use_checkpoint, **TINY_KW).train()
        torch.cuda.manual_seed(19)
        _, outs = model(x.to(cuda))
        sum(o.mean() for o in outs).backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        return grads, torch.cuda.get_rng_state(cuda)

    ref, ref_state = step(False)
    grads, state = step(True)
    assert torch.equal(state, ref_state)
    floor = 1e-2 * max(g.abs().max().item() for g in ref.values())
    worst = max(((grads[n] - g).abs().max().item() / max(g.abs().max().item(), floor), n)
                for n, g in ref.items())
    assert worst[0] <= 1e-4, worst


# the tiny AdaBins and Depthformer v1-v8 of tests/test_torch_port_adabins.py,
# tests/test_torch_port_depthformer.py and test_torch_port_depthformer_luna.py:
# name -> (config, image size). No kernel of the port lies on their paths
EFFNET_KW = dict(encoder_kwargs=dict(width=0.1, depth=0.25, stem_ch=32, head_ch=256))
EFFNET_TINY = {
    "adabins": (dict(num_bins=16), (288, 480)),
    "depthformer": (dict(hidden_dim=16, num_heads=4, img_size=(64, 96)), (64, 96)),
    "depthformer_v2": (dict(hidden_dim=32, num_heads=4, img_size=(64, 96)), (64, 96)),
    "depthformer_v3": (dict(hidden_dim=32, num_heads=4, img_size=(64, 96), num_bins=10),
                       (64, 96)),
    "depthformer_v4": (dict(hidden_dim=16, num_heads=4), (64, 96)),
    "depthformer_v5": (dict(hidden_dim=32, num_heads=4, img_size=(64, 96), key_query_dim=64),
                       (64, 96)),
    **{f"depthformer_v{v}": (dict(hidden_dim=32, num_heads=8, num_bins=10, num_aux=6,
                                  img_size=(64, 96)), (64, 96)) for v in (6, 7, 8)}}


def _flat_outputs(out):
    """Every tensor of a model's output, in order (a None, ``oda_conv``'s
    second, left out)."""
    return [t for item in out if item is not None
            for t in ([item] if torch.is_tensor(item) else item)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EFFNET_TINY))
def test_tiny_efficientnet_model_on_card_matches_cpu(cuda, name):
    """A tiny AdaBins or Depthformer's f32 forward on the card, no kernel
    launched, against the CPU's: the depth, bin edges and attention weights
    within 1e-3 (m, or probability)."""
    extra, hw = EFFNET_TINY[name]
    x = torch.from_numpy(np.random.RandomState(17).rand(2, *hw, 3).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model = build_model(dict(extra, name=name), 0.001, 80.0, device=dev, seed=18,
                            **EFFNET_KW)
        kernels.reset_launch_counts()
        with torch.no_grad():
            outs.append([t.cpu() for t in _flat_outputs(model(x.to(dev)))])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == NO_LAUNCHES
    for a, b in zip(*outs):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-3, (name, (a - b).abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EFFNET_TINY))
def test_tiny_efficientnet_train_step_on_card_matches_cpu(cuda, name):
    """One f32 train step of a tiny AdaBins or Depthformer (dropout off; the
    bin models with the chamfer loss at 0.1, AdaBins with ``same_lr``
    false) on the card, no kernel launched, against the same step on the
    CPU: the logs within 1e-4 of their size, each gradient within 1e-3 of
    its tensor's max |g| (or of 1% of the largest one), BatchNorm
    statistics within 1e-4, the new parameters within lr0. The CPU is fed
    the sides of the card's ReLU and LeakyReLU kinks (``chip_smoke.KinkReplay``):
    after AdaBins' batch-statistics BatchNorms a weight gradient sums
    random-signed terms, and one element on the other side of a kink moves
    it by about 1/sqrt(pixels)."""
    from chip_smoke import KinkReplay
    extra, hw = EFFNET_TINY[name]
    chamfer = 0.1 if name in ("adabins", "depthformer_v3", "depthformer_v7",
                              "depthformer_v8") else 0.0
    opt = {"model": dict(extra, name=name),
           "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True, "chamfer_weight": chamfer},
           "optimizer": {"lr": 1e-4, "weight_decay": 0.1, "eps": 1e-6,
                         "same_lr": name != "adabins"},
           "scheduler": {"name": "onecycle"}, "train": {"grad_norm": 0.1}}
    rng = np.random.RandomState(19)
    batch = {"image": rng.rand(2, *hw, 3).astype(np.float32),
             "depth": rng.uniform(0.5, 60.0, (2, *hw, 1)).astype(np.float32)}
    drop = dict(drop_prob=0.0) if name == "adabins" else dict(drop_prob=0.0,
                                                              attn_drop_prob=0.0)
    if name == "depthformer_v4":
        drop.pop("attn_drop_prob")
    results = []
    kinks = KinkReplay()
    for dev in (cuda, torch.device("cpu")):
        model = build_model(opt["model"], 0.001, 80.0, device=dev, seed=20, **EFFNET_KW,
                            **drop)
        (kinks.record if dev is cuda else kinks.replay)(model)
        state = TrainState.create(model, opt, 100)
        grads = {}
        update = state.optimizer.update
        state.optimizer.update = lambda g, update=update: (grads.update(
            {n: t.detach().cpu().clone() for n, t in g.items()}), update(g))
        kernels.reset_launch_counts()
        _, logs = make_train_step(opt, 0.001, 80.0)(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == dict(NO_LAUNCHES, **OPTIMIZER_LAUNCHES)
        results.append(({k: float(v) for k, v in logs.items()}, grads,
                        {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    (logs, grads, weights), (ref_logs, ref_grads, ref_weights) = results
    assert (ref_logs.get("loss_chamfer", 0.0) > 0) == (chamfer > 0)
    for key in ref_logs:
        assert abs(logs[key] - ref_logs[key]) <= 1e-4 * max(1.0, abs(ref_logs[key])), key
    floor = 1e-2 * max(g.abs().max().item() for g in ref_grads.values())
    for n, g in ref_grads.items():
        assert (grads[n] - g).abs().max().item() <= 1e-3 * max(g.abs().max().item(), floor), n
    for n, value in ref_weights.items():
        tol = 1e-4 * max(1.0, value.abs().max().item()) if "running" in n else 1e-4 / 25
        if value.is_floating_point():
            assert (weights[n] - value).abs().max().item() <= tol, n


# the tiny ODA models of tests/test_torch_port_oda.py on an encoder of width
# 32, depths (2, 2, 2, 2) and head dim 32: at 128x192, not resized, stages 1
# and 2 run 12x12 windows (144 tokens, the wide tensor-core bodies in bf16),
# their odd blocks shifted and masked, stages 3 and 4 shrunk windows of 8 and
# 4; oda_bins at 384x384 (resized to itself: mViT takes 129 patches or more).
# name -> (config, image size). One forward launches K1 8 times (a block
# each), a train step 8 and 8 backward
ODA_KW = dict(encoder_kwargs=dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8)))
ODA_LUNA = dict(decoder_channels=32, num_aux=8, aux_dim=16, num_heads=4)
ODA_TINY = {"oda_conv": (dict(decoder_channels=32), (128, 192)),
            "oda_luna": (ODA_LUNA, (128, 192)),
            "oda_luna_cls": (dict(ODA_LUNA, num_bins=8), (128, 192)),
            "oda_bins": (dict(decoder_channels=32, num_bins=8), (384, 384)),
            "oda_lion": (dict(decoder_channels=32), (128, 192)),
            "oda_lime": (dict(decoder_channels=16, decoder_layers=2), (128, 192)),
            "oda_jeju": (dict(decoder_channels=32, num_aux=4, num_heads=8), (128, 192))}


# the models with a PPM-v2, whose 1x1 pooled BatchNorm normalises one value an
# image: at two images its output is +-1 whatever they are and the gradient
# into it rounding noise (the tiny steps' gradient norms came out 1.1e-4 apart
# card vs CPU), so their train step takes four images with colour casts of
# their own, as tests/test_torch_port_ksa_train.py's
PPM_V2 = ("oda_lion", "oda_jeju")


def _oda_build(name, dev, seed, **overrides):
    """A tiny ODA model. The cls head's last regressor bias is set to 1: its
    8 ELU(0.1) bin widths (no +0.1, as the reference's) sum near 0 at
    init, where the normalised widths, and so the depth, carry f32 rounding
    up a hundredfold (8.5e-3 m card vs CPU, the gradients' norms 1.2%
    apart; ROADMAP Queue 3); from 1 the widths sum to about 8."""
    extra, hw = ODA_TINY[name]
    kw = dict(ODA_KW, **overrides)
    if hw != (384, 384):
        kw.update(resize_to_multiple=False, img_size=hw)
    model = build_model(dict(extra, name=name), 0.001, 80.0, device=dev, seed=seed, **kw)
    if name == "oda_luna_cls":
        with torch.no_grad():
            model.bin_regressor[4].bias.fill_(1.0)
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ODA_TINY))
def test_tiny_oda_model_on_card_matches_cpu(cuda, name):
    """A tiny ODA model's f32 forward on the card (K1 8 times: the f32
    CUDA-core bodies at 144 tokens) against the CPU's: the depth, bins, aux
    tokens and attention weights within 1e-3 (m, or probability); in bf16
    on the card (the wide tensor-core bodies), 8 launches and finite
    outputs."""
    hw = ODA_TINY[name][1]
    x = torch.from_numpy(np.random.RandomState(24).rand(2, *hw, 3).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model = _oda_build(name, dev, 25)
        kernels.reset_launch_counts()
        with torch.no_grad():
            outs.append([t.cpu() for t in _flat_outputs(model(x.to(dev)))])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == dict(NO_LAUNCHES, window_attention=8)
    for a, b in zip(*outs):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-3, (name, (a - b).abs().max().item())
    model = _oda_build(name, cuda, 25, dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = _flat_outputs(model(x.to(cuda)))
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(NO_LAUNCHES, window_attention=8)
    assert all(torch.isfinite(t.float()).all() for t in out)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ODA_TINY))
def test_tiny_oda_train_step_on_card_matches_cpu(cuda, name):
    """One f32 train step of a tiny ODA model (dropout and stochastic depth
    off; the bin models with the chamfer loss at 0.1; ``PPM_V2``'s on four
    colour-cast images) on the card (K1 8 and
    8 backward, the f32 bodies at 144 tokens, the lean backward among them)
    against the same step on the CPU, at the tolerances of
    ``test_tiny_efficientnet_train_step_on_card_matches_cpu``."""
    hw = ODA_TINY[name][1]
    size = 4 if name in PPM_V2 else 2
    chamfer = 0.1 if name in ("oda_luna_cls", "oda_bins") else 0.0
    opt = {"model": dict(ODA_TINY[name][0], name=name),
           "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True, "chamfer_weight": chamfer},
           "optimizer": {"lr": 1e-4, "weight_decay": 0.1, "eps": 1e-6},
           "scheduler": {"name": "onecycle"}, "train": {"grad_norm": 0.1}}
    rng = np.random.RandomState(26)
    batch = {"image": rng.rand(size, *hw, 3).astype(np.float32),
             "depth": rng.uniform(0.5, 60.0, (size, *hw, 1)).astype(np.float32)}
    if name in PPM_V2:
        batch["image"] *= np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
                                    [1.0, 1.0, 1.0]], np.float32)[:, None, None]
    no_drop = dict(encoder_kwargs=dict(ODA_KW["encoder_kwargs"], drop_prob=0.0,
                                       path_drop_prob=0.0))
    if name != "oda_conv":  # the Luna layers', mViT's
        no_drop["drop_prob"] = 0.0
    results = []
    for dev in (cuda, torch.device("cpu")):
        model = _oda_build(name, dev, 27, **no_drop)
        state = TrainState.create(model, opt, 100)
        grads = {}
        update = state.optimizer.update
        state.optimizer.update = lambda g, update=update: (grads.update(
            {n: t.detach().cpu().clone() for n, t in g.items()}), update(g))
        kernels.reset_launch_counts()
        _, logs = make_train_step(opt, 0.001, 80.0)(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == dict(NO_LAUNCHES, window_attention=8,
                                                 window_attention_bwd=8, **OPTIMIZER_LAUNCHES)
        results.append(({k: float(v) for k, v in logs.items()}, grads,
                        {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    (logs, grads, weights), (ref_logs, ref_grads, ref_weights) = results
    assert (ref_logs.get("loss_chamfer", 0.0) > 0) == (chamfer > 0)
    for key in ref_logs:
        assert abs(logs[key] - ref_logs[key]) <= 1e-4 * max(1.0, abs(ref_logs[key])), key
    floor = 1e-2 * max(g.abs().max().item() for g in ref_grads.values())
    for n, g in ref_grads.items():
        assert (grads[n] - g).abs().max().item() <= 1e-3 * max(g.abs().max().item(), floor), n
    for n, value in ref_weights.items():
        tol = 1e-4 * max(1.0, value.abs().max().item()) if "running" in n else 1e-4 / 25
        if value.is_floating_point():
            assert (weights[n] - value).abs().max().item() <= tol, n


# -- the forward kernels as operators, the exported serving forward -------

def _op_cases(cuda, dtype):
    """Each ``torch.ops.mde`` operator's inputs at a small shape on the card:
    (the operator's name, the kernel module it is in, its arguments)."""
    g = torch.Generator().manual_seed(18)

    def rand(*shape, dt=dtype, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dt).to(cuda)

    mask = torch.where(torch.rand((4, 16, 16), generator=g) < 0.2, -100.0, 0.0).to(cuda)
    idx = torch.randint(0, 16, (8, 16), generator=g, dtype=torch.int32).to(cuda)
    f32 = torch.float32
    return [("window_attention", "window_attention",
             (rand(32, 16, 96), rand(2, 16, 16, dt=f32), mask, 2, 0.25)),
            ("window_attention_qk_v", "window_attention",
             (rand(32, 16, 64), rand(32, 16, 32), rand(2, 16, 16, dt=f32), mask, 2, 0.25)),
            ("ordered_attention", "ordered_attention",
             (rand(8, 16, 32), rand(8, 16, 32), rand(8, 16, 32), idx,
              rand(31, 2, dt=f32, scale=0.1), 2, 0.25, 16)),
            ("depthwise_conv2d", "depthwise", (rand(2, 8, 12, 16), rand(5, 5, 16))),
            ("glu_ff", "glu_ff", (rand(2, 8, 12, 32), rand(5, 5, 16), rand(16, dt=f32),
                                  rand(16, dt=f32))),
            ("channel_attention", "channel_attention", (rand(8, 16, 16), rand(8, 16, 32), 2,
                                                        0.25))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_match_their_direct_launches(cuda, dtype):
    """Each forward operator against the direct launch of its kernel on the
    same inputs: the same bits, one launch each."""
    import importlib
    for name, module_name, args in _op_cases(cuda, dtype):
        module = importlib.import_module(f"mde_tpu_torch.ops.kernels.{module_name}")
        kernel = "window_attention" if name.startswith("window") else name
        kernels.reset_launch_counts()
        out = getattr(torch.ops.mde, name)(*args)
        direct = getattr(module, f"direct_{name}")(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts == dict(NO_LAUNCHES, **{kernel: 2}), name
        assert out.dtype == dtype and torch.equal(out, direct), name


@pytest.mark.gpu
def test_exported_tiny_flagship_launches_as_eager(cuda, tmp_path):
    """The tiny flagship (bf16) exported on the card, loaded and run: the
    program's launches are the eager call's (K1 6, K2 4, K3 4) and so are
    its output's bits; with ``return_weights`` the eager call leaves K2."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import torch_export
    model = build_model(TINY, 0.001, 80.0, device=cuda, seed=4, use_checkpoint=False,
                        dtype=torch.bfloat16, **TINY_KW).eval()
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 96, 3).astype(np.float32))
    x = x.to(cuda)
    torch_export.export(str(tmp_path), "train", 2, "custom", model=model, hw=(64, 96))
    expect = dict(NO_LAUNCHES, window_attention=6, ordered_attention=4, depthwise_conv2d=4)
    kernels.reset_launch_counts()
    with torch.no_grad():
        eager = model(x)[0]
    torch.cuda.synchronize()
    assert kernels.launch_counts == expect
    program = torch_export.load(str(tmp_path))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = program(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts == expect
    assert torch.equal(out, eager)
    for m in model.modules():
        if hasattr(m, "return_weights"):
            m.return_weights = True
    kernels.reset_launch_counts()
    with torch.no_grad():
        _, _, weights = model(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(expect, ordered_attention=0)
    assert len(weights) == 4 and all(w.shape == (48, 4, 16, 16) for w in weights)


def _bwd_op_cases(cuda, dtype):
    """Each backward operator's inputs at a small shape on the card: (the
    operator's name, the plain Python entry that checks and launches its
    kernel through ``ctypes``, the kernel, its arguments)."""
    from mde_tpu_torch.ops.kernels import channel_attention as ca
    from mde_tpu_torch.ops.kernels import depthwise as dw
    from mde_tpu_torch.ops.kernels import ordered_attention as oa
    from mde_tpu_torch.ops.kernels import window_attention as wa
    g = torch.Generator().manual_seed(19)

    def rand(*shape, dt=dtype, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dt).to(cuda)

    mask = torch.where(torch.rand((4, 16, 16), generator=g) < 0.2, -100.0, 0.0).to(cuda)
    idx = torch.randint(0, 16, (8, 16), generator=g, dtype=torch.int32).to(cuda)
    f32 = torch.float32
    bias = rand(2, 16, 16, dt=f32)
    return [("window_attention_bwd", wa.window_attention_bwd, "window_attention_bwd",
             (rand(32, 16, 96), rand(32, 16, 32), bias, mask, 2, 0.25)),
            ("window_attention_qk_v_bwd", wa.window_attention_qk_v_bwd, "window_attention_bwd",
             (rand(32, 16, 64), rand(32, 16, 32), rand(32, 16, 32), bias, mask, 2, 0.25)),
            ("ordered_attention_bwd", oa.ordered_attention_bwd, "ordered_attention_bwd",
             (rand(8, 16, 32), rand(8, 16, 32), rand(8, 16, 32), rand(8, 16, 32), idx,
              rand(31, 2, dt=f32, scale=0.1), 2, 0.25, 16)),
            ("depthwise_conv2d_dxdw", dw.depthwise_dxdw, "depthwise_conv2d_dxdw",
             (rand(2, 8, 12, 16), rand(2, 8, 12, 16), rand(5, 5, 16, scale=0.2))),
            ("depthwise_conv2d_dw", dw.depthwise_dw, "depthwise_conv2d_dw",
             (rand(2, 8, 12, 16), rand(2, 8, 12, 16), rand(5, 5, 16, scale=0.2))),
            ("channel_attention_bwd", ca.channel_attention_bwd, "channel_attention_bwd",
             (rand(8, 16, 16), rand(8, 16, 32), rand(8, 16, 16), 2, 0.25))]


# outputs that the kernels sum with atomics across blocks (K1's dbias, K2's
# dtable), whose bits follow the blocks' order from one launch to the next
ATOMIC_SUMS = {"window_attention_bwd": 1, "window_attention_qk_v_bwd": 2,
               "ordered_attention_bwd": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_ops_match_the_direct_ctypes_path(cuda, dtype):
    """Each backward operator against its plain Python entry (the check and
    the ``ctypes`` launch): one launch each, the same bits; the sums made
    with atomics within 1e-5 of their size."""
    for name, direct, kernel, args in _bwd_op_cases(cuda, dtype):
        kernels.reset_launch_counts()
        out = getattr(torch.ops.mde, name)(*args)
        want = direct(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts == dict(NO_LAUNCHES, **{kernel: 2}), name
        out, want = _as_tuple(out), _as_tuple(want)
        assert len(out) == len(want), name
        for i, (a, b) in enumerate(zip(out, want)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            if ATOMIC_SUMS.get(name) == i:
                tol = 1e-5 * max(1.0, b.abs().max().item())
                assert (a - b).abs().max().item() <= tol, (name, i)
            else:
                assert torch.equal(a, b), (name, i)


def _tiny_recomputing_step(cuda, monkeypatch):
    """The tiny flagship in bf16 on the card, recomputing under
    ``save_sa_conv``, its train step and a batch; one step taken."""
    monkeypatch.setenv("MDE_REMAT_POLICY", "save_sa_conv")
    opt = {"model": TINY, "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True},
           "optimizer": {"lr": 1e-4, "weight_decay": 0.1, "eps": 1e-6},
           "scheduler": {"name": "onecycle"}, "train": {"grad_norm": 0.1}}
    model = build_model(TINY, 0.001, 80.0, device=cuda, seed=7, use_checkpoint=True,
                        dtype=torch.bfloat16, **TINY_KW)
    state = TrainState.create(model, opt, 100)
    step = make_train_step(opt, 0.001, 80.0)
    rng = np.random.RandomState(6)
    batch = {"image": torch.from_numpy(rng.rand(2, 64, 96, 3).astype(np.float32)).to(cuda),
             "depth": torch.from_numpy(rng.uniform(0.5, 60.0, (2, 64, 96, 1))
                                       .astype(np.float32)).to(cuda)}
    step(state, batch)
    torch.cuda.synchronize()
    return lambda: step(state, batch)


def _profiled_events(call, log_dir) -> list:
    import json
    from mde_tpu_torch.utils import profiling
    with profiling.trace(str(log_dir)):
        call()
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.gpu
def test_profiled_step_launches_inside_program_spans(cuda, monkeypatch, tmp_path):
    """In a profiled recomputing train step every kernel launch (the CUDA
    runtime's or driver's, in any thread) lies inside one of the program's
    spans, which are the trace's ``mde.*`` annotations; each span has its
    device time, and the replays sit in the backward."""
    from mde_tpu_torch.utils import profiling
    call = _tiny_recomputing_step(cuda, monkeypatch)
    profiling.spans()
    events = _profiled_events(call, tmp_path)
    records = profiling.spans()
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("mde.")]
    assert len(ranges) == len(records)
    launches = [float(e["ts"]) for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e["name"]]
    assert len(launches) > 100
    outside = [t for t in launches if not any(a <= t <= b for a, b in ranges)]
    assert outside == []
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0 for r in records)
    (backward,) = [r for r in records if r["name"] == "mde.train.backward"]
    replays = [r for r in records if r["name"] == "mde.remat.replay"]
    assert replays and all(r["parent"] == backward["id"] for r in replays)


@pytest.mark.gpu
def test_spans_add_no_synchronisation(cuda, monkeypatch, tmp_path):
    """The runtime calls that make the host wait for the card in a profiled
    train step are as many with the program's spans as without them."""
    from mde_tpu_torch.utils import profiling
    call = _tiny_recomputing_step(cuda, monkeypatch)
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy", "cudaMemcpy2D")
    counts = []
    for on in (True, False):
        if not on:
            monkeypatch.setattr(profiling, "_recording", lambda: False)
        events = _profiled_events(call, tmp_path / str(on))
        counts.append(sum(e.get("cat") == "cuda_runtime" and e["name"] in waits
                          for e in events))
        names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
        assert ("mde.train.step" in names) == on
    profiling.spans()
    assert counts[0] == counts[1] > 0
