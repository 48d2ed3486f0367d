"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker ``gpu``) and skips without one.
The file imports nothing of JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest sets JAX up.) f32 comparisons run
with TF32 off and hold at 1e-5; bf16 tolerances are stated in BF16_REL.
"""

import numpy as np
import pytest
import torch

from mde_tpu_torch.models import build_model
from mde_tpu_torch.ops import kernels
from mde_tpu_torch.ops.kernels.depthwise import depthwise_conv2d, plain_depthwise_conv2d
from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention,
                                                         plain_ordered_attention)
from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention,
                                                        window_attention)
from mde_tpu_torch.ops.window import shifted_window_attn_mask

TOL = 1e-5
# bf16, relative to max(1, max |plain|): the kernels keep the logits (K1, K2)
# and the running sums (K3) in f32 where the plain versions round them to
# bf16. K3's plain version rounds each of its 25 partial sums to bf16, half
# an ulp (2^-9 relative) each, so the two may differ by up to 25 * 2^-9 ~ 5%.
BF16_REL = {"window_attention": 3e-2, "ordered_attention": 3e-2, "depthwise_conv2d": 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _check(name, fn, plain, args, dtype):
    before = kernels.launch_counts[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts[name] == before + 1
    ref = plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert err <= (TOL if dtype == torch.float32 else BF16_REL[name] * scale), (name, dtype, err)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,shifted", [(7, False), (7, True), (4, True)])
def test_window_attention_kernel(cuda, dtype, r, shifted):
    rng = np.random.RandomState(0)
    n, nh, c = r * r, 4, 128
    mask = shifted_window_attn_mask(2 * r, 4 * r, r, r // 2, cuda) if shifted else None
    bw = 3 * 8  # 3 images of 8 windows
    qkv = _randn(rng, bw, n, 3 * c).to(cuda, dtype)
    args = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
            _randn(rng, nh, n, n).to(cuda), mask, nh, (c // nh) ** -0.5)
    _check("window_attention", window_attention, plain_window_attention, args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_table", [True, False])
def test_ordered_attention_kernel(cuda, dtype, with_table):
    rng = np.random.RandomState(1)
    bw, n, nh, c, e = 10, 64, 8, 512, 128
    q, k, v = (_randn(rng, bw, n, c).to(cuda, dtype) for _ in range(3))
    idx = torch.from_numpy(rng.randint(0, e, (bw, n)).astype(np.int32)).to(cuda)
    table = _randn(rng, 2 * e - 1, nh).to(cuda) if with_table else None
    args = (q, k, v, idx, table, nh, (c // nh) ** -0.5, e)
    _check("ordered_attention", ordered_attention, plain_ordered_attention, args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 10, 12), (2, 12, 24, 64), (1, 5, 3, 2048)])
def test_depthwise_kernel(cuda, dtype, shape):
    rng = np.random.RandomState(3)
    x = _randn(rng, *shape).to(cuda, dtype)
    w = _randn(rng, 5, 5, shape[-1]).to(cuda, dtype)
    out = _check("depthwise_conv2d", depthwise_conv2d, plain_depthwise_conv2d, (x, w), dtype)
    # the kernel sums in f32 and rounds once: within one bf16 ulp of the f32 sum
    ref = plain_depthwise_conv2d(x.float(), w.float())
    assert ((out.float() - ref).abs() <= ref.abs() * 2 ** -8 + 1e-6).all()


@pytest.mark.gpu
def test_tiny_flagship_on_card_matches_cpu(cuda):
    cfg = dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32, num_heads=4,
               num_repeats=2, num_emb=16, window_size=4, neck_type="red33")
    kw = dict(resize_to_multiple=False, encoder_kwargs=dict(
        embed_dim=16, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4))
    cpu_model = build_model(cfg, 0.001, 80.0, device="cpu", seed=4, **kw)
    gpu_model = build_model(cfg, 0.001, 80.0, device=cuda, seed=4, **kw)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 96, 3).astype(np.float32))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, outs = gpu_model(x.to(cuda))
        ref, _ = cpu_model(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {"window_attention": 6, "ordered_attention": 4,
                                     "depthwise_conv2d": 4}
    assert (out.cpu() - ref).abs().max().item() <= 1e-3
