"""The port's three forward kernels (mde_tpu_torch/ops/kernels) against the JAX ones.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX package's ``xla_*`` function and against the Pallas kernel run in
interpret mode, on the same seeded numpy inputs, at max-abs 1e-5 in f32.
The CUDA kernels are held against their plain versions on the card in
``test_torch_port_gpu.py``; the gradients are tested in
``test_torch_port_backward.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.ops.pallas.depthwise import fused_depthwise_conv2d, xla_depthwise_conv2d
from mde_tpu.ops.pallas.ordered_attention import (fused_ordered_window_attention,
                                                  xla_ordered_attention)
from mde_tpu.ops.pallas.window_attention import fused_window_attention, xla_window_attention
from mde_tpu.ops.window import shifted_window_attn_mask as jax_mask
from mde_tpu_torch.ops import kernels
from mde_tpu_torch.ops.kernels.depthwise import depthwise_conv2d, plain_depthwise_conv2d
from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention,
                                                         plain_ordered_attention)
from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention,
                                                        window_attention)

TOL = 1e-5


def _max_abs(a, b) -> float:
    a = a.detach().cpu().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().cpu().float().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def _window_inputs(n, with_bias, with_mask, seed=0, hd=16):
    r = int(round(n ** 0.5))
    h, w = 2 * r, 2 * r
    nw = (h // r) * (w // r)
    bw, nh, c = 3 * nw, 2, 2 * hd  # 3 images: an odd multiple of nW
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bw, n, c).astype(np.float32) for _ in range(3))
    bias = rng.randn(nh, n, n).astype(np.float32) if with_bias else None
    mask = np.array(jax_mask(h, w, r, r // 2)) if with_mask else None
    return q, k, v, bias, mask, nh, (c // nh) ** -0.5


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# head dim 16 at n 16 and 49, and the main path's head dim 32 (Swin's)
@pytest.mark.parametrize("n,hd", [pytest.param(16, 16, id="16"), pytest.param(49, 16, id="49"),
                                  pytest.param(49, 32, id="49-hd32")])
@pytest.mark.parametrize("with_bias,with_mask",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_window_attention_plain_matches_jax(n, hd, with_bias, with_mask):
    q, k, v, bias, mask, nh, scale = _window_inputs(n, with_bias, with_mask, hd=hd)
    ours = window_attention(_t(np.concatenate([q, k, v], axis=-1)), _t(bias), _t(mask), nh,
                            scale)
    args = (_j(q), _j(k), _j(v), _j(bias), _j(mask), nh, scale)
    assert _max_abs(ours, xla_window_attention(*args)) <= TOL
    assert _max_abs(ours, fused_window_attention(*args, impl="pallas_interpret")) <= TOL


def _ordered_inputs(n, with_table, seed=1):
    bw, nh, c, e = 6, 4, 64, 16
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bw, n, c).astype(np.float32) for _ in range(3))
    idx = rng.randint(0, e, (bw, n)).astype(np.int32)
    table = rng.randn(2 * e - 1, nh).astype(np.float32) if with_table else None
    return q, k, v, idx, table, nh, (c // nh) ** -0.5, e


@pytest.mark.parametrize("n", [16, 64, 49])
@pytest.mark.parametrize("with_table", [True, False])
def test_ordered_attention_plain_matches_jax(n, with_table):
    q, k, v, idx, table, nh, scale, e = _ordered_inputs(n, with_table)
    ours = ordered_attention(_t(q), _t(k), _t(v), _t(idx), _t(table), nh, scale, e)
    args = (_j(q), _j(k), _j(v), _j(idx), _j(table), nh, scale, e)
    assert _max_abs(ours, xla_ordered_attention(*args)) <= TOL
    assert _max_abs(ours, fused_ordered_window_attention(*args, impl="pallas_interpret")) <= TOL


@pytest.mark.parametrize("shape,k", [((2, 7, 10, 12), 5), ((1, 9, 6, 20), 3),
                                     ((2, 6, 11, 16), 5)])
def test_depthwise_plain_matches_jax(shape, k):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(k, k, shape[-1]).astype(np.float32)
    ours = depthwise_conv2d(_t(x), _t(w))
    assert _max_abs(ours, xla_depthwise_conv2d(_j(x), _j(w))) <= TOL
    assert _max_abs(ours, fused_depthwise_conv2d(_j(x), _j(w), impl="pallas_interpret")) <= TOL


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    q, k, v, bias, mask, nh, scale = _window_inputs(16, True, True)
    qkv = _t(np.concatenate([q, k, v], axis=-1))
    out = window_attention(qkv, _t(bias), _t(mask), nh, scale)
    ref = plain_window_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask), nh, scale)
    assert torch.equal(out, ref)
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 0)
    with pytest.raises(ValueError, match="device"):
        window_attention(qkv.to("meta"), None, None, nh, scale)
