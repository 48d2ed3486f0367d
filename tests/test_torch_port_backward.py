"""The port's kernel gradients (mde_tpu_torch/ops/kernels) against JAX's.

On the CPU each ``torch.autograd.Function`` runs its plain forward and its
plain backward (``plain_*_bwd``). Its gradients are held against
``jax.vjp`` of the JAX kernels run as the JAX package's own tests run them
on the CPU (Pallas in interpret mode, so that the Pallas backward kernels
run) and of the ``xla_*`` reference paths, on the same seeded numpy inputs
and output gradient, in f32 at max-abs 1e-5 of the larger of 1 and the
reference's largest magnitude: the gradients are sums (dT over every pair
of a head, dx over 25 taps) that reach ~20 here and differ only in the
order of their f32 additions. The depthwise backward's plain versions are
held against ``_dw_pallas`` and ``_dxdw_pallas`` in interpret mode and
against ``jax.grad`` of ``xla_depthwise_conv2d``, and each plain backward
against ``torch.autograd.grad`` of its plain forward. The CUDA kernels are
held against the plain versions on the card in ``test_torch_port_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.ops.pallas.depthwise import _dw_pallas, _dxdw_pallas, xla_depthwise_conv2d
from mde_tpu.ops.pallas.ordered_attention import (fused_ordered_window_attention,
                                                  xla_ordered_attention)
from mde_tpu.ops.pallas.window_attention import fused_window_attention, xla_window_attention
from mde_tpu.ops.window import shifted_window_attn_mask as jax_mask
from mde_tpu_torch.ops import kernels
from mde_tpu_torch.ops.kernels.depthwise import (depthwise_conv2d, plain_depthwise_conv2d,
                                                 plain_depthwise_dw, plain_depthwise_dxdw)
from mde_tpu_torch.ops.kernels.ordered_attention import (ordered_attention,
                                                         plain_ordered_attention,
                                                         plain_ordered_attention_bwd)
from mde_tpu_torch.ops.kernels.window_attention import (plain_window_attention,
                                                        plain_window_attention_bwd,
                                                        window_attention)
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _np(a) -> np.ndarray:
    a = a.detach().cpu().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.astype(np.float64)


def _max_abs(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _window_case(n, with_bias, with_mask, seed=0, hd=16):
    r = int(round(n ** 0.5))
    h = w = 2 * r
    nw = (h // r) * (w // r)
    bw, nh, c = 3 * nw, 2, 2 * hd
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(bw, n, c).astype(np.float32) for _ in range(4))
    bias = rng.randn(nh, n, n).astype(np.float32) if with_bias else None
    mask = np.array(jax_mask(h, w, r, r // 2)) if with_mask else None
    return q, k, v, g, bias, mask, nh, (c // nh) ** -0.5


def _jax_window_grads(fn, q, k, v, g, bias, mask, nh, scale):
    args = [jnp.asarray(a) for a in (q, k, v)] + ([jnp.asarray(bias)] if bias is not None
                                                   else [])
    m = None if mask is None else jnp.asarray(mask)

    def f(*a):
        return fn(a[0], a[1], a[2], a[3] if bias is not None else None, m, nh, scale)

    _, vjp = jax.vjp(f, *args)
    return vjp(jnp.asarray(g))


# head dim 16 at n 16 and 49, and the main path's head dim 32 (Swin's)
@pytest.mark.parametrize("n,hd", [pytest.param(16, 16, id="16"), pytest.param(49, 16, id="49"),
                                  pytest.param(49, 32, id="49-hd32")])
@pytest.mark.parametrize("with_bias,with_mask",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_window_attention_grads_match_jax(n, hd, with_bias, with_mask):
    q, k, v, g, bias, mask, nh, scale = _window_case(n, with_bias, with_mask, hd=hd)
    qkv = _t(np.concatenate([q, k, v], axis=-1), grad=True)
    tb = _t(bias, grad=True)
    window_attention(qkv, tb, _t(mask), nh, scale).backward(torch.from_numpy(g))
    c = q.shape[-1]
    ours = [qkv.grad[..., :c], qkv.grad[..., c:2 * c], qkv.grad[..., 2 * c:]]
    ours += [tb.grad] if with_bias else []
    pallas = _jax_window_grads(
        lambda *a: fused_window_attention(*a, impl="pallas_interpret"),
        q, k, v, g, bias, mask, nh, scale)
    xla = _jax_window_grads(xla_window_attention, q, k, v, g, bias, mask, nh, scale)
    for name, o, p, x in zip(("dq", "dk", "dv", "dbias"), ours, pallas, xla):
        assert _max_abs(o, p) <= TOL, (name, _max_abs(o, p))
        assert _max_abs(o, x) <= TOL, (name, _max_abs(o, x))


def test_window_attention_plain_bwd_matches_torch_autograd():
    q, k, v, g, bias, mask, nh, scale = _window_case(49, True, True, seed=1)
    tq, tk, tv, tb = (_t(a, grad=True) for a in (q, k, v, bias))
    out = plain_window_attention(tq, tk, tv, tb, _t(mask), nh, scale)
    ref = torch.autograd.grad(out, (tq, tk, tv, tb), torch.from_numpy(g))
    ours = plain_window_attention_bwd(_t(q), _t(k), _t(v), _t(g), _t(bias), _t(mask), nh,
                                      scale)
    for o, r in zip(ours, ref):
        assert _max_abs(o, r) <= TOL


def _ordered_case(n, with_table, seed=2):
    bw, nh, c, e = 6, 4, 64, 16
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(bw, n, c).astype(np.float32) for _ in range(4))
    idx = rng.randint(0, e, (bw, n)).astype(np.int32)
    table = rng.randn(2 * e - 1, nh).astype(np.float32) if with_table else None
    return q, k, v, g, idx, table, nh, (c // nh) ** -0.5, e


def _jax_ordered_grads(fn, q, k, v, g, idx, table, nh, scale, e):
    args = [jnp.asarray(a) for a in (q, k, v)] + ([jnp.asarray(table)] if table is not None
                                                   else [])

    def f(*a):
        return fn(a[0], a[1], a[2], jnp.asarray(idx), a[3] if table is not None else None,
                  nh, scale, e)

    _, vjp = jax.vjp(f, *args)
    return vjp(jnp.asarray(g))


def _check_ordered_grads(q, k, v, g, idx, table, nh, scale, e):
    tq, tk, tv, tt = (_t(a, grad=True) for a in (q, k, v, table))
    ordered_attention(tq, tk, tv, _t(idx), tt, nh, scale, e).backward(torch.from_numpy(g))
    ours = [tq.grad, tk.grad, tv.grad] + ([tt.grad] if table is not None else [])
    pallas = _jax_ordered_grads(
        lambda *a: fused_ordered_window_attention(*a, impl="pallas_interpret"),
        q, k, v, g, idx, table, nh, scale, e)
    xla = _jax_ordered_grads(xla_ordered_attention, q, k, v, g, idx, table, nh, scale, e)
    for name, o, p, x in zip(("dq", "dk", "dv", "dtable"), ours, pallas, xla):
        assert _max_abs(o, p) <= TOL, (name, _max_abs(o, p))
        assert _max_abs(o, x) <= TOL, (name, _max_abs(o, x))


@pytest.mark.parametrize("n", [16, 64, 49])
@pytest.mark.parametrize("with_table", [True, False])
def test_ordered_attention_grads_match_jax(n, with_table):
    _check_ordered_grads(*_ordered_case(n, with_table))


def test_ordered_attention_grads_match_jax_one_bucket_per_window():
    """Every index of a window equal, so that all of a window's dS fall in
    one dT bucket (E - 1), where the card kernel's runs of equal buckets are
    longest."""
    q, k, v, g, idx, table, nh, scale, e = _ordered_case(16, True, seed=6)
    idx = np.repeat(idx[:, :1], idx.shape[1], axis=1)
    _check_ordered_grads(q, k, v, g, idx, table, nh, scale, e)


def test_ordered_attention_plain_bwd_matches_torch_autograd():
    q, k, v, g, idx, table, nh, scale, e = _ordered_case(64, True, seed=3)
    tq, tk, tv, tt = (_t(a, grad=True) for a in (q, k, v, table))
    out = plain_ordered_attention(tq, tk, tv, _t(idx), tt, nh, scale, e)
    ref = torch.autograd.grad(out, (tq, tk, tv, tt), torch.from_numpy(g))
    ours = plain_ordered_attention_bwd(_t(q), _t(k), _t(v), _t(g), _t(idx), _t(table), nh,
                                       scale, e)
    for o, r in zip(ours, ref):
        assert _max_abs(o, r) <= TOL


# (shape, k): 5x5 and 3x3, odd H and W, one side smaller than the kernel
DW_CASES = [((2, 7, 10, 12), 5), ((1, 9, 11, 32), 3), ((2, 5, 3, 16), 5)]


def _dw_case(shape, k, seed=4):
    rng = np.random.RandomState(seed)
    x, g = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    return x, rng.randn(k, k, shape[-1]).astype(np.float32), g


# the f32 cases under their first ids, and bf16 inputs for dw alone
DW_GRAD_CASES = ([pytest.param(shape, k, "float32", id=f"shape{i}-{k}")
                  for i, (shape, k) in enumerate(DW_CASES)] +
                 [pytest.param(*DW_CASES[i], "bfloat16", id=f"shape{i}-{DW_CASES[i][1]}-bfloat16")
                  for i in (0, 1)])


@pytest.mark.parametrize("shape,k,dtype", DW_GRAD_CASES)
def test_depthwise_grads_match_jax(shape, k, dtype):
    x, w, g = _dw_case(shape, k)
    if dtype == "bfloat16":
        # dw from bf16 inputs, products and sums in f32 (the f32 cases
        # cannot tell where the inputs are widened): within f32 rounding
        # of the TPU kernel's sums
        tx, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g))
        ref = _dw_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), k, k,
                         interpret=True)
        ours = plain_depthwise_dw(tx, tg, k, k)
        assert ours.dtype == torch.float32
        assert _max_abs(ours, ref) <= TOL * max(1.0, float(jnp.max(jnp.abs(ref))))
        return
    rdx, rdw = jax.grad(lambda a, b: jnp.sum(xla_depthwise_conv2d(a, b) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    pdx, pdw = _dxdw_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(w), k, k,
                            interpret=True)
    dw_only = _dw_pallas(jnp.asarray(x), jnp.asarray(g), k, k, interpret=True)
    dx, dw = plain_depthwise_dxdw(_t(x), _t(g), _t(w))
    for ours, pallas, ref in ((dx, pdx, rdx), (dw, pdw, rdw)):
        assert _max_abs(ours, pallas) <= TOL
        assert _max_abs(ours, ref) <= TOL
    assert _max_abs(plain_depthwise_dw(_t(x), _t(g), k, k), dw_only) <= TOL

    # through the autograd Function: dxdw when x needs a gradient, dw alone
    # when only w does
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    depthwise_conv2d(tx, tw).backward(torch.from_numpy(g))
    assert _max_abs(tx.grad, rdx) <= TOL and _max_abs(tw.grad, rdw) <= TOL
    tw = _t(w, grad=True)
    depthwise_conv2d(_t(x), tw).backward(torch.from_numpy(g))
    assert _max_abs(tw.grad, rdw) <= TOL


def test_depthwise_plain_bwd_matches_torch_autograd():
    x, w, g = _dw_case((2, 6, 9, 8), 5, seed=5)
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    ref = torch.autograd.grad(plain_depthwise_conv2d(tx, tw), (tx, tw), torch.from_numpy(g))
    dx, dw = plain_depthwise_dxdw(_t(x), _t(g), _t(w))
    assert _max_abs(dx, ref[0]) <= TOL and _max_abs(dw, ref[1]) <= TOL


def test_cpu_backward_takes_the_plain_versions_without_counting():
    kernels.reset_launch_counts()
    q, k, v, g, bias, mask, nh, scale = _window_case(16, True, True)
    qkv = _t(np.concatenate([q, k, v], axis=-1), grad=True)
    window_attention(qkv, _t(bias, grad=True), _t(mask), nh, scale).sum().backward()
    x, w, _ = _dw_case((1, 4, 5, 8), 3)
    depthwise_conv2d(_t(x, grad=True), _t(w, grad=True)).sum().backward()
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 0)
