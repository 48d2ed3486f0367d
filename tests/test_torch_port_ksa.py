"""The port's ``oda2_ksa_reg`` pieces against the JAX package's, in f32 on
the CPU.

- K5, the channel attention: the plain version against
  ``xla_channel_attention`` and against the Pallas kernel in interpret mode
  at 1e-5, square and rectangular head dims; its gradients (the autograd
  Function's plain backward) against ``jax.vjp`` of both at 1e-4 of the
  larger of 1 and the reference's largest magnitude, and the plain backward
  against torch's autograd of the plain forward.
- ``adaptive_avg_pool2d``, the Pyramid Pooling Module (eval, and training
  with its new running statistics), ``KernelWindowAttention``, ``KSABlock``
  (shift 0 and shift > 0, non-square maps, one not a multiple of the window)
  and ``PatchUnMerging`` against the JAX modules at 1e-4; the decoder's
  dropout rates reaching every block, and a KSA block in training at each
  rate under flax's dropout masks. Each JAX module's
  variables are seeded numpy values and reach the port through
  ``from_jax_variables`` (placed where the KSA model holds that module).
- A tiny ``ODA2KSARegModel`` (custom Swin encoder, decoder depths (2, 2, 2,
  2), window 4, 64x96 images) forward through the converter at 1e-4 of
  the depth range, and
  the port's weights back to the JAX tree through the JAX package's own
  ``convert_oda2_ksa_decoder``.
"""

import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mde_tpu.models.oda2.ksa as jax_ksa
from mde_tpu.core.family_converters import convert_oda2_ksa_decoder
from mde_tpu.ops import resize as jax_resize
from mde_tpu.ops.pallas.channel_attention import (_pallas_channel_attention_bwd,
                                                  fused_channel_attention, xla_channel_attention)
from mde_tpu.ops.ppm import PyramidPoolingModule as JaxPPM
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.oda2 import ksa
from mde_tpu_torch.ops import drop, kernels, resize
from mde_tpu_torch.ops.kernels.channel_attention import (channel_attention,
                                                         plain_channel_attention,
                                                         plain_channel_attention_bwd)
from mde_tpu_torch.ops.ppm import PyramidPoolingModule
from test_torch_port_flagship import ENC, _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4
# bf16 gradients, relative to max(1, max |ref|): an output one bf16 ulp
# (2^-8 relative) apart in a few elements, from sums in another order
BF16_GRAD_TOL = 1e-3
# BatchNorm running statistics, relative to max(1, max |JAX's|): batch means
# of convolutions that the two frameworks sum in another order (the train
# step's tolerance, tests/_torch_port_train_case.py)
STATS_TOL = 1e-5

# the tiny model: decoder widths 8/16/32/64, head dims 4/8/8/16
CFG = dict(name="oda2_ksa_reg", encoder_type="custom", dec_dim=64, depths=(2, 2, 2, 2),
           dec_num_heads=(2, 2, 4, 4), window_size=4)


def _max_abs(a, b) -> float:
    a = a.detach().cpu().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.max(np.abs(a.astype(np.float64) - np.asarray(b, np.float64))))


def _rel(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return _max_abs(a, b) / max(1.0, float(np.max(np.abs(np.asarray(b)))))


def _input(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _channel_case(c, ec, seed=0):
    rng = np.random.RandomState(seed)
    bw, n = 8, 49
    q = rng.randn(bw, n, c).astype(np.float32)
    k, v, g = (rng.randn(bw, n, ec if i < 2 else c).astype(np.float32) for i in range(3))
    return q, k, v, g, 4, n ** -0.5


CHANNEL_CASES = [(32, 32), (32, 64), (48, 16)]


@pytest.mark.parametrize("c,ec", CHANNEL_CASES)
def test_channel_attention_plain_matches_jax(c, ec):
    q, k, v, _, nh, scale = _channel_case(c, ec)
    t = torch.from_numpy
    ours = plain_channel_attention(t(q), t(k), t(v), nh, scale)
    j = [jnp.asarray(a) for a in (q, k, v)]
    assert _max_abs(ours, xla_channel_attention(*j, nh, scale)) <= KERNEL_TOL
    assert _max_abs(ours, fused_channel_attention(*j, nh, scale,
                                                  impl="pallas_interpret")) <= KERNEL_TOL
    # the wrapper takes the plain version for CPU tensors
    kernels.reset_launch_counts()
    fused = channel_attention(t(q), t(np.concatenate([k, v], -1)), nh, scale)
    assert torch.equal(fused, ours) and not any(kernels.launch_counts.values())


# the f32 cases under their first ids, and one bf16 case at the KSA
# decoder's head dims (8 windows, 64 channels, 4 heads of 16)
CHANNEL_GRAD_CASES = ([pytest.param(c, ec, "float32", id=f"{c}-{ec}")
                       for c, ec in CHANNEL_CASES] +
                      [pytest.param(64, 64, "bfloat16", id="64-64-bfloat16")])


@pytest.mark.parametrize("c,ec,dtype", CHANNEL_GRAD_CASES)
def test_channel_attention_grads_match_jax(c, ec, dtype):
    q, k, v, g, nh, scale = _channel_case(c, ec, seed=1)
    if dtype == "bfloat16":
        # the TPU kernel's backward on bf16 inputs rounds P and dS to bf16
        # before the products, as the port's plain backward does (in f32
        # that rounding is the identity): the two agree but for sums in
        # another order moving an output rounding by one bf16 ulp
        tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
        tq, tkv = tq.requires_grad_(), torch.cat([tk, tv], -1).requires_grad_()
        channel_attention(tq, tkv, nh, scale).backward(tg)
        ours = (tq.grad, tkv.grad[..., :ec], tkv.grad[..., ec:])
        ref = _pallas_channel_attention_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)),
                                            nh, scale, interpret=True)
        for name, o, r in zip(("dq", "dk", "dv"), ours, ref):
            assert o.dtype == torch.bfloat16
            assert _rel(o, r.astype(jnp.float32)) <= BF16_GRAD_TOL, (name, _rel(o, r))
        return
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(np.concatenate([k, v], -1)).requires_grad_()
    channel_attention(tq, tkv, nh, scale).backward(torch.from_numpy(g))
    ours = (tq.grad, tkv.grad[..., :ec], tkv.grad[..., ec:])
    for fn in (xla_channel_attention,
               lambda *a: fused_channel_attention(*a, impl="pallas_interpret")):
        _, vjp = jax.vjp(lambda a, b, d: fn(a, b, d, nh, scale),
                         *(jnp.asarray(x) for x in (q, k, v)))
        for name, o, r in zip(("dq", "dk", "dv"), ours, vjp(jnp.asarray(g))):
            assert _rel(o, r) <= GRAD_TOL, (name, _rel(o, r))


def test_channel_attention_plain_bwd_matches_torch_autograd():
    q, k, v, g, nh, scale = _channel_case(32, 64, seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = torch.autograd.grad(plain_channel_attention(tq, tk, tv, nh, scale), (tq, tk, tv),
                              torch.from_numpy(g))
    ours = plain_channel_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, g)), nh, scale)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= KERNEL_TOL


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (6, 6), (7, 9)])
def test_adaptive_avg_pool2d(size):
    x = _input(3, 2, 7, 9, 5)
    assert _max_abs(resize.adaptive_avg_pool2d(torch.from_numpy(x), size),
                    jax_resize.adaptive_avg_pool2d(jnp.asarray(x), size)) <= 1e-6


def _jax_vars(module, seed, *args):
    """The JAX module's variables, seeded as the flagship test seeds them."""
    init = types.SimpleNamespace(
        init=lambda key, x, train: module.init(key, *(jnp.asarray(a) for a in args),
                                               train=train))
    return _random_jax_variables(init, jnp.asarray(args[0]), seed)


def _port_state(variables, where, prefix) -> dict:
    """A JAX module's variables placed at ``where`` (a path of the KSA
    model's tree) through the converter, which must name them ``prefix``
    + the module's own names; returns the latter."""
    def nest(tree):
        for key in reversed(where):
            tree = {key: tree}
        return tree

    nested = {"params": {}, **{k: nest(v) for k, v in variables.items()}}
    converted = from_jax_variables(nested)
    assert all(name.startswith(prefix) for name in converted)
    return {name[len(prefix):]: value for name, value in converted.items()}


@pytest.mark.parametrize("train", [False, True])
def test_pyramid_pooling_module(train):
    x = _input(4, 2, 7, 9, 32) * 2 + 0.5
    jm = JaxPPM(proj_ch=16, out_ch=24)
    variables = _jax_vars(jm, 5, x)
    mod = PyramidPoolingModule(32, 16, 24).train(train)
    mod.load_state_dict(_port_state(variables, ("decoder", "ppm32"), "decoder.ppm32."))
    ours = mod(torch.from_numpy(x))
    if not train:
        assert _max_abs(ours, jm.apply(variables, jnp.asarray(x))) <= TOL
        return
    ref, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert _max_abs(ours, ref) <= TOL
    new = _port_state({"batch_stats": upd["batch_stats"]}, ("decoder", "ppm32"),
                      "decoder.ppm32.")
    state = mod.state_dict()
    for name, value in new.items():
        if value.is_floating_point():
            scale = max(1.0, value.abs().max().item())
            assert _max_abs(state[name], value) <= STATS_TOL * scale, name


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_kernel_window_attention(impl):
    x, enc = _input(6, 4, 16, 32), _input(7, 4, 16, 64)
    jm = jax_ksa.KernelWindowAttention(num_heads=2, attn_impl=impl)
    variables = _jax_vars(jm, 8, x, enc)
    mod = ksa.KernelWindowAttention(32, 64, 2).eval()
    mod.load_state_dict(_port_state(variables, ("decoder", "layers0_blocks0", "kernel_attn"),
                                    "decoder.layers.0.blocks.0.kernel_attn."))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(enc))
    assert _max_abs(mod(torch.from_numpy(x), torch.from_numpy(enc)), ref) <= TOL
    # training without attention dropout keeps the kernel's path: the same
    assert _max_abs(mod.train()(torch.from_numpy(x), torch.from_numpy(enc)), ref) <= TOL


@pytest.mark.parametrize("rates", [dict(attn_drop_prob=0.1), dict(drop_prob=0.1)])
def test_ksa_dropout_is_not_ported(rates, monkeypatch):
    """Dropout inside the KSA decoder, which the first KSA slice refused, is
    ported: the build carries each rate to every block's kernel attention,
    W-MSA and MLPs (the coarsest stage's Swin blocks too), and a KSA block
    in training at that rate alone matches flax's with flax's masks handed
    to the port's dropout in call order."""
    model = build_model(dict(CFG, **rates), 0.001, 80.0, device="cpu", encoder_kwargs=ENC)
    blocks = [b for stage in model.decoder.layers for b in stage.blocks]
    attn, out = rates.get("attn_drop_prob", 0.0), rates.get("drop_prob", 0.0)
    for b in blocks:
        attentions = [b.attn] + ([b.kernel_attn] if isinstance(b, ksa.KSABlock) else [])
        assert all(a.attn_drop.rate == attn and a.proj_drop.rate == out for a in attentions)
        mlps = [b.mlp1, b.mlp2] if isinstance(b, ksa.KSABlock) else [b.mlp]
        assert all(m.drop.rate == out for m in mlps)
    assert len(blocks) == 8 and sum(isinstance(b, ksa.KSABlock) for b in blocks) == 6
    x, enc = _input(18, 2, 8, 12, 16), _input(19, 2, 8, 12, 16)
    jm = jax_ksa.KSABlock(num_heads=2, window_size=4, shift_size=2, **rates)
    variables = _jax_vars(jm, 20, x, enc)
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__"
                and context.module.rate > 0):
            masks.append(torch.from_numpy(np.asarray(out) != 0))
        return out

    with flax_nn.intercept_methods(interceptor):
        ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(enc), train=True,
                       rngs={"dropout": jax.random.PRNGKey(21)})
    assert len(masks) == (2 if attn else 6)
    mod = ksa.KSABlock(16, 16, 2, 4, 2, **rates).train()
    mod.load_state_dict(_port_state(variables, ("decoder", "layers0_blocks1"),
                                    "decoder.layers.0.blocks.1."))
    handed = iter(masks)
    monkeypatch.setattr(drop, "_keep_mask", lambda shape, *a: next(handed))
    ours = mod(torch.from_numpy(x), torch.from_numpy(enc))
    assert next(handed, None) is None
    assert _max_abs(ours, ref) <= TOL


@pytest.mark.parametrize("shift,hw", [(0, (8, 12)), (2, (8, 12)), (2, (7, 10))])
def test_ksa_block(shift, hw):
    c, nh, r = 16, 2, 4
    x, enc = _input(11, 2, *hw, c), _input(12, 2, *hw, c)
    jm = jax_ksa.KSABlock(num_heads=nh, window_size=r, shift_size=shift)
    variables = _jax_vars(jm, 13, x, enc)
    mod = ksa.KSABlock(c, c, nh, r, shift).eval()
    mod.load_state_dict(_port_state(variables, ("decoder", "layers0_blocks1"),
                                    "decoder.layers.0.blocks.1."))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(enc))
    ours = mod(torch.from_numpy(x), torch.from_numpy(enc))
    assert ours.shape == ref.shape and _max_abs(ours, ref) <= TOL


def test_patch_unmerging():
    x = _input(14, 2, 3, 5, 32)
    jm = jax_ksa.PatchUnMerging()
    variables = _jax_vars(jm, 15, x)
    mod = ksa.PatchUnMerging(32).eval()
    mod.load_state_dict(_port_state(variables, ("decoder", "layers1_up"),
                                    "decoder.layers.1.upsample."))
    ref = jm.apply(variables, jnp.asarray(x))
    ours = mod(torch.from_numpy(x))
    assert ours.shape == (2, 6, 10, 16) and _max_abs(ours, ref) <= TOL


def _jax_model(**overrides):
    return jax_ksa.ODA2KSARegModel.build(CFG, 0.001, 80.0, resize_to_multiple=False,
                                         encoder_kwargs=ENC, use_checkpoint=False,
                                         **overrides)


def test_ksa_model_matches_jax():
    x = np.random.RandomState(16).rand(2, 64, 96, 3).astype(np.float32)
    jm = _jax_model()
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=17)
    port = build_model(CFG, 0.001, 80.0, device="cpu", resize_to_multiple=False,
                       encoder_kwargs=ENC)
    port.load_state_dict(from_jax_variables(variables))
    # jitted: op by op the JAX model takes ~7x as long on the CPU
    ref, none = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        out, aux = port(torch.from_numpy(x))
    assert aux is None and none is None
    assert out.shape == ref.shape == (2, 14, 22, 1)
    # in units of the depth range (the decoder's sigmoid map): the f32
    # noise of ~40 layers summed in another order (mean 4e-7 of the range)
    # comes out 80x larger in metres
    assert _max_abs(out, ref) <= TOL * (80.0 - 0.001)

    # the port's decoder names are the reference's: the JAX package's own
    # converter takes them back to exactly the JAX decoder variables
    state = {k[len("decoder."):]: v.numpy() for k, v in port.state_dict().items()
             if k.startswith("decoder.")}
    back = convert_oda2_ksa_decoder(state, depths=CFG["depths"])
    ref_dec = {k: v["decoder"] for k, v in variables.items()}
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref_dec))
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(back_leaves) == len(leaves)
    for path, leaf in back_leaves:
        np.testing.assert_array_equal(leaf, leaves[path], err_msg=jax.tree_util.keystr(path))
