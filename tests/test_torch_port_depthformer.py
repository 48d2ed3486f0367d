"""The port's Depthformer v1-v5 against the JAX package's, in f32 on the CPU.

- The layers (``ConvBN`` with and without its residual, ``ConvBNBlock``,
  ``ResConvBNBlock`` with its shortcut, ``SelfAttentionBlock`` with its own
  key-query width, ``FeedForwardBlock``, ``ViTLayer`` repeating one set of
  weights twice): the output (and the attention weights) and the gradients
  of a seeded loss with respect to the input and every parameter, at 1e-4
  of max(1, max |JAX's|); in eval mode, and the attention and FF blocks in
  training with both dropout rates at 0.1, the port handed the keep masks
  flax drew in an eager forward (``jax.random.bernoulli`` recorded in call
  order). ``upscale_concat_act`` at 1e-5.
- The tiny v1-v5 (the EfficientNet of ``tests/test_adabins.py``, hidden
  width 16 or 32, 4 heads, 64x64 images; v4 on 64x96): the depth through
  ``from_jax_variables`` at 1e-4 of the depth range, every attention
  weight at 1e-4 and v3's bin edges at 1e-4 of the depth range; the port's
  decoder weights of v2, v5 and v4 back through the JAX package's own
  ``convert_depthformer_v2_decoder`` / ``convert_depthformer_v4_decoder``
  to exactly the JAX decoder variables (v1 and v3 have no converter: their
  names are held by the strict load). One jitted JAX forward a model.
- The train step's adapter gives v1's, v2's and v5's loss the depth map,
  where JAX's default adapter hands it the attention weights (ROADMAP
  Queue 3, J1); v3's edges become centers; v4's weights reach neither.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.family_converters import (convert_depthformer_v2_decoder,
                                            convert_depthformer_v4_decoder)
from mde_tpu.models.depthformer import layers as jax_layers
from mde_tpu.models.depthformer.model import Depthformer as JaxDepthformer
from mde_tpu.models.depthformer.versions import DepthformerV2, DepthformerV3, DepthformerV4
from mde_tpu.ops import tnn as jax_tnn
from mde_tpu.train.step import default_adapter as jax_default_adapter
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.depthformer import layers
from mde_tpu_torch.ops import tnn
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.step import make_adapter
from test_torch_port_adabins import _input, _rel, check_module
from test_torch_port_flagship import _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 80.0
TINY_ENC = dict(width=0.1, depth=0.25, stem_ch=32, head_ch=256)

SA = dict(key_query_dim=8, num_heads=2, attn_drop_prob=0.1, drop_prob=0.1)
# kind -> (the JAX module, the port module, the input's shape, the outputs'
# shapes, where it sits in a Depthformer's tree and its port names there, the
# masks flax draws in training, or None where the module has no dropout)
MODULES = {
    "ConvBN-residual": (
        lambda: jax_layers.ConvBN(8, 3, act=jax_tnn.gelu),
        lambda: layers.ConvBN(8, 8, 3, act=tnn.gelu), (2, 6, 10, 8), [(2, 6, 10, 8)],
        ("decoder", "post_conv0", "layers0"), "decoder.post_conv_layers.0.layers.0.", None),
    "ConvBN": (
        lambda: jax_layers.ConvBN(8, 3), lambda: layers.ConvBN(6, 8, 3), (2, 6, 10, 6),
        [(2, 6, 10, 8)], ("decoder", "post_conv0", "layers0"),
        "decoder.post_conv_layers.0.layers.0.", None),
    "ConvBNBlock": (
        lambda: jax_layers.ConvBNBlock(8, 5), lambda: layers.ConvBNBlock(6, 8, 5), (2, 6, 10, 6),
        [(2, 6, 10, 8)], ("decoder", "post_conv1"), "decoder.post_conv_layers.1.", None),
    "ResConvBNBlock": (
        lambda: jax_layers.ResConvBNBlock(8, 3), lambda: layers.ResConvBNBlock(6, 8, 3),
        (2, 6, 10, 6), [(2, 6, 10, 8)], ("decoder", "post_conv2"),
        "decoder.post_conv_layers.2.", None),
    "SelfAttentionBlock": (
        lambda: jax_layers.SelfAttentionBlock(**SA), lambda: layers.SelfAttentionBlock(16, **SA),
        (2, 12, 16), [(2, 12, 16), (2, 2, 12, 12)], ("decoder", "vit0", "self_attn"),
        "decoder.vit_layers.0.self_attn.", 2),
    "FeedForwardBlock": (
        lambda: jax_layers.FeedForwardBlock(feedforward_dim=32, drop_prob=0.1),
        lambda: layers.FeedForwardBlock(16, 32, drop_prob=0.1), (2, 12, 16), [(2, 12, 16)],
        ("decoder", "vit0", "feed_forward"), "decoder.vit_layers.0.feed_forward.", 2),
    "ViTLayer": (
        lambda: jax_layers.ViTLayer(num_repeat=2, feedforward_dim=32, **SA),
        lambda: layers.ViTLayer(16, num_repeat=2, feedforward_dim=32, **SA), (2, 12, 16),
        [(2, 12, 16), (2, 2, 12, 12)], ("decoder", "vit0"), "decoder.vit_layers.0.", 8),
}
CASES = [(k, False) for k in MODULES] + [(k, True) for k, m in MODULES.items() if m[-1]]


@pytest.mark.parametrize("kind,train", CASES,
                         ids=[f"{k}-{'train_dropout' if t else 'eval'}" for k, t in CASES])
def test_depthformer_layer_matches_jax(kind, train, monkeypatch):
    check_module(monkeypatch, train, *MODULES[kind])


@pytest.mark.parametrize("act", [None, "gelu"])
def test_upscale_concat_act_matches_jax(act):
    x, y = _input(1, 2, 8, 12, 3), _input(2, 2, 2, 3, 5)
    ours = layers.upscale_concat_act(torch.from_numpy(x), torch.from_numpy(y), 4,
                                     act=tnn.gelu if act else None)
    ref = jax_layers.upscale_concat_act(jnp.asarray(x), jnp.asarray(y), 4,
                                        act=jax_tnn.gelu if act else None)
    assert tuple(ours.shape) == ref.shape == (2, 8, 12, 8) and _rel(ours, ref) <= 1e-5


# name -> (the config, the JAX model, the image size, the converter of its
# decoder or None)
MODELS = {
    "depthformer": (dict(hidden_dim=16, num_heads=4, img_size=(64, 64)),
                    lambda cfg: JaxDepthformer.build(cfg, 0.001, MAX_DEPTH), (64, 64), None),
    "depthformer_v2": (dict(hidden_dim=32, num_heads=4, img_size=(64, 64)),
                       lambda cfg: DepthformerV2.build(2, cfg, 0.001, MAX_DEPTH), (64, 64),
                       convert_depthformer_v2_decoder),
    "depthformer_v3": (dict(hidden_dim=32, num_heads=4, img_size=(64, 64), num_bins=10),
                       lambda cfg: DepthformerV3.build(cfg, 0.001, MAX_DEPTH), (64, 64), None),
    "depthformer_v4": (dict(hidden_dim=16, num_heads=4, img_size=(64, 96)),
                       lambda cfg: DepthformerV4.build(cfg, 0.001, MAX_DEPTH), (64, 96),
                       convert_depthformer_v4_decoder),
    "depthformer_v5": (dict(hidden_dim=32, num_heads=4, img_size=(64, 64), key_query_dim=64),
                       lambda cfg: DepthformerV2.build(5, cfg, 0.001, MAX_DEPTH), (64, 64),
                       convert_depthformer_v2_decoder),
}


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    """(variables, images, the jitted eval forward's output) of a tiny JAX
    model."""
    cfg, make, hw, _ = MODELS[name]
    jm = make(cfg).clone(encoder_kwargs=TINY_ENC)
    x = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32)
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=6)
    return variables, x, jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                             jnp.asarray(x))


def _port(name, variables):
    cfg = MODELS[name][0]
    port = build_model(dict(cfg, name=name), 0.001, MAX_DEPTH, device="cpu",
                       encoder_kwargs=TINY_ENC)
    port.load_state_dict(from_jax_variables(variables))
    return port


@pytest.mark.parametrize("name", list(MODELS))
def test_depthformer_matches_jax_both_ways(name):
    variables, x, ref = _jax_forward(name)
    port = _port(name, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref)
    hw = MODELS[name][2]
    assert out[0].shape == ref[0].shape == (2, hw[0] // 2, hw[1] // 2, 1)
    # in units of the depth range
    assert _rel(out[0], ref[0]) <= TOL * (MAX_DEPTH - 0.001)
    if name == "depthformer_v3":
        edges, attn, ref_edges, ref_attn = out[1], out[2], ref[1], ref[2]
        assert edges.shape == ref_edges.shape == (2, 11)
        assert _rel(edges, ref_edges) <= TOL * (MAX_DEPTH - 0.001)
    else:
        attn, ref_attn = out[1], ref[1]
    assert len(attn) == len(ref_attn) == {"depthformer": 4, "depthformer_v4": 5}.get(name, 3)
    for a, r in zip(attn, ref_attn):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape and _rel(a, r) <= TOL

    convert = MODELS[name][3]
    if convert is None:
        return
    # port -> JAX through the JAX package's own converter: exactly the
    # decoder variables the port was loaded from
    state = {k[len("decoder."):]: v.numpy() for k, v in port.state_dict().items()
             if k.startswith("decoder.")}
    back = convert(state)
    ref_dec = {k: v["decoder"] for k, v in variables.items()}
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref_dec))
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(back_leaves) == len(leaves)
    for path, leaf in back_leaves:
        np.testing.assert_array_equal(leaf, leaves[path], err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_depthformer_adapter_routes_as_the_port_means(name):
    """JAX's default adapter takes any tuple of 4-D tensors in a model's
    second slot for the ordered heads' maps (``mde_tpu/train/step.py:38-43``):
    it hands v1's, v2's and v5's (B, heads, N, N) attention weights to the
    loss. The port's takes only (B, h, w, 1) maps there and gives the loss
    the depth map. v3's second item is its edges (centers for the chamfer
    loss on both sides), v4's weights are 3-D: both route alike."""
    variables, x, ref = _jax_forward(name)
    with torch.no_grad():
        out = _port(name, variables)(torch.from_numpy(x))
    maps, bins = make_adapter(name)(out)
    assert len(maps) == 1 and maps[0] is out[0]
    jax_maps, jax_bins = jax_default_adapter(ref)
    if name in ("depthformer", "depthformer_v2", "depthformer_v5"):
        assert bins is None and jax_bins is None
        assert [m.shape for m in jax_maps] == [a.shape for a in ref[1]]
        assert all(m.ndim == 4 and m.shape[-1] != 1 for m in jax_maps)
    elif name == "depthformer_v3":
        assert torch.equal(bins, 0.5 * (out[1][:, 1:] + out[1][:, :-1]))
        assert jax_maps[0] is ref[0] and jax_bins is ref[1]
    else:
        assert bins is None and jax_bins is None and jax_maps[0] is ref[0]


def test_depthformer_v4_serves_through_predictor():
    """v4 takes any size: ``Predictor`` serves its map resized to the input."""
    from mde_tpu.ops.resize import resize_bilinear as jax_resize
    variables, x, ref = _jax_forward("depthformer_v4")
    pred = Predictor(_port("depthformer_v4", variables)).predict(x)
    want = np.clip(np.asarray(jax_resize(ref[0], x.shape[1:3])), 0.0, None)
    assert pred.shape == (2, 64, 96, 1)
    assert float(np.max(np.abs(pred.numpy() - want))) <= TOL * (MAX_DEPTH - 0.001)


def test_depthformer_v1_checks_its_input_size():
    port = build_model(dict(MODELS["depthformer"][0], name="depthformer"), 0.001, MAX_DEPTH,
                       device="cpu", encoder_kwargs=TINY_ENC)
    with pytest.raises(ValueError, match="requires input size"):
        port(torch.zeros(1, 32, 64, 3))
