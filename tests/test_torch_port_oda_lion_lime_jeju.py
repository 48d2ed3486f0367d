"""The port's ODA Lion, Lime and Jeju (``mde_tpu_torch/models/oda/{lion,lime,
jeju}.py``) against the JAX package's, in f32 on the CPU.

- ``resize_nearest`` against JAX's, exactly, in f32 and bf16, at integer
  and non-integer ratios both ways; the four ``apply_out_func`` heads.
- The modules at tiny widths: ``LionAxialAttention`` (h and w, self and
  cross), ``LionFeedForwardConv``, ``LionLayer`` (and its last block with
  the BatchNorm), ``PyramidPoolingModuleV2``, ``LimeConvBlock``,
  ``LimeCrossAttention``, ``JejuBlock``, the grouped ``JejuFeedForward``,
  ``SpatialUpsample2d`` (LN, and the last one's BatchNorm) and
  ``ReorderUpsample1d``: every output (the f32 weights included) and the
  gradients of a seeded loss with respect to the inputs and every
  parameter, at 1e-4 of max(1, max |JAX's|); in eval mode, and in
  training (every dropout at 0.1, the port handed the keep masks flax drew
  in an eager forward, recorded in call order; BatchNorm on batch
  statistics, the running statistics it leaves held too). Each module
  sits in a decoder's tree for the converter's names.
- The tiny models (``tests/test_oda_lion_lime_jeju.py``'s configs) at
  64x64 with the resize off, and ``oda_lime`` at 384x384 with its
  model-level resize on: the depth through ``from_jax_variables`` at 1e-4
  of the depth range (Lime's at 1/4 scale), every weight and Jeju's aux
  tokens at 1e-4; the port's decoder back through the JAX package's own
  ``convert_oda_{lion,lime,jeju}_decoder`` to exactly the JAX decoder
  variables; both adapters (J1: JAX's hands Lion's eight weights to the
  loss as maps, the port the depth); ``Predictor`` serves Lime at 1/4.
- J2: Lion's position embedding has the 1/32 grid of the first call in
  JAX and of ``img_size`` in the port; a model built for 352x704 (12x24
  after the resize) cannot run at 352x1216 (12x36) in either. The port's
  ``Trainer`` builds it for the train crop, as JAX's sizes it by the first
  train batch.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.family_converters import (convert_oda_jeju_decoder, convert_oda_lime_decoder,
                                            convert_oda_lion_decoder)
from mde_tpu.models.oda import jeju as jax_jeju
from mde_tpu.models.oda import lime as jax_lime
from mde_tpu.models.oda import lion as jax_lion
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu.ops.resize import resize_nearest as jax_resize_nearest
from mde_tpu.train.step import make_adapter as jax_make_adapter
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.core.config import load_config
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.oda import jeju, lime, lion
from mde_tpu_torch.ops import ppm
from mde_tpu_torch.ops.resize import resize_nearest
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train import driver
from mde_tpu_torch.train.step import make_adapter
from test_driver import TINY_OPT
from test_torch_port_adabins import _flax_masks, _hand_masks, _input, _rel, _variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 80.0
TINY_ENC = dict(embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8))
RATES = dict(attn_drop_prob=0.1, drop_prob=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src,dst", [((6, 10), (24, 40)), ((7, 13), (16, 30)),
                                     ((12, 24), (5, 7)), ((6, 9), (6, 9))],
                         ids=["x4", "non_integer_up", "down", "same"])
def test_resize_nearest_matches_jax_exactly(src, dst, dtype):
    x = _input(1, 2, *src, 3)
    ref = jax_resize_nearest(jnp.asarray(x).astype(dtype), dst).astype(jnp.float32)
    out = resize_nearest(torch.from_numpy(x).to(getattr(torch, dtype)), dst)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref))


@pytest.mark.parametrize("out_func", ["sigmoid", "scaled_sigmoid", "inv_scaled_sigmoid", "relu"])
def test_apply_out_func_matches_jax(out_func):
    x = 3 * _input(2, 2, 4, 5, 1)
    ref = jax_lion.apply_out_func(jnp.asarray(x), out_func, 0.001, MAX_DEPTH)
    out = lion.apply_out_func(torch.from_numpy(x).bfloat16(), out_func, 0.001, MAX_DEPTH)
    ref_bf16 = jax_lion.apply_out_func(jnp.asarray(x).astype(jnp.bfloat16), out_func, 0.001,
                                       MAX_DEPTH)
    assert out.dtype == torch.float32 and ref_bf16.dtype == jnp.float32
    assert _rel(out, ref_bf16) <= 1e-6
    assert _rel(lion.apply_out_func(torch.from_numpy(x), out_func, 0.001, MAX_DEPTH),
                ref) <= 1e-6
    with pytest.raises(ValueError, match="out_func"):
        lion.apply_out_func(torch.from_numpy(x), "tanh", 0.001, MAX_DEPTH)


MAP, ENC = (2, 3, 4, 8), (2, 3, 4, 6)
# kind -> (the JAX module, the port module (dropout 0.1 in both where it has
# any), the inputs' shapes, the outputs' shapes, where it sits in a decoder's
# tree and its port names there, the masks flax draws in training). The PPM
# takes three images with colour casts (``CASTS``): the 1x1 pool's channels
# are constant over an image, and BatchNorm maps two images' values to -1 and
# +1 whatever they are, which leaves that reduce's gradient rounding noise in
# both frameworks; on plain random images the three pooled values lie within
# ~0.1 of one another and the BatchNorm's 1/sigma amplifies f32 rounding.
MODULES = {
    **{f"LionAxialAttention-{axis}-{kind}": (
        functools.partial(jax_lion.LionAxialAttention, axis=axis, cross=kind == "cross",
                          **RATES),
        functools.partial(lion.LionAxialAttention, 8, axis, 6 if kind == "cross" else None,
                          **RATES),
        [MAP, ENC] if kind == "cross" else [MAP],
        [MAP, (2, 3 if axis == "h" else 4, 8, 8)],
        ("decoder", "lion32", f"{'cross_' if kind == 'cross' else ''}attn_{axis}"),
        f"decoder.lion32.{'cross_' if kind == 'cross' else ''}attn_{axis}.", 2)
        for axis in ("h", "w") for kind in ("self", "cross")},
    "LionFeedForwardConv": (
        functools.partial(jax_lion.LionFeedForwardConv, feedforward_dim=8, drop_prob=0.1),
        functools.partial(lion.LionFeedForwardConv, 8, 8, 0.1), [(2, 4, 5, 8)],
        [(2, 4, 5, 8)], ("decoder", "lion16", "feed_forward_w"),
        "decoder.lion16.feed_forward_w.", 1),
    "LionLayer": (
        functools.partial(jax_lion.LionLayer, **RATES),
        functools.partial(lion.LionLayer, 8, 6, False, **RATES), [MAP, ENC],
        [(2, 6, 8, 4), (2, 4, 8, 8), (2, 4, 8, 8)], ("decoder", "lion32"), "decoder.lion32.",
        10),
    "LionLayer-last": (
        functools.partial(jax_lion.LionLayer, last_block=True, **RATES),
        functools.partial(lion.LionLayer, 8, 6, True, **RATES), [MAP, ENC],
        [(2, 6, 8, 4), (2, 4, 8, 8), (2, 4, 8, 8)], ("decoder", "lion4"), "decoder.lion4.", 10),
    "PyramidPoolingModuleV2": (
        functools.partial(jax_lion.PPMv2, proj_ch=4, out_ch=8),
        functools.partial(ppm.PyramidPoolingModuleV2, 6, 4, 8), [(3, 6, 7, 6)], [(3, 6, 7, 8)],
        ("decoder", "ppm"), "decoder.ppm.", 0),
    "LimeConvBlock": (
        functools.partial(jax_lime.LimeConvBlock, mid_ch=4),
        functools.partial(lime.LimeConvBlock, 8, 4), [(2, 5, 6, 8)], [(2, 5, 6, 8)],
        ("decoder", "layers0_conv"), "decoder.layers.0.conv.", 0),
    "LimeCrossAttention": (
        functools.partial(jax_lime.LimeCrossAttention, **RATES),
        functools.partial(lime.LimeCrossAttention, 8, 10, **RATES), [(2, 12, 8), (2, 12, 10)],
        [(2, 12, 8), (2, 8, 8)], ("decoder", "layers1_attn"), "decoder.layers.1.attn.", 2),
    "JejuBlock": (
        functools.partial(jax_jeju.JejuBlock, aux_dim=8, num_heads=2, **RATES),
        functools.partial(jeju.JejuBlock, 16, 6, 8, 2, **RATES),
        [(2, 12, 16), (2, 12, 6), (2, 5, 8)],
        [(2, 12, 16), (2, 5, 8), (2, 2, 5, 12), (2, 2, 12, 5)], ("decoder", "jeju16"),
        "decoder.jeju16.jeju_attn.", 3),
    "JejuFeedForward-grouped": (
        functools.partial(jax_jeju.JejuFeedForward, num_groups=4),
        functools.partial(jeju.JejuFeedForward, 8, 4), [(2, 5, 6, 8)], [(2, 5, 6, 8)],
        ("decoder", "jeju8_ff"), "decoder.jeju8.jeju_ff.", 0),
    "SpatialUpsample2d": (
        jax_jeju.SpatialUpsample2d, functools.partial(jeju.SpatialUpsample2d, 8), [MAP],
        [(2, 6, 8, 4)], ("decoder", "up32"), "decoder.hidden_32to16.", 0),
    "SpatialUpsample2d-last": (
        functools.partial(jax_jeju.SpatialUpsample2d, out_bn=True),
        functools.partial(jeju.SpatialUpsample2d, 8, True), [MAP], [(2, 6, 8, 4)],
        ("decoder", "up4"), "decoder.hidden_4to2.", 0),
    "ReorderUpsample1d": (
        jax_jeju.ReorderUpsample1d, functools.partial(jeju.ReorderUpsample1d, 8), [(2, 5, 8)],
        [(2, 10, 4)], ("decoder", "aux_up16"), "decoder.aux_16to8.", 0),
}
# kind -> the scale of a per-image, per-channel offset added to the first input
CASTS = {"PyramidPoolingModuleV2": 2.0}
# ReorderUpsample1d takes no train flag: it runs the same in both modes
CASES = [(kind, train) for kind in MODULES for train in (False, True)
         if not (train and kind == "ReorderUpsample1d")]


def _oda_state(variables, where, prefix):
    """A JAX module's variables placed at ``where`` in an ODA model's tree
    (told by its ``encoder/backbone``) through the converter, which must
    name them ``prefix`` + the module's own names; returns the latter."""
    def nest(tree):
        for key in reversed(where):
            tree = {key: tree}
        return tree

    backbone = {"encoder": {"backbone": {"norm0": {"scale": np.ones(1, np.float32)}}}}
    state = from_jax_variables(dict({"params": {}}, **{
        k: dict(nest(v), **(backbone if k == "params" else {})) for k, v in variables.items()}))
    state = {n: v for n, v in state.items() if not n.startswith("encoder.")}
    assert state and all(name.startswith(prefix) for name in state)
    return {name[len(prefix):]: value for name, value in state.items()}


@pytest.mark.parametrize("kind,train", CASES,
                         ids=[f"{k}-{'train' if t else 'eval'}" for k, t in CASES])
def test_module_matches_jax(kind, train, monkeypatch):
    make_jax, make_port, in_shapes, out_shapes, where, prefix, count = MODULES[kind]
    xs = [_input(1 + i, *s) for i, s in enumerate(in_shapes)]
    if kind in CASTS:
        b, *_, c = in_shapes[0]
        xs[0] = xs[0] + CASTS[kind] * _input(7, b, 1, 1, c)
    gs = [_input(10 + i, *s) for i, s in enumerate(out_shapes)]
    jm = make_jax()
    flag = {} if kind == "ReorderUpsample1d" else {"train": train}
    init = type("Init", (), {"init": staticmethod(
        lambda key, x, train: jm.init(key, *(jnp.asarray(a) for a in xs), **flag))})
    variables = _variables(init, jnp.asarray(xs[0]), seed=3)
    mutable = ["batch_stats"] if train and "batch_stats" in variables else False

    def apply(v, *a):
        out = jm.apply(v, *a, rngs={"dropout": jax.random.PRNGKey(4)}, mutable=mutable, **flag)
        out, new = out if mutable else (out, {})
        return (tuple(out) if isinstance(out, tuple) else (out,)), new

    # eager, so that the masks flax draws in training are recorded
    masks = _flax_masks(monkeypatch)
    ref, vjp, new = jax.vjp(apply, variables, *(jnp.asarray(a) for a in xs), has_aux=True)
    monkeypatch.undo()
    assert len(masks) == (count if train else 0)
    mod = make_port().train(train)
    mod.load_state_dict(_oda_state(variables, where, prefix))
    handed = _hand_masks(monkeypatch, masks)
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    out = mod(*ts)
    out = out if isinstance(out, tuple) else (out,)
    assert next(handed, None) is None
    assert len(out) == len(ref) == len(out_shapes)
    for o, r, shape in zip(out, ref, out_shapes):
        assert o.dtype == torch.float32
        assert tuple(o.shape) == r.shape == shape and _rel(o, r) <= TOL
    if mutable:  # the running statistics batch statistics leave
        stats = _oda_state({"params": variables["params"], **new}, where, prefix)
        state = mod.state_dict()
        for name, value in stats.items():
            if "running" in name:
                assert _rel(state[name], value.numpy()) <= TOL, name
    torch.autograd.backward(out, [torch.from_numpy(g) for g in gs])
    dvars, *dxs = vjp(tuple(jnp.asarray(g) for g in gs))
    for t, d in zip(ts, dxs):
        assert _rel(t.grad, d) <= TOL
    grads = _oda_state({"params": dvars["params"]}, where, prefix)
    params = dict(mod.named_parameters())
    assert set(grads) == set(params)
    for name, p in params.items():
        assert _rel(p.grad, grads[name].numpy()) <= TOL, name


# name -> (the config, the JAX model, the image side, whether the input is
# resized, the scale of the depth, the JAX package's converter of the decoder)
LIME = dict(decoder_channels=16, decoder_layers=2)
MODELS = {
    "oda_lion": (dict(decoder_channels=32), jax_lion.ODALionModel, 64, False, 2,
                 convert_oda_lion_decoder),
    "oda_lime": (LIME, jax_lime.ODALimeModel, 64, False, 4,
                 functools.partial(convert_oda_lime_decoder, num_layers=2)),
    "oda_lime_384_resized": (LIME, jax_lime.ODALimeModel, 384, True, 4,
                             functools.partial(convert_oda_lime_decoder, num_layers=2)),
    "oda_jeju": (dict(decoder_channels=32, num_aux=4, num_heads=8), jax_jeju.ODAJejuModel, 64,
                 False, 2, convert_oda_jeju_decoder),
}


def _registered(name):
    return "oda_lime" if name.startswith("oda_lime") else name


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    """(variables, images, the jitted eval forward's output) of a tiny JAX
    model."""
    cfg, cls, side, resize, _, _ = MODELS[name]
    jm = cls.build(cfg, 0.001, MAX_DEPTH, resize_to_multiple=resize, encoder_kwargs=TINY_ENC)
    x = np.random.RandomState(5).rand(2, side, side, 3).astype(np.float32)
    variables = _variables(jm, jnp.asarray(x), seed=6)
    return variables, x, jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                             jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def _port(name):
    cfg, _, side, resize, _, _ = MODELS[name]
    port = build_model(dict(cfg, name=_registered(name)), 0.001, MAX_DEPTH, device="cpu",
                       resize_to_multiple=resize, img_size=(side, side),
                       encoder_kwargs=TINY_ENC)
    port.load_state_dict(from_jax_variables(_jax_forward(name)[0]))
    return port


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax_both_ways(name):
    variables, x, ref = _jax_forward(name)
    _, _, side, resize, scale, convert = MODELS[name]
    port = _port(name)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref) == (3 if name == "oda_jeju" else 2)
    assert out[0].shape == ref[0].shape == (2, side // scale, side // scale, 1)
    assert _rel(out[0], ref[0]) <= TOL * (MAX_DEPTH - 0.001)
    if name == "oda_jeju":  # the final aux tokens: 4 doubled thrice, of 32 / 8
        assert out[1].shape == ref[1].shape == (2, 32, 4) and _rel(out[1], ref[1]) <= TOL
    count = LIME["decoder_layers"] if _registered(name) == "oda_lime" else 8
    assert len(out[-1]) == len(ref[-1]) == count
    for a, r in zip(out[-1], ref[-1]):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape and _rel(a, r) <= TOL

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

    # both adapters give the loss the depth map and no bins, but JAX's hands
    # it Lion's eight (B, L, d, d) weights as maps (J1)
    maps, bins = make_adapter(_registered(name))(out)
    jax_maps, jax_bins = jax_make_adapter(_registered(name))(ref)
    assert len(maps) == 1 and maps[0] is out[0] and bins is None and jax_bins is None
    assert len(jax_maps) == (8 if name == "oda_lion" else 1)


def test_oda_lime_serves_through_predictor_at_a_quarter():
    _, x, ref = _jax_forward("oda_lime")
    pred = Predictor(_port("oda_lime")).predict(x)
    want = np.clip(np.asarray(jax_resize(ref[0], x.shape[1:3])), 0.0, None)
    assert ref[0].shape == (2, 16, 16, 1) and pred.shape == (2, 64, 64, 1)
    assert float(np.max(np.abs(pred.numpy() - want))) <= TOL * (MAX_DEPTH - 0.001)


def test_oda_lion_grid_is_fixed_by_its_first_size():
    """J2: JAX sizes ``pe`` by the first call (352x704 -> 384x768: 12x24),
    and its variables fail at 352x1216 (384x1152: 12x36), flax refusing a
    ``pe`` of another shape; the port
    fixes the grid from ``img_size`` and refuses the other, and a build
    without ``img_size``."""
    cfg = dict(name="oda_lion", decoder_channels=32)
    jm = jax_lion.ODALionModel.build(cfg, 0.001, MAX_DEPTH, encoder_kwargs=TINY_ENC)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                            jax.ShapeDtypeStruct((1, 352, 704, 3), jnp.float32))
    assert shapes["params"]["decoder"]["pe"].shape == (12, 24, 32)
    with pytest.raises(flax.errors.ScopeParamShapeError,
                       match=r"shape \(12, 36, 32\).*has shape \(12, 24, 32\)"):
        jax.eval_shape(lambda v, x: jm.apply(v, x), shapes,
                       jax.ShapeDtypeStruct((1, 352, 1216, 3), jnp.float32))
    port = build_model(dict(cfg, img_size=(352, 704)), 0.001, MAX_DEPTH, device="cpu",
                       encoder_kwargs=TINY_ENC)
    assert tuple(port.decoder.pe.shape) == (12, 24, 32)
    with pytest.raises(ValueError, match=r"built for the 1/32 grid \(12, 24\)"), \
            torch.no_grad():
        port(torch.zeros(1, 352, 1216, 3))
    with pytest.raises(ValueError, match="needs img_size"):
        build_model(cfg, 0.001, MAX_DEPTH, device="cpu", encoder_kwargs=TINY_ENC)


def test_trainer_sizes_oda_lion_by_the_train_crop(tmp_path):
    """JAX's ``Trainer.init_state`` sizes ``pe`` by the first train batch;
    the port's ``Trainer`` builds ``oda_lion`` for the train crop (64x96,
    the resize off: grid 2x3) where the config names no ``img_size``."""
    opt = load_config(dict(TINY_OPT, output_dir=str(tmp_path),
                           model=dict(name="oda_lion", decoder_channels=32),
                           dataset=dict(TINY_OPT["dataset"], img_size=[64, 96])))
    trainer = driver.Trainer(opt, model_overrides=dict(resize_to_multiple=False,
                                                       encoder_kwargs=TINY_ENC), device="cpu")
    assert trainer.model.decoder.grid == (2, 3)
    with torch.no_grad():
        assert trainer.model(torch.zeros(1, 64, 96, 3))[0].shape == (1, 32, 48, 1)
