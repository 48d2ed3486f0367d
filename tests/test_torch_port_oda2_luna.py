"""The port's ODA2 Luna half against the JAX package's, in f32 on the CPU.

- ``ODA2LunaLayer``, ``ODA2LunaGating`` (its ``o_cross2`` seeded nonzero,
  so that the gate is not sigmoid(0) everywhere) and red-Luna's
  ``SplitLuna`` S1 and S2: the output and the gradients of a seeded loss
  with respect to the inputs and every parameter, at 1e-4 of max(1, max
  |JAX's|); in eval mode, and in training with both dropout rates at 0.1,
  the port's dropout handed the keep masks flax drew, in call order.
- The tiny ``oda2_luna_reg``, ``oda2_luna_cls`` and ``oda2_red_luna_reg``
  (the custom Swin of ``tests/test_oda2_luna.py``, 64x64 images): the
  forward through ``from_jax_variables`` at 1e-4 of the depth range (the
  cls bin centers and red-Luna's attention weights too), and the port's
  decoder weights back through the JAX package's own
  ``convert_oda2_luna_decoder`` / ``convert_oda2_red_luna_decoder`` to
  exactly the JAX decoder variables. One jitted JAX forward a model.
- The train step's adapter gives red-Luna's loss its depth map, not its
  attention weights; ``Predictor`` serves it.
"""

import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.family_converters import (convert_oda2_luna_decoder,
                                            convert_oda2_red_luna_decoder)
from mde_tpu.models.oda2 import luna as jax_luna
from mde_tpu.models.oda2 import red_luna as jax_red_luna
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.oda2 import luna, red_luna
from mde_tpu_torch.ops import drop
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.step import default_adapter, make_adapter
from test_torch_port_flagship import _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 80.0
# the tiny models of tests/test_oda2_luna.py and tests/test_oda2_red_luna_ksa.py
TINY_ENC = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4)
MODEL_KW = dict(resize_to_multiple=False, encoder_kwargs=TINY_ENC, use_checkpoint=False)
LUNA = dict(encoder_type="custom", dec_dim=32, num_aux=8, aux_dim=16, num_heads=4)
RED_LUNA = dict(encoder_type="custom", dec_dim=32, num_aux=6, num_heads=4, num_layers=2)


def _rel(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a.astype(np.float64) - b))) / max(1.0, float(np.max(np.abs(b))))


def _input(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_state(variables, where, prefix):
    """A JAX module's variables placed at ``where`` in a Luna decoder's
    tree through the converter, which must name them ``prefix`` + the
    module's own names; returns the latter."""
    def nest(tree):
        for key in reversed(where):
            tree = {key: tree}
        return tree

    state = from_jax_variables(dict({"params": {}}, **{k: nest(v) for k, v in
                                                        variables.items()}))
    assert state and all(name.startswith(prefix) for name in state)
    return {name[len(prefix):]: value for name, value in state.items()}


X, AUX = (2, 6, 10, 12), (2, 5, 16)
# kind -> (the JAX module, the port module at the given rates, the inputs'
# shapes, the outputs' shapes, where the module sits in a decoder's tree and
# its port names there, the masks flax draws at both rates: the layer's three
# attentions, its self and cross-1 projections and its FF's two; S1 and S2
# their attention and projection)
MODULES = {
    "ODA2LunaLayer": (
        lambda rates: jax_luna.ODA2LunaLayer(out_dims=8, num_heads=4, **rates),
        lambda rates: luna.ODA2LunaLayer(12, 16, 8, 4, **rates), [X, AUX], [AUX, (2, 6, 10, 8)],
        ("decoder", "block16_gate", "luna"), "decoder.block16_gate.luna.", 7),
    "ODA2LunaGating": (
        lambda rates: jax_luna.ODA2LunaGating(out_channels=8, num_heads=4, **rates),
        lambda rates: luna.ODA2LunaGating(12, 8, 16, 4, **rates), [X, AUX], [(2, 6, 10, 8), AUX],
        ("decoder", "block16_gate"), "decoder.block16_gate.", 7),
    "SplitLuna-S1": (
        lambda rates: jax_red_luna._SplitLuna(num_heads=4, s2=False, **rates),
        lambda rates: red_luna.SplitLuna(16, 4, False, **rates), [(2, 6, 10, 16), AUX], [AUX],
        ("decoder", "luna", "layers0_luna1"), "decoder.luna.layers.0.luna1.", 2),
    "SplitLuna-S2": (
        lambda rates: jax_red_luna._SplitLuna(num_heads=4, s2=True, **rates),
        lambda rates: red_luna.SplitLuna(16, 4, True, **rates), [(2, 6, 10, 16), AUX],
        [(2, 6, 10, 16)], ("decoder", "luna", "layers0_luna2"), "decoder.luna.layers.0.luna2.",
        2),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_dropout"])
@pytest.mark.parametrize("kind", list(MODULES))
def test_luna_module_matches_jax(kind, train, monkeypatch):
    make_jax, make_port, in_shapes, out_shapes, where, prefix, count = MODULES[kind]
    rates = dict(attn_drop_prob=0.1, drop_prob=0.1) if train else {}
    xs = [_input(1 + i, *s) for i, s in enumerate(in_shapes)]
    gs = [_input(10 + i, *s) for i, s in enumerate(out_shapes)]
    jm = make_jax(rates)
    init = types.SimpleNamespace(init=lambda key, x, train: jm.init(
        key, *(jnp.asarray(a) for a in xs), train=train))
    variables = _random_jax_variables(init, jnp.asarray(xs[0]), seed=3)
    if kind.startswith("ODA2"):  # seeded: the gate is not sigmoid(0) = 0.5
        layer = variables["params"].get("luna", variables["params"])
        assert np.abs(np.asarray(layer["o_cross2"]["kernel"])).min() > 0
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__"
                and context.module.rate > 0 and not context.module.deterministic):
            masks.append(torch.from_numpy(np.asarray(out) != 0))
        return out

    def apply(v, *a):
        out = jm.apply(v, *a, train=train, rngs={"dropout": jax.random.PRNGKey(4)},
                       mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        # the gate and the layer return two tensors, S1 and S2 one and the
        # attention weights
        return tuple(out) if len(out_shapes) == 2 else out[0]

    # the masks of an eager forward (jitted, the same key draws the same bits)
    if train:
        with flax_nn.intercept_methods(interceptor):
            apply(variables, *(jnp.asarray(a) for a in xs))
    ref, vjp = jax.vjp(jax.jit(apply), variables, *(jnp.asarray(a) for a in xs))
    assert len(masks) == (count if train else 0)
    mod = make_port(rates).train(train)
    mod.load_state_dict(_port_state(variables, where, prefix))
    handed = iter(masks)
    monkeypatch.setattr(drop, "_keep_mask", lambda shape, *a: next(handed))
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    out = mod(*ts)
    assert next(handed, None) is None
    outs, refs = (out, ref) if len(out_shapes) == 2 else ((out[0],), (ref,))
    for o, r, shape in zip(outs, refs, out_shapes):
        assert tuple(o.shape) == r.shape == shape and _rel(o, r) <= TOL
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs])
    dvars, *dxs = vjp(tuple(jnp.asarray(g) for g in gs) if len(gs) == 2
                      else jnp.asarray(gs[0]))
    for t, d in zip(ts, dxs):
        assert _rel(t.grad, d) <= TOL
    grads = _port_state({"params": dvars["params"]}, where, prefix)
    params = dict(mod.named_parameters())
    assert set(grads) == set(params)
    for name, p in params.items():
        assert _rel(p.grad, grads[name].numpy()) <= TOL, name


def _jax_model(name):
    if name == "oda2_red_luna_reg":
        return jax_red_luna.ODA2RedLunaRegModel.build(RED_LUNA, 0.001, MAX_DEPTH, **MODEL_KW)
    return jax_luna.ODA2LunaModel.build(LUNA, 0.001, MAX_DEPTH,
                                        cls_head=name == "oda2_luna_cls", **MODEL_KW)


# name -> (the config, the converter, the map's shape)
MODELS = {
    "oda2_luna_reg": (LUNA, lambda state: convert_oda2_luna_decoder(state), (2, 16, 16, 1)),
    "oda2_luna_cls": (LUNA, lambda state: convert_oda2_luna_decoder(state, cls_head=True),
                      (2, 16, 16, 1)),
    "oda2_red_luna_reg": (RED_LUNA, lambda state: convert_oda2_red_luna_decoder(
        state, num_layers=RED_LUNA["num_layers"]), (2, 14, 14, 1)),
}


def _images(seed):
    return np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("name", list(MODELS))
def test_luna_model_matches_jax_both_ways(name):
    cfg, convert, shape = MODELS[name]
    x = _images(5)
    jm = _jax_model(name)
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=6)
    ref, ref_second = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                           jnp.asarray(x))
    port = build_model(dict(cfg, name=name), 0.001, MAX_DEPTH, device="cpu", **MODEL_KW)
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out, second = port(torch.from_numpy(x))
    assert out.shape == ref.shape == shape
    # in units of the depth range
    assert _rel(out, ref) <= TOL * (MAX_DEPTH - 0.001)
    if name == "oda2_luna_reg":
        assert second is None and ref_second is None
    elif name == "oda2_luna_cls":
        assert second.shape == ref_second.shape == (2, LUNA["num_aux"])
        assert _rel(second, ref_second) <= TOL * (MAX_DEPTH - 0.001)
        assert torch.all(second[:, 1:] > second[:, :-1])
    else:
        hw, s = 16 * 16, RED_LUNA["num_aux"]
        assert [tuple(a.shape) for a in second] == [(2, 4, s, hw), (2, 4, hw, s)] * 2
        assert all(a.dtype == torch.float32 and _rel(a, b) <= TOL
                   for a, b in zip(second, ref_second))

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

    # the loss takes the depth map, and the cls centers
    maps, centers = make_adapter(name)((out, second))
    assert len(maps) == 1 and maps[0] is out
    assert centers is (second if name == "oda2_luna_cls" else None)
    if name == "oda2_red_luna_reg":
        # serving: the map resized to the input with align_corners, >= 0
        pred = Predictor(port).predict(x)
        want = np.clip(np.asarray(jax_resize(ref, x.shape[1:3])), 0.0, None)
        assert pred.shape == (2, 64, 64, 1)
        assert float(np.max(np.abs(pred.numpy() - want))) <= TOL * (MAX_DEPTH - 0.001)


def test_red_luna_adapter_gives_the_loss_the_prediction():
    """JAX's adapter takes any tuple of 4-D tensors in a model's second
    slot as the ordered heads' maps (``mde_tpu/train/step.py:38-43``), so
    it hands red-Luna's attention weights to the loss; the port's takes
    only (B, h, w, 1) maps there and gives the loss the prediction."""
    out = torch.rand(1, 14, 14, 1)
    attns = (torch.rand(1, 4, 6, 256), torch.rand(1, 4, 256, 6))
    assert default_adapter((out, attns)) == ((out,), None)
    maps = (torch.rand(1, 16, 16, 1), torch.rand(1, 16, 16, 1))
    assert default_adapter((out, maps, (None, None))) == (maps, None)
