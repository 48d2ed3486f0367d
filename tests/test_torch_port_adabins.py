"""The port's EfficientNet and AdaBins against the JAX package's, in f32 on
the CPU.

- ``tf_same_pad`` for kernels 3 and 5, strides 1 and 2, on odd and even
  sizes: the same shapes and values.
- ``EfficientNetFeatures`` at ``TINY_ENC`` (``tests/test_adabins.py``) on
  64x96 images: all 13 entries, in eval mode and in training (batch
  statistics, and the running statistics it leaves), at 1e-4 of max(1,
  max |JAX's|).
- ``TransformerEncoderLayer`` against ``TorchTransformerEncoderLayer`` and
  ``MiniViT`` against ``mViT``: the output and the gradients of a seeded
  loss with respect to the input and every parameter, at 1e-4 of max(1,
  max |JAX's|); in eval mode and in training with dropout 0.1 (mViT's
  output only, see ``MODULES``), the port handed the keep masks flax drew
  in an eager forward (``jax.random.bernoulli`` recorded in call order: the
  attention's one (1, 1, q, k) mask shared by every image and head, then
  each ``nn.Dropout``'s). mViT runs on a (1, 144, 240, 16) map: 9 x 15 =
  135 patches, the least it takes being 129.
- The tiny ``UnetAdaptiveBins`` (``TINY_ENC``, 16 bins, 384x384 images:
  144 patches): the prediction and the bin edges through
  ``from_jax_variables`` at 1e-4 of the depth range; the port's state
  dict at B5's depth (width 0.1) back through the JAX package's own
  ``convert_adabins_model`` to exactly the JAX variables (the converter
  takes B5's block counts); the train step's adapter turns the edges into
  centers; ``Predictor`` serves it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.checkpoint import convert_adabins_model
from mde_tpu.models import efficientnet as jax_effnet
from mde_tpu.models.adabins import model as jax_adabins
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model, efficientnet
from mde_tpu_torch.models.adabins import model as adabins
from mde_tpu_torch.ops import drop
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.step import make_adapter
from test_torch_port_flagship import _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 10.0
TINY_ENC = dict(width=0.1, depth=0.25, stem_ch=32, head_ch=256)


def _rel(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a.astype(np.float64) - b))) / max(1.0, float(np.max(np.abs(b))))


def _input(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("size", [7, 8], ids=["odd", "even"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [3, 5])
def test_tf_same_pad_matches_jax(kernel, stride, size):
    x = _input(1, 2, size, size + 3, 4)
    ours = efficientnet.tf_same_pad(torch.from_numpy(x), kernel, stride)
    ref = np.asarray(jax_effnet.tf_same_pad(jnp.asarray(x), kernel, stride))
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the output of the conv it pads has ceil(size / stride) rows
    assert (ours.shape[1] - kernel) // stride + 1 == -(-size // stride)


def _variables(model, x, seed):
    """``_random_jax_variables``, with the attention's (E, heads, hd) and
    (heads, hd, E) kernels drawn at 1 / sqrt(fan_in) as every other kernel
    (that helper takes the heads for their fan_in: logits of ~30 make each
    softmax nearly one-hot, and four such layers in a row turn f32 rounding
    into 1% of the output)."""
    def rescale(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] != "kernel" or leaf.ndim != 3:
            return leaf
        fan = (leaf.shape[0] if keys[-2] in ("query", "key", "value")
               else leaf.shape[0] * leaf.shape[1])
        return leaf * np.float32(np.sqrt(leaf.shape[-2] / fan))

    return jax.tree_util.tree_map_with_path(rescale, _random_jax_variables(model, x, seed))


def _port_state(variables, where, prefix):
    """A JAX module's variables placed at ``where`` in a model's tree
    through the converter, which must name them ``prefix`` + the module's
    own names; returns the latter."""
    def nest(tree):
        for key in reversed(where):
            tree = {key: tree}
        return tree

    # the converter tells an EfficientNet model's tree by its encoder's stem
    stem = {"encoder": {"conv_stem": {"kernel": np.zeros((3, 3, 3, 1), np.float32)}}}
    state = from_jax_variables(dict({"params": {}}, **{
        k: dict(nest(v), **(stem if k == "params" else {})) for k, v in variables.items()}))
    state = {n: v for n, v in state.items() if not n.startswith("encoder.")}
    assert state and all(name.startswith(prefix) for name in state)
    return {name[len(prefix):]: value for name, value in state.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_efficientnet_features_match_jax(train):
    x = np.random.RandomState(2).rand(2, 64, 96, 3).astype(np.float32)
    jm = jax_effnet.EfficientNetFeatures(**TINY_ENC)
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=3)
    apply = jax.jit(lambda v, a: jm.apply(v, a, train=train,
                                          mutable=["batch_stats"] if train else False))
    ref = apply(variables, jnp.asarray(x))
    ref, new_stats = ref if train else (ref, None)
    def port_state(variables):  # the encoder's names in a model, less ``encoder.``
        state = from_jax_variables({k: {"encoder": v} for k, v in variables.items()})
        return {name[len("encoder."):]: value for name, value in state.items()}

    port = efficientnet.EfficientNetEncoder(**TINY_ENC).train(train)
    port.load_state_dict(port_state(variables))
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    assert len(ours) == len(ref) == 13
    assert port.channels == [r.shape[-1] for r in ref]
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert tuple(o.shape) == r.shape and _rel(o, r) <= TOL, i
    if train:
        want = port_state(dict(variables, **new_stats))
        state = port.state_dict()
        for name in want:
            if name.endswith(("running_mean", "running_var")):
                assert _rel(state[name], want[name].numpy()) <= TOL, name


def _flax_masks(monkeypatch):
    """Record every keep mask ``jax.random.bernoulli`` draws (flax's
    ``nn.Dropout`` and the attention's broadcast dropout), in call order."""
    masks = []
    real = jax.random.bernoulli

    def bernoulli(*args, **kwargs):
        keep = real(*args, **kwargs)
        masks.append(torch.from_numpy(np.asarray(keep)))
        return keep

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return masks


def _hand_masks(monkeypatch, masks):
    """The port's dropouts take ``masks`` in order; returns the iterator."""
    handed = iter(masks)

    def keep_mask(shape, *args):
        mask = next(handed)
        assert tuple(mask.shape) == tuple(shape)
        return mask

    monkeypatch.setattr(drop, "_keep_mask", keep_mask)
    return handed


# kind -> (the JAX module, the port module (dropout 0.1 in both), the input's
# shape, the output shapes, where it sits in AdaBins' tree and its port names
# there, the masks flax draws in training: an attention's one and three
# dropouts a layer; whether the gradients are compared in training too).
# mViT's four FFs hold 135 x 1024 ReLU units each: in training one of them
# sat within f32 rounding of 0 (+-5e-7 at a scale of 4.6) with its sign
# opposite in the two frameworks, which moves that unit's bias gradient by
# its whole value, 7% of the tensor's largest. Its training gradients are
# held by the layer's case (128 units) and by the train step's test.
MODULES = {
    "TransformerEncoderLayer": (
        lambda: jax_adabins.TorchTransformerEncoderLayer(num_heads=4, ff_dim=64, drop=0.1),
        lambda: adabins.TransformerEncoderLayer(32, 4, ff_dim=64, drop_prob=0.1),
        (2, 10, 32), [(2, 10, 32)],
        ("adaptive_bins_layer", "patch_transformer", "layer0"),
        "adaptive_bins_layer.patch_transformer.transformer_encoder.layers.0.", 4, True),
    "MiniViT": (
        lambda: jax_adabins.mViT(dim_out=8), lambda: adabins.MiniViT(16, 8, drop_prob=0.1),
        (1, 144, 240, 16), [(1, 8), (1, 144, 240, 128)], ("adaptive_bins_layer",),
        "adaptive_bins_layer.", 16, False),
}


def check_module(monkeypatch, train, make_jax, make_port, in_shape, out_shapes, where, prefix,
                 count, grads=True):
    """A JAX module and its port (the port loaded through the converter's
    names for ``where``): the outputs and, unless ``train`` and not
    ``grads``, the gradients of a seeded loss with respect to the input and
    every parameter at ``TOL`` of max(1, max |JAX's|); in ``train`` the port
    handed the ``count`` keep masks flax drew in an eager forward."""
    x = _input(1, *in_shape)
    gs = [_input(10 + i, *s) for i, s in enumerate(out_shapes)]
    jm = make_jax()
    variables = _variables(jm, jnp.asarray(x), seed=3)

    def apply(v, a):
        out = jm.apply(v, a, train=train, rngs={"dropout": jax.random.PRNGKey(4)})
        return tuple(out) if len(out_shapes) == 2 else out

    if train:  # eager, so that the masks flax draws are recorded
        masks = _flax_masks(monkeypatch)
        ref, vjp = jax.vjp(apply, variables, jnp.asarray(x))
        monkeypatch.undo()
    else:
        masks, (ref, vjp) = [], jax.vjp(jax.jit(apply), variables, jnp.asarray(x))
    assert len(masks) == (count if train else 0)
    mod = make_port().train(train)
    mod.load_state_dict(_port_state(variables, where, prefix))
    handed = _hand_masks(monkeypatch, masks)
    t = torch.from_numpy(x).requires_grad_()
    out = mod(t)
    assert next(handed, None) is None
    outs, refs = (out, ref) if len(out_shapes) == 2 else ((out,), (ref,))
    for o, r, shape in zip(outs, refs, out_shapes):
        assert tuple(o.shape) == r.shape == shape and _rel(o, r) <= TOL
    if train and not grads:
        return
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs])
    dvars, dx = vjp(tuple(jnp.asarray(g) for g in gs) if len(gs) == 2 else jnp.asarray(gs[0]))
    assert _rel(t.grad, dx) <= TOL
    grads = _port_state({"params": dvars["params"]}, where, prefix)
    params = dict(mod.named_parameters())
    assert set(grads) == set(params)
    for name, p in params.items():
        assert _rel(p.grad, grads[name].numpy()) <= TOL, name


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_dropout"])
@pytest.mark.parametrize("kind", list(MODULES))
def test_adabins_module_matches_jax(kind, train, monkeypatch):
    check_module(monkeypatch, train, *MODULES[kind])


def test_mvit_needs_129_patches():
    """Tokens 1..128 are mViT's queries: 128 patches are one too few."""
    with pytest.raises(ValueError, match="at least 129"):
        adabins.MiniViT(4, 8)(torch.zeros(1, 128, 256, 4))


@functools.lru_cache(maxsize=None)
def _tiny_adabins():
    """The tiny JAX model, its seeded variables, two 384x384 images and its
    jitted eval forward on them."""
    jm = jax_adabins.UnetAdaptiveBins(n_bins=16, min_val=0.001, max_val=MAX_DEPTH,
                                      encoder_kwargs=TINY_ENC)
    x = np.random.RandomState(5).rand(2, 384, 384, 3).astype(np.float32)
    variables = _variables(jm, jnp.asarray(x), seed=6)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    return variables, x, ref


def test_adabins_matches_jax_both_ways():
    variables, x, (ref, ref_edges) = _tiny_adabins()
    cfg = {"name": "adabins", "num_bins": 16}
    port = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", encoder_kwargs=TINY_ENC)
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out, edges = port(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 192, 192, 1) and edges.shape == ref_edges.shape == (2, 17)
    # in units of the depth range
    assert _rel(out, ref) <= TOL * (MAX_DEPTH - 0.001)
    assert _rel(edges, ref_edges) <= TOL * (MAX_DEPTH - 0.001)
    assert torch.all(edges[:, 1:] > edges[:, :-1]) and torch.allclose(
        edges[:, 0], torch.tensor(0.001))

    # port -> JAX through the JAX package's own converter, which takes B5's
    # block counts: a B5-deep encoder at width 0.1 (shapes traced, no forward)
    deep = dict(TINY_ENC, depth=2.2)
    jm = jax_adabins.UnetAdaptiveBins(n_bins=16, min_val=0.001, max_val=MAX_DEPTH,
                                      encoder_kwargs=deep)
    want = _variables(jm, jnp.asarray(x[:1]), seed=7)
    port = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", encoder_kwargs=deep)
    port.load_state_dict(from_jax_variables(want))
    back = convert_adabins_model({k: v.numpy() for k, v in port.state_dict().items()})
    leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(back_leaves) == len(leaves)
    for path, leaf in back_leaves:
        np.testing.assert_array_equal(leaf, leaves[path], err_msg=jax.tree_util.keystr(path))


def test_adabins_adapter_and_predictor():
    """The train step's adapter hands the chamfer loss the bin centers
    (AdaBins emits edges); ``Predictor`` serves the map resized to the
    input with align corners, clipped at 0."""
    variables, x, (ref, _) = _tiny_adabins()
    port = build_model({"name": "adabins", "num_bins": 16}, 0.001, MAX_DEPTH, device="cpu",
                       encoder_kwargs=TINY_ENC)
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out, edges = port(torch.from_numpy(x))
    maps, centers = make_adapter("adabins")((out, edges))
    assert len(maps) == 1 and maps[0] is out
    assert torch.equal(centers, 0.5 * (edges[:, 1:] + edges[:, :-1]))
    pred = Predictor(port).predict(x)
    want = np.clip(np.asarray(jax_resize(ref, x.shape[1:3])), 0.0, None)
    assert pred.shape == (2, 384, 384, 1)
    assert float(np.max(np.abs(pred.numpy() - want))) <= TOL * (MAX_DEPTH - 0.001)
