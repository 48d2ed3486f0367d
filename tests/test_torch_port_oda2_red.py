"""The port's ODA2 reduction pieces and two of the sibling models against
the JAX package's, in f32 on the CPU.

- ``block_mean`` (on integer-valued maps, whose block sums are exact in
  both frameworks) and ``sinusoidal_depth_embedding`` (bases 2000 and
  1000): equal bit for bit.
- ``PreNormOrderedReductionSA`` and ``PreNormReductionSA``, shift 0 and
  shift > 0: the output and the gradients of a seeded loss with respect to
  the input and every parameter, at 1e-4 of max(1, max |JAX's|).
- ``PreNormFF`` and ``PreNormDWConvFF`` in training with ``drop_prob`` 0.2,
  and the attentions below with their dropouts: the port's dropout is
  handed the keep masks flax drew (flax's ``nn.Dropout`` calls are
  intercepted), so the outputs compare at 1e-4.
- The tiny ``oda2_red_reg`` and ``oda2_conv`` (the custom Swin of
  ``tests/test_oda2_siblings.py``, dec_dim 32, 64x64 images): the forward
  through ``from_jax_variables`` at 1e-4 of the depth range, and the port's
  decoder weights back through the JAX package's own
  ``convert_oda2_red_decoder`` / ``convert_oda2_conv_decoder`` to exactly
  the JAX decoder variables. One jitted JAX forward a model.
- The attentions and blocks that drop in training (the reduction SAs, the
  ordered window SA with and without its table, the W-MSA, the KSA kernel
  attention and block, the CRF block) under flax's dropout masks.
- ``build_model`` of every sibling and Luna name runs on the card unless
  asked, and carries ``bn_momentum`` into every BatchNorm (``oda2_ksa_reg``'s
  too); each tiny sibling trains two steps through ``Trainer.fit`` (port
  only).
"""

import os
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.family_converters import convert_oda2_conv_decoder, convert_oda2_red_decoder
from mde_tpu.models.oda2 import red_order_swin2 as jax_flagship
from mde_tpu.models.oda2.conv import ODA2ConvModel as JaxConvModel
from mde_tpu.models.oda2.red_reg import ODA2RedRegModel as JaxRedRegModel
from mde_tpu.models.newcrfs import layers as jax_crf
from mde_tpu.models.oda2 import ksa as jax_ksa
from mde_tpu.ops import attention as jax_attention
from mde_tpu.ops import mlp as jax_mlp
from mde_tpu.ops import ordered_attention as jax_ordered
from mde_tpu.ops import reduction as jax_reduction
from mde_tpu.ops import window as jax_window
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.core.config import load_config
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.newcrfs import layers as crf
from mde_tpu_torch.models.oda2 import ksa
from mde_tpu_torch.models.oda2 import red_order_swin2 as port_flagship
from mde_tpu_torch.ops import attention, drop, mlp, ordered_attention, reduction
from mde_tpu_torch.train import driver
from mde_tpu_torch.train.step import default_adapter
from test_driver import TINY_OPT
from test_torch_port_driver import _small_test_split
from test_torch_port_flagship import _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 80.0
TINY_ENC = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4)
MODEL_KW = dict(resize_to_multiple=False, encoder_kwargs=TINY_ENC, use_checkpoint=False)


def _rel(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a.astype(np.float64) - b))) / max(1.0, float(np.max(np.abs(b))))


def _input(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [2, 4, 8])
def test_block_mean_matches_jax(dtype, r):
    x = np.random.RandomState(r).randint(-50, 50, (2, 16, 24, 3)).astype(np.float32)
    ours = reduction.block_mean(torch.from_numpy(x).to(dtype), r)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_reduction.block_mean(jnp.asarray(x, jdt), r)
    assert ours.dtype == dtype and ours.shape == ref.shape
    assert np.array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("base,num_emb,dims", [(2000.0, 128, 512), (1000.0, 16, 32)])
def test_sinusoidal_depth_embedding_matches_jax(base, num_emb, dims):
    ours = reduction.sinusoidal_depth_embedding(num_emb, dims, base)
    ref = np.asarray(jax_reduction.sinusoidal_depth_embedding(num_emb, dims, base))
    assert ours.dtype == torch.float32 and np.array_equal(ours.numpy(), ref)


def _module_vars(module, seed, *args, **kwargs):
    """The JAX module's variables, seeded as the flagship test seeds them."""
    init = types.SimpleNamespace(init=lambda key, x, train: module.init(
        key, *(None if a is None else jnp.asarray(a) for a in args), **kwargs))
    return _random_jax_variables(init, jnp.asarray(args[0]), seed)


SA_CASES = {"ordered-shift0": ("ordered", 0), "ordered-shift2": ("ordered", 2),
            "plain-shift0": ("plain", 0), "plain-shift2": ("plain", 2)}


@pytest.mark.parametrize("case", list(SA_CASES))
def test_reduction_sa_matches_jax(case):
    """Forward and gradients (input and parameters) of both reduction SAs
    on a 2 x 8 x 12 map of 32 channels, 4 heads, reduction ratio 4."""
    kind, shift = SA_CASES[case]
    x, g = _input(1, 2, 8, 12, 32), _input(2, 2, 8, 12, 32)
    if kind == "ordered":
        jm = jax_reduction.PreNormOrderedReductionSA(num_heads=4, reduction_ratio=4,
                                                     shift_size=shift)
        mod = reduction.PreNormOrderedReductionSA(32, 4, 4, shift)
        variables = _module_vars(jm, 3, x, None)

        def apply(v, a):
            return jm.apply(v, a, None)[0]
    else:
        jm = jax_reduction.PreNormReductionSA(num_heads=4, reduction_ratio=4, shift_size=shift)
        mod = reduction.PreNormReductionSA(32, 4, 4, shift)
        variables = _module_vars(jm, 3, x)

        def apply(v, a):
            return jm.apply(v, a)[0]
    mod.load_state_dict(_port_names(variables))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt)
    ref, vjp = jax.vjp(apply, variables, jnp.asarray(x))
    assert _rel(out, ref) <= TOL
    out.backward(torch.from_numpy(g))
    dvars, dx = vjp(jnp.asarray(g))
    assert _rel(xt.grad, dx) <= TOL
    grads = _port_names(dvars)
    params = dict(mod.named_parameters())
    assert set(grads) == set(params)
    for name, p in params.items():
        assert _rel(p.grad, grads[name].numpy()) <= TOL, name


def _port_names(variables) -> dict:
    """A JAX module's variables in the port's names, through the converter:
    the module is placed as ``sa1`` of the first ordered reduction block
    (a name path the converter maps one to one) and the prefix dropped."""
    where = ("decoder", "reducer", "attn0", "sa1")

    def nest(tree):
        for key in reversed(where):
            tree = {key: tree}
        return tree

    state = from_jax_variables(dict({"params": {}}, **{k: nest(v) for k, v in
                                                        variables.items()}))
    prefix = "decoder.reducer.attn_layers.0.sa1."
    assert all(name.startswith(prefix) for name in state)
    return {name[len(prefix):]: value for name, value in state.items()}


def _intercept_dropout_masks():
    """A flax interceptor that records the keep mask of every
    ``nn.Dropout`` call that draws one (rate > 0; the mask is where its
    output is nonzero), in call order."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__"
                and context.module.rate > 0):
            masks.append(torch.from_numpy(np.asarray(out) != 0))
        return out

    return masks, interceptor


@pytest.mark.parametrize("kind", ["PreNormFF", "PreNormDWConvFF"])
def test_ff_dropout_matches_flax_with_shared_masks(kind, monkeypatch):
    """The FFs in training at drop_prob 0.2: flax draws the masks, the
    port's dropout takes them in the same order."""
    x = _input(4, 2, 6, 10, 16)
    jm = getattr(jax_mlp, kind)(drop_prob=0.2)
    variables = _module_vars(jm, 5, x, train=False)
    masks, interceptor = _intercept_dropout_masks()
    with flax_nn.intercept_methods(interceptor):
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(6)})
    assert len(masks) == (2 if kind == "PreNormFF" else 1)
    assert all(0.7 < m.float().mean() < 0.9 for m in masks)
    mod = getattr(mlp, kind)(16, drop_prob=0.2).train()
    mod.load_state_dict(_port_names(variables))
    handed = iter(masks)
    monkeypatch.setattr(drop, "_keep_mask", lambda shape, *a: next(handed))
    out = mod(torch.from_numpy(x))
    assert next(handed, None) is None
    assert _rel(out, ref) <= TOL


def _placed(where, prefix):
    """The port names of a JAX module's variables placed at ``where`` in a
    model's tree: ``from_jax_variables`` must name them ``prefix`` + the
    module's own names."""
    def names(variables):
        def nest(tree):
            for key in reversed(where):
                tree = {key: tree}
            return tree

        state = from_jax_variables(dict({"params": {}}, **{k: nest(v) for k, v in
                                                            variables.items()}))
        assert all(name.startswith(prefix) for name in state)
        return {name[len(prefix):]: value for name, value in state.items()}
    return names


def _window_mask():
    return np.array(jax_window.shifted_window_attn_mask(8, 8, 4, 2))


RATES = dict(attn_drop_prob=0.1, drop_prob=0.2)
# kind -> (the JAX module, the port module, the inputs' shapes, extra
# arguments of both calls, the port names of the JAX variables, the number
# of masks flax draws)
SA_DROP_CASES = {
    "PreNormReductionSA": (
        lambda: jax_reduction.PreNormReductionSA(num_heads=4, reduction_ratio=4, shift_size=2,
                                                 **RATES),
        lambda: reduction.PreNormReductionSA(32, 4, 4, 2, **RATES), [(2, 8, 12, 32)], (),
        _port_names, 2),
    "PreNormOrderedReductionSA": (
        lambda: jax_reduction.PreNormOrderedReductionSA(num_heads=4, reduction_ratio=4,
                                                        shift_size=2, **RATES),
        lambda: reduction.PreNormOrderedReductionSA(32, 4, 4, 2, **RATES), [(2, 8, 12, 32)],
        (None,), _port_names, 2),
    # the gen-1 SA: JAX's einsum path drops the scaled logits, then softmax
    "PreNormOrderedSwinSA": (
        lambda: jax_ordered.PreNormOrderedSwinSA(num_heads=4, num_emb=1, window_size=4,
                                                 shift_size=2, bias_type="none", **RATES),
        lambda: ordered_attention.PreNormOrderedSwinSA(32, 4, 1, 4, 2, bias_type="none",
                                                       **RATES),
        [(2, 8, 12, 32)], (np.zeros((2, 8, 12), np.int32),), _port_names, 2),
    # with the depth table: dropped logits, then the gathered bias
    "PreNormOrderedSwinSA-table": (
        lambda: jax_ordered.PreNormOrderedSwinSA(num_heads=4, num_emb=16, window_size=4,
                                                 shift_size=2, **RATES),
        lambda: ordered_attention.PreNormOrderedSwinSA(32, 4, 16, 4, 2, **RATES),
        [(2, 8, 12, 32)], (np.random.RandomState(3).randint(0, 16, (2, 8, 12)),),
        _port_names, 2),
    "WindowAttention": (
        lambda: jax_attention.WindowAttention(num_heads=4, window_size=4, **RATES),
        lambda: attention.WindowAttention(32, 4, 4, **RATES), [(8, 16, 32)], (_window_mask(),),
        _placed(("encoder", "layers0", "blocks0", "attn"), "encoder.layers.0.blocks.0.attn."),
        2),
    "KernelWindowAttention": (
        lambda: jax_ksa.KernelWindowAttention(num_heads=2, **RATES),
        lambda: ksa.KernelWindowAttention(32, 64, 2, **RATES), [(4, 16, 32), (4, 16, 64)], (),
        _placed(("decoder", "layers0_blocks0", "kernel_attn"),
                "decoder.layers.0.blocks.0.kernel_attn."), 2),
    # the kernel attention, MLP 1, the W-MSA and MLP 2, each with two masks
    "KSABlock": (
        lambda: jax_ksa.KSABlock(num_heads=2, window_size=4, shift_size=2, **RATES),
        lambda: ksa.KSABlock(16, 16, 2, 4, 2, **RATES), [(2, 8, 12, 16), (2, 8, 12, 16)], (),
        _placed(("decoder", "layers0_blocks1"), "decoder.layers.0.blocks.1."), 8),
    # the attention's probabilities and projection, and both MLP outputs
    "CRFBlock": (
        lambda: jax_crf.CRFBlock(num_heads=2, window_size=7, shift_size=3, **RATES),
        lambda: crf.CRFBlock(16, 2, 7, 3, **RATES), [(2, 9, 12, 16), (2, 9, 12, 16)], (),
        _placed(("crf0", "blocks0"), "crf0.crf_layer.blocks.0."), 4),
}


@pytest.mark.parametrize("kind", list(SA_DROP_CASES))
def test_sa_dropout_matches_flax_with_shared_masks(kind, monkeypatch):
    """The attentions and blocks in training with both dropout rates
    (attention 0.1, output 0.2): flax draws the masks, the port's dropout
    takes them in the same order. Where JAX leaves its kernel for the
    einsum path in training with attention dropout (the window SAs, the
    KSA kernel attention), so does the port."""
    make_jax, make_port, shapes, extra, names, count = SA_DROP_CASES[kind]
    xs = [_input(8 + i, *shape) for i, shape in enumerate(shapes)]
    jm = make_jax()
    variables = _module_vars(jm, 9, *xs, *extra)
    masks, interceptor = _intercept_dropout_masks()
    with flax_nn.intercept_methods(interceptor):
        ref = jm.apply(variables, *(None if a is None else jnp.asarray(a)
                                    for a in xs + list(extra)),
                       train=True, rngs={"dropout": jax.random.PRNGKey(10)})
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert len(masks) == count
    mod = make_port()
    mod.load_state_dict(names(variables))
    handed = iter(masks)
    monkeypatch.setattr(drop, "_keep_mask", lambda shape, *a: next(handed))
    out = mod.train()(*(None if a is None else torch.from_numpy(np.asarray(a))
                        for a in xs + list(extra)))
    assert next(handed, None) is None
    assert _rel(out, ref) <= TOL


def test_flagship_dropout_matches_flax_with_shared_masks(monkeypatch):
    """The flagship's ordered block in training at both rates, as the
    flagship's ``build`` now makes every one of its blocks: flax draws the
    six masks (each SA's dropped logits and projection, each FF's output),
    the port's dropout takes them in the same order, and the block's
    BatchNorms take batch statistics."""
    x = _input(11, 2, 8, 12, 32)
    idx = np.random.RandomState(12).randint(0, 16, (2, 8, 12)).astype(np.int32)
    jm = jax_flagship.OrderedSwinBlock(num_heads=4, num_emb=16, window_size=4, **RATES)
    variables = _module_vars(jm, 13, x, idx)
    masks, interceptor = _intercept_dropout_masks()
    with flax_nn.intercept_methods(interceptor):
        (ref, _), _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(idx), train=True,
                               mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(14)})
    assert len(masks) == 6
    model = build_model(dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32,
                             num_heads=4, num_repeats=2, num_emb=16, window_size=4, **RATES),
                        0.001, MAX_DEPTH, device="cpu", **MODEL_KW)
    blocks = list(model.decoder.reducer.attn_layers)
    assert all(b.sa1.attn_drop.rate == b.sa2.attn_drop.rate == 0.1 for b in blocks)
    assert all(m.drop.rate == 0.2 for b in blocks for m in (b.sa1, b.ff1, b.sa2, b.ff2))
    mod = blocks[0].train()
    mod.load_state_dict(_placed(("decoder", "reducer", "attn0"),
                                "decoder.reducer.attn_layers.0.")(variables))
    handed = iter(masks)
    monkeypatch.setattr(drop, "_keep_mask", lambda shape, *a: next(handed))
    out = mod(torch.from_numpy(x), torch.from_numpy(idx))
    assert next(handed, None) is None
    assert _rel(out, ref) <= TOL


def _jax_red_reg():
    return JaxRedRegModel(dec_dim=32, min_depth=0.001, max_depth=MAX_DEPTH, num_heads=4,
                          encoder_type="custom", **MODEL_KW)


def _jax_conv():
    return JaxConvModel(decoder_channels=32, min_depth=0.001, max_depth=MAX_DEPTH,
                        encoder_type="custom", **MODEL_KW)


MODELS = {
    "oda2_red_reg": (_jax_red_reg, dict(name="oda2_red_reg", encoder_type="custom", dec_dim=32,
                                        num_heads=4),
                     lambda state: convert_oda2_red_decoder(state), (2, 14, 14, 1)),
    "oda2_conv": (_jax_conv, dict(encoder_type="custom", dec_dim=32, name="oda2_conv"),
                  lambda state: convert_oda2_conv_decoder(state), (2, 32, 32, 1)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_sibling_model_matches_jax_both_ways(name):
    make_jax, cfg, convert, shape = MODELS[name]
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    jm = make_jax()
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=8)
    ref, ref_aux = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    port = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", **MODEL_KW)
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out, aux = port(torch.from_numpy(x))
    assert out.shape == ref.shape == shape
    if name == "oda2_conv":
        assert aux is None and ref_aux is None
    else:
        assert aux == (None,) * 4 and tuple(ref_aux) == (None,) * 4
    # the loss takes the one map, not the None attention slots
    maps, centers = default_adapter((out, aux))
    assert len(maps) == 1 and maps[0] is out and centers is None
    # in units of the depth range
    assert _rel(out, ref) <= TOL * (MAX_DEPTH - 0.001)

    # port -> JAX: the JAX package's own converter gives back exactly the
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


@pytest.mark.parametrize("name", ["oda2_red_order_reg", "oda2_red_order_cls",
                                  "oda2_red_order_swin", "oda2_red_reg", "oda2_conv",
                                  "oda2_luna_reg", "oda2_luna_cls", "oda2_red_luna_reg"])
def test_sibling_build_runs_on_the_card_unless_asked(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    cfg = {"name": name, "encoder_type": "base", "dec_dim": 512, "num_heads": 8,
           "num_repeats": 3, "num_emb": 128}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, 0.001, 80.0)


@pytest.mark.parametrize("name", ["oda2_red_order_reg", "oda2_red_order_swin", "oda2_red_reg",
                                  "oda2_conv", "oda2_ksa_reg", "oda2_luna_reg", "oda2_luna_cls",
                                  "oda2_red_luna_reg", "oda2_red_order_swin2"])
def test_sibling_bn_momentum_reaches_every_batchnorm(name):
    """A config's ``bn_momentum`` (torch's convention) reaches every
    BatchNorm of the model, as the JAX builds read it."""
    from mde_tpu_torch.ops.tnn import BatchNorm
    cfg = {"name": name, "encoder_type": "custom", "dec_dim": 32, "num_heads": 4,
           "num_repeats": 1, "num_emb": 16, "reduction_ratio": 4, "window_size": 4,
           "dec_num_heads": (1, 2, 4, 8), "num_aux": 8, "aux_dim": 16, "num_layers": 1,
           "bn_momentum": 0.05}
    model = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", **MODEL_KW)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert norms and all(m.momentum == 0.05 for m in norms)


SIBLING_NAMES = ["oda2_red_order_reg", "oda2_red_order_cls", "oda2_red_order_swin",
                 "oda2_red_reg", "oda2_conv", "oda2_luna_reg", "oda2_luna_cls",
                 "oda2_red_luna_reg"]


@pytest.mark.parametrize("name", SIBLING_NAMES)
def test_sibling_trains_through_trainer_fit(name, tmp_path, monkeypatch):
    """Two steps of the port's ``Trainer.fit`` on the CPU on
    ``tests/test_driver.py``'s ``TINY_OPT`` with the sibling's name
    (synthetic NYU, batch 4 in two microbatches, the test split cut to 16
    images of 64x64): a validation at step 2 with nine finite metrics and
    its checkpoint. On one torch thread, as the driver tests run."""
    monkeypatch.setattr(driver, "DepthDataset", _small_test_split(driver.DepthDataset))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        opt = load_config(dict(TINY_OPT, output_dir=str(tmp_path),
                               model=dict(TINY_OPT["model"], name=name, reduction_ratio=4,
                                          num_aux=8, aux_dim=16, num_layers=1),
                               train=dict(TINY_OPT["train"], valid_freq=2)))
        trainer = driver.Trainer(opt, model_overrides=MODEL_KW, device="cpu")
        metrics = trainer.fit(max_steps=2)
    finally:
        torch.set_num_threads(threads)
    assert trainer.global_step == 2
    assert len(metrics) == 9 and all(np.isfinite(v) for v in metrics.values())
    assert os.listdir(tmp_path / "checkpoints") == ["step_2"]
