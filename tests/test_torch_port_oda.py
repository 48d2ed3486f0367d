"""The port's ODA family against the JAX package's, in f32 on the CPU.

- ``ODASwinEncoder`` with the tiny Swin of ``tests/test_oda.py`` (embed 8,
  depths (1, 1, 2, 1)): at 384x384 with the 384-multiple resize on (stage
  4 is one 12x12 window, its blocks collapse to W-MSA) and at 64x64 with
  it off (the windows shrink to 12, 8, 4 and 2 and the rel-pos tables with
  them), the four stage outputs at 1e-4 of max(1, max |JAX's|). The
  encoder built for 64x64 refuses a 128x128 call, whose stages would take
  other windows.
- The tiny ``oda_conv``, ``oda_luna`` (bilinear, and the pixel-shuffle
  variant with its gen-1 PPM and GroupNorms of 2 groups for the
  BatchNorms), ``oda_luna_cls`` (64x64, resize off) and
  ``oda_bins`` (384x384, resize on: mViT takes at least 129 patches): the
  depth through ``from_jax_variables`` at 1e-4 of the depth range, the aux
  tokens and every Luna weight at 1e-4, the cls centers and the bins'
  edges at 1e-4 of the depth range; the port's decoder weights back
  through the JAX package's own ``convert_oda_conv_decoder`` /
  ``convert_oda_luna_decoder`` to exactly the JAX decoder variables. One
  jitted JAX forward a model.
- Both adapters route each model's output alike (the cls centers, the
  bins' edges as centers); ``Predictor`` serves ``oda_luna``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.family_converters import convert_oda_conv_decoder, convert_oda_luna_decoder
from mde_tpu.models.oda import encoder as jax_encoder
from mde_tpu.models.oda.models import (ODABinsModel, ODAConvModel, ODALunaClsModel,
                                       ODALunaModel)
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu.train.step import make_adapter as jax_make_adapter
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.oda.encoder import ODASwinEncoder
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.step import make_adapter
from test_torch_port_adabins import _rel, _variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 80.0
TINY_ENC = dict(embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8))
LUNA = dict(decoder_channels=32, num_aux=8, aux_dim=16, num_heads=4)


def _images(seed, side):
    return np.random.RandomState(seed).rand(2, side, side, 3).astype(np.float32)


@pytest.mark.parametrize("side,resize", [(384, True), (64, False)],
                         ids=["384_resized", "64_not_resized"])
def test_oda_encoder_matches_jax(side, resize):
    x = _images(1, side)
    jm = jax_encoder.ODASwinEncoder(resize_to_multiple=resize, encoder_kwargs=TINY_ENC)
    variables = _variables(jm, jnp.asarray(x), seed=2)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    port = ODASwinEncoder(resize_to_multiple=resize, input_size=(side, side),
                          encoder_kwargs=TINY_ENC).eval()
    state = from_jax_variables({k: {"encoder": v} for k, v in variables.items()})
    port.load_state_dict({n[len("encoder."):]: v for n, v in state.items()})
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape and _rel(o, r) <= TOL
    windows = [stage.blocks[0].window_size for stage in port.backbone.layers]
    assert windows == ([12] * 4 if resize else [12, 8, 4, 2])
    # stage 4 collapses: its odd block runs unshifted, with the full window
    assert port.backbone.layers[3].blocks[-1].window(*out[3].shape[1:3]) == (windows[3], 0)
    if not resize:
        with pytest.raises(ValueError, match="built for window"), torch.no_grad():
            port(torch.zeros(1, 2 * side, 2 * side, 3))


# name -> (the config, the JAX model, the image side, whether the input is
# resized, the JAX package's converter of the decoder)
MODELS = {
    "oda_conv": (dict(decoder_channels=32), ODAConvModel, 64, False, convert_oda_conv_decoder),
    "oda_luna": (LUNA, ODALunaModel, 64, False, convert_oda_luna_decoder),
    "oda_luna_rp_gn": (dict(LUNA, use_rp=True, use_gn=True, num_groups=2), ODALunaModel, 64,
                       False, functools.partial(convert_oda_luna_decoder, use_rp=True,
                                                use_gn=True)),
    "oda_luna_cls": (dict(LUNA, num_bins=8), ODALunaClsModel, 64, False,
                     convert_oda_luna_decoder),
    "oda_bins": (dict(decoder_channels=32, num_bins=8), ODABinsModel, 384, True,
                 convert_oda_conv_decoder),
}


def _registered(name):
    return "oda_luna" if name == "oda_luna_rp_gn" else name


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    """(variables, images, the jitted eval forward's output) of a tiny JAX
    model."""
    cfg, cls, side, resize, _ = MODELS[name]
    jm = cls.build(cfg, 0.001, MAX_DEPTH, resize_to_multiple=resize, encoder_kwargs=TINY_ENC)
    x = _images(5, side)
    variables = _variables(jm, jnp.asarray(x), seed=6)
    return variables, x, jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                             jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def _port(name):
    cfg, _, side, resize, _ = MODELS[name]
    port = build_model(dict(cfg, name=_registered(name)), 0.001, MAX_DEPTH, device="cpu",
                       resize_to_multiple=resize, img_size=(side, side),
                       encoder_kwargs=TINY_ENC)
    port.load_state_dict(from_jax_variables(_jax_forward(name)[0]))
    return port


@pytest.mark.parametrize("name", list(MODELS))
def test_oda_model_matches_jax_both_ways(name):
    variables, x, ref = _jax_forward(name)
    port = _port(name)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref)
    side = MODELS[name][2]
    assert out[0].shape == ref[0].shape == (2, side // 2, side // 2, 1)
    span = MAX_DEPTH - 0.001
    assert _rel(out[0], ref[0]) <= TOL * span
    if name == "oda_conv":
        assert out[1] is None and ref[1] is None
    elif name == "oda_bins":
        assert out[1].shape == ref[1].shape == (2, 9) and _rel(out[1], ref[1]) <= TOL * span
    else:
        assert out[1].shape == ref[1].shape == (2, LUNA["num_aux"], LUNA["aux_dim"])
        assert _rel(out[1], ref[1]) <= TOL
        if name == "oda_luna_cls":
            assert out[2].shape == ref[2].shape == (2, 8) and _rel(out[2], ref[2]) <= TOL * span
        assert len(out[-1]) == len(ref[-1]) == 8
        for a, r in zip(out[-1], ref[-1]):
            assert a.dtype == torch.float32 and tuple(a.shape) == r.shape and _rel(a, r) <= TOL

    # port -> JAX through the JAX package's own converter: exactly the
    # decoder variables the port was loaded from
    state = {k[len("decoder."):]: v.numpy() for k, v in port.state_dict().items()
             if k.startswith("decoder.")}
    back = MODELS[name][4](state)
    ref_dec = {k: v["decoder"] for k, v in variables.items()}
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref_dec))
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(back_leaves) == len(leaves)
    for path, leaf in back_leaves:
        np.testing.assert_array_equal(leaf, leaves[path], err_msg=jax.tree_util.keystr(path))

    # both adapters route the output alike: the depth, and the cls centers
    # or the bins' edges as centers
    maps, bins = make_adapter(_registered(name))(out)
    jax_maps, jax_bins = jax_make_adapter(_registered(name))(ref)
    assert len(maps) == len(jax_maps) == 1 and maps[0] is out[0]
    assert (bins is None) == (jax_bins is None) == (name not in ("oda_luna_cls", "oda_bins"))
    if bins is not None:
        assert bins.shape == jax_bins.shape and _rel(bins, jax_bins) <= TOL * span


def test_oda_luna_serves_through_predictor():
    _, x, ref = _jax_forward("oda_luna")
    pred = Predictor(_port("oda_luna")).predict(x)
    want = np.clip(np.asarray(jax_resize(ref[0], x.shape[1:3])), 0.0, None)
    assert pred.shape == (2, 64, 64, 1)
    assert float(np.max(np.abs(pred.numpy() - want))) <= TOL * (MAX_DEPTH - 0.001)
