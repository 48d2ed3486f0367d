"""The port's Depthformer v6, v7 and v8 against the JAX package's, in f32 on
the CPU.

- The tiny v6, v7 and v8 (the EfficientNet of ``tests/test_adabins.py``,
  hidden width 32, 8 heads, 6 aux tokens (v7: the 1/32 grid's 4), 10 bins,
  64x64 images): the depth through ``from_jax_variables`` at 1e-4 of the
  depth range, v7's and v8's bin centers at 1e-4 of the depth range, every
  Luna attention weight at 1e-4; the port's decoder weights back through
  the JAX package's own ``convert_depthformer_luna_decoder`` to exactly
  the JAX decoder variables. One jitted JAX forward a model.
- The train step's adapter gives v6's loss the depth map, where JAX's
  default adapter hands it the nine attention weights (ROADMAP Queue 3,
  J1); v7's and v8's centers reach both adapters' chamfer term alike.
- ``Predictor`` serves v8; v7 refuses an input its position embedding was
  not built for.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.family_converters import convert_depthformer_luna_decoder
from mde_tpu.models.depthformer.luna_versions import DepthformerLuna
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu.train.step import default_adapter as jax_default_adapter
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.step import make_adapter
from test_torch_port_adabins import _rel, _variables
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
MAX_DEPTH = 80.0
TINY_ENC = dict(width=0.1, depth=0.25, stem_ch=32, head_ch=256)
CFG = dict(hidden_dim=32, num_heads=8, num_bins=10, num_aux=6, img_size=(64, 64))
ATTNS = {6: 9, 7: 8, 8: 8}


@functools.lru_cache(maxsize=None)
def _jax_forward(version):
    """(variables, images, the jitted eval forward's output) of a tiny JAX
    model."""
    jm = DepthformerLuna.build(version, CFG, 0.001, MAX_DEPTH, encoder_kwargs=TINY_ENC)
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    variables = _variables(jm, jnp.asarray(x), seed=6)
    return variables, x, jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                             jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def _port(version):
    variables = _jax_forward(version)[0]
    port = build_model(dict(CFG, name=f"depthformer_v{version}"), 0.001, MAX_DEPTH,
                       device="cpu", encoder_kwargs=TINY_ENC)
    port.load_state_dict(from_jax_variables(variables))
    return port


@pytest.mark.parametrize("version", [6, 7, 8])
def test_depthformer_luna_matches_jax_both_ways(version):
    variables, x, ref = _jax_forward(version)
    port = _port(version)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref) == (2 if version == 6 else 3)
    assert out[0].shape == ref[0].shape == (2, 32, 32, 1)
    # in units of the depth range
    assert _rel(out[0], ref[0]) <= TOL * (MAX_DEPTH - 0.001)
    if version > 6:
        assert out[1].shape == ref[1].shape == (2, CFG["num_bins"])
        assert _rel(out[1], ref[1]) <= TOL * (MAX_DEPTH - 0.001)
    attn, ref_attn = out[-1], ref[-1]
    assert len(attn) == len(ref_attn) == ATTNS[version]
    for a, r in zip(attn, ref_attn):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape and _rel(a, r) <= TOL

    # port -> JAX through the JAX package's own converter: exactly the
    # decoder variables the port was loaded from
    state = {k[len("decoder."):]: v.numpy() for k, v in port.state_dict().items()
             if k.startswith("decoder.")}
    back = convert_depthformer_luna_decoder(state, version)
    ref_dec = {k: v["decoder"] for k, v in variables.items()}
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref_dec))
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(back_leaves) == len(leaves)
    for path, leaf in back_leaves:
        np.testing.assert_array_equal(leaf, leaves[path], err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("version", [6, 7, 8])
def test_depthformer_luna_adapter_routes_as_the_port_means(version):
    """JAX's default adapter takes v6's tuple of 4-D attention weights for
    the ordered heads' maps (``mde_tpu/train/step.py:38-43``) and hands the
    loss those nine; the port's gives it the depth map (J1). v7 and v8
    return (depth, centers, weights): both adapters give the loss the
    depth and the centers."""
    _, x, ref = _jax_forward(version)
    with torch.no_grad():
        out = _port(version)(torch.from_numpy(x))
    maps, bins = make_adapter(f"depthformer_v{version}")(out)
    assert len(maps) == 1 and maps[0] is out[0]
    jax_maps, jax_bins = jax_default_adapter(ref)
    if version == 6:
        assert bins is None and jax_bins is None
        assert [m.shape for m in jax_maps] == [a.shape for a in ref[1]]
        assert len(jax_maps) == 9 and all(m.ndim == 4 and m.shape[-1] != 1 for m in jax_maps)
    else:
        assert bins is out[1] and jax_bins is ref[1] and jax_maps[0] is ref[0]


def test_depthformer_v8_serves_and_v7_checks_its_input_size():
    _, x, ref = _jax_forward(8)
    pred = Predictor(_port(8)).predict(x)
    want = np.clip(np.asarray(jax_resize(ref[0], x.shape[1:3])), 0.0, None)
    assert pred.shape == (2, 64, 64, 1)
    assert float(np.max(np.abs(pred.numpy() - want))) <= TOL * (MAX_DEPTH - 0.001)
    with pytest.raises(ValueError, match="img_size"), torch.no_grad():
        _port(7)(torch.zeros(1, 96, 64, 3))
