"""The port's three ordered ODA2 siblings against the JAX package's, in f32
on the CPU: ``oda2_red_order_reg`` (2 repeats), ``oda2_red_order_cls`` and
``oda2_red_order_swin`` (1 repeat each), tiny (the custom Swin of
``tests/test_oda2_siblings.py``, dec_dim 32, 4 heads, num_emb 16,
reduction ratio 4 or window 4, 64x64 images).

Each model's weights are seeded JAX variables, carried into the port by
``from_jax_variables``. Every map of ``outs`` agrees at 1e-4 of the depth
range; the reg and gen-1 heads' index maps are compared too, so that a
bucket rounded the other way is reported as such. The port's decoder
weights go back through the JAX package's own converter
(``convert_oda2_red_order_decoder``, with ``cls_head`` for the cls model;
``convert_oda2_red_order_swin_decoder``) to exactly the JAX decoder
variables. ``Predictor.predict`` matches JAX's forward resized to the
input and clipped at 0. One jitted JAX forward a model serves its cases.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mde_tpu_torch.models.oda2.red_order_reg as port_reg
from mde_tpu.core.family_converters import (convert_oda2_red_order_decoder,
                                            convert_oda2_red_order_swin_decoder)
from mde_tpu.models.oda2 import red_luna as jax_red_luna
from mde_tpu.models.oda2 import red_order_reg as jax_reg
from mde_tpu.models.oda2 import red_order_swin as jax_swin
from mde_tpu.ops import reduction as jax_reduction
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.step import default_adapter
from test_torch_port_flagship import _random_jax_variables
from test_torch_port_oda2_red import MAX_DEPTH, MODEL_KW
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4

# name -> (the tiny config, the JAX head class that quantises or None, the
# port module whose _logit_to_indices the head calls, the converter)
MODELS = {
    "oda2_red_order_reg": (
        dict(num_repeats=2, reduction_ratio=4), jax_reg.OrderedReductionRegHead, port_reg,
        lambda state: convert_oda2_red_order_decoder(state, num_repeats=2)),
    "oda2_red_order_cls": (
        dict(num_repeats=1, reduction_ratio=4), None, None,
        lambda state: convert_oda2_red_order_decoder(state, num_repeats=1, cls_head=True)),
    "oda2_red_order_swin": (
        dict(num_repeats=1, window_size=4), jax_swin.Gen1OrderedSwinHead, port_reg,
        lambda state: convert_oda2_red_order_swin_decoder(state, num_repeats=1)),
}


def _cfg(name):
    return dict(MODELS[name][0], name=name, encoder_type="custom", dec_dim=32, num_heads=4,
                num_emb=16)


def _jax_model(name):
    build = (jax_swin.ODA2OrderedSwinModel.build if name == "oda2_red_order_swin"
             else jax_reg.ODA2OrderedRegModel.build)
    kw = dict(cls_head=True) if name == "oda2_red_order_cls" else {}
    return build(_cfg(name), 0.001, MAX_DEPTH, **MODEL_KW, **kw)


def _images(seed):
    return np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """name -> (variables, outs, index maps) of one jitted JAX forward."""
    runs = {}
    for i, name in enumerate(MODELS):
        jm, head = _jax_model(name), MODELS[name][1]
        x = jnp.asarray(_images(i))
        variables = _random_jax_variables(jm, x, seed=10 + i)
        seen = []
        with pytest.MonkeyPatch.context() as mp:
            if head is not None:
                real = head._logit_to_indices

                def record(self, logit, real=real):
                    seen.append(real(self, logit))
                    return seen[-1]
                mp.setattr(head, "_logit_to_indices", record)

            def forward(v, a):
                seen.clear()
                _, outs, attns = jm.apply(v, a, train=False)
                assert all(w is None for w in attns)
                return outs, list(seen)
            outs, idx = jax.jit(forward)(variables, x)
        runs[name] = (variables, outs, idx)
    return runs


@pytest.mark.parametrize("name", list(MODELS))
def test_ordered_sibling_matches_jax_both_ways(name, jax_runs, monkeypatch):
    variables, jax_outs, jax_idx = jax_runs[name]
    cfg, head, module, convert = MODELS[name]
    port = build_model(_cfg(name), 0.001, MAX_DEPTH, device="cpu", **MODEL_KW)
    port.load_state_dict(from_jax_variables(variables))
    port_idx = []
    if module is not None:
        real = module._logit_to_indices
        monkeypatch.setattr(module, "_logit_to_indices",
                            lambda logit, e: port_idx.append(real(logit, e)) or port_idx[-1])
    x = _images(list(MODELS).index(name))
    with torch.no_grad():
        out, outs, attns = port(torch.from_numpy(x))
    assert attns == (None,) * (2 * cfg["num_repeats"])
    # the loss takes every map (mde_tpu/train/step.py:31-53)
    maps, centers = default_adapter((out, outs, attns))
    assert maps == outs and centers is None
    assert torch.equal(out, outs[-1]) and len(outs) == len(jax_outs) == cfg["num_repeats"] + 1
    flips = [int((a.numpy() != np.asarray(b)).sum()) for a, b in zip(port_idx, jax_idx)]
    assert len(port_idx) == len(jax_idx) == (cfg["num_repeats"] if head else 0)
    for i, (p, j) in enumerate(zip(outs, jax_outs)):
        assert p.shape == j.shape == (2, 16, 16, 1)
        err = float(np.max(np.abs(p.numpy().astype(np.float64) - np.asarray(j, np.float64))))
        assert err <= TOL * (MAX_DEPTH - 0.001), f"map {i}: {err}; index flips {flips}"
    assert flips == [0] * len(flips), f"index flips per repeat {flips}"

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

    # serving: the last map resized to the input with align_corners, >= 0
    pred = Predictor(port).predict(x)
    ref = np.clip(np.asarray(jax_resize(jax_outs[-1], x.shape[1:3])), 0.0, None)
    assert pred.shape == (2, 64, 64, 1)
    assert float(np.max(np.abs(pred.numpy() - ref))) <= TOL * (MAX_DEPTH - 0.001)


def test_port_init_matches_jax_init_rules():
    """The port starts what JAX's initialisers fix: the blocks' de_norm
    scale 0.1 (reg, cls), the cls head's bins (JAX's own ``_bins_init``)
    and base-1000 table, the gen-1 head's unscaled base-2000 table
    (``red_order_swin.py:153-156``); the Luna decoders' Dense, zero
    ``o_cross2`` and aux banks."""
    e, d = 16, 32
    tables = {"oda2_red_order_cls": {
        "depth_bins": np.asarray(jax_reg.OrderedReductionClsHead._bins_init(e)(None, (e,))),
        "depth_embedding": np.asarray(jax_reduction.sinusoidal_depth_embedding(e, d, 1000.0))},
        "oda2_red_order_swin": {"depth_embedding": np.asarray(
            jax_reduction.sinusoidal_depth_embedding(e, d, 2000.0) * math.sqrt(float(d)))}}
    for name in MODELS:
        state = build_model(_cfg(name), 0.001, MAX_DEPTH, device="cpu", seed=1,
                            **MODEL_KW).state_dict()
        reducer = "decoder.reducer."
        norms = [k for k in state if k.startswith(reducer) and k.endswith("de_norm.weight")]
        assert len(norms) == MODELS[name][0]["num_repeats"]
        assert all(torch.all(state[k] == (1.0 if name == "oda2_red_order_swin" else 0.1))
                   for k in norms)
        assert (reducer + "depth_embedding" in state) == (name in tables)
        for key, want in tables.get(name, {}).items():
            np.testing.assert_array_equal(state[reducer + key].numpy(),
                                          want.reshape(state[reducer + key].shape), err_msg=key)

    # the Luna decoders: every Dense truncated normal 0.02 with zero bias,
    # each gate's o_cross2 zero, the learned aux bank truncated normal
    # sqrt(1/aux_dims) (luna.py:53-58,161-163); red-Luna's fixed aux bank is
    # JAX's unscaled base-10000 table (red_luna.py:31-40)
    luna = build_model(dict(name="oda2_luna_cls", encoder_type="custom", dec_dim=32,
                            num_heads=4, num_aux=64, aux_dim=128), 0.001, MAX_DEPTH,
                       device="cpu", seed=2, **MODEL_KW)
    dense = {n: m for n, m in luna.decoder.named_modules() if isinstance(m, torch.nn.Linear)}
    assert len(dense) == 3 * 12 + 3 * 2 + 2
    for name, m in dense.items():
        assert m.bias is None or torch.all(m.bias == 0), name
        if name.endswith("o_cross2"):
            assert torch.all(m.weight == 0), name
        else:
            assert m.weight.abs().max() <= 0.04 and 0.015 < m.weight.std() < 0.025, name
    aux, std = luna.decoder.aux, math.sqrt(1.0 / 128)
    assert aux.shape == (1, 64, 128) and aux.abs().max() <= 2 * std
    assert 0.8 * std < aux.std() < std
    red = build_model(dict(name="oda2_red_luna_reg", encoder_type="custom", dec_dim=32,
                           num_heads=4, num_aux=12), 0.001, MAX_DEPTH, device="cpu", **MODEL_KW)
    assert "decoder.aux" not in red.state_dict()
    np.testing.assert_array_equal(red.decoder.aux.numpy(),
                                  np.asarray(jax_red_luna._sin_aux(12, 32)))
