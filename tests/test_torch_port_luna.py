"""The port's Luna blocks (``mde_tpu_torch/ops/luna.py``) against the JAX
package's, in f32 on the CPU.

``LunaBlock``, ``PreNormLunaBlock``, ``LunaHalfBlock`` and ``LunaLayer``
(pre- and post-norm), at a pixel width (16) other than the aux tokens'
(8) and the q/k width (8): every output (the aux tokens and the f32
attention weights included) and the gradients of a seeded loss with
respect to both inputs and every parameter, at 1e-4 of max(1, max |JAX's|);
in eval mode, and in training with both dropout rates at 0.1, the port
handed the keep masks flax drew in an eager forward
(``jax.random.bernoulli`` recorded in call order). The modules sit in a
Depthformer decoder's tree for the converter's names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.ops import luna as jax_luna
from mde_tpu_torch.ops import luna
from test_torch_port_adabins import (_flax_masks, _hand_masks, _input, _port_state, _rel,
                                     _variables)
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
RATES = dict(attn_drop_prob=0.1, drop_prob=0.1)
HIDDEN, MAP, AUX = (2, 12, 16), (2, 3, 4, 16), (2, 5, 8)
BLOCK_OUT = [HIDDEN, AUX, (2, 2, 5, 12), (2, 2, 12, 5)]
LAYER_OUT = [MAP, AUX, (2, 2, 5, 12), (2, 2, 12, 5)]
# kind -> (the JAX module, the port module (dropout 0.1 in both), the
# inputs' shapes, the outputs' shapes, where it sits in a Depthformer
# decoder's tree and its port names there, the masks flax draws in training)
MODULES = {
    "LunaBlock": (
        lambda: jax_luna.LunaBlock(qk_proj_dim=8, num_heads=2, **RATES),
        lambda: luna.LunaBlock(16, 8, 8, 2, **RATES), [HIDDEN, AUX], BLOCK_OUT,
        ("decoder", "luna0", "luna_attn"), "decoder.luna_layers.0.luna_attn.", 4),
    "PreNormLunaBlock": (
        lambda: jax_luna.PreNormLunaBlock(qk_proj_dim=8, num_heads=2, **RATES),
        lambda: luna.PreNormLunaBlock(16, 8, 8, 2, **RATES), [HIDDEN, AUX], BLOCK_OUT,
        ("decoder", "luna1", "luna_attn"), "decoder.luna_layers.1.luna_attn.", 4),
    "LunaHalfBlock": (
        lambda: jax_luna.LunaHalfBlock(qk_proj_dim=8, num_heads=2, **RATES),
        lambda: luna.LunaHalfBlock(16, 8, 8, 2, **RATES), [MAP, AUX], [AUX, (2, 2, 5, 12)],
        ("decoder", "luna_final"), "decoder.luna_final.", 2),
    "LunaLayer-post_norm": (
        lambda: jax_luna.LunaLayer(qk_proj_dim=8, num_heads=2, feedforward_dim=24, **RATES),
        lambda: luna.LunaLayer(16, 8, 8, 2, feedforward_dim=24, **RATES), [MAP, AUX],
        LAYER_OUT, ("decoder", "luna2"), "decoder.luna_layers.2.", 6),
    "LunaLayer-pre_norm": (
        lambda: jax_luna.LunaLayer(qk_proj_dim=8, num_heads=2, pre_norm=True, **RATES),
        lambda: luna.LunaLayer(16, 8, 8, 2, pre_norm=True, **RATES), [MAP, AUX], LAYER_OUT,
        ("decoder", "luna3"), "decoder.luna_layers.3.", 6),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_dropout"])
@pytest.mark.parametrize("kind", list(MODULES))
def test_luna_module_matches_jax(kind, train, monkeypatch):
    make_jax, make_port, in_shapes, out_shapes, where, prefix, count = MODULES[kind]
    xs = [_input(1 + i, *s) for i, s in enumerate(in_shapes)]
    gs = [_input(10 + i, *s) for i, s in enumerate(out_shapes)]
    jm = make_jax()
    init = type("Init", (), {"init": staticmethod(
        lambda key, x, train: jm.init(key, *(jnp.asarray(a) for a in xs), train=train))})
    variables = _variables(init, jnp.asarray(xs[0]), seed=3)

    def apply(v, *a):
        return tuple(jm.apply(v, *a, train=train, rngs={"dropout": jax.random.PRNGKey(4)}))

    # eager (so that the masks flax draws in training are recorded; the
    # small modules run faster so than compiled)
    masks = _flax_masks(monkeypatch)
    ref, vjp = jax.vjp(apply, variables, *(jnp.asarray(a) for a in xs))
    monkeypatch.undo()
    assert len(masks) == (count if train else 0)
    mod = make_port().train(train)
    mod.load_state_dict(_port_state(variables, where, prefix))
    handed = _hand_masks(monkeypatch, masks)
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    out = mod(*ts)
    assert next(handed, None) is None
    assert len(out) == len(ref) == len(out_shapes)
    for o, r, shape in zip(out, ref, out_shapes):
        assert o.dtype == torch.float32
        assert tuple(o.shape) == r.shape == shape and _rel(o, r) <= TOL
    torch.autograd.backward(out, [torch.from_numpy(g) for g in gs])
    dvars, *dxs = vjp(tuple(jnp.asarray(g) for g in gs))
    for t, d in zip(ts, dxs):
        assert _rel(t.grad, d) <= TOL
    grads = _port_state({"params": dvars["params"]}, where, prefix)
    params = dict(mod.named_parameters())
    assert set(grads) == set(params)
    for name, p in params.items():
        assert _rel(p.grad, grads[name].numpy()) <= TOL, name


def test_luna_scale_ignores_the_qk_width():
    """The logits are scaled by (hidden_dim // heads)^-0.5 whatever
    ``qk_proj_dim`` is, as the reference's (``mde_tpu/ops/luna.py:8-9``)."""
    assert luna.LunaBlock(16, 8, 8, 2).scale == (16 // 2) ** -0.5
    with pytest.raises(ValueError, match="heads"):
        luna.LunaBlock(16, 8, 6, 4)
