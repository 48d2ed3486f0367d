"""The port's ``depthformer_v3`` and ``depthformer`` (v1) train steps against
JAX's ``make_train_step``, in f32 on the CPU.

The tiny models of ``test_torch_port_depthformer.py`` built for 64x96
(both dropout rates 0, so that no random draw differs) each take one step
from the same weights (``from_jax_variables``) on the same numpy batch of
two 64x96 images, with the flagship's loss and optimizer:

- ``depthformer_v3`` with the chamfer loss at 0.1, on the bin centers that
  both sides' adapters make of its edges;
- ``depthformer`` (v1), whose loss the port computes on its depth map.
  JAX's default adapter would take its four attention weights for maps
  (ROADMAP Queue 3, J1), so the JAX step is given JAX's own ``adapter=``
  argument with the port's routing: the prediction, no centers.

The comparison and its tolerances are ``_torch_port_train_case.py``'s:
the logs, every gradient, the BatchNorm statistics and the parameters
after AdamW.
"""

import jax.numpy as jnp
import pytest

import _torch_port_train_case as case
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_depthformer import MAX_DEPTH, MODELS, TINY_ENC
from test_torch_port_flagship import _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

DROP = dict(attn_drop_prob=0.0, drop_prob=0.0)
# name -> (JAX's adapter: None for its default, the chamfer weight)
NAMES = {"depthformer_v3": (None, 0.1), "depthformer": (lambda out: ((out[0],), None), 0.0)}


@pytest.mark.parametrize("name", list(NAMES))
def test_depthformer_train_step_matches_jax(name):
    adapter, chamfer = NAMES[name]
    cfg = dict(MODELS[name][0], img_size=(64, 96), name=name)
    opt = dict(case.make_opt(), model=cfg)
    opt["loss"] = dict(opt["loss"], chamfer_weight=chamfer)
    data = case.batch(size=2)
    model = MODELS[name][1](cfg).clone(encoder_kwargs=TINY_ENC, **DROP)
    variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=30)
    jax_grads, jax_logs, jax_stats, jax_params = case.jax_step(model, opt, variables, data,
                                                               adapter=adapter)
    assert (jax_logs.get("loss_chamfer", 0.0) > 0) == (chamfer > 0)
    port = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", encoder_kwargs=TINY_ENC, **DROP)
    port.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(port, opt, data)
    case.assert_logs(logs, jax_logs)
    if chamfer:
        assert abs(logs["loss_chamfer"] - jax_logs["loss_chamfer"]) <= (
            case.LOG_TOL * max(1.0, jax_logs["loss_chamfer"]))
    case.assert_grads(grads, jax_grads)
    case.assert_stats(port, variables["params"], jax_stats)
    case.assert_params(port, jax_params)
