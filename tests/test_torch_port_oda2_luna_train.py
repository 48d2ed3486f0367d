"""The port's ``oda2_luna_cls`` and ``oda2_red_luna_reg`` train steps against
JAX's ``make_train_step``, in f32 on the CPU.

The tiny models of ``test_torch_port_oda2_luna.py`` (dropout and stochastic
depth off, so that no random draw differs) each take one step from the
same weights (``from_jax_variables``) on the same numpy batch of two 64x96
images, with the flagship's loss and optimizer:

- ``oda2_luna_cls`` with the chamfer loss on, so that its bin centers
  reach it on both sides, at ``chamfer_weight`` 0.001 and with
  ``freeze_bn``. The chamfer gradient reaches the parameters through the
  normalised bin widths, where it largely cancels: in f32 the chamfer
  path's gradients are good to about 1e-4 of a tensor's largest (JAX's own
  jitted and eager gradients of it differ by 1.5e-4 on this model), and
  BatchNorm's batch statistics make the centers' noise ten times larger
  (2.6e-4 m against 2.7e-5). At weight 0.1 (the card's check,
  ``chip_smoke.py``) the gradients' norm came out 1.6e-4 apart with frozen
  statistics, against the logs' 1e-5; at 0.001 the chamfer term still
  moves the median tensor's gradient by 0.6% of its largest (up to 1%),
  twelve times the gradient tolerance, and the step holds. Training with batch statistics is held by the gates'
  module tests (``test_torch_port_oda2_luna.py``), red-Luna's step and
  ``Trainer.fit``.
- ``oda2_red_luna_reg``, with batch statistics, whose loss the port
  computes on its depth map. JAX's default adapter would take its
  attention weights for maps (ROADMAP Queue 3), so the JAX step is given
  JAX's own ``adapter=`` argument with the same routing: the prediction,
  no centers.

The comparison and its tolerances are ``_torch_port_train_case.py``'s:
the logs, every gradient, the BatchNorm statistics and the parameters
after AdamW.
"""

import jax.numpy as jnp
import pytest

import _torch_port_train_case as case
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_flagship import _random_jax_variables
from test_torch_port_oda2_luna import LUNA, MAX_DEPTH, RED_LUNA, TINY_ENC, _jax_model
from _torch_port_threads import one_torch_thread  # noqa: F401

# name -> (the config, JAX's adapter: None for its default, freeze_bn)
NAMES = {"oda2_luna_cls": (dict(LUNA, drop_prob=0.0), None, True),
         "oda2_red_luna_reg": (RED_LUNA, lambda out: ((out[0],), None), False)}


def _opt(name):
    opt = dict(case.make_opt(), model=dict(NAMES[name][0], name=name))
    if name == "oda2_luna_cls":
        opt["loss"] = dict(opt["loss"], chamfer_weight=0.001)
    return opt


@pytest.mark.parametrize("name", list(NAMES))
def test_luna_train_step_matches_jax(name):
    opt, data = _opt(name), case.batch(size=2)
    _, adapter, freeze_bn = NAMES[name]
    model = _jax_model(name).clone(path_drop_prob=0.0, drop_prob=0.0)
    variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=30)
    jax_grads, jax_logs, jax_stats, jax_params = case.jax_step(
        model, opt, variables, data, adapter=adapter, freeze_bn=freeze_bn)
    if name == "oda2_luna_cls":
        assert jax_logs["loss_chamfer"] > 0
    port = build_model(opt["model"], 0.001, MAX_DEPTH, device="cpu", resize_to_multiple=False,
                       encoder_kwargs=TINY_ENC, path_drop_prob=0.0, use_checkpoint=False)
    port.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(port, opt, data, freeze_bn=freeze_bn)
    case.assert_logs(logs, jax_logs)
    if name == "oda2_luna_cls":
        assert abs(logs["loss_chamfer"] - jax_logs["loss_chamfer"]) <= (
            case.LOG_TOL * max(1.0, jax_logs["loss_chamfer"]))
    case.assert_grads(grads, jax_grads)
    case.assert_stats(port, variables["params"], jax_stats)
    case.assert_params(port, jax_params)

