"""The port's ``oda2_red_order_reg`` and ``oda2_red_order_swin`` train steps
against JAX's ``make_train_step``, in f32 on the CPU.

The tiny models of ``test_torch_port_oda2_red_order.py`` (stochastic depth
off, so that no random draw differs) each take one step from the same
weights (``from_jax_variables``) on the same numpy batch of two 64x96
images, with the flagship's loss and optimizer: the reg model's backward
runs through the reduction SAs and the DWConv-GLU FFs (K3 dxdw's plain
version), the gen-1 model's through K2's bias-free backward (its plain
version). The comparison and its tolerances are
``_torch_port_train_case.py``'s: the logs, every gradient, the BatchNorm
statistics and the parameters after AdamW. The port runs with and without
recompute of the encoder blocks (``use_checkpoint``, on by default in the
JAX models and the port's; JAX hands it to the encoder only).
"""

import jax.numpy as jnp
import pytest

import _torch_port_train_case as case
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_flagship import _random_jax_variables
from test_torch_port_oda2_red import MAX_DEPTH, TINY_ENC
from test_torch_port_oda2_red_order import _cfg, _jax_model
from _torch_port_threads import one_torch_thread  # noqa: F401

NAMES = ("oda2_red_order_reg", "oda2_red_order_swin")


@pytest.fixture(scope="module")
def refs():
    """name -> (opt, start variables, (grads, logs, new batch_stats, new
    params) of one JAX step)."""
    out = {}
    data = case.batch(size=2)
    for i, name in enumerate(NAMES):
        opt = dict(case.make_opt(), model=_cfg(name))
        model = _jax_model(name).clone(path_drop_prob=0.0)
        variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=20 + i)
        out[name] = opt, variables, case.jax_step(model, opt, variables, data)
    return out


@pytest.mark.parametrize("use_checkpoint", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_ordered_sibling_train_step_matches_jax(refs, name, use_checkpoint):
    opt, variables, (jax_grads, jax_logs, jax_stats, jax_params) = refs[name]
    model = build_model(opt["model"], 0.001, MAX_DEPTH, device="cpu", resize_to_multiple=False,
                        encoder_kwargs=TINY_ENC, path_drop_prob=0.0,
                        use_checkpoint=use_checkpoint)
    model.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(model, opt, case.batch(size=2))
    case.assert_logs(logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(model, variables["params"], jax_stats)
    case.assert_params(model, jax_params)
