"""The port's ``adabins`` train step against JAX's ``make_train_step``, in
f32 on the CPU.

The tiny model of ``test_torch_port_adabins.py`` (``TINY_ENC``, 16 bins)
takes one step from the same weights (``from_jax_variables``) on the same
numpy batch of two 288x480 images (9 x 15 = 135 patches of mViT's, the
least it takes being 129), with the flagship's loss and optimizer, the
chamfer loss at 0.1 on the bin centers that the adapters make of the
edges on both sides, and ``same_lr`` off: the encoder's updates at a tenth
(its parameter names all hold an ``encoder`` segment, as JAX labels them).
The transformer's dropout is 0 on both sides, so that no random draw
differs (JAX's layer takes its rate from a field its model never sets:
``TorchTransformerEncoderLayer`` is swapped for one at rate 0 in the JAX
module's globals for the test).

The comparison and its tolerances are ``_torch_port_train_case.py``'s:
the logs (and the chamfer term), every gradient, the BatchNorm statistics
and the parameters after AdamW. The gradient norm is held to the f64 norm
of JAX's own gradients, which JAX's f32 log misses by 5e-5 here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import _torch_port_train_case as case
from mde_tpu.models.adabins import model as jax_adabins
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_adabins import TINY_ENC, _variables
from _torch_port_threads import one_torch_thread  # noqa: F401


def test_adabins_train_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_adabins, "TorchTransformerEncoderLayer", functools.partial(
        jax_adabins.TorchTransformerEncoderLayer, drop=0.0))
    cfg = {"name": "adabins", "num_bins": 16}
    opt = dict(case.make_opt(same_lr=False), model=cfg)
    opt["loss"] = dict(opt["loss"], chamfer_weight=0.1)
    rng = np.random.RandomState(0)
    data = {"image": rng.rand(2, 288, 480, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 60.0, (2, 288, 480, 1)).astype(np.float32)}
    model = jax_adabins.UnetAdaptiveBins.build(cfg, 0.001, 80.0, encoder_kwargs=TINY_ENC)
    variables = _variables(model, jnp.asarray(data["image"]), seed=30)
    jax_grads, jax_logs, jax_stats, jax_params = case.jax_step(model, opt, variables, data)
    assert jax_logs["loss_chamfer"] > 0
    # JAX logs the norm of its gradients summed in f32, 5e-5 low here (the
    # patch embedding's gradient holds 4.2e6 elements); the port's sums each
    # tensor's squares in f64 on the CPU. Hold it to those gradients' norm.
    exact = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                              for g in jax.tree_util.tree_leaves(jax_grads))))
    assert abs(exact - jax_logs["grad_norm"]) <= 1e-4 * exact
    jax_logs = dict(jax_logs, grad_norm=exact)
    port = build_model(cfg, 0.001, 80.0, device="cpu", encoder_kwargs=TINY_ENC, drop_prob=0.0)
    assert all("encoder" in n.split(".") for n, _ in port.named_parameters()
               if n.startswith("encoder."))
    port.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(port, opt, data)
    case.assert_logs(logs, jax_logs)
    assert abs(logs["loss_chamfer"] - jax_logs["loss_chamfer"]) <= (
        case.LOG_TOL * max(1.0, jax_logs["loss_chamfer"]))
    case.assert_grads(grads, jax_grads)
    case.assert_stats(port, variables["params"], jax_stats)
    case.assert_params(port, jax_params)
