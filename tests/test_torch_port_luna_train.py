"""The port's ``oda_luna_cls`` and ``depthformer_v7`` train steps against
JAX's ``make_train_step``, in f32 on the CPU.

The tiny models of ``test_torch_port_oda.py`` and
``test_torch_port_depthformer_luna.py``, built for 64x96 (every dropout
rate and the stochastic depth 0, so that no random draw differs: the JAX
ODA encoder fixes its Swin's at 0.1, so the JAX side runs with a
``SwinTransformer`` at 0), each take one step from the same weights
(``from_jax_variables``) on the same numpy batch of two 64x96 images, with
the flagship's loss and optimizer and the chamfer loss on the bin centers
that both adapters hand over:

- ``oda_luna_cls``, the ODA encoder's windows shrunk to 12, 8, 4 and 2
  (16x24 tokens at stage 1), K1's path on the CPU, with ``freeze_bn``;
- ``depthformer_v7`` with batch statistics: five aux ViTs, the position
  embedding and dropout sites, SiLU.

Both at ``chamfer_weight`` 0.001, as ``oda2_luna_cls``'s test
(``test_torch_port_oda2_luna_train.py``): the chamfer term's gradient
reaches the parameters through the bin widths normalised by their sum,
where it largely cancels (ROADMAP Queue 3). At weight 0.1,
``oda_luna_cls``'s ELU(0.1) widths (no +0.1) left a loss of 654 that came
out 5e-5 apart between the frameworks, and v7's gradient norm (661, 157
without the chamfer term) 5.4e-5 apart with every tensor's gradient
within 1.1e-4, against the logs' 1e-5; at weight 0 v7's norm held at
4.7e-6.

The comparison and its tolerances are ``_torch_port_train_case.py``'s:
the logs, every gradient, the BatchNorm statistics and the parameters
after AdamW. The gradient norm is held to the f64 norm of JAX's own
gradients, as in ``test_torch_port_adabins_train.py``: JAX's f32 log
misses it by 5e-5 at v7's EfficientNet gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_train_case as case
from mde_tpu.models import swin as jax_swin
from mde_tpu.models.depthformer.luna_versions import DepthformerLuna
from mde_tpu.models.oda import encoder as jax_encoder
from mde_tpu.models.oda.models import ODALunaClsModel
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_depthformer_luna import CFG as DF_CFG
from test_torch_port_depthformer_luna import TINY_ENC as DF_ENC
from test_torch_port_flagship import _random_jax_variables
from test_torch_port_oda import LUNA, TINY_ENC
from _torch_port_threads import one_torch_thread  # noqa: F401

MAX_DEPTH = 80.0
NO_DROP = dict(attn_drop_prob=0.0, drop_prob=0.0)
# name -> (the config, the JAX model, the port's build overrides, freeze_bn)
NAMES = {
    "oda_luna_cls": (
        dict(LUNA, num_bins=8, **NO_DROP),
        lambda cfg: ODALunaClsModel.build(cfg, 0.001, MAX_DEPTH, resize_to_multiple=False,
                                          encoder_kwargs=TINY_ENC),
        dict(resize_to_multiple=False, img_size=(64, 96),
             encoder_kwargs=dict(TINY_ENC, drop_prob=0.0, path_drop_prob=0.0)), True),
    "depthformer_v7": (
        dict(DF_CFG, img_size=(64, 96), **NO_DROP),
        lambda cfg: DepthformerLuna.build(7, cfg, 0.001, MAX_DEPTH, encoder_kwargs=DF_ENC),
        dict(encoder_kwargs=DF_ENC), False),
}


def _swin_without_drops(**kwargs):
    return jax_swin.SwinTransformer(**dict(kwargs, drop_prob=0.0, path_drop_prob=0.0))


@pytest.mark.parametrize("name", list(NAMES))
def test_luna_family_train_step_matches_jax(name, monkeypatch):
    cfg, make, overrides, freeze_bn = NAMES[name]
    cfg = dict(cfg, name=name)
    opt = dict(case.make_opt(), model=cfg)
    opt["loss"] = dict(opt["loss"], chamfer_weight=0.001)
    data = case.batch(size=2)
    monkeypatch.setattr(jax_encoder, "SwinTransformer", _swin_without_drops)
    model = make(cfg)
    variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=30)
    jax_grads, jax_logs, jax_stats, jax_params = case.jax_step(model, opt, variables, data,
                                                               freeze_bn=freeze_bn)
    assert jax_logs["loss_chamfer"] > 0
    exact = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                              for g in jax.tree_util.tree_leaves(jax_grads))))
    assert abs(exact - jax_logs["grad_norm"]) <= 1e-4 * exact
    jax_logs = dict(jax_logs, grad_norm=exact)
    port = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", **overrides)
    port.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(port, opt, data, freeze_bn=freeze_bn)
    case.assert_logs(logs, jax_logs)
    assert abs(logs["loss_chamfer"] - jax_logs["loss_chamfer"]) <= (
        case.LOG_TOL * max(1.0, jax_logs["loss_chamfer"]))
    case.assert_grads(grads, jax_grads)
    case.assert_stats(port, variables["params"], jax_stats)
    case.assert_params(port, jax_params)
