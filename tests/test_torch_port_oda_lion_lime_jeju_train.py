"""The port's ``oda_lion`` and ``oda_jeju`` train steps against JAX's
``make_train_step``, in f32 on the CPU.

The tiny models of ``test_torch_port_oda_lion_lime_jeju.py``, built for
64x96 with the resize off (the ODA encoder's windows shrunk to 12, 8, 4
and 2; every dropout rate and the stochastic depth 0, so that no random
draw differs: the JAX ODA encoder fixes its Swin's at 0.1, so the JAX side
runs with a ``SwinTransformer`` at 0), each take one step from the same
weights (``from_jax_variables``) on the same numpy batch of 64x96 images,
with the flagship's loss and optimizer and the BatchNorms' running
statistics (``freeze_bn``). The batch is ``test_torch_port_ksa_train.py``'s:
four images, three with colour casts of their own.

With batch statistics JAX's jitted f32 step is the less accurate side: its
gradient norm came out 1.6e-5 (lion) and 9.9e-5 (jeju) from the norm of the
port's step run in float64, and its worst gradient 1.4e-3 and 4.3e-4 of
a tensor's largest; the port's f32 step came out 8e-7 and 1.8e-6 in the
norm and 4e-5 in the worst gradient (the PPM-v2's 1x1 pooled BatchNorm
normalises one value an image, and its variance E[x^2] - E[x]^2 cancels in
f32; ROADMAP Queue 3). With frozen statistics
the two frameworks agree to 1e-7. The BatchNorms on batch statistics are
held module by module in ``test_torch_port_oda_lion_lime_jeju.py`` and on
the card by ``tests/test_torch_port_gpu.py``.

- ``oda_lion``, whose loss the port computes on its depth map. JAX's
  default adapter would take its eight (B, L, d, d) attention weights for
  maps (J1, ROADMAP Queue 3), so the JAX step is given JAX's own
  ``adapter=`` argument with the port's routing: the prediction, no
  centers.
- ``oda_jeju`` with both frameworks' default adapters, which agree: its
  second output is the aux tokens, 3-D.

The comparison and its tolerances are ``_torch_port_train_case.py``'s:
the logs, every gradient, the BatchNorm statistics and the parameters
after AdamW.
"""

import pytest

import _torch_port_train_case as case
import jax.numpy as jnp
from mde_tpu.models import swin as jax_swin
from mde_tpu.models.oda import encoder as jax_encoder
from mde_tpu.models.oda.jeju import ODAJejuModel
from mde_tpu.models.oda.lion import ODALionModel
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_flagship import _random_jax_variables
from test_torch_port_ksa_train import batch
from test_torch_port_oda_lion_lime_jeju import MAX_DEPTH, TINY_ENC
from _torch_port_threads import one_torch_thread  # noqa: F401

NO_DROP = dict(attn_drop_prob=0.0, drop_prob=0.0)
# name -> (the config, the JAX model class, JAX's adapter: None for its default)
NAMES = {"oda_lion": (dict(decoder_channels=32, **NO_DROP), ODALionModel,
                      lambda out: ((out[0],), None)),
         "oda_jeju": (dict(decoder_channels=32, num_aux=4, num_heads=8, **NO_DROP),
                      ODAJejuModel, None)}


def _swin_without_drops(**kwargs):
    return jax_swin.SwinTransformer(**dict(kwargs, drop_prob=0.0, path_drop_prob=0.0))


@pytest.mark.parametrize("name", list(NAMES))
def test_oda_train_step_matches_jax(name, monkeypatch):
    cfg, cls, adapter = NAMES[name]
    cfg = dict(cfg, name=name)
    opt = dict(case.make_opt(), model=cfg)
    data = batch()
    monkeypatch.setattr(jax_encoder, "SwinTransformer", _swin_without_drops)
    model = cls.build(cfg, 0.001, MAX_DEPTH, resize_to_multiple=False, encoder_kwargs=TINY_ENC)
    variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=31)
    jax_grads, jax_logs, jax_stats, jax_params = case.jax_step(model, opt, variables, data,
                                                               adapter=adapter, freeze_bn=True)
    port = build_model(cfg, 0.001, MAX_DEPTH, device="cpu", resize_to_multiple=False,
                       img_size=(64, 96),
                       encoder_kwargs=dict(TINY_ENC, drop_prob=0.0, path_drop_prob=0.0))
    port.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(port, opt, data, freeze_bn=True)
    case.assert_logs(logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(port, variables["params"], jax_stats)
    case.assert_params(port, jax_params)
