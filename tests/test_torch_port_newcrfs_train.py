"""The port's NewCRFs train step against JAX's ``make_train_step``.

The tiny ``NewCRFDepth`` of ``test_torch_port_newcrfs.py`` (``custom04``,
bilinear upsampling) takes one step from the same weights
(``from_jax_variables``) on the same numpy batch of 64x96 images, in f32 on
the CPU, with the flagship's loss and optimizer. The comparison and its
tolerances are ``_torch_port_train_case.py``'s: the logs, every gradient,
the BatchNorm statistics and the parameters after AdamW.

The JAX model fixes its Swin's stochastic depth at 0.3 with no field to
change it (``mde_tpu/models/newcrfs/model.py:133``), and the two frameworks
draw different masks, so the JAX side runs with the ``SwinTransformer``
that its model module calls replaced by one at rate 0, and the port's build
takes ``path_drop_prob=0.0``. The batch is four images, three with a colour
cast of their own: the PSP's BatchNorms normalise 2x2, 3x3 and 6x6 pooled
maps of a 2x3 feature map, whose statistics over few, similar images
cancel in f32 (``test_torch_port_ksa_train.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_train_case as case
from mde_tpu.models import swin as jax_swin
from mde_tpu.models.newcrfs import model as jax_model
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from test_torch_port_newcrfs import CFG, MAX_DEPTH, TINY, _random_vars
from _torch_port_threads import one_torch_thread  # noqa: F401


def batch():
    data = case.batch(size=4)
    data["image"] *= np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
                               [1.0, 1.0, 1.0]], np.float32)[:, None, None]
    return data


def _swin_without_drop_path(**kwargs):
    return jax_swin.SwinTransformer(**dict(kwargs, path_drop_prob=0.0))


@pytest.fixture(scope="module")
def ref():
    """(opt, start variables, (grads, logs, new batch_stats, new params) of
    one JAX step)."""
    opt = dict(case.make_opt(), model=dict(CFG))
    data = batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "SwinTransformer", _swin_without_drop_path)
        model = jax_model.NewCRFDepth(min_depth=0.001, max_depth=MAX_DEPTH, **TINY)
        variables = _random_vars(model, jnp.asarray(data["image"][:1]), seed=21)
        return opt, variables, case.jax_step(model, opt, variables, data)


def test_newcrfs_train_step_matches_jax(ref):
    opt, variables, (jax_grads, jax_logs, jax_stats, jax_params) = ref
    model = build_model(CFG, 0.001, MAX_DEPTH, device="cpu",
                        encoder_kwargs=TINY["encoder_kwargs"], path_drop_prob=0.0)
    model.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(model, opt, batch())
    case.assert_logs(logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(model, variables["params"], jax_stats)
    case.assert_params(model, jax_params)
