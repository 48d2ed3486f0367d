"""The port's ``oda2_ksa_reg`` train step against JAX's ``make_train_step``.

The tiny KSA model of ``test_torch_port_ksa.py`` (stochastic depth off, so
that no random draw differs) takes one step from the same weights
(``from_jax_variables``) on the same numpy batch of 64x96 images, in f32 on
the CPU, with the flagship's loss and optimizer.

The batch is four images, three with a colour cast of their own, for the
PPM's 1x1 pooled BatchNorm, which normalises one pooled value per image. At
one image it would normalise a single value. At two its output is +-1
whatever their spread, so the gradient into its 1x1 conv is rounding noise
on both sides (measured: 2% of that tensor's largest gradient apart). And
random images of one distribution pool to nearly the same features (the
encoder's LayerNorms take out brightness, so darkening does not help; a
cast changes the colour's direction, which they keep), whose variance
E[x^2] - E[x]^2 cancels in f32 (ROADMAP Queue 3) and sends noise into every
encoder gradient.

The comparison and its tolerances are ``_torch_port_train_case.py``'s: the
logs, every gradient, the BatchNorm statistics and the parameters after
AdamW. The port runs with and without recompute of the encoder blocks
(``use_checkpoint``, on by default in the JAX model and the port's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port_train_case as case
import mde_tpu.models.oda2.ksa as jax_ksa
from mde_tpu.train.optim import build_optimizer as jax_build_optimizer
from mde_tpu.train.state import TrainState as JaxTrainState
from mde_tpu.train.step import make_train_step as jax_make_train_step
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.train.optim import global_norm
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import make_train_step
from test_torch_port_flagship import ENC, _random_jax_variables
from test_torch_port_ksa import CFG
from _torch_port_threads import one_torch_thread  # noqa: F401


def batch():
    data = case.batch(size=4)
    data["image"] *= np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
                               [1.0, 1.0, 1.0]], np.float32)[:, None, None]
    return data


@pytest.fixture(scope="module")
def ref():
    """(opt, start variables, (grads, logs, new batch_stats, new params) of
    one JAX step)."""
    opt = dict(case.make_opt(), model=dict(CFG))
    model = jax_ksa.ODA2KSARegModel.build(CFG, 0.001, 80.0, resize_to_multiple=False,
                                          encoder_kwargs=ENC, use_checkpoint=False,
                                          path_drop_prob=0.0)
    data = batch()
    variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=8)
    stash = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(stash, jax_build_optimizer(opt, case.TOTAL_STEPS))
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    step = jax_make_train_step(model, opt, 0.001, 80.0, tx, donate=False)
    new, logs = step(state, {k: jnp.asarray(v) for k, v in data.items()},
                     jax.random.PRNGKey(0))
    return opt, variables, (new.opt_state[0], {k: float(v) for k, v in logs.items()},
                            new.batch_stats, new.params)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_ksa_train_step_matches_jax(ref, use_checkpoint):
    opt, variables, (jax_grads, jax_logs, jax_stats, jax_params) = ref
    model = build_model(CFG, 0.001, 80.0, device="cpu", resize_to_multiple=False,
                        encoder_kwargs=ENC, path_drop_prob=0.0, use_checkpoint=use_checkpoint)
    model.load_state_dict(from_jax_variables(variables))
    state = TrainState.create(model, opt, case.TOTAL_STEPS)
    grads = {}
    update = state.optimizer.update

    def keep(g):
        grads.update({n: t.clone() for n, t in g.items()})
        update(g)

    state.optimizer.update = keep
    state, logs = make_train_step(opt, 0.001, 80.0)(state, batch(),
                                                   torch.Generator().manual_seed(0))
    assert state.step == 1
    case.assert_logs({k: float(v) for k, v in logs.items()}, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(model, variables["params"], jax_stats)
    case.assert_params(model, jax_params)


def test_global_norm_holds_at_a_swin_l_layer_size():
    """The gradient of one Swin-L MLP weight holds 9.4e6 elements, where
    torch's f32 CPU ``vector_norm`` comes out 1e-4 low (the KSA step's
    grad_norm, card against CPU, showed it). The port's ``global_norm``
    agrees with the f64 norm and with ``optax.global_norm`` within 1e-6."""
    rng = np.random.RandomState(9)
    ts = [(rng.randn(1536 * 6144) * 0.01 + 0.02).astype(np.float32),
          rng.randn(300).astype(np.float32)]
    exact = float(np.sqrt(sum(np.sum(t.astype(np.float64) ** 2) for t in ts)))
    ours = float(global_norm([torch.from_numpy(t) for t in ts]))
    assert abs(ours - exact) <= 1e-6 * exact
    assert abs(ours - float(optax.global_norm([jnp.asarray(t) for t in ts]))) <= 1e-6 * exact
