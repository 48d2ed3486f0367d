"""The port's GSPMD train step (``make_train_step_gspmd``) on two gloo
ranks against the JAX package's ``make_train_step`` on the global batch,
on the CPU in f32.

Under JAX's data mesh (``mde_tpu/train/driver.py:94-104``) the GSPMD step
is the one-device step on the global batch. So the reference is
``mde_tpu.train.step.make_train_step`` in one process on a batch of four,
and the port's step runs on two ranks (``_torch_port_dist.gspmd_steps``),
each taking its rows of every microbatch, from the same weights (rank 1
starts from other weights and takes rank 0's through ``replicate``), on
the tiny flagship of ``test_torch_port_shard_map.py`` (one block a
stage, one repeat), recomputing its blocks, stochastic depth and dropout
off; with batch statistics and with ``freeze_encoder_bn``, in one
microbatch and in two (one image a rank each). The logs, the parameters
after AdamW and the BatchNorm statistics within 1e-4 (max-abs; the
parameters within ``_torch_port_train_case.PARAM_TOL``, a tenth of
Adam's first update), the gradients at that file's tolerances, every
rank's state the same, and the all-reduces each rank launched the count
derived from the model (``test_torch_port_gspmd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_dist as ranks
import _torch_port_train_case as case
import mde_tpu.models.oda2.red_order_swin2 as jax_flagship
from mde_tpu_torch.convert import from_jax_variables
from test_torch_port_flagship import _random_jax_variables
from test_torch_port_shard_map import CFG, ENC1, MODEL_KW, TOL, WORLD
from _torch_port_threads import one_torch_thread  # noqa: F401

# (num_accum, freeze_encoder_bn)
VARIANTS = {"bn_live-accum_1": (1, False), "bn_live-accum_2": (2, False),
            "freeze_encoder_bn-accum_1": (1, True), "freeze_encoder_bn-accum_2": (2, True)}


@pytest.fixture(scope="module")
def jax_model():
    model = jax_flagship.ODA2OrderedSwin2RegModel.build(
        CFG, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC1,
        use_checkpoint=False, scan_repeats=False, path_drop_prob=0.0)
    data = case.batch(size=2 * WORLD)
    return model, data, _random_jax_variables(model, jnp.asarray(data["image"]), seed=5)


@pytest.fixture(scope="module")
def port(jax_model, tmp_path_factory):
    """Both ranks' ``gspmd_step`` of every variant, one gloo group."""
    _, data, variables = jax_model
    step_args = (CFG, dict(MODEL_KW, use_checkpoint=True), case.make_opt(),
                 from_jax_variables(variables), data)
    return ranks.run_ranks(ranks.gspmd_steps, WORLD, tmp_path_factory.mktemp("ranks"),
                           step_args, list(VARIANTS.values()))


def _jax_step(model, data, variables, num_accum, freeze_encoder_bn):
    """(grads, logs, batch_stats, params) of JAX's ``make_train_step`` on
    the whole batch, the gradients stashed by a first link in the chain."""
    import optax
    from mde_tpu.train.optim import build_optimizer
    from mde_tpu.train.state import TrainState
    from mde_tpu.train.step import make_train_step
    opt = case.make_opt()
    stash = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(stash, build_optimizer(opt, case.TOTAL_STEPS))
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    step = make_train_step(model, opt, 0.001, 80.0, tx, num_accum=num_accum,
                           freeze_encoder_bn=freeze_encoder_bn, donate=False)
    new, logs = step(state, {k: jnp.asarray(v) for k, v in data.items()},
                     jax.random.PRNGKey(0))
    return (new.opt_state[0], {k: float(v) for k, v in logs.items()}, new.batch_stats,
            new.params)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gspmd_step_matches_jax_on_the_global_batch(jax_model, port, variant):
    model, data, variables = jax_model
    num_accum, freeze_encoder_bn = VARIANTS[variant]
    jax_grads, jax_logs, jax_stats, jax_params = _jax_step(model, data, variables, num_accum,
                                                           freeze_encoder_bn)
    i = list(VARIANTS).index(variant)
    (grads, logs, state, launched, norms, replayed, maps), \
        (_, logs1, state1, launched1, *_) = port[0][i], port[1][i]
    assert logs == logs1 and all(np.array_equal(state[k], state1[k]) for k in state)
    for key in ("loss", "loss_si", "grad_norm", "param_norm"):
        assert abs(logs[key] - jax_logs[key]) <= TOL, (key, logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    ref_stats = case.port_names(variables["params"], jax_stats)
    assert ref_stats
    worst = max((state[n] - v).abs().max().item() for n, v in ref_stats.items())
    assert worst <= TOL, worst
    ref_params = case.port_names(jax_params)
    worst = max((state[n] - v).abs().max().item() for n, v in ref_params.items())
    assert worst <= case.PARAM_TOL, worst
    start = from_jax_variables(variables)
    assert not np.array_equal(state["decoder.dec_linear.weight"],
                              start["decoder.dec_linear.weight"])
    # the flagship's encoder has no BatchNorm: freezing it takes no collective out
    assert launched == launched1
    assert launched == num_accum * (2 * norms + replayed + 2 * maps) + 1
