"""The port's data-parallel training against the JAX package's, on the CPU
in f32.

- The step: ``make_train_step_shard_map`` on two gloo ranks
  (``_torch_port_dist.run_ranks``; each rank its two rows of a batch of
  four) against ``mde_tpu.train.step.make_train_step_shard_map`` over two
  of the host devices, from the same weights (rank 1 starts from other
  weights and takes rank 0's through ``replicate``), on the tiny flagship
  of ``_torch_port_train_case.py`` at one repeat, stochastic depth and
  dropout off; with batch statistics everywhere and with
  ``freeze_encoder_bn``. The logs, the parameters after AdamW and the
  BatchNorm statistics within 1e-4 (max-abs; Adam's first update is 4e-6
  a parameter, so the parameters are held at a tenth of that, as in
  ``_torch_port_train_case.py``), the gradients at that file's
  tolerances, and every rank's state the same.
- The driver: ``Trainer.fit(max_steps=2)`` with ``train.spmd`` 'shard_map'
  on two ranks over a synthetic KITTI tree, one validation at step 2: only
  rank 0 saves the checkpoint and writes ``Trainer.predict``'s PNGs, and
  both ranks end with the same parameters. The 'gspmd' step and driver
  across ranks: ``test_torch_port_gspmd.py``, ``test_torch_port_gspmd_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_port_dist as ranks
import _torch_port_train_case as case
import mde_tpu.models.oda2.red_order_swin2 as jax_flagship
from mde_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mde_tpu.train.optim import build_optimizer as jax_build_optimizer
from mde_tpu.train.state import TrainState as JaxTrainState
from mde_tpu.train.step import make_train_step_shard_map as jax_shard_map_step
from mde_tpu_torch.convert import from_jax_variables
from test_torch_port_flagship import ENC, _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

WORLD = 2
CFG = dict(case.CFG, num_repeats=1)
# one block a stage: the data-parallel arithmetic does not depend on depth
ENC1 = dict(ENC, depths=(1, 1, 1, 1))
MODEL_KW = dict(resize_to_multiple=False, encoder_kwargs=ENC1, path_drop_prob=0.0,
                use_checkpoint=False)
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_model():
    model = jax_flagship.ODA2OrderedSwin2RegModel.build(
        CFG, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC1,
        use_checkpoint=False, scan_repeats=False, path_drop_prob=0.0)
    data = case.batch(size=2 * WORLD)
    return model, data, _random_jax_variables(model, jnp.asarray(data["image"]), seed=5)


def _jax_step(model, data, variables, freeze_encoder_bn):
    """(grads, logs, batch_stats, params) of JAX's shard_map step over two
    host devices, the gradients stashed by a first link in the chain."""
    opt = case.make_opt()
    stash = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(stash, jax_build_optimizer(opt, case.TOTAL_STEPS))
    mesh = jax_make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    step = jax_shard_map_step(model, opt, 0.001, 80.0, tx, mesh,
                              freeze_encoder_bn=freeze_encoder_bn)
    new, logs = step(state, {k: jnp.asarray(v) for k, v in data.items()},
                     jax.random.PRNGKey(0))
    return (new.opt_state[0], {k: float(v) for k, v in logs.items()}, new.batch_stats,
            new.params)


@pytest.fixture(scope="module")
def port(jax_model, tmp_path_factory):
    """Both ranks' ``_torch_port_dist.shard_map_steps_and_fit``, one gloo
    group: the shard_map step from the JAX model's weights (with batch
    statistics, then with ``freeze_encoder_bn``), then ``Trainer.fit`` of
    the tiny flagship of ``tests/test_driver.py``'s ``TINY_OPT`` on a
    synthetic KITTI tree, batch 4 (two rows a rank) in one microbatch,
    validation at step 2."""
    _, data, variables = jax_model
    root = tmp_path_factory.mktemp("ranks")
    dataset = ranks.write_kitti_tree(str(root))
    from test_driver import TINY_OPT
    opt = dict(TINY_OPT, output_dir=str(root / "run"), dataset=dataset,
               dataloader={"batch_size": 4, "num_workers": 1},
               train=dict(TINY_OPT["train"], num_accum=1, valid_freq=2, spmd="shard_map"),
               eval=dict(TINY_OPT["eval"], max_depth_eval=80.0, garg_crop=True,
                         eigen_crop=False))
    step_args = (CFG, MODEL_KW, case.make_opt(), from_jax_variables(variables), data)
    fit_args = (opt, MODEL_KW, str(root / "splits"))
    return root, ranks.run_ranks(ranks.shard_map_steps_and_fit, WORLD, root, step_args,
                                 fit_args)


@pytest.mark.parametrize("freeze_encoder_bn", [False, True], ids=["bn_live", "freeze_encoder_bn"])
def test_shard_map_step_matches_jax(jax_model, port, freeze_encoder_bn):
    model, data, variables = jax_model
    jax_grads, jax_logs, jax_stats, jax_params = _jax_step(model, data, variables,
                                                           freeze_encoder_bn)
    _, ((steps0, _), (steps1, _)) = port
    grads, logs, state = steps0[freeze_encoder_bn]
    _, logs1, state1 = steps1[freeze_encoder_bn]
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
    assert not np.array_equal(state["decoder.dec_linear.weight"], start["decoder.dec_linear.weight"])
    if freeze_encoder_bn:
        assert all(np.array_equal(state[n], start[n]) for n in ref_stats
                   if n.startswith("encoder."))


def test_trainer_fit_shard_map_on_two_ranks(port):
    root, ((_, fit0), (_, fit1)) = port
    (saved0, steps0, metrics0, params0, written0), \
        (saved1, steps1, metrics1, params1, written1) = fit0, fit1
    assert steps0 == steps1 == 2
    assert saved0 == [2] and saved1 == []
    assert sorted(p.name for p in (root / "run" / "checkpoints").iterdir()) == ["step_2"]
    assert written0 == 2 and written1 == 0
    assert len(list((root / "run" / "predictions").rglob("*.png"))) == 2
    assert len(metrics0) == 9 and all(np.isfinite(v) for v in metrics0.values())
    assert metrics0 == metrics1
    assert all(np.array_equal(params0[n], params1[n]) for n in params0)
