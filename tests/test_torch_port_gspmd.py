"""The port's GSPMD data parallelism (``train.spmd`` ``"gspmd"``) on two
gloo ranks on the CPU in f32, against the JAX package on the global batch
and against the port's one-process step.

JAX's GSPMD step computes on global arrays: BatchNorm statistics, dropout
masks and losses are the whole batch's, whatever device holds each row.
Each rank here holds two rows of a batch of four (``_torch_port_dist``'s
targets, one gloo group for the whole file):

- ``BatchNorm`` inside ``parallel.mesh.gspmd_scope`` against flax's
  ``BatchNorm`` on the concatenated batch: output, running statistics and
  the gradients to x, scale and bias, for f32 and bf16 inputs. f32 within
  1e-5 of max(1, |JAX's|); bf16 outputs and x's gradient within one bf16
  ulp (2^-7 of the value; the f32 values the two sides round differ in
  their last bits, so a rounding can fall either side), the f32 parameter
  gradients and statistics as f32.
- The draws: a ``Dropout``, a ``DropPath`` and a shifted ``SwinBlock``'s
  windowed attention dropout (leading dimension batch x windows) on two
  ranks give, bit for bit, each rank's rows of the one process's masks,
  and leave the generator where the one process leaves it.
- ``DepthLoss`` (four maps, oda weighting, sog and chamfer terms, per
  image and over the batch) against JAX's on the global batch: logs
  within 1e-5 of max(1, |JAX's|), and each rank's gradients, divided by
  the number of ranks (every rank backpropagates the global loss and each
  sum over the ranks sums the gradients back), within 1e-5 of the largest
  |g| of JAX's gradients to the maps and centers.
- The tiny flagship's ``make_train_step_gspmd`` with dropout, attention
  dropout and stochastic depth on and recompute on, two microbatches,
  against the port's ``make_train_step`` on the global batch in one
  process from the same generator: logs, gradients, parameters and
  BatchNorm statistics within 1e-5 (logs of their magnitude, gradients of
  the largest |g|); every rank's state the same; its all-reduce launches
  exactly the count derived from the model (each microbatch: a forward
  and a backward one a BatchNorm, one a BatchNorm of a recomputed block in
  its replay, a forward and a backward one a loss map; then one for the
  gradients).
- The driver: ``Trainer.fit(max_steps=2)`` with ``train.spmd`` 'gspmd' on
  two ranks over a synthetic KITTI tree, two microbatches of two a step,
  one validation at step 2: both ranks end with the same parameters and
  metrics, only rank 0 saves and predicts; a loader batch of three, which
  does not split over two ranks, raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_dist as ranks
import mde_tpu.train.loss as jax_loss
from mde_tpu_torch.models import build_model
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import make_train_step
from _torch_port_threads import one_torch_thread  # noqa: F401

WORLD = 2
TOL = 1e-5
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SITES = ("dropout", "drop_path", "window")
LOSSES = {"per_image": True, "per_batch": False}
ENC = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4)
DROP_CFG = dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32, num_heads=4,
                num_repeats=2, num_emb=16, window_size=4, neck_type="red33", drop_prob=0.1,
                attn_drop_prob=0.1)
DROP_KW = dict(resize_to_multiple=False, encoder_kwargs=ENC, path_drop_prob=0.2,
               use_checkpoint=True)
DROP_ACCUM = 2


def _opt():
    return {"model": dict(DROP_CFG),
            "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True, "si_weight": 1.0},
            "optimizer": {"lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 0.1,
                          "eps": 1e-6, "same_lr": True},
            "scheduler": {"name": "onecycle", "pct_start": 0.25, "div_factor": 25,
                          "final_div_factor": 100},
            "train": {"grad_norm": 0.1}}


def _bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(2 * WORLD, 3, 5, 6) * 2.0 + 0.5).astype(np.float32)
    weight = rng.randn(*x.shape).astype(np.float32)
    params = tuple(v.astype(np.float32) for v in (
        rng.randn(6) * 0.2 + 1.0, rng.randn(6) * 0.2, rng.randn(6) * 0.2,
        rng.uniform(0.5, 1.5, 6)))
    return x, weight, params


def _loss_inputs():
    rng = np.random.RandomState(2)
    gt = rng.uniform(0.5, 90.0, (2 * WORLD, 12, 20, 1)).astype(np.float32)
    gt[0, :3] = 0.0
    gt[3, :, :5] = 0.0
    maps = [rng.uniform(0.5, 60.0, (2 * WORLD, h, w, 1)).astype(np.float32)
            for h, w in ((6, 10), (6, 10), (6, 10), (12, 20))]
    centers = rng.uniform(0.5, 80.0, (2 * WORLD, 16)).astype(np.float32)
    return maps, gt, centers


def _loss_section(per_image):
    return {"alpha": 10.0, "beta": 0.15, "per_image": per_image, "oda_weight": 0.5,
            "sog_weight": 0.3, "chamfer_weight": 0.1}


def _draw_batch():
    return np.random.RandomState(4).randn(2 * WORLD, 8, 8, 8).astype(np.float32)


def _step_batch():
    rng = np.random.RandomState(0)
    return {"image": rng.rand(2 * WORLD, 64, 96, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 60.0, (2 * WORLD, 64, 96, 1)).astype(np.float32)}


@pytest.fixture(scope="module")
def start_state():
    model = build_model(DROP_CFG, 0.001, 80.0, device="cpu", seed=0, **DROP_KW)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def port(start_state, tmp_path_factory):
    """Both ranks' ``_torch_port_dist.gspmd_case``, one gloo group."""
    root = tmp_path_factory.mktemp("gspmd")
    x, weight, params = _bn_inputs()
    modules = {"bn": [(x, weight, DTYPES[d][0], params) for d in DTYPES],
               "draws": (SITES, _draw_batch()),
               "loss": ([_loss_section(v) for v in LOSSES.values()], *_loss_inputs())}
    step_args = (DROP_CFG, DROP_KW, _opt(), start_state, _step_batch(), DROP_ACCUM, False)
    dataset = ranks.write_kitti_tree(str(root))
    from test_driver import TINY_OPT
    opt = dict(TINY_OPT, output_dir=str(root / "run"), dataset=dataset,
               dataloader={"batch_size": 2, "num_workers": 1},
               train=dict(TINY_OPT["train"], num_accum=2, valid_freq=2, spmd="gspmd"),
               eval=dict(TINY_OPT["eval"], max_depth_eval=80.0, garg_crop=True,
                         eigen_crop=False))
    fit_args = (opt, dict(resize_to_multiple=False, encoder_kwargs=ENC,
                          path_drop_prob=0.0, use_checkpoint=False), str(root / "splits"))
    return root, ranks.run_ranks(ranks.gspmd_case, WORLD, root, modules, step_args, fit_args)


def _flax_batch_norm(dtype):
    """(output, x's gradient, new mean, new variance, scale's and bias's
    gradients) of flax's BatchNorm in training on the whole batch, the
    same loss as the ranks'."""
    x, weight, (scale, bias, mean, var) = _bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=dtype,
                       param_dtype=jnp.float32)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def loss(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * weight).sum(), (y, upd["batch_stats"])

    (_, (y, new)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x).astype(dtype), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})
    return tuple(np.asarray(jnp.asarray(v, jnp.float32)) for v in (
        y, gx, new["mean"], new["var"], gp["scale"], gp["bias"]))


def _within(ours, ref, tol=TOL):
    return float(np.max(np.abs(ours - ref))) <= tol * max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batch_norm_takes_the_global_batch_statistics(port, dtype):
    ref = _flax_batch_norm(DTYPES[dtype][1])
    _, results = port
    n = ref[0].shape[0] // WORLD
    i = list(DTYPES).index(dtype)
    for rank, (bn, *_) in enumerate(results):
        y, gx, mean, var, gscale, gbias = bn[i]
        rows = slice(rank * n, (rank + 1) * n)
        for ours, want in ((y, ref[0][rows]), (gx, ref[1][rows])):
            if dtype == "float32":
                assert _within(ours, want)
            else:
                assert np.all(np.abs(ours - want) <= BF16_ULP * np.abs(want) + 1e-6)
        for ours, want in zip((mean, var, gscale, gbias), ref[2:]):
            assert _within(ours, want)
    assert all(np.array_equal(a, b) for a, b in zip(results[0][0][i][2:], results[1][0][i][2:]))


@pytest.mark.parametrize("site", SITES)
def test_global_draws_are_rows_of_one_draw(port, site):
    batch = torch.from_numpy(_draw_batch())
    generator = torch.Generator().manual_seed(3)
    y, masks = ranks.draw_site(site, batch, generator)
    _, results = port
    for rank, (_, draws, *_) in enumerate(results):
        y_r, masks_r, state = draws[site]
        assert len(masks_r) == len(masks) > 0
        for mask, mask_r in zip(masks, masks_r):
            n = mask.shape[0] // WORLD
            assert torch.equal(mask_r, mask[rank * n:(rank + 1) * n]), site
        n = y.shape[0] // WORLD
        torch.testing.assert_close(y_r, y[rank * n:(rank + 1) * n], rtol=0, atol=1e-6)
        assert torch.equal(state, generator.get_state())
    # the draws were real: the masks keep some and drop some
    assert 0 < sum(int(m.sum()) for m in masks) < sum(m.numel() for m in masks)


@pytest.mark.parametrize("case", list(LOSSES))
def test_depth_loss_is_the_global_batch_loss(port, case):
    maps, gt, centers = _loss_inputs()
    loss = jax_loss.DepthLoss(_loss_section(LOSSES[case]), 0.001, 80.0)

    def total(maps, centers):
        value, logs = loss(maps, jnp.asarray(gt), bin_centers=centers)
        return value, logs

    (_, ref_logs), (ref_maps, ref_centers) = jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True)([jnp.asarray(m) for m in maps],
                                             jnp.asarray(centers))
    ref_grads = [np.asarray(g) for g in (*ref_maps, ref_centers)]
    scale = max(float(np.max(np.abs(g))) for g in ref_grads)
    _, results = port
    n = gt.shape[0] // WORLD
    for rank, (_, _, losses, *_) in enumerate(results):
        logs, map_grads, center_grad = losses[list(LOSSES).index(case)]
        assert set(logs) == set(ref_logs) == {"loss", "loss_si", "loss_sog", "loss_chamfer"}
        for key, value in ref_logs.items():
            assert abs(logs[key] - float(value)) <= TOL * max(1.0, abs(float(value))), key
        for ours, want in zip((*map_grads, center_grad), ref_grads):
            err = np.max(np.abs(ours / WORLD - want[rank * n:(rank + 1) * n]))
            assert err <= TOL * scale, (rank, err, scale)


def test_gspmd_step_with_dropout_matches_one_process(port, start_state):
    model = build_model(DROP_CFG, 0.001, 80.0, device="cpu", seed=0, **DROP_KW)
    model.load_state_dict(start_state)
    state = TrainState.create(model, _opt(), 100)
    seen = {}
    real = state.optimizer.update

    def update(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        real(grads)

    state.optimizer.update = update
    _, ref_logs = make_train_step(_opt(), 0.001, 80.0, num_accum=DROP_ACCUM)(
        state, _step_batch(), torch.Generator().manual_seed(0))
    ref_state = model.state_dict()
    _, results = port
    steps = [r[3] for r in results]
    scale = max(g.abs().max().item() for g in seen.values())
    for grads, logs, weights, launched, norms, replayed, maps in steps:
        for key, value in ref_logs.items():
            assert abs(logs[key] - float(value)) <= TOL * max(1.0, abs(float(value))), key
        assert set(grads) == set(seen)
        worst = max((grads[n] - g).abs().max().item() for n, g in seen.items())
        assert worst <= TOL * scale, (worst, scale)
        for name, value in ref_state.items():
            if value.is_floating_point():
                assert _within(weights[name].numpy(), value.numpy()), name
        assert norms > 0 and replayed > 0 and maps == DROP_CFG["num_repeats"] + 1
        assert launched == DROP_ACCUM * (2 * norms + replayed + 2 * maps) + 1
    (_, logs0, weights0, *_), (_, logs1, weights1, *_) = steps
    assert logs0 == logs1 and all(torch.equal(weights0[k], weights1[k]) for k in weights0)
    # the draws took effect: another generator gives another loss
    model.load_state_dict(start_state)
    _, other = make_train_step(_opt(), 0.001, 80.0, num_accum=DROP_ACCUM)(
        TrainState.create(model, _opt(), 100), _step_batch(), torch.Generator().manual_seed(1))
    assert float(other["loss"]) != float(ref_logs["loss"])


def test_trainer_fit_gspmd_on_two_ranks(port):
    root, results = port
    (saved0, steps0, metrics0, params0, written0), \
        (saved1, steps1, metrics1, params1, written1) = (r[4] for r in results)
    assert steps0 == steps1 == 2
    assert saved0 == [2] and saved1 == []
    assert sorted(p.name for p in (root / "run" / "checkpoints").iterdir()) == ["step_2"]
    assert written0 == 2 and written1 == 0
    assert len(metrics0) == 9 and all(np.isfinite(v) for v in metrics0.values())
    assert metrics0 == metrics1
    assert all(np.array_equal(params0[n], params1[n]) for n in params0)


def test_gspmd_trainer_refuses_a_batch_that_does_not_split(port):
    _, results = port
    for *_, refused in results:
        assert refused is not None and "microbatch of 3 images" in refused
        assert "does not split over 2 ranks" in refused
