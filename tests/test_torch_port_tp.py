"""Tensor-parallel feed-forwards (``tp_axis``) over a ``(data, model)``
mesh: the port's GSPMD step on gloo ranks against the JAX package's
``make_train_step`` on the global batch, on the CPU in f32.

JAX's ``tp_axis`` constrains the FF activations' layout over the model
axis of the mesh and leaves the numbers those of the one-device step
(``tests/test_train_step.py::test_tensor_parallel_2d_mesh_matches_replicated``).
So the reference is ``make_train_step`` on a batch of four in one
process, and the port's step runs on ``(data=2, model=2)`` (four ranks,
two rows each) and on ``(data=1, model=2)`` (two ranks, all four rows),
each rank of a model group on half of every FF's hidden channels, on the
tiny flagship of ``test_torch_port_gspmd_step.py`` with ``tp_axis``
"model", its head's blocks recomputed under ``save_sa_conv`` (the
default), BatchNorm live. The logs, statistics, parameters and gradients
at that file's tolerances, every rank's state bit-equal, and the
all-reduces each rank launched the count derived from the model. With
``n_model=1`` the option changes no number.
"""

import numpy as np
import pytest

import _torch_port_dist as ranks
import _torch_port_train_case as case
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.ops.mlp import PreNormDWConvFF
from test_torch_port_gspmd_step import _jax_step, jax_model  # noqa: F401
from test_torch_port_shard_map import CFG, MODEL_KW, TOL
from _torch_port_threads import one_torch_thread  # noqa: F401

TP_CFG = dict(CFG, tp_axis="model")
STEP_KW = dict(MODEL_KW, use_checkpoint=True)
# (data, model) grids
GRIDS = {"data2-model2": (2, 2), "data1-model2": (1, 2)}


def derived_all_reduces(num_accum: int = 1) -> int:
    """The all-reduces of one GSPMD step of the tiny TP flagship: a
    microbatch sums each BatchNorm's statistics forward and backward,
    again in each replay of a recomputed block, each loss map's sums
    forward and backward, and for each FF its partial products forward,
    its input's gradient backward and the partial products again in its
    block's replay; then the replicated gradients' mean, the slices' sum
    and the slices' running statistics, one each."""
    from mde_tpu_torch.ops.tnn import BatchNorm
    model = build_model(TP_CFG, 0.001, 80.0, device="cpu", **STEP_KW)
    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    blocks = list(model.decoder.reducer.attn_layers)
    replayed = sum(isinstance(m, BatchNorm) for b in blocks for m in b.modules())
    ffs = sum(isinstance(m, PreNormDWConvFF) for m in model.modules())
    maps = CFG["num_repeats"] + 1
    return num_accum * (2 * norms + replayed + 2 * maps + 3 * ffs) + 3


@pytest.fixture(scope="module")
def port(jax_model, tmp_path_factory):  # noqa: F811
    """Every rank's step on each grid, one gloo group a grid; on the
    two-rank group also the step without ``tp_axis`` and with it at
    ``n_model=1``."""
    _, data, variables = jax_model
    state = from_jax_variables(variables)
    out = {}
    for name, (n_data, n_model) in GRIDS.items():
        args = (TP_CFG, STEP_KW, case.make_opt(), state, data)
        out[name] = ranks.run_ranks(ranks.tp_steps, n_data * n_model,
                                    tmp_path_factory.mktemp(name), n_model, args, [(1, False)])
    args = [(cfg, STEP_KW, case.make_opt(), state, data) for cfg in (CFG, TP_CFG)]
    out["model1"] = ranks.run_ranks(ranks.tp_steps, 2, tmp_path_factory.mktemp("model1"), 1,
                                    args[0], [(1, False)])
    out["model1-tp"] = ranks.run_ranks(ranks.tp_steps, 2, tmp_path_factory.mktemp("model1tp"),
                                       1, args[1], [(1, False)])
    return out


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_step_matches_jax_on_the_global_batch(jax_model, port, grid):  # noqa: F811
    model, data, variables = jax_model
    jax_grads, jax_logs, jax_stats, jax_params = _jax_step(model, data, variables, 1, False)
    results = port[grid]
    n_data, n_model = GRIDS[grid]
    assert [place for (place, _), in results] == [(r // n_model, r % n_model)
                                                  for r in range(n_data * n_model)]
    (_, (grads, logs, state, launched, *_)), = results[0]
    for (_, (_, logs_r, state_r, launched_r, *_)), in results[1:]:
        assert logs_r == logs and launched_r == launched
        assert all(np.array_equal(state[k], state_r[k]) for k in state)
    for key in ("loss", "loss_si", "grad_norm", "param_norm"):
        assert abs(logs[key] - jax_logs[key]) <= TOL, (key, logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    ref_stats = case.port_names(variables["params"], jax_stats)
    worst = max((state[n] - v).abs().max().item() for n, v in ref_stats.items())
    assert worst <= TOL, worst
    ref_params = case.port_names(jax_params)
    worst = max((state[n] - v).abs().max().item() for n, v in ref_params.items())
    assert worst <= case.PARAM_TOL, worst
    assert launched == derived_all_reduces()


def test_tp_axis_on_one_model_rank_changes_nothing(port):
    """``tp_axis`` under a mesh without a model axis: the GSPMD step's
    numbers, bit for bit."""
    for plain, tp in zip(port["model1"], port["model1-tp"]):
        (_, (grads, logs, state, launched, *_)), = plain
        (_, (grads_tp, logs_tp, state_tp, launched_tp, *_)), = tp
        assert logs == logs_tp and launched == launched_tp
        assert all(np.array_equal(grads[k], grads_tp[k]) for k in grads)
        assert all(np.array_equal(state[k], state_tp[k]) for k in state)
