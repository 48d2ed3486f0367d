"""The port's collectives (``mde_tpu_torch/core/dist.py``) against the JAX
package's (``mde_tpu/core/dist.py``): the cases of ``tests/test_dist.py``,
two gloo processes on the CPU (``_torch_port_dist.run_ranks``) against
JAX's ``shard_map`` over two of the eight host devices, and the identity
where no process group is live. Values are small integers: every result
is exact on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_port_dist as ranks
from mde_tpu.core import dist as jax_dist
from mde_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mde_tpu_torch.core import dist
from _torch_port_threads import one_torch_thread  # noqa: F401

WORLD = 2


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """What each of the two ranks computed (``_torch_port_dist.collectives``)."""
    return ranks.run_ranks(ranks.collectives, WORLD, tmp_path_factory.mktemp("dist"))


def _jax(fn, x):
    mesh = jax_make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    return np.asarray(jax.shard_map(fn, mesh=mesh, in_specs=(P("data"),), out_specs=P(),
                                    check_vma=False)(jnp.asarray(x)))


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "product"])
def test_all_reduce_ops_match_jax(port, op):
    ref = _jax(lambda x: jax_dist.all_reduce_tensor(x[0], op=op),
               np.arange(1, WORLD + 1, dtype=np.float32))
    for r in port:
        assert r[op] == float(ref)
        assert r["untouched"] == r["process_index"] + 1


def test_all_reduce_dict_and_scalar_mean_match_jax(port):
    ref = _jax(lambda x: jax_dist.all_reduce_dict({"m": x[0]}, op="mean")["m"],
               np.arange(WORLD, dtype=np.float32))
    assert [r["dict_mean"] for r in port] == [float(ref)] * WORLD
    assert [r["scalar_mean"] for r in port] == [float(ref)] * WORLD


def test_all_gather_concats_as_jax(port):
    data = np.arange(2 * WORLD, dtype=np.float32).reshape(WORLD, 2)
    ref = _jax(lambda x: jax_dist.all_gather_tensor(x, axis=0), data)
    for r in port:
        np.testing.assert_array_equal(r["gather"], ref)


def test_all_reduce_tensors_reduce_each_dtype(port):
    """The list form takes each dtype in one collective and gives every
    tensor back in its shape and dtype."""
    for r in port:
        np.testing.assert_array_equal(r["many"][0], np.full((2, 3), 3.0, np.float32))
        np.testing.assert_array_equal(r["many"][1], np.array([1], np.int64))
    assert [r["process_index"] for r in port] == list(range(WORLD))


def test_sum_over_ranks_sums_values_and_gradients(port):
    """``sum_over_ranks``: the sum of every rank's tensors, and each
    input's gradient the sum over the ranks of its output's (rank r's loss
    is (r + 1) * sum(s1) + s2, so x's gradient is the sum of r + 1 over
    the ranks, plus the ranks' number), two collectives in all."""
    total = sum(range(1, WORLD + 1))
    for r in port:
        s1, s2, grad, launched = r["sum_over_ranks"]
        np.testing.assert_array_equal(s1, np.array([1.0, 2.0], np.float32) * total)
        assert s2 == 3.0 * total
        np.testing.assert_array_equal(grad, np.full(2, total + WORLD, np.float32))
        assert launched == 2


def test_identity_without_a_process_group():
    """No process group: every collective gives its input (JAX's outside a
    mapped axis, ``tests/test_dist.py::test_identity_fallback_outside_mesh``)."""
    assert not dist.live()
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(dist.all_reduce_tensor(x, "sum"), x)
    assert float(dist.all_reduce_scalar(3.0, "mean")) == 3.0
    assert float(jax_dist.all_reduce_scalar(3.0, "mean")) == 3.0
    assert torch.equal(dist.all_gather_tensor(x), x)
    assert dist.all_reduce_dict({"a": x})["a"] is x
    assert dist.process_index() == 0 and dist.process_count() == 1 and dist.is_primary()
    y = x.clone().requires_grad_(True)
    (s,) = dist.sum_over_ranks([y])
    assert s is y
    from mde_tpu_torch.parallel.mesh import gspmd_scope, make_mesh
    with gspmd_scope(make_mesh("cpu")):  # no group: no global batch
        assert dist.global_batch() is None
    with pytest.raises(ValueError, match="Unsupported reduce op"):
        dist.all_reduce_tensor(x, "median")
