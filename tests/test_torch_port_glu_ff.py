"""The port's K4 (the fused GLU + depthwise conv + folded BatchNorm + GELU)
and ``PreNormDWConvFF(ff_impl="fused")`` against the JAX package's, in f32
on the CPU.

- The plain version against ``xla_glu_dwconv_bn_gelu`` and against the
  Pallas kernel in interpret mode at 1e-5 (the kernel's erf polynomial is
  within 1.5e-7 of erf); its gradients with respect to ab, w, s and t (the
  autograd Function recomputing the composite) against ``jax.vjp`` of both
  at 1e-4 of the larger of 1 and the reference's largest magnitude.
- The module: in eval mode, with perturbed running statistics, against
  JAX's ``ff_impl="pallas_interpret"`` at 1e-5; in training mode the
  unfused path (batch statistics) is kept, on both sides; inside a
  BatchNorm freeze scope in training mode the fused path runs, and the
  output, the input's gradient and every parameter's gradient agree with
  JAX's under its own freeze scope at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.checkpoint import KeyAccountant, _dwconv_ff
from mde_tpu.ops import tnn as jax_tnn
from mde_tpu.ops.mlp import PreNormDWConvFF as JaxFF
from mde_tpu.ops.pallas.glu_ff import fused_glu_dwconv_bn_gelu, xla_glu_dwconv_bn_gelu
from mde_tpu_torch.ops import kernels, tnn
from mde_tpu_torch.ops.kernels.glu_ff import glu_ff, plain_glu_ff
from mde_tpu_torch.ops.mlp import PreNormDWConvFF
from test_torch_port_modules import _randomize

TOL = 1e-5
GRAD_TOL = 1e-4


def _max_abs(a, b) -> float:
    a = a.detach().cpu().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.max(np.abs(a.astype(np.float64) - np.asarray(b, np.float64))))


def _rel(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return _max_abs(a, b) / max(1.0, float(np.max(np.abs(np.asarray(b)))))


def _case(shape, k, seed=0):
    """(ab, w, s, t, g) for an x of ``shape``: ab has 2C channels."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    ab = rng.randn(*shape[:3], 2 * c).astype(np.float32)
    w = rng.randn(k, k, c).astype(np.float32)
    s, t = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    return ab, w, s, t, rng.randn(*shape).astype(np.float32)


CASES = [((2, 16, 24, 8), 5), ((1, 9, 13, 16), 3)]


@pytest.mark.parametrize("shape,k", CASES)
def test_glu_ff_plain_matches_jax(shape, k):
    ab, w, s, t, _ = _case(shape, k)
    ours = plain_glu_ff(*(torch.from_numpy(a) for a in (ab, w, s, t)))
    j = [jnp.asarray(a) for a in (ab, w, s, t)]
    assert _max_abs(ours, xla_glu_dwconv_bn_gelu(*j)) <= TOL
    assert _max_abs(ours, fused_glu_dwconv_bn_gelu(*j, impl="pallas_interpret")) <= TOL
    # the wrapper takes the plain version for CPU tensors
    kernels.reset_launch_counts()
    assert torch.equal(glu_ff(*(torch.from_numpy(a) for a in (ab, w, s, t))), ours)
    assert not any(kernels.launch_counts.values())


@pytest.mark.parametrize("shape,k", CASES)
def test_glu_ff_grads_match_jax(shape, k):
    ab, w, s, t, g = _case(shape, k, seed=1)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (ab, w, s, t)]
    glu_ff(*inputs).backward(torch.from_numpy(g))
    for fn in (xla_glu_dwconv_bn_gelu,
               lambda *a: fused_glu_dwconv_bn_gelu(*a, impl="pallas_interpret")):
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (ab, w, s, t)))
        for name, o, r in zip(("dab", "dw", "ds", "dt"), inputs, vjp(jnp.asarray(g))):
            assert _rel(o.grad, r) <= GRAD_TOL, (name, _rel(o.grad, r))


def _ff_pair(seed):
    """A port FF with seeded weights and perturbed running statistics, and
    the JAX FF's variables converted from it."""
    mod = PreNormDWConvFF(8, feedforward_dims=16, ff_impl="fused")
    params, stats = _dwconv_ff(KeyAccountant(_randomize(mod, seed)), "m")
    return mod, {"params": params, "batch_stats": stats}


def _jax_ff(impl="pallas_interpret"):
    return JaxFF(feedforward_dims=16, ff_impl=impl)


def test_fused_ff_eval_matches_jax():
    mod, variables = _ff_pair(2)
    x = np.random.RandomState(3).randn(2, 12, 16, 8).astype(np.float32)
    ref = _jax_ff().apply(variables, jnp.asarray(x))
    assert _max_abs(mod.eval()(torch.from_numpy(x)), ref) <= TOL
    # the unfused path gives the same function
    assert _max_abs(_jax_ff("xla").apply(variables, jnp.asarray(x)), ref) <= TOL
    mod.ff_impl = "auto"
    assert _max_abs(mod(torch.from_numpy(x)), ref) <= TOL


def test_fused_ff_training_keeps_the_unfused_path():
    mod, variables = _ff_pair(4)
    x = np.random.RandomState(5).randn(2, 12, 16, 8).astype(np.float32)
    kernels.reset_launch_counts()
    ours = mod.train()(torch.from_numpy(x))
    ref, upd = _jax_ff().apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
    assert _max_abs(ours, ref) <= TOL
    assert _max_abs(mod.bn2.running_var, upd["batch_stats"]["bn2"]["var"]) <= 1e-6
    # batch statistics: the running ones moved; the fused path would not move them
    assert _max_abs(mod.bn2.running_mean, variables["batch_stats"]["bn2"]["mean"]) > 1e-3


def test_fused_ff_in_freeze_scope_matches_jax_with_gradients():
    mod, variables = _ff_pair(6)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 16, 8).astype(np.float32)
    g = rng.randn(2, 12, 16, 8).astype(np.float32)

    def jax_loss(params, x):
        with jax_tnn.bn_freeze_scope():
            y, _ = _jax_ff().apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   x, train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * g), y

    (_, ref), (gp, gx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    mod.train()
    tx = torch.from_numpy(x).requires_grad_()
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    with tnn.bn_freeze_scope(mod):
        out = mod(tx)
        out.backward(torch.from_numpy(g))
    assert _max_abs(out, ref) <= TOL
    assert _rel(tx.grad, gx) <= GRAD_TOL
    # the parameters' gradients in JAX's tree, through the JAX converter
    grads = {f"m.{n}": p.grad.numpy() for n, p in mod.named_parameters()}
    grads.update({f"m.{n}": np.zeros(b.shape, np.float32) for n, b in mod.named_buffers()
                  if n.startswith("bn2.running")})
    ours, _ = _dwconv_ff(KeyAccountant(grads), "m")
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(gp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ours):
        assert _rel(leaf, ref_leaves[path]) <= GRAD_TOL, jax.tree_util.keystr(path)
    # frozen: the running statistics did not move
    for name in ("bn2.running_mean", "bn2.running_var"):
        assert torch.equal(mod.state_dict()[name], before[name])


def test_unknown_ff_impl_raises():
    mod = PreNormDWConvFF(8, ff_impl="pallas")
    with pytest.raises(ValueError, match="ff_impl"):
        mod(torch.zeros(1, 4, 4, 8))
