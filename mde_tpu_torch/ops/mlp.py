"""Feed-forward blocks (``mde_tpu/ops/mlp.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import dist
from ..parallel.mesh import MODEL_AXIS, Mesh
from .depthwise import DepthwiseConv2d
from .drop import Dropout
from .kernels.depthwise import depthwise_conv2d
from .kernels.glu_ff import glu_ff
from .remat import tag_conv, tag_glu
from .tnn import BatchNorm, LayerNorm, Linear, bn_use_running_average, gelu


class SwinMLP(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout (``mde_tpu/ops/mlp.py:68-85``)."""

    def __init__(self, dim: int, hidden: int, drop_prob: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(gelu(self.fc1(x)), generator)), generator)


class PreNormFF(nn.Module):
    """Pre-norm residual FF: LN -> lin1 -> GELU -> dropout -> lin2 ->
    dropout -> residual (``mde_tpu/ops/mlp.py:88-108``)."""

    def __init__(self, dim: int, feedforward_dims: Optional[int] = None,
                 drop_prob: float = 0.0):
        super().__init__()
        hidden = feedforward_dims or 4 * dim
        self.norm = LayerNorm(dim)
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.drop(gelu(self.lin1(self.norm(x))), generator)
        return self.drop(self.lin2(y), generator) + x


class PreNormDWConvFF(nn.Module):
    """Pre-norm GLU + depthwise-conv feed-forward on (B, H, W, C):
    LN -> lin1 -> a * sigmoid(b) -> 5x5 depthwise conv (kernel K3) ->
    BN -> GELU -> lin3 -> dropout -> residual (``mde_tpu/ops/mlp.py:111-202``).

    ``ff_impl``: ``"auto"`` (the default) keeps this unfused path, the JAX
    module's default. ``"fused"`` (JAX's ``'pallas'``) runs gate, conv,
    BatchNorm folded to an affine and exact-erf GELU in one pass (kernel K4)
    whenever BatchNorm normalises with its running statistics: in eval mode
    or inside an active ``bn_freeze_scope`` (JAX's ``fused_ok``, :176-178).
    With batch statistics the unfused path runs. In bf16 the two paths differ
    by about a bf16 ulp: the fused GELU is exact erf, the unfused one
    ``tnn.gelu``'s tanh form. The unfused path tags the gate's output and
    the conv for the recompute policies (``ops/remat.py``), as JAX's does
    (:195-196); the fused one, which runs only without batch statistics,
    takes no tag.

    ``tp_axis="model"`` (``mde_tpu/ops/mlp.py:145``): inside the GSPMD
    step's scope on a mesh whose model axis has n > 1 ranks
    (``parallel.mesh``), each rank computes its n-th of the hidden
    channels: ``lin1``'s rows of both GLU halves for its slice, the gate,
    the conv (K3 on hidden / n channels), ``bn2`` on them (statistics over
    the data group), GELU, and ``lin3``'s partial product over its slice,
    summed over the model group (``core.dist.sum_over_model``) before the
    bias is added once; the input's gradient through the slices is summed
    over the model group too (``core.dist.copy_to_model``). The parameters
    stay whole and replicated, as in JAX, where the axis constrains the
    activations' layout and not the numbers; the GSPMD step assembles the
    slices' gradients and statistics (:func:`tp_gather`). Elsewhere the
    option changes nothing."""

    FF_IMPLS = ("auto", "fused")

    def __init__(self, dim: int, feedforward_dims: Optional[int] = None,
                 kernel_size: int = 5, bn_eps: float = 1e-5, ff_impl: str = "auto",
                 drop_prob: float = 0.0, bn_momentum: float = 0.1,
                 tp_axis: Optional[str] = None):
        super().__init__()
        hidden = feedforward_dims or 4 * dim
        self.ff_impl = ff_impl
        self.tp_axis = tp_axis
        self.norm = LayerNorm(dim)
        self.lin1 = Linear(dim, 2 * hidden)
        self.conv2 = DepthwiseConv2d(hidden, kernel_size)
        self.bn2 = BatchNorm(hidden, eps=bn_eps, momentum=bn_momentum)
        self.lin3 = Linear(hidden, dim)
        self.drop = Dropout(drop_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.ff_impl not in self.FF_IMPLS:
            raise ValueError(f"ff_impl {self.ff_impl!r}: expected one of {self.FF_IMPLS}")
        mesh = self.tp_mesh()
        if mesh is not None:
            return self._tp_forward(x, mesh, generator)
        ab = self.lin1(self.norm(x))
        if self.ff_impl == "fused" and bn_use_running_average(self.bn2):
            bn = self.bn2
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            t = bn.bias - bn.running_mean * s
            y = glu_ff(ab, self.conv2.kernel(ab.dtype), s, t)
        else:
            a, b = ab.chunk(2, dim=-1)
            g = tag_glu((a * torch.sigmoid(b)).contiguous())
            y = gelu(self.bn2(tag_conv(self.conv2, g)))
        return self.drop(self.lin3(y), generator) + x

    def tp_mesh(self) -> Optional[Mesh]:
        """The mesh whose model group splits this FF's hidden channels in
        the current call, or None."""
        mesh = dist.global_batch()
        if self.tp_axis != MODEL_AXIS or mesh is None or mesh.model_size == 1:
            return None
        return mesh

    def tp_channels(self, mesh: Mesh) -> slice:
        """This rank's slice of the hidden channels."""
        hidden = self.bn2.num_features
        if hidden % mesh.model_size:
            raise ValueError(f"{hidden} hidden channels do not split over {mesh.model_size} "
                             f"ranks of the model axis")
        part = hidden // mesh.model_size
        return slice(mesh.model_rank * part, (mesh.model_rank + 1) * part)

    def _tp_forward(self, x: torch.Tensor, mesh: Mesh,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """The FF on this rank's slice of the hidden channels (class
        docstring); the unfused path, as JAX's under ``tp_axis``."""
        hidden = self.bn2.num_features
        sl = self.tp_channels(mesh)
        dt = x.dtype
        xn = dist.copy_to_model(self.norm(x), mesh.model_group)
        w1 = torch.cat([self.lin1.weight[sl], self.lin1.weight[hidden + sl.start:hidden + sl.stop]])
        b1 = torch.cat([self.lin1.bias[sl], self.lin1.bias[hidden + sl.start:hidden + sl.stop]])
        a, b = F.linear(xn, w1.to(dt), b1.to(dt)).chunk(2, dim=-1)
        g = tag_glu((a * torch.sigmoid(b)).contiguous())
        w = self.conv2.kernel(dt)[..., sl].contiguous()
        y = gelu(self.bn2(tag_conv(depthwise_conv2d, g, w), sl))
        partial = F.linear(y, self.lin3.weight[:, sl].to(dt))
        out = dist.sum_over_model(partial, mesh.model_group) + self.lin3.bias.to(dt)
        return self.drop(out, generator) + x


def tp_gather(model: nn.Module, mesh: Mesh, grads: dict) -> Tuple[List[str], List[str]]:
    """After a GSPMD step's backward on a mesh with a model axis: put each
    tensor-parallel FF's ``bn2`` running statistics together from the
    ranks of the model group, each its slice (one collective: the rest
    zeroed, summed), and return (the names in ``grads`` that the FFs'
    slices computed, the rest). A sliced parameter's gradient is zero
    outside this rank's slice; the sum over every rank assembles it."""
    ffs = [(name, m) for name, m in model.named_modules()
           if isinstance(m, PreNormDWConvFF) and m.tp_axis == MODEL_AXIS]
    if mesh.model_size == 1 or not ffs:
        return [], list(grads)
    buffers = [t for _, ff in ffs for t in (ff.bn2.running_mean, ff.bn2.running_var)]
    parts = []
    for _, ff in ffs:
        sl = ff.tp_channels(mesh)
        for t in (ff.bn2.running_mean, ff.bn2.running_var):
            part = torch.zeros_like(t)
            part[sl] = t[sl]
            parts.append(part)
    with torch.no_grad():
        for t, whole in zip(buffers, dist.all_reduce_tensors(parts, "sum", mesh.model_group)):
            t.copy_(whole)
    sliced = {f"{name}.{p}" for name, _ in ffs
              for p in ("lin1.weight", "lin1.bias", "conv2.weight", "bn2.weight", "bn2.bias",
                        "lin3.weight")}
    return [n for n in grads if n in sliced], [n for n in grads if n not in sliced]
