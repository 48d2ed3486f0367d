"""The optimizer's step on the card: optax's ``clip_by_global_norm`` +
``adamw`` over every parameter as one multi-tensor kernel trio
(``csrc/adamw.cu``), with the logged gradient and parameter norms.

It replaces no Pallas kernel: optax's chain ran under XLA in the JAX
package. The plain version is ``AdamW._plain_update``
(``mde_tpu_torch/train/optim.py``), foreach ops and ``global_norm``, which
``AdamW.update`` runs for CPU tensors; for CUDA tensors it runs
:class:`FusedAdamW`, here, or raises. A step is ``2 * windows + 1`` launches
(:func:`plan`): a norm pass and an update pass a window of ``MAX_TENSORS``
tensors, then one block that finishes the two norms: 3 for 23 of the
port's 27 models (the flagship's 520 tensors, oda_conv's 363), 5 for
depthformer_v6-v8 and oda_lime (678-754). Nothing is read back and nothing
is copied from the host: the clip is decided on the card, the scalars are
kernel arguments and the table of tensors travels in the kernel's
parameters.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _DTYPE_CODES, launch, ptr

# tensors one launch carries in its parameters (MAX_TENSORS in csrc/adamw.cu)
MAX_TENSORS = 640
# blocks an SM: each block takes one equal range of the concatenation, and
# the kernels' 64 registers a thread keep them all resident at once
BLOCKS_PER_SM = 4

# One window: tensors [t0, t1) of the optimizer's, of which [t0, u1) get an
# update.
Window = Tuple[int, int, int]


def plan(numels: Sequence[int], n_update: int) -> Tuple[np.ndarray, List[Window]]:
    """(offsets, windows) of tensors of ``numels`` elements, the first
    ``n_update`` of which get an update: each tensor's start in the
    concatenation, every tensor padded to a multiple of 4 elements so that
    each starts on a 16-byte vector (``len(numels) + 1`` entries, the last
    the total), and the windows of at most ``MAX_TENSORS`` tensors."""
    numel = np.asarray(numels, dtype=np.int64).reshape(-1)
    offsets = np.zeros(len(numel) + 1, dtype=np.int64)
    np.cumsum((numel + 3) // 4 * 4, out=offsets[1:])
    windows = [(t0, min(t0 + MAX_TENSORS, len(numel)),
                max(t0, min(t0 + MAX_TENSORS, len(numel), n_update)))
               for t0 in range(0, len(numel), MAX_TENSORS)]
    return offsets, windows


def launches(n_tensors: int) -> int:
    """Kernel launches of one step over ``n_tensors`` tensors."""
    return 2 * len(plan([0] * n_tensors, 0)[1]) + 1


def _check(kind: str, t: torch.Tensor, dtypes, device: torch.device) -> None:
    if t.dtype not in dtypes or t.device != device or not t.is_contiguous():
        raise ValueError(f"adamw: every {kind} must be a contiguous "
                         f"{' or '.join(map(str, dtypes))} tensor on {device}, got "
                         f"{t.dtype} on {t.device}{'' if t.is_contiguous() else ', strided'}")


class FusedAdamW:
    """The card's side of one ``AdamW``: a window's table of its tensors
    (an int64 array on the host, packed once: the gradients' pointers, left
    for each step, then the pointers of the parameters and moments, the
    sizes, the offsets and the encoder's flags; ``csrc/adamw.cu``'s
    ``unpack``), and :meth:`step`. ``params`` get the update, with moments
    ``mu`` (f32 or bf16) and ``nu`` (f32); the parameters at ``encoder``
    take ``encoder_scale``; ``rest`` (the BatchNorm parameters under
    ``zero_grad_bn``) get none but count in both norms. The tensors are
    updated in place and must stay the same tensors: the table holds their
    addresses."""

    def __init__(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], encoder: Sequence[int],
                 rest: Sequence[torch.Tensor]):
        tensors = [p.detach() for p in params] + [p.detach() for p in rest]
        self.device = tensors[0].device
        for t in tensors:
            _check("parameter", t, (torch.float32,), self.device)
        for m, v in zip(mu, nu):
            _check("first moment", m, (torch.float32, torch.bfloat16), self.device)
            _check("second moment", v, (torch.float32,), self.device)
        if len({m.dtype for m in mu}) > 1:
            raise ValueError("adamw: the first moments must share one dtype")
        self.mu_code = _DTYPE_CODES[mu[0].dtype if mu else torch.float32]
        self.numel = [t.numel() for t in tensors]
        offsets, self.windows = plan(self.numel, len(params))
        n = len(tensors)
        columns = np.zeros((7, n), dtype=np.int64)
        columns[1] = [t.data_ptr() for t in tensors]
        columns[2, :len(mu)] = [m.data_ptr() for m in mu]
        columns[3, :len(nu)] = [v.data_ptr() for v in nu]
        columns[4] = self.numel
        columns[6, list(encoder)] = 1
        self.tables = [np.concatenate([columns[:5, t0:t1].reshape(-1), offsets[t0:t1 + 1],
                                       columns[6, t0:t1]]) for t0, t1, _ in self.windows]
        sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        self.blocks = BLOCKS_PER_SM * sms
        self.stride = self.blocks * len(self.windows)

    def step(self, grads: Sequence[torch.Tensor], hyper: Sequence[float]) -> torch.Tensor:
        """One step from ``grads`` (f32, contiguous, in the order of
        ``params`` then ``rest``) and ``hyper``: b1, 1 - b1, b2, 1 - b2,
        1 - b1^t, 1 - b2^t, eps, weight decay, -lr, encoder_scale, max_norm
        (0: no clip). Returns a (2,) f32 tensor on the card: the gradients'
        norm before the clip, every tensor's, and the parameters' after."""
        if len(grads) != len(self.numel):
            raise ValueError(f"adamw: {len(grads)} gradients for {len(self.numel)} tensors")
        for g, n in zip(grads, self.numel):
            if g.numel() != n:
                raise ValueError(f"adamw: a gradient of {g.numel()} elements for a "
                                 f"parameter of {n}")
            _check("gradient", g, (torch.float32,), self.device)
        ptrs = [g.data_ptr() for g in grads]
        for (t0, t1, _), table in zip(self.windows, self.tables):
            table[:t1 - t0] = ptrs[t0:t1]
        partials = torch.empty(4 * self.stride, dtype=torch.float64, device=self.device)
        out = torch.empty(2, dtype=torch.float32, device=self.device)
        part = ptr(partials)
        # the entries copy the tables into their launches' parameters
        for w, ((t0, t1, u1), table) in enumerate(zip(self.windows, self.tables)):
            launch("adamw", "mde_adamw_norm", self.device, table.ctypes.data, t1 - t0, u1 - t0,
                   part, self.blocks, w * self.blocks, self.stride)
        for w, ((t0, t1, u1), table) in enumerate(zip(self.windows, self.tables)):
            launch("adamw", "mde_adamw_update", self.device, table.ctypes.data, t1 - t0,
                   u1 - t0, part, self.blocks, w * self.blocks, self.stride, *hyper,
                   self.mu_code)
        launch("adamw", "mde_adamw_finish", self.device, part, self.stride, ptr(out))
        return out
