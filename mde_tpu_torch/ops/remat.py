"""Recompute of checkpointed blocks under JAX's policies
(``mde_tpu/ops/remat.py``).

A checkpointed block (a Swin block, an ordered head repeat) keeps its
inputs and the tensors its policy names, drops every other tensor its
backward needs, and runs its forward again in the backward pass to get
them back. ``MDE_REMAT_POLICY`` names the policy, as in the JAX package,
read at each checkpointed call:

- ``full``: the inputs only;
- ``save_sa``: also the attention sublayers' outputs (``tag_sa``);
- ``save_sa_conv`` (the default, and any value that names no policy):
  also the FF depthwise convs' outputs (``tag_conv``);
- ``save_sa_conv_glu``: also the GLU gates' outputs, the convs' inputs
  (``tag_glu``).

The mechanism. The first forward runs under saved-tensor hooks. A tensor
that an op saves is kept where it is a view of a kept tensor (an input, or
an output tagged with a name the policy saves) or of a parameter or
buffer; any other is dropped and stands as its place in the order of
saves. The first time the backward asks for a dropped tensor, the block
runs once more from its inputs (the replay) and every dropped tensor is
taken from the replay at the same place. A tagged call whose output is
saved (``tag_conv``) does not run in the replay: its saved output stands
in, and the tensors the call saved are the replay's views of its
arguments. So under ``save_sa_conv`` a depthwise conv (kernel K3) runs
once a step, and its backward takes the recomputed GLU output. The
attentions run again under every policy: the projection after each needs
the attention's output for its weight gradient, and no policy saves it
(nor does JAX's). The kept tensors are saved once more by an identity
node on the block's output, so a caller's saved-tensor hooks see every
tensor a checkpoint keeps.

Two things a replay must not change: the random masks, and the BatchNorm
running statistics, which the first forward already updated. While the
block replays, its BatchNorms use batch statistics without updating them.
A caller draws per-sample masks outside the block and passes them in
(``ops/drop.py``); a block that draws element-wise dropout masks from a
``generator`` draws them from a copy of the generator's state, taken
before the block, both times. A block that draws from the global
generators (``generator`` None) replays from their states as the first
forward found them: the CPU's, and those of the CUDA devices that hold its
inputs, as ``torch.utils.checkpoint`` does. The replay runs under
``torch.random.fork_rng``, so it leaves the global generators where the
step left them, however early it ends.

One backward pass runs through a checkpointed call: the backward takes
each recomputed tensor once, and it is released then. Under a
``torch.profiler`` profile each replay is the span ``mde.remat.replay``,
inside the train step's ``mde.train.backward`` (``utils.profiling``).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import span
from .tnn import BatchNorm

POLICIES: Dict[str, FrozenSet[str]] = {
    "full": frozenset(),
    "save_sa": frozenset({"sa_out"}),
    "save_sa_conv": frozenset({"sa_out", "dw_conv"}),
    "save_sa_conv_glu": frozenset({"sa_out", "dw_conv", "glu_out"}),
}
DEFAULT_POLICY = "save_sa_conv"


def remat_policy() -> FrozenSet[str]:
    """The names a checkpointed block saves under ``MDE_REMAT_POLICY``
    (none for ``full``); a value that names no policy gives the default,
    ``save_sa_conv``, as in JAX."""
    mode = os.environ.get("MDE_REMAT_POLICY", DEFAULT_POLICY)
    return POLICIES.get(mode, POLICIES[DEFAULT_POLICY])


@contextlib.contextmanager
def _replaying(block: nn.Module):
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.replaying = True
    try:
        yield
    finally:
        for m in norms:
            m.replaying = False


# the checkpointed call whose forward or replay runs in this thread
_active = threading.local()


def _current() -> Optional["_Checkpoint"]:
    return getattr(_active, "call", None)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _view(t: torch.Tensor, base: torch.Tensor) -> tuple:
    """``t`` as a view of ``base``: its shape, strides and offset from
    ``base``'s."""
    return tuple(t.shape), t.stride(), t.storage_offset() - base.storage_offset()


def _as_view(base: torch.Tensor, view: tuple) -> torch.Tensor:
    shape, stride, offset = view
    return base.detach().as_strided(shape, stride, base.storage_offset() + offset)


def _tensors(args) -> List[torch.Tensor]:
    """The tensors of ``args``, tuples and lists entered, in order."""
    out = []
    for a in args:
        if torch.is_tensor(a):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(_tensors(a))
    return out


_SLOT = object()  # a tensor's place in a checkpointed call's arguments


def _rebuild(args, tensors):
    """``args`` with its tensors (or slots), in ``_tensors``' order, taken
    from the iterator ``tensors``."""
    out = []
    for a in args:
        if torch.is_tensor(a) or a is _SLOT:
            out.append(next(tensors))
        elif isinstance(a, (tuple, list)):
            out.append(type(a)(_rebuild(a, tensors)))
        else:
            out.append(a)
    return out


class _Stop(Exception):
    """Ends a replay once it has given every tensor the backward needs."""


class _Checkpoint:
    """One checkpointed call: what its first forward keeps and drops, its
    replay, and the tensors it hands to the backward."""

    def __init__(self, block: nn.Module, fn: Callable, args: tuple, saves: FrozenSet[str]):
        self.block, self.fn, self.saves = block, fn, saves
        inputs = _tensors(args)
        self.template = _rebuild(args, iter([_SLOT] * len(inputs)))
        self.n_inputs = len(inputs)
        self.kept: List[Optional[torch.Tensor]] = list(inputs)
        self.grad_flags = [t.requires_grad for t in inputs]
        self.cuda_devices = sorted({t.device.index for t in inputs if t.is_cuda})
        self.rng_states = (torch.get_rng_state(),
                           [torch.cuda.get_rng_state(d) for d in self.cuda_devices])
        self.kept_at = {_storage(t): j for j, t in enumerate(inputs)}
        self.fixed = {_storage(t) for t in (*block.parameters(), *block.buffers())}
        self.uses: Dict[int, int] = {}  # kept index -> saved views not yet unpacked
        self.dropped: Dict[int, tuple] = {}  # place -> (shape, dtype) of a dropped save
        self.replayed: Dict[int, torch.Tensor] = {}
        self.calls: List[Optional[list]] = []  # a skipped call's arguments, in the forward
        self.outputs: List[Tuple[int, bool]] = []  # its output's kept index, grad flag
        self.arg_uses: Dict[Tuple[int, int], int] = {}
        self.arg_values: Dict[Tuple[int, int], torch.Tensor] = {}
        self.count = 0  # saves so far, outside skipped calls
        self.in_call: Optional[int] = None
        self.replaying = self.done = False

    def run(self, args: tuple):
        with torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack):
            out = self._call(args)
        if not torch.is_tensor(out):
            raise TypeError(f"a checkpointed block returns one tensor, not {type(out)}")
        kept = [t.detach() for t in self.kept]
        self.kept, self.calls = [None] * len(kept), []
        return _Keep.apply(self, out, *kept)

    def _call(self, args: tuple):
        if _current() is not None:
            raise RuntimeError("checkpointed blocks do not nest")
        _active.call = self
        try:
            return self.fn(*args)
        finally:
            _active.call = None

    # -- the first forward and the replay --------------------------------
    def pack(self, t: torch.Tensor):
        if self.replaying:
            place, self.count = self.count, self.count + 1
            if place in self.dropped:
                if (tuple(t.shape), t.dtype) != self.dropped[place]:
                    raise RuntimeError(f"the replay of a checkpointed block saved a "
                                       f"{tuple(t.shape)} {t.dtype} tensor where its first "
                                       f"forward saved a {self.dropped[place]}")
                self.replayed[place] = t.detach()
            self._stop_when_done()
            return None
        ptr = _storage(t)
        if self.in_call is None:
            place, self.count = self.count, self.count + 1
        if ptr in self.fixed:
            return ("fixed", t.detach())
        j = self.kept_at.get(ptr)
        if j is not None and self.kept[j].dtype == t.dtype:
            self.uses[j] = self.uses.get(j, 0) + 1
            return ("kept", j, _view(t, self.kept[j]))
        if self.in_call is not None:
            for i, a in enumerate(self.calls[self.in_call]):
                if torch.is_tensor(a) and _storage(a) == ptr and a.dtype == t.dtype:
                    key = (self.in_call, i)
                    self.arg_uses[key] = self.arg_uses.get(key, 0) + 1
                    return ("arg", key, _view(t, a))
            # the call's own intermediate: the replay does not run the call
            return ("fixed", t.detach())
        self.dropped[place] = (tuple(t.shape), t.dtype)
        return ("replay", place)

    def keep(self, t: torch.Tensor) -> None:
        if not self.replaying:
            self.kept_at[_storage(t)] = len(self.kept)
            self.kept.append(t)

    def call(self, fn: Callable, args: tuple) -> torch.Tensor:
        """``fn(*args)``, whose output is kept: run in the first forward;
        in the replay its kept output stands in and its arguments are
        taken for the tensors the call saved."""
        if self.replaying:
            c = self.calls_seen
            self.calls_seen += 1
            self.arg_values.update({(c, i): a.detach() for i, a in enumerate(args)
                                    if (c, i) in self.arg_uses})
            j, grad = self.outputs[c]
            out = self.kept[j].detach().requires_grad_(grad)
            self._stop_when_done()
            return out
        c = self.in_call = len(self.calls)
        self.calls.append(list(args))
        try:
            out = fn(*args)
        finally:
            self.in_call = None
        self.outputs.append((len(self.kept), out.requires_grad))
        self.keep(out)
        return out

    def _stop_when_done(self) -> None:
        if self.count > self.last_place and self.calls_seen > self.last_call:
            raise _Stop

    # -- the backward ----------------------------------------------------
    def restore(self, kept) -> None:
        """The kept tensors, back from the identity node at the start of
        the block's backward."""
        self.kept = list(kept)
        for j in range(len(self.kept)):
            self._release(j)

    def unpack(self, packed) -> torch.Tensor:
        kind, key = packed[0], packed[1]
        if kind == "fixed":
            return key
        if kind == "kept":
            out = _as_view(self.kept[key], packed[2])
            self.uses[key] -= 1
            self._release(key)
            return out
        if not self.done:
            self._replay()
        if kind == "replay":
            if key not in self.replayed:
                raise RuntimeError("a checkpointed block is backpropagated through once")
            return self.replayed.pop(key)
        out = _as_view(self.arg_values[key], packed[2])
        self.arg_uses[key] -= 1
        if self.arg_uses[key] == 0:
            del self.arg_values[key]
        return out

    def _release(self, j: int) -> None:
        """Drop kept tensor ``j`` once no saved view of it is left to
        unpack and no replay still needs it (as an input, or as a skipped
        call's output)."""
        replay_needs = not self.done and (j < self.n_inputs or
                                          any(j == o for o, _ in self.outputs))
        if self.uses.get(j, 0) == 0 and not replay_needs:
            self.kept[j] = None

    def _replay(self) -> None:
        with span("mde.remat.replay"):
            self._run_replay()

    def _run_replay(self) -> None:
        inputs = [t.detach().requires_grad_(g)
                  for t, g in zip(self.kept[:self.n_inputs], self.grad_flags)]
        args = _rebuild(self.template, iter(inputs))
        self.last_place = max(self.dropped, default=-1)
        self.last_call = max((c for c, _ in self.arg_uses), default=-1)
        self.count, self.calls_seen, self.replaying = 0, 0, True
        try:
            with torch.random.fork_rng(devices=self.cuda_devices), torch.enable_grad(), \
                    _replaying(self.block), \
                    torch.autograd.graph.saved_tensors_hooks(self.pack, _never):
                cpu, cuda = self.rng_states
                torch.set_rng_state(cpu)
                for d, state in zip(self.cuda_devices, cuda):
                    torch.cuda.set_rng_state(state, d)
                self._call(args)
        except _Stop:
            pass
        finally:
            self.replaying = False
        self.done = True
        for j in range(len(self.kept)):
            self._release(j)


def _never(_):
    raise RuntimeError("a replay's own graph is never backpropagated through")


class _Keep(torch.autograd.Function):
    """Identity on a checkpointed block's output that saves the tensors
    the block keeps, and hands them back to it at the start of the
    block's backward."""

    @staticmethod
    def forward(ctx, call, out, *kept):
        ctx.call = call
        ctx.save_for_backward(*kept)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.call.restore(ctx.saved_tensors)
        return (None, grad) + (None,) * len(ctx.saved_tensors)


def _tag(name: str, x: torch.Tensor) -> torch.Tensor:
    call = _current()
    if call is not None and name in call.saves:
        call.keep(x)
    return x


def tag_sa(x: torch.Tensor) -> torch.Tensor:
    """Tag an attention sublayer's output (``sa_out``), kept by a
    checkpointed block under ``save_sa`` and the policies after it."""
    return _tag("sa_out", x)


def tag_glu(x: torch.Tensor) -> torch.Tensor:
    """Tag an FF's GLU gate output (``glu_out``, the depthwise conv's
    input), kept under ``save_sa_conv_glu``."""
    return _tag("glu_out", x)


def tag_conv(conv: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``conv(*args)``, an FF's depthwise conv, whose output is tagged
    ``dw_conv``. The port's tag takes the call, where JAX's takes its
    output: under a policy that keeps the output, a replay does not run
    the conv again, and it must know that before the call."""
    call = _current()
    if call is not None and "dw_conv" in call.saves:
        return call.call(conv, args)
    return conv(*args)


def checkpoint(block: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """``block(*args)``, or ``block(*args, generator)`` where a generator is
    given, recomputed in the backward pass under ``remat_policy()``. The
    first forward leaves ``generator`` where the block left it; the replay
    draws the same bits from the saved state and leaves it alone."""
    fn = block
    if generator is not None:
        state, first = generator.get_state(), [True]

        def fn(*a):
            g = torch.Generator(device=generator.device)
            g.set_state(state)
            out = block(*a, g)
            if first:
                generator.set_state(g.get_state())
                first.clear()
            return out
    return _Checkpoint(block, fn, args, remat_policy()).run(args)
