"""The port's spans (``mde_tpu_torch/utils/profiling.py``) and its backward
kernel entries as operators, on the CPU.

- With no profile recording, ``span`` and ``count`` record nothing and
  allocate nothing.
- Under ``profiling.trace``, a tiny flagship's recomputing train step and
  a ``Predictor.predict`` call give the span tree the layers promise: one
  top-level span a call whose identifier every span inside shares, the
  phases under it, the recompute's replays under the backward, the
  counters, and the same names as ``user_annotation`` events of the
  Chrome trace.
- A tiny NeW CRFs served under a profile: its encoder, PSP, four CRF stage
  and head spans in order under ``mde.serve.forward``, each stage's
  ``tokens`` and ``pad_tokens`` from its map's shape; served without one,
  no span and the same bits.
- Each of the six backward operators (``torch.ops.mde.*_bwd``,
  ``depthwise_conv2d_dxdw``, ``depthwise_conv2d_dw``) exists, its fake
  gives the shapes and dtypes of its outputs, and it and the gradient
  through its ``autograd.Function`` give the plain backward's bits.
"""

import contextlib
import itertools
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mde_tpu_torch.models import build_model
from mde_tpu_torch.ops.kernels import channel_attention as ca
from mde_tpu_torch.ops.kernels import depthwise as dw
from mde_tpu_torch.ops.kernels import ordered_attention as oa
from mde_tpu_torch.ops.kernels import window_attention as wa
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import make_train_step
from mde_tpu_torch.utils import profiling
from _torch_port_threads import one_torch_thread  # noqa: F401

CFG = dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32, num_heads=4,
           num_repeats=1, num_emb=16, window_size=4, neck_type="red33")
ENC = dict(embed_dim=16, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4)
OPT = {"model": dict(CFG),
       "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True, "si_weight": 1.0},
       "optimizer": {"lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 0.1, "eps": 1e-6,
                     "same_lr": True},
       "scheduler": {"name": "onecycle", "pct_start": 0.25, "div_factor": 25,
                     "final_div_factor": 100},
       "train": {"grad_norm": 0.1}}
# checkpointed calls of the tiny flagship: six Swin blocks and one head repeat
REPLAYS = 7


def _peak_bytes(loop) -> int:
    """The most memory the interpreter held at once for ``loop`` (a
    function of an iterator) over 1000 turns, over what it held before."""
    repeat = itertools.repeat(None, 1000)
    tracemalloc.start()
    try:
        start = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(repeat)
        return tracemalloc.get_traced_memory()[1] - start
    finally:
        tracemalloc.stop()


def test_span_off_records_and_allocates_nothing():
    """With no profile recording, 1000 spans with a counter each hold no
    more memory at their peak than 1000 ``with`` statements over a null
    context (CPython binds each ``__exit__``), and record nothing."""
    assert not torch._C._autograd._profiler_enabled()
    profiling.spans()
    null = contextlib.nullcontext()

    def spans(repeat):
        for _ in repeat:
            with profiling.span("mde.test"):
                profiling.count("n", 1)

    def nulls(repeat):
        for _ in repeat:
            with null:
                pass

    spans(itertools.repeat(None, 10))
    nulls(itertools.repeat(None, 10))
    assert _peak_bytes(spans) == _peak_bytes(nulls)
    assert profiling.span("a") is profiling.span("b")
    assert profiling.dropped() == 0 and profiling.spans() == []


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One recomputing train step and one serving call of the tiny flagship
    under ``profiling.trace``: (the spans, the Chrome trace's
    ``user_annotation`` names)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MDE_REMAT_POLICY", "save_sa_conv")
        model = build_model(CFG, 0.001, 80.0, device="cpu", seed=0, resize_to_multiple=False,
                            encoder_kwargs=ENC, use_checkpoint=True)
        state = TrainState.create(model, OPT, 100)
        step = make_train_step(OPT, 0.001, 80.0)
        rng = np.random.RandomState(0)
        batch = {"image": rng.rand(2, 32, 64, 3).astype(np.float32),
                 "depth": rng.uniform(0.5, 60.0, (2, 32, 64, 1)).astype(np.float32)}
        log_dir = str(tmp_path_factory.mktemp("trace"))
        profiling.spans()
        with profiling.trace(log_dir):
            step(state, batch)
            Predictor(model).predict(batch["image"][:1])
        records = profiling.spans()
    with open(os.path.join(log_dir, os.listdir(log_dir)[0])) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    return records, names


def _tree(records, top):
    """The records of the call whose top-level span is ``top``, and that
    span."""
    (root,) = [r for r in records if r["name"] == top]
    return [r for r in records if r["call"] == root["call"]], root


def test_step_spans(traced):
    records, _ = traced
    assert [r["name"] for r in records if r["parent"] is None] == ["mde.train.step",
                                                                    "mde.serve.predict"]
    call, root = _tree(records, "mde.train.step")
    children = [r["name"] for r in call if r["parent"] == root["id"]]
    assert children == ["mde.train.h2d", "mde.train.forward", "mde.train.loss",
                        "mde.train.backward", "mde.train.optimizer"]
    assert root["counters"] == {"images": 2}
    assert len({r["call"] for r in records}) == 2
    for r in call:
        assert r["device_ms"] is None and 0 <= r["self_ms"] <= r["host_ms"]
        assert r["host_start_ns"] >= root["host_start_ns"]
        assert r["host_end_ns"] <= root["host_end_ns"]
    covered = sum(r["host_ms"] for r in call if r["parent"] == root["id"])
    assert root["self_ms"] == pytest.approx(root["host_ms"] - covered)


def test_replays_nest_under_the_backward(traced):
    call, _ = _tree(traced[0], "mde.train.step")
    (backward,) = [r for r in call if r["name"] == "mde.train.backward"]
    replays = [r for r in call if r["name"] == "mde.remat.replay"]
    assert len(replays) == REPLAYS
    assert all(r["parent"] == backward["id"] for r in replays)
    assert backward["self_ms"] == pytest.approx(
        backward["host_ms"] - sum(r["host_ms"] for r in replays))


def test_predict_spans(traced):
    call, root = _tree(traced[0], "mde.serve.predict")
    assert [r["name"] for r in call if r["parent"] == root["id"]] == [
        "mde.serve.h2d", "mde.serve.forward", "mde.serve.resize"]
    (h2d,) = [r for r in call if r["name"] == "mde.serve.h2d"]
    assert h2d["counters"] == {"h2d_bytes": 32 * 64 * 3 * 4}
    assert root["counters"] == {"images": 1}


def test_spans_are_the_traces_annotations(traced):
    records, names = traced
    assert sorted(n for n in names if n.startswith("mde.")) == sorted(r["name"] for r in records)


def _bwd_cases():
    """name -> (the op's inputs, the plain backward, the autograd route:
    the forward, its inputs, the indices of those that take a gradient (the
    op's outputs, in order) and the output's gradient)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    mask = torch.where(torch.rand((4, 16, 16), generator=g) < 0.2, -100.0, 0.0)
    bias = r(2, 16, 16)
    qkv, qk, v, dout = r(8, 16, 96), r(8, 16, 64), r(8, 16, 32), r(8, 16, 32)
    q, k = r(8, 16, 32), r(8, 16, 32)
    idx = torch.randint(0, 16, (8, 16), generator=g, dtype=torch.int32)
    table = r(31, 2, scale=0.1)
    x, gx, w = r(2, 8, 12, 16), r(2, 8, 12, 16), r(5, 5, 16, scale=0.2)
    cq, ckv, cdout = r(8, 16, 16), r(8, 16, 32), r(8, 16, 16)
    return {
        "window_attention_bwd": (
            (qkv, dout, bias, mask, 2, 0.25), wa.window_attention_bwd,
            (wa.window_attention, (qkv, bias, mask, 2, 0.25), (0, 1), dout)),
        "window_attention_qk_v_bwd": (
            (qk, v, dout, bias, mask, 2, 0.25), wa.window_attention_qk_v_bwd,
            (wa.window_attention_qk_v, (qk, v, bias, mask, 2, 0.25), (0, 1, 2), dout)),
        "ordered_attention_bwd": (
            (q, k, v, dout, idx, table, 2, 0.25, 16), oa.ordered_attention_bwd,
            (oa.ordered_attention, (q, k, v, idx, table, 2, 0.25, 16), (0, 1, 2, 4), dout)),
        "depthwise_conv2d_dxdw": (
            (x, gx, w), dw.depthwise_dxdw, (dw.depthwise_conv2d, (x, w), (0, 1), gx)),
        "depthwise_conv2d_dw": (
            (x, gx, w), dw.depthwise_dw, (dw.depthwise_conv2d, (x, w), (1,), gx)),
        "channel_attention_bwd": (
            (cq, ckv, cdout, 2, 0.25), ca.channel_attention_bwd,
            (ca.channel_attention, (cq, ckv, 2, 0.25), (0, 1), cdout)),
    }


BWD_OPS = ["window_attention_bwd", "window_attention_qk_v_bwd", "ordered_attention_bwd",
           "depthwise_conv2d_dxdw", "depthwise_conv2d_dw", "channel_attention_bwd"]


@pytest.mark.parametrize("name", BWD_OPS)
def test_backward_op_gives_the_plain_backwards_bits(name):
    args, plain, (forward, inputs, wanted, dout) = _bwd_cases()[name]
    op = getattr(torch.ops.mde, name)
    got, want = op(*args), plain(*args)
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    assert len(got) == len(want) == len(wanted)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    fake = (fake,) if torch.is_tensor(fake) else fake
    assert [(f.shape, f.dtype) for f in fake] == [(a.shape, a.dtype) for a in got]
    # the gradient through the autograd.Function, whose backward calls the op
    leaves = [a.detach().requires_grad_(i in wanted) if torch.is_tensor(a) else a
              for i, a in enumerate(inputs)]
    grads = torch.autograd.grad(forward(*leaves), [leaves[i] for i in wanted], dout)
    for grad, ref in zip(grads, got):
        assert torch.equal(grad, ref.to(grad.dtype))


@pytest.mark.parametrize("name,absent", [("window_attention_bwd", (2,)),
                                         ("ordered_attention_bwd", (4, 5))])
def test_backward_op_without_bias_returns_an_empty_gradient(name, absent):
    """Without K1's bias (or K2's indices and table) the op's last output
    is an empty f32 tensor where the plain backward returns None."""
    args, plain, _ = _bwd_cases()[name]
    args = tuple(None if i in absent else a for i, a in enumerate(args))
    got, want = getattr(torch.ops.mde, name)(*args), plain(*args)
    assert got[-1].shape == (0,) and got[-1].dtype == torch.float32 and want[-1] is None
    for a, b in zip(got[:-1], want[:-1]):
        assert torch.equal(a, b)


# a tiny NeW CRFs at window 7 on 62x90 frames: maps 16x23, 8x12, 4x6, 2x3
NEWCRFS = dict(name="newcrfs", version="custom07")
NEWCRFS_ENC = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4),
                   in_channels=(8, 16, 32, 64), crf_dims=(8, 16, 32, 64))


@pytest.fixture(scope="module")
def newcrfs_served():
    """The tiny NeW CRFs' depth for two frames: (untraced, traced, the
    spans of the traced call)."""
    model = build_model(NEWCRFS, 0.001, 80.0, device="cpu", seed=0,
                        encoder_kwargs=NEWCRFS_ENC)
    images = np.random.RandomState(1).rand(2, 62, 90, 3).astype(np.float32)
    predictor = Predictor(model)
    profiling.spans()
    plain = predictor.predict(images)
    assert profiling.spans() == []
    with profiling.profiler(host=True):
        traced = predictor.predict(images)
    return plain, traced, profiling.spans()


def test_newcrfs_spans_nest_under_the_forward(newcrfs_served):
    _, _, records = newcrfs_served
    (forward,) = [r for r in records if r["name"] == "mde.serve.forward"]
    inside = [r for r in records if r["parent"] == forward["id"]]
    assert [r["name"] for r in inside] == ["mde.newcrfs.encoder", "mde.newcrfs.psp"] + [
        "mde.newcrfs.crf"] * 4 + ["mde.newcrfs.head"]
    maps = [(2, 3), (4, 6), (8, 12), (16, 23)]  # crf3 first
    for r, (h, w) in zip(inside[2:6], maps):
        padded = (-(-h // 7) * 7) * (-(-w // 7) * 7)
        assert r["counters"] == {"tokens": 2 * h * w, "pad_tokens": 2 * (padded - h * w)}
    assert all(r["counters"] == {} for r in inside if r["name"] != "mde.newcrfs.crf")


def test_newcrfs_depth_is_the_same_traced(newcrfs_served):
    plain, traced, _ = newcrfs_served
    assert plain.shape == (2, 62, 90, 1) and torch.equal(plain, traced)
