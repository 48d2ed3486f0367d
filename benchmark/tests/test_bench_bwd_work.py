"""The backward kernel ops' work counts and the readers of the metrics
that read the program's backward ops and spans, on the CPU.

- Each backward op's bytes and operations equal ``chip_smoke.py``'s count
  at the shapes of its backward phases (meta tensors: the counts need
  shapes and dtypes only). Where a phase of ``chip_smoke.py`` leaves the
  bias and mask reads out of K1's bytes (the q|k + v entry, the ODA
  stage), the work module counts them, as the flagship's phase and the
  forward ops' counts do.
- The K2 + K3 backward share pairs each call with its pass's launch and,
  for K3, with the launch of the reduction of its partial sums, whose
  time it counts; a call without its launch gives nothing.
- The span readers split the program's spans between the traced run's
  two stretches, the card-only one first, read the card-only one, write
  the phase table to the log, and give nothing where the program records
  no spans.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.run import Record
from benchmark.tests.test_bench_work import dims_types, nbytes
from benchmark.trace import STRETCH, Trace

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def k1_case(bw, n, c, heads, nw, fused=True):
    """K1 backward's inputs at one of ``chip_smoke.py``'s shapes and its
    count there: the inputs read once, the gradients written once."""
    bias, mask = meta(heads, n, n, dtype=F32), meta(nw, n, n, dtype=F32)
    dout = meta(bw, n, c)
    if fused:
        qkv = meta(bw, n, 3 * c)
        return ((qkv, dout, bias, mask),
                nbytes(qkv, dout, bias, mask, qkv, bias), 10 * bw * n * n * c)
    qk, v = meta(bw, n, 2 * c), meta(bw, n, c)
    return ((qk, v, dout, bias, mask),
            nbytes(qk, v, dout, qk, v, bias) + nbytes(bias, mask), 10 * bw * n * n * c)


def k2_case(with_table):
    bw, n, c, heads, e = 392 * 4, 64, 512, 8, 128
    q = meta(bw, n, c)
    idx = meta(bw, n, dtype=I32) if with_table else None
    table = meta(2 * e - 1, heads, dtype=F32) if with_table else None
    return ((q, q, q, q, idx, table),
            nbytes(q, q, q, q, idx, table, q, q, q, table), 10 * bw * n * n * c)


def k3_case(dxdw):
    x, w = meta(4, 112, 224, 2048), meta(5, 5, 2048)
    dw = meta(5, 5, 2048, dtype=F32)
    if dxdw:
        return (x, x, w), nbytes(x, x, w, x, dw), 4 * 25 * x.numel()
    return (x, x, w), nbytes(x, x, dw), 2 * 25 * x.numel()


CASES = {
    # chip_smoke's window_bwd_phase at stages 1 and 3 of the flagship's step
    "K1 stage 1": ("window_attention_bwd", lambda: k1_case(512 * 4, 49, 128, 4, 512)),
    "K1 stage 3": ("window_attention_bwd", lambda: k1_case(32 * 4, 49, 512, 16, 32)),
    # oda_window_phase's backward at the ODA encoder's stage 1, both entries
    "K1 ODA stage 1": ("window_attention_bwd", lambda: k1_case(128 * 4, 144, 192, 6, 128)),
    "K1 q|k+v ODA stage 1": ("window_attention_qk_v_bwd",
                             lambda: k1_case(128 * 4, 144, 192, 6, 128, fused=False)),
    # window_qk_v_bwd_phase at NewCRFs' crf0
    "K1 q|k+v NewCRFs crf0": ("window_attention_qk_v_bwd",
                              lambda: k1_case(338 * 4, 49, 128, 4, 338, fused=False)),
    # ordered_bwd_phase with the table and bias-free
    "K2 with table": ("ordered_attention_bwd", lambda: k2_case(True)),
    "K2 bias-free": ("ordered_attention_bwd", lambda: k2_case(False)),
    # depthwise_bwd_phase, both entries
    "K3 dxdw": ("depthwise_conv2d_dxdw", lambda: k3_case(True)),
    "K3 dw": ("depthwise_conv2d_dw", lambda: k3_case(False)),
}


@pytest.mark.parametrize("case", CASES)
def test_backward_counts_are_chip_smokes(case):
    op, make = CASES[case]
    tensors, want_bytes, want_ops = make()
    work = harness.load_module("work", op)
    assert work.cost(*dims_types(*tensors)) == (want_bytes, want_ops)


# kernel names as the profiler records them
NAMES = {"dxdw": "void depthwise_dxdw_tiled_kernel<__nv_bfloat16, 5>(__nv_bfloat16 const*)",
         "gather_dw": "void depthwise_bwd_kernel<__nv_bfloat16, 2, 5, false>(float*)",
         "sum": "depthwise_sum_partials(float const*, float*, int, int)",
         "k2": "void ordered_attention_bwd_mma_kernel<4, 4>(__nv_bfloat16 const*)",
         "k3_fwd": "void depthwise_tiled_kernel<__nv_bfloat16, 5>(__nv_bfloat16 const*)",
         "k1": "void window_attention_bwd_wide_kernel<2>(__nv_bfloat16 const*)"}


def make_trace(ops, kernels):
    """A host stretch of ``ops`` ((name, tensors) each, 1 us apart) and
    ``kernels`` ((name, us) each) in a Chrome trace's events."""
    events = [{"name": STRETCH, "ph": "X", "cat": "user_annotation", "ts": 0, "dur": 1000}]
    for i, (name, tensors) in enumerate(ops):
        dims, types = dims_types(*tensors)
        events.append({"name": name, "ph": "X", "cat": "cpu_op", "ts": 10 + i, "dur": 0.5,
                       "args": {"Input Dims": dims, "Input type": types}})
    for i, (name, us) in enumerate(kernels):
        events.append({"name": NAMES[name], "ph": "X", "cat": "kernel", "ts": 100 + 10 * i,
                       "dur": us})
    return Trace(events, 1, 1e-3, own_syncs=1)


def test_k2_k3_backward_share_counts_the_reductions():
    reader = harness.metric_reader("k2_k3_bwd_roofline.train")
    q_args, q_bytes, q_ops = k2_case(True)
    x_args, x_bytes, x_ops = k3_case(True)
    w_args, w_bytes, w_ops = k3_case(False)
    ops = [("mde::ordered_attention_bwd", q_args), ("mde::depthwise_conv2d_dxdw", x_args),
           ("mde::depthwise_conv2d_dw", w_args)]
    peaks = harness.load_json("work", "peaks")
    least = sum(max(b / peaks["hbm_bytes_per_s"], f / peaks["bf16_flops_per_s"])
                for b, f in ((q_bytes, q_ops), (x_bytes, x_ops), (w_bytes, w_ops)))
    kernels = [("k2", 300.0), ("dxdw", 500.0), ("sum", 20.0), ("gather_dw", 200.0),
               ("sum", 10.0), ("k3_fwd", 400.0), ("k1", 90.0)]
    share, note = reader.share(make_trace(ops, kernels), reader.OPS)
    assert share == pytest.approx(100.0 * least / 1030e-6)
    assert note == "bytes bound on 3 of 3 calls"
    # a reduction, or a pass, with no call to pair with: nothing
    assert reader.share(make_trace(ops, kernels + [("sum", 5.0)]), reader.OPS) is None
    assert reader.share(make_trace(ops[:1], kernels[:1] + [("dxdw", 5.0)]),
                        reader.OPS) is None


def span(name, call, device_ms, parent=None, counters=None):
    return {"name": name, "id": 0, "parent": parent, "call": call, "host_ms": 2.0 * device_ms,
            "self_ms": device_ms, "device_ms": device_ms, "counters": counters or {}}


class Stretch:
    def __init__(self, calls):
        self.calls = calls


def record(monkeypatch, records=None, card_calls=2, host_calls=1):
    """A traced run's record whose program's ``spans()`` gives ``records``
    (a program that records no spans where None)."""
    from mde_tpu_torch.utils import profiling
    if records is None:
        monkeypatch.delattr(profiling, "spans")
    else:
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    rec = Record("flagship.train.b4", {}, {}, {})
    rec.device_trace, rec.trace = Stretch(card_calls), Stretch(host_calls)
    return rec


def test_span_readers_read_the_card_only_stretch(monkeypatch):
    # a call left over before the stretches, two card-only steps, one host step
    records = []
    for call, scale in ((7, 100.0), (8, 1.0), (9, 3.0), (10, 50.0)):
        records += [span("mde.remat.replay", call, 2.0 * scale, parent=1),
                    span("mde.remat.replay", call, 1.0 * scale, parent=1),
                    span("mde.train.optimizer", call, 5.0 * scale, parent=1),
                    span("mde.train.step", call, 20.0 * scale, counters={"images": 4})]
    rec = record(monkeypatch, records)
    values = {m: harness.metric_reader(m).read(m, rec)
              for m in ("optimizer_ms.train", "replay_ms.train", "h2d_ms.serve")}
    assert values == {"optimizer_ms.train": pytest.approx(10.0),
                      "replay_ms.train": pytest.approx(6.0), "h2d_ms.serve": None}
    lines = [n for n in rec.notes if n.startswith("spans")]
    assert len(lines) == 6
    assert "spans, card stretch: mde.remat.replay x2: host 12.000 ms, self 6.000, " \
           "device 6.000" in lines
    assert "spans, host stretch: mde.train.step x1: host 2000.000 ms, self 1000.000, " \
           "device 1000.000, images 4" in lines


def test_span_readers_give_nothing_without_spans(monkeypatch):
    # fewer calls than the two stretches made
    rec = record(monkeypatch, [span("mde.train.optimizer", 1, 5.0)])
    assert harness.metric_reader("optimizer_ms.train").read("optimizer_ms.train", rec) is None
    rec = record(monkeypatch)
    assert harness.metric_reader("optimizer_ms.train").read("optimizer_ms.train", rec) is None
