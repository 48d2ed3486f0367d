"""The frozen work counts against ``torch.utils.flop_counter.FlopCounterMode``
over the reference at small sizes, the flagship's against its published
2.0107 TFLOP an image at 352x704 (and the program's own hand model), and
each op's bytes against the tensors of a call."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, reference
from benchmark.reference.layers import Numerics, attend
from benchmark.tests.test_bench_reference import TINY, tiny_config
from benchmark.work import flagship, oda_conv

FLAGSHIP = harness.load_json("configs", "flagship")["model"]
ODA = harness.load_json("configs", "oda_conv")["model"]


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_flagship_published_count():
    assert flagship.forward_flops(FLAGSHIP, 352, 704) == pytest.approx(2.0107e12, rel=1e-4)


@pytest.mark.parametrize("hw", [(352, 704), (352, 1216), (480, 640)])
def test_flagship_count_is_the_programs(hw):
    from mde_tpu_torch.utils.flops import flagship_forward_flops
    assert flagship.forward_flops(FLAGSHIP, *hw) == flagship_forward_flops(*hw)


def test_oda_conv_count_at_the_cells_size():
    # Swin-L/384 at 384x768 is 0.4157 TFLOP; the decoder adds its convs
    assert oda_conv.forward_flops(ODA, 352, 704) == pytest.approx(0.51172e12, rel=1e-4)


@pytest.mark.parametrize("name,work", [("flagship", flagship), ("oda_conv", oda_conv)])
def test_model_count_matches_flop_counter(name, work):
    config = tiny_config(name)
    hw = TINY[name][1]
    model = reference.build(config, Numerics("f32"), hw).eval()
    x = torch.zeros(1, *hw, 3)
    with torch.no_grad():
        total = counted(lambda: model(x))
    assert work.forward_flops(config["model"], *hw) == pytest.approx(total, rel=1e-9)


def dims_types(*tensors):
    names = {torch.float32: "float", torch.bfloat16: "c10::BFloat16", torch.int32: "int"}
    return ([list(t.shape) if t is not None else [] for t in tensors],
            [names[t.dtype] if t is not None else "" for t in tensors])


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_counts(masked):
    bw, n, c, heads, nw = 8, 49, 64, 4, 4
    qkv = torch.randn(bw, n, 3 * c, dtype=torch.bfloat16)
    bias = torch.randn(heads, n, n)
    mask = torch.zeros(nw, n, n) if masked else None
    out = torch.empty(bw, n, c, dtype=torch.bfloat16)
    work = harness.load_module("work", "window_attention")
    b, ops = work.cost(*dims_types(qkv, bias, mask))
    assert b == nbytes(qkv, bias, mask, out)
    q, k, v = qkv.float().split(c, dim=-1)
    assert ops == counted(lambda: attend(Numerics("f32"), q, k, v, heads, 0.1, bias))
    qk, vv = qkv[..., :2 * c].contiguous(), qkv[..., 2 * c:].contiguous()
    work = harness.load_module("work", "window_attention_qk_v")
    assert work.cost(*dims_types(qk, vv, bias, mask)) == (nbytes(qk, vv, bias, mask, out), ops)


def test_ordered_attention_counts():
    bw, n, c, heads, e = 6, 64, 64, 4, 16
    q = torch.randn(bw, n, c, dtype=torch.bfloat16)
    idx = torch.zeros(bw, n, dtype=torch.int32)
    table = torch.randn(2 * e - 1, heads)
    work = harness.load_module("work", "ordered_attention")
    b, ops = work.cost(*dims_types(q, q, q, idx, table))
    assert b == nbytes(q, q, q, idx, table, q)
    add = torch.zeros(bw, heads, n, n)
    assert ops == counted(lambda: attend(Numerics("f32"), q.float(), q.float(), q.float(),
                                         heads, 0.1, add))


def test_depthwise_and_glu_counts():
    x = torch.randn(2, 12, 10, 16, dtype=torch.bfloat16)
    w = torch.randn(5, 5, 16, dtype=torch.bfloat16)
    conv = counted(lambda: F.conv2d(x.float().permute(0, 3, 1, 2),
                                    w.float().permute(2, 0, 1)[:, None], padding=2, groups=16))
    work = harness.load_module("work", "depthwise_conv2d")
    assert work.cost(*dims_types(x, w)) == (nbytes(x, w, x), conv)
    ab = torch.randn(2, 12, 10, 32, dtype=torch.bfloat16)
    s = torch.ones(16)
    work = harness.load_module("work", "glu_ff")
    b, ops = work.cost(*dims_types(ab, w, s, s))
    assert b == nbytes(ab, w, s, s, x)
    # the taps' products as the counter sees them, and 14 elementwise
    # operations an output for the gate, the affine and the erf GELU
    assert ops == conv + 14 * math.prod(x.shape)
