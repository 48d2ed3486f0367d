"""The ``newcrfs`` configuration and its cell ``newcrfs.serve.b4``.

On the CPU:

- the program (its plain CPU path) against ``reference/newcrfs.py`` on one
  seeded state dict, at a small ``custom07`` size whose maps are odd (the
  image not a patch multiple, an odd map before a merge, no map a window
  multiple), and with the PSP at 512 channels, so that the scale-1
  GroupNorm normalises two values a group as in ``large07``; eval, f32, at
  1e-4 of the reference's largest depth;
- the program and the reference built as ``large07`` (on the meta device)
  against the published widths the configuration records: one template;
- ``work/newcrfs.forward_flops`` against ``FlopCounterMode`` over the
  reference at two small sizes and at 352x1216, where it is pinned;
- a whole run of the cell at the small size, sound (``correct``) and with
  each fault a serving call can have (a frozen call, half a batch, an
  altered map): not ``correct``;
- the readers of ``k1_qk_v_roofline.serve`` (a q|k + v call paired with its
  kernel by order among both K1 entries' calls) and ``crf_ms.serve`` on
  made-up traces and spans.

On the card (``-m gpu``), at the configuration's widths on 2 frames of
352x1216: the fp8 control fails the cell's limits on three seeds while the
program passes them, and each fault reads not ``correct``:

    python -m pytest benchmark/tests/test_bench_newcrfs.py -m gpu -q
"""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, inputs, reference
from benchmark.calibrate import readings
from benchmark.reference.layers import Numerics
from benchmark.run import run_cell
from benchmark.tests.test_bench_bwd_work import record, span
from benchmark.tests.test_bench_work import dims_types
from benchmark.trace import STRETCH, Trace
from benchmark.work import newcrfs as work

CELL = "newcrfs.serve.b4"
SEEDS = [4021, 5039, 6047]
TINY_ENCODER = {"embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 2, 4],
                "in_channels": [16, 32, 64, 128], "crf_dims": [32, 64, 128, 1024]}
# 62x90: patches pad to 64x92; maps 16x23 (odd before the merge), 8x12, 4x6, 2x3
TINY_HW = (62, 90)


def tiny_config() -> dict:
    config = copy.deepcopy(harness.load_json("configs", "newcrfs"))
    config["model"].update(version="custom07", encoder_kwargs=copy.deepcopy(TINY_ENCODER))
    config["dtype"] = "float32"
    return config


def test_forward_matches_program():
    config = tiny_config()
    ref = reference.build(config, Numerics("f32"), TINY_HW)
    state = inputs.make_weights(harness.template(ref), 3, "cpu")
    ref.load_state_dict(state)
    prog = harness.build_program(config, "cpu")
    prog.load_state_dict(state)
    x = inputs.make_images(1, 2, *TINY_HW, seed=5, device="cpu")[0]
    with torch.no_grad():
        want = ref.eval()(x)[0]
        got = prog.eval()(x)
    assert got.shape == want.shape == (2, 64, 92, 1)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


def test_published_widths():
    """The program and the reference as ``large07`` hold the widths and
    depths the configuration records, under one template."""
    config = harness.load_json("configs", "newcrfs")
    from mde_tpu_torch.models.newcrfs import NewCRFDepth
    with torch.device("meta"):
        ref = reference.build(config, Numerics("f32"), (352, 1216))
        prog = NewCRFDepth.build(config["model"], config["min_depth"], config["max_depth"])
    t = harness.template(ref)
    assert t == harness.template(prog)
    wd = config["widths"]
    assert t["backbone.patch_embed.proj.weight"][0] == (wd["embed_dim"], 3, 4, 4)
    for i, (depth, heads) in enumerate(zip(wd["depths"], wd["num_heads"])):
        blocks = {k.split(".")[4] for k in t if k.startswith(f"backbone.layers.{i}.blocks.")}
        assert len(blocks) == depth
        table = t[f"backbone.layers.{i}.blocks.0.attn.relative_position_bias_table"][0]
        assert table == ((2 * wd["window_size"] - 1) ** 2, heads)
        assert t[f"backbone.norm{i}.weight"][0] == (wd["embed_dim"] * 2 ** i,)
    for k, (dim, heads) in enumerate(zip(wd["crf_dims"], wd["crf_heads"])):
        blocks = {key.split(".")[3] for key in t if key.startswith(f"crf{k}.crf_layer.blocks.")}
        assert len(blocks) == wd["crf_depth"]
        table = t[f"crf{k}.crf_layer.blocks.0.attn.relative_position_bias_table"][0]
        assert table == ((2 * wd["crf_window"] - 1) ** 2, heads)
        assert t[f"crf{k}.norm_crf.weight"][0] == (dim,)
    assert len(wd["pool_scales"]) == len({k.split(".")[2] for k in t
                                          if k.startswith("decoder.psp_modules.")})
    assert t["decoder.psp_modules.0.1.gn.weight"][0] == (wd["psp_channels"],)
    assert t["decoder.bottleneck.conv.weight"][0][0] == wd["psp_channels"]
    assert sum(p.numel() for p in ref.parameters()) == 270_444_877


def counted(model, hw) -> int:
    x = torch.zeros(1, *hw, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("hw", [TINY_HW, (57, 122)])
def test_count_matches_flop_counter(hw):
    config = tiny_config()
    model = reference.build(config, Numerics("f32"), hw).eval()
    assert work.forward_flops(config["model"], *hw) == counted(model, hw)


def test_count_at_the_cells_size():
    config = harness.load_json("configs", "newcrfs")
    with torch.device("meta"):
        model = reference.build(config, Numerics("f32"), (352, 1216)).eval()
        total = counted(model, (352, 1216))
    assert work.forward_flops(config["model"], 352, 1216) == total
    assert total == pytest.approx(0.80174e12, rel=1e-5)


K1 = "void window_attention_mma_kernel<49, 32>(__nv_bfloat16 const*)"


def k1_trace(calls, kernels):
    """A host stretch of K1 entry ``calls`` ((op, tensors) each, 1 us apart)
    and K1 ``kernels`` (us each, in the card's order)."""
    events = [{"name": STRETCH, "ph": "X", "cat": "user_annotation", "ts": 0, "dur": 1000}]
    for i, (op, tensors) in enumerate(calls):
        dims, types = dims_types(*tensors)
        events.append({"name": f"mde::{op}", "ph": "X", "cat": "cpu_op", "ts": 10 + i,
                       "dur": 0.5, "args": {"Input Dims": dims, "Input type": types}})
    for i, us in enumerate(kernels):
        events.append({"name": K1, "ph": "X", "cat": "kernel", "ts": 100 + 10 * i, "dur": us})
    return Trace(events, 1, 1e-3, own_syncs=1)


def test_qk_v_share_pairs_calls_with_kernels_by_order():
    reader = harness.metric_reader("k1_qk_v_roofline.serve")
    meta = dict(dtype=torch.bfloat16, device="meta")
    qkv = torch.empty(4096, 49, 384, **meta)
    qk, v = torch.empty(2288, 49, 256, **meta), torch.empty(2288, 49, 128, **meta)
    bias = torch.empty(4, 49, 49, device="meta")
    mask = torch.empty(572, 49, 49, device="meta")
    calls = [("window_attention", (qkv, bias, None)),
             ("window_attention_qk_v", (qk, v, bias, None)),
             ("window_attention", (qkv, bias, mask)),
             ("window_attention_qk_v", (qk, v, bias, mask))]
    work_qk_v = harness.load_module("work", "window_attention_qk_v")
    peaks = harness.load_json("work", "peaks")
    least = 0.0
    for _, tensors in calls[1::2]:
        b, f = work_qk_v.cost(*dims_types(*tensors))
        least += max(b / peaks["hbm_bytes_per_s"], f / peaks["bf16_flops_per_s"])
    share, note = reader.share(k1_trace(calls, [150.0, 90.0, 160.0, 100.0]))
    assert share == pytest.approx(100.0 * least / 190e-6)
    assert note == "bytes bound on 2 of 2 calls"
    assert reader.share(k1_trace(calls, [150.0, 90.0, 160.0])) is None
    assert reader.share(k1_trace(calls[::2], [150.0, 160.0])) is None


def test_crf_ms_reads_the_four_stage_spans(monkeypatch):
    records = []
    for call, scale in ((3, 1.0), (4, 2.0), (5, 50.0)):  # two card-only calls, a host one
        records += [span("mde.newcrfs.crf", call, s * scale, parent=2) for s in (1, 2, 3, 4)]
        records.append(span("mde.serve.predict", call, 20.0 * scale))
    rec = record(monkeypatch, records)
    assert harness.metric_reader("crf_ms.serve").read("crf_ms.serve", rec) == \
        pytest.approx(15.0)
    rec = record(monkeypatch)
    assert harness.metric_reader("crf_ms.serve").read("crf_ms.serve", rec) is None


def frozen_call(driver):
    """Every call hands back the depth maps of the predictor's first call."""
    real, first = driver.predictor.predict, []

    def predict(images):
        if not first:
            first.append(real(images).clone())
        return first[0]
    driver.predictor.predict = predict


def half_batch(driver):
    """A call computes the first half of its frames and sends that half
    twice."""
    real = driver.predictor.predict

    def predict(images):
        depth = real(images[:images.shape[0] // 2])
        return torch.cat([depth, depth])
    driver.predictor.predict = predict


def altered_answer(driver):
    """The first frame's depth map comes back shifted."""
    real = driver.predictor.predict

    def predict(images):
        depth = real(images).clone()
        depth[0] = torch.roll(depth[0], shifts=(5, 7), dims=(0, 1))
        return depth
    driver.predictor.predict = predict


def small_traffic(hw) -> dict:
    traffic = copy.deepcopy(harness.load_json("traffic", "kitti_eval_b4"))
    traffic.update(batch=2, height=hw[0], width=hw[1], pool=2, keep_within=1, check_rows=2,
                   warmup_calls=1)
    return traffic


@pytest.mark.parametrize("fault", [None, frozen_call, half_batch, altered_answer],
                         ids=["sound", "frozen_call", "half_batch", "altered_answer"])
def test_run_on_the_cpu(fault):
    result = run_cell(CELL, 1234567891011, 1.0, False, device="cpu", config=tiny_config(),
                      traffic=small_traffic(TINY_HW), driver_hook=fault)
    assert result["correct"] == (fault is None), result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the program's kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_control_fails_the_limits(card):
    limits = harness.load_json("workloads", CELL)["limits"]
    traffic = small_traffic((352, 1216))
    over = {"program": [], "control": []}
    for line in readings(CELL, SEEDS, SEEDS, traffic=traffic):
        over[line["side"]].append(any(line[k] > v for k, v in limits.items()))
    assert over["program"] == [False] * len(SEEDS)
    assert over["control"] == [True] * len(SEEDS)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [frozen_call, half_batch, altered_answer],
                         ids=["frozen_call", "half_batch", "altered_answer"])
def test_fault_on_the_card_is_not_correct(card, fault):
    result = run_cell(CELL, 2718281828459, 1.0, False, traffic=small_traffic((352, 1216)),
                      driver_hook=fault)
    assert not result["correct"], result["check"]
