"""The control on the card: the reference one precision below the
configuration's (fp8 products) in the program's place fails the cell's
limits, on three seeds, while the program passes them; the cells' widths
at a smaller batch. Run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m gpu -q
"""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import readings

CELLS = ["flagship.train.b4", "oda_conv.serve.b32", "flagship.serve.b4", "oda_conv.train.b16"]
SEEDS = [4021, 5039, 6047]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the program's kernels are CUDA only")
    spec = harness.load_json("workloads", cell)
    limits = spec["limits"]
    traffic = copy.deepcopy(harness.load_json("traffic", spec["traffic"]))
    traffic.update(batch=2, pool=max(2, traffic.get("check_steps", 0)), check_rows=2)
    over = {"program": [], "control": []}
    for line in readings(cell, SEEDS, SEEDS, traffic=traffic):
        if line["side"] in over:
            over[line["side"]].append(any(line[k] > v for k, v in limits.items()))
    assert over["program"] == [False] * len(SEEDS)
    assert over["control"] == [True] * len(SEEDS)
