"""The check against a broken timed path: a whole run of each cell on the
CPU (the harness's look for a card skipped), at reduced width and size,
the program in float32, first sound, then with a fault planted under the
window's own calls. Sound, ``correct`` is true; with each fault the cell
can have, false:

- a train step that returns its state unchanged;
- a train step that leaves out half of the batch, its mean taken over the
  rest;
- a served depth map altered where it is produced.

(The exchange between chips is left out of no cell: every cell takes one.)
"""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from benchmark.tests.test_bench_reference import TINY, tiny_config

CELLS = {"flagship.train.b4": "flagship", "oda_conv.train.b16": "oda_conv",
         "flagship.serve.b4": "flagship", "oda_conv.serve.b32": "oda_conv"}


def tiny_traffic(cell: str) -> dict:
    traffic = copy.deepcopy(harness.load_json("traffic",
                                              harness.load_json("workloads", cell)["traffic"]))
    h, w = TINY[CELLS[cell]][1]
    traffic.update(batch=2, height=h, width=w, pool=3 if traffic["mode"] == "train" else 2,
                   keep_within=1, check_rows=2, warmup_calls=1)
    return traffic


def run(cell: str, hook=None) -> dict:
    return run_cell(cell, 1234567891011, 2.0, False, device="cpu",
                    config=tiny_config(CELLS[cell]), traffic=tiny_traffic(cell),
                    driver_hook=hook)


def frozen_step(driver):
    """The step hands its state back unchanged."""
    def step(state, batch, generator=None):
        return state, {"loss": torch.tensor(1.0)}
    driver.step = step


def half_batch(driver):
    """The step runs on the first half of the batch only."""
    real = driver.step

    def step(state, batch, generator=None):
        rows = batch["image"].shape[0] // 2
        return real(state, {k: v[:rows] for k, v in batch.items()}, generator)
    driver.step = step


def altered_answer(driver):
    """The predictor's depth maps come back with the first frame shifted."""
    real = driver.predictor.predict

    def predict(images):
        depth = real(images).clone()
        depth[0] = torch.roll(depth[0], shifts=(5, 7), dims=(0, 1))
        return depth
    driver.predictor.predict = predict


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0


FAULTS = [(c, f) for c in sorted(CELLS) for f in
          ((frozen_step, half_batch) if "train" in c else (altered_answer,))]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault):
    result = run(cell, fault)
    assert not result["correct"], result["check"]
