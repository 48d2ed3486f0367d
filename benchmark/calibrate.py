"""Readings that a cell's limits are set from, on the card, many seeds in
one process (the benchmark's own runs do not run this):

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --control 1,2,3

For each seed, the program's timed path as a run drives it (the serving
calls that fill the kept depth maps; a train state's first steps) against
the float32 reference: the numbers a run compares. For each seed of
``--control``, the same numbers of the control (the reference one
precision lower, fp8 products) and, in a training cell, of a fault: the
reference over half of each batch. One JSON line a reading. The program's
model is built once and takes each seed's weights.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from benchmark import harness


def readings(cell: str, seeds: Sequence[int], control: Sequence[int], device="cuda",
             config: Optional[dict] = None, traffic: Optional[dict] = None
             ) -> Iterator[Dict]:
    spec = harness.load_json("workloads", cell)
    config = config or harness.load_json("configs", spec["config"])
    traffic = traffic or harness.load_json("traffic", spec["traffic"])
    modes = harness.load_module("modes", traffic["mode"])
    built: List[torch.nn.Module] = []
    build = harness.build_program

    def cached(cfg, dev):
        if not built:
            built.append(build(cfg, dev))
        return built[0]

    harness.build_program = cached
    try:
        for seed in sorted(set(seeds) | set(control)):
            driver = modes.Driver(spec, config, traffic, seed, device)
            driver.setup()
            if traffic["mode"] == "serve":
                while not all(driver.filled):
                    driver.call()
            want = driver.outputs("f32")
            if seed in seeds:
                yield {"seed": seed, "side": "program", **driver.numbers(want)}
            if seed in control:
                yield {"seed": seed, "side": "control",
                       **driver.numbers(want, driver.outputs("fp8"))}
                if traffic["mode"] == "train":
                    half = driver.outputs("f32", rows=traffic["batch"] // 2)
                    yield {"seed": seed, "side": "half_batch", **driver.numbers(want, half)}
            del driver, want
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        harness.build_program = build


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    args = p.parse_args(argv)
    harness.require_cards(1)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control.split(",") if s]
    for line in readings(args.workload, seeds, control):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
