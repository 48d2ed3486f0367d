"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the first timed call: the program's build, the
weights and inputs made from the seed, kernel builds, the cell's first
calls) is ``setup_s``. The window then drives the cell's traffic for
``--seconds``; with ``--trace 1`` a profiled stretch of the same calls
follows it and the per-layer metrics are read, else the end-to-end ones.
Then the device's peak memory is read, the program is freed, and the
plain reference checks what the timed path produced: each number compared
is printed beside its limit on standard error and, last, in the result
line, which is the last line of standard output. The run fails, printing
no result, without the cards the cell asks for, or where JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


@dataclass
class Record:
    """What a metric's reader gets: the cell's files, the window's counts
    and, in a traced run, the two profiled stretches (``device_trace``: the
    card alone; ``trace``: the host too)."""
    cell: str
    config: dict
    traffic: dict
    window: dict
    trace: Optional[object] = None
    device_trace: Optional[object] = None
    notes: List[str] = field(default_factory=list)

    def note(self, line: str) -> None:
        self.notes.append(line)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             config: dict = None, traffic: dict = None, driver_hook=None) -> dict:
    """One run of cell ``name``; returns the result line as a dict, with the
    lines for standard error under ``"log"``. ``config``, ``traffic`` and
    ``driver_hook`` (called with the driver inside its set-up) replace the
    cell's files and reach into the run for the check's own tests."""
    cell = harness.load_json("workloads", name)
    config = config or harness.load_json("configs", cell["config"])
    traffic = traffic or harness.load_json("traffic", cell["traffic"])
    modes = harness.load_module("modes", traffic["mode"])
    cuda = torch.device(device).type == "cuda"
    driver = modes.Driver(cell, config, traffic, seed, device)
    driver.setup(driver_hook)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    window = driver.window(seconds)
    values = dict(driver.end_to_end(window), setup_s=setup_s)
    log = [f"window: {window['calls']} calls, {window['images']} images in "
           f"{window['seconds']:.3f} s"]
    if window.get("latency_ms"):
        lat = sorted(window["latency_ms"])
        log.append(f"latency ms: p50 {lat[len(lat) // 2]:.3f}, p95 "
                   f"{values['serve_p95_ms']:.3f}, max {lat[-1]:.3f} over {len(lat)} batches")
    rec = Record(name, config, traffic, window)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": cell["chips"]}
    if traced:
        from benchmark import trace
        rec.device_trace = trace.profile(driver.call, traffic["trace_calls"], host=False)
        rec.trace = trace.profile(driver.call, traffic["trace_calls"], host=True)
        metrics = {}
        for m in harness.cell_metrics("per_layer", name):
            value = harness.metric_reader(m["name"]).read(m["name"], rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=rec.device_trace.busy_s, window_s=rec.device_trace.window_s)
        per_call = window["seconds"] / max(window["calls"], 1)
        log.append(f"stretches: {rec.device_trace.host_wall_s / rec.device_trace.calls:.4f} "
                   f"s a call with the card traced, {rec.trace.host_wall_s / rec.trace.calls:.4f} "
                   f"with the host too, {per_call:.4f} in the window")
        log.append(f"syncs by source: {rec.trace.sync_sources()}")
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics("end_to_end", name)}
    if cuda:
        dev["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated())
        dev["power_limit"] = harness.power_limit()
    driver.free()
    t_ref = time.perf_counter()
    want = driver.outputs("f32")
    numbers = driver.numbers(want)
    log.append(f"reference: {time.perf_counter() - t_ref:.1f} s")
    log += driver.notes(want)
    limits = cell["limits"]
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in check.values())
    log += rec.notes
    log += [f"reading {k}: {numbers[k]:.6g} (not compared)" for k in numbers if k not in limits]
    log += [f"check {k}: {numbers[k]:.6g} (limit {limits[k]})" for k in limits]
    result = {"correct": correct, "attempted": window["calls"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": rec.device_trace.breakdown()["device_ops"],
                               "idle_gaps": rec.trace.breakdown()["idle_gaps"]}
    result["check"] = check
    result["log"] = log
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_json("workloads", args.workload)
    harness.require_cards(cell["chips"])
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    log = result.pop("log")
    found = harness.banned_modules()
    if found:
        print(f"loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
