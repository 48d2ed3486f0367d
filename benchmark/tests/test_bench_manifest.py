"""Guards on the benchmark's own files: no JAX anywhere in it, no program
in its yardstick, a ``BENCHMARK.json`` that keeps the contract's
characters and pairs each per-layer metric with an end-to-end metric its
cells report, and cells, mixes, configurations and metrics found by name
with no edit."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "optax", "mde_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module a file imports (relative imports
    are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("part", ["reference", "work"])
def test_yardstick_imports_no_program(part):
    for path in sorted((ROOT / part).rglob("*.py")):
        assert "mde_tpu_torch" not in imported(path), path


def test_names_and_units():
    b = harness.manifest()
    named = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in named]
    assert len(names) == len(set(names))


def test_moves_reported_where_read():
    b = harness.manifest()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in v for k, v in e2e.items() if k != "setup_s"), cell
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"]), cell


def test_files_match_manifest():
    b = harness.manifest()
    for c in b["configs"]:
        config = json.loads((harness.REPO / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert (ROOT / "reference" / f"{config['reference']}.py").exists()
        assert (ROOT / "work" / f"{config['work']}.py").exists()
    for w in b["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        mode = harness.load_json("traffic", w["traffic"])["mode"]
        assert (ROOT / "modes" / f"{mode}.py").exists()
    for m in b["per_layer"]:
        assert hasattr(harness.metric_reader(m["name"]), "read"), m["name"]


def test_found_by_name(tmp_path, monkeypatch):
    """A configuration, a mix, a cell and a metric that a later change adds
    as files are found by their names, and a metric's reader by the part
    of its name before the first dot."""
    for kind in ("configs", "traffic", "workloads", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "model_b.json").write_text(json.dumps({"name": "model_b"}))
    (tmp_path / "traffic" / "mix_b.json").write_text(json.dumps({"mode": "serve"}))
    (tmp_path / "workloads" / "model_b.mix_b.json").write_text(
        json.dumps({"config": "model_b", "traffic": "mix_b", "chips": 1}))
    (tmp_path / "metrics" / "spare_ms.py").write_text(
        "def read(name, rec):\n    return 1.5 if name.endswith('.serve') else None\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.load_json("workloads", "model_b.mix_b")
    assert harness.load_json("configs", cell["config"])["name"] == "model_b"
    assert harness.load_json("traffic", cell["traffic"])["mode"] == "serve"
    reader = harness.metric_reader("spare_ms.serve")
    assert reader.read("spare_ms.serve", None) == 1.5
    assert reader.read("spare_ms.train", None) is None
