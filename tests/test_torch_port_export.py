"""The exported serving forward (``tools/torch_export.py``) and the
flagship's ``return_weights``, against the JAX package on the CPU.

- Export: the tiny flagship of ``test_torch_port_flagship.py`` (f32, red33,
  two repeats) is exported in a fresh process before any eager call, the
  order in which a traced tensor once stayed in the shift mask's cache,
  and an eager call after the export still runs. The program's graph holds
  one ``torch.ops.mde`` node at each kernel call site (K1 6, K2 4, K3 4)
  and no softmax of a plain attention in their place; loaded again, it
  gives an eager call's depth map exactly (in one process; the exporting
  process's eager call at 1e-5, on one thread) and JAX's
  ``model.apply(...)[0]`` at 1e-4; ``--check`` runs it on a zero batch.
- ``return_weights``: the flagship's (out, outs, weights), the weights f32
  (B*nW, heads, N, N), two a repeat, match JAX's at 1e-5 with the same
  index maps, each row summing to 1; the depth maps are those of the model
  without weights; the train step's adapter takes the maps.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mde_tpu.models.oda2.red_order_swin2 as jax_flagship
import mde_tpu_torch.models.oda2.red_order_swin2 as port_flagship
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.train.step import default_adapter
from test_torch_port_flagship import (ENC, NUM_REPEATS, _cfg, _images, _jax_model, _port_model,
                                      _random_jax_variables, _record_indices)
from _torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_export  # noqa: E402

CFG = _cfg("red33", 4)
# one node a kernel call: K1 in each encoder block, K2 in each ordered SA,
# K3 in each FF
CALLS = {"mde.window_attention.default": sum(ENC["depths"]),
         "mde.ordered_attention.default": 2 * NUM_REPEATS,
         "mde.depthwise_conv2d.default": 2 * NUM_REPEATS}
CHILD = """
import sys, torch
sys.path[:0] = [{root!r}, {tools!r}]
torch.set_num_threads(1)
import torch_export
from mde_tpu_torch.models import build_model
model = build_model({cfg!r}, 0.001, 80.0, device="cpu", resize_to_multiple=False,
                    encoder_kwargs={enc!r}, use_checkpoint=False)
model.load_state_dict(torch.load({state!r}))
x = torch.load({images!r})
torch_export.export({out!r}, "train", 2, "custom", model=model, hw=(64, 96), device="cpu")
with torch.no_grad():
    torch.save(model(x)[0], {eager!r})
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny flagship exported by a fresh process: (the export's
    directory, the images, the JAX model and variables)."""
    root = tmp_path_factory.mktemp("export")
    x = _images()
    jm = _jax_model(CFG)
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=1)
    paths = {k: str(root / f"{k}.pt") for k in ("state", "images", "eager")}
    torch.save(from_jax_variables(variables), paths["state"])
    torch.save(torch.from_numpy(x), paths["images"])
    out = str(root / "program")
    script = CHILD.format(root=ROOT, tools=os.path.join(ROOT, "tools"), cfg=CFG, enc=ENC,
                          out=out, **paths)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    return out, x, jm, variables, torch.load(paths["eager"])


def test_exported_graph_holds_the_kernel_ops(exported):
    out, *_ = exported
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["hw"] == [64, 96] and meta["batch"] == 2 and meta["device"] == "cpu"
    program = torch.export.load(os.path.join(out, "flagship_train.pt2"))
    calls = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    assert {k: v for k, v in calls.items() if k.startswith("mde.")} == CALLS
    assert not [k for k in calls if "softmax" in k], calls


def test_loaded_program_matches_eager_and_jax(exported, monkeypatch):
    out, x, jm, variables, eager = exported
    jax_idx = _record_indices(monkeypatch, jax_flagship)
    ref = jm.apply(variables, jnp.asarray(x), train=False)[0]
    assert len(jax_idx) == NUM_REPEATS
    pred = torch_export.load_and_run(out, torch.from_numpy(x))
    port = _port_model(CFG).eval()
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        here = port(torch.from_numpy(x))[0]
    # the same process: the same bits; the exporting process ran on one
    # thread, whose sums may round otherwise
    assert pred.shape == (2, 16, 24, 1) and torch.equal(pred, here)
    assert float((eager - here).abs().max()) <= 1e-5
    assert float(np.max(np.abs(pred.numpy() - np.asarray(ref)))) <= 1e-4
    assert torch_export.main(["--check", out]) == 0


def test_flagship_return_weights_match_jax(monkeypatch):
    x = _images()
    jm = jax_flagship.ODA2OrderedSwin2RegModel.build(
        CFG, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC, use_checkpoint=False,
        scan_repeats=False, return_weights=True)
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=1)
    port = port_flagship.ODA2OrderedSwin2RegModel.build(
        CFG, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC, use_checkpoint=False,
        return_weights=True).eval()
    port.load_state_dict(from_jax_variables(variables))
    plain = _port_model(CFG).eval()
    plain.load_state_dict(from_jax_variables(variables))
    jax_idx = _record_indices(monkeypatch, jax_flagship)
    port_idx = _record_indices(monkeypatch, port_flagship)
    ref_out, _, ref_weights = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        model_out = port(torch.from_numpy(x))
        out, outs, weights = model_out
        plain_out, plain_outs = plain(torch.from_numpy(x))
    assert all(np.array_equal(a, b) for a, b in zip(port_idx, jax_idx))
    assert torch.equal(out, plain_out) and all(map(torch.equal, outs, plain_outs))
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref_out)))) <= 1e-4
    assert len(weights) == len(ref_weights) == 2 * NUM_REPEATS
    for w, r in zip(weights, ref_weights):
        # (B * windows of 4x4 on the 16x24 map, heads, N, N)
        assert w.dtype == torch.float32 and w.shape == r.shape == (2 * 24, 4, 16, 16)
        assert float(np.max(np.abs(w.numpy() - np.asarray(r)))) <= 1e-5
        assert torch.allclose(w.sum(-1), torch.ones(()), atol=1e-6)
    maps, bins = default_adapter(model_out)
    assert bins is None and len(maps) == NUM_REPEATS + 1
    assert all(m is o for m, o in zip(maps, outs))
