"""The port's tools and utilities against the JAX package's, on the CPU.

- ``utils/flops``: equal to JAX's ``flagship_forward_flops`` over encoders,
  necks and shapes, and within 10% of ``torch.utils.flop_counter`` on the
  port's forward of a narrow flagship whose windows tile its grids.
- ``utils/golden``, ``data/extract`` and ``utils/visualize.save_visualizations``:
  the same reports, trees and pixels as JAX's on synthetic inputs, built as
  ``tests/test_golden.py`` and ``tests/test_extract.py`` build them (JAX's
  PNGs and JPEGs through Pillow, the port's PNGs through its own codec).
- Reference checkpoints: ``load_torch_state_dict`` of nested, ``module.``
  prefixed files; ``swin_backbone_state_dict`` of
  ``test_checkpoint._fake_msft_swin_state``, with and without a window
  change, gives the port's ``SwinTransformer`` the outputs of JAX's fed by
  ``convert_swin_backbone`` at 1e-5, and its key accounting raises as
  JAX's does.
- ``tools/torch_parity_check.py dump`` of a tiny NewCRFs and of AdaBins
  (``test_converters``' synthetic states, saved under ``model`` with
  ``module.`` prefixes) against ``tools/parity_check.py dump`` of the same
  files: ``diff`` exits 0 at 1e-4.
- ``ops/attention.MultiHeadAttention`` with ``return_weights`` against
  JAX's at 1e-5, each row of its weights summing to 1.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mde_tpu.core.checkpoint import convert_swin_backbone
from mde_tpu.data import extract as jax_extract
from mde_tpu.data import splits as jax_splits
from mde_tpu.models.swin import SwinTransformer as JaxSwin
from mde_tpu.ops import attention as jax_attention
from mde_tpu.utils import flops as jax_flops
from mde_tpu.utils import golden as jax_golden
from mde_tpu.utils import visualize as jax_visualize
from mde_tpu_torch.core import checkpoint as ckpt
from mde_tpu_torch.data import extract
from mde_tpu_torch.data.png import read_png
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.swin import SwinTransformer
from mde_tpu_torch.ops import attention
from mde_tpu_torch.utils import flops, golden, visualize
from test_checkpoint import _fake_msft_swin_state
from test_converters import _fake_adabins_state, _fake_newcrfs_state
from _torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- FLOPs -----------------------------------------------------------------

@pytest.mark.parametrize("encoder", ["base", "large"])
@pytest.mark.parametrize("neck", ["red33", "red", "fpn", "segformer", "red33r", "red33res"])
def test_flops_equal_jax(encoder, neck):
    for h, w in ((352, 704), (352, 1216), (480, 640), (300, 500)):
        for resize in (True, False):
            kw = dict(encoder_type=encoder, neck_type=neck, resize_to_multiple=resize)
            assert flops.flagship_forward_flops(h, w, **kw) == \
                jax_flops.flagship_forward_flops(h, w, **kw)


def test_flops_within_ten_percent_of_the_counted_forward(monkeypatch):
    """The hand model counts matmuls and convs; ``FlopCounterMode`` counts
    the port's matmuls, einsums and convs (the plain K3 is elementwise and
    uncounted, 2.5% of this model). Swin widths (32, depths 2 a stage,
    window 7) at 224x224, whose grids 56, 28, 14, 7 the windows tile."""
    from torch.utils.flop_counter import FlopCounterMode
    monkeypatch.setitem(flops._SWIN, "narrow", (32, (2, 2, 2, 2), (1, 2, 4, 8)))
    cfg = dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=128, num_heads=4,
               num_repeats=2, num_emb=16, window_size=8, neck_type="red33")
    model = build_model(cfg, 0.001, 80.0, device="cpu", seed=0, resize_to_multiple=False,
                        use_checkpoint=False,
                        encoder_kwargs=dict(embed_dim=32, depths=(2, 2, 2, 2),
                                            num_heads=(1, 2, 4, 8), window_size=7)).eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.rand(1, 224, 224, 3))
    counted = counter.get_total_flops()
    model_flops = flops.flagship_forward_flops(224, 224, "narrow", dec_dim=128, num_repeats=2,
                                               num_heads=4, window_size=8, num_emb=16,
                                               resize_to_multiple=False)
    assert abs(model_flops - counted) / counted < 0.10, (model_flops, counted)


# -- golden, visualisations, extraction --------------------------------------

def test_golden_reports_equal_jax(tmp_path):
    golden_dir, pred = tmp_path / "golden", tmp_path / "pred"
    (golden_dir / "sub").mkdir(parents=True)
    pred.mkdir()
    base = np.arange(64, dtype=np.uint16).reshape(8, 8) * 100
    Image.fromarray(base).save(golden_dir / "a.png")
    Image.fromarray(base).save(golden_dir / "missing.png")
    rgb = np.random.RandomState(0).randint(0, 256, (6, 5, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(golden_dir / "sub" / "c.png")
    drifted = base.copy()
    drifted[0, 0] += 3
    Image.fromarray(drifted).save(pred / "a.png")
    (pred / "sub").mkdir()
    Image.fromarray(rgb[:5]).save(pred / "sub" / "c.png")
    for kw in (dict(tolerance=2.0), dict(tolerance=3.0, names=["a.png"]), dict()):
        ours = golden.compare_png_dirs(str(pred), str(golden_dir), **kw)
        ref = jax_golden.compare_png_dirs(str(pred), str(golden_dir), **kw)
        assert ours == ref
        assert golden.summarize(ours) == jax_golden.summarize(ref)
    assert not ours["sub/c.png"]["shape_match"]


def test_save_visualizations_equal_jax(tmp_path):
    preds = np.random.RandomState(1).uniform(0.0, 12.0, (3, 6, 9, 1)).astype(np.float32)
    paths = ["a/x.png", "a/y", "b/c/z.png"]
    visualize.save_visualizations(preds, paths, str(tmp_path / "port"), vmax=10.0)
    jax_visualize.save_visualizations(preds, paths, str(tmp_path / "jax"), vmax=10.0)
    for rel in ("a/x.png", "a/y.png", "b/c/z.png"):
        ours = read_png(str(tmp_path / "port" / rel))
        ref = np.asarray(Image.open(tmp_path / "jax" / rel))
        assert ours.shape == ref.shape == (6, 9, 4) and np.array_equal(ours, ref)


def _corpus(tmp_path, lines):
    split_dir = tmp_path / "splits" / "KITTI"
    split_dir.mkdir(parents=True)
    (split_dir / "kitti_eigen_test.txt").write_text("\n".join(lines) + "\n")
    src = tmp_path / "src"
    for line in lines:
        for rel in line.split()[:2]:
            p = src / "raw" / rel if "img" in rel else src / "gts" / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(p)
    return str(tmp_path / "splits"), str(src)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_extract_subset_and_check_equal_jax(tmp_path, monkeypatch, capsys):
    lines = ["a/img_0.png a/gt_0.png 718.0", "b/img_1.png b/gt_1.png 718.0",
             "c/img_2.png c/gt_2.png 718.0"]
    split_dir, src = _corpus(tmp_path, lines)
    os.remove(os.path.join(src, "gts", "c/gt_2.png"))
    kw = dict(img_subdir="raw", gt_subdir="gts", split_dir=split_dir)
    with pytest.raises(FileNotFoundError):
        extract.extract_subset("KITTI", "test", src, str(tmp_path / "x"), **kw)
    ours = extract.extract_subset("KITTI", "test", src, str(tmp_path / "port"), missing_ok=True,
                                  **kw)
    ref = jax_extract.extract_subset("KITTI", "test", src, str(tmp_path / "jax"),
                                     missing_ok=True, **kw)
    assert ours == ref == (2, 1)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    monkeypatch.setenv("MDE_SPLIT_DIR", split_dir)
    # JAX's splits read MDE_SPLIT_DIR when imported
    monkeypatch.setattr(jax_splits, "_DEFAULT_SPLIT_DIRS", (split_dir,))
    assert extract.main(["check", "KITTI", "test", src]) == 0
    jax_extract.main(["check", "KITTI", "test", src])
    port_out, jax_out = capsys.readouterr().out.splitlines()
    assert port_out == jax_out == "found 2, missing 1"


def test_convert_nyu_mat_equal_jax(tmp_path):
    """A synthetic labelled .mat (h5py) and split .mat (scipy): the same
    scenes, depths (pixels) and JPEGs (bytes) as JAX's converter."""
    import h5py
    import scipy.io
    rng = np.random.RandomState(2)
    mat, split = str(tmp_path / "nyu.mat"), str(tmp_path / "splits.mat")
    with h5py.File(mat, "w") as h5:
        h5["images"] = rng.randint(0, 256, (3, 3, 640, 480)).astype(np.uint8)
        h5["depths"] = rng.uniform(0.5, 9.5, (3, 640, 480)).astype(np.float32)
    scipy.io.savemat(split, {"trainNdxs": np.array([[1], [3]]), "testNdxs": np.array([[2]])})
    assert extract.convert_nyu_mat(mat, split, str(tmp_path / "port")) == 3
    assert jax_extract.convert_nyu_mat(mat, split, str(tmp_path / "jax")) == 3
    tree = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == tree and len(tree) == 6
    for rel in tree:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith(".jpg"):
            assert a.read_bytes() == b.read_bytes()
        else:
            assert np.array_equal(read_png(str(a)), np.asarray(Image.open(b)))


# -- reference checkpoints ---------------------------------------------------

@pytest.mark.parametrize("nest_key", [None, "model", "state_dict"])
def test_load_torch_state_dict_unnests_and_strips(tmp_path, nest_key):
    sd = _fake_msft_swin_state()
    wrapped = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    obj = wrapped if nest_key is None else {nest_key: wrapped, "epoch": 3}
    torch.save(obj, tmp_path / "c.pt")
    loaded = ckpt.load_torch_state_dict(str(tmp_path / "c.pt"))
    assert sorted(loaded) == sorted(sd)
    assert all(torch.equal(loaded[k], torch.from_numpy(sd[k])) for k in sd)


@pytest.mark.parametrize("target_window", [None, 6])
def test_swin_backbone_state_dict_matches_jax(target_window):
    depths, heads, window = (2, 1), (1, 2), target_window or 4
    sd = _fake_msft_swin_state(depths=depths, num_heads=heads, window=4)
    port_sd = ckpt.swin_backbone_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                            depths=depths, out_indices=(0, 1),
                                            target_window=target_window)
    params = convert_swin_backbone(sd, depths=depths, out_indices=(0, 1),
                                   target_window=target_window)
    kw = dict(embed_dim=16, depths=depths, num_heads=heads, window_size=window,
              out_indices=(0, 1))
    port = SwinTransformer(path_drop_prob=0.0, **kw).eval()
    port.load_state_dict(port_sd, strict=True)
    x = np.random.RandomState(0).rand(1, 8 * window, 12 * window, 3).astype(np.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    ref = JaxSwin(path_drop_prob=0.0, **kw).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x), train=False)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= 1e-5


def test_swin_backbone_key_accounting():
    sd = {k: torch.from_numpy(v) for k, v in _fake_msft_swin_state().items()}
    with pytest.raises(ValueError, match="Unconverted"):
        ckpt.swin_backbone_state_dict(dict(sd, **{"layers.0.blocks.0.attn.extra": sd["head.bias"]}),
                                      depths=(1, 1), out_indices=(0, 1))
    with pytest.raises(KeyError, match="Missing"):
        ckpt.swin_backbone_state_dict({k: v for k, v in sd.items() if "mlp.fc1.bias" not in k},
                                      depths=(1, 1), out_indices=(0, 1))
    with pytest.raises(KeyError, match="norm0"):
        ckpt.swin_backbone_state_dict(sd, depths=(1, 1), out_indices=(0, 1),
                                      take_out_norms=True)


@pytest.mark.heavy
@pytest.mark.parametrize("model,shape", [("newcrfs", ("64", "96")),
                                         ("adabins", ("352", "416"))])
def test_parity_dump_diff_against_jax(tmp_path, model, shape, capsys):
    """The released-checkpoint path on synthetic files: the port's dump and
    JAX's dump of the same .pt, then ``diff`` (both tools at 1e-4), the
    synthetic states' zeros replaced by seeded values. AdaBins' mViT needs
    129 patches of 16x16 at half the input's size."""
    sd = _fake_newcrfs_state("tiny07") if model == "newcrfs" else _fake_adabins_state()
    rng = np.random.RandomState(6)
    sd = {k: (v if v.dtype != np.float32 else
              rng.uniform(0.5, 1.5, v.shape) if k.endswith("running_var") else
              0.05 * rng.randn(*v.shape)).astype(v.dtype) for k, v in sd.items()}
    path = str(tmp_path / f"{model}.pt")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    args = ["dump", "--model", model, "--ckpt", path, "--version", "tiny07", "--shape", *shape,
            "--data-type", "NYU"]
    port_tool, jax_tool = _tool("torch_parity_check"), _tool("parity_check")
    assert port_tool.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu",
                                  "--intermediates"]) == 0
    assert jax_tool.main(args + ["--out", str(tmp_path / "jax.npz")]) == 0
    port_dump, jax_dump = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    outs = sorted(k for k in jax_dump.files if k.startswith("out"))
    assert outs and outs == sorted(k for k in port_dump.files if k.startswith("out"))
    assert any(k.startswith("act:") for k in port_dump.files)
    capsys.readouterr()
    for tool in (port_tool, jax_tool):
        assert tool.main(["diff", str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"),
                          "--tol", "1e-4"]) == 0
    assert "max abs diff" in capsys.readouterr().out


# -- return_weights ----------------------------------------------------------

@pytest.mark.parametrize("shape", [((2, 5, 24), (2, 7, 24)), ((3, 2, 6, 24), (3, 2, 6, 24))])
def test_multi_head_attention_weights_match_jax(shape):
    qs, ks = shape
    rng = np.random.RandomState(4)
    q, k, v = rng.randn(*qs).astype(np.float32), rng.randn(*ks).astype(np.float32), \
        rng.randn(*ks).astype(np.float32)
    jm = jax_attention.MultiHeadAttention(num_heads=4, out_dim=32, key_query_dim=16,
                                          return_weights=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref, ref_w = jm.apply(variables, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    mod = attention.MultiHeadAttention(24, 4, out_dim=32, key_query_dim=16,
                                       return_weights=True)
    mod.load_state_dict({f"{name}.{p}": torch.from_numpy(np.asarray(
        leaf.T if p == "weight" else leaf).copy())
        for name, dense in variables["params"].items()
        for p, leaf in (("weight", dense["kernel"]), ("bias", dense["bias"]))})
    with torch.no_grad():
        out, w = mod(*(torch.from_numpy(a) for a in (q, k, v)))
    assert w.dtype == torch.float32 and w.shape == ref_w.shape
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) <= 1e-5
    assert float(np.max(np.abs(w.numpy() - np.asarray(ref_w)))) <= 1e-5
    assert torch.allclose(w.sum(-1), torch.ones(()), atol=1e-6)


# -- profiling ---------------------------------------------------------------

def test_profiling_trace_timer_and_memory(tmp_path):
    """``trace`` writes a Chrome trace of the host's ops (the card's too,
    where there is one) and hands back the profiler; ``device_memory_stats``
    is empty without a card."""
    from mde_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert any("mm" in e.key for e in prof.key_averages())
    assert profiling.device_memory_stats() == {}
