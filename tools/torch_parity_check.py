"""Activation-parity harness of the PyTorch port: the counterpart of
``tools/parity_check.py``, with the same flags and the same ``.npz`` layout,
so that ``diff`` compares a dump of the port with one of the JAX package
(or of the reference's own code) on the same input.

* ``dump``: load a released torch checkpoint into the port's model
  (``core/checkpoint.load_reference_model``: the reference's names,
  ``strict=True``), run it in eval mode on the seeded input and write an
  ``.npz`` of ``input``, then ``out{i}`` in the order of the flattened
  model output (tuples in order, ``None`` left out) and, with
  ``--intermediates``, ``act:<module path>`` of every submodule's tensor
  output (forward hooks).
* ``diff``: the per-tensor sum, mean and max absolute differences of the
  keys two dumps share; exit code 1 where the largest passes ``--tol``.

Usage:
  python tools/torch_parity_check.py dump --model adabins --ckpt AdaBins_nyu.pt \\
      --data-type NYU --out port.npz
  python tools/parity_check.py dump --model adabins --ckpt AdaBins_nyu.pt \\
      --data-type NYU --out jax.npz
  python tools/torch_parity_check.py diff port.npz jax.npz --tol 1e-4
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _build(model_name: str, data_type: str, ckpt: str, version: str, device: str):
    from mde_tpu_torch.core.checkpoint import load_reference_model
    from mde_tpu_torch.models import build_model

    min_d, max_d = (0.001, 10.0) if data_type == "NYU" else (0.001, 80.0)
    if model_name == "adabins":
        cfg = {"name": "adabins", "num_bins": 256}
    elif model_name == "newcrfs":
        cfg = {"name": "newcrfs", "version": version}
    else:
        raise SystemExit(f"unsupported model {model_name}")
    model = build_model(cfg, min_d, max_d, device=device)
    return load_reference_model(model, ckpt).eval()


def _leaves(out):
    """The tensors of a model output in ``jax.tree_util.tree_flatten``'s
    order: tuples and lists in order, dicts by sorted key, None left out."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    return [out]


def cmd_dump(args) -> None:
    import torch

    model = _build(args.model, args.data_type, args.ckpt, args.version, args.device)
    h, w = args.shape or ((480, 640) if args.data_type == "NYU" else (352, 1216))
    x = np.random.RandomState(args.seed).rand(1, h, w, 3).astype(np.float32)
    tensors = {"input": x}
    hooks = []
    if args.intermediates:
        def record(name):
            def hook(module, inputs, output):
                if isinstance(output, torch.Tensor):
                    tensors[f"act:{name}"] = output.detach().float().cpu().numpy()
            return hook
        hooks = [m.register_forward_hook(record(name))
                 for name, m in model.named_modules() if name]
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(x).to(args.device))
    finally:
        for hook in hooks:
            hook.remove()
    for i, leaf in enumerate(_leaves(out)):
        tensors[f"out{i}"] = leaf.detach().float().cpu().numpy()
    np.savez(args.out, **tensors)
    for k, v in tensors.items():
        print(f"{k}: shape={v.shape} sum={v.sum():.6f} mean={v.mean():.6f}")


def cmd_diff(args) -> int:
    a = np.load(args.a)
    b = np.load(args.b)
    keys = sorted(set(a.files) & set(b.files))
    worst = 0.0
    for k in keys:
        if a[k].shape != b[k].shape:
            print(f"{k}: SHAPE MISMATCH {a[k].shape} vs {b[k].shape}")
            worst = float("inf")
            continue
        d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
        print(f"{k}: sum={d.sum():.6e} mean={d.mean():.6e} max={d.max():.6e}")
        worst = max(worst, float(d.max()))
    ok = worst <= args.tol
    print(f"max abs diff {worst:.3e} {'<=' if ok else '>'} tol {args.tol}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("dump")
    pd.add_argument("--model", required=True, choices=["adabins", "newcrfs"])
    pd.add_argument("--ckpt", required=True)
    pd.add_argument("--data-type", default="NYU", choices=["NYU", "KITTI"])
    pd.add_argument("--out", required=True)
    pd.add_argument("--seed", type=int, default=0)
    pd.add_argument("--intermediates", action="store_true",
                    help="also dump every submodule's output (forward hooks)")
    pd.add_argument("--version", default="large07",
                    help="newcrfs encoder version (reference NewCRFDepth.py:28-42)")
    pd.add_argument("--shape", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="override the input resolution (tests use tiny shapes)")
    pd.add_argument("--device", default="cuda", help="cuda (the default) or cpu")

    pf = sub.add_parser("diff")
    pf.add_argument("a")
    pf.add_argument("b")
    pf.add_argument("--tol", type=float, default=1e-3)

    args = p.parse_args(argv)
    if args.cmd == "dump":
        cmd_dump(args)
        return 0
    return cmd_diff(args)


if __name__ == "__main__":
    raise SystemExit(main())
