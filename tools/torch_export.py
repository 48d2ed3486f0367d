"""Export the flagship's serving forward with ``torch.export`` and run it
again from the saved program: the port's counterpart of
``tools/export_aot.py``.

A serving process should not pay for building and initialising the model
in Python at start. This tool traces the flagship ``oda2_red_order_swin2``
(Swin-B, red33 neck, bf16 activations) in eval mode for one serving shape,
``model(x)[0]`` as ``export_aot.py:70`` compiles it, and writes:

  <out>/flagship_<shape>.pt2   the exported program with its weights
                               (``torch.export.save``)
  <out>/meta.json              shape, batch, encoder, the card's name and
                               the hash of the kernel library the program
                               calls

The port's kernels are operators of the ``mde`` namespace
(``torch.ops.mde.*``), so the program holds one node for each kernel call
(the flagship: K1 24, K2 6, K3 6) and runs the same kernels when it is
loaded, in any process that imports the port. ``load_and_run`` (used by the
tests and ``chip_smoke.py``) loads it and runs it on the card.

Usage:
  python tools/torch_export.py --out /tmp/export --shape train --batch 8
  python tools/torch_export.py --check /tmp/export      # load + run + verify
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
from torch import nn  # noqa: E402

SHAPES = {"train": (352, 704), "kitti_test": (352, 1216), "nyu": (480, 640)}


def _build(encoder_type: str, device: str) -> nn.Module:
    from mde_tpu_torch.models import build_model
    cfg = {"name": "oda2_red_order_swin2", "encoder_type": encoder_type, "dec_dim": 512,
           "num_heads": 8, "num_repeats": 3, "num_emb": 128, "window_size": 8,
           "neck_type": "red33"}
    return build_model(cfg, 0.001, 80.0, device=device, seed=0, dtype=torch.bfloat16,
                       use_checkpoint=False)


class ServingForward(nn.Module):
    """The depth map alone, ``model(x)[0]``, of a model in eval mode."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images)[0]


def _program_path(out: str, shape: str) -> str:
    return os.path.join(out, f"flagship_{shape}.pt2")


def export(out: str, shape: str, batch: int, encoder_type: str, model=None, hw=None,
           device: str = "cuda") -> str:
    """Export ``model`` (default: the flagship of ``encoder_type``, weights
    from seed 0) for (batch, *hw, 3) f32 images on ``device`` into
    ``out``; returns ``out``."""
    from mde_tpu_torch.ops import kernels
    model = (model or _build(encoder_type, device)).eval()
    hw = hw or SHAPES[shape]
    device = next(model.parameters()).device
    x = torch.zeros((batch, *hw, 3), device=device)
    with torch.no_grad():
        program = torch.export.export(ServingForward(model), (x,))
    os.makedirs(out, exist_ok=True)
    torch.export.save(program, _program_path(out, shape))
    meta = {"shape": shape, "hw": list(hw), "batch": batch, "encoder_type": encoder_type,
            "device": str(device),
            "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
            "kernel_library": kernels.library_digest()}
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(json.dumps({"exported": out, **meta}))
    return out


def load(out: str) -> nn.Module:
    """The exported serving forward in ``out`` as a module. Raises where
    the program calls another build of the kernels than this checkout's."""
    import mde_tpu_torch.models  # noqa: F401  (registers the torch.ops.mde operators)
    from mde_tpu_torch.ops import kernels
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    if meta["kernel_library"] != kernels.library_digest():
        raise ValueError(f"{out} was exported with kernel library {meta['kernel_library']}, "
                         f"this checkout builds {kernels.library_digest()}")
    return torch.export.load(_program_path(out, meta["shape"])).module()


def load_and_run(out: str, images: torch.Tensor) -> torch.Tensor:
    """Load the exported program and run it on ``images`` (moved to the
    device it was exported on); returns the depth map."""
    with open(os.path.join(out, "meta.json")) as f:
        device = json.load(f)["device"]
    module = load(out)
    with torch.no_grad():
        return module(images.to(device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None)
    p.add_argument("--check", default=None, help="load an exported dir and run a zero batch")
    p.add_argument("--shape", default="train", choices=sorted(SHAPES))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--encoder", default="base")
    args = p.parse_args(argv)
    if args.check:
        with open(os.path.join(args.check, "meta.json")) as f:
            meta = json.load(f)
        pred = load_and_run(args.check, torch.zeros((meta["batch"], *meta["hw"], 3)))
        if not torch.isfinite(pred).all():
            raise SystemExit("the exported program gave non-finite depths")
        print(json.dumps({"check": "ok", "pred_shape": list(pred.shape)}))
        return 0
    export(args.out or "./export", args.shape, args.batch, args.encoder)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
