"""Golden-image regression of the PyTorch port: the counterpart of
``tools/golden_check.py``.

Writes predictions with the port's ``Trainer.predict`` and compares them
with a golden directory (``utils/golden.compare_png_dirs``): the
reference's ``cherrypick/`` fixtures once released weights are loaded, or
goldens captured from an earlier run, to catch drift between versions.
``--ckpt`` is the checkpoint the trainer resumes from (the config's
``checkpoint``, the key the driver reads; JAX's tool sets
``resume_from``, which its driver never reads).

Usage:
    python tools/torch_golden_check.py --config x.json --ckpt <dir> \\
        --golden-dir <dir> [--tolerance 0] [--visualize] [--device cuda]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--golden-dir", required=True)
    p.add_argument("--tolerance", type=float, default=0.0)
    p.add_argument("--out-dir", default=None, help="keep predictions here (default: temp dir)")
    p.add_argument("--visualize", action="store_true",
                   help="also write colorized maps next to the PNGs")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from mde_tpu_torch.core.config import parse
    from mde_tpu_torch.train.driver import Trainer
    from mde_tpu_torch.utils.golden import compare_png_dirs, summarize

    opt = parse(args.config, dump_option=False)
    if args.ckpt:
        opt["checkpoint"] = args.ckpt
    trainer = Trainer(opt, device=args.device)
    trainer.init_state()
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="golden_pred_")
    trainer.predict(out_dir, visualize=args.visualize)
    report = compare_png_dirs(out_dir, args.golden_dir, tolerance=args.tolerance)
    print(summarize(report))
    ok = all(r["pass"] for r in report.values())
    print(json.dumps({"golden_pass": ok, "files": len(report)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
