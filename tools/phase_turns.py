"""Time kernel phases of two checkouts in turns on one card.

    python3 tools/phase_turns.py OTHER_TREE [PHASE ...]

Runs each checkout's own ``chip_smoke.py`` phase functions, each checkout in
processes of its own (its kernels built from its own sources into its own
``build/kernels/``), in the order other, this, this, other, and prints the
device ms of each phase per run and one JSON line of them all. OTHER_TREE
is another checkout of the repo, e.g. the parent commit unpacked with
``git archive`` into ``chip_trees/``. PHASE names are keys of PHASES
(default: all). Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# phase name -> the chip_smoke call that runs it (dev: the card)
PHASES = {"K4": "glu_phase(dev)", "K5 fwd": "channel_phase(dev, False)",
          "K5 bwd": "channel_phase(dev, True)",
          "K5 bwd stage 1": "channel_phase(dev, True, 128)",
          "K5 bwd stage 2": "channel_phase(dev, True, 256)",
          "K3 dxdw": "depthwise_bwd_phase(dev, True)",
          "K3 dw": "depthwise_bwd_phase(dev, False)"}
SETUP = """
import json, torch, chip_smoke as cs
from mde_tpu_torch.ops import kernels
kernels.build()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
"""


def run(tree: Path, phases: list) -> dict:
    """{phase: device ms} from one process in ``tree``."""
    calls = ", ".join(f"{name!r}: cs.{PHASES[name]}['ms']" for name in phases)
    code = SETUP + f"print('PHASE_MS ' + json.dumps({{{calls}}}))"
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"phases failed in {tree}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PHASE_MS ")][-1]
    return json.loads(line[len("PHASE_MS "):])


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    phases = sys.argv[2:] or list(PHASES)
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        print(f"phase_turns: unknown phases {unknown}; known: {list(PHASES)}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    runs = []
    for tag, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        ms = run(tree, phases)
        runs.append({"tree": tag, "ms": ms})
        print(f"{tag} ({tree}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
              flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
