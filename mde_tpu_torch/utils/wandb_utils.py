"""wandb logging (``mde_tpu/utils/wandb_utils.py``; reference ``utils/wandb_utils.py:8-45``).

Primary-process-only init with project/entity/name/id/notes/tags from the
config's ``wandb`` section, ``resume='allow'``, mode online/offline/disabled.
Gated: if wandb is unavailable (not installed / no network), degrades to a
no-op stub so training never depends on it.
"""

from __future__ import annotations

from typing import Optional

from ..core.dist import is_primary


class _NoopRun:
    dir = "."

    def log(self, *a, **k):
        pass

    def finish(self, *a, **k):
        pass


def set_wandb(opt, force_mode: Optional[str] = None):
    """Returns (run, run_dir). Non-primary processes and disabled/broken
    wandb environments get a no-op run."""
    if not is_primary():
        return _NoopRun(), "."

    cfg = opt.get("wandb", {}) or {}
    mode = force_mode or cfg.get("mode", "disabled")
    if mode == "disabled":
        return _NoopRun(), "."

    try:
        import wandb
        run = wandb.init(
            project=cfg.get("project", "mde_tpu"),
            entity=cfg.get("entity", None),
            name=cfg.get("name", None),
            id=cfg.get("id", None),
            notes=cfg.get("notes", None),
            tags=cfg.get("tags", [opt.get("dataset", {}).get("data_type", "")]),
            mode=mode,
            resume="allow",
            config=opt.to_dict() if hasattr(opt, "to_dict") else dict(opt),
        )
        return run, run.dir
    except Exception as e:  # no network / not installed -> degrade
        print(f"[wandb disabled: {e}]")
        return _NoopRun(), "."
