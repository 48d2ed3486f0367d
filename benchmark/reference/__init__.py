"""The benchmark's plain reference: float32 PyTorch copies of the
configurations' models, loss, clip and AdamW, independent of the program
under test (they import nothing of it), and the same code one precision
lower as the control (``layers.Numerics("fp8")``).

``build`` makes a configuration's model through the module of this
package that the configuration's ``reference`` names (its ``build``);
its parameter names are the program's, so one state dict loads into both.
"""

from __future__ import annotations

import importlib
from typing import Tuple

from torch import nn

from .layers import Numerics


def build(config: dict, num: Numerics, input_hw: Tuple[int, int],
          checkpoint_blocks: bool = True) -> nn.Module:
    """The reference of ``config`` (a file of ``benchmark/configs``) for
    images of ``input_hw``, on the current default device."""
    module = importlib.import_module(f"{__name__}.{config['reference']}")
    return module.build(config, num, input_hw, checkpoint_blocks)
