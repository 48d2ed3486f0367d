"""Shared arithmetic of the kernel ops' work counts: the bytes of the
tensors an op's profiler record lists (its ``Input Dims`` and ``Input
type``), each input read once and the output written once."""

from __future__ import annotations

import math
from typing import Optional, Sequence

SIZES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "int": 4, "long int": 8,
         "double": 8, "unsigned char": 1, "bool": 1, "signed char": 1, "short int": 2}


def nbytes(dims: Optional[Sequence[int]], dtype: str) -> int:
    """Bytes of a tensor of ``dims`` and the profiler's type name; 0 for an
    absent tensor (empty dims)."""
    if not dims:
        return 0
    if dtype not in SIZES:
        raise ValueError(f"unknown element type {dtype!r}")
    return math.prod(dims) * SIZES[dtype]
