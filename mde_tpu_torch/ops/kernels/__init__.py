"""The port's hand-written CUDA kernels: build, load, dispatch and count.

Counterpart of ``mde_tpu/ops/pallas/__init__.py``. Each kernel module here
(``window_attention``, ``ordered_attention``, ``depthwise``, ``glu_ff``,
``channel_attention``) holds a ``torch.autograd.Function`` whose forward
(and, where the JAX package has one, backward) is a kernel and, beside
each, the plain PyTorch version of the same function.

Dispatch is by device and nothing else: a tensor on the CPU takes the plain
version, a CUDA tensor launches the kernel or raises. There is no override
and no fallback: a failed build or launch is an error.

The forward entry of every kernel is also an operator of the ``mde``
namespace (``torch.library.custom_op``: ``torch.ops.mde.window_attention``,
``window_attention_qk_v``, ``ordered_attention``, ``depthwise_conv2d``,
``glu_ff``, ``channel_attention``), registered when its module is
imported, so that ``torch.export`` records one node a call
(``tools/torch_export.py``); its fake gives only the output's shape and
dtype. The backward entries stay plain ``ctypes`` calls inside the
``autograd.Function``s.

The kernels are compiled at first use, never at import: every
``csrc/*.cu`` goes through its own ``nvcc`` (all started together) for
``sm_90a``, and the objects are linked into one shared library under
``build/kernels/``, named by a hash of the sources. The library has a plain C
interface and is loaded with ``ctypes``; every entry point returns the CUDA
error code of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

KERNELS = ("window_attention", "window_attention_bwd", "ordered_attention",
           "ordered_attention_bwd", "depthwise_conv2d", "depthwise_conv2d_dxdw",
           "depthwise_conv2d_dw", "glu_ff", "channel_attention", "channel_attention_bwd")

# launches of each kernel since the last reset; a wrapper adds one where it
# launches its kernel, and nowhere else
launch_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# of those, the launches through a kernel's second entry (K1's q|k +
# separate-v entry: ``window_attention_qk_v`` and its backward), by entry
entry_counts: Dict[str, int] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mde_window_attention": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    "mde_window_attention_bwd": [_P] * 10 + [_I] * 7 + [_F, _I, _P],
    "mde_window_attention_smem": [_I] * 4,
    "mde_window_attention_bwd_smem": [_I] * 5,
    "mde_ordered_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "mde_ordered_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _I, _P],
    "mde_ordered_attention_smem": [_I] * 6,
    "mde_ordered_attention_bwd_smem": [_I] * 6,
    "mde_depthwise_conv2d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mde_depthwise_conv2d_dxdw": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mde_depthwise_conv2d_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mde_depthwise_conv2d_smem": [_I] * 2,
    "mde_depthwise_conv2d_dxdw_smem": [_I] * 2,
    "mde_depthwise_conv2d_dw_smem": [_I] * 2,
    "mde_depthwise_conv2d_dw_tiled": [_P, _P, _I, _I, _I],
    "mde_depthwise_bwd_parts": [_I] * 4,
    "mde_glu_ff": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mde_glu_ff_smem": [_I] * 2,
    "mde_channel_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "mde_channel_attention_smem": [_I] * 5,
    "mde_channel_attention_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "mde_channel_attention_bwd_smem": [_I] * 5,
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    entry_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                           "the port's CUDA kernels need the CUDA toolkit")
    return path


def library_digest() -> str:
    """The hash that names the kernel library: of the compiler flags and
    every source under ``csrc/``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (reused while the
    sources are unchanged) and return its path. The ``-Xptxas -v`` report
    of every source (registers, shared memory, spills) is written beside it
    as ``.ptxas.txt``."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / f"libmde_kernels_{library_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                               "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    # wait for every compiler before raising, so that none is left running
    outs = [proc.communicate()[0] for proc in procs]
    reports = []
    for src, proc, out in zip(sources, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        reports.append(f"== {src.name}\n{out}")
    tmp = lib.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stdout}")
    lib.with_suffix(".ptxas.txt").write_text("\n".join(reports))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mde_error_string.argtypes = [ctypes.c_int]
            lib.mde_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


def ptxas_report() -> str:
    """What ``nvcc -Xptxas -v`` said of each kernel in the current build."""
    return build().with_suffix(".ptxas.txt").read_text()


def is_plain(t: torch.Tensor) -> bool:
    """True where the plain version runs (a CPU tensor); False for a CUDA
    tensor, which takes the kernel; raises on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape, dtype and
    device."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_smem(kernel: str, n: int, hd: int, need: int) -> None:
    """Raise unless ``need`` bytes fit a block's shared memory."""
    if need > SMEM_LIMIT:
        raise ValueError(f"{kernel}: N={n}, head dim {hd} needs {need} bytes of shared "
                         f"memory; a block has {SMEM_LIMIT}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(kernel: str, entry: str, device: torch.device, *args,
           counted_entry: Optional[str] = None) -> None:
    """Call one C entry point on ``device``'s current stream, raise if the
    launch failed, and count it (and under ``counted_entry`` too, if
    given)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({lib.mde_error_string(err).decode()})")
    launch_counts[kernel] += 1
    if counted_entry is not None:
        entry_counts[counted_entry] = entry_counts.get(counted_entry, 0) + 1
