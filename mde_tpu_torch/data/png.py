"""PNG reader and writer on numpy and ``zlib``: the port's one PNG path.

The card's machine has no Pillow, so the port decodes the datasets' PNGs
(KITTI's 8-bit RGB images, the uint16 ground truth of KITTI and NYU) and
writes its uint16 predictions itself. Read: 8-bit gray, RGB and RGBA and
16-bit gray, not interlaced, with any of the five row filters; anything
else raises ``ValueError``. Write: 8-bit gray, RGB and RGBA and 16-bit gray,
every row with the Up filter (the first row's Up is plain: there is no row
above it).

Average and Paeth predict a byte from the decoded byte to its left, so rows
are unfiltered by a loop over their bytes in C (``csrc/png_unfilter.c``),
compiled with the host's C compiler at the first decode (never at import)
into ``build/host/``, named by a hash of the source, and called through
``ctypes``, which releases the GIL: the loader's decode threads unfilter in
parallel, as they decompress (``zlib`` releases it too).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> channels
_FORMATS = {(8, 0): 1, (8, 2): 3, (8, 6): 4, (16, 0): 1}
_COLOUR_TYPES = {1: 0, 3: 2, 4: 6}
NONE, SUB, UP, AVERAGE, PAETH = range(5)

UNFILTER_SOURCE = Path(__file__).resolve().parent / "csrc" / "png_unfilter.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CFLAGS = ("-O2", "-std=c99", "-shared", "-fPIC")

_lock = threading.Lock()
_unfilter: Optional[Callable[..., int]] = None


def _unfilter_function() -> Callable[..., int]:
    """``mde_png_unfilter`` from the compiled ``csrc/png_unfilter.c`` (built
    at the first call, reused while the source is unchanged)."""
    global _unfilter
    with _lock:
        if _unfilter is None:
            source = UNFILTER_SOURCE.read_bytes()
            digest = hashlib.sha256(" ".join(CFLAGS).encode() + source).hexdigest()[:16]
            lib = BUILD_DIR / f"libmde_png_{digest}.so"
            if not lib.exists():
                cc = shutil.which("cc") or shutil.which("gcc")
                if not cc:
                    raise RuntimeError("no C compiler (cc or gcc): the PNG codec "
                                       f"compiles {UNFILTER_SOURCE.name} at its first decode")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
                run = subprocess.run([cc, *CFLAGS, str(UNFILTER_SOURCE), "-o", str(tmp)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
                if run.returncode != 0:
                    raise RuntimeError(f"{cc} failed on {UNFILTER_SOURCE.name}:\n{run.stdout}")
                os.replace(tmp, lib)
            fn = ctypes.CDLL(str(lib)).mde_png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 3
            fn.restype = ctypes.c_int64
            _unfilter = fn
    return _unfilter


def read_png(path: str) -> np.ndarray:
    """The image in ``path``: (H, W) uint8 or uint16 for gray, (H, W, 3) or
    (H, W, 4) uint8 for RGB and RGBA."""
    with open(path, "rb") as f:
        return decode_png(f.read(), name=str(path))


def decode_png(data: bytes, name: str = "PNG data") -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    view = memoryview(data)  # chunk bodies without copies
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", view[pos:pos + 8])
        body = view[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if (depth, colour) not in _FORMATS:
        raise ValueError(f"{name}: {depth}-bit PNG of colour type {colour} is not read "
                         f"(8-bit gray, RGB and RGBA and 16-bit gray are)")
    if interlace or compression or filtering:
        raise ValueError(f"{name}: interlaced or non-standard PNG is not read")
    channels = _FORMATS[depth, colour]
    bpp = channels * depth // 8
    size = height * (width * bpp + 1)
    # an output buffer of the image's size: zlib fills it without the GIL
    # and hands it over without a copy
    raw = np.frombuffer(zlib.decompress(idat[0] if len(idat) == 1 else b"".join(idat),
                                        bufsize=size), np.uint8)
    if raw.size != size:
        raise ValueError(f"{name}: {raw.size} bytes of image data for {width}x{height}")
    rows = unfilter(raw.reshape(height, width * bpp + 1), bpp, name)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    return rows.reshape((height, width) if channels == 1 else (height, width, channels))


def unfilter(raw: np.ndarray, bpp: int, name: str = "PNG data") -> np.ndarray:
    """Undo the row filters: ``raw`` (H, 1 + stride) uint8, each row its
    filter type and then its filtered bytes, ``bpp`` bytes a pixel. Returns
    the (H, stride) pixel bytes."""
    raw = np.ascontiguousarray(raw, np.uint8)
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter_function()(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"{name}: unknown PNG row filter {int(raw[bad - 1, 0])} in row "
                         f"{bad - 1}")
    return out


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) uint8 or uint16 gray image, or an (H, W, 3) or
    (H, W, 4) uint8 RGB or RGBA one; every row Up-filtered, deflated at
    zlib's default level."""
    image = np.ascontiguousarray(image)
    channels = 1 if image.ndim == 2 else image.shape[-1] if image.ndim == 3 else 0
    if image.dtype == np.uint16 and channels == 1:
        depth, rows = 16, image.astype(">u2").view(np.uint8)
    elif image.dtype == np.uint8 and channels in _COLOUR_TYPES:
        depth, rows = 8, image
    else:
        raise ValueError(f"cannot write a PNG of {image.dtype} {image.shape} (uint8 gray, "
                         f"RGB or RGBA, or uint16 gray)")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = UP
    filtered[:, 1:] = rows
    filtered[1:, 1:] -= rows[:-1]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPES[channels], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(filtered.tobytes())) + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
