"""ctypes binding of the native image decoder (twin of
radnerf_tpu/data/native.py).

The library is the repository's `native/libradnerf_io.so` (built from
`native/radnerf_io.cpp`, linked to libpng and libjpeg). Where it does not
load (absent, or its libpng / libjpeg missing), it is built from the same
source with g++ into the git-ignored `radnerf_tpu_torch/_build/`, never
into `native/`. Where that fails too, `load_images` returns None and the
caller decodes in Python (color_utils.read_image), and `morton3d_cpu`
returns None; `unavailable_reason` then says why (the loader's OSError,
or the last line of g++'s error).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
NATIVE_LIB = _REPO / "native" / "libradnerf_io.so"
NATIVE_SRC = _REPO / "native" / "radnerf_io.cpp"
BUILT_LIB = Path(__file__).resolve().parents[1] / "_build" / "libradnerf_io.so"

_lib = None
_tried = False
_reasons = []             # why each library path did not load or build


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.radnerf_load_images.restype = ctypes.c_int
    lib.radnerf_load_images.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.radnerf_morton3d.restype = None
    lib.radnerf_morton3d.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _last_line(text) -> str:
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    lines = [ln.strip() for ln in (text or "").splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def _build() -> bool:
    """g++ native/radnerf_io.cpp -> _build/libradnerf_io.so (atomically);
    on failure, the reason joins _reasons."""
    BUILT_LIB.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILT_LIB.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
             str(NATIVE_SRC), "-lpng", "-ljpeg", "-lpthread"],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, BUILT_LIB)
        return True
    except subprocess.CalledProcessError as e:
        _reasons.append(f"g++ failed: {_last_line(e.stderr)}")
        return False
    except (OSError, subprocess.SubprocessError) as e:
        _reasons.append(f"g++ did not run: {e}")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    for path in (NATIVE_LIB, BUILT_LIB):
        if path == BUILT_LIB and not path.exists() and not _build():
            break
        try:
            _lib = _bind(path)
            break
        except (OSError, AttributeError) as e:
            _reasons.append(
                f"{path.parent.name}/{path.name} did not load: {e}")
            continue
    return _lib


def unavailable_reason() -> str | None:
    """Why the native library is not in use (None where it loaded): what
    loading native/libradnerf_io.so said, and what building it said."""
    if _load() is not None:
        return None
    return "; ".join(_reasons) or "not tried"


def load_images(
    paths: list[str],
    img_wh: tuple[int, int],
    blend_a: bool = True,
    unpad: int = 0,
) -> np.ndarray | None:
    """Threaded native decode of a batch of images.

    Returns (n, W*H, 3) float32 in [0, 1] (the ray-store layout of
    color_utils.read_image), or None when the native library is
    unavailable or any image fails to decode (caller falls back to the
    Python loader)."""
    lib = _load()
    if lib is None or not paths:
        return None
    if any(
        not p.lower().endswith((".png", ".jpg", ".jpeg")) for p in paths
    ):
        return None
    w, h = img_wh
    out = np.empty((len(paths), h * w * 3), np.float32)
    blob = b"\x00".join(p.encode() for p in paths) + b"\x00"
    ok = lib.radnerf_load_images(
        blob, len(paths), w, h, int(blend_a), int(unpad), 0,  # 0: all cores
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if ok != len(paths):
        return None
    return out.reshape(len(paths), h * w, 3)


def morton3d_cpu(coords: np.ndarray) -> np.ndarray | None:
    """(n, 3) integer coords -> (n,) int32 Morton indices from the native
    library's radnerf_morton3d (ops/morton.py's morton3d on the host), or
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, np.int32)
    out = np.empty(len(coords), np.int32)
    lib.radnerf_morton3d(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(coords),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
