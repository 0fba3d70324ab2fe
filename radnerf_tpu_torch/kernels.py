"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one source in `csrc/` with a plain C entry point. It is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under
`_build/` (git-ignored) at first use, and called through `ctypes`: no
PyTorch headers, so a build takes seconds. A library's file name carries
a hash of its source and flags, so an edited source is rebuilt.

Every entry point takes raw device pointers and the CUDA stream, launches
on that stream without synchronising, and returns `cudaGetLastError()`;
`launch` raises on a nonzero code and only then counts the launch.

`-fmad=false`: the kernels' float arithmetic must round exactly as their
plain PyTorch twins do (row ids and occupancy cells are compared for
equality), so nvcc may not contract a*b+c on its own; the fused
multiply-adds the reference has are written as `__fmaf_rn`. Never
`--use_fast_math`: division and `frexpf` must be IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _I32, _F32 = (
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
)

# kernel name -> (source in csrc/, C entry point argtypes)
KERNELS = {
    # (packed, x, out, n, n_levels, rows_per_level, scales, nps, dense,
    #  stream)
    "brick3_encode_fwd": (
        "brick3_encode_fwd.cu",
        (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P),
    ),
    # (xyz, dt, occ, out, n, cascades, grid_size, scale, stream)
    "occ_lookup": (
        "occ_lookup.cu",
        (_P, _P, _P, _P, _I64, _I32, _I32, _F32, _P),
    ),
}

# launches per kernel since the last reset (see reset_launch_counts)
launch_counts = {name: 0 for name in KERNELS}
_entry = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from csrc/ on a machine with the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None, ptxas_info: bool = False) -> dict:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together. Returns
    {name: (seconds, nvcc stderr)}; raises if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_info:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, str(CSRC / KERNELS[name][0])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def _entry_point(name: str):
    fn = _entry.get(name)
    if fn is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = KERNELS[name][1]
        fn.restype = ctypes.c_int
        _entry[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point; raise on a CUDA error."""
    err = _entry_point(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    launch_counts[name] += 1
