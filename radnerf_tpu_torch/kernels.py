"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is a plain C entry point of a source in `csrc/` (one source
may hold several). A source is compiled by `nvcc` for Hopper (`sm_90a`)
into a shared library under `_build/` (git-ignored) at first use, and
its entry points are called through `ctypes`: no PyTorch headers, so a
build takes seconds. A library's file name carries a hash of its source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source or
header is rebuilt.

Every entry point takes raw device pointers and the CUDA stream, launches
on that stream without synchronising, and returns `cudaGetLastError()`;
`launch` raises on a nonzero code and only then counts the launch, as
counter `launch.<kernel>` of `utils.trace`.

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

from .utils import trace

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
    # (table, table_is_f32, x, out, n, n_levels, rows_per_level, scales,
    #  nps, dense, stream)
    "brick3_encode_fwd": (
        "brick3_encode_fwd.cu",
        (_P, _I32, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P),
    ),
    # (x, g, out, n, n_levels, rows_per_level, scales, nps, dense, stream)
    "brick3_table_grad": (
        "brick3_table_grad.cu",
        (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P),
    ),
    # (xyz, dt, occ, out, n, cascades, grid_size, scale, stream)
    "occ_lookup": (
        "occ_lookup.cu",
        (_P, _P, _P, _P, _I64, _I32, _I32, _F32, _P),
    ),
    # (keys, vals, out, n, n_levels, table_size, stream): the tcnn, slab
    # and brick table gradients, one source
    **{name: ("stream_table_grad.cu", (_P, _P, _P, _I64, _I32, _I64, _P))
       for name in ("tcnn_table_grad", "slab_table_grad",
                    "brick_table_grad")},
    # the examples' microbenchmark kernels (radnerf_tpu_torch/examples/);
    # tal_sublane stages the table, tal_sublane_l2 takes tables too large
    # to stage
    # (tbl, rows, out, n, n_rows, stream)
    **{name: ("vmem_gather.cu", (_P, _P, _P, _I64, _I32, _P))
       for name in ("tal_sublane", "tal_sublane_l2")},
    # (tbl, row, lane, out, n, n_rows, stream)
    "rowgather_onehot": ("vmem_gather.cu",
                         (_P, _P, _P, _P, _I64, _I32, _P)),
    # (table, idx, out, m, t, stream)
    "pallas_gather": ("proto_gather.cu", (_P, _P, _P, _I64, _I64, _P)),
    # (idx, vals, out, m, t, stream)
    "pallas_scatter": ("proto_gather.cu", (_P, _P, _P, _I64, _I64, _P)),
}

_entry = {}


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


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:12]}.so"


def build(names=None, ptxas_info: bool = False) -> dict:
    """Compile the sources of the named kernels (default: all) that are
    not built yet, one nvcc process per source, all started together.
    Returns {source: (seconds, nvcc stderr)}; raises if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    sources = dict.fromkeys(KERNELS[n][0] for n in names)
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for source in todo:
        out = library_path(source)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_info:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, str(CSRC / source)]
        procs[source] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    done, failed = {}, []
    for source, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[source] = (time.perf_counter() - t0, log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"{source}: nvcc exit {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def _entry_point(name: str):
    fn = _entry.get(name)
    if fn is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(KERNELS[name][0])))
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
    trace.count(f"launch.{name}")


def launches() -> dict:
    """Launches of each kernel since the last `trace.reset()` (the
    registry's `launch.<kernel>` counters)."""
    c = trace.counters()
    return {k: c.get(f"launch.{k}", 0) for k in KERNELS}
