"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` (one ``nvcc`` process
per source, all started together) and link into one shared library with
a plain C interface, loaded with ctypes. The library lands in
``build/phdslam_tpu_torch/<hash of the sources, headers and flags>/`` at
the root of
the checkout (listed in ``.gitignore``) on first use, so a fresh checkout
builds once and later processes reuse the file. Nothing here runs at
import time: machines without ``nvcc`` import the package and use the
plain twins on CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "phdslam_tpu_torch")
LIB_NAME = "libphdslam_kernels.so"
# --fmad=false keeps each multiply and add a separate f32 rounding, as the
# plain twins' elementwise PyTorch ops round, so kernel and twin agree
# to reduction order only
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

# launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel (never for a CPU tensor that runs the twin)
launch_counts: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # planes, z4, vals, idx, norm, count, cons (NULL: plain), P, K, M, T,
    # min_fw, cb, min_sep, adaptive, stream
    "phd_detect": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                   _I, _P],
    # idx, tab, out, P, C, R, cap, stream
    "phd_gather_cols": [_P, _P, _P, _I, _I, _I, _I, _P],
    # idx, tab, out, P, R, C, cap, stream
    "phd_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # packed, out, P, N, K, min_separation, argmax, metric, stream
    "phd_merge2d": [_P, _P, _I, _I, _I, _F, _I, _I, _P],
    # ints, flts, t_k, t_m, out, P, N, K tables, M tables, K out,
    # min_separation, metric, stream
    "phd_merge2d_tables": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                           _P],
    # packed, out, P, N, K, min_separation, stream
    "phd_merge3d": [_P, _P, _I, _I, _I, _F, _P],
    # packed, out, P, N, K, min_separation, stream
    "phd_merge4d": [_P, _P, _I, _I, _I, _F, _P],
}

_lib = None
last_build_log = ""


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    # PyTorch's own toolkit lookup: CUDA_HOME, CUDA_PATH, nvcc on PATH,
    # then the toolkit's default install directory
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):       # the sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this source hash is already built."""
    global last_build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # compile and link in a private directory, then rename the library into
    # place: concurrent builders never see a half-written file
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        lib = Path(tmp) / LIB_NAME
        link = [nvcc, "-shared", "-o", str(lib), *map(str, objs)]
        failed = any(proc.returncode != 0 for proc in procs)
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            cmds.append(link)
            logs.append(proc.stdout + proc.stderr)
            failed = proc.returncode != 0
        last_build_log = "".join(
            f"{' '.join(cmd)}\n{log}" for cmd, log in zip(cmds, logs)) \
            + f"built in {time.perf_counter() - t0:.1f} s\n"
        if failed:
            raise RuntimeError(f"nvcc failed:\n{last_build_log}")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(cond: bool, msg: str) -> None:
    """Validate a kernel argument before its pointer reaches the library."""
    if not cond:
        raise ValueError(msg)
