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

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..runtime import profiling

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
# launches its kernel (never for a CPU tensor that runs the twin), inside
# the launch's span ``kernel.<name>`` (``profiling.kernel``); the counter
# is ``profiling.launch_counts``
launch_counts = profiling.launch_counts

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # planes, z4, vals, idx, norm, count, cons (NULL: plain), P, K, M, T,
    # min_fw, cb, min_sep, stream
    "phd_detect": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                   _P],
    # idx, tab, out, P, C, R, cap, staged, vec, stream
    "phd_gather_cols": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # idx, tab, out, P, R, C, cap, staged, vec, stream
    "phd_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # packed, out, P, N, K, min_separation, argmax, metric, stream
    "phd_merge2d": [_P, _P, _I, _I, _I, _F, _I, _I, _P],
    # ints, flts, t_k, t_m, scratch (NULL: no overflow), out, P, N,
    # K tables, M tables, K out, min_separation, metric, stream
    "phd_merge2d_tables": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                           _I, _P],
    # P, N, argmax, metric, tables, out int[7] (the launch plan)
    "phd_merge2d_plan": [_I, _I, _I, _I, _I, _P],
    # packed, out, P, N, K, min_separation, argmax, metric, stream
    "phd_merge3d": [_P, _P, _I, _I, _I, _F, _I, _I, _P],
    "phd_merge4d": [_P, _P, _I, _I, _I, _F, _I, _I, _P],
    # P, N, argmax, metric, out int[7] (the launch plan)
    "phd_merge3d_plan": [_I, _I, _I, _I, _P],
    "phd_merge4d_plan": [_I, _I, _I, _I, _P],
    # the staged wide-lane variants: packed, out, spill f32[P, C - 1, X]
    # and states uint8[P, X] (X: the plan's overflow; NULL when 0), P, N,
    # K, min_separation, argmax, metric, stream
    "phd_merge2d_wide": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "phd_merge3d_wide": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "phd_merge4d_wide": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    # ints, flts, t_k, t_m, spill f32[P, 6, X], states uint8[P, X] (NULL:
    # no overflow), out, P, N, K tables, M tables, K out, min_separation,
    # metric, stream
    "phd_merge2d_tables_wide": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _F, _I, _P],
    # P, N, argmax, metric, tables, out int[7]
    "phd_merge2d_wide_plan": [_I, _I, _I, _I, _I, _P],
    # P, N, argmax, metric, out int[7]
    "phd_merge3d_wide_plan": [_I, _I, _I, _I, _P],
    "phd_merge4d_wide_plan": [_I, _I, _I, _I, _P],
    # planes, z4, vals, idx, norm, count, cons (NULL: plain), words
    # uint32[P, M, ceil(K / 32)] (cons where its plan is not staged, else
    # NULL), P, K, M, T, min_fw, cb, min_sep, stream
    "phd_detect_wide": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                        _F, _F, _P],
    # K, out int[5] (detect_wide's launch: threads, shared bytes, staged,
    # registers, blocks an SM)
    "phd_detect_wide_plan": [_I, _P],
    # K, M, out int[5] (detect_cons_wide's launch, the same keys)
    "phd_detect_cons_wide_plan": [_I, _I, _P],
    # log_cn, log_cn_birth, out, P, C1, stream (cardinality.cu)
    "phd_cardinality_predict": [_P, _P, _P, _I, _I, _P],
    # pairs, seed, mode, counts int64[3], stream (merge_core_check.cu)
    "phd_merge_recip_check": [ctypes.c_ulonglong, ctypes.c_ulonglong, _I,
                              _P, _P],
}

# shared memory a gather block may take for its particle's staged table
# slab: two such blocks fit on an H100 SM (228 KB). A larger slab is read
# through __ldg by the same kernel, counted under the "_ldg" name.
GATHER_SMEM_BUDGET = 96 * 1024

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


def gather_staged(n_floats: int) -> bool:
    """Whether a gather stages a per-particle slab of ``n_floats`` in
    shared memory (csrc/bulk_copy.cuh::staged_smem_bytes within
    GATHER_SMEM_BUDGET)."""
    return 16 + 4 * n_floats + 16 <= GATHER_SMEM_BUDGET


def stream_handle(device: torch.device) -> int:
    # the raw handle of the device's current stream, read without building
    # a torch.cuda.Stream object (microseconds a launch on the host)
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_gather(name: str, idx, tab, C: int, R: int) -> None:
    """The gathers' arguments: int32 idx [P, cap] and float32 tab [P, ...]
    of C columns by R gathered rows, both contiguous on one CUDA device,
    and a particle's table and output under 2**31 elements (the kernels'
    offsets inside a particle are 32-bit). The message is formatted only on
    a failure, so a passing check costs the host little."""
    if (tab.is_cuda and idx.dim() == 2 and idx.shape[0] == tab.shape[0]
            and idx.dtype == torch.int32 and tab.dtype == torch.float32
            and idx.get_device() == tab.get_device()
            and idx.is_contiguous() and tab.is_contiguous()
            and C * max(R, idx.shape[1]) < 2 ** 31):
        return
    raise ValueError(
        f"{name}: needs int32 idx [P, cap] and float32 tab [P, ...], "
        f"contiguous on one CUDA device, under 2**31 elements a particle; "
        f"got idx {tuple(idx.shape)} {idx.dtype} on {idx.device}, tab "
        f"{tuple(tab.shape)} {tab.dtype} on {tab.device}")


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(cond: bool, msg: str) -> None:
    """Validate a kernel argument before its pointer reaches the library."""
    if not cond:
        raise ValueError(msg)
