"""The runtime's C++ part: ``textio.cpp``, the state-log writer, with a
plain C interface loaded with ctypes.

The source compiles with ``g++`` on first use into
``build/phdslam_tpu_torch/native/<hash of the source and flags>/`` at the
root of the checkout (listed in ``.gitignore``), so a fresh checkout
builds once and later processes reuse the file. The compile and link run
in a private directory and the library is renamed into place, so
processes that build at once never load a half-written file. A failed
build raises with the compiler's output; there is no fallback.
``runtime/io.py`` keeps the pure-Python writer as the plain version the
tests hold it to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ...kernels.build import BUILD_ROOT

SRC = Path(__file__).resolve().parent
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # path, vals f64, lens i64, kinds i32, n_lines
    "textio": {"phd_textio_write": [ctypes.c_char_p, _P, _P, _P, _I64]},
}
_libs: dict = {}


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("native runtime: no C++ compiler (g++ or c++) on "
                       "PATH")


def library_path(name: str, root: Path = BUILD_ROOT) -> Path:
    """Where ``<name>.cpp``'s library lands under ``root``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SRC / f"{name}.cpp").read_bytes())
    return Path(root) / "native" / h.hexdigest()[:16] / f"lib{name}.so"


def compile_library(src: Path, out: Path) -> Path:
    """Compile ``src`` into the shared library ``out`` unless it exists:
    in a private directory beside ``out``, renamed into place. Raises
    RuntimeError with the compiler's output when it fails."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        cmd = [_cxx(), *CXX_FLAGS, str(src), "-o", str(lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native runtime: {' '.join(cmd)} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out


def library(name: str, root: Path = BUILD_ROOT) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp`` ("textio"), built first if
    needed."""
    key = (name, str(root))
    lib = _libs.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(compile_library(SRC / f"{name}.cpp",
                                              library_path(name, root))))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[key] = lib
    return lib


def _check(err: int, what: str, path) -> None:
    if err:
        raise OSError(err, f"{what}: {os.strerror(err)}", str(path))


# the kinds of a log line (textio.cpp::phd_textio_write)
LINE_G, LINE_INT, LINE_MAP = 0, 1, 2


def write_lines(path, lines, root: Path = BUILD_ROOT) -> None:
    """Append lines of numbers to a text file, each number followed by a
    space, then a newline: ``lines`` holds (kind, values) pairs, kind
    :data:`LINE_G` ("%g"), :data:`LINE_INT` (integers) or
    :data:`LINE_MAP` ("%g"; an empty one is a bare newline, where an
    empty line of the other kinds is " \\n")."""
    arrs = [np.asarray(v, np.float64).reshape(-1) for _, v in lines]
    vals = np.ascontiguousarray(np.concatenate(arrs) if arrs
                                else np.zeros(0))
    lens = np.asarray([len(a) for a in arrs], np.int64)
    kinds = np.asarray([k for k, _ in lines], np.int32)
    _check(library("textio", root).phd_textio_write(
        os.fsencode(path), vals.ctypes.data, lens.ctypes.data,
        kinds.ctypes.data, len(lines)), "write", path)

