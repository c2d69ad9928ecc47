"""ctypes bindings for the native C++ CSV loader, built on first use.

Port of portfoliooptgp_tpu/native/__init__.py. `csrc/csv_loader.cc` is
compiled by g++ into the directory of the CUDA libraries
(`ops/cuda_build.build_dir()`: `<repo>/build/kernels/`, listed in
.gitignore), named by a hash of the source and the flags, through a
temporary file and `os.replace`, so processes that build it at once each
load a whole library. `available()` says whether it built; a failed build
is reported by a warning with g++'s output, and `load_eod` then raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from typing import Sequence

import numpy as np

from portfoliooptgp_tpu_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "csv_loader.cc")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_error = None


class _EodTable(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("dates", ctypes.POINTER(ctypes.c_int64)),
        ("open", ctypes.POINTER(ctypes.c_double)),
        ("high", ctypes.POINTER(ctypes.c_double)),
        ("low", ctypes.POINTER(ctypes.c_double)),
        ("close", ctypes.POINTER(ctypes.c_double)),
        ("adjusted_close", ctypes.POINTER(ctypes.c_double)),
        ("volume", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(cuda_build.build_dir(), f"libcsvloader-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the loader unless it is built; returns the library's path.
    Raises with g++'s output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build the CSV loader: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build the CSV loader:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = build()
        except RuntimeError as exc:
            _build_error = str(exc)
            warnings.warn(f"native CSV loader unavailable, pandas parses instead: {exc}")
            return None
        lib = ctypes.CDLL(path)
        lib.eod_parse.restype = ctypes.POINTER(_EodTable)
        lib.eod_parse.argtypes = [ctypes.c_char_p]
        lib.eod_free.restype = None
        lib.eod_free.argtypes = [ctypes.POINTER(_EodTable)]
        lib.eod_parse_many.restype = None
        lib.eod_parse_many.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(_EodTable)), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def _loaded():
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native CSV loader unavailable: {_build_error}")
    return lib


def _table_to_dict(lib, ptr):
    t = ptr.contents
    try:
        if t.error:
            raise IOError(t.error.decode())
        n = t.n_rows
        out = {"dates": np.ctypeslib.as_array(t.dates, shape=(n,)).copy()}
        for name in ("open", "high", "low", "close", "adjusted_close", "volume"):
            out[name] = np.ctypeslib.as_array(getattr(t, name), shape=(n,)).copy()
        return out
    finally:
        lib.eod_free(ptr)


def load_eod(path: str) -> dict:
    """Parse one EOD CSV into numpy columns; `dates` are int64 days since
    the unix epoch."""
    lib = _loaded()
    return _table_to_dict(lib, lib.eod_parse(os.fspath(path).encode()))


def load_eod_many(paths: Sequence[str], n_threads: int = 8) -> list:
    """Parse several EOD CSVs in one call over `n_threads` threads."""
    lib = _loaded()
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[os.fspath(p).encode() for p in paths])
    out = (ctypes.POINTER(_EodTable) * n)()
    lib.eod_parse_many(arr, n, out, n_threads)
    return [_table_to_dict(lib, out[i]) for i in range(n)]
