"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by nvcc into a shared library with a plain C
interface and loaded with ctypes. Libraries are named by a hash of the
source, the `csrc/*.cuh` headers it includes and the flags, and land in
`<repo>/build/kernels/` (listed in .gitignore; `PORTFOLIOOPTGP_BUILD_DIR`
overrides it), so an unchanged source is built once per checkout. Nothing here runs at import time: the
first launch builds, or `build()` builds every source at once, one nvcc
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = {"stationary_nll": "stationary_nll.cu", "blocked_panel": "blocked_panel.cu",
           "trinv": "trinv.cu", "dense_nll": "dense_nll.cu", "svgp_gram": "svgp_gram.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def build_dir() -> str:
    return os.environ.get("PORTFOLIOOPTGP_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _source_files(name: str) -> list:
    """The source of `name` and every header of CSRC that it includes,
    directly or through another header, in the order first met."""
    files, todo = [], [SOURCES[name]]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        with open(os.path.join(CSRC, f), "rb") as fh:
            todo += [inc.decode() for inc in _INCLUDE.findall(fh.read())
                     if os.path.exists(os.path.join(CSRC, inc.decode()))]
    return files


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _source_files(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named sources (default: all) that are not built yet, in
    parallel. Returns {name: seconds spent} and prints nvcc's register and
    shared-memory report when `verbose`. Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        if verbose and log:
            print(log, flush=True)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


# The arrival tickets of the kernels' last-CTA reductions (csrc/svgp_gram.cu,
# the stationary NLL backward): int32 zeros, which every launch leaves zero.
# One buffer per device and stream, shared by the kernels, since launches on
# one stream never overlap.
_TICKETS: dict = {}


def tickets(device, stream, n: int):
    """At least n zeroed int32 arrival tickets for a launch on `stream`."""
    import torch

    buf = _TICKETS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _TICKETS[(device, stream)] = torch.zeros((max(n, 4096),), dtype=torch.int32,
                                                       device=device)
    return buf
