"""Build and load the hand-written CUDA kernels under splice_tpu_torch/csrc.

Each source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds). All sources build in parallel, once per process, into
splice_tpu_torch/_build (git-ignored), keyed by a hash of the source, the
headers it includes from csrc (`#include "x.cuh"`, recursively) and the
flags. Nothing here runs at import time: the CPU tests import every
module of the port on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("attention", "conv", "probe")
# --split-compile=0: the device optimiser runs on every core (the conv
# library's 60-odd template instances took 116 s on one, 47 s split, on the
# H100 machine's 8 cores)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# dtype codes of the C entry points
DTYPES = {"float32": 0, "bfloat16": 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of splice_tpu_torch are built from source")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: pathlib.Path, seen=None) -> list:
    """path and every file it includes by a quoted #include, recursively,
    each once, in the order they are first reached."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str) -> pathlib.Path:
    """The library of csrc/{name}.cu, named by a hash of its text, its
    headers' and the flags: an edited header builds a new library."""
    h = hashlib.sha256()
    for f in _sources(CSRC_DIR / f"{name}.cu"):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every kernel source that is not built yet (one nvcc process
    per source, all started together) and load the libraries. Raises with
    the compiler's output when a build fails."""
    with _lock:
        missing = [n for n in SOURCES if n not in _libs]
        if not missing:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in missing:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in missing:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (one of SOURCES)."""
    return build_all()[name]


def check_cuda_tensors(name: str, *ts) -> int:
    """Raise unless every tensor is a contiguous CUDA tensor of one type the
    kernels take; return that type's dtype code."""
    codes = {str(t.dtype).removeprefix("torch.") for t in ts}
    if len(codes) != 1 or not codes <= set(DTYPES) or not all(
            t.is_cuda and t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: needs contiguous CUDA tensors of one type, "
                         f"float32 or bfloat16; got "
                         f"{[(t.dtype, str(t.device)) for t in ts]}")
    return DTYPES[codes.pop()]


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
