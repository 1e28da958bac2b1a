"""Build and load the hand-written CUDA kernels under splice_tpu_torch/csrc.

Each source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds). All sources build in parallel, once per process, into
splice_tpu_torch/_build (git-ignored), keyed by a hash of the source and
the flags. Nothing here runs at import time: the CPU tests import every
module of the port on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("attention", "conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _target(name: str) -> pathlib.Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


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
    """The loaded kernel library `name` ("attention" or "conv")."""
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
