"""Build and bind the port's CUDA sources.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface, in ``build/`` at the root of the checkout, named
by the hash of the source and its flags (an edited source rebuilds), and
loaded with ``ctypes``; the headers beside the sources (``*.cuh``) count
in the hash. ``build_many`` starts one ``nvcc`` per source, all
together, and waits for them; ptxas' report (registers, spills) of each
build is kept in ``BUILD_INFO`` under the source's file name. Nothing here
runs at import: the CPU tests import every module on a machine without the
CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# sm_90a: Hopper, with its architecture-specific instructions
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source file name -> ptxas' report of its last build
BUILD_INFO: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       f"from {CSRC} with the CUDA toolkit")


def library_path(source: Path, flags) -> Path:
    """The library of ``source`` built with ``flags``, named by the hash of
    the source, of every header (``*.cuh``) beside it, which a source may
    include, and of the flags: an edited header rebuilds too."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"


def build_many(specs, force: bool = False) -> list:
    """``specs``: ``(source, flags)`` pairs. Compiles every library that is
    missing (or all, with ``force``), one ``nvcc`` per source started
    together; returns the libraries' paths in order."""
    libs = [library_path(src, flags) for src, flags in specs]
    jobs = []
    for (src, flags), lib in zip(specs, libs):
        if lib.exists() and not force:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc(), *flags, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src}:\n{err}")
            continue
        os.replace(tmp, lib)
        BUILD_INFO[src.name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path, flags, signatures: dict):
    """Build ``source`` if needed and bind it: ``signatures`` maps each C
    function to its ``argtypes``; every function returns an int (0, or the
    ``cudaError_t`` of its launch)."""
    lib = ctypes.CDLL(str(build_many([(source, flags)])[0]))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream_of(t):
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def aligned(t):
    """``t`` itself, or a contiguous copy where a kernel's 16-byte vector
    loads could not read it."""
    import torch
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def route(x, what: str) -> str:
    """'plain' for CPU tensors, 'cuda' for CUDA tensors, 'meta' for
    shape-only meta tensors (the wrapper returns empty outputs of its
    kernel's shapes and dtypes); any other device is refused."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type in ("cuda", "meta"):
        return x.device.type
    raise ValueError(f"no {what} kernel for device {x.device}")
