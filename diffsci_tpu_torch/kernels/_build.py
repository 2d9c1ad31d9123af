"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``_build/`` (git-ignored) at first
use, and loaded with ``ctypes``. The library's file name carries a hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. ``build()`` starts one ``nvcc`` per missing source, all at
once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_precondition", "fused_norm", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA toolkit's nvcc: on the PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/ with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """The library's path; its hash covers the source, every shared header
    of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet."""
    with _lock:
        jobs = []
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            jobs.append((name, tmp, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, tmp, so, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, so)
        if failures:
            raise RuntimeError("\n".join(failures))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. ``signatures``
    maps each exported function to ``(restype, argtypes)``."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = open_library(library_path(name), signatures)
        return _libs[name]


def open_library(path, signatures: dict) -> ctypes.CDLL:
    """Load the built library at ``path`` and declare its functions:
    ``signatures`` and ``error_string``."""
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.error_string.restype = ctypes.c_char_p
    lib.error_string.argtypes = [ctypes.c_int]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
