"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points that launch on a
given stream and return ``cudaGetLastError()``. At first use the source
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``csrc/_build/`` (listed in ``.gitignore``), named by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing is built or
loaded when this module is imported, so machines without ``nvcc`` can
import the package and run the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources_digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless already built; return the .so path.

    The compiler's resource report (``--ptxas-options=-v``) is kept
    beside the library as ``<lib>.ptxas.txt``.
    """
    lib = os.path.join(BUILD_DIR, f"{name}-{_sources_digest(name)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    # atomic: a concurrent builder never sees a partial file
    os.replace(tmp, lib)
    with open(lib + ".ptxas.txt", "w") as f:
        f.write(proc.stderr)
    return lib


def build_all(names) -> Dict[str, str]:
    """Build several sources at once, one ``nvcc`` process each, all
    started together; {name: .so path}. Raises if any build fails."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        lib = ctypes.CDLL(build(name))
        lib.cl3d_error_string.argtypes = [ctypes.c_int]
        lib.cl3d_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def entry(name: str, fn_name: str, argtypes: list, restype=ctypes.c_int):
    """(library, C entry point with argtypes set) from ``csrc/<name>.cu``.

    Pointers and the stream are ``c_void_p``: left undeclared, ctypes
    would pass them as 32-bit ints and cut them.
    """
    lib = load(name)
    fn = getattr(lib, fn_name)  # ctypes caches this object per library
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return lib, fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cl3d_error_string(err).decode()
        raise RuntimeError(
            f"{what} failed to launch: {msg} (cuda error {err})")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Argument check for kernel wrappers (survives ``python -O``)."""
    if not cond:
        raise ValueError(msg)


def require_cuda(what: str, **tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    devices = {t.device for t in tensors.values()}
    for name, t in tensors.items():
        require(t.device.type == "cuda",
                f"{what}: {name} must be a CUDA tensor, got {t.device}")
        require(t.is_contiguous(), f"{what}: {name} must be contiguous")
    require(len(devices) == 1, f"{what}: tensors on several devices")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
