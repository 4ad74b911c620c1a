"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and bound with ``ctypes``. The build runs at first use, from the
sources in this package only, into ``build/kernels/`` of the checkout; the
library's file name carries a hash of its source and flags, so an edited
kernel is rebuilt and a stale one is never loaded. The compiler's report
(``-Xptxas -v``: registers and spills per kernel) is kept beside the
library as ``<library>.log`` and read back with it (``build_log``; a
library without its report is built again). Importing this module
builds nothing: the tests on a machine without a GPU import every module.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a non-zero
code and counts successful launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


class CudaKernel:
    """One hand-written kernel: its source file, the C entry point that
    launches it, the built library and a count of launches."""

    def __init__(self, source: str, symbol: str, argtypes: list,
                 extra_flags: tuple = ()):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.flags = (*ARCH_FLAGS, "-std=c++17", "-O3", *extra_flags)
        self.launches = 0
        self.build_seconds: float | None = None
        self.build_log = ""
        self._fn = None
        self._lib = None

    def _lib_path(self) -> str:
        with open(os.path.join(CSRC_DIR, self.source), "rb") as f:
            h = hashlib.sha256(f.read())
        h.update(" ".join(self.flags).encode())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")

    def build(self) -> float:
        """Compile (if the library is missing) and load; returns seconds."""
        if self._fn is not None:
            return self.build_seconds or 0.0
        t0 = time.perf_counter()
        path = self._lib_path()
        if not (os.path.isfile(path) and os.path.isfile(f"{path}.log")):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *self.flags, "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", tmp,
                   os.path.join(CSRC_DIR, self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                   f"{self.build_log}")
            with open(f"{tmp}.log", "w") as f:
                f.write(self.build_log)
            os.replace(f"{tmp}.log", f"{path}.log")
            os.replace(tmp, path)
        else:
            with open(f"{path}.log") as f:
                self.build_log = f.read()
        self._lib = ctypes.CDLL(path)
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = self._lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn = fn
        self.build_seconds = time.perf_counter() - t0
        return self.build_seconds

    def launch(self, *args) -> None:
        """Call the C entry point; raise on a CUDA error, else count."""
        self.build()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} "
                               f"({msg})")
        self.launches += 1


def ptxas_usage(build_log: str) -> list[dict]:
    """Per kernel function of an ``nvcc -Xptxas -v`` log: its mangled
    ``name``, ``registers`` and ``spill_stores`` / ``spill_loads`` in
    bytes."""
    out: list[dict] = []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"name": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (``-1`` in ``shape`` matches any size)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s != -1 and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def all_kernels() -> list:
    """The kernels of the main path, in pipeline order."""
    from .ops.lines_device import CCL_KERNEL
    from .ops.sphere import SPHERE_KERNEL
    return [CCL_KERNEL, SPHERE_KERNEL]
