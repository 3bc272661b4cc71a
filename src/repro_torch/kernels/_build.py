"""Build a CUDA source of ``repro_torch/csrc`` with nvcc; bind it with ctypes.

Each kernel module owns one :class:`CudaLibrary`.  The library is built
on first use into ``build/repro_torch/`` at the repository root, named
``<name>_<hash>.so``, where the hash covers the ``.cu`` source, every
shared header ``csrc/*.cuh`` and the library's nvcc flags, so an edited
source, header or flag builds anew and an unchanged one is reused.  Nothing is built at import: the CPU tests
import every kernel module on a machine with no ``nvcc`` and no card.
The C entry points return ``cudaGetLastError()`` after their launch, and
:func:`check_launch` turns anything but 0 into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source at first use and need the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into a shared library and loaded once.

    ``source`` names another ``csrc/<source>.cu`` to build under ``name``
    (with its own ``extra_flags``, a second library of one source).
    ``bind`` sets ``argtypes``/``restype`` of the library's entry points
    (``ctypes.c_void_p`` for every pointer and the stream, or ctypes cuts
    them to 32 bits).  ``extra_flags`` go to nvcc after
    :data:`NVCC_FLAGS`.  ``build_seconds`` and ``build_log`` (nvcc's
    ``-Xptxas -v`` register report) describe the last build; both stay
    empty when a built library was reused.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Tuple[str, ...] = (),
                 source: Optional[str] = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_seconds = 0.0
        self.build_log = ""

    def library_path(self) -> Path:
        """Where the built library for the current sources and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update("\0".join(self.flags).encode())
        return BUILD_DIR / f"{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Build the library if this source has not been built yet."""
        out = self.library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build into a temporary name and rename, so a concurrent or cut
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc(), *self.flags, "-o", tmp,
                                   str(self.source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source} (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
