"""Build a CUDA source into its own shared library and bind it with ctypes.

Each hand-written kernel source (``csrc/*.cu``) has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root, named by a
hash of the source and the flags, the first time one of its kernels is
launched.  nvcc's output, with ptxas's register/spill report, is kept
beside the library as ``<library>.log``.  Nothing here runs when a module
is imported, and nothing catches a failed build: it raises with nvcc's
output.

Also the checks every wrapper shares: the device rule (CPU and meta
tensors take the plain torch version, CUDA tensors the kernel) and
argument checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Sequence

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and "
            "PATH); the CUDA kernels cannot be built")
    return found


class CudaLibrary:
    """One CUDA source, its nvcc flags, and the ctypes signatures of its
    C functions.

    ``bind(lib)`` sets ``argtypes``/``restype`` of every C function the
    wrappers call.  ``error_fn`` names the library's C function that turns
    a return code into a message.
    """

    def __init__(self, name: str, source: pathlib.Path,
                 flags: Sequence[str], bind: Callable[[ctypes.CDLL], None],
                 error_fn: str):
        self.name, self.source, self.flags = name, source, tuple(flags)
        self._bind, self._error_fn = bind, error_fn
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> pathlib.Path:
        """Compile unless a library for this source and these flags
        exists; returns its path.  Raises with nvcc's output on failure."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *self.flags, "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                err = getattr(lib, self._error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch returned anything but 0."""
        if rc != 0:
            msg = getattr(self.load(), self._error_fn)(rc).decode()
            raise RuntimeError(f"{what} launch failed: {msg}")


def on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU, or every one on the
    ``meta`` device (the dry run's abstract tensors: the plain version's
    shapes and costs, nothing computed); False when every one lies on one
    CUDA device; raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type in ("cpu", "meta"):
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
