"""Build the port's hand-written CUDA kernels at first use and bind them.

Each ``csrc/<name>.cu`` exposes a plain C interface; it is compiled with
``nvcc`` for ``sm_90a`` into a shared library under the repository's
``build/kernels/`` directory (listed in ``.gitignore``), keyed by a hash of
the source and the flags, and loaded with ``ctypes``. No PyTorch header is
included, so a build takes seconds rather than minutes.

Nothing here runs at import time: the first kernel launch builds. A kernel
that does not build, load or launch raises ``KernelError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelError(Exception):
    """A hand-written kernel failed to build, load or launch. Deliberately
    not a ``RuntimeError``: the pooled-program containment
    (``pools._dispatch_pooled_recovering``) catches ``RuntimeError`` to
    survive running out of device memory, and must not serve a broken
    kernel's ticks through a program that does not run it."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; the
    compiler's resource report (registers, shared memory, spills) is kept
    beside it as ``<lib>.ptxas.txt``."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = _libs[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path.name}: {e}") from e
        return lib
