"""Native audio runtime bindings (ctypes over pcm_runtime.cpp).

Builds the shared library on first use with g++ -O3 into the repository's
``build/native/`` directory (listed in ``.gitignore``), not next to the
source; every entry point has a numpy fallback so the package works on
hosts without a toolchain. See pcm_runtime.cpp for what/why.

(The port's copy of whisperlivekit_tpu/native/__init__.py.)
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "pcm_runtime.cpp"
_SO = _HERE.parents[1] / "build" / "native" / "pcm_runtime.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _ResampleState(ctypes.Structure):
    _fields_ = [("pos", ctypes.c_double), ("last", ctypes.c_float), ("has_last", ctypes.c_int)]


def _build() -> Optional[Path]:
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)  # atomic: concurrent builders never load half a file
        return _SO
    except Exception as e:
        logger.info("native pcm_runtime build unavailable (%s); using numpy", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _SO if _SO.exists() else _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.info("native pcm_runtime load failed (%s)", e)
            return None
        lib.s16le_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.f32_to_s16le.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.s16le_to_f32_mono.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.resample_linear.argtypes = [
            ctypes.POINTER(_ResampleState), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.resample_linear.restype = ctypes.c_int64
        lib.ring_create.argtypes = [ctypes.c_int64]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_int64
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.ring_push.restype = ctypes.c_int64
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.ring_pop.restype = ctypes.c_int64
        _lib = lib
        logger.info("native pcm_runtime loaded (%s)", so.name)
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# API (native with numpy fallback)
# ---------------------------------------------------------------------------


def s16le_to_f32(data: bytes | np.ndarray) -> np.ndarray:
    arr = np.frombuffer(data, dtype="<i2") if isinstance(data, (bytes, bytearray)) else data
    lib = get_lib()
    if lib is None:
        return arr.astype(np.float32) / 32768.0
    arr = np.ascontiguousarray(arr)
    out = np.empty(arr.shape[0], np.float32)
    lib.s16le_to_f32(arr.ctypes.data, out.ctypes.data, arr.shape[0])
    return out


def f32_to_s16le(audio: np.ndarray) -> bytes:
    lib = get_lib()
    if lib is None:
        clipped = np.clip(audio, -1.0, 1.0 - 1.0 / 32768.0)
        return (clipped * 32768.0).astype("<i2").tobytes()
    audio = np.ascontiguousarray(audio, np.float32)
    out = np.empty(audio.shape[0], "<i2")
    lib.f32_to_s16le(audio.ctypes.data, out.ctypes.data, audio.shape[0])
    return out.tobytes()


class StreamingResampler:
    """Stateful streaming resampler (linear interpolation) for mic-rate →
    16 kHz conversion across chunk boundaries."""

    def __init__(self, in_rate: int, out_rate: int = 16000):
        self.ratio = out_rate / in_rate
        self._state = _ResampleState(pos=0.0, last=0.0, has_last=0)
        self._np_buf = np.zeros(0, np.float32)

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.ascontiguousarray(chunk, np.float32)
        lib = get_lib()
        if lib is None:
            return self._process_numpy(chunk)
        cap = int(len(chunk) * self.ratio) + 8
        out = np.empty(cap, np.float32)
        n = lib.resample_linear(
            ctypes.byref(self._state), chunk.ctypes.data, len(chunk),
            self.ratio, out.ctypes.data, cap,
        )
        return out[:n]

    def _process_numpy(self, chunk: np.ndarray) -> np.ndarray:
        # numpy mirror of the C state machine
        base = 1 if self._state.has_last else 0
        virtual = np.concatenate(([self._state.last], chunk)) if base else chunk
        total = len(virtual)
        step = 1.0 / self.ratio
        pos = self._state.pos
        n_out = max(0, int(np.floor((total - 1 - pos) / step - 1e-12)) + 1)
        if n_out > 0:
            positions = pos + step * np.arange(n_out)
            positions = positions[positions + 1.0 < total]
            i0 = positions.astype(np.int64)
            frac = (positions - i0).astype(np.float32)
            out = (1 - frac) * virtual[i0] + frac * virtual[i0 + 1]
            pos = positions[-1] + step if len(positions) else pos
        else:
            out = np.zeros(0, np.float32)
        self._state.last = float(chunk[-1]) if len(chunk) else self._state.last
        self._state.has_last = 1
        self._state.pos = max(0.0, pos - (total - 1))
        return out.astype(np.float32)


class RingBuffer:
    """Lock-free SPSC float ring buffer (native), numpy deque fallback."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        lib = get_lib()
        self._lib = lib
        if lib is not None:
            self._handle = lib.ring_create(capacity)
            if not self._handle:
                raise MemoryError("ring_create failed")
        else:
            self._buf = np.zeros(0, np.float32)

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        if self._lib is not None:
            return int(self._lib.ring_push(self._handle, data.ctypes.data, len(data)))
        n = min(len(data), self.capacity - len(self._buf))
        self._buf = np.concatenate([self._buf, data[:n]])
        return n

    def pop(self, n: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty(n, np.float32)
            got = int(self._lib.ring_pop(self._handle, out.ctypes.data, n))
            return out[:got]
        got = min(n, len(self._buf))
        out, self._buf = self._buf[:got], self._buf[got:]
        return out

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._handle))
        return len(self._buf)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.ring_destroy(self._handle)
            self._handle = None
