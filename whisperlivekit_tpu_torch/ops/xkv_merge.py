"""Cross-KV pool splice for the large form's steady tick.

Counterpart of ``whisperlivekit_tpu/ops/xkv_merge.py``. An incremental tick
refreshes pool columns ``[dst0, dst0 + W_SPLICE)`` of each active lane, where
``dst0 = align128(win - 128)`` clipped into the pool: a 128-aligned,
256-wide window that always holds the lane's unsynced frames (the session
plan re-anchors on longer catch-up bursts). The pool's T axis is padded to a
multiple of 128; the padding columns are masked out of attention through
``decode(..., t_valid)``.

``xkv_splice`` launches the kernel ``csrc/xkv_splice.cu`` (CUDA C++ for
sm_90a, bound through ctypes) for CUDA tensors and raises on anything it does
not take; for CPU tensors it takes ``xkv_splice_plain``, the plain PyTorch
twin of the JAX ``xkv_splice_ref``. Either way the pools are updated in place
(the JAX kernel aliases its donated inputs to its outputs). Pools are f32,
bf16 or float8_e4m3fn, tails f32 or bf16; the cast to the pool's dtype is
JAX's (``ops/f8.to_e4m3fn`` for float8, which the kernel repeats).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelError, load
from .f8 import F8, write_cast

W_SPLICE = 256   # spliced pool columns per inc tick (2 x 128, aligned)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, F8: 2}
_TAIL_DTYPES = (torch.float32, torch.bfloat16)


def splice_dst0(win: torch.Tensor, t_pool: int) -> torch.Tensor:
    """First spliced column: align128(win - 128), clipped into the pool."""
    d = torch.div(win - 128, 128, rounding_mode="floor") * 128
    return d.clamp(0, t_pool - W_SPLICE)


def xkv_splice_plain(pool_k, pool_v, tail_k, tail_v, win):
    """Twin of ``xkv_splice_ref``: returns new pools in which each lane with
    win > 0 holds the tail, cast to the pool's dtype, at columns
    [dst0, dst0 + W_SPLICE); every other column keeps its bits."""
    lanes = (win > 0).nonzero()[:, 0]
    cols = splice_dst0(win.long(), pool_k.shape[-1])[lanes, None] + torch.arange(W_SPLICE, device=win.device)
    # [L, G, H, Dh, Tp] indexed at (lane, column): the value is [n, W, L, H, Dh]
    index = (slice(None), lanes[:, None], ..., cols)

    def merge(pool, tail):
        out = pool.clone()
        write_cast(out, index, tail[:, lanes].permute(1, 4, 0, 2, 3))
        return out

    return merge(pool_k, tail_k), merge(pool_v, tail_v)


def _check_cuda_args(pool_k, pool_v, tail_k, tail_v, win):
    if pool_k.dim() != 5:
        raise ValueError(f"pools must be [L,G,H,Dh,Tp], got {tuple(pool_k.shape)}")
    L, G, H, Dh, Tp = pool_k.shape
    if tuple(pool_v.shape) != tuple(pool_k.shape):
        raise ValueError(f"pool shapes differ: {tuple(pool_k.shape)} vs {tuple(pool_v.shape)}")
    want_tail = (L, G, H, Dh, W_SPLICE)
    for name, t in (("tail_k", tail_k), ("tail_v", tail_v)):
        if tuple(t.shape) != want_tail:
            raise ValueError(f"{name} must be {want_tail}, got {tuple(t.shape)}")
    if Tp % 128 != 0 or Tp < W_SPLICE:
        raise ValueError(f"pool T dim {Tp} must be a multiple of 128 and >= {W_SPLICE}")
    if pool_k.dtype not in _DTYPE_CODE or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"pools must share one of {tuple(_DTYPE_CODE)}; got {pool_k.dtype}, {pool_v.dtype}")
    if tail_k.dtype not in _TAIL_DTYPES or tail_v.dtype != tail_k.dtype:
        raise TypeError(f"tails must share one of {_TAIL_DTYPES}; got {tail_k.dtype}, {tail_v.dtype}")
    if tuple(win.shape) != (G,):
        raise ValueError(f"win must be [G]={G}, got {tuple(win.shape)}")
    dev = pool_k.device
    for name, t in (("pool_v", pool_v), ("tail_k", tail_k), ("tail_v", tail_v), ("win", win)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the pools on {dev}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v), ("tail_k", tail_k), ("tail_v", tail_v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _lib():
    lib = load("xkv_splice")
    if not getattr(lib, "_wlk_bound", False):
        lib.wlk_xkv_splice.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.wlk_xkv_splice.restype = ctypes.c_int
        lib.wlk_xkv_splice_error_string.argtypes = [ctypes.c_int]
        lib.wlk_xkv_splice_error_string.restype = ctypes.c_char_p
        lib._wlk_bound = True
    return lib


def xkv_splice(pool_k, pool_v, tail_k, tail_v, win):
    """Copy the W_SPLICE projected columns into the pools IN PLACE.

    pool_*: [L, G, H, Dh, Tp] (Tp a multiple of 128); tail_*:
    [L, G, H, Dh, W_SPLICE], the projection of window columns
    [dst0, dst0 + W_SPLICE), cast to the pool's dtype here; win: [G]. Lanes
    with win == 0 are skipped. Returns the (updated) pools.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version. ``xkv_splice.launches`` counts kernel launches, and
    ``xkv_splice.f8_launches`` those into float8 pools."""
    if not pool_k.is_cuda:
        new_k, new_v = xkv_splice_plain(pool_k, pool_v, tail_k, tail_v, win)
        pool_k.copy_(new_k)
        pool_v.copy_(new_v)
        return pool_k, pool_v
    _check_cuda_args(pool_k, pool_v, tail_k, tail_v, win)
    L, G, H, Dh, Tp = pool_k.shape
    wn = win.to(torch.int32).contiguous()  # a device-side cast: no host sync
    lib = _lib()
    rc = lib.wlk_xkv_splice(
        pool_k.data_ptr(), pool_v.data_ptr(), tail_k.data_ptr(), tail_v.data_ptr(),
        wn.data_ptr(), L, G, H * Dh, Tp,
        _DTYPE_CODE[pool_k.dtype], _DTYPE_CODE[tail_k.dtype],
        torch.cuda.current_stream(pool_k.device).cuda_stream,
    )
    if rc != 0:
        why = "unsupported arguments" if rc < 0 else lib.wlk_xkv_splice_error_string(rc).decode()
        raise KernelError(f"xkv_splice launch failed ({rc}): {why}")
    xkv_splice.launches += 1
    if pool_k.dtype == F8:
        xkv_splice.f8_launches += 1
    return pool_k, pool_v


xkv_splice.launches = 0
xkv_splice.f8_launches = 0
