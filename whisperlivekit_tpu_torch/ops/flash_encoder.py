"""Flash self-attention for the Whisper encoder (non-causal, full-row).

Counterpart of ``whisperlivekit_tpu/ops/flash_encoder.py``. The kernel is
``csrc/flash_encoder.cu`` (CUDA C++ for sm_90a, bound through ctypes); see
its header for what bounds it on the H100 and how it is tiled.

Layouts are the JAX function's: q ``[B,H,S,Dh]``, k ``[B,H,Dh,T]``, v
``[B,H,T,Dh]`` (or ``[B,H,Dh,T]`` with ``v_transposed``). The kernel takes
explicit element strides, so strided views of the projections go in without
a transposing copy. Unlike the TPU kernel, S and T need no padding: ragged
edges are masked in-kernel.

``flash_encoder_attn`` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
``flash_encoder_attn_plain``, the plain PyTorch version of the same math.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .cuda_build import KernelError, load

_SUPPORTED = (torch.float32, torch.bfloat16)


def flash_encoder_attn_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_valid: int,
    v_transposed: bool = False,
) -> torch.Tensor:
    """Same layouts and math as ``flash_encoder_attn_reference``: f32 scores
    and softmax, columns >= t_valid masked, probabilities rounded to V's
    dtype, P.V accumulated in f32, output in q's dtype."""
    Dh = q.shape[-1]
    T = k.shape[-1]
    s = torch.matmul(q.float(), k.float()) * (Dh ** -0.5)  # [B,H,S,T] f32
    col = torch.arange(T, device=q.device)
    s = s.masked_fill(col >= t_valid, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    vt = v.transpose(-1, -2) if v_transposed else v  # -> [B,H,T,Dh]
    # a bf16 matmul accumulates in f32 and rounds once, like the reference's
    # preferred_element_type=f32 dot followed by astype
    return torch.matmul(p, vt).to(q.dtype)


def _strides_bhtd(x: torch.Tensor, transposed: bool):
    """Element strides of ``x`` read as a logical [B,H,T,Dh] view."""
    sb, sh, s2, s3 = x.stride()
    return (sb, sh, s3, s2) if transposed else (sb, sh, s2, s3)


def _check_cuda_args(q, k, v, t_valid, v_transposed):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_encoder_attn takes 4-D q, k, v")
    B, H, S, Dh = q.shape
    T = k.shape[-1]
    if tuple(k.shape) != (B, H, Dh, T):
        raise ValueError(f"k must be [B,H,Dh,T]={(B, H, Dh, T)}, got {tuple(k.shape)}")
    want_v = (B, H, Dh, T) if v_transposed else (B, H, T, Dh)
    if tuple(v.shape) != want_v:
        raise ValueError(f"v must be {want_v}, got {tuple(v.shape)}")
    if q.dtype not in _SUPPORTED or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {_SUPPORTED}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on the same CUDA device")
    if Dh not in (64, 128):
        raise ValueError(f"head dim {Dh} not supported (64 or 128)")
    if not 1 <= t_valid <= T:
        raise ValueError(f"t_valid={t_valid} outside [1, {T}]")
    if q.stride(-1) != 1:
        raise ValueError("q must have a unit stride on its Dh axis")
    for name, x in (("k", k), ("v", v)):
        if x.stride(-1) != 1 and x.stride(-2) != 1:
            raise ValueError(f"{name} needs a unit stride on its Dh or T axis")


def _lib():
    lib = load("flash_encoder")
    if not getattr(lib, "_wlk_bound", False):
        lib.wlk_flash_encoder_attn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_void_p,
        ]
        lib.wlk_flash_encoder_attn.restype = ctypes.c_int
        lib.wlk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.wlk_cuda_error_string.restype = ctypes.c_char_p
        lib._wlk_bound = True
    return lib


def flash_encoder_attn(
    q: torch.Tensor,  # [B, H, S, Dh]
    k: torch.Tensor,  # [B, H, Dh, T]
    v: torch.Tensor,  # [B, H, T, Dh] (or [B, H, Dh, T] with v_transposed)
    t_valid: int,
    v_transposed: bool = False,
) -> torch.Tensor:
    """Full (non-causal) attention; returns [B, H, S, Dh] in q.dtype.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version. ``flash_encoder_attn.launches`` counts kernel
    launches and ``flash_encoder_attn.shapes`` counts them per (S, T)."""
    if not q.is_cuda:
        return flash_encoder_attn_plain(q, k, v, t_valid, v_transposed)
    _check_cuda_args(q, k, v, t_valid, v_transposed)
    B, H, S, Dh = q.shape
    T = k.shape[-1]
    out = torch.empty((B, H, S, Dh), dtype=q.dtype, device=q.device)
    strides = (
        *q.stride(),
        *_strides_bhtd(k, transposed=True),
        *_strides_bhtd(v, transposed=v_transposed),
        *out.stride(),
    )
    lib = _lib()
    rc = lib.wlk_flash_encoder_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, S, Dh, int(t_valid), int(q.dtype == torch.bfloat16),
        float(Dh ** -0.5), (ctypes.c_longlong * 16)(*strides),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        why = "unsupported arguments" if rc < 0 else lib.wlk_cuda_error_string(rc).decode()
        raise KernelError(f"flash_encoder_attn launch failed ({rc}): {why}")
    flash_encoder_attn.launches += 1
    flash_encoder_attn.shapes[(S, T)] += 1
    return out


flash_encoder_attn.launches = 0
flash_encoder_attn.shapes = Counter()
