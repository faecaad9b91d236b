"""DRY repetition penalty for the decode step (reference
align_att_base.py:492-537): kernel K4.

``dry_penalty`` launches the kernel ``csrc/dry_penalty.cu`` (CUDA C++ for
sm_90a, bound through ctypes) for CUDA tensors and raises on anything it
does not take; for CPU tensors it takes ``dry_penalty_plain``, the eager
twin of the JAX package's ``dry_penalty``, which XLA fuses on the TPU and
which no Pallas kernel stands for. Both return a new tensor, bit for bit
the same. ``dry_penalty.launches`` counts kernel launches, and each launch
also counts ``dry.kernel`` on the tracer.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.trace import TRACER
from .cuda_build import KernelError, load

#: the longest token row the kernel takes (one thread per candidate
#: position: THREADS in csrc/dry_penalty.cu)
MAX_LEN = 1024

_INT_DTYPES = (torch.int32, torch.int64)


def dry_penalty_plain(logits: torch.Tensor, tokens: torch.Tensor, cur_len: torch.Tensor, eot: int):
    """Vectorized DRY v0 (reference align_att_base.py:492-537).

    logits [B,V], tokens [B,L], cur_len [B]. Penalizes tokens that would
    extend a verbatim repetition of the current suffix.
    """
    B, L = tokens.shape
    V = logits.shape[-1]
    tokens = tokens.long()
    end = cur_len.long()[:, None] - 1                     # [B,1] suffix end
    idx = torch.arange(L, device=tokens.device)[None, :]  # [1,L]
    last = tokens.gather(1, end % L)  # [B,1]; an empty lane wraps, as in JAX

    # candidate positions i: tokens[i] == last, i < cur_len-1, next is text
    next_tok = torch.roll(tokens, -1, dims=1)
    cand = (tokens == last) & (idx < end) & (next_tok < eot)

    # match length: consecutive equality of the suffixes ending at i and at
    # cur_len-1, over up to 49 steps back
    length = torch.ones((B, L), dtype=torch.long, device=tokens.device)
    alive = cand
    for l in range(1, 50):
        j = idx - l        # position behind the candidate
        k = end - l        # position behind the suffix end
        ok = (j >= 0) & (k > idx)
        tj = tokens.gather(1, j.clamp(min=0).expand(B, L))
        tk = tokens.gather(1, k.clamp(min=0))
        alive = alive & ok & (tj == tk) & (tj < eot)
        length = length + alive.long()

    pen_len = torch.where(cand, length, 0)
    # scatter-max per next-token id
    pen_per_tok = torch.zeros((B, V), dtype=torch.long, device=tokens.device).scatter_reduce_(
        1, torch.where(cand, next_tok, 0), pen_len, "amax", include_self=True
    )
    penalty = torch.where(
        pen_per_tok >= 2, torch.pow(2.0, pen_per_tok.float() - 2.0), 0.0
    )
    apply = (end + 1 >= 5) & (last < eot)  # [B,1]
    return logits - torch.where(apply, penalty, 0.0)


def check_args(logits: torch.Tensor, tokens: torch.Tensor, cur_len: torch.Tensor, kernel: bool) -> None:
    """Raise on shapes that do not belong together; with ``kernel``, also on
    what the kernel does not take (dtypes, devices, a row past MAX_LEN)."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be [B,V], got {tuple(logits.shape)}")
    B = logits.shape[0]
    if tokens.dim() != 2 or tokens.shape[0] != B or tokens.shape[1] < 1:
        raise ValueError(f"tokens must be [B={B},L], got {tuple(tokens.shape)}")
    if tuple(cur_len.shape) != (B,):
        raise ValueError(f"cur_len must be [B]={B}, got {tuple(cur_len.shape)}")
    if not kernel:
        return
    if tokens.shape[1] > MAX_LEN:
        raise ValueError(f"token rows of {tokens.shape[1]} exceed the kernel's {MAX_LEN}")
    if logits.shape[1] > 0x7FFFFFFF:
        raise ValueError(f"a vocabulary of {logits.shape[1]} does not fit the kernel's int32 ids")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    for name, t in (("tokens", tokens), ("cur_len", cur_len)):
        if t.dtype not in _INT_DTYPES:
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, the logits on {logits.device}")


def _lib():
    lib = load("dry_penalty")
    if not getattr(lib, "_wlk_bound", False):
        lib.wlk_dry_penalty.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.wlk_dry_penalty.restype = ctypes.c_int
        lib.wlk_dry_penalty_error_string.argtypes = [ctypes.c_int]
        lib.wlk_dry_penalty_error_string.restype = ctypes.c_char_p
        lib._wlk_bound = True
    return lib


def dry_penalty(logits: torch.Tensor, tokens: torch.Tensor, cur_len: torch.Tensor, eot: int):
    """logits [B,V] minus the DRY penalty of each lane's token row
    ``tokens`` [B,L] at length ``cur_len`` [B]; a new tensor.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version."""
    kernel = logits.is_cuda
    check_args(logits, tokens, cur_len, kernel)
    if not kernel:
        return dry_penalty_plain(logits, tokens, cur_len, eot)
    B, V = logits.shape
    logits, tokens, cur_len = logits.contiguous(), tokens.contiguous(), cur_len.contiguous()
    out = torch.empty_like(logits)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.wlk_dry_penalty(
        logits.data_ptr(), out.data_ptr(), tokens.data_ptr(), cur_len.data_ptr(),
        B, tokens.shape[1], V, int(eot),
        int(tokens.dtype == torch.int64), int(cur_len.dtype == torch.int64),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if rc != 0:
        why = "unsupported arguments" if rc < 0 else lib.wlk_dry_penalty_error_string(rc).decode()
        raise KernelError(f"dry_penalty launch failed ({rc}): {why}")
    dry_penalty.launches += 1
    TRACER.count("dry.kernel")
    return out


dry_penalty.launches = 0
