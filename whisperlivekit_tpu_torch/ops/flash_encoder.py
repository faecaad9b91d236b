"""Flash self-attention for the Whisper encoder (non-causal, full-row).

Counterpart of ``whisperlivekit_tpu/ops/flash_encoder.py``. Two hand-written
bodies for sm_90a, bound through ctypes; see each source's header for what
bounds it on the H100 and how it is tiled:

- bf16, the serving dtype: ``csrc/flash_encoder_wgmma.cu``, tensor cores
  (``wgmma``) fed by TMA where the strides are 16-byte multiples
  (``"wgmma_tma"``), else by 8-byte ``cp.async`` (``"wgmma_cpasync"``: the
  dense ``[B,H,Dh,1500]`` cross-KV), with T split across blocks when the
  query rows alone leave the SMs idle;
- f32: ``csrc/flash_encoder.cu``, f32 FMAs on the CUDA cores
  (``"cuda_cores_f32"``), exact enough for the 2e-5 bar the reference
  phases hold the card to.

``k1_plan`` picks the body, the split and the tile layouts from dtype,
shapes, strides and pointers alone (no device needed), and raises on what
neither body takes; nothing falls back.

Layouts are the JAX function's: q ``[B,H,S,Dh]``, k ``[B,H,Dh,T]``, v
``[B,H,T,Dh]`` (or ``[B,H,Dh,T]`` with ``v_transposed``). The kernels take
explicit element strides, so strided views of the projections go in without
a transposing copy. Unlike the TPU kernel, S and T need no padding: ragged
edges are masked in-kernel.

``flash_encoder_attn`` launches a kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
``flash_encoder_attn_plain``, the plain PyTorch version of the same math.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import NamedTuple, Sequence

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
    if not 1 <= t_valid <= T:
        raise ValueError(f"t_valid={t_valid} outside [1, {T}]")


# the bf16 body's tiles (csrc/flash_encoder_wgmma.cu: BM, BN) and the card
ROWS_PER_WARPGROUP = 64
KEYS_PER_TILE = 128
N_SMS = 132  # H100 SXM


class K1Plan(NamedTuple):
    body: str          # "wgmma_tma" | "wgmma_cpasync" | "cuda_cores_f32"
    k_t_unit: bool     # k's T axis has unit stride (else its Dh axis)
    v_t_unit: bool
    n_consumers: int   # 64-row consumer warpgroups per block (bf16)
    n_split: int       # blocks sharing one query tile's keys (1: no split)


def k1_splits(B: int, H: int, S: int, t_valid: int, n_consumers: int) -> int:
    """Key splits for the bf16 body: 1 when the query tiles alone make two
    waves of blocks over the SMs; otherwise enough splits for about four
    waves, each split at least two key tiles and none empty."""
    blocks = B * H * math.ceil(S / (ROWS_PER_WARPGROUP * n_consumers))
    n_tiles = math.ceil(t_valid / KEYS_PER_TILE)
    if blocks >= 2 * N_SMS or n_tiles < 4:
        return 1
    want = min(math.ceil(4 * N_SMS / blocks), n_tiles // 2)
    per_split = math.ceil(n_tiles / want)
    return math.ceil(n_tiles / per_split)


def _pinned_strides(shape: Sequence[int], strides: Sequence[int]) -> tuple:
    """Strides with each size-1 axis' (which no index moves along) replaced
    by the tensor's packed span, so it never fails an alignment test."""
    span = 1 + sum(st * (n - 1) for n, st in zip(shape, strides))
    span = -(-span // 8) * 8
    return tuple(span if n == 1 else st for n, st in zip(shape, strides))


def k1_plan(
    dtype: torch.dtype, q_shape: Sequence[int], T: int, t_valid: int,
    q_strides: Sequence[int], k_strides: Sequence[int], v_strides: Sequence[int],
    ptrs: Sequence[int] = (0, 0, 0),
) -> K1Plan:
    """Which body runs a call, from dtype, shapes, element strides (q as
    [B,H,S,Dh]; k and v read as logical [B,H,T,Dh]) and data pointers.
    Raises ValueError on what no body takes."""
    B, H, S, Dh = q_shape
    if Dh not in (64, 128):
        raise ValueError(f"head dim {Dh} not supported (64 or 128)")
    qs = _pinned_strides(q_shape, q_strides)
    ks = _pinned_strides((B, H, T, Dh), k_strides)
    vs = _pinned_strides((B, H, T, Dh), v_strides)
    if qs[3] != 1:
        raise ValueError("q must have a unit stride on its Dh axis")
    for name, st in (("k", ks), ("v", vs)):
        if st[3] != 1 and st[2] != 1:
            raise ValueError(f"{name} needs a unit stride on its Dh or T axis")
    k_t, v_t = ks[3] != 1, vs[3] != 1
    if dtype == torch.float32:
        return K1Plan("cuda_cores_f32", k_t, v_t, 1, 1)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_encoder_attn takes float32 or bfloat16, not {dtype}")
    # the byte steps every load of the bf16 body takes: q by rows, lanes and
    # heads; k and v by lanes, heads and their other tile axis
    qp, kp, vp = ptrs
    q_steps = [2 * qs[0], 2 * qs[1], 2 * qs[2], qp]
    kv_steps = [2 * ks[0], 2 * ks[1], 2 * (ks[3] if k_t else ks[2]), kp,
                2 * vs[0], 2 * vs[1], 2 * (vs[3] if v_t else vs[2]), vp]
    if any(x % 8 for x in q_steps + kv_steps):
        raise ValueError("the bf16 body needs q, k and v strides and pointers in 8-byte multiples")
    body = "wgmma_tma" if not any(x % 16 for x in kv_steps) else "wgmma_cpasync"
    n_consumers = 1 if S <= ROWS_PER_WARPGROUP else 2
    return K1Plan(body, k_t, v_t, n_consumers, k1_splits(B, H, S, t_valid, n_consumers))


def _lib(name: str):
    lib = load(name)
    if not getattr(lib, "_wlk_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "flash_encoder":
            lib.wlk_flash_encoder_attn.argtypes = [
                p, p, p, p, i, i, i, i, i, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p,
            ]
            lib.wlk_flash_encoder_attn.restype = i
        else:
            lib.wlk_flash_wgmma.argtypes = [
                p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_float,
                ctypes.POINTER(ctypes.c_longlong), p,
            ]
            lib.wlk_flash_wgmma.restype = i
            lib.wlk_flash_wgmma_smem_bytes.argtypes = [i]
            lib.wlk_flash_wgmma_smem_bytes.restype = i
        lib.wlk_cuda_error_string.argtypes = [i]
        lib.wlk_cuda_error_string.restype = ctypes.c_char_p
        lib._wlk_bound = True
    return lib


_ERRORS = {-1: "unsupported arguments", -2: "the CUDA driver refused a tensor map",
           -3: "the CUDA driver has no cuTensorMapEncodeTiled"}


@functools.lru_cache(maxsize=1024)
def _launch_args(dtype, q_shape, T, t_valid, q_strides, k_strides, v_strides, align):
    """``k1_plan`` and the stride array its kernel takes, for one call
    signature (pointers by their residue mod 16). Cached: the main path
    repeats a few signatures every tick."""
    plan = k1_plan(dtype, q_shape, T, t_valid, q_strides, k_strides, v_strides, align)
    B, H, S, Dh = q_shape
    if plan.body == "cuda_cores_f32":
        out = (H * S * Dh, S * Dh, Dh, 1)  # contiguous [B,H,S,Dh]
        return plan, (ctypes.c_longlong * 16)(*q_strides, *k_strides, *v_strides, *out)
    qs = _pinned_strides(q_shape, q_strides)
    ks = _pinned_strides((B, H, T, Dh), k_strides)
    vs = _pinned_strides((B, H, T, Dh), v_strides)
    return plan, (ctypes.c_longlong * 9)(
        qs[0], qs[1], qs[2],
        ks[0], ks[1], ks[3] if plan.k_t_unit else ks[2],
        vs[0], vs[1], vs[3] if plan.v_t_unit else vs[2])


def flash_encoder_attn(
    q: torch.Tensor,  # [B, H, S, Dh]
    k: torch.Tensor,  # [B, H, Dh, T]
    v: torch.Tensor,  # [B, H, T, Dh] (or [B, H, Dh, T] with v_transposed)
    t_valid: int,
    v_transposed: bool = False,
) -> torch.Tensor:
    """Full (non-causal) attention; returns [B, H, S, Dh] in q.dtype.

    CUDA tensors launch a hand-written kernel (or raise); CPU tensors take
    the plain version. ``flash_encoder_attn.launches`` counts kernel
    launches, ``.shapes`` counts them per (S, T), ``.bodies`` per body
    (``k1_plan``) and ``.splits`` per key-split count of the bf16 body."""
    if not q.is_cuda:
        return flash_encoder_attn_plain(q, k, v, t_valid, v_transposed)
    _check_cuda_args(q, k, v, t_valid, v_transposed)
    B, H, S, Dh = q.shape
    T = k.shape[-1]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    plan, strides = _launch_args(
        q.dtype, tuple(q.shape), T, int(t_valid), q.stride(), _strides_bhtd(k, transposed=True),
        _strides_bhtd(v, transposed=v_transposed), tuple(x % 16 for x in ptrs))
    out = torch.empty((B, H, S, Dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.body == "cuda_cores_f32":
        lib = _lib("flash_encoder")
        rc = lib.wlk_flash_encoder_attn(*ptrs, out.data_ptr(), B, H, S, Dh, int(t_valid),
                                        float(Dh ** -0.5), strides, stream)
    else:
        lib = _lib("flash_encoder_wgmma")
        part = lse = None
        if plan.n_split > 1:  # per-split outputs [n,B,H,S,Dh] and log-sum-exps [n,B,H,S], merged by a second kernel
            rows = plan.n_split * B * H * S
            scratch = torch.empty(rows * (Dh + 1), dtype=torch.float32, device=q.device)
            part, lse = scratch.data_ptr(), scratch.data_ptr() + 4 * rows * Dh
        rc = lib.wlk_flash_wgmma(
            *ptrs, out.data_ptr(), part, lse, B, H, S, Dh, int(t_valid), int(plan.k_t_unit),
            int(plan.v_t_unit), int(plan.body == "wgmma_tma"), plan.n_split, plan.n_consumers,
            float(Dh ** -0.5), strides, stream,
        )
    if rc != 0:
        why = _ERRORS.get(rc) or lib.wlk_cuda_error_string(rc).decode()
        raise KernelError(f"flash_encoder_attn ({plan.body}) launch failed ({rc}): {why}")
    flash_encoder_attn.launches += 1
    flash_encoder_attn.shapes[(S, T)] += 1
    flash_encoder_attn.bodies[plan.body] += 1
    if plan.body != "cuda_cores_f32":
        flash_encoder_attn.splits[plan.n_split] += 1
    return out


flash_encoder_attn.launches = 0
flash_encoder_attn.shapes = Counter()
flash_encoder_attn.bodies = Counter()
flash_encoder_attn.splits = Counter()
