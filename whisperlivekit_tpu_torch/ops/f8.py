"""float8_e4m3fn casts and byte views, as the JAX package takes them.

JAX's ``astype(jnp.float8_e4m3fn)`` (ml_dtypes) rounds to nearest even and
turns every value whose rounding passes the largest finite 448, and +-inf,
into NaN with the input's sign (byte 0x7F or 0xFF); NaN keeps its sign too.
Torch's ``.to(torch.float8_e4m3fn)`` saturates to +-448 instead, and PTX's
only convert to e4m3 (``cvt.rn.satfinite``) saturates as well. So the port
casts through ``to_e4m3fn``, integer arithmetic on the f32 bits that gives
JAX's bytes on every device; K2's CUDA kernel (``csrc/xkv_splice.cu``) does
the same arithmetic.

Torch lacks float8 ``gather`` and some indexed copies (on the CPU at
least), so every write into a float8 tensor goes through ``write_cast``:
it casts as JAX does and stores through uint8 views (``as_bytes``), which
is a byte copy anyway. A pool's writers call it whatever its dtype.
"""

from __future__ import annotations

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0  # the largest finite e4m3fn value

_MIN_NORMAL_BITS = 0x3C800000  # f32 bits of 2**-6, the smallest e4m3fn normal
_REBIAS = (127 - 7) << 3       # f32 exponent bias to e4m3 bias, in (exp, 3-bit mantissa) units


def to_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(float8_e4m3fn)`` as JAX computes it, from f32, bf16 or f16
    (each widens exactly to f32 first). Round to nearest even; a magnitude
    that rounds past 448 (anything above 464), +-inf and NaN become NaN with
    the input's sign; subnormals keep their 2**-9 steps; -0 stays -0."""
    bits = x.float().contiguous().view(torch.int32)
    sign = (bits >> 24) & 0x80                 # the sign bit, moved to bit 7
    mag = bits & 0x7FFFFFFF
    # normals: round the 23-bit mantissa to 3 bits, to nearest even
    lsb = (mag >> 20) & 1
    normal = ((mag + 0x7FFFF + lsb) >> 20) - _REBIAS
    # subnormals (below 2**-6): a multiple of 2**-9; 8 steps is the first normal
    sub = torch.round(mag.view(torch.float32) * 512.0).to(torch.int32)
    code = torch.where(mag < _MIN_NORMAL_BITS, sub, normal)
    code = torch.where((code > 0x7E) | (mag >= 0x7F800000), 0x7F, code)
    return (code | sign).to(torch.uint8).view(F8)


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A uint8 view of a float8 tensor (any other dtype is returned as is)."""
    return x.view(torch.uint8) if x.dtype == F8 else x


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX computes it: ``to_e4m3fn`` for float8,
    ``Tensor.to`` (round to nearest even) otherwise."""
    if x.dtype == dtype:
        return x
    return to_e4m3fn(x) if dtype == F8 else x.to(dtype)


def write_cast(dst: torch.Tensor, index, src, keep: torch.Tensor = None) -> None:
    """``dst[index] = src`` cast to ``dst``'s dtype as JAX casts (``cast_to``;
    ``src`` a tensor or a number), stored through uint8 views when ``dst``
    is float8. With ``keep`` (a bool tensor broadcast against
    ``dst[index]``), only where it is true: elsewhere every bit stays."""
    if not torch.is_tensor(src):
        src = torch.tensor(src, dtype=torch.float32, device=dst.device)
    d = as_bytes(dst)
    val = as_bytes(cast_to(src, dst.dtype))
    if keep is not None:
        val = torch.where(keep, val, d[index])
    d[index] = val
