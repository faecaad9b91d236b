"""Median filter over the trailing axis (port of whisperlivekit_tpu/ops/median.py).

Used by the AlignAtt emission gate. Same formulation as the JAX module:
reflect padding, then a sort over the width-wide shifted windows.
"""

from __future__ import annotations

import torch


def median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    """Median filter along axis -1 with reflect padding, matching the
    reference's torch implementation semantics (whisper/timing.py:19-46)."""
    if width <= 1:
        return x
    if width % 2 != 1:
        raise ValueError("width must be odd")
    if x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    xp = torch.cat(
        [x[..., 1 : pad + 1].flip(-1), x, x[..., -pad - 1 : -1].flip(-1)], dim=-1
    )
    windows = xp.unfold(-1, width, 1)  # [..., T, width]
    return torch.sort(windows, dim=-1).values[..., width // 2]
