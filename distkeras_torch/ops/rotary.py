"""Rotary position embeddings (RoPE, Su et al. 2021).

Counterpart of ``distkeras_tpu/ops/rotary.py``: NeoX split-half
convention, frequencies ``base^(-2i/D)``, rotation in float32 and cast back
to the input dtype.
"""

from __future__ import annotations

import torch


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                base: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` [B, L, H, D] by absolute ``positions`` [L]."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    half = d // 2
    freq = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * freq[None, :]
    cos = torch.cos(ang)[None, :, None, :]                          # [1, L, 1, half]
    sin = torch.sin(ang)[None, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
