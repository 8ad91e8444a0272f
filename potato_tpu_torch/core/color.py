"""Color utilities: linear -> u8 / sRGB-u8 conversion.

Colors are (..., 3) linear-light tensors; quantizers return (..., 4) uint8
RGBA with alpha 255.
"""

from __future__ import annotations

import torch


def rgb(r, g, b, dtype=torch.float32, device="cpu"):
    return torch.tensor([r, g, b], dtype=dtype, device=device)


def _alpha_like(color):
    return torch.full(color.shape[:-1] + (1,), 255, dtype=torch.uint8,
                      device=color.device)


def to_u8(color: torch.Tensor) -> torch.Tensor:
    """Clamp + quantize, no gamma."""
    c = torch.clamp(color, 0.0, 1.0)
    q = (255.0 * c).to(torch.uint8)
    return torch.cat([q, _alpha_like(color)], dim=-1)


def to_srgb_u8(color: torch.Tensor) -> torch.Tensor:
    """Gamma 1/2.2 + quantize."""
    c = torch.clamp(color, 0.0, 1.0)
    q = (255.0 * c ** (1.0 / 2.2)).to(torch.uint8)
    return torch.cat([q, _alpha_like(color)], dim=-1)
