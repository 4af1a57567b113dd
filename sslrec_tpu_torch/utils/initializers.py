"""Parameter initialisers (port of ``sslrec_tpu/utils/initializers.py``)."""

from __future__ import annotations

import math

import torch


def xavier_uniform(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """U(±√(6 / (fan_in + fan_out))) over the last two dims, drawn on ``gen``'s
    device (``nn.init.xavier_uniform_``'s bound)."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return u * (2 * limit) - limit


def normal_init(gen: torch.Generator, shape, std=0.02, dtype=torch.float32) -> torch.Tensor:
    """N(0, std²), drawn on ``gen``'s device."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype) * std


def linear_params(gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True,
                  dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``nn.Linear``'s default init in the JAX package's layout: ``w`` [in, out]
    and ``b`` [out], each U(±1/√in), drawn on ``gen``'s device."""
    limit = 1.0 / math.sqrt(in_dim)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype) * (2 * limit) - limit

    p = {"w": u(in_dim, out_dim)}
    if bias:
        p["b"] = u(out_dim)
    return p
