"""Inputs that hold the mx kernels (K1-mx, K2-mx) against their plain
versions on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``."""

from __future__ import annotations

import math

import torch


def mx_all_codes(device=None) -> torch.Tensor:
    """[256, 256*33] payload: row b holds every element code under scale byte b."""
    p = torch.zeros(256, 256, 33, dtype=torch.uint8, device=device)
    p[:, :, 0] = torch.arange(256, dtype=torch.uint8, device=device)[:, None]
    p[:, :, 1:] = torch.arange(256, dtype=torch.uint8, device=device)[None, :, None]
    return p.reshape(256, -1)


def mx_sweep(gen: torch.Generator, n: int) -> torch.Tensor:
    """[2n + 14, 32] f32 blocks on ``gen``'s device for K2-mx: ``n`` blocks of
    elements at random binades, ``n`` narrow blocks at random binades, then
    all-zero, NaN and Inf blocks, subnormal elements (alone and beside a
    tiny absmax), scaled values just below 2^-126, absmax near 2^-126 and
    near 2^127, and values above every element cap."""
    dev = gen.device
    wide = torch.rand((n, 32), generator=gen, device=dev, dtype=torch.float64) + 1.0
    wide = wide * torch.exp2(torch.randint(-140, 128, (n, 32), generator=gen, device=dev).double())
    wide = wide * (torch.randint(0, 2, (n, 32), generator=gen, device=dev) * 2 - 1)
    narrow = torch.randn((n, 32), generator=gen, device=dev, dtype=torch.float64) * torch.exp2(
        torch.randint(-130, 126, (n, 1), generator=gen, device=dev).double())
    x = torch.cat([wide, narrow]).to(torch.float32)
    z = torch.zeros((14, 32), device=dev)
    z[1, 3], z[2, 5], z[3], z[3, 0] = math.nan, math.inf, 1e-39, -1e-39
    z[4, :3] = torch.tensor([2.0 ** -120, 1e-39, -1e-39])
    z[5, :4] = torch.tensor([2.0 ** 100, 1.4901160e-08, 1.5 * 2.0 ** -27, -(2.0 ** -27)])
    z[6], z[6, 1] = 3.3e38, -math.inf
    z[7] = torch.randn(32, generator=gen, device=dev) * 1e-37
    z[8], z[8, 1] = 2.0 ** -126, 1.9 * 2.0 ** -126
    z[9] = (torch.rand(32, generator=gen, device=dev) * 2 - 1) * 3.4e38
    z[10], z[11] = 1.99, 1.9e-38
    z[12] = torch.randn(32, generator=gen, device=dev) * 1e6
    z[13, ::2] = -0.0
    return torch.cat([x, z])
