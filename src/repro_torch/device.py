"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the host with
``device="cpu"``.  Without a CUDA device and without an explicit device they
raise: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device exists); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
