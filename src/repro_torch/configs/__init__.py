"""Architecture registry of the port: ``get(arch)`` / ``get_smoke(arch)``
(counterpart of ``repro.configs``): every architecture ``repro``
registers, the dense decoder block (llama3-8b, llama3.2-3b, gemma2-2b,
granite-34b, musicgen-large), the MoE family (dbrx-132b, kimi-k2-1t-a32b),
the ssm family (mamba2-780m), the hybrid family (hymba-1.5b) and the vlm
family (llama-3.2-vision-90b)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

#: every architecture ``repro`` registers, in its order
ARCHS = [
    "musicgen_large", "kimi_k2_1t_a32b", "dbrx_132b", "gemma2_2b", "llama3_8b",
    "llama3_2_3b", "granite_34b", "hymba_1_5b", "llama3_2_vision_90b", "mamba2_780m",
]

ALIASES = {
    "musicgen-large": "musicgen_large",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "dbrx-132b": "dbrx_132b",
    "gemma2-2b": "gemma2_2b",
    "llama3-8b": "llama3_8b",
    "llama3.2-3b": "llama3_2_3b",
    "granite-34b": "granite_34b",
    "hymba-1.5b": "hymba_1_5b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "mamba2-780m": "mamba2_780m",
}


def _mod(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE
