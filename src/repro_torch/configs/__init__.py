"""Config registry: ``--arch <id>`` resolves here (PyTorch port of
``repro.configs``: the same ten architectures, copied as pure data, so
``--arch`` resolves as in the JAX package).
"""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, pad_vocab

from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK_400B
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.llama3_405b import CONFIG as LLAMA3_405B
from repro_torch.configs.hymba_1p5b import CONFIG as HYMBA_1P5B
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.qwen2_vl_2b import CONFIG as QWEN2_VL_2B

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        MINITRON_8B, GROK_1_314B, LLAMA4_MAVERICK_400B, DEEPSEEK_7B, YI_6B,
        LLAMA3_405B, HYMBA_1P5B, MUSICGEN_LARGE, MAMBA2_130M, QWEN2_VL_2B,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(
            f"unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = ["ARCHITECTURES", "INPUT_SHAPES", "ModelConfig", "InputShape",
           "get_arch", "get_shape", "pad_vocab"]
