"""Configurations the port runs (counterparts of ``repro.configs``): the
paper's regression scenario and the LM architectures whose layers the port
has: the dense family, deepseek-v3 (MLA and MoE), rwkv6-1.6b, whisper-base,
llama4-maverick (MoE and the vision-stub frontend) and llava-next-34b
(``get_config`` / ``ARCH_IDS``, in the reference's order).
"""
from ..models.config import ModelConfig
from . import (deepseek_v3_671b, gemma3_4b, llama4_maverick_400b,
               llava_next_34b, mistral_nemo_12b, phi4_mini_3p8b, qwen2_72b,
               rwkv6_1p6b, whisper_base)
from .paper_regression import RegressionConfig
from .paper_regression import config as regression_config

__all__ = ["ARCH_IDS", "get_config", "RegressionConfig", "regression_config"]

# jamba-v0.1-52b, first in the reference's registry, waits for the Mamba
# mixer of its hybrid stack (ROADMAP.md queue 1, item 8)
_MODULES = {
    "gemma3-4b": gemma3_4b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "qwen2-72b": qwen2_72b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "rwkv6-1.6b": rwkv6_1p6b,
    "whisper-base": whisper_base,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "llava-next-34b": llava_next_34b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        return _MODULES[arch].config()
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; the port runs "
                         f"{sorted(_MODULES)}") from None
