"""Configurations the port runs (counterparts of ``repro.configs``): the
paper's regression scenario and the LM architectures whose layers the port
has: the dense family, whisper-base and rwkv6-1.6b (``get_config`` /
``ARCH_IDS``)."""
from ..models.config import ModelConfig
from . import (gemma3_4b, mistral_nemo_12b, phi4_mini_3p8b, qwen2_72b,
               rwkv6_1p6b, whisper_base)
from .paper_regression import RegressionConfig
from .paper_regression import config as regression_config

__all__ = ["ARCH_IDS", "get_config", "RegressionConfig", "regression_config"]

_MODULES = {
    "gemma3-4b": gemma3_4b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "qwen2-72b": qwen2_72b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "whisper-base": whisper_base,
    "rwkv6-1.6b": rwkv6_1p6b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        return _MODULES[arch].config()
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; the port runs "
                         f"{sorted(_MODULES)}") from None
