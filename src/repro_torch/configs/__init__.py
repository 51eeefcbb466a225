"""Configurations the port runs (counterparts of ``repro.configs``): the
paper's regression scenario and the reference's ten LM architectures:
jamba-v0.1-52b (Mamba, attention and MoE), the dense family, deepseek-v3
(MLA and MoE), rwkv6-1.6b, whisper-base, llama4-maverick (MoE and the
vision-stub frontend) and llava-next-34b (``get_config`` / ``ARCH_IDS``,
in the reference's order).  ``cli_config`` is a launcher's config: under
``--smoke``, the reference's hybrid cut that keeps an attention layer.
"""
import dataclasses

from ..models.config import ModelConfig
from . import (deepseek_v3_671b, gemma3_4b, jamba_v01_52b,
               llama4_maverick_400b, llava_next_34b, mistral_nemo_12b,
               phi4_mini_3p8b, qwen2_72b, rwkv6_1p6b, whisper_base)
from .paper_regression import RegressionConfig
from .paper_regression import config as regression_config

__all__ = ["ARCH_IDS", "get_config", "cli_config", "RegressionConfig",
           "regression_config"]

_MODULES = {
    "jamba-v0.1-52b": jamba_v01_52b,
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


def cli_config(arch: str, smoke: bool = False) -> ModelConfig:
    """The config the serve and train CLIs run for ``--arch`` (and
    ``--smoke``): a hybrid's smoke config keeps ssm_period 8 over its 2
    layers, all Mamba, so it takes the reference CLIs' cut, attention every
    second layer from layer 1 (repro/launch/serve.py:33-36,
    repro/launch/train.py:190-193)."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
        if cfg.arch_type == "hybrid":
            cfg = dataclasses.replace(cfg, ssm_period=2, ssm_attn_offset=1)
    return cfg
