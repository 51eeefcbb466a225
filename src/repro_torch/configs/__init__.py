"""Configurations the port runs (counterparts of ``repro.configs``): the
paper's regression scenario and the reference's ten LM architectures:
jamba-v0.1-52b (Mamba, attention and MoE), the dense family, deepseek-v3
(MLA and MoE), rwkv6-1.6b, whisper-base, llama4-maverick (MoE and the
vision-stub frontend) and llava-next-34b (``get_config`` / ``ARCH_IDS``,
in the reference's order).  ``cli_config`` is a launcher's config: under
``--smoke``, the reference's hybrid cut that keeps an attention layer.

The four input shapes (``SHAPES``), the long-context variant of
``long_500k`` (``long_variant``, ``resolve``) and ``input_specs``, the
inputs of every shape as tensors on the ``meta`` device (no allocation)
for the dry run (``launch/dryrun.py``), are the reference's
(repro/configs/__init__.py:51-148).
"""
import dataclasses
from typing import Dict

import torch

from ..models.config import ModelConfig
from . import (deepseek_v3_671b, gemma3_4b, jamba_v01_52b,
               llama4_maverick_400b, llava_next_34b, mistral_nemo_12b,
               phi4_mini_3p8b, qwen2_72b, rwkv6_1p6b, whisper_base)
from .paper_regression import RegressionConfig
from .paper_regression import config as regression_config

__all__ = ["ARCH_IDS", "get_config", "cli_config", "RegressionConfig",
           "regression_config", "InputShape", "SHAPES", "LONG_WINDOW",
           "shape_supported", "long_variant", "resolve", "input_specs"]

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


# ---------------------------- input shapes -----------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

#: the window of every attention layer of a dense model's long variant
LONG_WINDOW = 8192


def shape_supported(cfg: ModelConfig, shape: str) -> bool:
    """Only whisper-base skips long_500k (its decoder has no analogue at
    524k tokens); the dense archs run it through their sliding-window long
    variant, deepseek through the MLA latent cache, rwkv6 and the hybrid
    natively."""
    return not (shape == "long_500k" and cfg.arch_type == "audio")


def long_variant(cfg: ModelConfig) -> ModelConfig:
    """The config of ``long_500k``.  rwkv6 (O(1) state) and MLA (the
    latent cache) stay as they are, with room for 524 296 positions.  Any
    other config turns sliding-window, window ``LONG_WINDOW``, every layer
    local (``local_global_pattern`` (1, 0)), named ``<name>+swa``.  As in
    the reference, a hybrid's attention layers stay full attention:
    ``layer_specs`` gives them ``gqa`` before it reads the pattern, so
    jamba's long variant keeps a full-depth cache at its attention
    layers."""
    long_len = SHAPES["long_500k"].seq_len + 8
    if cfg.ssm_kind == "rwkv6" or cfg.kv_lora_rank:
        return dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len,
                                                        long_len))
    return dataclasses.replace(
        cfg, name=cfg.name + "+swa", sliding_window=LONG_WINDOW,
        local_global_pattern=(1, 0), max_seq_len=long_len)


def resolve(cfg: ModelConfig, shape: str) -> ModelConfig:
    """The config a (arch, shape) runs: the long variant for long_500k, a
    decode shape's max_seq_len capped at its depth, else ``cfg``."""
    if shape == "long_500k":
        return long_variant(cfg)
    if SHAPES[shape].kind == "decode":
        return dataclasses.replace(
            cfg, max_seq_len=min(cfg.max_seq_len, SHAPES[shape].seq_len))
    return cfg


def input_specs(cfg: ModelConfig, shape_name: str, *, n: int = 16,
                r: int = 1, device="meta") -> dict:
    """Every model input of the shape as an uninitialised tensor on
    ``device`` (``meta`` by default: shapes and dtypes only), int32 tokens
    and float32 modality extras, under the reference's keys.  train:
    slot-major straggler-round batches (r, n, b, S) with b = B / n (plus
    ``slot_embeds`` / ``slot_frames``); prefill: (B, S) ``tokens`` (plus
    ``embeds`` / ``enc_frames``); decode: the (B, 1) ``tokens`` of one
    step (the cache comes from ``init_cache``).  A frontend's patch tokens
    count in S."""
    sh = SHAPES[shape_name]
    S, B = sh.seq_len, sh.global_batch

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    St = S - (cfg.frontend_seq or 0)
    if sh.kind == "train":
        if B % n:
            raise ValueError(f"global batch {B} is not a multiple of n={n}")
        lead = (r, n, B // n)
        spec = {"slot_tokens": empty(lead + (St,), i32),
                "slot_labels": empty(lead + (St,), i32)}
        if cfg.frontend_seq:
            spec["slot_embeds"] = empty(lead + (cfg.frontend_seq,
                                                cfg.frontend_dim), f32)
        if cfg.encoder_layers:
            spec["slot_frames"] = empty(lead + (cfg.encoder_seq,
                                                cfg.frontend_dim), f32)
        return spec
    if sh.kind == "prefill":
        spec = {"tokens": empty((B, St), i32)}
        if cfg.frontend_seq:
            spec["embeds"] = empty((B, cfg.frontend_seq, cfg.frontend_dim),
                                   f32)
        if cfg.encoder_layers:
            spec["enc_frames"] = empty((B, cfg.encoder_seq,
                                        cfg.frontend_dim), f32)
        return spec
    return {"tokens": empty((B, 1), i32)}
