"""The LM stack of the port (counterpart of ``repro.models``): the shared
``ModelConfig``, the layers and the ``Transformer``."""
from .config import LayerSpec, ModelConfig, find_period, layer_specs
from .model import (Segment, Transformer, active_params, block_apply, encode,
                    forward, init_cache, init_params, num_params,
                    plan_segments)

__all__ = ["LayerSpec", "ModelConfig", "find_period", "layer_specs",
           "Segment", "Transformer", "active_params", "block_apply",
           "encode", "forward",
           "init_cache", "init_params", "num_params", "plan_segments"]
