"""Steps of the port's LM stack (counterpart of ``repro.train``); serving
only so far."""
from .steps import make_serve_step

__all__ = ["make_serve_step"]
