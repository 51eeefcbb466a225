"""Live asynchronous master–worker execution over pluggable transports;
counterpart of ``repro.live``.

The real counterpart of the Monte Carlo simulator: workers execute their
assigned task rows sequentially, streaming one message per completed
message group; an async master closes each round at ``k`` distinct results
(or at the deadline under ``wait`` / ``close_partial`` / ``reissue``),
feeds censored arrival feedback to the adaptive scheduler, and records the
run as a ``DelayTrace`` that replays bit-exactly through the engine.  The
master scores rounds and schedules on the card unless given
``device="cpu"``; the transports (``comm``, ``inproc``, ``tcp``,
``protocol``) carry no framework and speak the JAX package's wire format.

Entry points: ``run_live`` (one-call in-process cluster),
``Master`` + ``run_worker`` (distributed over ``tcp://``), and the
``repro_torch.launch.live`` CLI.
"""
from .comm import Comm, CommClosedError, Listener, connect, listen
from .master import LiveResult, Master, RoundReport, run_live
from .worker import run_worker, sample_delay_tables

__all__ = [
    "Comm", "CommClosedError", "Listener", "connect", "listen",
    "Master", "LiveResult", "RoundReport", "run_live",
    "run_worker", "sample_delay_tables",
]
