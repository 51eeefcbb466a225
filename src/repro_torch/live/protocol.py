"""Wire protocol of the live master–worker round loop (a copy of
``repro.live.protocol``; either package's master and workers share it).

All messages are JSON-safe dicts with a ``type`` field.  Per connection
they are FIFO; the protocol never relies on cross-connection ordering.

Handshake::

    worker -> master   {"type": "hello"}
    master -> worker   {"type": "welcome", "worker": w,
                        "config": RoundConfig.to_dict(), "rounds": R,
                        "time_scale": ts, "abort_on_close": bool}

Per round ``t`` (master initiates; workers answer with a stream of
results and exactly one ``round_done``)::

    master -> worker   {"type": "round", "round": t, "row": p,
                        "tasks": [...], "load": l}
    worker -> master   {"type": "result", "round": t, "worker": w,
                        "msg": l, "slots": [j0, j1], "tasks": [...],
                        "t1": [full T1 prefix 0..j1], "t2": t2_at_j1,
                        "arrival": virtual_arrival}         (x messages)
    master -> worker   {"type": "close", "round": t}        (optional)
    worker -> master   {"type": "round_done", "round": t, "sent": m,
                        "aborted": bool, "stalled": bool}

``result.t1`` carries the worker's FULL compute-delay prefix up to the
message's closing slot, so the master can fill table cells even when an
earlier message was cancelled by a ``close`` — any cell never covered by a
received message stays +inf (fault-censoring semantics, version-2 trace).
``result.arrival`` is the worker's virtual arrival time (pacing /
close-decision grade); the master's authoritative statistics are computed
from the assembled tables with the MC engine's own fused arithmetic.

Teardown::

    master -> worker   {"type": "shutdown"}

A worker receiving ``close`` for a round it already finished ignores it;
a master receiving ``result`` after broadcasting ``close`` records it
(the message was already in flight — exactly what a real master does).
"""
from __future__ import annotations

HELLO = "hello"
WELCOME = "welcome"
ROUND = "round"
RESULT = "result"
CLOSE = "close"
ROUND_DONE = "round_done"
SHUTDOWN = "shutdown"

__all__ = ["HELLO", "WELCOME", "ROUND", "RESULT", "CLOSE", "ROUND_DONE",
           "SHUTDOWN"]
