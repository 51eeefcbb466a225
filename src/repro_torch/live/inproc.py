"""In-process transport: queue-pair ``Comm``s behind a module-level
listener registry.  Deterministic (single event loop, FIFO queues) and
dependency-free — the default transport for tests and ``run_live``.  A
copy of ``repro.live.inproc``.

Every message still round-trips through JSON (see ``comm``), so inproc and
tcp carry byte-identical payload semantics.
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional

from .comm import Comm, CommClosedError, Listener

__all__ = ["InProcComm", "InProcListener", "connect_inproc", "listen_inproc"]

_CLOSE = object()                      # queue sentinel: peer closed

# name -> live listener (one listener per inproc address at a time)
_LISTENERS: Dict[str, "InProcListener"] = {}


class InProcComm(Comm):
    def __init__(self, rx: asyncio.Queue, tx: asyncio.Queue, name: str,
                 side: str):
        self._rx = rx
        self._tx = tx
        self._closed = False
        self._peer_closed = False
        self.local_address = f"inproc://{name}#{side}"
        self.peer_address = f"inproc://{name}"

    async def send(self, msg: dict) -> None:
        if self._closed or self._peer_closed:
            raise CommClosedError(f"{self.local_address}: channel closed")
        # serialize exactly like the tcp transport so payload semantics
        # (tuples -> lists, float repr round-trip) are transport-invariant
        self._tx.put_nowait(json.dumps(msg))

    async def recv(self) -> dict:
        if self._peer_closed:
            raise CommClosedError(f"{self.local_address}: peer closed")
        item = await self._rx.get()
        if item is _CLOSE:
            self._peer_closed = True
            raise CommClosedError(f"{self.local_address}: peer closed")
        return json.loads(item)

    async def aclose(self) -> None:
        if not self._closed:
            self._closed = True
            self._tx.put_nowait(_CLOSE)

    @property
    def closed(self) -> bool:
        return self._closed or self._peer_closed


class InProcListener(Listener):
    def __init__(self, name: str):
        self._name = name
        self._pending: asyncio.Queue = asyncio.Queue()
        self.address = f"inproc://{name}"
        self._closed = False

    def _incoming(self) -> InProcComm:
        a_to_b: asyncio.Queue = asyncio.Queue()
        b_to_a: asyncio.Queue = asyncio.Queue()
        server_side = InProcComm(a_to_b, b_to_a, self._name, "server")
        client_side = InProcComm(b_to_a, a_to_b, self._name, "client")
        self._pending.put_nowait(server_side)
        return client_side

    async def accept(self) -> InProcComm:
        if self._closed:
            raise CommClosedError(f"{self.address}: listener closed")
        return await self._pending.get()

    async def aclose(self) -> None:
        self._closed = True
        if _LISTENERS.get(self._name) is self:
            del _LISTENERS[self._name]


async def listen_inproc(name: str) -> InProcListener:
    if name in _LISTENERS:
        raise ValueError(f"inproc://{name} already has a listener")
    lst = InProcListener(name)
    _LISTENERS[name] = lst
    return lst


async def connect_inproc(name: str) -> InProcComm:
    lst: Optional[InProcListener] = _LISTENERS.get(name)
    if lst is None or lst._closed:
        raise CommClosedError(f"inproc://{name}: no listener")
    return lst._incoming()
