"""Pluggable transport abstraction for the live execution layer (a copy
of ``repro.live.comm``: the transports are free of any framework).

A ``Comm`` is one bidirectional, ordered, reliable message channel between
a master and a worker; a ``Listener`` accepts incoming ``Comm``s at an
address.  Two transports ship:

* ``inproc://<name>`` — in-process queue pairs (deterministic, used by the
  tests and the default ``run_live`` orchestration);
* ``tcp://<host>:<port>`` — length-prefixed JSON over asyncio TCP streams
  (multi-process clusters; ``port`` 0 binds an ephemeral port, read the
  bound address back from ``Listener.address``).

Messages are JSON-serializable dicts.  Both transports round-trip every
message through JSON (inproc included), so a config developed against
``inproc://`` behaves identically over ``tcp://`` — in particular float
values survive exactly (a float32 delay → shortest-repr JSON → float64 →
back to float32 is the identity).
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["Comm", "Listener", "CommClosedError", "parse_address",
           "connect", "listen"]


class CommClosedError(ConnectionError):
    """The peer closed (or dropped) the channel."""


class Comm:
    """One ordered, reliable message channel.  Subclasses implement
    ``send`` / ``recv`` / ``aclose``; messages are JSON-safe dicts."""

    local_address: str = ""
    peer_address: str = ""

    async def send(self, msg: dict) -> None:
        raise NotImplementedError

    async def recv(self) -> dict:
        """Next message from the peer; raises ``CommClosedError`` once the
        channel is closed and drained."""
        raise NotImplementedError

    async def aclose(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


class Listener:
    """Accepts incoming ``Comm`` connections at ``address``."""

    address: str = ""

    async def accept(self) -> Comm:
        raise NotImplementedError

    async def aclose(self) -> None:
        raise NotImplementedError


def parse_address(address: str) -> Tuple[str, str]:
    """Split ``"scheme://rest"`` and validate the scheme."""
    if "://" not in address:
        raise ValueError(f"address needs a scheme://, got {address!r} "
                         f"(use inproc://<name> or tcp://<host>:<port>)")
    scheme, rest = address.split("://", 1)
    if scheme not in ("inproc", "tcp"):
        raise ValueError(f"unknown transport scheme {scheme!r}; choose "
                         f"from ('inproc', 'tcp')")
    return scheme, rest


async def connect(address: str) -> Comm:
    """Open a ``Comm`` to the listener at ``address``."""
    scheme, rest = parse_address(address)
    if scheme == "inproc":
        from .inproc import connect_inproc
        return await connect_inproc(rest)
    from .tcp import connect_tcp
    return await connect_tcp(rest)


async def listen(address: str) -> Listener:
    """Start a ``Listener`` at ``address``."""
    scheme, rest = parse_address(address)
    if scheme == "inproc":
        from .inproc import listen_inproc
        return await listen_inproc(rest)
    from .tcp import listen_tcp
    return await listen_tcp(rest)
