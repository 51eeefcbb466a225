"""TCP transport: length-prefixed JSON frames over asyncio streams (a
copy of ``repro.live.tcp``, byte-compatible with it: a master of either
package serves workers of the other).

Frame format: a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON.  One frame == one message; asyncio streams are
ordered and reliable, so the per-connection FIFO guarantee the live
protocol relies on holds here exactly as for ``inproc``.
"""
from __future__ import annotations

import asyncio
import json
import struct

from .comm import Comm, CommClosedError, Listener

__all__ = ["TCPComm", "TCPListener", "connect_tcp", "listen_tcp"]

_MAX_FRAME = 64 * 1024 * 1024          # sanity cap; a round message is KBs


def _split_hostport(rest: str):
    host, _, port = rest.rpartition(":")
    if not host or not port:
        raise ValueError(f"tcp address must be host:port, got tcp://{rest}")
    return host, int(port)


class TCPComm(Comm):
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._closed = False
        sock = writer.get_extra_info("sockname")
        peer = writer.get_extra_info("peername")
        self.local_address = f"tcp://{sock[0]}:{sock[1]}" if sock else "tcp://"
        self.peer_address = f"tcp://{peer[0]}:{peer[1]}" if peer else "tcp://"

    async def send(self, msg: dict) -> None:
        if self._closed:
            raise CommClosedError(f"{self.local_address}: channel closed")
        data = json.dumps(msg).encode()
        try:
            self._writer.write(struct.pack(">I", len(data)) + data)
            await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self._closed = True
            raise CommClosedError(f"{self.local_address}: {e}") from e

    async def recv(self) -> dict:
        try:
            hdr = await self._reader.readexactly(4)
            (length,) = struct.unpack(">I", hdr)
            if length > _MAX_FRAME:
                raise CommClosedError(f"{self.local_address}: oversized "
                                      f"frame ({length} bytes)")
            data = await self._reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self._closed = True
            raise CommClosedError(f"{self.local_address}: peer closed") from e
        return json.loads(data.decode())

    async def aclose(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @property
    def closed(self) -> bool:
        return self._closed


class TCPListener(Listener):
    def __init__(self, server: asyncio.AbstractServer, host: str):
        self._server = server
        self._pending: asyncio.Queue = asyncio.Queue()
        port = server.sockets[0].getsockname()[1]
        self.address = f"tcp://{host}:{port}"

    def _on_connect(self, reader, writer):
        self._pending.put_nowait(TCPComm(reader, writer))

    async def accept(self) -> TCPComm:
        return await self._pending.get()

    async def aclose(self) -> None:
        self._server.close()
        await self._server.wait_closed()


async def listen_tcp(rest: str) -> TCPListener:
    host, port = _split_hostport(rest)
    holder: list = []
    server = await asyncio.start_server(
        lambda r, w: holder[0]._on_connect(r, w), host, port)
    lst = TCPListener(server, host)
    holder.append(lst)
    return lst


async def connect_tcp(rest: str) -> TCPComm:
    host, port = _split_hostport(rest)
    reader, writer = await asyncio.open_connection(host, port)
    return TCPComm(reader, writer)
