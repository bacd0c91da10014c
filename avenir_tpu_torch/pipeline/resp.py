"""Minimal RESP (REdis Serialization Protocol) client — stdlib sockets only;
port of ``avenir_tpu/pipeline/resp.py``.

The reference's streaming stack talks to Redis through Jedis
(reinforce/RedisSpout.java:70-74, RedisActionWriter.java:46-49,
RedisRewardReader.java:72-86: ``rpop`` events, ``lpush`` actions, reward-list
reads). The package takes no ``redis`` dependency for one transport — RESP
is a ~100-line protocol, so the client is implemented directly. Covers
RESP2 reply types (simple string, error, integer, bulk string, array),
which is everything the list commands use.
"""

from __future__ import annotations

import socket
from typing import List, Optional, Union


class RespError(RuntimeError):
    """Server-reported error reply (RESP ``-ERR ...``)."""


class RespClient:
    """One blocking connection; thread-compat like Jedis (one per thread)."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 db: int = 0, timeout: float = 5.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._db = db
        self.reconnects = 0              # transport faults absorbed so far
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        if db:
            self._exchange(("SELECT", db))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _reconnect(self) -> None:
        self.close()
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        self._buf = b""
        self.reconnects += 1
        if self._db:
            self._exchange(("SELECT", self._db))

    # -- protocol ------------------------------------------------------------
    def _exchange(self, args):
        parts = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            parts.append(b"$%d\r\n%s\r\n" % (len(b), b))
        self._sock.sendall(b"".join(parts))
        return self._read_reply()

    def command(self, *args: Union[str, bytes, int, float],
                retry: bool = True):
        """Send one command as a RESP array of bulk strings; return the
        decoded reply (str | int | None | list, recursively).

        Survives ONE transient transport fault per call (server restart,
        idle-connection reap): any ``ConnectionError`` — ``BrokenPipeError``
        / ``ConnectionResetError`` on send, or the clean-close error the
        reply reader raises — triggers a reconnect and a single resend.
        Caveat the caller owns: if the fault hit AFTER the server executed
        the command (reply lost in flight), the resend makes delivery
        at-least-once — the same trade Jedis' reconnect-on-retry makes.
        Pass ``retry=False`` for writes where a duplicate is worse than a
        surfaced fault (e.g. non-idempotent LPUSH into an exactly-once
        pipeline)."""
        try:
            return self._exchange(args)
        except ConnectionError:
            if not retry:
                raise
            self._reconnect()
            return self._exchange(args)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:          # payload + trailing CRLF
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RespError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n).decode()
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply() for _ in range(n)]
        raise RespError(f"unknown RESP reply type {line!r}")

    # -- the command surface the streaming stack uses ------------------------
    def ping(self) -> bool:
        return self.command("PING") == "PONG"

    def lpush(self, key: str, value: str) -> int:
        return self.command("LPUSH", key, value)

    def rpop(self, key: str) -> Optional[str]:
        return self.command("RPOP", key)

    def rpop_count(self, key: str, count: int) -> Optional[List[str]]:
        """Batched ``RPOP key count`` (redis ≥ 6.2); RespError if unsupported."""
        return self.command("RPOP", key, count)

    def llen(self, key: str) -> int:
        return self.command("LLEN", key)

    def lindex(self, key: str, index: int) -> Optional[str]:
        return self.command("LINDEX", key, index)

    def delete(self, key: str) -> int:
        return self.command("DEL", key)


class RedisListQueue:
    """The push/pop queue surface (same as InProcQueue) over one Redis list:
    ``push`` = LPUSH, ``pop`` = RPOP — the exact verbs of the reference's
    spout/writer pair, so simulators written against either side match."""

    def __init__(self, name: str, client: Optional[RespClient] = None,
                 host: str = "localhost", port: int = 6379, db: int = 0):
        self.name = name
        self.client = client or RespClient(host, port, db=db)
        self._batch_pop = True          # downgraded on first unsupported RPOP count

    def push(self, msg: str) -> None:
        self.client.lpush(self.name, msg)

    def pop(self) -> Optional[str]:
        return self.client.rpop(self.name)

    def drain(self) -> List[str]:
        """Empty the list. Batched (one round-trip per 128 messages) on
        redis ≥ 6.2; falls back to one RPOP per message on older servers —
        this sits on the serving loop's per-event path."""
        out: List[str] = []
        while self._batch_pop:
            try:
                batch = self.client.rpop_count(self.name, 128)
            except RespError:
                self._batch_pop = False
                break
            if batch is None:
                return out
            out.extend(batch)
            if len(batch) < 128:
                return out
        while True:
            msg = self.pop()
            if msg is None:
                return out
            out.append(msg)

    def __len__(self) -> int:
        return self.client.llen(self.name)
