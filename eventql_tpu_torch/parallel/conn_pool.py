"""Server-to-server native-protocol connection pool + DNS cache.

Fan-out opens one native-TCP connection per shard request; without
reuse, a 256-shard query pays 256 TCP+HELLO handshakes every time it
runs. The reference keys pooled sockets by host with age-based linger
eviction and global/per-host caps (reference:
transport/native/client_tcp.h:233-270, client_tcp.cc:867-990 —
TCPConnectionPool built in db/database.cc:283-290 from the
server.s2s_pool_* config keys) and caches DNS lookups
(util/net/dnscache.h). This module is the TPU build's equivalent,
shared process-wide so per-request ClusterTableProvider instances all
reuse the same sockets.

Semantics mirrored from the reference:
  * checkout scans a host's cached list newest-first and returns the
    first connection younger than the linger timeout
    (client_tcp.cc:920-945 getFD)
  * checkin drops the socket when the global cap is reached and evicts
    over-cap / lingered-out entries per host (storeFD:966-1008)
  * a connection is only stored back after a CLEAN request (the
    reference only pools on graceful close, client_tcp.cc:856-864);
    any transport error closes it instead
  * a reused socket may have been closed by the peer while pooled —
    `call` retries exactly once on a fresh connection when the failure
    happened on a pooled socket (the reference burns a replica-failover
    attempt instead; retrying locally keeps failover semantics clean)
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

# reference defaults (evqld.cc:239-241): unlimited conns, 1 s linger
DEFAULT_MAX_CONNS = 0
DEFAULT_MAX_CONNS_PER_HOST = 0
DEFAULT_LINGER_TIMEOUT = 1.0  # seconds (reference: 1000000 µs)

DNS_TTL = 60.0


class DNSCache:
    """getaddrinfo result cache (reference: util/net/dnscache.h — the
    reference caches forever; a TTL keeps long-lived evqld processes
    from pinning a moved host)."""

    def __init__(self, ttl: float = DNS_TTL):
        self._ttl = ttl
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, int], Tuple[float, list]] = {}

    def resolve(self, host: str, port: int) -> list:
        key = (host, port)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and now - hit[0] < self._ttl:
                return hit[1]
        infos = socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM
        )
        with self._lock:
            self._cache[key] = (now, infos)
        return infos

    def connect(self, host: str, port: int, timeout=None) -> socket.socket:
        err = None
        for family, stype, proto, _cn, sa in self.resolve(host, port):
            try:
                s = socket.socket(family, stype, proto)
                if timeout is not None:
                    s.settimeout(timeout)
                s.connect(sa)
                return s
            except OSError as e:
                err = e
                try:
                    s.close()
                except OSError:
                    pass
        raise err if err is not None else OSError("resolve failed")


class TCPConnectionPool:
    """Pool of idle NativeTCPClient connections keyed by (host, port)."""

    def __init__(
        self,
        max_conns: int = DEFAULT_MAX_CONNS,
        max_conns_per_host: int = DEFAULT_MAX_CONNS_PER_HOST,
        linger_timeout: float = DEFAULT_LINGER_TIMEOUT,
    ):
        self.max_conns = max_conns
        self.max_conns_per_host = max_conns_per_host
        self.linger_timeout = linger_timeout
        self.dns_cache = DNSCache()
        self._lock = threading.Lock()
        self._conns: Dict[Tuple[str, int], List[Tuple[float, object]]] = {}
        self._num_conns = 0
        # observability (repeated-query benches assert on these)
        self.stats_hits = 0
        self.stats_misses = 0

    # -- raw checkout / checkin ------------------------------------------

    def checkout(self, addr: Tuple[str, int]):
        """Newest pooled connection younger than the linger timeout, or
        None (reference: getFD scans back-to-front)."""
        cutoff = time.monotonic() - self.linger_timeout
        stale = []
        got = None
        with self._lock:
            lst = self._conns.get(tuple(addr))
            if lst:
                while lst and got is None:
                    t, client = lst.pop()
                    self._num_conns -= 1
                    if t > cutoff:
                        got = client
                    else:
                        stale.append(client)
            if got is not None:
                self.stats_hits += 1
            else:
                self.stats_misses += 1
        for c in stale:
            _close_quiet(c)
        return got

    def checkin(self, addr: Tuple[str, int], client) -> None:
        """Store an idle, protocol-clean connection for reuse."""
        addr = tuple(addr)
        now = time.monotonic()
        cutoff = now - self.linger_timeout
        evicted = []
        with self._lock:
            if self.max_conns and self._num_conns >= self.max_conns:
                evicted.append(client)
            else:
                lst = self._conns.setdefault(addr, [])
                # evict lingered-out entries (oldest are at the front)
                while lst and lst[0][0] < cutoff:
                    evicted.append(lst.pop(0)[1])
                    self._num_conns -= 1
                while (
                    self.max_conns_per_host
                    and len(lst) >= self.max_conns_per_host
                ):
                    evicted.append(lst.pop(0)[1])
                    self._num_conns -= 1
                lst.append((now, client))
                self._num_conns += 1
        for c in evicted:
            _close_quiet(c)

    def close(self) -> None:
        with self._lock:
            all_conns = [
                c for lst in self._conns.values() for _t, c in lst
            ]
            self._conns.clear()
            self._num_conns = 0
        for c in all_conns:
            _close_quiet(c)

    # -- pooled request helper -------------------------------------------

    def call(self, addr: Tuple[str, int], fn, connect=None):
        """Run `fn(client)` on a pooled (or fresh) connection to addr.

        The connection returns to the pool after a clean request —
        including server-reported SQLError responses, after which the
        peer awaits the next request — and is closed on transport
        errors AND on ProtocolDesyncError (unexpected opcode
        mid-resultset leaves unread frames on the socket; pooling it
        would feed stale frames to the next request). A transport
        error on a REUSED socket (peer closed it while pooled) retries
        exactly once on a fresh connection."""
        from eventql_tpu_torch.core.errors import ProtocolDesyncError, SQLError

        if connect is None:
            from eventql_tpu_torch.server.native_tcp import NativeTCPClient

            connect = lambda: NativeTCPClient(addr[0], addr[1])

        client = self.checkout(addr)
        reused = client is not None
        if client is None:
            client = connect()
        try:
            out = fn(client)
        except ProtocolDesyncError:
            _close_quiet(client)
            raise
        except SQLError:
            # server-reported error: the connection stays healthy
            self.checkin(addr, client)
            raise
        except (OSError, ConnectionError):
            _close_quiet(client)
            if not reused:
                raise
            # pooled socket had died; one fresh retry
            client = connect()
            try:
                out = fn(client)
            except ProtocolDesyncError:
                _close_quiet(client)
                raise
            except SQLError:
                self.checkin(addr, client)
                raise
            except (OSError, ConnectionError):
                _close_quiet(client)
                raise
        self.checkin(addr, client)
        return out


def _close_quiet(client) -> None:
    try:
        client.close()
    except (OSError, ConnectionError):
        pass


# process-wide pool: per-request ClusterTableProvider instances share it
_GLOBAL_POOL: Optional[TCPConnectionPool] = None
_GLOBAL_LOCK = threading.Lock()


def global_pool() -> TCPConnectionPool:
    global _GLOBAL_POOL
    with _GLOBAL_LOCK:
        if _GLOBAL_POOL is None:
            _GLOBAL_POOL = TCPConnectionPool()
        return _GLOBAL_POOL
