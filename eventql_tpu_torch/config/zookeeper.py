"""Minimal ZooKeeper wire protocol: client + embedded server.

The reference's cluster backend is ZooKeeper via the C client library
(reference: config/config_directory_zookeeper.cc; vendored client in
deps/3rdparty/zookeeper). This module speaks the real ZooKeeper (jute)
wire protocol, so the TPU build's client can talk to a stock ZooKeeper
ensemble — and, because the build image ships no ZooKeeper, it also
provides an embedded single-node server implementing the subset the
config directory needs:

  connect/session (with ephemeral-node cleanup on session close),
  create (persistent/ephemeral/sequence), delete, exists, getData,
  setData (version CAS), getChildren/getChildren2, ping, closeSession,
  one-shot data + child watches (NodeCreated/NodeDeleted/
  NodeDataChanged/NodeChildrenChanged events).

Protocol notes (jute binary, big-endian):
  handshake: [len][ConnectRequest]  →  [len][ConnectResponse]
  request:   [len][xid:i32][type:i32][body]
  response:  [len][xid:i32][zxid:i64][err:i32][body]
  watch event: xid == -1, body = WatcherEvent{type, state, path}
  ping: xid == -2, type == 11
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# op codes
OP_CREATE = 1
OP_DELETE = 2
OP_EXISTS = 3
OP_GETDATA = 4
OP_SETDATA = 5
OP_GETCHILDREN = 8
OP_GETCHILDREN2 = 12
OP_PING = 11
OP_CLOSE = -11

# create flags
EPHEMERAL = 1
SEQUENCE = 2

# error codes
ZOK = 0
ZNONODE = -101
ZNODEEXISTS = -110
ZBADVERSION = -103
ZNOTEMPTY = -111
ZNOCHILDRENFOREPHEMERALS = -108

# watcher event types / states
EVENT_CREATED = 1
EVENT_DELETED = 2
EVENT_CHANGED = 3
EVENT_CHILD = 4
STATE_CONNECTED = 3

XID_WATCH = -1
XID_PING = -2


class ZKError(Exception):
    def __init__(self, code: int, msg: str = ""):
        self.code = code
        super().__init__(msg or f"zookeeper error {code}")


# -- jute ---------------------------------------------------------------------

def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + b


def _pack_buf(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.data, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from(">q", self.data, self.pos)
        self.pos += 8
        return v

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def buf(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def s(self) -> str:
        return (self.buf() or b"").decode()


class Stat:
    """Znode stat (jute Stat record, 68 bytes)."""

    FMT = ">qqqqiiiqiiq"
    SIZE = struct.calcsize(FMT)
    __slots__ = ("czxid", "mzxid", "ctime", "mtime", "version", "cversion",
                 "aversion", "ephemeral_owner", "data_length",
                 "num_children", "pzxid")

    def __init__(self, czxid=0, mzxid=0, ctime=0, mtime=0, version=0,
                 cversion=0, aversion=0, ephemeral_owner=0, data_length=0,
                 num_children=0, pzxid=0):
        self.czxid = czxid
        self.mzxid = mzxid
        self.ctime = ctime
        self.mtime = mtime
        self.version = version
        self.cversion = cversion
        self.aversion = aversion
        self.ephemeral_owner = ephemeral_owner
        self.data_length = data_length
        self.num_children = num_children
        self.pzxid = pzxid

    def pack(self) -> bytes:
        return struct.pack(
            self.FMT, self.czxid, self.mzxid, self.ctime, self.mtime,
            self.version, self.cversion, self.aversion,
            self.ephemeral_owner, self.data_length, self.num_children,
            self.pzxid)

    @classmethod
    def unpack(cls, r: _Reader) -> "Stat":
        vals = struct.unpack_from(cls.FMT, r.data, r.pos)
        r.pos += cls.SIZE
        return cls(*vals)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("zookeeper connection closed")
        out += chunk
    return out


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack(">i", _recv_exact(sock, 4))
    return _recv_exact(sock, n)


def _send_frame(sock: socket.socket, payload: bytes):
    sock.sendall(struct.pack(">i", len(payload)) + payload)


# world:anyone ACL (what the reference client passes: ZOO_OPEN_ACL_UNSAFE)
_OPEN_ACL = struct.pack(">i", 1) + struct.pack(">i", 31) \
    + _pack_str("world") + _pack_str("anyone")


# -- client -------------------------------------------------------------------

class ZooKeeperClient:
    """Blocking ZooKeeper client over the jute wire protocol with a
    reader thread for watch events and ping keepalive."""

    def __init__(self, hosts: str, session_timeout_ms: int = 10000,
                 watcher: Optional[Callable] = None):
        host, _, port = hosts.partition(":")
        self._sock = socket.create_connection(
            (host, int(port or 2181)), timeout=10)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._xid = 0
        self._pending: Dict[int, list] = {}
        self._watcher = watcher
        self._closed = False
        self.session_id = 0

        # handshake
        req = struct.pack(">iqi", 0, 0, session_timeout_ms) \
            + struct.pack(">q", 0) + _pack_buf(b"\x00" * 16)
        _send_frame(self._sock, req)
        resp = _Reader(_recv_frame(self._sock))
        resp.i32()  # protocol version
        self.negotiated_timeout = resp.i32()
        self.session_id = resp.i64()
        resp.buf()  # passwd

        self._sock.settimeout(None)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._pinger = threading.Thread(target=self._ping_loop, daemon=True)
        self._pinger.start()

    # -- plumbing ------------------------------------------------------
    def _read_loop(self):
        try:
            while not self._closed:
                frame = _recv_frame(self._sock)
                r = _Reader(frame)
                xid = r.i32()
                if xid == XID_WATCH:
                    r.i64()  # zxid
                    r.i32()  # err
                    etype = r.i32()
                    state = r.i32()
                    path = r.s()
                    if self._watcher is not None:
                        try:
                            self._watcher(etype, state, path)
                        except Exception:
                            pass
                    continue
                if xid == XID_PING:
                    continue
                with self._lock:
                    slot = self._pending.pop(xid, None)
                if slot is not None:
                    slot[1] = frame
                    slot[0].set()
        except (ConnectionError, OSError):
            self._closed = True
            with self._lock:
                for slot in self._pending.values():
                    slot[1] = None
                    slot[0].set()
                self._pending.clear()

    def _ping_loop(self):
        interval = max(self.negotiated_timeout / 3000.0, 1.0)
        while not self._closed:
            time.sleep(interval)
            if self._closed:
                return
            try:
                with self._lock:
                    payload = struct.pack(">ii", XID_PING, OP_PING)
                    _send_frame(self._sock, payload)
            except OSError:
                return

    def _call(self, op: int, body: bytes) -> _Reader:
        if self._closed:
            raise ConnectionError("zookeeper session closed")
        ev = threading.Event()
        slot = [ev, None]
        with self._lock:
            self._xid += 1
            xid = self._xid
            self._pending[xid] = slot
            _send_frame(self._sock, struct.pack(">ii", xid, op) + body)
        if not ev.wait(timeout=30):
            # drop the slot: a late reply must not signal an abandoned
            # event, and long-lived pooled sessions must not leak one
            # pending entry per timeout
            with self._lock:
                self._pending.pop(xid, None)
            raise ZKError(-4, "zookeeper request timeout")
        if slot[1] is None:
            raise ConnectionError("zookeeper connection lost")
        r = _Reader(slot[1])
        r.i32()  # xid
        r.i64()  # zxid
        err = r.i32()
        if err != ZOK:
            raise ZKError(err)
        return r

    # -- operations -----------------------------------------------------
    def create(self, path: str, data: bytes = b"", flags: int = 0) -> str:
        body = _pack_str(path) + _pack_buf(data) + _OPEN_ACL \
            + struct.pack(">i", flags)
        return self._call(OP_CREATE, body).s()

    def delete(self, path: str, version: int = -1):
        self._call(OP_DELETE, _pack_str(path) + struct.pack(">i", version))

    def exists(self, path: str, watch: bool = False) -> Optional[Stat]:
        try:
            r = self._call(OP_EXISTS, _pack_str(path)
                           + struct.pack(">b", 1 if watch else 0))
        except ZKError as e:
            if e.code == ZNONODE:
                return None
            raise
        return Stat.unpack(r)

    def get(self, path: str, watch: bool = False) -> Tuple[bytes, Stat]:
        r = self._call(OP_GETDATA, _pack_str(path)
                       + struct.pack(">b", 1 if watch else 0))
        data = r.buf() or b""
        return data, Stat.unpack(r)

    def set(self, path: str, data: bytes, version: int = -1) -> Stat:
        r = self._call(OP_SETDATA, _pack_str(path) + _pack_buf(data)
                       + struct.pack(">i", version))
        return Stat.unpack(r)

    def get_children(self, path: str, watch: bool = False) -> List[str]:
        r = self._call(OP_GETCHILDREN, _pack_str(path)
                       + struct.pack(">b", 1 if watch else 0))
        return [r.s() for _ in range(r.i32())]

    def ensure_path(self, path: str):
        """Create path and parents if missing (helper, not a ZK op)."""
        parts = path.strip("/").split("/")
        cur = ""
        for p in parts:
            cur += "/" + p
            try:
                self.create(cur)
            except ZKError as e:
                if e.code != ZNODEEXISTS:
                    raise

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            with self._lock:
                self._xid += 1
                _send_frame(self._sock,
                            struct.pack(">ii", self._xid, OP_CLOSE))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# -- embedded server ----------------------------------------------------------

class _Znode:
    __slots__ = ("data", "children", "stat", "seq_counter")

    def __init__(self, data: bytes, stat: Stat):
        self.data = data
        self.children: Dict[str, _Znode] = {}
        self.stat = stat
        self.seq_counter = 0


class ZooKeeperServer:
    """Embedded single-node ZooKeeper server (the op subset above).

    Sessions: each connection is one session; ephemeral nodes are
    deleted (with watch notifications) when its connection closes.
    Watches are one-shot, per the protocol.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._zxid = 0
        self._next_session = int(time.time() * 1000) << 16 | os.getpid() & 0xFFFF
        self._lock = threading.RLock()
        self._root = _Znode(b"", Stat())
        # path -> list of (conn) with a pending data watch / child watch
        self._data_watches: Dict[str, List] = {}
        self._child_watches: Dict[str, List] = {}
        self._ephemerals: Dict[int, List[str]] = {}
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = False
        # watch notifications dispatch OFF the server lock: every op
        # runs under self._lock, so a sendall to one slow/stalled
        # watcher in _fire would freeze all coordination (liveness,
        # leader election, CAS) behind the lock
        import queue as _queue

        self._notify_queue: _queue.Queue = _queue.Queue()
        self._notify_thread = threading.Thread(
            target=self._notify_loop, daemon=True
        )
        self._notify_thread.start()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "ZooKeeperServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        return self

    def stop(self):
        self._stopped = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True).start()

    # -- znode tree helpers ----------------------------------------------
    def _resolve(self, path: str) -> Optional[_Znode]:
        if path == "/":
            return self._root
        node = self._root
        for part in path.strip("/").split("/"):
            node = node.children.get(part)
            if node is None:
                return None
        return node

    def _parent_of(self, path: str) -> Tuple[Optional[_Znode], str]:
        parts = path.strip("/").split("/")
        parent = self._resolve("/" + "/".join(parts[:-1])) \
            if len(parts) > 1 else self._root
        return parent, parts[-1]

    def _fire(self, registry: Dict[str, List], path: str, etype: int):
        conns = registry.pop(path, [])
        if not conns:
            return
        payload = struct.pack(">iqi", XID_WATCH, self._zxid, ZOK) \
            + struct.pack(">ii", etype, STATE_CONNECTED) + _pack_str(path)
        self._notify_queue.put((conns, payload))

    def _notify_loop(self):
        while True:
            conns, payload = self._notify_queue.get()
            for conn_lock, conn in conns:
                try:
                    with conn_lock:
                        _send_frame(conn, payload)
                except OSError:
                    pass

    def _notify_node(self, path: str, etype: int):
        self._fire(self._data_watches, path, etype)

    def _notify_children(self, path: str):
        self._fire(self._child_watches, path, EVENT_CHILD)

    # -- per-connection session ------------------------------------------
    def _serve_conn(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn_lock = threading.Lock()
        session_id = 0
        try:
            req = _Reader(_recv_frame(conn))
            req.i32()  # protocol version
            req.i64()  # last zxid
            timeout = req.i32()
            req.i64()  # session id (reconnect unsupported: new session)
            with self._lock:
                self._next_session += 1
                session_id = self._next_session
                self._ephemerals[session_id] = []
            resp = struct.pack(">iiq", 0, max(timeout, 4000), session_id) \
                + _pack_buf(b"\x00" * 16)
            with conn_lock:
                _send_frame(conn, resp)

            while True:
                frame = _Reader(_recv_frame(conn))
                xid = frame.i32()
                op = frame.i32()
                if op == OP_CLOSE:
                    with conn_lock:
                        _send_frame(conn, struct.pack(
                            ">iqi", xid, self._zxid, ZOK))
                    return
                if op == OP_PING:
                    with conn_lock:
                        _send_frame(conn, struct.pack(
                            ">iqi", XID_PING, self._zxid, ZOK))
                    continue
                err, body = self._dispatch(
                    op, frame, session_id, conn_lock, conn)
                with conn_lock:
                    _send_frame(conn, struct.pack(
                        ">iqi", xid, self._zxid, err) + body)
        except (ConnectionError, OSError):
            pass
        finally:
            self._end_session(session_id)
            try:
                conn.close()
            except OSError:
                pass

    def _end_session(self, session_id: int):
        with self._lock:
            paths = self._ephemerals.pop(session_id, [])
            for path in paths:
                parent, name = self._parent_of(path)
                if parent is not None and name in parent.children:
                    del parent.children[name]
                    parent.stat.cversion += 1
                    self._zxid += 1
                    self._notify_node(path, EVENT_DELETED)
                    self._notify_children(
                        "/" + path.strip("/").rsplit("/", 1)[0]
                        if "/" in path.strip("/") else "/")

    # -- op dispatch -----------------------------------------------------
    def _dispatch(self, op, r, session_id, conn_lock, conn):
        with self._lock:
            if op == OP_CREATE:
                return self._op_create(r, session_id)
            if op == OP_DELETE:
                return self._op_delete(r)
            if op == OP_EXISTS:
                return self._op_exists(r, conn_lock, conn)
            if op == OP_GETDATA:
                return self._op_getdata(r, conn_lock, conn)
            if op == OP_SETDATA:
                return self._op_setdata(r)
            if op in (OP_GETCHILDREN, OP_GETCHILDREN2):
                return self._op_getchildren(
                    r, conn_lock, conn, with_stat=op == OP_GETCHILDREN2)
        return -6, b""  # unimplemented

    def _op_create(self, r, session_id):
        path = r.s()
        data = r.buf() or b""
        nacl = r.i32()
        for _ in range(nacl):
            r.i32()
            r.s()
            r.s()
        flags = r.i32()
        parent, name = self._parent_of(path)
        if parent is None:
            return ZNONODE, b""
        if parent.stat.ephemeral_owner:
            return ZNOCHILDRENFOREPHEMERALS, b""
        if flags & SEQUENCE:
            name = f"{name}{parent.seq_counter:010d}"
            parent.seq_counter += 1
            path = path.rsplit("/", 1)[0] + "/" + name
        if name in parent.children:
            return ZNODEEXISTS, b""
        self._zxid += 1
        now = int(time.time() * 1000)
        stat = Stat(czxid=self._zxid, mzxid=self._zxid, ctime=now,
                    mtime=now, data_length=len(data),
                    ephemeral_owner=session_id if flags & EPHEMERAL else 0)
        parent.children[name] = _Znode(data, stat)
        parent.stat.cversion += 1
        parent.stat.num_children = len(parent.children)
        if flags & EPHEMERAL:
            self._ephemerals.setdefault(session_id, []).append(path)
        self._notify_node(path, EVENT_CREATED)
        parent_path = path.rsplit("/", 1)[0] or "/"
        self._notify_children(parent_path)
        return ZOK, _pack_str(path)

    def _op_delete(self, r):
        path = r.s()
        version = r.i32()
        parent, name = self._parent_of(path)
        node = parent.children.get(name) if parent else None
        if node is None:
            return ZNONODE, b""
        if version != -1 and node.stat.version != version:
            return ZBADVERSION, b""
        if node.children:
            return ZNOTEMPTY, b""
        self._zxid += 1
        del parent.children[name]
        parent.stat.cversion += 1
        parent.stat.num_children = len(parent.children)
        if node.stat.ephemeral_owner:
            owned = self._ephemerals.get(node.stat.ephemeral_owner, [])
            if path in owned:
                owned.remove(path)
        self._notify_node(path, EVENT_DELETED)
        parent_path = path.rsplit("/", 1)[0] or "/"
        self._notify_children(parent_path)
        return ZOK, b""

    def _op_exists(self, r, conn_lock, conn):
        path = r.s()
        watch = r.u8()
        node = self._resolve(path)
        if watch:
            # exists watches fire on create too, so register either way
            self._data_watches.setdefault(path, []).append(
                (conn_lock, conn))
        if node is None:
            return ZNONODE, b""
        return ZOK, node.stat.pack()

    def _op_getdata(self, r, conn_lock, conn):
        path = r.s()
        watch = r.u8()
        node = self._resolve(path)
        if node is None:
            return ZNONODE, b""
        if watch:
            self._data_watches.setdefault(path, []).append(
                (conn_lock, conn))
        return ZOK, _pack_buf(node.data) + node.stat.pack()

    def _op_setdata(self, r):
        path = r.s()
        data = r.buf() or b""
        version = r.i32()
        node = self._resolve(path)
        if node is None:
            return ZNONODE, b""
        if version != -1 and node.stat.version != version:
            return ZBADVERSION, b""
        self._zxid += 1
        node.data = data
        node.stat.version += 1
        node.stat.mzxid = self._zxid
        node.stat.mtime = int(time.time() * 1000)
        node.stat.data_length = len(data)
        self._notify_node(path, EVENT_CHANGED)
        return ZOK, node.stat.pack()

    def _op_getchildren(self, r, conn_lock, conn, with_stat: bool):
        path = r.s()
        watch = r.u8()
        node = self._resolve(path)
        if node is None:
            return ZNONODE, b""
        if watch:
            self._child_watches.setdefault(path, []).append(
                (conn_lock, conn))
        names = sorted(node.children)
        body = struct.pack(">i", len(names)) \
            + b"".join(_pack_str(n) for n in names)
        if with_stat:
            body += node.stat.pack()
        return ZOK, body
