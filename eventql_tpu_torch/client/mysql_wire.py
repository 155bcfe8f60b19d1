"""Minimal MySQL client protocol (stdlib-only) for mysql2evql's
live-server mode.

The reference's mysql2evql streams rows out of a running MySQL server
through libmysqlclient (reference: tools/mysql2evql.cc:56-66,162-221,
util/mysql/MySQLConnection.h). No MySQL driver ships in this image, so
this module speaks the wire protocol directly: protocol-41 handshake
with mysql_native_password auth, COM_QUERY, and text-protocol
resultset decoding — exactly the subset `SHOW COLUMNS` and
`SELECT * FROM t` need.

Protocol shapes follow the public MySQL client/server protocol
(packets = 3-byte LE length + sequence byte; lenenc integers/strings;
OK=0x00 / ERR=0xff / EOF=0xfe markers).
"""

from __future__ import annotations

import hashlib
import socket
import struct
from typing import Iterator, List, Optional, Tuple

CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000

COM_QUIT = 0x01
COM_QUERY = 0x03


class MySQLError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"MySQL error {code}: {message}")
        self.code = code


def _native_password(password: str, nonce: bytes) -> bytes:
    """mysql_native_password scramble:
    SHA1(pw) XOR SHA1(nonce + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    p1 = hashlib.sha1(password.encode("utf-8")).digest()
    p2 = hashlib.sha1(p1).digest()
    mix = hashlib.sha1(nonce + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, mix))


def _read_lenenc_int(buf: bytes, pos: int) -> Tuple[Optional[int], int]:
    b = buf[pos]
    pos += 1
    if b < 0xFB:
        return b, pos
    if b == 0xFB:  # NULL marker (in row context)
        return None, pos
    if b == 0xFC:
        return struct.unpack_from("<H", buf, pos)[0], pos + 2
    if b == 0xFD:
        return int.from_bytes(buf[pos : pos + 3], "little"), pos + 3
    return struct.unpack_from("<Q", buf, pos)[0], pos + 8


def _read_lenenc_str(buf: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    n, pos = _read_lenenc_int(buf, pos)
    if n is None:
        return None, pos
    return buf[pos : pos + n], pos + n


def _lenenc_int(v: int) -> bytes:
    if v < 0xFB:
        return bytes([v])
    if v < 1 << 16:
        return b"\xfc" + struct.pack("<H", v)
    if v < 1 << 24:
        return b"\xfd" + v.to_bytes(3, "little")
    return b"\xfe" + struct.pack("<Q", v)


class MySQLConnection:
    """A blocking protocol-41 client connection."""

    def __init__(
        self,
        host: str,
        port: int = 3306,
        user: str = "root",
        password: str = "",
        database: str = "",
        timeout: float = 30.0,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._seq = 0
        self.server_version = ""
        self._handshake(user, password, database)

    # -- packet layer ---------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("mysql connection closed")
            buf += chunk
        return buf

    def _read_packet(self) -> bytes:
        # MySQL splits payloads >= 16 MB - 1 across packets: a length
        # of exactly 0xFFFFFF means a continuation packet follows (a
        # trailing empty packet terminates an exact-multiple payload)
        out = b""
        while True:
            hdr = self._recv_exact(4)
            length = int.from_bytes(hdr[:3], "little")
            self._seq = (hdr[3] + 1) & 0xFF
            out += self._recv_exact(length) if length else b""
            if length != 0xFFFFFF:
                return out

    def _send_packet(self, payload: bytes):
        hdr = len(payload).to_bytes(3, "little") + bytes([self._seq])
        self._seq = (self._seq + 1) & 0xFF
        self.sock.sendall(hdr + payload)

    # -- handshake ------------------------------------------------------
    def _handshake(self, user: str, password: str, database: str):
        pkt = self._read_packet()
        if pkt and pkt[0] == 0xFF:
            raise self._err(pkt)
        if not pkt or pkt[0] != 0x0A:
            raise ConnectionError("unsupported mysql protocol version")
        pos = 1
        end = pkt.index(b"\x00", pos)
        self.server_version = pkt[pos:end].decode("utf-8", "replace")
        pos = end + 1
        pos += 4  # thread id
        nonce = pkt[pos : pos + 8]
        pos += 8 + 1  # auth-plugin-data-part-1 + filler
        cap_low = struct.unpack_from("<H", pkt, pos)[0]
        pos += 2
        auth_len = 0
        if pos < len(pkt):
            pos += 1 + 2  # charset + status
            cap_high = struct.unpack_from("<H", pkt, pos)[0]
            pos += 2
            caps = cap_low | (cap_high << 16)
            auth_len = pkt[pos]
            pos += 1 + 10  # auth data len + reserved
            if caps & CLIENT_SECURE_CONNECTION:
                n2 = max(13, auth_len - 8)
                part2 = pkt[pos : pos + n2].rstrip(b"\x00")
                nonce += part2
                pos += n2

        flags = (
            CLIENT_PROTOCOL_41
            | CLIENT_SECURE_CONNECTION
            | CLIENT_PLUGIN_AUTH
        )
        if database:
            flags |= CLIENT_CONNECT_WITH_DB
        auth = _native_password(password, nonce[:20])
        resp = struct.pack("<IIB23x", flags, 1 << 24, 33)  # utf8
        resp += user.encode("utf-8") + b"\x00"
        resp += bytes([len(auth)]) + auth
        if database:
            resp += database.encode("utf-8") + b"\x00"
        resp += b"mysql_native_password\x00"
        self._send_packet(resp)

        pkt = self._read_packet()
        if pkt and pkt[0] == 0xFF:
            raise self._err(pkt)
        # auth-switch / auth-more-data would arrive as 0xFE/0x01; the
        # reference's libmysqlclient path likewise assumes native auth
        if pkt and pkt[0] == 0xFE:
            raise ConnectionError(
                "server requested an unsupported auth switch (only "
                "mysql_native_password is implemented; for MySQL 8's "
                "caching_sha2_password default, create the import "
                "user WITH mysql_native_password)"
            )

    def _err(self, pkt: bytes) -> MySQLError:
        code = struct.unpack_from("<H", pkt, 1)[0]
        msg = pkt[3:]
        if msg[:1] == b"#":  # SQL-state marker
            msg = msg[6:]
        return MySQLError(code, msg.decode("utf-8", "replace"))

    # -- queries --------------------------------------------------------
    def query(self, sql: str):
        """Run one statement; returns (column_names, row_iterator).
        Rows are lists of Optional[bytes] (text protocol). Statements
        without a resultset return ([], empty iterator)."""
        self._seq = 0
        self._send_packet(bytes([COM_QUERY]) + sql.encode("utf-8"))
        pkt = self._read_packet()
        if pkt and pkt[0] == 0xFF:
            raise self._err(pkt)
        if pkt and pkt[0] == 0x00:  # OK: no resultset
            return [], iter(())
        ncols, _pos = _read_lenenc_int(pkt, 0)
        names: List[str] = []
        for _ in range(ncols):
            col = self._read_packet()
            p = 0
            parts = []
            for _f in range(6):  # catalog..org_name
                s, p = _read_lenenc_str(col, p)
                parts.append(s)
            names.append((parts[4] or b"").decode("utf-8", "replace"))
        pkt = self._read_packet()  # EOF after column definitions
        if not (pkt and pkt[0] == 0xFE and len(pkt) < 9):
            raise ConnectionError("expected EOF after column defs")

        def rows() -> Iterator[List[Optional[bytes]]]:
            while True:
                r = self._read_packet()
                if r and r[0] == 0xFF:
                    raise self._err(r)
                if r and r[0] == 0xFE and len(r) < 9:
                    return  # EOF: resultset done
                row: List[Optional[bytes]] = []
                p = 0
                for _ in range(ncols):
                    s, p = _read_lenenc_str(r, p)
                    row.append(s)
                yield row

        return names, rows()

    def table_schema(self, table: str):
        """[(name, mysql_type, nullable, is_pk)] via SHOW COLUMNS
        (reference: MySQLConnection::getTableSchema issues DESCRIBE)."""
        names, rows = self.query(f"SHOW COLUMNS FROM `{table}`")
        idx = {n.lower(): i for i, n in enumerate(names)}
        out = []
        for row in rows:
            get = lambda k: (row[idx[k]] or b"").decode("utf-8", "replace")
            out.append(
                (
                    get("field"),
                    get("type"),
                    get("null").upper() == "YES",
                    get("key").upper() == "PRI",
                )
            )
        return out

    def close(self):
        try:
            self._seq = 0
            self._send_packet(bytes([COM_QUIT]))
        except OSError:
            pass
        self.sock.close()
