"""Unified listener: one port serves both protocols.

The reference's server accepts on a single port and sniffs the first
byte of each connection: '^' (0x5e — the first byte of the native
HELLO opcode) routes to the native binary transport, anything else to
the HTTP transport (reference: server/listener.cc:223-295). This
listener peeks the byte (MSG_PEEK, so the downstream parser sees the
full stream) and dispatches accordingly.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional


class Listener:
    FIRST_BYTE_TIMEOUT = 10.0

    def __init__(self, http_server, native_server, host="127.0.0.1", port=9175):
        """http_server: EventQLServer (dispatch mode), native_server:
        NativeTCPServer (its connection handler is reused)."""
        self.http_server = http_server
        self.native_server = native_server
        self.host = host
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(128)
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    def _accept_loop(self):
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._dispatch, args=(conn, addr), daemon=True
            )
            t.start()

    def _dispatch(self, conn: socket.socket, addr):
        try:
            conn.settimeout(self.FIRST_BYTE_TIMEOUT)
            first = conn.recv(1, socket.MSG_PEEK)
            if not first:
                conn.close()
                return
            conn.settimeout(None)
            if first == b"\x5e":  # '^' — native HELLO (listener.cc:276-287)
                self.native_server._handle_connection(conn)
                conn.close()
            else:
                self.http_server.handle_socket(conn, addr)
        except (OSError, ConnectionError):
            try:
                conn.close()
            except OSError:
                pass
