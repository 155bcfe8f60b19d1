"""HTTP API server.

Re-implements the reference's REST transport surface
(reference: transport/http/api_servlet.cc:127-198 routes; JSON result
format from server/sql/codec/json_codec.cc:29-82:
  {"results": [{"type": "table", "columns": [...], "rows": [[...]]}]}
errors as {"error": "..."}; SSE streaming per json_sse_codec.cc emits
`result` events carrying the same payload).

Routes:
  GET/POST /api/v1/sql           query={q} format=json|json_sse
  POST     /api/v1/tables/insert [{table, data}, ...]
  POST     /api/v1/tables/list
  POST     /api/v1/tables/create {table, schema:{columns:[...]}, primary_key}
  POST     /api/v1/tables/drop   {table}
  GET/POST /api/v1/tables/describe?table=t
  POST     /api/v1/tables/add_field / remove_field
  POST     /api/v1/mapreduce/...  (mapreduce/ is not ported to
                                 eventql_tpu_torch yet: 500 + error)
  GET      /api/v1/auth/info
  GET      /eventql/stats
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from eventql_tpu_torch.core.errors import SQLError
from eventql_tpu_torch.core.types import sql_typename
from eventql_tpu_torch.db.table_service import TableService, stype_from_name
from eventql_tpu_torch.exec.runtime import PlanCache, Runtime
from eventql_tpu_torch.plan.nodes import ColumnDefinition, CreateTableNode


class ServerStats:
    """Counters in the spirit of the reference's ServerStats
    (reference: server/server_stats.h:32-40)."""

    def __init__(self):
        self.num_queries = 0
        self.num_inserts = 0
        self.num_errors = 0
        self.lock = threading.Lock()

    def as_dict(self):
        return {
            "num_queries": self.num_queries,
            "num_inserts": self.num_inserts,
            "num_errors": self.num_errors,
        }


class EventQLServer:
    def __init__(
        self,
        table_service: Optional[TableService] = None,
        host="127.0.0.1",
        port=9175,
        query_provider_factory=None,
        client_auth=None,
        device="cuda",
    ):
        """``device``: where the queries' routes run ("cuda", which
        raises here without a card; "cpu" for the kernels' plain
        versions; None for the host engine)."""
        from eventql_tpu_torch.server.auth import TrustClientAuth

        self.client_auth = client_auth or TrustClientAuth()
        self.table_service = table_service or TableService()
        # queries may run against a different provider than inserts —
        # cluster coordinators fan SQL out while writes stay local
        self.query_provider_factory = (
            query_provider_factory or (lambda: self.table_service)
        )
        # server-side plan cache: repeated queries skip parse+plan
        # (invalidated by the provider's schema version)
        self.runtime = Runtime(plan_cache=PlanCache(), device=device)
        self.stats = ServerStats()
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self, bind: bool = True):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                server.handle(self, {})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                self.raw_body = body
                try:
                    payload = json.loads(body) if body else {}
                except json.JSONDecodeError:
                    payload = {}
                server.handle(self, payload)

        if bind:
            self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
            self._thread.start()
        else:
            # dispatch mode: an external Listener owns the socket and
            # hands accepted connections to handle_socket()
            self._httpd = ThreadingHTTPServer(
                (self.host, 0), Handler, bind_and_activate=False
            )
        return self

    def handle_socket(self, conn, addr):
        """Serve one already-accepted connection (used by the unified
        protocol-sniffing Listener, server/listener.py)."""
        try:
            self._httpd.RequestHandlerClass(conn, addr, self._httpd)
        finally:
            # we bypass socketserver's process_request, so its
            # shutdown_request never runs; close the socket here or the
            # client never sees EOF (and the fd leaks)
            self._httpd.shutdown_request(conn)

    def stop(self):
        if self._httpd:
            if self._thread is not None:
                self._httpd.shutdown()
            self._httpd.server_close()

    # -- request handling ----------------------------------------------
    def handle(self, h: BaseHTTPRequestHandler, payload):
        parsed = urlparse(h.path)
        path = parsed.path
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}

        # Authorization: "Token <t>" or "Basic <b64 user:pass>"
        # (reference: transport/http/http_auth.cc:32-63)
        from eventql_tpu_torch.server.auth import AuthError

        auth_data = {}
        hdrval = h.headers.get("Authorization", "")
        if hdrval.startswith("Token "):
            from urllib.parse import unquote

            auth_data["auth_token"] = unquote(hdrval[len("Token ") :])
        elif hdrval.startswith("Basic "):
            import base64 as _b64

            try:
                basic = _b64.b64decode(hdrval[len("Basic ") :]).decode()
            except Exception:
                basic = ""
            user, sep, password = basic.partition(":")
            auth_data["user"] = user
            if sep:
                auth_data["password"] = password
        try:
            self.client_auth.authenticate(auth_data)
        except AuthError as e:
            return self._json(h, 401, {"error": str(e)})
        try:
            if path in ("/api/v1/sql", "/api/v1/sql_stream"):
                return self._handle_sql(h, params, payload)
            if path == "/api/v1/tables/insert":
                return self._handle_insert(h, payload)
            if path == "/api/v1/tables/list":
                return self._handle_list(h)
            if path == "/api/v1/tables/create":
                return self._handle_create(h, payload)
            if path == "/api/v1/tables/add_field":
                return self._handle_add_field(h, payload)
            if path == "/api/v1/tables/remove_field":
                return self._handle_remove_field(h, payload)
            if path == "/api/v1/tables/drop":
                return self._handle_drop(h, payload)
            if path == "/api/v1/tables/describe":
                return self._handle_describe(h, params, payload)
            if path.startswith("/api/v1/mapreduce/"):
                from eventql_tpu_torch.exec.operators import _not_ported

                raise _not_ported("mapreduce")
            if path == "/api/v1/auth/info":
                return self._json(h, 200, {"valid": True, "namespaces": []})
            if path == "/eventql/stats":
                out = self.stats.as_dict()
                # the process-wide exported counter set (what statsd
                # pushes): evqld.num_rows_scanned, device program
                # cache, partitions, ...
                from eventql_tpu_torch.utils.stats import (
                    StatsRepository,
                    evqld_stats,
                )

                evqld_stats()  # ensure the counter set is registered
                StatsRepository.get().for_each_stat(
                    lambda st: out.__setitem__(st.path, st.stat.get())
                )
                return self._json(h, 200, out)
            if path == "/eventql" or path.startswith("/eventql/"):
                return self._handle_status_page(h, path)
            self._text(h, 404, "not found")
        except SQLError as e:
            with self.stats.lock:
                self.stats.num_errors += 1
            self._json(h, 500, {"error": e.message})
        except Exception as e:  # pragma: no cover
            with self.stats.lock:
                self.stats.num_errors += 1
            self._json(h, 500, {"error": str(e)})

    # -- helpers --------------------------------------------------------
    def _json(self, h, status, obj):
        body = json.dumps(obj).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json; charset=utf-8")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _text(self, h, status, text):
        body = text.encode()
        h.send_response(status)
        h.send_header("Content-Type", "text/plain; charset=utf-8")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _html(self, h, status, html):
        body = html.encode()
        h.send_response(status)
        h.send_header("Content-Type", "text/html; charset=utf-8")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _handle_status_page(self, h, path):
        """Human status dashboard (reference: status_servlet.cc:97-230 —
        /eventql/ server overview, /eventql/db/<ns>/<table> drill-down)."""
        import resource

        parts = [p for p in path[len("/eventql"):].split("/") if p]
        style = (
            "<style>body{font-family:monospace;margin:2em}"
            "h1{font-size:1.2em}a{margin-right:1em}</style>"
        )
        menu = "<div><a href='/eventql/'>Dashboard</a>" \
               "<a href='/eventql/stats'>Stats</a></div>"

        if len(parts) >= 2 and parts[0] == "db":
            table = parts[2] if len(parts) >= 3 else None
            lines = []
            for t in self.table_service.list_tables():
                if table and t.table_name != table:
                    continue
                cols = ", ".join(f"{c[0]} {c[1].name}" for c in t.columns)
                lines.append(f"{t.table_name}: {cols}")
            html = (
                style + menu
                + f"<h1>eventql_tpu_torch db/{'/'.join(parts[1:])}</h1><pre>"
                + "\n".join(lines or ["(no tables)"])
                + "</pre>"
            )
            return self._html(h, 200, html)

        maxrss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        fd_soft, fd_hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        s = self.stats.as_dict()
        lines = [
            "Version: eventql_tpu_torch v0.1",
            f"Memory Usage - Peak: {maxrss_mb:.1f} MB",
            f"Max FDs: {fd_soft} (soft) / {fd_hard} (hard)",
            f"Number of Tables: {len(self.table_service.list_tables())}",
        ] + [f"{k}: {v}" for k, v in sorted(s.items())]
        # the process-wide exported counter set (evqld.num_rows_scanned,
        # device program cache, partitions, ... — what statsd pushes)
        from eventql_tpu_torch.utils.stats import StatsRepository, evqld_stats

        evqld_stats()  # ensure the counter set is registered
        repo_lines = []
        StatsRepository.get().for_each_stat(
            lambda st: repo_lines.append(f"{st.path}: {st.stat.get()}")
        )
        lines += sorted(repo_lines)
        html = (
            style + menu + "<h1>eventql_tpu_torch v0.1</h1><pre>"
            + "\n".join(lines) + "</pre>"
        )
        self._html(h, 200, html)

    # -- endpoints ------------------------------------------------------
    def _run_query(self, query: str):
        from eventql_tpu_torch.utils.stats import evqld_stats

        evqld_stats().num_queries.incr()
        txn = self.runtime.new_transaction(self.query_provider_factory())
        plan = self.runtime.build_query_plan(txn, query)
        results = []
        for i in range(plan.num_queries):
            r = plan.execute(i)
            results.append(
                {"type": "table", "columns": r.columns, "rows": r.rows}
            )
        with self.stats.lock:
            self.stats.num_queries += 1
        return results

    def _handle_sql(self, h, params, payload):
        query = payload.get("query") or params.get("query")
        fmt = payload.get("format") or params.get("format") or "json"
        if not query:
            if "query" in params or "query" in payload:
                return self._text(h, 400, "missing field: query")
            return self._text(h, 400, "missing ?query=... parameter")
        if fmt not in ("json", "json_sse"):
            return self._text(h, 400, f"invalid format: {fmt}")

        if fmt == "json":
            try:
                results = self._run_query(query)
            except SQLError as e:
                with self.stats.lock:
                    self.stats.num_errors += 1
                return self._json(h, 500, {"error": e.message})
            return self._json(h, 200, {"results": results})

        # json_sse: stream ONE `result` event whose JSON body is
        # produced incrementally from the statement cursors — the wire
        # bytes match the reference's one-event shape
        # (json_sse_codec.cc:32-90) while server memory stays bounded
        # for streamable statements (result_cursor.h:35-75). Errors
        # before the event starts emit a `query_error` event
        # (api_servlet.cc:1089-1096).
        from eventql_tpu_torch.utils.stats import evqld_stats

        evqld_stats().num_queries.incr()
        try:
            txn = self.runtime.new_transaction(
                self.query_provider_factory()
            )
            plan = self.runtime.build_query_plan(txn, query)
            # only the FIRST statement executes before the event opens
            # (its errors surface as query_error); later statements
            # run IN ORDER inside the write loop — building every
            # cursor upfront would execute non-streamable statements
            # eagerly before an earlier streamable statement's lazy
            # rows, breaking sequential statement semantics (an INSERT
            # after a SELECT must not be visible to that SELECT)
            first_cur = (
                plan.execute_stream(0) if plan.num_queries else None
            )
        except SQLError as e:
            with self.stats.lock:
                self.stats.num_errors += 1
            sse = self._sse_begin(h)
            sse("query_error", json.dumps({"error": e.message}))
            return

        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.end_headers()
        w = h.wfile.write
        w(b"event: result\ndata: ")
        # JSON separators match json.dumps defaults so the event body
        # is byte-identical to the materialized encoding
        w(b'{"results": [')
        try:
            for k in range(plan.num_queries):
                cur = first_cur if k == 0 else plan.execute_stream(k)
                if k:
                    w(b", ")
                w(b'{"type": "table", "columns": ')
                w(json.dumps(cur.columns).encode())
                w(b', "rows": [')
                first = True
                for row in cur.rows:
                    if not first:
                        w(b", ")
                    first = False
                    w(json.dumps(row).encode())
                w(b"]}")
            w(b"]}\n\n")
            with self.stats.lock:
                self.stats.num_queries += 1
        except SQLError as e:
            # lazy execution failed mid-event: terminate the (now
            # malformed) result event and report the error as its own
            # event so the client sees the failure
            with self.stats.lock:
                self.stats.num_errors += 1
            w(b"\n\n")
            w(b"event: query_error\ndata: ")
            w(json.dumps({"error": e.message}).encode())
            w(b"\n\n")

    @staticmethod
    def _sse_begin(h):
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.end_headers()

        def sse(event: str, data: str):
            h.wfile.write(f"event: {event}\ndata: {data}\n\n".encode())
            h.wfile.flush()

        return sse

    def _alter_target(self):
        provider = self._tables_provider()
        if hasattr(provider, "alter_table"):
            return provider
        return self.table_service

    def _tables_provider(self):
        """Table-management target: in a cluster the provider routes DDL
        and inserts through partition metadata + replication (reference:
        api_servlet's TableService is always the cluster-aware one,
        db/table_service.cc); standalone falls back to the local store."""
        provider = self.query_provider_factory()
        if hasattr(provider, "create_table") and hasattr(
            provider, "insert_json"
        ):
            return provider
        return self.table_service

    def _handle_insert(self, h, payload):
        if not isinstance(payload, list):
            return self._text(h, 400, "expected JSON array")
        svc = self._tables_provider()
        # consecutive same-table runs shred in one native batch pass
        # when inserts land on the local store (cluster providers route
        # per record by partition key)
        batchable = svc is self.table_service and hasattr(
            svc, "insert_json_batch"
        )
        i = 0
        while i < len(payload):
            row = payload[i]
            table = row.get("table")
            if not table:
                raise SQLError("missing field: table")
            data = row.get("data")
            if data is None:
                raise SQLError("missing field: data")
            if batchable and not isinstance(data, str):
                run = [data]
                j = i + 1
                while j < len(payload):
                    nxt = payload[j]
                    if nxt.get("table") != table or isinstance(
                        nxt.get("data"), str
                    ) or nxt.get("data") is None:
                        break
                    run.append(nxt["data"])
                    j += 1
                svc.insert_json_batch(table, json.dumps(run))
                with self.stats.lock:
                    self.stats.num_inserts += len(run)
                i = j
                continue
            if isinstance(data, str):
                svc.insert_json(table, data)
            else:
                svc.insert_json(table, json.dumps(data))
            with self.stats.lock:
                self.stats.num_inserts += 1
            i += 1
        self._json(h, 201, {})

    def _handle_list(self, h):
        tables = [
            {"name": t.table_name}
            for t in self.table_service.list_tables()
        ]
        self._json(h, 200, {"tables": tables})

    def _handle_create(self, h, payload):
        table = payload.get("table") or payload.get("table_name")
        if not table:
            raise SQLError("missing field: table")
        schema = payload.get("schema") or {}
        columns = []
        for col in schema.get("columns", []):
            columns.append(
                ColumnDefinition(
                    col["name"],
                    col.get("type", "STRING"),
                    bool(col.get("repeated", False)),
                    not bool(col.get("optional", True)),
                )
            )
        node = CreateTableNode(
            table,
            columns,
            payload.get("primary_key") or schema.get("primary_key") or [],
            payload.get("partition_key") or schema.get("partition_key"),
            [],
        )
        self._tables_provider().create_table(node)
        self._json(h, 201, {})

    def _handle_add_field(self, h, payload):
        # reference: api_servlet.cc:513-592 addTableField — POST JSON
        # {table, field_name, field_type, repeated?, optional?}
        table = payload.get("table")
        if not table:
            raise SQLError("missing field: table")
        field_name = payload.get("field_name")
        if not field_name:
            raise SQLError("missing field: field_name")
        field_type = payload.get("field_type")
        if not field_type:
            raise SQLError("missing field: field_type")
        from eventql_tpu_torch.plan.nodes import AlterTableNode

        node = AlterTableNode(
            table,
            [
                (
                    AlterTableNode.ADD_COLUMN,
                    ColumnDefinition(
                        field_name,
                        field_type,
                        bool(payload.get("repeated", False)),
                        not bool(payload.get("optional", True)),
                    ),
                )
            ],
        )
        self._tables_provider().alter_table(node)
        self._json(h, 201, {})

    def _handle_remove_field(self, h, payload):
        # reference: api_servlet.cc:595-660 removeTableField
        table = payload.get("table")
        if not table:
            raise SQLError("missing field: table")
        field_name = payload.get("field_name")
        if not field_name:
            raise SQLError("missing field: field_name")
        from eventql_tpu_torch.plan.nodes import AlterTableNode

        node = AlterTableNode(
            table, [(AlterTableNode.DROP_COLUMN, field_name)]
        )
        self._alter_target().alter_table(node)
        self._json(h, 201, {})

    def _handle_drop(self, h, payload):
        table = payload.get("table")
        if not table:
            raise SQLError("missing field: table")
        self._tables_provider().drop_table(table)
        self._json(h, 201, {})

    def _handle_describe(self, h, params, payload):
        table = payload.get("table") or params.get("table")
        if not table:
            raise SQLError("missing field: table")
        info = self.table_service.describe(table)
        if info is None:
            raise SQLError(f"table not found: '{table}'")
        cols = [
            {"column_name": n, "type": sql_typename(t), "is_nullable": True}
            for n, t in info.columns
        ]
        self._json(h, 200, {"table": {"name": table, "columns": cols}})
