"""The port's serving tier against the JAX package's.

The native binary protocol (server/native_tcp.py), the HTTP API
(server/http_api.py), the one-port listener (server/listener.py), client
auth (server/auth.py) and the connection pool (parallel/conn_pool.py)
are copies of the JAX package's modules, the servers with their routes
on an explicit device. Every case below runs through both packages on
the same data and must give the same observations (tolerance 0): the
JAX package's own serving tests (test_native_tcp.py, test_http_api.py,
test_listener.py, test_auth.py, test_conn_pool.py,
test_concurrent_serving.py) and the wire across the packages in both
directions. The port's servers run with device="cpu", where every route
takes its kernels' plain versions.
"""

import json
import re
import socket
import struct
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import eventql_tpu.core.errors as jax_errors
import eventql_tpu.core.types as jax_types
import eventql_tpu.db.table_service as jax_table_service
import eventql_tpu.exec.relation as jax_relation
import eventql_tpu.exec.runtime as jax_runtime
import eventql_tpu.parallel.cluster as jax_cluster
import eventql_tpu.parallel.conn_pool as jax_conn_pool
import eventql_tpu.plan.nodes as jax_nodes
import eventql_tpu.server.auth as jax_auth
import eventql_tpu.server.http_api as jax_http_api
import eventql_tpu.server.listener as jax_listener
import eventql_tpu.server.native_tcp as jax_native_tcp
import eventql_tpu_torch.core.errors as port_errors
import eventql_tpu_torch.core.types as port_types
import eventql_tpu_torch.db.table_service as port_table_service
import eventql_tpu_torch.exec.relation as port_relation
import eventql_tpu_torch.exec.runtime as port_runtime
import eventql_tpu_torch.parallel.cluster as port_cluster
import eventql_tpu_torch.parallel.conn_pool as port_conn_pool
import eventql_tpu_torch.plan.nodes as port_nodes
import eventql_tpu_torch.server.auth as port_auth
import eventql_tpu_torch.server.http_api as port_http_api
import eventql_tpu_torch.server.listener as port_listener
import eventql_tpu_torch.server.native_tcp as port_native_tcp
from eventql_tpu_torch.exec import device_exec

JAX = SimpleNamespace(
    name="jax", errors=jax_errors, types=jax_types, table_service=jax_table_service,
    relation=jax_relation, nodes=jax_nodes, runtime=jax_runtime, cluster=jax_cluster, conn_pool=jax_conn_pool,
    auth=jax_auth, http_api=jax_http_api, listener=jax_listener,
    nt=jax_native_tcp, device={},
)
PORT = SimpleNamespace(
    name="port", errors=port_errors, types=port_types, table_service=port_table_service,
    relation=port_relation, nodes=port_nodes, runtime=port_runtime, cluster=port_cluster, conn_pool=port_conn_pool,
    auth=port_auth, http_api=port_http_api, listener=port_listener,
    nt=port_native_tcp, device={"device": "cpu"},
)


def _both(case, *args):
    """The case's observation through the JAX package, equal to the
    port's; returns it."""
    want = case(JAX, *args)
    got = case(PORT, *args)
    assert got == want
    return got


def _native(pkg, svc=None, **kw):
    svc = svc if svc is not None else pkg.table_service.TableService()
    return pkg.nt.NativeTCPServer(svc, port=0, **pkg.device, **kw).start()


# one native and one HTTP server a package, shared by the cases that need
# no server of their own (a server takes half a second to stop); each
# case names its own tables
_SHARED = {}


@pytest.fixture(scope="module", autouse=True)
def _shared_servers():
    yield
    for server in _SHARED.values():
        server.stop()
    _SHARED.clear()


def _shared(pkg, kind):
    key = (pkg.name, kind)
    if key not in _SHARED:
        if kind == "native":
            _SHARED[key] = _native(pkg)
        else:
            _SHARED[key] = pkg.http_api.EventQLServer(port=0, **pkg.device).start()
    return _SHARED[key]


def _client(pkg, server, **kw):
    return pkg.nt.NativeTCPClient("127.0.0.1", server.port, **kw)


def _runtime(pkg):
    return pkg.runtime.Runtime(**pkg.device)


# -- native protocol (test_native_tcp.py) ------------------------------------


def _serve(pkg, fn, **kw):
    """fn(client) on the shared server, or on a server of its own when
    ``kw`` configures one."""
    server = _native(pkg, **kw) if kw else _shared(pkg, "native")
    try:
        c = _client(pkg, server)
        try:
            return fn(c)
        finally:
            c.close()
    finally:
        if kw:
            server.stop()


def test_handshake_and_ping():
    assert _both(lambda pkg: _serve(pkg, lambda c: c.ping())) is True


def test_query_roundtrip():
    got = _both(lambda pkg: _serve(pkg, lambda c: c.query("select 1 + 1 as two;")))
    assert got == [(["two"], [["2"]])]


def test_multi_statement_query():
    got = _both(lambda pkg: _serve(pkg, lambda c: c.query("select 1 as a; select 2 as b;")))
    assert got == [(["a"], [["1"]]), (["b"], [["2"]])]


def test_query_error():
    def case(pkg):
        def run(c):
            with pytest.raises(pkg.errors.SQLError) as e:
                c.query("select ;")
            return str(e.value)

        return _serve(pkg, run)

    assert "unexpected token T_SEMICOLON" in _both(case)


def test_insert_and_query():
    def run(c):
        c.query("CREATE TABLE ins (t uint64, v uint64, PRIMARY KEY (t));")
        c.insert_json("ins", ['{"t": 1, "v": 10}', '{"t": 2, "v": 32}'])
        return c.query("select sum(v) from ins;")

    assert _both(lambda pkg: _serve(pkg, run))[0][1] == [["42"]]


def test_heartbeats_during_slow_query():
    """HEARTBEAT frames flow while a query executes."""
    def case(pkg):
        class SlowService(pkg.table_service.TableService):
            def get_table_data(self, table_name):
                time.sleep(0.35)
                return super().get_table_data(table_name)

        nt = pkg.nt
        server = nt.NativeTCPServer(SlowService(), port=0, **pkg.device)
        server.HEARTBEAT_INTERVAL = 0.1
        server.start()
        try:
            c = _client(pkg, server)
            c.query("CREATE TABLE ev (t uint64, PRIMARY KEY (t));")
            c.insert_json("ev", ['{"t": 1}'])
            payload = (nt.write_lenencstr(b"select count(1) from ev;")
                       + nt.write_varint(0) + nt.write_varint(0))
            nt._send_frame(c.sock, nt.OP_QUERY, 0, payload)
            heartbeats = 0
            while True:
                opcode, _flags, _body = nt._recv_frame(c.sock)
                if opcode == nt.OP_HEARTBEAT:
                    heartbeats += 1
                    continue
                break
            c.close()
            return opcode == nt.OP_QUERY_RESULT, heartbeats >= 2
        finally:
            server.stop()

    assert _both(case) == (True, True)


def test_query_progress_frames():
    def case(pkg):
        svc = pkg.table_service.TableService()
        server = pkg.nt.NativeTCPServer(svc, port=0, **pkg.device)
        server.HEARTBEAT_INTERVAL = 0.02
        server.start()
        rt = _runtime(pkg)
        txn = rt.new_transaction(svc)

        class SlowPlan:
            num_queries = 1

            def execute(self, i):
                time.sleep(0.2)
                return rt.build_query_plan(txn, "select 42 as v;").execute(0)

            execute_stream = execute

        try:
            c = _client(pkg, server)
            seen = []
            server.runtime.build_query_plan = lambda txn, q: SlowPlan()
            results = c.query("select 42 as v;", on_progress=seen.append)
            c.close()
            return (results, len(seen) >= 1,
                    all(0 <= p["progress_permill"] <= 1000 for p in seen),
                    seen[-1]["elapsed_ms"] >= 0)
        finally:
            server.stop()

    assert _both(case) == ([(["v"], [["42"]])], True, True, True)


def _paging_client(pkg, nrows):
    """A client of the shared server, which holds the table pg<nrows>."""
    c = _client(pkg, _shared(pkg, "native"))
    if not any(r[0] == f"pg{nrows}" for r in c.query("show tables;")[0][1]):
        c.query(f"CREATE TABLE pg{nrows} (t uint64, v uint64, PRIMARY KEY (t));")
        c.insert_json(f"pg{nrows}", ['{"t": %d, "v": %d}' % (i, i * 2) for i in range(nrows)])
    return c


def test_query_result_pagination_frames():
    """maxrows=5: pages of 6 rows, QUERY_CONTINUE between them, only the
    last frame COMPLETE with ENDOFREQUEST."""
    def case(pkg):
        nt = pkg.nt
        c = _paging_client(pkg, 23)
        payload = (nt.write_lenencstr(b"select t, v from pg23 order by t;")
                   + nt.write_varint(0) + nt.write_varint(5))
        nt._send_frame(c.sock, nt.OP_QUERY, 0, payload)
        pages = []
        while True:
            opcode, flags, body = nt._recv_frame(c.sock)
            if opcode == nt.OP_HEARTBEAT:
                continue
            qf, pos = nt.read_varint(body, 0)
            ncols, pos = nt.read_varint(body, pos)
            nrows, pos = nt.read_varint(body, pos)
            pages.append((opcode, qf, flags, ncols, nrows))
            if qf & nt.QR_COMPLETE:
                break
            nt._send_frame(c.sock, nt.OP_QUERY_CONTINUE, 0, b"")
        after = c.query("select 7 as x;")
        c.close()
        return pages, after

    pages, after = _both(case)
    nt = PORT.nt
    assert [p[4] for p in pages] == [6, 6, 6, 5]
    assert all(p[0] == nt.OP_QUERY_RESULT and p[3] == 2 for p in pages)
    assert all(p[1] & nt.QR_HASCOLNAMES and p[1] & nt.QR_HASSTATS for p in pages)
    assert all(not p[1] & nt.QR_COMPLETE and not p[2] & nt.F_ENDOFREQUEST
               for p in pages[:-1])
    assert pages[-1][1] & nt.QR_COMPLETE and pages[-1][2] & nt.F_ENDOFREQUEST
    assert after[0][1] == [["7"]]


def test_query_result_discard_mid_result():
    def case(pkg):
        nt = pkg.nt
        c = _paging_client(pkg, 23)
        payload = (nt.write_lenencstr(b"select t from pg23 order by t;")
                   + nt.write_varint(0) + nt.write_varint(5))
        nt._send_frame(c.sock, nt.OP_QUERY, 0, payload)

        def frame():
            opcode, _flags, body = nt._recv_frame(c.sock)
            while opcode == nt.OP_HEARTBEAT:
                opcode, _flags, body = nt._recv_frame(c.sock)
            qf, pos = nt.read_varint(body, 0)
            _ncols, pos = nt.read_varint(body, pos)
            nrows, pos = nt.read_varint(body, pos)
            return opcode, bool(qf & nt.QR_COMPLETE), nrows

        first = frame()
        nt._send_frame(c.sock, nt.OP_QUERY_DISCARD, 0, b"")
        last = frame()
        after = c.query("select 9 as x;")
        c.close()
        return first, last, after

    first, last, after = _both(case)
    assert first == (PORT.nt.OP_QUERY_RESULT, False, 6)
    assert last == (PORT.nt.OP_QUERY_RESULT, True, 0)
    assert after[0][1] == [["9"]]


def test_query_client_batch_size_roundtrip():
    def case(pkg):
        c = _paging_client(pkg, 57)
        one = c.query("select t, v from pg57 order by t;", batch_size=7)
        two = c.query("select count(1) as n from pg57; select t from pg57 order by t;",
                      batch_size=3)
        c.close()
        return one, two

    one, two = _both(case)
    assert one == [(["t", "v"], [[str(i), str(i * 2)] for i in range(57)])]
    assert two[0][1] == [["57"]] and [r[0] for r in two[1][1]] == [str(i) for i in range(57)]


def test_recv_frame_rejects_oversized():
    def case(pkg):
        s = socket.create_connection(("127.0.0.1", _shared(pkg, "native").port))
        s.sendall(struct.pack(">HHI", pkg.nt.OP_HELLO, 0, 300 * 1024 * 1024))
        s.sendall(b"x" * 1024)
        s.settimeout(5.0)
        try:
            data = s.recv(4096)
        except OSError:
            data = b""
        s.close()
        return data

    assert _both(case) == b""


_U64 = [(1 << 63) + 5, (1 << 63) + 7, (1 << 64) - 1, 3, 1 << 62]


def test_u64_sums_of_2_63_and_more_on_both_protocols():
    """A sum at or above 2^63 (mod 2^64, as the reference's uint64
    arithmetic wraps) leaves both servers as the same unsigned decimal,
    over the native protocol and over HTTP; on the port the route
    serves it (the bit patterns it carries as int64 stay unsigned on the
    wire)."""
    def case(pkg):
        svc = pkg.table_service.TableService()
        server = _native(pkg, svc)
        http = pkg.http_api.EventQLServer(svc, port=0, **pkg.device).start()
        try:
            c = _client(pkg, server)
            c.query("CREATE TABLE u (id uint64, k uint64, v uint64, PRIMARY KEY (id));")
            c.insert_json("u", ['{"id": %d, "k": %d, "v": %d}' % (i, i % 2, v)
                                for i, v in enumerate(_U64)])
            sql = "select k, count(1), sum(v), max(v) from u group by k order by k;"
            before = device_exec.FUSED_GROUPBY_COUNT + device_exec.GENERAL_GROUPBY_COUNT
            native = c.query(sql)
            routed = device_exec.FUSED_GROUPBY_COUNT + device_exec.GENERAL_GROUPBY_COUNT - before
            c.close()
            status, out = _http(http, "/api/v1/sql", {"query": sql})
            return native, status, out, routed
        finally:
            http.stop()
            server.stop()

    want = [[str(k), str(len(_U64[k::2])), str(sum(_U64[k::2]) % (1 << 64)),
             str(max(_U64[k::2]))] for k in (0, 1)]
    assert int(want[0][2]) >= 1 << 63
    jax_native, jax_status, jax_out, _ = case(JAX)
    native, status, out, routed = case(PORT)
    assert native == jax_native and native[0][1] == want
    assert (status, out) == (jax_status, jax_out) and out["results"][0]["rows"] == want
    assert routed == 1


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_the_wire_across_the_packages(direction):
    """One package's client against the other's server: handshake,
    DDL, insert, a paged result, a multi-statement query, an error that
    leaves the connection usable, ping."""
    server_pkg, client_pkg = (PORT, JAX) if direction.startswith("jax") else (JAX, PORT)
    server = _native(server_pkg)
    try:
        c = _client(client_pkg, server)
        c.query("CREATE TABLE ev (t uint64, k string, v uint64, PRIMARY KEY (t));")
        c.insert_json("ev", ['{"t": %d, "k": "k%d", "v": %d}' % (i, i % 3, i * 7)
                             for i in range(40)])
        rows = c.query("select t, v from ev order by t;", batch_size=6)
        assert rows == [(["t", "v"], [[str(i), str(i * 7)] for i in range(40)])]
        got = c.query("select k, count(1), sum(v) from ev group by k order by k;"
                      " select 5 as x;")
        assert got == [(["k", "count(1)", "sum(v)"],
                        [[f"k{g}", str(len(range(g, 40, 3))),
                          str(sum(i * 7 for i in range(g, 40, 3)))] for g in range(3)]),
                       (["x"], [["5"]])]
        with pytest.raises(client_pkg.errors.SQLError, match="unexpected token"):
            c.query("select ;")
        assert c.ping() and c.query("select 1 as y;") == [(["y"], [["1"]])]
        c.close()
    finally:
        server.stop()


def test_metadata_ops_answer_as_a_server_without_a_metadata_service():
    def case(pkg):
        def run(c):
            with pytest.raises(pkg.errors.SQLError) as e:
                c.meta_request(pkg.nt.OP_META_GETFILE,
                               {"db": "d", "table": "t", "txnid": "x"})
            return str(e.value), c.ping()

        return _serve(pkg, run)

    assert _both(case) == ("no metadata service on this server", True)


# -- HTTP API (test_http_api.py) ---------------------------------------------


def _http(server, path, payload=None):
    url = f"http://127.0.0.1:{server.port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body)
        except json.JSONDecodeError:
            return e.code, {"raw": body.decode()}


def _with_http(pkg, fn, **kw):
    """fn(server) on the shared HTTP server, or on one of its own when
    ``kw`` configures one."""
    if not kw:
        return fn(_shared(pkg, "http"))
    server = pkg.http_api.EventQLServer(port=0, **pkg.device, **kw).start()
    try:
        return fn(server)
    finally:
        server.stop()


def test_http_sql_roundtrip():
    got = _both(lambda pkg: _with_http(
        pkg, lambda s: _http(s, "/api/v1/sql", {"query": "select 1 + 2 as three;"})))
    assert got == (200, {"results": [{"type": "table", "columns": ["three"],
                                      "rows": [["3"]]}]})


def test_http_sql_get_param():
    got = _both(lambda pkg: _with_http(pkg, lambda s: _http(s, "/api/v1/sql?query=select%2042;")))
    assert got[0] == 200 and got[1]["results"][0]["rows"] == [["42"]]


def test_http_sql_error():
    got = _both(lambda pkg: _with_http(pkg, lambda s: _http(s, "/api/v1/sql", {"query": "select ;"})))
    assert got == (500, {"error": "unexpected token T_SEMICOLON, expected: value expression"})


def _table_lifecycle(s):
    out = [_http(s, "/api/v1/tables/create", {
        "table": "events",
        "schema": {"columns": [{"name": "time", "type": "DATETIME"},
                               {"name": "value", "type": "UINT64"},
                               {"name": "label", "type": "STRING"}]},
        "primary_key": ["time"]})]
    out.append(_http(s, "/api/v1/tables/list", {}))
    out.append(_http(s, "/api/v1/tables/insert", [
        {"table": "events", "data": {"time": 1, "value": 10, "label": "a"}},
        {"table": "events", "data": {"time": 2, "value": 32, "label": "a"}}]))
    out.append(_http(s, "/api/v1/sql",
                     {"query": "select label, sum(value) from events group by label;"}))
    out.append(_http(s, "/api/v1/tables/describe?table=events"))
    out.append(_http(s, "/api/v1/tables/drop", {"table": "events"}))
    out.append(_http(s, "/api/v1/tables/list", {}))
    return out


def test_http_table_lifecycle():
    out = _both(lambda pkg: _with_http(pkg, _table_lifecycle))
    assert [o[0] for o in out] == [201, 200, 201, 200, 200, 201, 200]
    assert {"name": "events"} in out[1][1]["tables"]
    assert out[3][1]["results"][0]["rows"] == [["a", "42"]]
    assert [c["column_name"] for c in out[4][1]["table"]["columns"]] == ["time", "value", "label"]
    assert out[6][1]["tables"] == []


def test_http_stats():
    def case(pkg):
        def run(s):
            _http(s, "/api/v1/sql", {"query": "select 1;"})
            status, out = _http(s, "/eventql/stats")
            return status, out["num_queries"] >= 1

        return _with_http(pkg, run)

    assert _both(case) == (200, True)


def _sse(s, query):
    url = (f"http://127.0.0.1:{s.port}/api/v1/sql?format=json_sse&query="
           + urllib.parse.quote(query))
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode()


def test_http_sql_json_sse_stream():
    status, ctype, body = _both(lambda pkg: _with_http(
        pkg, lambda s: _sse(s, "select 1 + 2 as three;")))
    assert (status, ctype) == (200, "text/event-stream")
    frames = [f for f in body.split("\n\n") if f.strip()]
    lines = frames[0].split("\n")
    assert len(frames) == 1 and lines[0] == "event: result"
    data = "\n".join(l[len("data: "):] for l in lines[1:] if l.startswith("data: "))
    assert json.loads(data)["results"][0]["rows"] == [["3"]]


def test_http_status_dashboard():
    """The status pages name each package's own server (a server of its
    own: the page counts the tables)."""
    def case(pkg):
        def run(s):
            _http(s, "/api/v1/tables/create", {
                "table": "dash", "schema": {"columns": [{"name": "a", "type": "UINT64"}]}})
            with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/eventql/", timeout=30) as r:
                ctype, body = r.headers["Content-Type"], r.read().decode()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{s.port}/eventql/db/default/dash", timeout=30) as r:
                drill = r.read().decode()
            return (ctype.startswith("text/html"), f"eventql_tpu{'_torch' * (pkg is PORT)}"
                    " v0.1" in body, "Number of Tables: 1" in body, "dash: a UINT64" in drill)

        return _with_http(pkg, run, table_service=pkg.table_service.TableService())

    assert _both(case) == (True, True, True, True)


def _http_raw(server, path, body):
    """(status, content type, body bytes) of a POST of ``body`` (bytes;
    None: a GET)."""
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _mr_table(s, table):
    _http(s, "/api/v1/tables/create", {"table": table, "schema": {"columns": [
        {"name": "k", "type": "STRING"}, {"name": "v", "type": "UINT64"}]}})
    _http(s, "/api/v1/tables/insert", [
        {"table": table, "data": {"k": k, "v": v}}
        for k, v in (("x", 1), ("x", 2), ("y", 5), ("z", 7), ("y", 11))])


_MR_MAP = "lambda row: [(row['k'], str(row['v']))]"
_MR_REDUCE = "lambda k, vs: [(k, str(sum(int(v) for v in vs)))]"
_MR_JS = """
EVQL.log("mapping");
var m = EVQL.mapTable({table: "TABLE", map_fn: function(row) {
    return [[row.k, parseInt(row.v, 10)]]; }});
var r = EVQL.reduce({sources: [m], shards: 1, reduce_fn: function(key, values) {
    var s = 0;
    while (values.hasNext()) { s += parseInt(values.next(), 10); }
    return [[key, s]];
}});
EVQL.downloadResults([r]);
"""


def _map_partition(s, table, **extra):
    body = urllib.parse.urlencode({"table": table, "partition": "p0",
                                   "map_function": _MR_MAP, **extra}).encode()
    return _http_raw(s, "/api/v1/mapreduce/tasks/map_partition", body)


def _result_of(s, table, query=""):
    _status, _ctype, sse = _map_partition(s, table)
    rid = sse.decode().split("data: ")[1].split("\n")[0]
    return _http_raw(s, f"/api/v1/mapreduce/result/{rid}{query}", None)


# each case: (needs a table, fn(server, table) -> observation)
MAPREDUCE_ROUTES = {
    "execute_json_job": lambda s, t: _http_raw(s, "/api/v1/mapreduce/execute", json.dumps({
        "jobs": {"m": {"op": "map_table", "table": t, "map_fn": _MR_MAP},
                 "r": {"op": "reduce", "sources": ["m"], "reduce_fn": _MR_REDUCE},
                 "out": {"op": "return_results", "sources": ["r"]}},
        "execute": ["out"]}).encode()),
    "execute_js_program": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/execute", _MR_JS.replace("TABLE", t).encode()),
    "execute_empty_program": lambda s, t: _http_raw(s, "/api/v1/mapreduce/execute", b" "),
    "execute_js_error": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/execute", b"EVQL.mapTable({table: 'nope'}); x.y;"),
    "map_partition": lambda s, t: _map_partition(s, t),
    "map_partition_cache_miss": lambda s, t: _map_partition(s, t, cache_only="true",
                                                            map_function="lambda r: []"),
    "map_partition_missing_parameter": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/tasks/map_partition", b"table=t"),
    "map_partition_unknown_table": lambda s, t: _map_partition(s, "no_such_table"),
    "reduce_missing_parameter": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/tasks/reduce", b"input_table=x"),
    "reduce_without_inputs": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/tasks/reduce",
        urllib.parse.urlencode({"reduce_fn": _MR_REDUCE}).encode()),
    "save_to_table_missing_parameter": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/tasks/save_to_table", b"result_id=abc"),
    "save_to_table_unknown_result": lambda s, t: _http_raw(
        s, "/api/v1/mapreduce/tasks/save_to_table", b"result_id=abc&table_name=out"),
    "result_unknown_id": lambda s, t: _http_raw(s, "/api/v1/mapreduce/result/abc", None),
    "result_frames": lambda s, t: _result_of(s, t),
    "result_sample": lambda s, t: _result_of(s, t, "?sample=2:1"),
    "result_bad_sample": lambda s, t: _result_of(s, t, "?sample=2"),
}


@pytest.mark.parametrize("case", list(MAPREDUCE_ROUTES))
def test_http_mapreduce_routes_answer_as_the_jax_server(case):
    """Every /api/v1/mapreduce/* route (a job spec or a JavaScript program
    to execute, the map_partition / reduce / save_to_table task RPCs, the
    result stream) answers with the JAX server's status, content type and
    body, byte for byte but for a map result's id (a hash that takes in
    the process's boot epoch)."""
    def run(pkg):
        def on(s):
            table = f"mr_{case}"
            _mr_table(s, table)
            status, ctype, body = MAPREDUCE_ROUTES[case](s, table)
            return status, ctype, re.sub(rb"\b[0-9a-f]{40}\b", b"<result id>", body)
        return _with_http(pkg, on)

    got = _both(run)
    assert b"not ported" not in got[2]


def test_http_add_and_remove_field():
    def run(s):
        _http(s, "/api/v1/tables/create", {
            "table": "alt", "schema": {"columns": [{"name": "k", "type": "STRING"}]}})
        out = [_http(s, "/api/v1/tables/add_field",
                     {"table": "alt", "field_name": "extra", "field_type": "UINT64"})[0]]
        out.append([c["column_name"] for c in _http(
            s, "/api/v1/tables/describe?table=alt", {})[1]["table"]["columns"]])
        out.append(_http(s, "/api/v1/tables/remove_field",
                         {"table": "alt", "field_name": "extra"})[0])
        out.append([c["column_name"] for c in _http(
            s, "/api/v1/tables/describe?table=alt", {})[1]["table"]["columns"]])
        out.append(_http(s, "/api/v1/tables/add_field", {"table": "alt", "field_name": "x"}))
        return out

    out = _both(lambda pkg: _with_http(pkg, run))
    assert out[:4] == [201, ["k", "extra"], 201, ["k"]]
    assert out[4][0] == 500 and "field_type" in out[4][1]["error"]


def test_http_sql_json_sse_sequential_statement_semantics():
    def run(s):
        _http(s, "/api/v1/tables/create", {"table": "sseq", "schema": {"columns": [
            {"name": "id", "type": "UINT64"}, {"name": "v", "type": "UINT64"}]}})
        _http(s, "/api/v1/tables/insert", [{"table": "sseq", "data": {"id": 1, "v": 10}},
                                           {"table": "sseq", "data": {"id": 2, "v": 20}}])
        _status, _ctype, body = _sse(s, "select count(1) from sseq;"
                                     " insert into sseq (id, v) values (3, 30);"
                                     " select count(1) from sseq;")
        lines = [f for f in body.split("\n\n") if f.strip()][0].split("\n")
        return json.loads("\n".join(l[len("data: "):] for l in lines[1:]
                                    if l.startswith("data: ")))

    out = _both(lambda pkg: _with_http(pkg, run))
    assert out["results"][0]["rows"] == [["2"]] and out["results"][2]["rows"] == [["3"]]


# -- one port, both protocols (test_listener.py) -------------------------------


def _with_listener(pkg, fn):
    svc = pkg.table_service.TableService()
    http = pkg.http_api.EventQLServer(table_service=svc, **pkg.device).start(bind=False)
    native = pkg.nt.NativeTCPServer(svc, **pkg.device)  # not started: handler reused
    lis = pkg.listener.Listener(http, native, port=0).start()
    try:
        return fn(pkg, lis)
    finally:
        lis.stop()
        http.stop()


def test_listener_native_on_shared_port():
    def run(pkg, lis):
        c = pkg.nt.NativeTCPClient("127.0.0.1", lis.port)
        out = c.query("select 40 + 2 as x;")
        c.close()
        return out

    assert _both(lambda pkg: _with_listener(pkg, run)) == [(["x"], [["42"]])]


def test_listener_http_on_shared_port():
    got = _both(lambda pkg: _with_listener(
        pkg, lambda pkg, lis: _http(lis, "/api/v1/sql", {"query": "select 7 as x;"})))
    assert got[1]["results"][0]["rows"] == [["7"]]


def test_listener_both_protocols_share_state():
    def run(pkg, lis):
        c = pkg.nt.NativeTCPClient("127.0.0.1", lis.port)
        c.query("CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));")
        c.insert_json("ev", ['{"t": 1, "v": 41}'])
        c.close()
        return _http(lis, "/api/v1/sql", {"query": "select sum(v) + 1 from ev;"})

    assert _both(lambda pkg: _with_listener(pkg, run))[1]["results"][0]["rows"] == [["42"]]


# -- client auth (test_auth.py) --------------------------------------------------


def test_secure_cookie_roundtrip_across_the_packages():
    """A cookie either package signs, the other verifies; tampering and
    a wrong key are refused by both."""
    for signer, verifier in ((JAX, PORT), (PORT, JAX)):
        token = signer.auth.SecureCookieCoder("s3cret").encode(b"hello world", created_us=10**15)
        assert token == JAX.auth.SecureCookieCoder("s3cret").encode(
            b"hello world", created_us=10**15)
        coder = verifier.auth.SecureCookieCoder("s3cret", expire_after_days=1e9)
        assert coder.decode_and_verify(token) == b"hello world"
        bad = token[:-1] + ("0" if token[-1] != "0" else "1")
        assert coder.decode_and_verify(bad) is None
        assert verifier.auth.SecureCookieCoder("other").decode_and_verify(token) is None


def test_secure_cookie_expiry():
    assert _both(lambda pkg: pkg.auth.SecureCookieCoder("k", expire_after_days=1)
                 .decode_and_verify(pkg.auth.SecureCookieCoder("k").encode(
                     b"x", created_us=1))) is None


def test_token_data_protobuf():
    blob = _both(lambda pkg: pkg.auth.encode_token_data("mydb", "alice"))
    assert _both(lambda pkg: pkg.auth.decode_token_data(blob)) == ("mydb", "alice")


def test_legacy_auth_sessions():
    def case(pkg):
        auth = pkg.auth.LegacyClientAuth("topsecret")
        sess = auth.authenticate({"auth_token": auth.make_token("proddb", "bob")})
        errors = []
        for data in ({}, {"auth_token": "garbage|1|PLAIN||00"}):
            with pytest.raises(pkg.auth.AuthError) as e:
                auth.authenticate(data)
            errors.append(str(e.value))
        return sess.effective_namespace, sess.user_id, errors

    assert _both(case) == ("proddb", "bob", ["missing auth token", "invalid auth token"])


def test_native_server_rejects_bad_token():
    """The port's server takes the JAX package's tokens, and refuses a
    missing or forged one with the same message."""
    def case(pkg):
        auth = pkg.auth.LegacyClientAuth("topsecret")
        server = _native(pkg, client_auth=auth)
        try:
            token = JAX.auth.LegacyClientAuth("topsecret").make_token("db", "u")
            c = _client(pkg, server, auth_token=token)
            out = [c.query("select 1 as x;")]
            c.close()
            for kw in ({}, {"auth_token": "a|1|PLAIN||beef"}):
                with pytest.raises(pkg.errors.SQLError) as e:
                    _client(pkg, server, **kw)
                out.append(str(e.value))
            return out
        finally:
            server.stop()

    assert _both(case) == [[(["x"], [["1"]])], "missing auth token", "invalid auth token"]


def test_trust_auth_default():
    assert _both(lambda pkg: _serve(pkg, lambda c: c.ping())) is True


def test_http_auth_token():
    def case(pkg):
        auth = pkg.auth.LegacyClientAuth("websecret")

        def run(s):
            url = f"http://127.0.0.1:{s.port}/api/v1/sql"
            body = json.dumps({"query": "select 2 + 2 as four;"}).encode()
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=10)
            token = auth.make_token("db", "u")
            req = urllib.request.Request(url, data=body,
                                         headers={"Authorization": f"Token {token}"})
            return e.value.code, json.loads(urllib.request.urlopen(req, timeout=10).read())

        return _with_http(pkg, run, client_auth=auth)

    code, out = _both(case)
    assert code == 401 and out["results"][0]["rows"] == [["4"]]


# -- connection pool (test_conn_pool.py) -----------------------------------------


class FakeConn:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_checkout_checkin_roundtrip():
    def case(pkg):
        pool = pkg.conn_pool.TCPConnectionPool()
        first = pool.checkout(("h", 1))
        c = FakeConn()
        pool.checkin(("h", 1), c)
        return first, pool.checkout(("h", 1)) is c, pool.checkout(("h", 1))

    assert _both(case) == (None, True, None)


def test_linger_eviction():
    def case(pkg):
        pool = pkg.conn_pool.TCPConnectionPool(linger_timeout=0.05)
        c = FakeConn()
        pool.checkin(("h", 1), c)
        time.sleep(0.08)
        return pool.checkout(("h", 1)), c.closed

    assert _both(case) == (None, True)


def test_per_host_cap_evicts_oldest():
    def case(pkg):
        pool = pkg.conn_pool.TCPConnectionPool(max_conns_per_host=2)
        cs = [FakeConn() for _ in range(3)]
        for c in cs:
            pool.checkin(("h", 1), c)
        return ([c.closed for c in cs], pool.checkout(("h", 1)) is cs[2],
                pool.checkout(("h", 1)) is cs[1])

    assert _both(case) == ([True, False, False], True, True)


def test_global_cap_drops_surplus():
    def case(pkg):
        pool = pkg.conn_pool.TCPConnectionPool(max_conns=1)
        c1, c2 = FakeConn(), FakeConn()
        pool.checkin(("a", 1), c1)
        pool.checkin(("b", 2), c2)
        return c1.closed, c2.closed

    assert _both(case) == (False, True)


def test_pooled_call_reuses_socket():
    def case(pkg):
        server = _native(pkg)
        try:
            pool = pkg.conn_pool.TCPConnectionPool()
            addr = ("127.0.0.1", server.port)
            r1 = pool.call(addr, lambda c: c.query("select 1 as a;"))
            misses = pool.stats_misses
            r2 = pool.call(addr, lambda c: c.query("select 2 as b;"))
            pool.close()
            return r1, r2, misses, pool.stats_hits
        finally:
            server.stop()

    assert _both(case) == ([(["a"], [["1"]])], [(["b"], [["2"]])], 1, 1)


def test_pooled_call_retries_dead_socket():
    def case(pkg):
        server = _native(pkg)
        try:
            pool = pkg.conn_pool.TCPConnectionPool()
            addr = ("127.0.0.1", server.port)
            pool.call(addr, lambda c: c.query("select 1 as a;"))
            pool._conns[addr][0][1].sock.close()
            out = pool.call(addr, lambda c: c.query("select 3 as c;"))
            pool.close()
            return out
        finally:
            server.stop()

    assert _both(case) == [(["c"], [["3"]])]


def test_pooled_call_keeps_connection_after_sql_error():
    def case(pkg):
        server = _native(pkg)
        try:
            pool = pkg.conn_pool.TCPConnectionPool()
            addr = ("127.0.0.1", server.port)
            with pytest.raises(pkg.errors.SQLError):
                pool.call(addr, lambda c: c.query("select ;"))
            out = pool.call(addr, lambda c: c.query("select 4 as d;"))
            pool.close()
            return out, pool.stats_hits
        finally:
            server.stop()

    assert _both(case) == ([(["d"], [["4"]])], 1)


def test_cluster_provider_shares_pool_across_instances(monkeypatch):
    def case(pkg):
        server = _native(pkg)
        monkeypatch.setattr(pkg.conn_pool, "_GLOBAL_POOL", pkg.conn_pool.TCPConnectionPool())
        try:
            addr = ("127.0.0.1", server.port)
            pkg.cluster.ClusterTableProvider([addr])._query(addr, "select 1 as x;")
            pkg.cluster.ClusterTableProvider([addr])._query(addr, "select 2 as y;")
            pool = pkg.conn_pool.global_pool()
            return pool.stats_misses, pool.stats_hits
        finally:
            pkg.conn_pool._GLOBAL_POOL.close()
            server.stop()

    assert _both(case) == (1, 1)


# -- concurrent serving (test_concurrent_serving.py) ------------------------------


def _service(pkg, n, seed=3):
    """A table of n rows (k < 53, v < 1000) inserted as one batch."""
    rng = np.random.default_rng(seed)
    svc = pkg.table_service.TableService()
    svc.create_table(pkg.nodes.CreateTableNode(
        "ev", [pkg.nodes.ColumnDefinition("k", "UINT64"),
               pkg.nodes.ColumnDefinition("v", "UINT64")], [], None, []))
    C, u64, ones = pkg.relation.Column, pkg.types.SType.UINT64, np.ones(n, bool)
    svc.tables["ev"].insert_batch(pkg.relation.Relation(
        ["k", "v"],
        [C(u64, rng.integers(0, 53, n).astype(np.uint64), ones),
         C(u64, rng.integers(0, 1000, n).astype(np.uint64), ones)], n))
    return svc


QUERY = "select k, count(1), sum(v) from ev group by k order by k;"


def _clients(port, queries, n_clients, per_client, pkg=PORT):
    results = [None] * n_clients
    errors = []

    def one(i):
        try:
            c = pkg.nt.NativeTCPClient("127.0.0.1", port)
            try:
                results[i] = [c.query(queries[(i + j) % len(queries)], batch_size=100)
                              for j in range(per_client)]
            finally:
                c.close()
        except Exception as e:  # surfaced in the main thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return results


def test_concurrent_first_queries_on_the_route():
    """8 clients race the first GROUP BY of a fresh server (the column
    cache empty) with the interpreter switching threads every few
    microseconds: every answer equals the JAX server's, and the route
    served every one of them."""
    want = _serve(JAX, lambda c: c.query(QUERY), svc=_service(JAX, 20000))
    server = _native(PORT, _service(PORT, 20000))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        before = device_exec.FUSED_GROUPBY_COUNT
        outs = _clients(server.port, [QUERY], 8, 3)
    finally:
        sys.setswitchinterval(interval)
        server.stop()
    assert all(res == want for out in outs for res in out)
    assert device_exec.FUSED_GROUPBY_COUNT - before > 0


def test_concurrent_mixed_routes_parity():
    """8 clients x mixed statements (route GROUP BY, streamed SELECT,
    LIMIT, count) against one server: every client sees the JAX
    server's single-client answer."""
    queries = [QUERY, "select k, v from ev limit 40;",
               "select v from ev where k = 7 limit 10;", "select count(1) from ev;"]
    jax_server = _native(JAX, _service(JAX, 5000))
    try:
        refs = {q: r for q, r in zip(queries, _clients(jax_server.port, queries, 1, 4, JAX)[0])}
    finally:
        jax_server.stop()
    server = _native(PORT, _service(PORT, 5000))
    try:
        outs = _clients(server.port, queries, 8, 6)
    finally:
        server.stop()
    for i, out in enumerate(outs):
        for j, res in enumerate(out):
            assert res == refs[queries[(i + j) % len(queries)]]


def test_a_server_asked_for_the_card_raises_without_one():
    """No fallback hides the device: device="cuda" (the default) on a
    machine without a card raises at construction, for both servers."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    svc = PORT.table_service.TableService()
    for make in (lambda: PORT.nt.NativeTCPServer(svc, port=0),
                 lambda: PORT.nt.NativeTCPServer(svc, port=0, device="cuda", mesh_shards=2),
                 lambda: PORT.http_api.EventQLServer(svc, port=0)):
        with pytest.raises(PORT.errors.RuntimeError_, match="CUDA"):
            make()
