"""The port's embedded C server API and C client against the JAX package's.

eventql_tpu_torch/native/ holds the port's copies of native/evql_server.c
(the C server API over eventql_tpu_torch.server.embedded) and
native/embedded_server_smoke.c (a C host program of it), built with
native/evql_client.c by native/_build.py into the port's own build
directory at first use (``cc``; nothing is written under native/).
Here: each C copy against its original; the port's C host booting the
embedded server with ``server.device=cpu`` and running DDL, DML and a
query through the C client; the port's server library loaded into this
process (bound as chip_smoke.py phase 12 binds it), handed a table and
queried on the GROUP BY route; and
tests/test_cclient.py's cases through the port's ctypes wrapper
(client/cclient.py) against the port's server on the CPU, each beside the
same case through the JAX package's wrapper against the JAX server.
"""

import ctypes
import os
import re
import socket
import struct
import subprocess
import threading

import numpy as np
import pytest

import chip_smoke
from eventql_tpu.client import cclient as jax_cclient
from eventql_tpu.db.table_service import TableService as JaxTableService
from eventql_tpu.server import auth as jax_auth
from eventql_tpu.server.native_tcp import NativeTCPServer as JaxNativeTCPServer
from eventql_tpu_torch.client import cclient as port_cclient
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.db.table_service import TableService
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.exec.runtime import Runtime
from eventql_tpu_torch.native import _build
from eventql_tpu_torch.server import auth as port_auth
from eventql_tpu_torch.server.native_tcp import NativeTCPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NATIVE = os.path.join(REPO, "eventql_tpu_torch", "native")


def _read(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return f.read()


# -- the C copies ----------------------------------------------------------------


def test_server_c_copy_differs_only_in_its_module_name():
    port = _read(PORT_NATIVE, "evql_server.c")
    orig = _read(REPO, "native", "evql_server.c")
    assert port.count("eventql_tpu_torch.server.embedded") == 4
    assert port.replace("eventql_tpu_torch.server.embedded", "eventql_tpu.server.embedded") == orig


def test_host_c_copy_differs_only_in_taking_its_conf_from_its_arguments():
    """The C host sets server.listen as the original does, then each
    key=value argument (server.device=cuda|cpu): the device is an argument."""
    port = _read(PORT_NATIVE, "embedded_server_smoke.c")
    orig = _read(REPO, "native", "embedded_server_smoke.c")
    start, end = "int main(", "\n  evql_server_t* server = evql_server_init(conf);"
    pa, oa = port.index(start), orig.index(start)
    pb, ob = port.index(end, pa), orig.index(end, oa)
    assert "argv[i]" in port[pa:pb] and port[pa:pb] != orig[oa:ob]
    assert port[:pa] + orig[oa:ob] + port[pb:] == orig


def test_build_writes_only_the_ports_build_directory():
    out = _build.build()
    assert os.path.dirname(out) == os.path.join(PORT_NATIVE, "build")
    assert sorted(os.listdir(out)) == sorted(
        [_build.CLIENT_LIB, _build.SERVER_LIB, _build.SMOKE_BIN])
    assert _build.build() == out  # keyed by the sources: built once


# -- the C host program -----------------------------------------------------------


def _host(*conf):
    return subprocess.run([_build.path(_build.SMOKE_BIN), *conf], capture_output=True,
                          text=True, timeout=120, env=_build.host_env())


def test_c_host_boots_the_embedded_server_on_the_cpu():
    """conf -> init -> start -> listen, then DDL, two INSERTs and a sum
    through the C client."""
    out = _host("server.device=cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert re.match(r"embedded server smoke OK \(port \d+\)$", out.stdout.strip())


def test_c_host_default_device_is_the_card():
    """server.device defaults to cuda: without a card the server does not
    start, and says why."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = _host()
    assert out.returncode == 1 and "start failed" in out.stderr and "CUDA" in out.stderr


def test_c_host_rejects_an_argument_without_a_value():
    out = _host("server.device")
    assert out.returncode == 2 and "usage" in out.stderr


# -- the server library in this process --------------------------------------------


def _conf(clib, pairs):
    conf = clib.evql_conf_init()
    for k, v in pairs.items():
        assert clib.evql_conf_set(conf, k.encode(), v.encode()) == 0
    return conf


def test_server_library_in_process_serves_a_handed_table_on_the_route():
    """The port's libevql_server.so loaded into this interpreter (its
    Python symbols resolve from this process): init with
    server.device=cpu, the EmbeddedServer's table service handed a table,
    listen on a thread until the kill pipe is written; the C client's
    GROUP BY takes the route and equals numpy."""
    lib, clib = chip_smoke._server_lib()
    conf = _conf(clib, {"server.listen": "127.0.0.1:0", "server.device": "cpu"})
    server = lib.evql_server_init(conf)
    kill_r, kill_w = os.pipe()
    listener = None
    try:
        assert lib.evql_server_start(server) == 0, lib.evql_server_geterror(server)
        assert lib.evql_server_getconf(server, b"server.device") == b"cpu"
        assert lib.evql_server_getconf(server, b"server.query_failed_shard_policy") == b"tolerate"
        embedded = ctypes.cast(server, ctypes.POINTER(ctypes.py_object))[0]
        n = 20_000
        rng = np.random.default_rng(1)
        k, v = rng.integers(0, 64, n).astype(np.uint64), rng.integers(0, 1000, n).astype(np.uint64)
        svc = embedded.table_service
        rt = Runtime(device="cpu")
        rt.build_query_plan(rt.new_transaction(svc),
                            "CREATE TABLE t (k uint64, v uint64);").execute(0)
        svc.tables["t"].insert_batch(Relation(["k", "v"], [
            Column(SType.UINT64, k, np.ones(n, bool)), Column(SType.UINT64, v, np.ones(n, bool))], n))
        rc = []
        listener = threading.Thread(target=lambda: rc.append(
            lib.evql_server_listen(server, kill_r)), daemon=True)
        listener.start()
        port = 0
        for _ in range(400):
            port = lib.evql_server_getport(server)
            if port > 0 and embedded.listener is not None:
                break
            threading.Event().wait(0.01)
        assert port > 0
        before = device_exec.FUSED_GROUPBY_COUNT
        c = port_cclient.CClient("127.0.0.1", embedded.listener.port)
        try:
            ((cols, rows),) = c.query(
                "select k, sum(v), count(1) from t where v < 800 group by k;")
        finally:
            c.close()
        assert device_exec.FUSED_GROUPBY_COUNT == before + 1
        keep = v < 800
        want = sorted([str(g), str(int(v[keep & (k == g)].sum())), str(int((keep & (k == g)).sum()))]
                      for g in np.unique(k[keep]))
        assert sorted(rows) == want
        os.write(kill_w, b"x")
        listener.join(timeout=30)
        assert not listener.is_alive() and rc == [0]
    finally:
        if listener is not None and listener.is_alive():
            os.write(kill_w, b"x")
            listener.join(timeout=30)
        lib.evql_server_shutdown(server)
        lib.evql_server_free(server)
        clib.evql_conf_free(conf)
        os.close(kill_r)
        os.close(kill_w)


# -- the C client: tests/test_cclient.py's cases through both packages -------------


def _pkg_server(which, **kw):
    if which == "jax":
        return JaxNativeTCPServer(JaxTableService(), port=0, **kw).start()
    return NativeTCPServer(TableService(), port=0, device="cpu", **kw).start()


def _client_mod(which):
    return jax_cclient if which == "jax" else port_cclient


def _setopt(lib):
    lib.evql_client_setopt.restype = ctypes.c_int
    lib.evql_client_setopt.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_size_t, ctypes.c_long]
    return lib.evql_client_setopt


def _case_query(cc, port):
    c = cc.CClient("127.0.0.1", port)
    try:
        return c.query("select 1 + 1 as two, 'hi' as s;")
    finally:
        c.close()


def _case_multi_statement(cc, port):
    c = cc.CClient("127.0.0.1", port)
    try:
        return c.query("select 1 as a; select 2 as b;")
    finally:
        c.close()


def _case_table_roundtrip(cc, port):
    c = cc.CClient("127.0.0.1", port)
    try:
        c.query("CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));")
        c.query("INSERT INTO ev (t, v) VALUES (1, 10);")
        c.query("INSERT INTO ev (t, v) VALUES (2, 32);")
        return c.query("select sum(v) from ev;")
    finally:
        c.close()


def _case_error(cc, port):
    c = cc.CClient("127.0.0.1", port)
    try:
        try:
            c.query("select ;")
        except cc.CClientError as e:
            err = str(e)
        return err, c.query("select 1 as x;")
    finally:
        c.close()


def _case_setopt_and_getstat(cc, port):
    lib = cc._load()
    setopt = _setopt(lib)
    lib.evql_client_getstat.restype = ctypes.c_uint64
    lib.evql_client_getstat.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    c = cc.CClient("127.0.0.1", port)
    try:
        val = struct.pack("<Q", 5_000_000)
        return ([setopt(c._c, 1, val, 8, 0), setopt(c._c, 2, val, 8, 0),
                 setopt(c._c, 1, b"xx", 2, 0), setopt(c._c, 99, val, 8, 0)],
                int(lib.evql_client_getstat(c._c, 0x4)), c.query("select 1 as x;"))
    finally:
        c.close()


def _case_connectfd(cc, port):
    lib = cc._load()
    lib.evql_client_connectfd.restype = ctypes.c_int
    lib.evql_client_connectfd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long]
    sock = socket.create_connection(("127.0.0.1", port))
    raw = lib.evql_client_init()
    try:
        rc = lib.evql_client_connectfd(raw, sock.detach(), 0)
        c = cc.CClient.__new__(cc.CClient)
        c._c, c._lib = raw, lib
        return rc, c.query("select 41 + 1 as answer;")
    finally:
        lib.evql_client_close(raw)
        lib.evql_client_destroy(raw)


def _case_paged_fetch(cc, port):
    setopt = _setopt(cc._load())
    c = cc.CClient("127.0.0.1", port)
    try:
        c.query("CREATE TABLE pgc (t uint64, v uint64, PRIMARY KEY (t));")
        for i in range(100):
            c.query("INSERT INTO pgc (t, v) VALUES (%d, %d);" % (i, i * 3))
        assert setopt(c._c, 2, struct.pack("<Q", 8), 8, 0) == 0
        return c.query("select t, v from pgc order by t;"), c.query("select 3 as x;")
    finally:
        c.close()


def _case_discard_mid_result(cc, port):
    lib = cc._load()
    setopt = _setopt(lib)
    lib.evql_discard_result.restype = ctypes.c_int
    lib.evql_discard_result.argtypes = [ctypes.c_void_p]
    lib.evql_query.restype = ctypes.c_int
    c = cc.CClient("127.0.0.1", port)
    try:
        c.query("CREATE TABLE pgd (t uint64, PRIMARY KEY (t));")
        for i in range(40):
            c.query("INSERT INTO pgd (t) VALUES (%d);" % i)
        assert setopt(c._c, 2, struct.pack("<Q", 4), 8, 0) == 0
        rc = lib.evql_query(c._c, b"select t from pgd order by t;", b"", 0)
        return rc, lib.evql_discard_result(c._c), c.query("select 11 as x;")
    finally:
        c.close()


def _case_grouped_rows(cc, port):
    """A GROUP BY over JSON inserts (the port's route on the CPU)."""
    c = cc.CClient("127.0.0.1", port)
    try:
        c.query("CREATE TABLE g (t uint64, k string, v uint64, PRIMARY KEY (t));")
        for i in range(60):
            c.query("INSERT INTO g (t, k, v) VALUES (%d, 'k%d', %d);" % (i, i % 4, i))
        return c.query("select k, count(1), sum(v) from g group by k order by k;")
    finally:
        c.close()


C_CLIENT_CASES = {
    "query": _case_query, "multi_statement": _case_multi_statement,
    "table_roundtrip": _case_table_roundtrip, "error": _case_error,
    "setopt_and_getstat": _case_setopt_and_getstat, "connectfd": _case_connectfd,
    "paged_fetch": _case_paged_fetch, "discard_mid_result": _case_discard_mid_result,
    "grouped_rows": _case_grouped_rows,
}


@pytest.mark.parametrize("case", list(C_CLIENT_CASES))
def test_c_client_cases_alike(case):
    outs = []
    for which in ("jax", "port"):
        server = _pkg_server(which)
        try:
            outs.append(C_CLIENT_CASES[case](_client_mod(which), server.port))
        finally:
            server.stop()
    assert outs[1] == outs[0]


def test_c_client_auth_alike():
    outs = []
    for which, auth_mod in (("jax", jax_auth), ("port", port_auth)):
        auth = auth_mod.LegacyClientAuth("cs")
        server = _pkg_server(which, client_auth=auth)
        cc = _client_mod(which)
        try:
            with pytest.raises(cc.CClientError) as e:
                cc.CClient("127.0.0.1", server.port)
            c = cc.CClient("127.0.0.1", server.port, auth_token=auth.make_token("db", "u"))
            outs.append((str(e.value), c.query("select 5 as x;")))
            c.close()
        finally:
            server.stop()
    assert outs[1] == outs[0] and "missing auth token" in outs[0][0]


def test_c_conf_api_alike(tmp_path):
    ini = tmp_path / "evql.conf"
    ini.write_text("# comment\n[server]\ndatadir = /data/evql\nindexbuild_threads=2\n"
                   "[cluster]\nname = prod\n")
    outs = []
    for which in ("jax", "port"):
        lib = _client_mod(which)._load()
        lib.evql_conf_init.restype = ctypes.c_void_p
        lib.evql_conf_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.evql_conf_get.restype = ctypes.c_char_p
        lib.evql_conf_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.evql_conf_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.evql_conf_free.argtypes = [ctypes.c_void_p]
        conf = lib.evql_conf_init()
        got = [lib.evql_conf_set(conf, b"server.datadir", b"/tmp/x"),
               lib.evql_conf_get(conf, b"server.datadir"),
               lib.evql_conf_load(conf, str(ini).encode())]
        got += [lib.evql_conf_get(conf, k) for k in (
            b"server.datadir", b"server.indexbuild_threads", b"cluster.name", b"missing")]
        lib.evql_conf_free(conf)
        outs.append(got)
    assert outs[1] == outs[0] == [0, b"/tmp/x", 0, b"/data/evql", b"2", b"prod", None]


def test_c_client_progress_counters_on_the_port_route():
    """QUERY_SENDPROGRESS over 40 GROUP BYs of 50 000 rows: the rows
    scanned stick on the client, and each statement took the route."""
    server = _pkg_server("port")
    server.HEARTBEAT_INTERVAL = 0.02
    lib = port_cclient._load()
    lib.evql_client_getstat.restype = ctypes.c_uint64
    lib.evql_client_getstat.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    try:
        c = port_cclient.CClient("127.0.0.1", server.port)
        c.query("CREATE TABLE ev (k uint64, v uint64);")
        n = 50_000
        server.table_service.tables["ev"].insert_batch(Relation(["k", "v"], [
            Column(SType.UINT64, np.arange(n, dtype=np.uint64) % 101, np.ones(n, bool)),
            Column(SType.UINT64, np.arange(n, dtype=np.uint64), np.ones(n, bool))], n))
        before = device_exec.FUSED_GROUPBY_COUNT
        results = c.query("; ".join(
            "select k, count(1), sum(v) from ev group by k" for _ in range(40)) + ";", flags=0x4)
        assert len(results) == 40 and device_exec.FUSED_GROUPBY_COUNT - before == 40
        assert int(lib.evql_client_getstat(c._c, 0x2)) >= n
        c.close()
    finally:
        server.stop()
