"""The port's command-line tools and clients against the JAX package's.

cli/evqlctl.py, cli/evqlbench.py, cli/evqlslap.py, cli/mysql2evql.py,
cli/cstable_tool.py, cli/zkserver.py and client/mysql_wire.py are copies
of the JAX package's files with their imports renamed (evqlbench also
takes ``--device``; tests/test_torch_storage.py holds each to its
original). Here each tool runs in process through both packages on the
same inputs and must print the same text and leave the same state:
evqlctl's subcommands over a registry file of each package, evqlbench's
synthetic and imported tables (the port on ``--device cpu``, its GROUP BY
route counted), mysql2evql's dump parser and its imports into each
package's server (from a dump file and from tests/test_mysql_wire.py's
mock MySQL server), the MySQL wire client against that mock,
cstable_tool's dump / dump-json / index-lookup over files this test
writes, the ZooKeeper server CLI serving both packages' clients, and
evqlslap's query and insert modes against the port's server on the CPU.
"""

import importlib
import importlib.util
import io
import json
import os
import re
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

_MODULES = (
    "cli.evqlctl", "cli.evqlbench", "cli.evqlslap", "cli.mysql2evql", "cli.cstable_tool",
    "client.mysql_wire", "config.config_directory", "config.config_directory_zookeeper",
    "core.types", "db.metadata", "db.table_service", "db.lsm", "exec.relation",
    "exec.runtime", "columnar.cstable_writer", "server.native_tcp", "server.http_api",
)


def package(root):
    ns = SimpleNamespace(root=root)
    for mod in _MODULES:
        setattr(ns, mod.split(".")[1], importlib.import_module(f"{root}.{mod}"))
    ns.device = {} if root == "eventql_tpu" else {"device": "cpu"}
    return ns


JAX = package("eventql_tpu")
PORT = package("eventql_tpu_torch")


def _original(name):
    """tests/<name>.py, the JAX package's test module, as it is."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(TESTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MYSQL_WIRE_TEST = _original("test_mysql_wire")
MYSQL2EVQL_TEST = _original("test_mysql2evql")


def _native(pkg):
    return pkg.native_tcp.NativeTCPServer(pkg.table_service.TableService(), port=0,
                                          **pkg.device).start()


def _query(pkg, port, sql):
    c = pkg.native_tcp.NativeTCPClient("127.0.0.1", port)
    try:
        return c.query(sql)
    finally:
        c.close()


def _run_main(main, argv, capsys):
    """(return code, stdout, stderr) of a tool's main in this process."""
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


# -- evqlctl ------------------------------------------------------------------

# a sequence of subcommands on one registry file; ("meta",) writes a table's
# partition metadata as a cluster's CREATE TABLE would
EVQLCTL_STEPS = [
    ["cluster-create", "--cluster_name", "prod", "--replication_factor", "2"],
    ["cluster-create"],
    ["cluster-add-server", "--server_name", "n1", "--server_addr", "127.0.0.1:1"],
    ["cluster-add-server", "--server_name", "n2", "--server_addr", "127.0.0.1:2"],
    ["cluster-add-server", "--server_name", "n3"],
    ["cluster-list"],
    ["database-create", "--database", "db1"],
    ["table-config-set", "--table_name", "ev", "disable_split", "true"],
    ["table-split", "--table_name", "missing", "--partition_id", "p", "--split_point", "5"],
    ("meta",),
    ["table-split", "--table_name", "ev", "--partition_id", "PID", "--split_point", "100"],
    ["table-split-finalize", "--table_name", "ev", "--partition_id", "PID"],
    ["rebalance"],
    ["cluster-remove-server", "--server_name", "n3"],
    ["cluster-remove-server", "--server_name", "n3"],
    ["cluster-status"],
    ["cluster-list"],
]
_PID = "PID"


def _evqlctl_run(pkg, path, steps, capsys):
    out = []
    meta = pkg.metadata.TableMetadata.initial("uint64", "t", "ev", ["n1", "n2"])
    pid = meta.entries[0].partition_id
    for step in steps:
        if step == ("meta",):
            pkg.config_directory.ConfigDirectory(path).update_table_config(
                "default", "ev", {"metadata": meta.to_json()})
            continue
        argv = ["-C", path] + [pid if a == _PID else a for a in step]
        out.append(_run_main(pkg.evqlctl.main, argv, capsys))
    with open(path) as f:
        registry = f.read()
    # the registry names the package that built each server entry (and a
    # table pads its columns to that name), and the second the cluster was
    # created in
    out = [(rc, re.sub(r"[ =]{2,}", " ", o.replace(f"{pkg.root} v0.1", "<package> v0.1")), e)
           for rc, o, e in out]
    text = json.dumps([out, json.loads(registry)]).replace(f"{pkg.root} v0.1", "<package> v0.1")
    return json.loads(re.sub(r'"created": \d+', '"created": 0', text))


@pytest.mark.parametrize("upto", range(1, len(EVQLCTL_STEPS) + 1),
                         ids=[(s[0] if s[0] != "meta" else "meta") + f"-{i}"
                              for i, s in enumerate(EVQLCTL_STEPS)])
def test_evqlctl_subcommands_print_and_register_alike(tmp_path, capsys, upto):
    """The first ``upto`` of EVQLCTL_STEPS through each package's evqlctl on
    a registry file of its own: the same return codes, output text and
    error text, and the same registry afterwards."""
    steps = EVQLCTL_STEPS[:upto]
    want = _evqlctl_run(JAX, str(tmp_path / "jax.json"), steps, capsys)
    got = _evqlctl_run(PORT, str(tmp_path / "port.json"), steps, capsys)
    assert got == want
    # a second cluster-create, a split of a missing table and a second
    # removal of n3 fail
    assert [rc for rc, _o, _e in got[0]] == [
        int(i in (1, 8, 14)) for i, s in enumerate(steps) if s != ("meta",)]


def test_evqlctl_cluster_status_pings_each_packages_servers(tmp_path, capsys):
    """cluster-status over a live server of each package and a dead one."""
    def case(pkg):
        server = _native(pkg)
        path = str(tmp_path / f"{pkg.root}.json")
        try:
            main = pkg.evqlctl.main
            _run_main(main, ["-C", path, "cluster-create"], capsys)
            _run_main(main, ["-C", path, "cluster-add-server", "--server_name", "live",
                             "--server_addr", f"127.0.0.1:{server.port}"], capsys)
            _run_main(main, ["-C", path, "cluster-add-server", "--server_name", "dead",
                             "--server_addr", "127.0.0.1:1"], capsys)
            rc, out, err = _run_main(main, ["-C", path, "cluster-status"], capsys)
        finally:
            server.stop()
        return rc, re.sub(r"127\.0\.0\.1:%d\b" % server.port, "127.0.0.1:<live>", out), err

    got = case(PORT)
    assert got == case(JAX)
    lines = {line.split()[0]: line for line in got[1].splitlines() if line}
    assert "SERVER_UP" in lines["live"] and "SERVER_DOWN" in lines["dead"]


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_evqlctl_table_import_into_each_packages_server(tmp_path, capsys, fmt):
    rows = [{"t": i, "v": i * 10, "k": f"k{i % 3}"} for i in range(300)]
    data = tmp_path / f"rows.{fmt}"
    if fmt == "json":
        data.write_text("\n".join(json.dumps(r) for r in rows))
    else:
        data.write_text("t,v,k\n" + "\n".join(f"{r['t']},{r['v']},{r['k']}" for r in rows))

    def case(pkg):
        server = _native(pkg)
        try:
            _query(pkg, server.port,
                   "CREATE TABLE ev (t uint64, v uint64, k string, PRIMARY KEY (t));")
            rc, out, err = _run_main(pkg.evqlctl.main, [
                "table-import", "--port", str(server.port), "--table_name", "ev",
                "--format", fmt, str(data)], capsys)
            return rc, out, err, _query(pkg, server.port,
                                        "select k, count(1), sum(v) from ev group by k order by k;")
        finally:
            server.stop()

    got = case(PORT)
    assert got == case(JAX)
    assert got[1] == "imported 300 records into ev\n"


# -- evqlbench ----------------------------------------------------------------

BENCH_QUERY = "select k, sum(v), count(1) from benchmark where v < 800 group by k;"


def _bench_lines(pkg, argv, capsys):
    """evqlbench's output without its times."""
    device = ["--device", "cpu"] if pkg is PORT else []
    rc, out, _err = _run_main(pkg.evqlbench.main, argv + device, capsys)
    keep = [line for line in out.splitlines()
            if line.startswith(("query:", "result rows:"))]
    return rc, keep, out


def test_evqlbench_synthetic_table_on_the_port_route(capsys):
    """--rows 65536 -n 2: the same query and result row count as the JAX
    tool; the port's warm-up and both rounds take the GROUP BY route; the
    query's rows over the same generated table equal the JAX engine's."""
    from eventql_tpu_torch.exec import device_exec

    argv = ["--rows", "65536", "-n", "2"]
    want = _bench_lines(JAX, argv, capsys)
    before = device_exec.FUSED_GROUPBY_COUNT
    got = _bench_lines(PORT, argv, capsys)
    assert device_exec.FUSED_GROUPBY_COUNT - before == 3
    assert got[:2] == want[:2] == (0, [f"query: {BENCH_QUERY}", "result rows: 1024"])
    assert "M input rows/s" in got[2]

    def rows(pkg):
        n = 65536
        rng = np.random.default_rng(42)  # the tool's table
        C = pkg.relation.Column
        rel = pkg.relation.Relation(["k", "v"], [
            C(pkg.types.SType.UINT64, rng.integers(0, 1024, n).astype(np.uint64), np.ones(n, bool)),
            C(pkg.types.SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64), np.ones(n, bool))],
            n)
        tables = pkg.runtime.RelationTableProvider()
        tables.add_table("benchmark", rel)
        rt = pkg.runtime.Runtime(**pkg.device)
        return sorted(rt.build_query_plan(rt.new_transaction(tables), BENCH_QUERY).execute(0).rows)

    assert rows(PORT) == rows(JAX)


@pytest.mark.parametrize("kind", ["cst", "csv"])
def test_evqlbench_imported_table(tmp_path, capsys, kind):
    """-t name=<file>: a cstable file the port's writer made, or a CSV."""
    n = 5000
    rng = np.random.default_rng(5)
    k, v = rng.integers(0, 50, n).astype(np.uint64), rng.integers(0, 1000, n).astype(np.uint64)
    path = str(tmp_path / f"t.{kind}")
    if kind == "cst":
        C = PORT.relation.Column
        PORT.cstable_writer.write_cstable(path, PORT.relation.Relation(["k", "v"], [
            C(PORT.types.SType.UINT64, k, np.ones(n, bool)),
            C(PORT.types.SType.UINT64, v, np.ones(n, bool))], n))
    else:
        with open(path, "w") as f:
            f.write("k,v\n" + "".join(f"{a},{b}\n" for a, b in zip(k, v)))
    for argv in (["-t", f"t={path}", "-n", "1"],
                 ["-t", f"t={path}", "-n", "1", "-q",
                  "select k, sum(v) from t where v < 500 group by k;"]):
        got, want = _bench_lines(PORT, argv, capsys), _bench_lines(JAX, argv, capsys)
        assert got[:2] == want[:2] and got[0] == 0


def test_evqlbench_runs_on_the_card_unless_asked(capsys):
    """--device defaults to cuda, which raises without a card."""
    from eventql_tpu_torch.core.errors import RuntimeError_

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError_, match="CUDA"):
        PORT.evqlbench.main(["--rows", "16", "-n", "1"])


# -- mysql2evql and the MySQL wire client --------------------------------------

DUMP = MYSQL2EVQL_TEST.DUMP


@pytest.mark.parametrize("mysql_type", [
    "bigint(20)", "varchar(255)", "double", "tinyint(1)", "datetime", "longtext", "int",
    "decimal(10,2)", "enum('a','b')", "timestamp", "bool", "json", "blob", "geometry"])
def test_mysql_type_mapping_alike(mysql_type):
    assert PORT.mysql2evql.map_type(mysql_type) == JAX.mysql2evql.map_type(mysql_type)


def test_mysql_dump_parses_alike():
    got = PORT.mysql2evql.parse_create_table(DUMP, "users")
    assert got == JAX.mysql2evql.parse_create_table(DUMP, "users")
    records = list(PORT.mysql2evql.parse_inserts(DUMP, "users", got[0]))
    assert records == list(JAX.mysql2evql.parse_inserts(DUMP, "users", got[0]))
    assert len(records) == 3 and records[1]["name"] == "bob, the 'builder'"


def _generated_dump(n, seed):
    """A mysqldump of n rows: an id key, a string, integers, a double,
    NULLs, quotes and commas inside strings; extended INSERTs of 100 rows."""
    rng = np.random.default_rng(seed)
    names = ["a", "b,c", "it's", "x (y)", "\\\\slash", ""]
    rows = []
    for i in range(n):
        name = "NULL" if rng.random() < 0.1 else "'" + names[rng.integers(len(names))].replace(
            "'", "\\'") + "'"
        rows.append(f"({i},{name},{int(rng.integers(0, 1 << 40))},{rng.integers(0, 9)}.25)")
    inserts = "".join(f"INSERT INTO `ev` VALUES {','.join(rows[i:i + 100])};\n"
                      for i in range(0, n, 100))
    return ("CREATE TABLE `ev` (\n  `id` bigint(20) NOT NULL,\n  `name` varchar(64),\n"
            "  `v` bigint(20),\n  `f` double,\n  PRIMARY KEY (`id`)\n) ENGINE=InnoDB;\n"
            + inserts)


@pytest.mark.parametrize("dump,table,sql", [
    (DUMP, "users", "select id, name, score, active, created from users order by id;"),
    (_generated_dump(700, 3), "ev",
     "select name, count(1), sum(v), max(f) from ev group by name order by name;"),
], ids=["the_jax_tests_dump", "generated_700_rows"])
def test_mysql2evql_file_import_answers_alike(tmp_path, capsys, dump, table, sql):
    path = tmp_path / "dump.sql"
    path.write_text(dump)

    def case(pkg):
        server = _native(pkg)
        try:
            rc, out, _err = _run_main(pkg.mysql2evql.main, [
                "--source_file", str(path), "--source_table", table, "--port",
                str(server.port), "--batch_size", "64"], capsys)
            return rc, out, _query(pkg, server.port, sql)
        finally:
            server.stop()

    got = case(PORT)
    assert got == case(JAX)
    assert got[0] == 0 and got[1].startswith("imported ")


# ROADMAP C15: a dump's BIGINT above 2^53, as an integer column and as a
# numeric datetime, beside a decimal literal in a BIGINT column
BIG = (1 << 53) + 1
BIG_DUMP = ("CREATE TABLE `big` (\n  `id` bigint(20) unsigned NOT NULL,\n"
            "  `v` bigint(20) unsigned NOT NULL,\n  `t` datetime,\n  PRIMARY KEY (`id`)\n);\n"
            f"INSERT INTO `big` VALUES (1,{BIG},{BIG}),(2,12.75,'2020-01-02 03:04:05'),"
            f"(3,{(1 << 64) - 1},{BIG + 2});\n")


def test_dump_bigint_above_2_53_is_exact_in_the_port():
    """The port reads a dump's integers with int() first (C15); the JAX
    tool's int(float()) rounds 2^53 + 1 to 2^53."""
    cols = PORT.mysql2evql.parse_create_table(BIG_DUMP, "big")[0]
    assert cols == JAX.mysql2evql.parse_create_table(BIG_DUMP, "big")[0]
    got = list(PORT.mysql2evql.parse_inserts(BIG_DUMP, "big", cols))
    assert [(r["v"], r["t"]) for r in got] == [
        (BIG, BIG), (12, 1577934245 * 1_000_000), ((1 << 64) - 1, BIG + 2)]
    jax_rows = [(r["v"], r["t"]) for r in JAX.mysql2evql.parse_inserts(BIG_DUMP, "big", cols)]
    assert jax_rows[:2] == [(1 << 53, 1 << 53), (12, 1577934245 * 1_000_000)]


def test_mysql2evql_imports_a_bigint_above_2_53_exactly(tmp_path, capsys):
    path = tmp_path / "big.sql"
    path.write_text(BIG_DUMP)
    server = _native(PORT)
    try:
        rc, out, _err = _run_main(PORT.mysql2evql.main, [
            "--source_file", str(path), "--source_table", "big", "--port",
            str(server.port)], capsys)
        assert rc == 0 and out.startswith("imported 3 rows"), out
        rows = _query(PORT, server.port, "select id, v from big order by id;")[0][1]
    finally:
        server.stop()
    assert rows == [["1", str(BIG)], ["2", "12"], ["3", str((1 << 64) - 1)]]


@pytest.fixture
def mock_mysql():
    import threading

    srv = MYSQL_WIRE_TEST.MockMySQL(("127.0.0.1", 0), MYSQL_WIRE_TEST.Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def _wire_session(pkg, host, port):
    """What the wire client observes of the mock: the handshake, a result
    set, an error and the connection after it, the schema, a wrong
    password."""
    mw = pkg.mysql_wire
    out = []
    c = mw.MySQLConnection(host, port, user="tester", password=MYSQL_WIRE_TEST.PASSWORD)
    out.append(c.server_version)
    names, rows = c.query("SELECT * FROM `users`")
    out.append((names, list(rows)))
    try:
        c.query("BOOM")
    except mw.MySQLError as e:
        out.append(("error", str(e)))
    names, rows = c.query("SET NAMES utf8")
    out.append((names, list(rows)))
    out.append(c.table_schema("users"))
    c.close()
    try:
        mw.MySQLConnection(host, port, user="tester", password="wrong")
    except mw.MySQLError as e:
        out.append(("error", str(e)))
    return out


def test_mysql_wire_client_against_the_mock_server(mock_mysql):
    got = _wire_session(PORT, *mock_mysql)
    assert got == _wire_session(JAX, *mock_mysql)
    assert got[1][0] == ["id", "name", "score"] and "syntax error" in got[2][1]
    assert "Access denied" in got[-1][1]


def test_mysql_wire_reads_split_packets_alike():
    """A 16 MB payload split at 0xFFFFFF, an exact 0xFFFFFF payload with
    its empty terminator, and a small one."""
    class FakeSock:
        def __init__(self, data):
            self.data, self.pos = data, 0

        def recv(self, n):
            out = self.data[self.pos:self.pos + n]
            self.pos += len(out)
            return out

    def pkt(seq, payload):
        return len(payload).to_bytes(3, "little") + bytes([seq]) + payload

    big = bytes(range(256)) * 65536
    wires = [pkt(0, big[:0xFFFFFF]) + pkt(1, big[0xFFFFFF:]),
             pkt(0, big[:0xFFFFFF]) + pkt(1, b""), pkt(0, b"abc")]
    for wire, want in zip(wires, (big, big[:0xFFFFFF], b"abc")):
        for pkg in (JAX, PORT):
            conn = pkg.mysql_wire.MySQLConnection.__new__(pkg.mysql_wire.MySQLConnection)
            conn.sock = FakeSock(wire)
            assert conn._read_packet() == want


def test_mysql2evql_live_import_answers_alike(mock_mysql, capsys):
    host, port = mock_mysql

    def case(pkg):
        server = _native(pkg)
        try:
            rc, out, _err = _run_main(pkg.mysql2evql.main, [
                "--source_mysql", f"mysql://tester:{MYSQL_WIRE_TEST.PASSWORD}@{host}:{port}/shop",
                "--source_table", "users", "--port", str(server.port)], capsys)
            return rc, out, _query(pkg, server.port, "select id, name, score from users order by id;")
        finally:
            server.stop()

    got = case(PORT)
    assert got == case(JAX)
    assert got[2][0][1] == [["1", "ada", "1.500000"], ["2", "bob", "NULL"],
                            ["3", "NULL", "2.250000"]]


# -- cstable_tool ---------------------------------------------------------------


def _cst_fixture(tmp_path):
    """A cstable v0.1 file of the port's writer and a v0.2 segment of the
    port's LSM table service (two rows of a primary-keyed table)."""
    n = 40
    rng = np.random.default_rng(8)
    C, S = PORT.relation.Column, PORT.types.SType
    valid = rng.random(n) < 0.8
    v1 = str(tmp_path / "v1.cst")
    PORT.cstable_writer.write_cstable(v1, PORT.relation.Relation(["id", "f", "s"], [
        C(S.UINT64, np.arange(n, dtype=np.uint64), np.ones(n, bool)),
        C(S.FLOAT64, np.where(valid, rng.standard_normal(n), 0.0), valid),
        C.from_strings([f"s{i % 7}" if i % 5 else None for i in range(n)])], n))
    d = str(tmp_path / "data")
    svc = PORT.lsm.DurableTableService(d, arena_flush_rows=100)
    rt = PORT.runtime.Runtime(device="cpu")
    for sql in ("CREATE TABLE ev (id uint64, name string, PRIMARY KEY (id));",
                "INSERT INTO ev (id, name) VALUES (1, 'one');",
                "INSERT INTO ev (id, name) VALUES (2, 'two');"):
        rt.build_query_plan(rt.new_transaction(svc), sql).execute(0)
    svc.commit_all()
    seg_dir = os.path.join(d, "ev")
    seg = os.path.join(seg_dir, sorted(f for f in os.listdir(seg_dir) if f.endswith(".cst"))[0])
    return v1, seg_dir, seg


@pytest.mark.parametrize("cmd", ["dump v1", "dump-json v1", "dump v2", "dump-json v2",
                                 "index-lookup", "index-lookup missing", "no such file",
                                 "unknown command"])
def test_cstable_tool_prints_alike(tmp_path, cmd):
    import hashlib

    v1, seg_dir, seg = _cst_fixture(tmp_path)
    argv = {
        "dump v1": ["dump", v1], "dump-json v1": ["dump-json", v1],
        "dump v2": ["dump", seg], "dump-json v2": ["dump-json", seg],
        "index-lookup": ["index-lookup", seg_dir, hashlib.sha1(b"2").hexdigest()],
        "index-lookup missing": ["index-lookup", seg_dir, "0" * 40],
        "no such file": ["dump", str(tmp_path / "none.cst")],
        "unknown command": ["frobnicate", v1],
    }[cmd]

    def run(pkg):
        out = io.StringIO()
        try:
            rc = pkg.cstable_tool.main(list(argv), out=out)
        except Exception as e:  # noqa: BLE001 - the text is what is compared
            return ("raised", type(e).__name__, str(e))
        return rc, out.getvalue()

    got = run(PORT)
    assert got == run(JAX)
    if cmd in ("dump v1", "dump v2", "index-lookup"):
        assert got[0] == 0 and len(got[1]) > 40


# -- zkserver -------------------------------------------------------------------


def test_zkserver_serves_both_packages_and_stops_on_sigterm():
    """``python -m eventql_tpu_torch.cli.zkserver --listen 127.0.0.1:0``:
    a registry created through the JAX package's client reads back through
    the port's and the other way round; SIGTERM stops it with code 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "eventql_tpu_torch.cli.zkserver", "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    try:
        line = proc.stdout.readline()
        m = re.match(r"zookeeper server listening on (127\.0\.0\.1:\d+)", line)
        assert m, line
        addr = m.group(1)
        seen = []
        for writer, reader in ((JAX, PORT), (PORT, JAX)):
            url = f"zk://{addr}/{writer.root}"
            cdir = writer.config_directory.ConfigDirectory(url)
            cdir.cluster_create(writer.root, replication_factor=2)
            cdir.update_server_config(writer.config_directory.ServerConfig(
                "n1", "127.0.0.1:9", writer.config_directory.SERVER_UP))
            other = reader.config_directory.ConfigDirectory(url)
            seen.append((other.get_cluster_config()["name"],
                         [(s.server_id, s.server_addr, s.server_status)
                          for s in other.list_servers()]))
        assert seen == [("eventql_tpu", [("n1", "127.0.0.1:9", "SERVER_UP")]),
                        ("eventql_tpu_torch", [("n1", "127.0.0.1:9", "SERVER_UP")])]
    finally:
        for pkg in (JAX, PORT):
            pkg.config_directory_zookeeper.reset_sessions()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    assert rc == 0


# -- evqlslap -------------------------------------------------------------------


class _Tally:
    """Wraps evqlslap's RollingStats to keep the totals its windows reset."""

    def __init__(self, stats_cls):
        self.cls, self.made = stats_cls, []

    def __call__(self):
        stats = self.cls()
        record = stats.record
        stats.total = [0, 0]

        def counted(latency, error):
            record(latency, error)
            with stats.lock:
                stats.total[0] += 1
                stats.total[1] += int(error)

        stats.record = counted
        self.made.append(stats)
        return stats


def test_evqlslap_query_and_insert_modes_against_the_port_server(capsys, monkeypatch):
    """Two threads for 1.5 s each: the headline GROUP BY (every request
    answered, each on the route) and inserts, whose count(*) equals the
    inserts the tool recorded."""
    from eventql_tpu_torch.exec import device_exec

    slap = PORT.evqlslap
    tally = _Tally(slap.RollingStats)
    monkeypatch.setattr(slap, "RollingStats", tally)
    svc = PORT.table_service.TableService()
    server = PORT.http_api.EventQLServer(svc, port=0, device="cpu").start()
    try:
        rt = PORT.runtime.Runtime(device="cpu")
        for sql in ("CREATE TABLE t (id uint64, k uint64, v uint64, PRIMARY KEY (id));",
                    "CREATE TABLE slap (id uint64, value uint64, PRIMARY KEY (id));"):
            rt.build_query_plan(rt.new_transaction(svc), sql).execute(0)
        for i in range(200):
            svc.insert_json("t", json.dumps({"id": i, "k": i % 4, "v": i}))
        before = device_exec.FUSED_GROUPBY_COUNT
        rc, out, _err = _run_main(slap.main, [
            "-p", str(server.port), "-t", "2", "-d", "1.5",
            "-q", "select k, sum(v), count(1) from t where v < 150 group by k;"], capsys)
        (q,) = tally.made
        assert rc == 0 and "rps:" in out and q.total[0] > 0 and q.total[1] == 0
        assert device_exec.FUSED_GROUPBY_COUNT - before == q.total[0]
        rc, out, _err = _run_main(slap.main, [
            "-p", str(server.port), "-m", "insert", "--table", "slap", "-t", "2", "-d", "1.5"],
            capsys)
        ins = tally.made[1]
        assert rc == 0 and ins.total[0] > 0 and ins.total[1] == 0
        reported = sum(int(m) for m in re.findall(r"rps: (\d+)", out))
        assert 0 < reported <= ins.total[0]
        count = rt.build_query_plan(rt.new_transaction(svc),
                                    "select count(*), sum(value) from slap;").execute(0).rows
        assert count == [[str(ins.total[0]), str(7 * ins.total[0] * (ins.total[0] + 1) // 2)]]
    finally:
        server.stop()
