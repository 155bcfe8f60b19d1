"""The port's server binary and console against the JAX package's.

``python -m eventql_tpu_torch.cli.evqld --device cpu`` runs as a
subprocess (as the JAX package's test_cli.py runs its evqld) and is
driven over HTTP and through the port's console; each answer must equal
the JAX package's server given the same statements in this process. The
console's script mode (-f, -B, -q, --output_file) with the embedded
engine on --device cpu must write what the JAX console writes. Every
subprocess has its own timeout.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from eventql_tpu.cli import console as jax_console
from eventql_tpu.server.http_api import EventQLServer as JaxServer
from eventql_tpu_torch.config.config_directory import ConfigDirectory
from eventql_tpu_torch.config.config_directory_zookeeper import reset_sessions
from eventql_tpu_torch.config.zookeeper import ZooKeeperServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _start_evqld(*args):
    """The port's server on free ports with ``args``; (process, its HTTP
    port, the lines it printed so far)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "eventql_tpu_torch.cli.evqld", "--device", "cpu",
         "--listen_http", "127.0.0.1:0", "--listen_native", "127.0.0.1:0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(), cwd=REPO, text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        for _ in range(600):  # 60 s
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", "".join(lines))
            if m:
                return proc, int(m.group(1)), lines
            if proc.poll() is not None:
                break
            reader.join(timeout=0.1)
        raise AssertionError("evqld did not start: " + "".join(lines))
    except BaseException:
        _stop(proc)
        raise


def _stop(proc, sig=None):
    """End the process (SIGTERM, or ``sig``); its exit code."""
    if proc.poll() is None:
        proc.send_signal(sig or signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=10)


@pytest.fixture(scope="module")
def evqld():
    """The port's server on free ports; yields its HTTP port."""
    proc, port, _lines = _start_evqld()
    try:
        yield port
    finally:
        _stop(proc)


@pytest.fixture(scope="module")
def jax_server():
    server = JaxServer(port=0).start()
    yield server.port
    server.stop()


def _sql(port, query):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/sql",
                                 data=json.dumps({"query": query}).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


BASIC_SQL = [
    "CREATE TABLE customers (customerid uint64, customername string,"
    " PRIMARY KEY (customerid));",
    "INSERT INTO customers (customerid, customername) VALUES (1, 'Alfred');",
    "INSERT INTO customers (customerid, customername) VALUES (2, 'Ana');",
    "select customername from customers order by customerid;",
    "select customername, count(1), sum(customerid) from customers group by customername;",
]


def test_basic_sql_system(evqld, jax_server):
    """Create, insert, query back (the reference's test/system/basic_sql)."""
    got = [_sql(evqld, q) for q in BASIC_SQL]
    want = [_sql(jax_server, q) for q in BASIC_SQL]
    assert got == want
    assert got[3]["results"][0]["rows"] == [["Alfred"], ["Ana"]]


def _port_console(*args, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "eventql_tpu_torch.cli.console", *args],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=timeout)


def _jax_console(*args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        jax_console.main(list(args))
    return e.value.code, out.getvalue()


def test_console_against_server(evqld, jax_server):
    for port in (evqld, jax_server):
        _sql(port, "CREATE TABLE visits (id uint64, page string, PRIMARY KEY (id));")
        _sql(port, "INSERT INTO visits (id, page) VALUES (1, 'a');")
        _sql(port, "INSERT INTO visits (id, page) VALUES (2, 'b');")
    q = "select count(1) cnt from visits;"
    r = _port_console("--host", "127.0.0.1", "-p", str(evqld), "-e", q)
    rc, want = _jax_console("--host", "127.0.0.1", "-p", str(jax_server), "-e", q)
    assert r.returncode == rc == 0, r.stderr
    assert r.stdout == want
    assert "cnt" in r.stdout and "| 2" in r.stdout


def test_console_batch_and_file(tmp_path):
    """-f script, -B batch output, -q, --output_file on the embedded
    engine (the port on --device cpu)."""
    sql = tmp_path / "q.sql"
    sql.write_text(
        "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));\n"
        "INSERT INTO ev (t, v) VALUES (1, 10);\n"
        "INSERT INTO ev (t, v) VALUES (2, 32);\n"
        "select t, v from ev order by t;\n"
        "select count(1), sum(v) from ev;\n")
    r = _port_console("--device", "cpu", "-B", "-q", "-f", str(sql),
                      "--output_file", str(tmp_path / "port.txt"))
    rc, _ = _jax_console("-B", "-q", "-f", str(sql), "--output_file", str(tmp_path / "jax.txt"))
    assert r.returncode == rc == 0, r.stderr
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    lines = [l for l in got.splitlines() if l]
    assert lines[-5:] == ["t\tv", "1\t10", "2\t32", "count(1)\tsum(v)", "2\t42"]


def test_evqld_refuses_a_missing_card():
    """The default device (cuda) on a machine without a card ends the
    process with an error, not a CPU server."""
    r = subprocess.run(
        [sys.executable, "-m", "eventql_tpu_torch.cli.evqld",
         "--listen_http", "127.0.0.1:0", "--listen_native", "127.0.0.1:0"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=60)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "listening" not in r.stdout


@pytest.fixture(scope="module")
def zk_server():
    """The port's embedded ZooKeeper server."""
    srv = ZooKeeperServer().start()
    yield srv
    srv.stop()


def _registry(kind, tmp_path, zk_server):
    """(evqld's flags naming the registry, the registry's path) of a new
    cluster of replication factor 1."""
    if kind == "config_dir":
        path = str(tmp_path / "cluster.json")
        ConfigDirectory(path).cluster_create("c", replication_factor=1)
        return ["--config_dir", path], path
    name = tmp_path.name[-20:].replace("-", "_")
    path = f"zk://{zk_server.address}/{name}"
    ConfigDirectory(path).cluster_create(name, replication_factor=1)
    if kind == "zookeeper_addr":
        return ["--zookeeper_addr", f"{zk_server.address}/{name}"], path
    return ["--config_dir", path], path  # zk:// in --config_dir


def _status(path, sid):
    return {s.server_id: (s.server_status, s.server_addr)
            for s in ConfigDirectory(path).list_servers()}.get(sid)


@pytest.mark.parametrize("kind", ["config_dir", "zookeeper_addr", "config_dir_zk"])
def test_evqld_starts_a_cluster_member(kind, tmp_path, zk_server):
    """With a registry (a file, ZooKeeper through --zookeeper_addr, or a
    zk:// --config_dir) and --server_name the process registers itself
    up at its address, runs the cluster's workers (it leads the one-node
    cluster), and SIGTERM marks it down before it exits."""
    flags, path = _registry(kind, tmp_path, zk_server)
    proc, port, lines = _start_evqld(*flags, "--server_name", "n1",
                                     "--datadir", str(tmp_path / "data"))
    try:
        assert _status(path, "n1") == ("SERVER_UP", f"127.0.0.1:{port}")
        assert _until(lambda: _leader(path) == "n1")
        _sql(port, "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));")
        rows = _sql(port, "cluster show servers;")["results"][0]["rows"]
        assert [r[:3] for r in rows] == [[f"127.0.0.1:{port}", "SERVER_UP",
                                          f"127.0.0.1:{port}"]]
        assert len(_sql(port, "describe partitions ev;")["results"][0]["rows"]) == 1
    finally:
        code = _stop(proc)
        if kind != "config_dir":
            reset_sessions()
    assert code == 0, "".join(lines)
    assert _status(path, "n1") == ("SERVER_DOWN", f"127.0.0.1:{port}")


def _leader(path):
    """The cluster's leader: the ZooKeeper leader node, or the name a file
    registry's leader wrote into the lock file beside it."""
    if path.startswith("zk://"):
        return ConfigDirectory(path).current_leader()
    try:
        with open(path + ".leader") as f:
            return f.read()
    except FileNotFoundError:
        return None


def _until(fn, deadline_s=30.0):
    end = time.monotonic() + deadline_s
    while not fn() and time.monotonic() < end:
        time.sleep(0.1)
    return fn()


def test_evqld_partition_split_threshold_rows_splits(tmp_path, zk_server):
    """--partition_split_threshold_rows reaches the leader's autosplit:
    rows inserted over HTTP past it split the partition (the one node is
    the least loaded server, so the split finalizes at once)."""
    flags, path = _registry("zookeeper_addr", tmp_path, zk_server)
    proc, port, lines = _start_evqld(*flags, "--server_name", "n1",
                                     "--partition_split_threshold_rows", "10")
    try:
        _sql(port, "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));")
        body = [{"table": "ev", "data": {"t": i, "v": i}} for i in range(40)]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/tables/insert",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 201
        assert _until(lambda: len(_sql(port, "describe partitions ev;")["results"][0]["rows"])
                      > 1), "".join(lines)
        assert _sql(port, "select count(1), sum(v) from ev;")["results"][0]["rows"] == [
            ["40", "780"]]
    finally:
        _stop(proc)
        reset_sessions()
    assert _status(path, "n1")[0] == "SERVER_DOWN"
