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
import subprocess
import sys
import threading
import urllib.request

import pytest

from eventql_tpu.cli import console as jax_console
from eventql_tpu.server.http_api import EventQLServer as JaxServer
from eventql_tpu_torch.cli import evqld as port_evqld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.fixture(scope="module")
def evqld():
    """The port's server on free ports; yields its HTTP port."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "eventql_tpu_torch.cli.evqld", "--device", "cpu",
         "--listen_http", "127.0.0.1:0", "--listen_native", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(), cwd=REPO, text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        port = None
        for _ in range(600):  # 60 s
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", "".join(lines))
            if m:
                port = int(m.group(1))
                break
            if proc.poll() is not None:
                break
            reader.join(timeout=0.1)
        assert port is not None, "evqld did not start: " + "".join(lines)
        yield port
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


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


def test_evqld_refuses_what_is_not_ported_and_a_missing_card():
    """--config_dir names the missing modules; the default device
    (cuda) on a machine without a card ends the process with an error,
    not a CPU server."""
    r = subprocess.run(
        [sys.executable, "-m", "eventql_tpu_torch.cli.evqld", "--config_dir", "c.cfg"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=60)
    assert r.returncode != 0 and "not ported to eventql_tpu_torch yet: config/" in r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "eventql_tpu_torch.cli.evqld",
         "--listen_http", "127.0.0.1:0", "--listen_native", "127.0.0.1:0"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=60)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "listening" not in r.stdout


@pytest.mark.parametrize("flag", [("--server_name", "n1"), ("--zookeeper_addr", "zk:2181"),
                                  ("--partition_split_threshold_rows", "1000")])
def test_evqld_refuses_cluster_flags_by_name(flag, capsys):
    """A flag that takes effect only in a cluster (autosplit, the node's
    cluster id, the coordination service) is refused by its name before
    any server starts, never accepted and ignored."""
    with pytest.raises(SystemExit) as e:
        port_evqld.main(["--device", "cpu", *flag])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert f"{flag[0]}: not ported to eventql_tpu_torch yet" in err and "autosplit" in err
