"""The port's MapReduce tier against the JAX package's.

mapreduce/ (the service, the job-builder API, the distributed scheduler,
the JS runtime and its ES5 interpreter js/) and columnar/sstable.py are
copies of the JAX package's files with their imports renamed
(tests/test_torch_storage.py holds each to its original). Here:

- every case of tests/test_js.py and tests/test_js_conformance.py runs
  against the port's interpreter: each of those modules is loaded a
  second time with ``eventql_tpu`` renamed to ``eventql_tpu_torch`` and
  its test functions, parameters included, are collected here under a
  ``test_port_`` name; and every program of their parameter tables runs
  through both interpreters, which must give the same value or the same
  error text;
- sstable files: both writers give the same bytes, each reader reads the
  other's file;
- tests/test_mapreduce.py's jobs (Python and JavaScript functions, the
  job-builder API, save_to_table) through both services: the same pairs;
- the distributed scheduler over two cluster members of each package on
  the CPU: the same pairs, map shards on the partition owners, failover;
- the HTTP routes of both servers are in tests/test_torch_server.py.
"""

import importlib
import importlib.util
import json
import math
import os
import re
import struct
import sys
import types
import urllib.request
from types import SimpleNamespace
from urllib.parse import unquote, urlencode

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))


# -- the JS interpreter: the JAX package's JS tests on the port ---------------


def _port_twin(name):
    """tests/<name>.py loaded with its imports renamed to the port."""
    path = os.path.join(TESTS, name + ".py")
    with open(path, encoding="utf-8") as f:
        src = re.sub(r"\beventql_tpu\b", "eventql_tpu_torch", f.read())
    mod = types.ModuleType(f"_port_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102
    assert "eventql_tpu." not in src.replace("eventql_tpu_torch.", "")
    return mod


def _original(name):
    """tests/<name>.py as it is (the JAX package's test module)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(TESTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JS_MODULES = ("test_js", "test_js_conformance")
_TWINS = {name: _port_twin(name) for name in _JS_MODULES}
for _name, _mod in _TWINS.items():
    for _fn_name, _fn in list(vars(_mod).items()):
        if _fn_name.startswith("test_") and callable(_fn):
            globals()[f"test_port_{_name[len('test_'):]}__{_fn_name[len('test_'):]}"] = _fn


def test_every_js_test_has_a_port_case():
    jax = {n: _original(n) for n in _JS_MODULES}
    for name in _JS_MODULES:
        want = sorted(k for k, v in vars(jax[name]).items()
                      if k.startswith("test_") and callable(v))
        prefix = f"test_port_{name[len('test_'):]}__"
        got = sorted("test_" + k[len(prefix):] for k in globals() if k.startswith(prefix))
        assert got == want and len(want) > 10


def _table_programs():
    """Every ``src`` of the parameter tables of the JAX JS tests."""
    out = []
    for name in _JS_MODULES:
        mod = _original(name)
        for fn_name, fn in sorted(vars(mod).items()):
            for mark in getattr(fn, "pytestmark", []):
                if mark.name != "parametrize" or not mark.args[0].startswith("src"):
                    continue
                for case in mark.args[1]:
                    out.append((f"{name}.{fn_name}", case[0] if isinstance(case, tuple) else case))
    return out


_PROGRAMS = _table_programs()


def _run_js(root, src):
    interp = importlib.import_module(f"{root}.mapreduce.js.interp")
    lexer = importlib.import_module(f"{root}.mapreduce.js.lexer")
    try:
        v = interp.js_to_python(interp.Interpreter().run(src))
    except (interp.JSError, lexer.JSSyntaxError) as e:
        return ("error", type(e).__name__, str(e))
    if isinstance(v, float) and math.isnan(v):
        return ("value", "NaN")
    return ("value", repr(v))


@pytest.mark.parametrize("where,src", _PROGRAMS, ids=[f"{w}-{i}" for i, (w, _s) in
                                                        enumerate(_PROGRAMS)])
def test_js_programs_give_the_same_value_through_both_interpreters(where, src):
    assert _run_js("eventql_tpu_torch", src) == _run_js("eventql_tpu", src)


@pytest.mark.parametrize("src", [
    "throw new TypeError('bad ' + 1);",
    "var x = ;",
    "undefined_function_here();",
    "null.x;",
    "JSON.parse('{bad');",
    "new Array(-1);",
    "'abc'.repeat(2);",
])
def test_js_errors_have_the_same_text(src):
    got, want = _run_js("eventql_tpu_torch", src), _run_js("eventql_tpu", src)
    assert got == want


def test_js_runtime_task_contexts_agree():
    """The map / reduce adapters and the job context of both runtimes over
    the same functions and rows."""
    def case(root):
        rt = importlib.import_module(f"{root}.mapreduce.js_runtime")
        m = rt.js_map_adapter("function(row) { return [[row.k, row.v * 2], ['n', 1]]; }",
                              "", "")
        r = rt.js_reduce_adapter(
            "function(key, values) { var s = 0; while (values.hasNext())"
            " { s += parseInt(values.next(), 10); } return [[key, s]]; }", "", "")
        mapped = [m({"k": f"k{i % 3}", "v": i}) for i in range(7)]
        return mapped, r("k1", iter(["3", "4", "10"]))

    assert case("eventql_tpu_torch") == case("eventql_tpu")


# -- sstable ------------------------------------------------------------------

JAX_SST = importlib.import_module("eventql_tpu.columnar.sstable")
PORT_SST = importlib.import_module("eventql_tpu_torch.columnar.sstable")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(int(rng.integers(0, 40))), rng.bytes(int(rng.integers(0, 300))))
            for _ in range(n)]


@pytest.mark.parametrize("n,userdata", [(0, b""), (1, b"meta"), (257, b"x" * 100), (3000, b"")])
def test_sstable_writers_give_the_same_bytes_and_read_each_other(tmp_path, n, userdata):
    rows = _rows(n, seed=n)
    paths = {}
    for mod, name in ((JAX_SST, "j.sst"), (PORT_SST, "p.sst")):
        w = mod.SSTableWriter(str(tmp_path / name), userdata=userdata)
        for k, v in rows:
            w.append(k, v)
        w.finalize()
        paths[mod] = str(tmp_path / name)
    assert open(paths[PORT_SST], "rb").read() == open(paths[JAX_SST], "rb").read()
    for reader, path in ((PORT_SST, paths[JAX_SST]), (JAX_SST, paths[PORT_SST])):
        r = reader.SSTableReader(path)
        assert (r.finalized, r.num_rows, r.userdata, r.rows()) == (True, n, userdata, rows)


def test_sstable_corruption_raises_the_same_error(tmp_path):
    path = str(tmp_path / "t.sst")
    w = PORT_SST.SSTableWriter(path)
    w.append(b"key", b"data")
    w.finalize()
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    errors = []
    for mod in (JAX_SST, PORT_SST):
        with pytest.raises(Exception) as e:
            mod.SSTableReader(path).rows()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "row checksum" in errors[0]


# -- the service: tests/test_mapreduce.py's jobs through both packages ----------


def package(root):
    ns = SimpleNamespace(root=root)
    for mod in ("core.types", "db.table_service", "exec.runtime", "mapreduce.service",
                "mapreduce.api", "plan.nodes", "server.http_api", "server.native_tcp",
                "server.listener", "config.config_directory", "db.metadata",
                "parallel.cluster"):
        setattr(ns, mod.split(".")[1], importlib.import_module(f"{root}.{mod}"))
    ns.device = {} if root == "eventql_tpu" else {"device": "cpu"}
    return ns


JAX = package("eventql_tpu")
PORT = package("eventql_tpu_torch")
MR = _original("test_mapreduce")
MRD = _original("test_mapreduce_distributed")


def _events(pkg):
    """tests/test_mapreduce.py's ``events`` table."""
    ts = pkg.table_service.TableService()
    cd = pkg.nodes.ColumnDefinition
    ts.create_table(pkg.nodes.CreateTableNode(
        "events", [cd("id", "UINT64"), cd("user", "STRING"), cd("value", "UINT64")],
        ["id"], None, []))
    SV = pkg.types.SValue
    for i, (user, value) in enumerate([("a", 1), ("b", 2), ("a", 3), ("c", 4), ("b", 5),
                                       ("a", 6)]):
        ts.insert("events", ["id", "user", "value"],
                  [SV.new_uint64(i), SV.new_string(user), SV.new_uint64(value)])
    return ts


def _sql(pkg, provider, query):
    rt = pkg.runtime.Runtime(**pkg.device)
    return rt.build_query_plan(rt.new_transaction(provider), query).execute(0).rows


def _job(map_fn, reduce_fn=None, shards=1, terminal="return_results", table="events"):
    jobs = {"m": {"op": "map_table", "table": table, "map_fn": map_fn}}
    src = "m"
    if reduce_fn is not None:
        jobs["r"] = {"op": "reduce", "sources": ["m"], "reduce_fn": reduce_fn,
                     "num_shards": shards}
        src = "r"
    if terminal == "return_results":
        jobs["out"] = {"op": "return_results", "sources": [src]}
    else:
        jobs["out"] = {"op": "save_to_table", "sources": [src], "table": terminal}
    return {"jobs": jobs, "execute": ["out"]}


def _api(pkg, svc):
    evql = pkg.api.EVQL(pkg.service.MapReduceService(svc))
    r = evql.reduce(sources=[evql.map_table(table="events", map_fn=MR.MAP_FN)],
                    reduce_fn=MR.REDUCE_FN)
    return sorted(evql.download_results([r])[0])


def _api_join(pkg, svc):
    evql = pkg.api.EVQL(pkg.service.MapReduceService(svc))
    m1 = evql.map_table(table="events", map_fn=(
        "def map_a(row):\n    import json\n"
        "    return [(row['user'], json.dumps({'v': int(row['value'])}))]\n"))
    m2 = evql.map_table(table="events", map_fn=(
        "def map_b(row):\n    import json\n"
        "    return [(row['user'], json.dumps({'u': row['user']}))]\n"))
    return sorted(evql.download_results([evql.join(sources=[m1, m2])])[0])


def _api_save(pkg, svc):
    evql = pkg.api.EVQL(pkg.service.MapReduceService(svc))
    r = evql.reduce(sources=[evql.map_table(table="events", map_fn=MR.MAP_FN)],
                    reduce_fn=MR.REDUCE_FN)
    evql.save_to_table("evql_api_out", [r])
    return _sql(pkg, svc, "select `key`, `value` from evql_api_out order by `key`;")


def _script(program):
    def run(pkg, svc):
        results, logs = pkg.service.MapReduceService(svc).execute_script(program)
        return sorted(results), logs
    return run


def _execute(spec, query=None):
    def run(pkg, svc):
        out = [sorted(o) for o in pkg.service.MapReduceService(svc).execute(spec)]
        return out, (_sql(pkg, svc, query) if query else None)
    return run


_JS_SAVE = """
var m = EVQL.mapTable({
  table: "events",
  map_fn: function(row) { return [[row.user, row.value]]; },
});
EVQL.saveToTable({table: "js_mr_out", sources: [m]});
"""

SERVICE_CASES = {
    "pipeline": _execute(_job(MR.MAP_FN, MR.REDUCE_FN, shards=4)),
    "save_to_table": _execute(_job(MR.MAP_FN, MR.REDUCE_FN, terminal="user_totals"),
                              "select `key`, `value` from user_totals order by `key`;"),
    "lambdas": _execute(_job('lambda row: [("n", 1)]',
                             "lambda k, vs: [(k, sum(int(v) for v in vs))]")),
    "map_only": _execute(_job(MR.MAP_FN)),
    "api": _api,
    "api_join": _api_join,
    "api_save": _api_save,
    "js_program": _script(MR.JS_PROGRAM),
    "js_broadcast": _script("""
    var factor = 100;
    EVQL.broadcast("factor");
    function weight(v) { return v * factor; }
    var m = EVQL.mapTable({table: "events", map_fn: function(row) {
        return [[row.user, weight(parseInt(row.value, 10))]]; }});
    EVQL.downloadResults([m]);
    """),
    "js_serialize": _script("""
    var m = EVQL.mapTable({table: "events", map_fn: function(row) { return [[row.user, 1]]; }});
    EVQL.downloadResults([m], function(key, value) {
      if (key == "c") return "";
      return key + "=" + value;
    });
    """),
    "js_join": _script("""
    var m1 = EVQL.mapTable({table: "events", map_fn: function(row) {
        return [[row.user, {v: parseInt(row.value, 10)}]]; }});
    var m2 = EVQL.mapTable({table: "events", map_fn: function(row) {
        return [[row.user, {u: row.user}]]; }});
    var j = EVQL.join({sources: [m1, m2], shards: 1, map_fn: function(joined) {
        return [[joined.u, joined.v]]; }});
    EVQL.downloadResults([j]);
    """),
    "js_save": lambda pkg, svc: (_script(_JS_SAVE)(pkg, svc), _sql(
        pkg, svc, "select `key`, `value` from js_mr_out order by `key`, `value`;")),
    "js_logging": _script("""
    EVQL.log("starting", 42);
    console.log("via console");
    var m = EVQL.mapTable({table: "events", map_fn: function(row) { return []; }});
    EVQL.downloadResults([m]);
    """),
    "js_error": lambda pkg, svc: _error_text(lambda: _script(
        "var m = EVQL.mapTable({table: 'events', map_fn: function(row) {"
        " return row.nope.x; }}); EVQL.downloadResults([m]);")(pkg, svc)),
    "unknown_table": lambda pkg, svc: _error_text(lambda: _execute(
        _job(MR.MAP_FN, table="missing"))(pkg, svc)),
    "bad_python": lambda pkg, svc: _error_text(lambda: _execute(
        _job("def broken(:\n"))(pkg, svc)),
}


def _error_text(fn):
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 - the text is what is compared
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("case", list(SERVICE_CASES))
def test_mapreduce_jobs_give_the_same_pairs_through_both_services(case):
    want = SERVICE_CASES[case](JAX, _events(JAX))
    got = SERVICE_CASES[case](PORT, _events(PORT))
    assert got == want
    assert want not in ([], [[]], ("value", []))


def test_mapreduce_spills_to_sstable_alike(tmp_path):
    """spill_dir: the same result files (a random suffix to each name),
    byte for byte."""
    outs = []
    for pkg in (JAX, PORT):
        spill = tmp_path / pkg.root
        mr = pkg.service.MapReduceService(_events(pkg), spill_dir=str(spill))
        result = mr.execute(_job(MR.MAP_FN, MR.REDUCE_FN, shards=2))
        files = sorted(os.listdir(spill))
        outs.append((sorted(result[0]), [f.rsplit("-", 1)[0] for f in files],
                     [open(spill / f, "rb").read() for f in files]))
    assert outs[0] == outs[1] and len(outs[0][1]) >= 2


# -- the distributed scheduler over cluster members ----------------------------


def _cluster(pkg, tmp_path, n_nodes=2):
    """n_nodes members (HTTP + native on one sniffed port, a MapReduce
    cache each) of a file registry with replication factor 2, as
    tests/test_mapreduce_distributed.py's fixture builds them."""
    cfg = str(tmp_path / f"{pkg.root}.json")
    cdir = pkg.config_directory.ConfigDirectory(cfg)
    cdir.cluster_create("test", replication_factor=2)

    def provider():
        return pkg.cluster.cluster_provider_from_config(cfg)

    nodes = []
    for i in range(n_nodes):
        svc = pkg.table_service.TableService()
        cachedir = str(tmp_path / f"{pkg.root}-cache{i + 1}")
        http = pkg.http_api.EventQLServer(table_service=svc, query_provider_factory=provider,
                                          mr_cachedir=cachedir, **pkg.device)
        http.start(bind=False)
        native = pkg.native_tcp.NativeTCPServer(svc, port=0, query_provider_factory=provider,
                                                **pkg.device).start()
        listener = pkg.listener.Listener(http, native, port=0).start()
        cdir.update_server_config(pkg.config_directory.ServerConfig(
            f"node{i + 1}", f"127.0.0.1:{listener.port}", pkg.config_directory.SERVER_UP))
        nodes.append(dict(id=f"node{i + 1}", svc=svc, http=http, native=native,
                          listener=listener, cachedir=cachedir))
    return cfg, cdir, nodes


def _stop(nodes):
    for n in nodes:
        n["listener"].stop()
        n["native"].stop()
        n["http"].stop()


def _split_table(pkg, cfg, cdir, rows=24):
    """tests/test_mapreduce_distributed.py's table: two partitions."""
    p = pkg.cluster.cluster_provider_from_config(cfg)
    _sql(pkg, p, "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));")
    meta = pkg.metadata.TableMetadata.from_json(cdir.get_table_config("default", "ev")["metadata"])
    meta.split(meta.entries[0].partition_id, rows // 2)
    cdir.update_table_config("default", "ev", {"metadata": meta.to_json()})
    p2 = pkg.cluster.cluster_provider_from_config(cfg)
    for i in range(rows):
        p2.insert_json("ev", json.dumps({"t": i, "v": i % 5}))
    p.close()
    p2.close()


def _post(addr, path, body, raw=False):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{addr}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read().decode()


def _sse_results(text):
    out = []
    for block in text.split("\n\n"):
        lines = block.strip().split("\n")
        if len(lines) >= 2 and lines[0] == "event: result":
            r = json.loads(unquote(lines[1][len("data: "):]))
            out.append((r["key"], r["value"]))
    return sorted(out)


def _addr(node):
    return f"127.0.0.1:{node['listener'].port}"


def _dist_job(pkg, cfg, cdir, nodes):
    status, body = _post(_addr(nodes[0]), "/api/v1/mapreduce/execute", MRD.JOB)
    return status, sorted((r["key"], r["value"]) for r in json.loads(body)["results"][0])


def _dist_js(pkg, cfg, cdir, nodes):
    program = """
var mapped = EVQL.mapTable({table: "ev", map_fn: function(row) { return [[row.v, 1]]; }});
var reduced = EVQL.reduce({sources: [mapped], shards: 2, reduce_fn: function(key, values) {
    var sum = 0;
    while (values.hasNext()) { sum += Number(values.next()); }
    return [[key, sum]];
}});
EVQL.downloadResults([reduced]);
"""
    status, body = _post(_addr(nodes[0]), "/api/v1/mapreduce/execute", program.encode(),
                         raw=True)
    return status, _sse_results(body)


def _dist_scheduler(pkg, cfg, cdir, nodes):
    """The scheduler driven in process over the registry, a map-only job:
    one pair a row, the shards cached on the partition owners only."""
    sched = importlib.import_module(f"{pkg.root}.mapreduce.distributed")
    provider = pkg.cluster.cluster_provider_from_config(cfg)
    try:
        out = sched.DistributedMapReduceScheduler(provider).execute(
            {"jobs": {"m": {"op": "map_table", "table": "ev", "map_fn": MRD.MAP_FN},
                      "out": {"op": "return_results", "sources": ["m"]}},
             "execute": ["out"]})
    finally:
        provider.close()
    meta = pkg.metadata.TableMetadata.from_json(cdir.get_table_config("default", "ev")["metadata"])
    owners = {s for e in meta.entries for s in e.servers}
    cached_on = {n["id"] for n in nodes if os.path.isdir(n["cachedir"]) and any(
        f.startswith("mr-shard-") for f in os.listdir(n["cachedir"]))}
    return sorted(out[0]), bool(cached_on) and cached_on <= owners


def _dist_sample(pkg, cfg, cdir, nodes):
    """One map_partition task on an owner, its result through the result
    route whole and in two samples."""
    meta = pkg.metadata.TableMetadata.from_json(cdir.get_table_config("default", "ev")["metadata"])
    entry = meta.entries[0]
    owner = next(n for n in nodes if n["id"] == entry.servers[0])
    _status, text = _post(_addr(owner), "/api/v1/mapreduce/tasks/map_partition", urlencode(
        [("table", "ev"), ("partition", entry.partition_id),
         ("map_function", MRD.MAP_FN)]).encode(), raw=True)
    rid = next(b.split("data:")[1].strip() for b in text.split("\n\n") if "result_id" in b)
    got = []
    for sample in ("", "?sample=2:0", "?sample=2:1"):
        with urllib.request.urlopen(
                f"http://{_addr(owner)}/api/v1/mapreduce/result/{rid}{sample}", timeout=60) as r:
            got.append(r.read())
    return got


def _dist_save(pkg, cfg, cdir, nodes):
    job = _job(MRD.MAP_FN, MRD.REDUCE_FN, terminal="mr_out", table="ev")
    status, _body = _post(_addr(nodes[0]), "/api/v1/mapreduce/execute", job)
    p = pkg.cluster.cluster_provider_from_config(cfg)
    try:
        return status, _sql(pkg, p, "select `key`, `value` from mr_out order by `key`;")
    finally:
        p.close()


def _dist_failover(pkg, cfg, cdir, nodes):
    """The first replica of the first partition stopped and marked down:
    the job fails over to the other replica."""
    meta = pkg.metadata.TableMetadata.from_json(cdir.get_table_config("default", "ev")["metadata"])
    down = meta.entries[0].servers[0]
    for n in nodes:
        if n["id"] == down:
            n["listener"].stop()
            n["native"].stop()
            cdir.update_server_config(pkg.config_directory.ServerConfig(
                n["id"], "127.0.0.1:1", pkg.config_directory.SERVER_DOWN))
    live = next(n for n in nodes if n["id"] != down)
    status, body = _post(_addr(live), "/api/v1/mapreduce/execute", MRD.JOB)
    return status, sorted((r["key"], r["value"]) for r in json.loads(body)["results"][0])


DIST_CASES = {"json_job": _dist_job, "js_program": _dist_js, "scheduler": _dist_scheduler,
              "result_samples": _dist_sample, "save_to_table": _dist_save,
              "failover": _dist_failover}
_COUNTS = sorted((str(k), str(sum(1 for i in range(24) if i % 5 == k))) for k in range(5))


@pytest.mark.parametrize("case", list(DIST_CASES))
def test_distributed_scheduler_over_two_members_of_each_package(tmp_path, case):
    outs = []
    for pkg in (JAX, PORT):
        cfg, cdir, nodes = _cluster(pkg, tmp_path)
        try:
            _split_table(pkg, cfg, cdir)
            outs.append(DIST_CASES[case](pkg, cfg, cdir, nodes))
        finally:
            _stop(nodes)
    assert outs[1] == outs[0]
    if case in ("json_job", "failover"):
        assert outs[1] == (200, _COUNTS)
    if case == "js_program":
        assert outs[1] == (200, sorted((k, str(int(v))) for k, v in _COUNTS))


class _SplitsAfterPlanning:
    """A cluster provider whose table's first partition splits into two
    new partitions just after the scheduler has read the metadata, as an
    autosplit pass that finalizes while a job runs."""

    def __init__(self, pkg, provider, cdir):
        self._pkg, self._provider, self._cdir, self._split = pkg, provider, cdir, False

    def __getattr__(self, name):
        return getattr(self._provider, name)

    def _table_metadata(self, table):
        meta = self._provider._table_metadata(table)
        if not self._split:
            self._split = True
            now = self._pkg.metadata.TableMetadata.from_json(meta.to_json())
            first = now.entries[0]
            Entry = self._pkg.metadata.PartitionMapEntry
            now.entries[:1] = [Entry(first.begin, "low" + first.partition_id[3:], first.servers),
                               Entry(6, "high" + first.partition_id[4:], first.servers)]
            self._cdir.update_table_config("default", table, {"metadata": now.to_json()})
        return meta


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_distributed_map_shard_of_a_partition_that_split_meanwhile(tmp_path, pkg):
    """Every replica fails the shard of a partition that is gone from the
    metadata. The port maps the partitions that now cover its keyrange and
    keeps every row; the JAX scheduler tolerates the shard as failed and
    loses the partition's rows."""
    sched = importlib.import_module(f"{pkg.root}.mapreduce.distributed")
    cfg, cdir, nodes = _cluster(pkg, tmp_path)
    try:
        _split_table(pkg, cfg, cdir)
        provider = pkg.cluster.cluster_provider_from_config(cfg)
        logs = []
        try:
            out = sched.DistributedMapReduceScheduler(
                _SplitsAfterPlanning(pkg, provider, cdir), on_log=logs.append).execute(
                {"jobs": {"m": {"op": "map_table", "table": "ev", "map_fn": MRD.MAP_FN},
                          "out": {"op": "return_results", "sources": ["m"]}},
                 "execute": ["out"]})
        finally:
            provider.close()
    finally:
        _stop(nodes)
    assert any("failed on every replica" in line for line in logs)
    rows = range(24) if pkg is PORT else range(12, 24)  # the first partition holds 0..11
    assert sorted(out[0]) == sorted((str(i % 5), "1") for i in rows)
