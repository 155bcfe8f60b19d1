"""One run of one benchmark cell: generate the cell's tables from the seed,
load them into the port's query entry, warm up, send the cell's traffic
for a fixed window, check every answer against the plain reference and
reduce the records to the cell's metrics.

Everything particular to a configuration, a traffic mix or a metric is
found by name: ``configs/<config>.json`` and ``configs/<config>.py`` (its
generator), ``reference/<config>.py`` (one function per query shape) or
``reference/<config>/<shape>.py`` (a shape's function in a file of its own),
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` (one ``read(run)``
each). ``layers.json`` names each layer's modules, counters and kernels,
``peaks.json`` each card's peak bandwidth.

A traffic query's ``reads`` is a list of ``query["table"]``'s columns, or
a mapping from each table it reads to its columns. It reads every row of
those tables: its ``rows`` are their sum, its logical bytes each table's
rows times the narrowest widths of its columns. The reference function
gets the list form's one table as ``{column: tensor}``, and the mapping
form's tables as ``{table: {column: tensor}}``, the columns it names.
"""

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

from gpubench import compare, tracing, workload

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "eventql_tpu")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that no run may load, compared whole
    (``eventql_tpu_torch`` is not ``eventql_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _load(path):
    name = "gpubench_" + os.path.relpath(path, HERE).replace(os.sep, "_")[: -len(".py")]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


def _one(items, name, what):
    found = [x for x in items if x["name"] == name]
    if len(found) != 1:
        raise SystemExit(f"BENCHMARK.json has no single {what} named {name!r}")
    return found[0]


class Cell:
    """A workload of a benchmark file with its configuration, traffic,
    generator and references, found by name.

    The benchmark file is BENCHMARK.json unless ``bench`` names another
    (tests only). Its directory is the root that configuration files are
    named from, and its first ``paths`` entry holds ``traffic/`` and
    ``reference/``. The metric readers, ``layers.json`` and ``peaks.json``
    are always the harness's own."""

    def __init__(self, workload_name, sizes=None, bench=None):
        bench = bench or BENCHMARK
        root = os.path.dirname(os.path.abspath(bench))
        self.bench = _json(bench)
        home = os.path.join(root, self.bench["paths"][0])
        self.workload = _one(self.bench["workloads"], workload_name, "workload")
        entry = _one(self.bench["configs"], self.workload["config"], "config")
        path = os.path.join(root, entry["file"])
        self.config = dict(_json(path), **(sizes or {}))
        self.generator = _load(path[: -len(".json")] + ".py")
        self.traffic = _json(os.path.join(home, "traffic", self.workload["traffic"] + ".json"))
        self.references = references(os.path.join(home, "reference", entry["name"]),
                                     [q["shape"] for q in self.traffic["queries"]])
        self.layers = _json(os.path.join(HERE, "layers.json"))

    def metrics(self, kind):
        name = self.workload["name"]
        return [m for m in self.bench[kind] if name in m.get("workloads", [name])]

    def generate(self, seed, device):
        """{table: {column: tensor}} on ``device``, in the configuration's
        column order."""
        tables = self.generator.generate(self.config, seed, device)
        return {t: {c["name"]: tables[t][c["name"]] for c in cols}
                for t, cols in self.config["tables"].items()}

    def dictionaries(self):
        return {c["name"]: list(c["values"])
                for cols in self.config["tables"].values() for c in cols if c["type"] == "STRING"}


def references(stem, shapes):
    """{shape: reference function}: the function named after the shape in
    ``<stem>.py``, or else in ``<stem>/<shape>.py``."""
    common = _load(stem + ".py") if os.path.isfile(stem + ".py") else None
    return {shape: getattr(common, shape, None) or getattr(_load(os.path.join(stem, shape + ".py")), shape)
            for shape in shapes}


def reads(query):
    """{table: [column]} that a traffic query reads."""
    r = query["reads"]
    return r if isinstance(r, dict) else {query["table"]: r}


def count_reads(instances, summary, table_rows):
    """Set each instance's ``rows`` (the rows of every table it reads) and
    ``read_bytes`` (each table's rows times the narrowest widths that hold
    its columns' generated spans)."""
    widths = {k: _width(lo, hi) for k, (lo, hi, _) in summary.items()}
    for inst in instances:
        r = reads(inst["query"])
        inst["rows"] = sum(table_rows[t] for t in r)
        inst["read_bytes"] = sum(table_rows[t] * sum(widths[(t, c)] for c in cols)
                                 for t, cols in r.items())


def summarize(tables):
    """(min, max, checksum) of every column, as Python ints."""
    import torch

    out = {}
    for t, cols in tables.items():
        for name, v in cols.items():
            v64 = v.to(torch.int64)
            out[(t, name)] = (int(v64.min()), int(v64.max()),
                              int((v64 * 0x9E37 + (v64 >> 17)).sum()))
    return out


def _width(lo, hi):
    span = hi - lo
    return next(b for b in (1, 2, 4, 8) if span < 1 << (8 * b))


def relations(cell, tables):
    """Copy the tables to host numpy and build the port's Relations."""
    import numpy as np
    from eventql_tpu_torch.core.types import SType
    from eventql_tpu_torch.exec.relation import relation_from_numpy

    out = {}
    for t, specs in cell.config["tables"].items():
        names, cols = [], []
        for spec in specs:
            data = tables[t][spec["name"]].cpu().numpy()
            valid = np.ones(len(data), dtype=bool)
            if spec["type"] == "STRING":
                words = np.array([v.encode() for v in spec["values"]], dtype=object)
                cols.append((SType.STRING, data.astype(np.int32, copy=False), valid, words))
            else:
                cols.append((SType[spec["type"]], data.view(np.uint64), valid, None))
            names.append(spec["name"])
        out[t] = relation_from_numpy(names, cols)
    return out


def _counter_names(layers):
    return [c for layer in layers.values() for c in layer.get("counters", [])]


def read_counters(names):
    """Current values of "module:attribute" counters (a dict attribute gives
    one entry a key); a module or attribute that is not there is left out."""
    out = {}
    for full in names:
        mod_name, attr = full.split(":")
        mod = sys.modules.get(mod_name)
        value = getattr(mod, attr, None) if mod is not None else None
        if isinstance(value, dict):
            out.update({f"{full}[{k}]": v for k, v in value.items()})
        elif isinstance(value, (int, float)):
            out[full] = value
    return out


def _power_limit():
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(workload_name, seed, seconds, trace, t_start, device="cuda", sizes=None, bench=None):
    """One run of a cell; returns the result line as a dict. ``device="cpu"``
    (tests only) runs the port's plain PyTorch route on the CPU; ``bench``
    (tests only) names another benchmark file than BENCHMARK.json."""
    import torch
    from eventql_tpu_torch.exec.runtime import PlanCache, RelationTableProvider, Runtime

    cell = Cell(workload_name, sizes, bench)
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    tables = cell.generate(seed, device)
    summary = summarize(tables)
    rels = relations(cell, tables)
    del tables
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    provider = RelationTableProvider()
    for name, rel in rels.items():
        provider.add_table(name, rel)
    table_rows = {name: rel.num_rows for name, rel in rels.items()}
    del rels
    rt = Runtime(plan_cache=PlanCache(), device=device)

    instances, order = workload.plan(cell.traffic, seed)
    count_reads(instances, summary, table_rows)

    span = tracing.annotate if trace else (lambda name: contextlib.nullcontext())

    def one(inst):
        shape = inst["shape"]
        t0 = time.perf_counter()
        with span(shape + "/plan"):
            plan = rt.build_query_plan(rt.new_transaction(provider), inst["sql"])
        t1 = time.perf_counter()
        with span(shape + "/execute"):
            res = plan.execute(0)
            sync()
        with span(shape + "/emit"):
            rows = res.rows
        return rows, t1 - t0, time.perf_counter() - t0

    # warm-up: every text once, which uploads the columns and fills the plan cache
    t0 = time.perf_counter()
    for inst in instances:
        one(inst)
    first_pass_s = time.perf_counter() - t0
    log(f"gpubench: warm-up pass {first_pass_s:.3f} s over {len(instances)} texts")

    names = _counter_names(cell.layers)
    before = read_counters(names)
    prof = tracing.profiler() if trace else None
    if prof is not None:
        prof.__enter__()
    queries, failed, first_error = [], 0, None
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    deadline = t_window + seconds
    with span("window"):
        while time.perf_counter() < deadline:
            i = next(order)
            inst = instances[i]
            try:
                rows, plan_s, latency_s = one(inst)
            except Exception as e:  # a query that fails counts as failed; the run goes on
                failed += 1
                first_error = first_error or f"{inst['shape']}: {type(e).__name__}: {e}"
                continue
            queries.append({"instance": i, "shape": inst["shape"], "latency_s": latency_s,
                            "plan_s": plan_s, "rows": inst["rows"],
                            "bytes": inst["read_bytes"] + 8 * sum(len(r) for r in rows),
                            "answer": rows})
    window_s = time.perf_counter() - t_window
    if prof is not None:
        prof.__exit__(None, None, None)
    after = read_counters(names)
    counters = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    attempted = len(queries) + failed
    log(f"gpubench: window {window_s:.3f} s, {attempted} queries sent, {failed} failed")
    if first_error:
        log(f"gpubench: first failure: {first_error}")
    log("gpubench: counters " + json.dumps(counters, sort_keys=True))
    if on_card:
        log(f"gpubench: card {_power_limit()}")

    trace_data = None
    if prof is not None:
        t0 = time.perf_counter()
        trace_data = tracing.read(prof)
        del prof
        log(f"gpubench: trace read in {time.perf_counter() - t0:.1f} s: "
            f"{len(trace_data.device)} device events, busy {trace_data.busy_s:.4f} s "
            f"of {trace_data.window_s:.4f} s")

    # the program's state goes before the reference runs
    del rt, provider
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(cell, seed, device, instances, queries, summary)

    # what the metric readers see of the run
    run = types.SimpleNamespace(queries=queries, window_s=window_s, setup_s=setup_s,
                                first_pass_s=first_pass_s, peak_bytes=peak,
                                table_rows=sum(table_rows.values()), counters=counters,
                                layers=cell.layers, trace=trace_data,
                                peak_bandwidth=_json(os.path.join(HERE, "peaks.json")).get(kind, {}).get("hbm_bytes_per_s"))
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = _load(os.path.join(HERE, "metrics", m["name"] + ".py")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lat = sorted(q["latency_s"] for q in queries)
    if lat:
        log(f"gpubench: {len(lat)} latencies, median {1e3 * lat[len(lat) // 2]:.4f} ms, "
            f"max {1e3 * lat[-1]:.4f} ms; per shape: " + json.dumps(_by_shape(queries)))

    correct = (failed == 0 and len(queries) > 0
               and all(c["value"] is None or c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell.workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace_data is not None:
        dev["busy_s"] = trace_data.busy_s
        dev["window_s"] = trace_data.window_s
        result["breakdown"] = {"device_ops": trace_data.device_ops(), "idle_gaps": trace_data.idle_gaps()}
    result["checks"] = checks
    return result


def _by_shape(queries):
    by = {}
    for q in queries:
        by.setdefault(q["shape"], []).append(q["latency_s"])
    return {s: {"n": len(v), "mean_ms": 1e3 * sum(v) / len(v)} for s, v in sorted(by.items())}


def reference_input(tables, query):
    """What a query's reference function reads: the list form's one table,
    or the mapping form's tables with the columns it names."""
    r = query["reads"]
    if isinstance(r, dict):
        return {t: {c: tables[t][c] for c in cols} for t, cols in r.items()}
    return tables[query["table"]]


def reference_answers(cell, tables, instances, low=False):
    """The reference's groups for every instance (computed once a text)."""
    dicts = cell.dictionaries()
    return [cell.references[inst["shape"]](reference_input(tables, inst["query"]), dicts,
                                           inst["params"], low=low)
            for inst in instances]


def judge(instances, answers, expected):
    """Sum of mismatches and largest float gap of ``answers`` (pairs of
    instance index and printed rows) against ``expected``."""
    mismatches, gap, has_float = 0, 0.0, False
    for i, rows in answers:
        m, g = compare.compare(rows, expected[i], instances[i]["query"])
        mismatches += m
        if g is not None:
            has_float = True
            gap = max(gap, g)
    return mismatches, (gap if has_float else None)


def check(cell, seed, device, instances, queries, summary):
    """Regenerate the tables from the seed, run the reference and compare
    every answer of the window. Returns each compared number with its limit."""
    import torch

    t0 = time.perf_counter()
    tables = cell.generate(seed, device)
    same = summarize(tables) == summary
    expected = reference_answers(cell, tables, instances)
    del tables
    if device == "cuda":
        torch.cuda.empty_cache()
    mismatches, gap = judge(instances, [(q["instance"], q["answer"]) for q in queries], expected)
    if not same:
        log("gpubench: the regenerated tables differ from the ones the program was given")
        mismatches += 1
    limits = cell.traffic["checks"]
    # a gap of None: no float cell was among the answers
    checks = {"mismatches": {"value": mismatches, "limit": limits["mismatches"]}}
    if "mean_gap_e6" in limits:
        checks["mean_gap_e6"] = {"value": gap, "limit": limits["mean_gap_e6"]}
    log(f"gpubench: reference and comparison of {len(queries)} answers in {time.perf_counter() - t0:.1f} s")
    return checks


def main(argv, t_start):
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = Cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"gpubench: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        log(f"gpubench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
