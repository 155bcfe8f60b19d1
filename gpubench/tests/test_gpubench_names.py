"""BENCHMARK.json keeps to its format's rules: names, units and texts
of the allowed characters and lengths, every entry's keys, and a file for
every configuration, traffic mix and metric. In it and in the test-only
fixtures, every table and column a query reads is its configuration's,
every query shape has one reference function, and every configuration
keeps its test sizes."""

import json
import os
import re

import pytest

from gpubench import harness
from gpubench.tests.tiny import BENCH_FILES

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and all(PATH.fullmatch(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_text(w) for w in bench["command"])
    assert bench["command"][1].startswith("gpubench/")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(bench, kind):
    for e in bench[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _text(e[k]), (e["name"], k)
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))


def test_configs_cells_and_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"])
        assert os.path.isfile(os.path.join(harness.HERE, "traffic", w["traffic"] + ".json"))
        used.add(w["config"])
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("gpubench/") and os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"][: -len(".json")] + ".py"))
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def _cells(bench_file):
    """Every cell of a benchmark file, at its full sizes."""
    return [harness.Cell(w["name"], bench=bench_file) for w in harness._json(bench_file)["workloads"]]


@pytest.mark.parametrize("bench_file", BENCH_FILES)
def test_reads_name_tables_and_columns_of_the_configuration(bench_file):
    for cell in _cells(bench_file):
        tables = {t: {c["name"] for c in cols} for t, cols in cell.config["tables"].items()}
        for q in cell.traffic["queries"]:
            if not isinstance(q["reads"], dict):
                assert q["table"] in tables, q["shape"]
            reads = harness.reads(q)
            assert reads and set(reads) <= set(tables), q["shape"]
            for t, cols in reads.items():
                assert cols and set(cols) <= tables[t] and len(cols) == len(set(cols)), (q["shape"], t)


@pytest.mark.parametrize("bench_file", BENCH_FILES)
def test_every_shape_has_one_reference_function(bench_file):
    root = os.path.dirname(bench_file)
    bench = harness._json(bench_file)
    for cell in _cells(bench_file):
        stem = os.path.join(root, bench["paths"][0], "reference", cell.workload["config"])
        common = harness._load(stem + ".py") if os.path.isfile(stem + ".py") else None
        for q in cell.traffic["queries"]:
            own = os.path.join(stem, q["shape"] + ".py")
            homes = [hasattr(common, q["shape"]),
                     os.path.isfile(own) and hasattr(harness._load(own), q["shape"])]
            assert homes.count(True) == 1, (cell.workload["name"], q["shape"], homes)


@pytest.mark.parametrize("bench_file", BENCH_FILES)
def test_every_configuration_keeps_its_test_sizes(bench_file):
    for cell in _cells(bench_file):
        sizes = cell.config["test_sizes"]
        assert sizes and all(isinstance(cell.config.get(k), int) and 0 < v <= cell.config[k]
                             for k, v in sizes.items()), sizes


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    layers = harness._json(os.path.join(harness.HERE, "layers.json"))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        reports = [m["name"] for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])


def test_a_full_check_fits_its_time(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
