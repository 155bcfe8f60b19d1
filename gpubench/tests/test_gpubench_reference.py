"""Each reference function agrees with the port's Runtime(device="cpu") on
every query of every cell, and a run of each cell on the CPU comes out
correct. A query's rows and logical bytes count every table it reads;
for the one-table cells they and the reference's answers are what the
one-table formula gives."""

import os
import time

import pytest

from gpubench import compare, harness, workload
from gpubench.tests.tiny import ALL_CELLS, CELLS, sizes

SEED = 2**31 + 23
JOIN = os.path.join(os.path.dirname(__file__), "fixtures", "two_tables", "bench.json")
ONE_TABLE = [c for c in CELLS if not any(isinstance(q["reads"], dict) for q in harness.Cell(c).traffic["queries"])]


@pytest.mark.parametrize("bench, cell_name", ALL_CELLS)
def test_reference_agrees_with_the_port_on_every_query(bench, cell_name):
    from eventql_tpu_torch.exec.runtime import PlanCache, RelationTableProvider, Runtime

    cell = harness.Cell(cell_name, sizes=sizes(cell_name, bench), bench=bench)
    tables = cell.generate(SEED, "cpu")
    provider = RelationTableProvider()
    for name, rel in harness.relations(cell, tables).items():
        provider.add_table(name, rel)
    rt = Runtime(plan_cache=PlanCache(), device="cpu")
    instances, _ = workload.plan(cell.traffic, SEED)
    expected = harness.reference_answers(cell, tables, instances)
    assert len(instances) == cell.traffic["parameter_sets"] * len(cell.traffic["queries"])
    for inst, ref in zip(instances, expected):
        rows = rt.build_query_plan(rt.new_transaction(provider), inst["sql"]).execute(0).rows
        mismatches, gap = compare.compare(rows, ref, inst["query"])
        assert mismatches == 0, (inst["sql"], rows[:3], ref[:3])
        assert gap is None or gap <= 0.5 + 1e-3, inst["sql"]
        assert rows, inst["sql"]


@pytest.mark.parametrize("bench, cell_name", ALL_CELLS)
def test_a_cpu_run_is_correct_and_routed(bench, cell_name):
    result = harness.run_cell(cell_name, SEED, 0.3, False, time.perf_counter(),
                              device="cpu", sizes=sizes(cell_name, bench), bench=bench)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in harness.Cell(cell_name, bench=bench).metrics("end_to_end")}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"


def test_the_traced_cpu_run_reads_the_route_counters():
    result = harness.run_cell("tpch_q6", SEED, 0.3, True, time.perf_counter(),
                              device="cpu", sizes=sizes("tpch_q6"))
    assert result["correct"]
    assert result["metrics"]["device_route_share"]["value"] == 100.0
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result


def test_the_join_fixture_takes_the_join_route():
    from eventql_tpu_torch.exec import device_exec

    before = device_exec.JOIN_GROUPBY_COUNT
    result = harness.run_cell("facts_join", SEED, 0.3, True, time.perf_counter(), device="cpu",
                              sizes=sizes("facts_join", JOIN), bench=JOIN)
    assert result["correct"], result["checks"]
    assert result["metrics"]["device_route_share"]["value"] == 100.0
    # the warm-up pass's eight texts and every query of the window
    assert device_exec.JOIN_GROUPBY_COUNT - before == 8 + result["attempted"]


def _narrowest(v):
    span = int(v.max()) - int(v.min())
    return 1 if span < 2**8 else 2 if span < 2**16 else 4 if span < 2**32 else 8


def _counted(cell, tables):
    instances, _ = workload.plan(cell.traffic, SEED)
    harness.count_reads(instances, harness.summarize(tables),
                        {t: next(iter(cols.values())).numel() for t, cols in tables.items()})
    return instances


def test_a_query_of_two_tables_counts_both():
    cell = harness.Cell("facts_join", sizes=sizes("facts_join", JOIN), bench=JOIN)
    tables = cell.generate(SEED, "cpu")
    facts, dims = tables["facts"], tables["dims"]
    n, d = facts["f_k"].numel(), dims["d_k"].numel()
    key_bytes = d * (_narrowest(dims["d_k"]) + _narrowest(dims["d_grp"]))
    for inst in _counted(cell, tables):
        value = "f_v" if inst["shape"] == "join_sum" else "f_w"
        assert inst["rows"] == n + d
        assert inst["read_bytes"] == n * sum(_narrowest(facts[c]) for c in ("f_k", value, "f_day")) + key_bytes


@pytest.mark.parametrize("cell_name", ONE_TABLE)
def test_one_table_cells_count_and_answer_as_the_one_table_formula(cell_name):
    """Each instance's rows are its table's rows, its logical bytes those rows
    times the narrowest widths of the columns it reads, and its reference
    answer that of reference/<config>.py's function on that table alone."""
    cell = harness.Cell(cell_name, sizes=sizes(cell_name))
    tables = cell.generate(SEED, "cpu")
    instances = _counted(cell, tables)
    module = harness._load(os.path.join(harness.HERE, "reference", cell.workload["config"] + ".py"))
    dicts = cell.dictionaries()
    for inst, answer in zip(instances, harness.reference_answers(cell, tables, instances)):
        q = inst["query"]
        cols = tables[q["table"]]
        rows = next(iter(cols.values())).numel()
        assert inst["rows"] == rows
        assert inst["read_bytes"] == rows * sum(_narrowest(cols[c]) for c in q["reads"])
        assert answer == getattr(module, inst["shape"])(cols, dicts, inst["params"])
