"""Each reference function agrees with the port's Runtime(device="cpu") on
every query of every cell, and a run of each cell on the CPU comes out
correct."""

import time

import pytest

from gpubench import compare, harness, workload
from gpubench.tests.tiny import CELLS, sizes

SEED = 2**31 + 23


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_agrees_with_the_port_on_every_query(cell_name):
    from eventql_tpu_torch.exec.runtime import PlanCache, RelationTableProvider, Runtime

    cell = harness.Cell(cell_name, sizes=sizes(cell_name))
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


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_cpu_run_is_correct_and_routed(cell_name):
    result = harness.run_cell(cell_name, SEED, 0.3, False, time.perf_counter(),
                              device="cpu", sizes=sizes(cell_name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in harness.Cell(cell_name).metrics("end_to_end")}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"


def test_the_traced_cpu_run_reads_the_route_counters():
    result = harness.run_cell("tpch_q6", SEED, 0.3, True, time.perf_counter(),
                              device="cpu", sizes=sizes("tpch_q6"))
    assert result["correct"]
    assert result["metrics"]["device_route_share"]["value"] == 100.0
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result
