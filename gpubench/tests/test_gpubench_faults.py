"""The control and the planted faults come out as not correct.

Each fault breaks the timed path underneath a CPU run of the cell (the
harness's look for a chip skipped): an answer altered where it is
produced, half of each table left out, and an answer returned unchanged
from an earlier query. A fourth kind, the exchange between chips left
out, cannot happen in these one-chip cells. The
control is the reference one precision below the configuration's
(int32 integers, float32 means) in the program's place. The cells are
BENCHMARK.json's and the test-only fixtures' (a join of two tables)."""

import time

import numpy as np
import pytest

from gpubench import control, harness
from gpubench.tests.tiny import ALL_CELLS, sizes

SEED = 2**31 + 37


def _bump(text):
    try:
        return str(int(text) + 1)
    except ValueError:
        pass
    try:
        return "%f" % (float(text) + 1e-3)
    except ValueError:
        return text + "x"


def altered_answer(monkeypatch):
    from eventql_tpu_torch.exec.result import ResultList

    rows = ResultList.rows

    def altered(self):
        out = [list(r) for r in rows.fget(self)]
        if out:
            out[0][-1] = _bump(out[0][-1])
        return out

    monkeypatch.setattr(ResultList, "rows", property(altered))


def half_the_rows(monkeypatch):
    relations = harness.relations

    def half(cell, tables):
        return {k: r.gather(np.arange(r.num_rows // 2)) for k, r in relations(cell, tables).items()}

    monkeypatch.setattr(harness, "relations", half)


def stale_answer(monkeypatch):
    from eventql_tpu_torch.exec.runtime import QueryPlan

    execute, first = QueryPlan.execute, []

    def stale(self, idx):
        if not first:
            first.append(execute(self, idx))
        return first[0]

    monkeypatch.setattr(QueryPlan, "execute", stale)


FAULTS = {"altered_answer": altered_answer, "half_the_rows": half_the_rows, "stale_answer": stale_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("bench, cell_name", ALL_CELLS)
def test_a_fault_makes_the_run_not_correct(bench, cell_name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = harness.run_cell(cell_name, SEED, 0.3, False, time.perf_counter(),
                              device="cpu", sizes=sizes(cell_name, bench), bench=bench)
    assert result["attempted"] > 0
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("bench, cell_name", ALL_CELLS)
def test_the_control_fails_a_limit(bench, cell_name):
    readings = control.control_readings(cell_name, SEED, "cpu", sizes(cell_name, bench), bench=bench)
    limits = harness.Cell(cell_name, bench=bench).traffic["checks"]
    assert any(v is not None and v > limits[k] for k, v in readings.items()), readings
