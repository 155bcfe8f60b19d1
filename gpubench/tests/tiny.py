"""The cells and configurations that the CPU tests run, taken from the
benchmark files: BENCHMARK.json's, and those of the test-only benchmarks
``fixtures/<name>/bench.json``. Each runs at the sizes its configuration
keeps under ``test_sizes`` (a few thousand rows a table)."""

import glob
import os

import pytest

from gpubench import harness

BENCHES = (harness.BENCHMARK,) + tuple(sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "*", "bench.json"))))
CELLS = tuple(w["name"] for w in harness._json(harness.BENCHMARK)["workloads"])


def _fixture(bench):
    """The fixture's directory name, or None for BENCHMARK.json."""
    return None if bench == harness.BENCHMARK else os.path.basename(os.path.dirname(bench))


def _params(kind):
    """pytest params (bench, name) of every benchmark file's ``kind``
    entries: BENCHMARK.json's under their names, with bench None; a
    fixture's under ``<fixture>.<name>``."""
    return [pytest.param(bench if fixture else None, e["name"],
                         id=f"{fixture}.{e['name']}" if fixture else e["name"])
            for bench in BENCHES for fixture in [_fixture(bench)] for e in harness._json(bench)[kind]]


ALL_CELLS = _params("workloads")
ALL_CONFIGS = _params("configs")
BENCH_FILES = [pytest.param(bench, id=_fixture(bench) or "BENCHMARK") for bench in BENCHES]


def sizes(cell, bench=None):
    return harness.Cell(cell, bench=bench).config["test_sizes"]
