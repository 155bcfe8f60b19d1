"""No module that the harness or the reference loads has the top-level name
jax, jaxlib, flax or eventql_tpu (whole names: eventql_tpu_torch is the
port), and the reference loads nothing of the port."""

import os
import subprocess
import sys
import types

from gpubench import harness

RUN_A_CELL = """
import json, sys, time
from gpubench import harness
from gpubench.tests.tiny import sizes
r = harness.run_cell("hits_dashboard", 5, 0.2, True, time.perf_counter(), device="cpu",
                     sizes=sizes("hits_dashboard"))
print(json.dumps({"correct": r["correct"], "bad": harness.forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""

LOAD_THE_REFERENCE = """
import json, sys
from gpubench import harness
from gpubench.tests.tiny import BENCHES
files = set()
for bench in BENCHES:
    for w in harness._json(bench)["workloads"]:
        files |= {f.__code__.co_filename for f in harness.Cell(w["name"], bench=bench).references.values()}
print(json.dumps({"files": sorted(files), "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _run(code):
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=harness.ROOT, timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert done.returncode == 0, done.stderr[-2000:]
    import json

    return json.loads(done.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    out = _run(RUN_A_CELL)
    assert out["correct"] and out["bad"] == []
    assert "eventql_tpu_torch" in out["tops"]
    assert not set(out["tops"]) & {"jax", "jaxlib", "flax", "eventql_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    """Every reference file of BENCHMARK.json's cells and the fixtures',
    found through their benchmark files."""
    out = _run(LOAD_THE_REFERENCE)
    assert not set(out["tops"]) & {"jax", "jaxlib", "flax", "eventql_tpu", "eventql_tpu_torch", "chip_smoke"}
    found = {os.path.relpath(f, harness.HERE) for f in out["files"]}
    assert {"reference/tpch_sf10_lineitem.py", "reference/clickbench_hits.py",
            "tests/fixtures/two_tables/reference/facts_dims.py",
            "tests/fixtures/two_tables/reference/facts_dims/join_mean.py"} <= found


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "eventql_tpu_torch_probe", types.ModuleType("x"))
    clean = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "eventql_tpu.exec", types.ModuleType("y"))
    assert "eventql_tpu" in harness.forbidden_modules()
    assert "eventql_tpu" not in clean or "eventql_tpu" in sys.modules
