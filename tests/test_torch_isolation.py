"""The port stands alone: it imports neither jax nor the JAX package,
and it does not hide a missing GPU behind the CPU.

Checked at run time in a fresh interpreter (this test process itself
has jax loaded by tests/conftest.py) and statically over the sources.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
import numpy as np
import eventql_tpu_torch
from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime

n = 1000
rng = np.random.default_rng(3)
rel = relation_from_numpy(
    ["k", "v"],
    [
        (SType.STRING, rng.integers(0, 4, n).astype(np.int32), np.ones(n, bool),
         np.array([b"a", b"b", b"c", b"d"], dtype=object)),
        (SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64),
         np.ones(n, bool), None),
    ],
)
p = RelationTableProvider()
p.add_table("t", rel)
rt = eventql_tpu_torch.Runtime(device="cpu")
res = rt.build_query_plan(
    rt.new_transaction(p),
    "select k, count(1), sum(v) from t where v < 800 group by k order by k;",
).execute(0)
assert [r[0] for r in res.rows] == ["a", "b", "c", "d"], res.rows
assert sum(int(r[1]) for r in res.rows) == int((rel.columns[1].data < 800).sum())
assert device_exec.FUSED_GROUPBY_COUNT == 1
res = rt.build_query_plan(
    rt.new_transaction(p), "select k, v from t order by v desc, k limit 3;"
).execute(0)
top = np.lexsort((rel.columns[0].data, -rel.columns[1].data.astype(np.int64)))[:3]
assert [int(r[1]) for r in res.rows] == [int(rel.columns[1].data[i]) for i in top]
res = rt.build_query_plan(
    rt.new_transaction(p), "select v from t where v < 10 order by v;"
).execute(0)
assert [int(r[0]) for r in res.rows] == sorted(
    int(x) for x in rel.columns[1].data if x < 10)
assert (device_exec.SCAN_TOPK_COUNT, device_exec.SCAN_ORDER_COUNT) == (1, 1)
m = 16
p.add_table("d", relation_from_numpy(
    ["k", "g"],
    [
        (SType.UINT64, (np.arange(m) * 50).astype(np.uint64), np.ones(m, bool), None),
        (SType.UINT64, (np.arange(m) % 3).astype(np.uint64), np.ones(m, bool), None),
    ],
))
res = rt.build_query_plan(
    rt.new_transaction(p),
    "select d.g, count(1), sum(t.v), sum(t.v + 1) from t join d on t.v = d.k"
    " group by d.g order by d.g;",
).execute(0)
v = rel.columns[1].data
hit = (v % 50 == 0) & (v // 50 < m)
assert [[int(x) for x in r] for r in res.rows] == [
    [g, int((hit & (v // 50 % 3 == g)).sum()),
     int(v[hit & (v // 50 % 3 == g)].sum()),
     int((v[hit & (v // 50 % 3 == g)] + 1).sum())] for g in range(3)], res.rows
assert device_exec.JOIN_GROUPBY_COUNT == 1
res = rt.build_query_plan(
    rt.new_transaction(p),
    "select k, min(v), max(v), count_distinct(v) from t group by k order by k;",
).execute(0)
k = rel.columns[0].data
assert [[int(x) for x in r[1:]] for r in res.rows] == [
    [int(v[k == i].min()), int(v[k == i].max()), len(np.unique(v[k == i]))]
    for i in range(4)], res.rows
assert device_exec.GENERAL_GROUPBY_COUNT == 1

bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "eventql_tpu" or m.startswith("eventql_tpu.")]
assert not bad, bad

import torch
assert not torch.cuda.is_available()
for make in (lambda: Runtime(), lambda: Runtime(device="cuda"),
             lambda: eventql_tpu_torch.Runtime()):
    try:
        make()
    except RuntimeError_ as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("Runtime(device='cuda') did not raise without a GPU")

# a CUDA tensor is never served by the plain version: without a card
# the tensor cannot even be made, and the wrapper has no other path
from eventql_tpu_torch.kernels import (
    extract, groupby, groupby_agg, hash_groupby, join, sort)
assert groupby_agg.LAUNCHES == {"groupby_agg": 0, "groupby_multi_agg": 0}
assert hash_groupby.LAUNCHES == {"hash_groupby": 0}
assert extract.LAUNCHES == {"extract_ge": 0}
assert join.LAUNCHES == {"dim_join_gid": 0, "probe_join_gid": 0, "build_join_table": 0}
keys = torch.tensor([7, -1, 9, 8])
assert join.join_gid(keys, torch.tensor([9, -1]), torch.tensor([4, 5], dtype=torch.int32)
                     ).tolist() == [-1, 5, 4, -1]
key = groupby.sortable_u64(torch.tensor([3, -1, 2]), descending=True)
assert sort.topk_permutation(key, 1).tolist() == [1]
assert extract.extract_ge(torch.tensor([1, 7, 9], dtype=torch.int32), 7, 2).tolist() == [1, 2]
g = hash_groupby.hash_groupby([torch.tensor([5, 3, 5])], 3, values=[torch.tensor([1, 2, 4])],
                              kinds=["max"])
assert (g.first_index.tolist(), g.counts.tolist(), g.aggregates[0].tolist()) == (
    [1, 0], [1, 2], [2, 4])
assert hash_groupby.LAUNCHES == {"hash_groupby": 0}
print("ISOLATED-OK")
"""


def test_port_runs_without_jax_and_refuses_a_missing_gpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", _PROGRAM],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED-OK" in out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import eventql_tpu\b(?!_torch)"
    r"|from eventql_tpu(\.| ))",
    re.M,
)


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_order.py")
    for root, _dirs, files in os.walk(os.path.join(REPO, "eventql_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def test_port_sources_name_no_jax_import():
    paths = list(_port_sources())
    assert len(paths) > 20
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            m = _FORBIDDEN.search(fh.read())
        assert m is None, f"{path}: {m.group(0)!r}"


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_needs_a_compiler(tmp_path, monkeypatch):
    """Without nvcc the build raises; nothing else is tried."""
    import pytest

    from eventql_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["extract", "groupby_agg", "hash_groupby", "join"]
