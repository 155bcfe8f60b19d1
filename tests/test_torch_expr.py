"""torch_expr.compile_expr against jax_expr.compile_expr.

Each SQL snippet is planned by the JAX package's planner and by the
port's planner; the scan's select expression of each plan is compiled
by its own package over the same physically narrowed column arrays
(made with numpy from a seed). Results must be equal exactly: integer
columns bit for bit (u64 results of the port are int64 bit patterns),
float columns value for value (every float snippet here is a single
IEEE operation or a conversion), validity masks too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventql_tpu.core.types import SType
from eventql_tpu.exec import device_exec as jax_device_exec
from eventql_tpu.exec import jax_expr
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.exec import device_exec as torch_device_exec
from eventql_tpu_torch.exec import torch_expr
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    RelationTableProvider as TorchProvider,
    Runtime as TorchRuntime,
)
# the corpus, shared with the expression program's tests (CPU and card)
from test_torch_expr_program import SNIPPETS

N = 2000


def _relation():
    rng = np.random.default_rng(41)
    ones = np.ones(N, bool)
    u = rng.integers(0, 1 << 64, N, dtype=np.uint64)  # above 2^63 too
    u[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    u2 = rng.integers(1, 1 << 64, N, dtype=np.uint64)
    u2[:4] = [(1 << 64) - 1, 1 << 63, (1 << 63) - 1, 1]
    i = rng.integers(-(1 << 62), 1 << 62, N).astype(np.int64)
    small = rng.integers(-300, 300, N).astype(np.int64)  # narrows to i16
    un_valid = rng.random(N) < 0.85
    un = np.where(un_valid, rng.integers(0, 60000, N), 0).astype(np.uint64)
    w = rng.integers(0, 1 << 32, N).astype(np.uint64)  # narrows to u32
    f = rng.standard_normal(N) * 1000.0
    fp = rng.random(N) * 1.8e19  # positive, up to just under 2^64
    ts = rng.integers(0, 1 << 51, N).astype(np.uint64)
    s = Column.from_strings(
        [f"k{int(k):03d}".encode() for k in rng.integers(0, 40, N)]
    )
    s2 = Column(SType.STRING, rng.integers(0, 40, N).astype(np.int32),
                rng.random(N) < 0.9, s.dictionary)
    return Relation(
        ["u", "u2", "i", "small", "un", "w", "f", "fp", "ts", "s", "s2"],
        [
            Column(SType.UINT64, u, ones),
            Column(SType.UINT64, u2, ones),
            Column(SType.INT64, i, ones),
            Column(SType.INT64, small, ones),
            Column(SType.UINT64, un, un_valid),
            Column(SType.UINT64, w, ones),
            Column(SType.FLOAT64, f, ones),
            Column(SType.FLOAT64, fp, ones),
            Column(SType.TIMESTAMP64, ts, ones),
            s,
            s2,
        ],
        N,
    )


_STATE = {}


def _state():
    if not _STATE:
        rel = _relation()
        pj = RelationTableProvider()
        pj.add_table("t", rel)
        pt = TorchProvider()
        pt.add_table(
            "t",
            relation_from_numpy(
                rel.names,
                [(int(c.stype), c.data, c.valid, c.dictionary)
                 for c in rel.columns],
            ),
        )
        _STATE["p"] = (pj, pt)
    return _STATE["p"]


def _scan_of(node):
    while not hasattr(node, "input_columns"):
        node = node.table
    return node


def _compile_both(snippet):
    pj, pt = _state()
    sql = f"select {snippet} from t;"

    rj = Runtime()
    scan_j = _scan_of(rj.build_query_plan(rj.new_transaction(pj), sql).nodes[0])
    tj = pj.get_table_data("t")
    by_name = dict(zip(tj.names, tj.columns))
    cols_j = [
        jax_expr.DeviceCol(
            by_name[c].stype,
            jnp.asarray(jax_device_exec._narrow_np(by_name[c])),
            jnp.asarray(by_name[c].valid),
        )
        for c, _t in scan_j.input_columns
    ]
    expr_j = scan_j.select_list[0].expr
    assert jax_expr.expr_is_device_compatible(expr_j)
    out_j = jax_expr.compile_expr(expr_j, cols_j, N)

    rt = TorchRuntime(device="cpu")
    scan_t = _scan_of(rt.build_query_plan(rt.new_transaction(pt), sql).nodes[0])
    tt = pt.get_table_data("t")
    cols_t = torch_device_exec._to_device_cols(
        tt.columns, tt.names, scan_t.input_columns, torch.device("cpu")
    )
    expr_t = scan_t.select_list[0].expr
    assert torch_expr.expr_is_device_compatible(expr_t)
    out_t = torch_expr.compile_expr(expr_t, cols_t, N).full(N)
    return out_j, out_t




@pytest.mark.parametrize("snippet", SNIPPETS)
def test_compile_expr_matches_jax(snippet):
    out_j, out_t = _compile_both(snippet)
    assert out_t.stype == out_j.stype
    dj = np.asarray(out_j.data)
    dt = out_t.data.numpy()
    if dj.dtype == np.uint64:
        assert dt.dtype == np.int64
        dt = dt.view(np.uint64)
    assert dt.dtype == dj.dtype
    assert dt.shape == dj.shape == (N,)
    assert np.array_equal(dt, dj, equal_nan=dj.dtype.kind == "f")
    assert np.array_equal(out_t.valid.numpy(), np.asarray(out_j.valid))


@pytest.mark.parametrize(
    "snippet", ["s", "concat(s, s2)", "i % small", "to_string(u)", "s = 'k001'",
                "date_trunc('1h', ts)"]
)
def test_device_compatibility_agrees(snippet):
    """What one package keeps on the host, the other keeps there too."""
    pj, pt = _state()
    sql = f"select {snippet} from t;"
    rj, rt = Runtime(), TorchRuntime(device="cpu")
    ej = _scan_of(
        rj.build_query_plan(rj.new_transaction(pj), sql).nodes[0]
    ).select_list[0].expr
    et = _scan_of(
        rt.build_query_plan(rt.new_transaction(pt), sql).nodes[0]
    ).select_list[0].expr
    assert torch_expr.expr_is_device_compatible(
        et
    ) == jax_expr.expr_is_device_compatible(ej)


def test_unsigned_helpers_against_python_ints():
    """The u64-on-int64 helpers against Python's big integers."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    b = rng.integers(1, 1 << 64, 500, dtype=np.uint64)
    b[:100] = rng.integers(1, 1 << 20, 100)
    ta, tb = torch.from_numpy(a.view(np.int64)), torch.from_numpy(b.view(np.int64))
    q, r = torch_expr._udivmod(ta, tb)
    assert q.numpy().view(np.uint64).tolist() == [int(x) // int(y) for x, y in zip(a, b)]
    assert r.numpy().view(np.uint64).tolist() == [int(x) % int(y) for x, y in zip(a, b)]
    assert torch_expr._u64_to_f64(ta).tolist() == [float(int(x)) for x in a]
    f = torch.tensor(
        [0.0, 1.5, 2.0**62, 2.0**63, 2.0**64 - 2048.0, -3.5, 1e30, float("nan")],
        dtype=torch.float64,
    )
    assert torch_expr._f64_to_u64(f).numpy().view(np.uint64).tolist() == [
        0, 1, 1 << 62, 1 << 63, (1 << 64) - 2048, 0, (1 << 64) - 1, 0
    ]
    assert torch_expr._f64_to_i64(f).tolist() == [
        0, 1, 1 << 62, (1 << 63) - 1, (1 << 63) - 1, -3, (1 << 63) - 1, 0
    ]
