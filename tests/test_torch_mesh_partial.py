"""Partial aggregation over the mesh: ``try_execute_mesh_groupby(...,
partial=True)`` and the merge of partials (``operators._merge_partials``)
in the port against the JAX package.

A table is split in two halves, each held by its own mesh provider of 8
shards (the JAX one over the virtual CPU mesh, the port's on the CPU):
the way a cluster worker aggregates its local rows on its mesh and ships
the accumulator states (GroupByPartial, mean as (sum, count)) to the
coordinator. Each half's partial and the merged Relation must be equal
in both packages (tolerance 0: counts and integer sums exact, the floats
of this table multiples of 1/64), and the merge equal to the host
engine's answer over the whole table.
"""

import numpy as np
import pytest

from eventql_tpu.core.types import SType
from eventql_tpu.exec import mesh_exec as jax_mesh_exec
from eventql_tpu.exec import operators as jax_ops
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider as JaxProvider
from eventql_tpu.exec.runtime import Runtime as JaxRuntime
from eventql_tpu.parallel import distributed as jax_dist
from eventql_tpu.parallel.mesh_provider import MeshTableProvider as JaxMesh
from eventql_tpu_torch.exec import mesh_exec
from eventql_tpu_torch.exec import operators as ops
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import Runtime
from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider
from eventql_tpu_torch.plan import nodes as qn

P = 8


def _table(n=2400, seed=17):
    rng = np.random.default_rng(seed)
    v_valid = rng.random(n) < 0.9
    cities = [b"c%02d" % c if rng.random() < 0.95 else None for c in rng.integers(0, 13, n)]
    return Relation(
        ["k", "v", "i", "f", "city"],
        [
            Column(SType.UINT64, rng.integers(0, 29, n).astype(np.uint64), np.ones(n, bool)),
            Column(SType.UINT64,
                   np.where(v_valid, rng.integers(0, 5000, n), 0).astype(np.uint64), v_valid),
            Column(SType.INT64, rng.integers(-300, 300, n).astype(np.int64), np.ones(n, bool)),
            Column(SType.FLOAT64, rng.integers(-6400, 6400, n) / 64.0, np.ones(n, bool)),
            Column.from_strings(cities),
        ],
        n,
    )


def _halves(rel):
    h = rel.num_rows // 2 + 37  # halves of 1237 and 1163 rows: both pad to 2048
    return [rel.gather(np.arange(0, h)), rel.gather(np.arange(h, rel.num_rows))]


def _port_rel(rel):
    return relation_from_numpy(
        rel.names, [(int(c.stype), c.data, c.valid, c.dictionary) for c in rel.columns])


def _group_node(node):
    while not isinstance(node, (qn.GroupByNode, jax_ops.qn.GroupByNode)):
        node = node.table
    return node


_JAX_MESH = []


def _jax_mesh():
    """One JAX mesh for the file: its compiled programs are cached per mesh."""
    if not _JAX_MESH:
        _JAX_MESH.append(jax_dist.make_mesh(P))
    return _JAX_MESH[0]


def _jax_partial(rel, query):
    p = JaxMesh(mesh=_jax_mesh())
    p.add_table("t", rel)
    rt = JaxRuntime()
    txn = rt.new_transaction(p)
    node = _group_node(rt.build_query_plan(txn, query).nodes[0])
    return node, jax_mesh_exec.try_execute_mesh_groupby(node, txn, partial=True)


def _port_partial(rel, query):
    p = MeshTableProvider(n_shards=P, device="cpu")
    p.add_table("t", _port_rel(rel))
    rt = Runtime(device=None)
    txn = rt.new_transaction(p)
    node = _group_node(rt.build_query_plan(txn, query).nodes[0])
    return node, mesh_exec.try_execute_mesh_groupby(node, txn, partial=True)


def _cols(cols):
    return [(int(c.stype), c.format_all()) for c in cols]


def _partial_form(p):
    """A GroupByPartial as plain values: keys, group count, and each
    entry's columns (first-row columns, or each aggregate's state)."""
    entries = []
    for e in p.entries:
        if e[0] == "first":
            entries.append(("first", _cols([e[1]])))
        else:
            entries.append(("agg", [(kind, _cols(cols)) for kind, cols in e[2]]))
    return _cols(p.key_cols), p.n_groups, entries


def _relation_form(rel):
    return list(rel.names), _cols(rel.columns)


QUERIES = [
    "select k, count(1), sum(v) from t group by k;",
    "select k, min(v), max(v), mean(v), count(v) from t where v < 4000 group by k;",
    "select city, sum(i), min(i), max(f) from t group by city;",
    "select city, k, count(1), sum(f), mean(f) from t where i > -100 group by city, k;",
    "select k % 4, sum(v + 1), max(i) * 2 from t group by k % 4;",
    "select sum(v), count(1), mean(i) from t;",
    "select k, k + 1, sum(v) from t group by k;",
]


@pytest.mark.parametrize("query", QUERIES)
def test_partials_and_their_merge_match_jax(query):
    rel = _table()
    jax_parts, port_parts = [], []
    for half in _halves(rel):
        jnode, jp = _jax_partial(half, query)
        before = mesh_exec.MESH_GROUPBY_RUNS
        tnode, tp = _port_partial(half, query)
        assert mesh_exec.MESH_GROUPBY_RUNS == before + 1
        assert jp is not None and tp is not None
        assert _partial_form(tp) == _partial_form(jp)
        jax_parts.append(jp)
        port_parts.append(tp)
    want = jax_ops._merge_partials(jnode, jax_parts)
    got = ops._merge_partials(tnode, port_parts)
    assert _relation_form(got) == _relation_form(want)
    # the merge of the two halves is the whole table's GROUP BY
    hp = JaxProvider()
    hp.add_table("t", rel)
    rt = JaxRuntime()
    whole = rt.build_query_plan(rt.new_transaction(hp), query).execute(0)
    assert [c.format_all() for c in got.columns] == [list(col) for col in zip(*whole.rows)]


def test_count_distinct_has_no_mesh_partial():
    """A partial of count_distinct needs the distinct value sets, which
    the mesh route does not keep: both packages return None."""
    q = "select k, count_distinct(v) from t group by k;"
    half = _halves(_table())[0]
    assert _jax_partial(half, q)[1] is None
    assert _port_partial(half, q)[1] is None


def test_empty_partials_merge_to_no_rows():
    """A filter that keeps nothing: the mesh route declines (None), the
    host partial of each half has no group, and the merge of those is an
    empty relation typed as the select list, in both packages."""
    q = "select k, sum(v) from t where v > 100000 group by k;"
    parts = {"jax": [], "port": []}
    for half in _halves(_table()):
        jnode, jp = _jax_partial(half, q)
        tnode, tp = _port_partial(half, q)
        assert jp is None and tp is None
        parts["jax"].append(jax_ops._exec_group_by_local(jnode, half))
        parts["port"].append(ops._exec_group_by_local(tnode, _port_rel(half)))
    want = jax_ops._merge_partials(jnode, parts["jax"])
    got = ops._merge_partials(tnode, parts["port"])
    assert got.num_rows == want.num_rows == 0
    assert _relation_form(got) == _relation_form(want)


@pytest.mark.parametrize("query", QUERIES[:3])
def test_mesh_partials_merge_with_host_partials(query):
    """One half aggregated on a mesh, the other by the host engine's
    ``_exec_group_by_local``: the states have the same form, so the merge
    is the same as the JAX package's of the same mix."""
    rel = _table()
    first, second = _halves(rel)
    jnode, jp = _jax_partial(first, query)
    tnode, tp = _port_partial(first, query)
    want = jax_ops._merge_partials(jnode, [jp, jax_ops._exec_group_by_local(jnode, second)])
    got = ops._merge_partials(tnode, [tp, ops._exec_group_by_local(tnode, _port_rel(second))])
    assert _relation_form(got) == _relation_form(want)
