"""The port's exchange layer and kernel-tier distributed aggregates
(eventql_tpu_torch/parallel/distributed.py) against the JAX package's.

The cases of tests/test_distributed_join.py (seeded numpy inputs, 8
shards) go through the JAX functions over the 8-device virtual CPU mesh,
their Pallas kernels in interpret mode as that file runs them, and
through the port's functions on ``make_mesh(8, "cpu")``, whose shards run
the kernels' plain versions. Counts and sums must be equal (tolerance 0:
exact integers, sums mod 2^64) to each other and to a numpy answer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_distributed_join as jax_dj

from eventql_tpu.parallel import distributed as jd
from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.parallel import distributed as td

P = 8


def _np(t):
    return t.numpy().view(np.uint64).tolist()


def _jax(out):
    return [np.asarray(o).astype(np.uint64).tolist() for o in out]


def _meshes():
    return jd.make_mesh(P), td.make_mesh(P, "cpu")


def test_sum_count_matches_jax():
    """B1 on each shard, one psum; values at and beyond 2^63 wrap as the
    JAX function's u64 sums do."""
    jmesh, tmesh = _meshes()
    n, K = P * 1024, 16
    rng = np.random.default_rng(1)
    mask = rng.random(n) < 0.8
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    vals[rng.integers(0, n, 50)] += np.uint64(1 << 63)
    want = _jax(jd.distributed_pallas_sum_count(
        jmesh, *jd.shard_table(jmesh, [mask, gid, vals]), K))
    counts, sums = td.distributed_sum_count(tmesh, *td.shard_table(tmesh, [mask, gid, vals]), K)
    assert [_np(counts), _np(sums)] == want
    keep = mask
    assert _np(counts) == np.bincount(gid[keep], minlength=K).tolist()
    exp = np.zeros(K, np.uint64)
    np.add.at(exp, gid[keep], vals[keep])
    assert _np(sums) == exp.tolist()
    assert td.distributed_pallas_sum_count is td.distributed_sum_count


def _join_case(seed, n, n_dim, K, mult, add, mask_p):
    rng = np.random.default_rng(seed)
    dim_keys = rng.permutation(np.arange(n_dim, dtype=np.uint64) * mult + add)
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = rng.integers(0, n_dim * 2, n).astype(np.uint64) * mult + add
    fact_vals = rng.integers(0, 1000, n).astype(np.uint64)
    fact_mask = rng.random(n) < mask_p
    return fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket


_JOIN_WANT = []


@pytest.mark.parametrize("probe", [None, "compare", "search"])
def test_join_aggregate_matches_jax(probe):
    """test_distributed_join_aggregate_exact's case (and the compare
    probe's): the JAX search probe against each of the port's probes."""
    jmesh, tmesh = _meshes()
    K = 16
    fk, fv, fm, dk, db = _join_case(2, P * 4096, 300, K, 13, 7, 0.8)
    if not _JOIN_WANT:  # the JAX answer once for the three probes
        _JOIN_WANT.append(_jax(jd.distributed_join_aggregate(
            jmesh, *jd.shard_table(jmesh, [fk, fv, fm]), jnp.asarray(dk), jnp.asarray(db),
            K, probe="search")))
    want = _JOIN_WANT[0]
    exp = jax_dj._expected(fk, fv, fm, dk, db, K)
    assert want == [e.tolist() for e in exp]
    counts, sums = td.distributed_join_aggregate(
        tmesh, *td.shard_table(tmesh, [fk, fv, fm]), torch.from_numpy(dk.view(np.int64)),
        torch.from_numpy(db), K, probe=probe)
    assert [_np(counts), _np(sums)] == want


def test_join_aggregate_compare_probe_case_matches_jax():
    """test_distributed_join_aggregate_compare_probe's case through the
    JAX compare kernel (interpret mode) and the port's B4."""
    jmesh, tmesh = _meshes()
    n, n_dim, K = P * 1024, 64, 8
    rng = np.random.default_rng(3)
    dk = rng.permutation(np.arange(n_dim, dtype=np.uint64) * 9 + 1)
    db = (np.arange(n_dim) % K).astype(np.int32)
    fk = rng.integers(0, n_dim, n).astype(np.uint64) * 9 + 1
    fv = rng.integers(0, 100, n).astype(np.uint64)
    fm = np.ones(n, bool)
    want = _jax(jd.distributed_join_aggregate(
        jmesh, *jd.shard_table(jmesh, [fk, fv, fm]), jnp.asarray(dk), jnp.asarray(db), K,
        probe="compare"))
    counts, sums = td.distributed_join_aggregate(
        tmesh, *td.shard_table(tmesh, [fk, fv, fm]), torch.from_numpy(dk.view(np.int64)),
        torch.from_numpy(db), K, probe="compare")
    assert [_np(counts), _np(sums)] == want


def _multi_case(seed, n, n_dim1, n_dim2, K, m1, a1, m2, a2, mask_p):
    rng = np.random.default_rng(seed)
    d1k = rng.permutation(np.arange(n_dim1, dtype=np.uint64) * m1 + a1)
    d1b = rng.integers(0, K, n_dim1).astype(np.int32)
    d2k = rng.permutation(np.arange(n_dim2, dtype=np.uint64) * m2 + a2)
    d2f = rng.integers(0, 2, n_dim2).astype(np.int32)
    fk1 = rng.integers(0, n_dim1 * 2, n).astype(np.uint64) * m1 + a1
    fk2 = rng.integers(0, n_dim2, n).astype(np.uint64) * m2 + a2
    fv = rng.integers(0, 1000 if mask_p < 1 else 100, n).astype(np.uint64)
    fm = rng.random(n) < mask_p if mask_p < 1 else np.ones(n, bool)
    return fk1, fk2, fv, fm, d1k, d1b, d2k, d2f


MULTI_CASES = {
    # test_distributed_multi_join_aggregate_ring
    "ring": ((4, P * 2048, P * 40, 96, 12, 13, 7, 5, 3, 0.8), "search"),
    # test_distributed_multi_join_compare_probe_ring
    "compare_ring": ((5, P * 512, P * 16, 32, 6, 9, 1, 3, 2, 1.0), "compare"),
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multi_join_aggregate_matches_jax(case):
    """dim1 sharded and rotated around the ring with _xch_ppermute, dim2
    on every shard; the JAX function's counts and sums, and the numpy
    answer. The ring moves each dim1 shard P - 1 times."""
    args, probe = MULTI_CASES[case]
    jmesh, tmesh = _meshes()
    K = args[4]
    fk1, fk2, fv, fm, d1k, d1b, d2k, d2f = _multi_case(*args)
    want = _jax(jd.distributed_multi_join_aggregate(
        jmesh, *jd.shard_table(jmesh, [fk1, fk2, fv, fm, d1k, d1b]),
        jnp.asarray(d2k), jnp.asarray(d2f), K, probe=probe))
    exp = jax_dj._expected_multi(fk1, fk2, fv, fm, d1k, d1b, d2k, d2f, K)
    assert want == [e.tolist() for e in exp]
    with td.exchange_tally(tmesh) as tally:
        counts, sums = td.distributed_multi_join_aggregate(
            tmesh, *td.shard_table(tmesh, [fk1, fk2, fv, fm, d1k, d1b]),
            torch.from_numpy(d2k.view(np.int64)), torch.from_numpy(d2f), K, probe=probe)
    assert [_np(counts), _np(sums)] == want
    ring = (P - 1) * len(d1k) * (8 + 4)  # P - 1 steps of every shard's keys and buckets
    assert tally.by_op() == {"join_ring": ring, "join_psum": 2 * (P - 1) * K * 8}


def test_padded_rows_are_masked_out():
    """Rows that do not split evenly pad with zeros and a False mask: a
    fact key 0 in the padding finds the dimension key 0 and is dropped."""
    tmesh = td.make_mesh(3, "cpu")
    K = 5
    fk, fv, fm, dk, db = _join_case(9, 1000, 40, K, 1, 0, 0.9)  # dimension key 0 exists
    assert 0 in dk and 1000 % 3
    counts, sums = td.distributed_join_aggregate(
        tmesh, *td.shard_table(tmesh, [fk, fv, fm]), torch.from_numpy(dk.view(np.int64)),
        torch.from_numpy(db), K)
    assert [_np(counts), _np(sums)] == [e.tolist() for e in jax_dj._expected(
        fk, fv, fm, dk, db, K)]


def test_collectives_move_and_count_bytes():
    mesh = td.make_mesh(4, "cpu")
    parts = [torch.arange(3, dtype=torch.int64) + 10 * i for i in range(4)]
    with td.exchange_tally(mesh) as outer:
        with td.exchange_tally(mesh) as inner:
            g = td._xch_all_gather(mesh, parts, "g")
        s = td._xch_psum(mesh, parts, "s")
        r = td._xch_ppermute(mesh, parts, [(0, 1), (1, 2), (2, 3), (3, 0)], "r")
    assert g.tolist() == [0, 1, 2, 10, 11, 12, 20, 21, 22, 30, 31, 32]
    assert s.tolist() == [60, 64, 68] and parts[0].tolist() == [0, 1, 2]
    assert [t.tolist()[0] for t in r] == [30, 0, 10, 20]
    assert inner.by_op() == {"g": 72}
    assert outer.by_op() == {"g": 72, "s": 72, "r": 96} and outer.bytes() == 240
    assert mesh._tallies == []
    with pytest.raises(ValueError):
        td._xch_all_gather(mesh, parts[:3])
    with pytest.raises(ValueError):
        td._xch_ppermute(mesh, parts, [(0, 1), (1, 1), (2, 3), (3, 0)])


def test_shard_table_splits_equal_blocks():
    """7 rows over 3 shards pad to 9: 3 rows a shard, the padding zeros
    (a False mask)."""
    mesh = td.make_mesh(3, "cpu")
    a, b = td.shard_table(mesh, [np.arange(7, dtype=np.uint64), np.ones(7, bool)])
    assert [t.tolist() for t in a] == [[0, 1, 2], [3, 4, 5], [6, 0, 0]]
    assert [t.dtype for t in a] == [torch.int64] * 3
    assert [t.tolist() for t in b] == [[True] * 3, [True] * 3, [True, False, False]]
    assert td.padded_rows(7, 3) == 9 and td.padded_rows(0, 3) == 3


def test_make_mesh_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError_, match="no CUDA device"):
        td.make_mesh(4, "cuda")
    with pytest.raises(ValueError):
        td.make_mesh(4, "tpu")
    with pytest.raises(ValueError):
        td.make_mesh(0, "cpu")
    assert td.make_mesh(2, "cpu").devices == [torch.device("cpu")] * 2
