"""The port's kernel-tier mesh aggregates and top-k
(eventql_tpu_torch/parallel/distributed.py: ``distributed_topk``,
``distributed_grouped_aggregate``, ``distributed_count_distinct``,
``distributed_grouped_aggregate_sharded``) against the JAX package's.

The seeded cases of tests/test_fuzz_distributed.py and
tests/test_distributed_groupby_sharded.py (a hot key spanning every
shard, all rows one group, all rows filtered out, several keys, narrow
key dtypes) go through the JAX functions over the virtual CPU mesh
(conftest), each under ``jax.jit``, and through the port's on
``make_mesh(P, "cpu")``, whose shards run H1's and the top-k's plain
versions. Tolerance 0: the valid groups, in order, with their keys and
aggregates (sums mod 2^64), and the top-k keys and row ids, equal the
JAX outputs and a numpy answer.
"""

import random

import jax
import numpy as np
import pytest
import torch

import test_distributed_groupby_sharded as jax_sharded
import test_fuzz_distributed as jax_fuzz

from eventql_tpu.parallel import distributed as jd
from eventql_tpu_torch.parallel import distributed as td

M64 = (1 << 64) - 1


def _bits(t):
    """A tensor's values as Python integers of their u64 bits (a float64
    stream by its value)."""
    a = t.numpy()
    if a.dtype == np.float64:
        return a.tolist()
    return [int(x) & M64 for x in a.astype(np.int64)]


def _jbits(a):
    a = np.asarray(a)
    if a.dtype == np.float64:
        return a.tolist()
    return [int(x) & M64 for x in a.astype(np.int64)]


def _unsigned(arr):
    return np.asarray(arr).dtype.kind in "ub"


def _jax_grouped(fn, jmesh, mask, keys, vals, *extra):
    """The valid entries of a JAX kernel-tier result, in its order, as u64
    bits: (keys per stream, outputs per stream)."""
    sharded = jd.shard_table(jmesh, [mask] + list(keys) + list(vals))
    nk = len(keys)
    m, ks, vs = sharded[0], tuple(sharded[1:1 + nk]), tuple(sharded[1 + nk:])
    gk, outs, valid = jax.jit(lambda m, ks, vs: fn(jmesh, m, ks, vs, *extra))(m, ks, vs)
    valid = np.asarray(valid)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return ([_jbits(np.asarray(k)[valid]) for k in gk],
            [_jbits(np.asarray(o)[valid]) for o in outs])


def _port_args(tmesh, mask, keys, vals):
    sharded = td.shard_table(tmesh, [mask] + list(keys) + list(vals))
    nk = len(keys)
    return sharded[0], sharded[1:1 + nk], sharded[1 + nk:]


def _fuzz_case(seed_base, seed):
    """test_fuzz_distributed's grouped case, with the port's mesh beside."""
    mesh, n, keys, vals, kinds, mask = jax_fuzz._gen_grouped_case(random.Random(seed_base + seed))
    return mesh, td.make_mesh(mesh.shape["shards"], "cpu"), keys, vals, kinds, mask


@pytest.mark.parametrize("seed", range(8))
def test_grouped_aggregate_matches_jax(seed):
    jmesh, tmesh, keys, vals, kinds, mask = _fuzz_case(100, seed)
    want_k, want_a = _jax_grouped(jd.distributed_grouped_aggregate, jmesh, mask, keys, vals,
                                  tuple(kinds))
    m, ks, vs = _port_args(tmesh, mask, keys, vals)
    gk, aggs, valid = td.distributed_grouped_aggregate(
        tmesh, m, ks, vs, kinds, values_unsigned=[True] * len(vals),
        keys_unsigned=[True] * len(keys))
    assert bool(valid.all())
    assert [_bits(k) for k in gk] == want_k
    assert [_bits(a) for a in aggs] == want_a
    expected = jax_fuzz._np_grouped(keys, vals, mask, kinds)
    assert dict(zip(zip(*want_k), map(list, zip(*want_a)))) == expected


@pytest.mark.parametrize("seed", range(8))
def test_grouped_aggregate_sharded_matches_jax(seed):
    """The valid groups, concatenated in shard order, equal the JAX
    function's: unique, ascending across shards, the same totals."""
    jmesh, tmesh, keys, vals, kinds, mask = _fuzz_case(300, seed)
    P = tmesh.size
    if P & (P - 1):
        pytest.skip("power-of-two meshes only")  # never for these seeds: P in {1, 2, 4, 8}
    want_k, want_a = _jax_grouped(jd.distributed_grouped_aggregate_sharded, jmesh, mask, keys,
                                  vals, tuple(kinds))
    m, ks, vs = _port_args(tmesh, mask, keys, vals)
    with td.exchange_tally(tmesh) as tally:
        gk, aggs, valid = td.distributed_grouped_aggregate_sharded(
            tmesh, m, ks, vs, kinds, values_unsigned=[True] * len(vals),
            keys_unsigned=[True] * len(keys))
    got_k = [sum((_bits(t[v]) for t, v in zip(k, valid)), []) for k in gk]
    got_a = [sum((_bits(t[v]) for t, v in zip(a, valid)), []) for a in aggs]
    assert got_k == want_k and got_a == want_a
    if P > 1:
        assert {"sort_exchange", "boundary_gather"} <= set(tally.by_op())


def _sharded_case(n_dev, keys, vals, mask, kinds, jax_fault=False):
    """The port's sharded aggregate against the JAX function's, or, where
    ``jax_fault``, against numpy, pinning that the JAX answer differs."""
    jmesh, tmesh = jd.make_mesh(n_dev), td.make_mesh(n_dev, "cpu")
    want_k, want_a = _jax_grouped(jd.distributed_grouped_aggregate_sharded, jmesh, mask,
                                  [keys], [vals] * len(kinds), tuple(kinds))
    m, ks, vs = _port_args(tmesh, mask, [keys], [vals] * len(kinds))
    gk, aggs, valid = td.distributed_grouped_aggregate_sharded(
        tmesh, m, ks, vs, kinds, values_unsigned=[True] * len(kinds),
        keys_unsigned=[_unsigned(keys)])
    got_k = [sum((_bits(t[v]) for t, v in zip(k, valid)), []) for k in gk]
    got_a = [sum((_bits(t[v]) for t, v in zip(a, valid)), []) for a in aggs]
    if jax_fault:
        host = jax_sharded._host_expected(keys, vals, mask, kinds)
        assert got_k == [sorted(host)]
        assert [list(r) for r in zip(*got_a)] == [[x & M64 for x in host[k]] for k in got_k[0]]
        assert (got_k, got_a) != (want_k, want_a)
    else:
        assert got_k == want_k and got_a == want_a
    return gk, aggs, valid


def test_sharded_hot_key_spans_every_shard():
    """test_single_hot_key_spanning_every_shard: one key on 90 % of the
    rows is one entry a shard after the pre-combine; after the sort its
    run covers the middle shards, and the boundary patch must chain
    through them: one owner, every other copy invalid."""
    n = 8 * 64
    rng = np.random.default_rng(5)
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(100, 140, n)).astype(np.uint64)
    vals = rng.integers(0, 50, n).astype(np.uint64)
    gk, aggs, valid = _sharded_case(8, keys, vals, np.ones(n, bool),
                                    ["sum", "count", "min", "max"])
    holders = [s for s in range(8) if bool(((gk[0][s] == 7) & valid[s]).any())]
    assert len(holders) == 1
    want = jax_sharded._host_expected(keys, vals, np.ones(n, bool),
                                      ("sum", "count", "min", "max"))
    s = holders[0]
    at = int(torch.nonzero((gk[0][s] == 7) & valid[s])[0])
    assert [int(a[s][at]) for a in aggs] == want[7]


@pytest.mark.parametrize("case", ["one_group", "all_filtered", "u64_max_key"])
def test_sharded_edge_cases(case):
    """All rows one group; all rows filtered out; keys up to the u64 max
    and values at 2^63 and above (min / max in unsigned order, C10). The
    JAX function folds the group of key 2^64 - 1 into another group and
    leaves the groups out of order (ROADMAP C12): that case is held
    against numpy."""
    n = 8 * 16
    keys = np.full(n, 3, np.uint64) if case == "one_group" else np.arange(n, dtype=np.uint64)
    vals = np.arange(n, dtype=np.uint64)
    mask = np.ones(n, bool) if case != "all_filtered" else np.zeros(n, bool)
    if case == "u64_max_key":
        keys = (keys % 5) + np.uint64(M64 - 4)
        vals[::7] = np.uint64((1 << 63) + 11)
    gk, aggs, valid = _sharded_case(8, keys, vals, mask, ["sum", "count", "min", "max"],
                                    jax_fault=case == "u64_max_key")
    total = sum(int(v.sum()) for v in valid)
    assert total == {"one_group": 1, "all_filtered": 0, "u64_max_key": 5}[case]


def test_sharded_multi_key_groups():
    n = 4 * 64
    rng = np.random.default_rng(9)
    k1 = rng.integers(0, 5, n).astype(np.uint64)
    k2 = rng.integers(-3, 7, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.uint64)
    mask = rng.random(n) < 0.9
    jmesh, tmesh = jd.make_mesh(4), td.make_mesh(4, "cpu")
    want = _jax_grouped(jd.distributed_grouped_aggregate_sharded, jmesh, mask, [k1, k2],
                        [vals], ("sum",))
    m, ks, vs = _port_args(tmesh, mask, [k1, k2], [vals])
    gk, aggs, valid = td.distributed_grouped_aggregate_sharded(
        tmesh, m, ks, vs, ["sum"], values_unsigned=[True], keys_unsigned=[True, False])
    got = ([sum((_bits(t[v]) for t, v in zip(k, valid)), []) for k in gk],
           [sum((_bits(t[v]) for t, v in zip(a, valid)), []) for a in aggs])
    assert got == want


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_sharded_narrow_key_dtypes(dtype):
    """Narrow keys, negative ones among them, sort as u32 under their
    static bound and come back in their own dtype, ascending."""
    n = 8 * 64
    rng = np.random.default_rng(31)
    info = np.iinfo(dtype)
    keys = rng.integers(info.min, int(info.max) + 1, n).astype(dtype)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    mask = rng.random(n) < 0.8
    gk, _aggs, valid = _sharded_case(8, keys, vals, mask, ["sum", "count", "min", "max"])
    got = np.concatenate([t[v].numpy() for t, v in zip(gk[0], valid)])
    assert got.dtype == dtype and np.array_equal(got, np.unique(keys[mask]))


def test_grouped_aggregate_narrow_keys_and_float_values():
    """int16 keys ordered signed, float64 sums / min / max, and a count."""
    n = 8 * 64
    rng = np.random.default_rng(2)
    keys = rng.integers(-40, 40, n).astype(np.int16)
    vals = rng.integers(-1000, 1000, n) / 8.0
    mask = rng.random(n) < 0.7
    kinds = ["sum", "min", "max", "count"]
    jmesh, tmesh = jd.make_mesh(8), td.make_mesh(8, "cpu")
    want = _jax_grouped(jd.distributed_grouped_aggregate, jmesh, mask, [keys], [vals] * 4,
                        tuple(kinds))
    m, ks, vs = _port_args(tmesh, mask, [keys], [vals] * 4)
    gk, aggs, _valid = td.distributed_grouped_aggregate(tmesh, m, ks, vs, kinds)
    got = ([_bits(k) for k in gk], [_bits(a) for a in aggs])
    # JAX counts in a u64 stream of the values' dtype: compare the count's value
    assert got[0] == want[0] and got[1][:3] == want[1][:3]
    assert got[1][3] == [int(c) for c in want[1][3]]


def test_grouped_aggregate_all_filtered_out():
    tmesh = td.make_mesh(4, "cpu")
    n = 4 * 8
    m, ks, vs = _port_args(tmesh, np.zeros(n, bool), [np.arange(n, dtype=np.uint64)],
                           [np.ones(n, np.float64)])
    gk, aggs, valid = td.distributed_grouped_aggregate(tmesh, m, ks, vs, ["sum"])
    assert (gk[0].shape[0], aggs[0].dtype, valid.shape[0]) == (0, torch.float64, 0)
    gk, counts, valid = td.distributed_count_distinct(tmesh, m, ks, vs[0])
    assert (gk[0].shape[0], counts.shape[0], valid.shape[0]) == (0, 0, 0)


@pytest.mark.parametrize("seed", range(8))
def test_count_distinct_matches_jax(seed):
    rng = random.Random(1100 + seed)
    n_dev = rng.choice([1, 2, 4, 8])
    jmesh, tmesh = jd.make_mesh(n_dev), td.make_mesh(n_dev, "cpu")
    n = n_dev * rng.choice([16, 64, 512])
    npr = np.random.default_rng(rng.randrange(1 << 30))
    keys = npr.integers(0, rng.choice([1, 7, 40]), n).astype(np.uint64)
    vals = npr.integers(0, rng.choice([2, 25, 1 << 30]), n).astype(np.uint64)
    mask = npr.random(n) < rng.choice([0.0, 0.5, 1.0])
    want_k, want_c = _jax_grouped(lambda mesh, m, ks, vs: jd.distributed_count_distinct(
        mesh, m, ks, vs[0]), jmesh, mask, [keys], [vals])
    m, ks, vs = _port_args(tmesh, mask, [keys], [vals])
    with td.exchange_tally(tmesh) as tally:
        gk, counts, valid = td.distributed_count_distinct(tmesh, m, ks, vs[0],
                                                          keys_unsigned=[True])
    assert bool(valid.all())
    assert ([_bits(k) for k in gk], [_bits(counts)]) == (want_k, want_c)
    assert n_dev == 1 or mask.sum() == 0 or set(tally.by_op()) == {"distinct_gather"}


def test_count_distinct_two_keys_matches_jax():
    n = 8 * 128
    rng = np.random.default_rng(12)
    k1 = rng.integers(0, 4, n).astype(np.uint64) + np.uint64(1 << 63)
    k2 = rng.integers(-2, 3, n).astype(np.int64)
    vals = rng.integers(0, 9, n).astype(np.uint64)
    mask = rng.random(n) < 0.8
    jmesh, tmesh = jd.make_mesh(8), td.make_mesh(8, "cpu")
    want = _jax_grouped(lambda mesh, m, ks, vs: jd.distributed_count_distinct(
        mesh, m, ks, vs[0]), jmesh, mask, [k1, k2], [vals])
    m, ks, vs = _port_args(tmesh, mask, [k1, k2], [vals])
    gk, counts, _valid = td.distributed_count_distinct(tmesh, m, ks, vs[0],
                                                       keys_unsigned=[True, False])
    assert ([_bits(k) for k in gk], [_bits(counts)]) == want


def _jax_topk(jmesh, keys, ids, k, key_bound=None):
    kd, idd = jd.shard_table(jmesh, [keys, ids])
    v, i = jax.jit(lambda a, b: jd.distributed_topk(jmesh, a, b, k, key_bound=key_bound))(kd, idd)
    return np.asarray(v).astype(np.uint64).tolist(), np.asarray(i).tolist()


@pytest.mark.parametrize("seed", range(12))
def test_topk_matches_jax(seed):
    """test_fuzz_distributed_topk's cases: the keys and row ids equal the
    JAX function's, ties to the lowest position as ``lax.top_k``."""
    rng = random.Random(900 + seed)
    n_dev = rng.choice([1, 2, 4, 8])
    jmesh, tmesh = jd.make_mesh(n_dev), td.make_mesh(n_dev, "cpu")
    n = n_dev * rng.choice([16, 128])
    k = rng.choice([1, 5, 16])
    npr = np.random.default_rng(rng.randrange(1 << 30))
    keys = jax_fuzz._gen_keys(npr, rng.choice(jax_fuzz.KEY_PATTERNS), n)
    ids = np.arange(n, dtype=np.int64)
    want = _jax_topk(jmesh, keys, ids, k)
    with td.exchange_tally(tmesh) as tally:
        v, i = td.distributed_topk(tmesh, *td.shard_table(tmesh, [keys, ids]), k)
    assert (v.numpy().view(np.uint64).tolist(), i.tolist()) == want
    assert want[0] == np.sort(keys)[::-1][:k].tolist()
    assert set(tally.by_op()) == {"topk_gather"}


def test_topk_key_bound_and_high_keys_match_jax():
    """A key bound with a 32-bit span clamps every key into it (a key
    below the bound sinks to its floor) and runs the top-k as a u32;
    without a bound, keys at and above 2^63 and the sentinel."""
    jmesh, tmesh = jd.make_mesh(8), td.make_mesh(8, "cpu")
    n = 8 * 64
    rng = np.random.default_rng(6)
    base = (1 << 63) + 1000
    keys = rng.integers(-50, 5000, n).astype(np.int64).astype(np.uint64) + np.uint64(base)
    keys[[3, 100, 400]] = np.uint64(M64)
    ids = np.arange(n, dtype=np.int64)
    for bound in ((base, base + 4000), None):
        want = _jax_topk(jmesh, keys, ids, 20, bound)
        v, i = td.distributed_topk(tmesh, *td.shard_table(tmesh, [keys, ids]), 20,
                                   key_bound=bound)
        assert (v.numpy().view(np.uint64).tolist(), i.tolist()) == want, bound
