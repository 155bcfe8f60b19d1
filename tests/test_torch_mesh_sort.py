"""The port's distributed sorts (eventql_tpu_torch/parallel/distributed.py:
``distributed_sort``, ``distributed_order_permutation``,
``distributed_bucket_sort``) against the JAX package's.

Seeded numpy inputs (the key patterns of tests/test_fuzz_distributed.py,
the cases of tests/test_distributed_sort.py) go through the JAX functions
over the virtual CPU mesh (conftest), each call under ``jax.jit`` as the
JAX mesh routes run them, and through the port's functions on
``make_mesh(P, "cpu")``. Tolerance 0: the sorted keys, and every output
of the bucket sort shard by shard (keys, row-id payloads, per-shard
counts, the overflow flag), equal the JAX outputs; rows equal on every
key may come out of the compare-split in another order, so payloads are
compared where the keys order every row (a row id as the last key).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import test_fuzz_distributed as jax_fuzz

from eventql_tpu.parallel import distributed as jd
from eventql_tpu_torch.parallel import distributed as td

U64_MAX = np.uint64((1 << 64) - 1)


def _meshes(P):
    return jd.make_mesh(P), td.make_mesh(P, "cpu")


def _u64(parts):
    return torch.cat(list(parts)).numpy().view(np.uint64)


def _i64(parts):
    return torch.cat(list(parts)).numpy()


def _keys(pattern, n, seed):
    """A key column: the fuzz file's patterns, or keys at and above 2^63
    with the sentinel among them."""
    npr = np.random.default_rng(seed)
    if pattern == "high":
        k = npr.integers(0, 1 << 62, n).astype(np.uint64) + np.uint64(3 << 62)
        k[npr.random(n) < 0.1] = U64_MAX
        k[: n // 8] = np.uint64(1 << 63)
        return k
    return jax_fuzz._gen_keys(npr, pattern, n)


def _jax_sort(jmesh, keys, pays, key_bounds=None):
    sharded = jd.shard_table(jmesh, list(keys) + list(pays))
    nk = len(keys)
    fn = jax.jit(lambda ks, ps: jd.distributed_sort(jmesh, ks, ps, key_bounds=key_bounds))
    sk, sp = fn(tuple(sharded[:nk]), tuple(sharded[nk:]))
    return [np.asarray(k) for k in sk], [np.asarray(p) for p in sp]


def _port_sort(tmesh, keys, pays, key_bounds=None):
    sharded = td.shard_table(tmesh, list(keys) + list(pays))
    nk = len(keys)
    return td.distributed_sort(tmesh, sharded[:nk], sharded[nk:], key_bounds=key_bounds)


PATTERNS = ["uniform", "dups", "sorted", "reverse", "equal", "high"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("P", [1, 2, 8])
def test_sort_matches_jax(P, pattern):
    """One key with row ids as payload: the sorted keys equal the JAX
    function's shard by shard (the output is balanced), and each row id
    holds its key. With the row id as a second key every row is ordered,
    and the payload equals JAX's too."""
    jmesh, tmesh = _meshes(P)
    n = P * 64
    keys = _keys(pattern, n, seed=P * 10 + PATTERNS.index(pattern))
    ids = np.arange(n, dtype=np.int64)
    (jk,), (jp,) = _jax_sort(jmesh, [keys], [ids])
    (tk,), (tp,) = _port_sort(tmesh, [keys], [ids])
    assert [len(t) for t in tk] == [n // P] * P
    assert np.array_equal(_u64(tk), jk) and np.array_equal(jk, np.sort(keys))
    assert np.array_equal(keys[_i64(tp)], jk) and np.array_equal(np.sort(_i64(tp)), ids)
    (jk, jr), (jv,) = _jax_sort(jmesh, [keys, ids.astype(np.uint64)], [keys * np.uint64(3)])
    (tk, tr), (tv,) = _port_sort(tmesh, [keys, ids.astype(np.uint64)], [keys * np.uint64(3)])
    assert np.array_equal(_u64(tk), jk) and np.array_equal(_u64(tr), jr)
    assert np.array_equal(_u64(tv), jv)


def test_two_keys_and_bounds_match_jax():
    """Two keys lexicographic (a narrow key under a static bound, sorted
    as a u32 and returned as the u64 it was, and a key spanning all 64
    bits), two payload columns riding along."""
    jmesh, tmesh = _meshes(8)
    n = 8 * 128
    rng = np.random.default_rng(23)
    base = 5_000_000_000  # beyond 2^32: only the span fits 32 bits
    a = (base + rng.integers(0, 1000, n)).astype(np.uint64)
    b = _keys("high", n, seed=5)
    ids = np.arange(n, dtype=np.uint64)
    bounds = ((base, base + 1000), None, None)
    (ja, jb, jr), (j1, j2) = _jax_sort(jmesh, [a, b, ids], [b ^ a, ids.astype(np.int64)],
                                        bounds)
    with td.exchange_tally(tmesh) as tally:
        (ta, tb, tr), (t1, t2) = _port_sort(tmesh, [a, b, ids], [b ^ a, ids.astype(np.int64)],
                                            bounds)
    assert ta[0].dtype == torch.int64
    for got, want in ((ta, ja), (tb, jb), (tr, jr), (t1, j1)):
        assert np.array_equal(_u64(got), want.astype(np.uint64))
    assert np.array_equal(_i64(t2), j2)
    # 6 stages of P = 8; each moves every shard's run: the narrowed key
    # (4 bytes), two u64 keys and two payloads (8 each)
    assert tally.by_op() == {"sort_exchange": 6 * n * (4 + 4 * 8)}


def test_sort_of_narrow_and_mask_keys():
    """A bool leading key and an int32 (u32) key, as the mesh ORDER BY's
    compare-split sorts them, against a numpy lexsort."""
    tmesh = td.make_mesh(4, "cpu")
    n = 4 * 50
    rng = np.random.default_rng(4)
    lead = rng.random(n) < 0.3
    k32 = rng.integers(0, 1 << 32, n).astype(np.uint32)
    ids = np.arange(n, dtype=np.int64)
    (tl, tk, tr), () = td.distributed_sort(tmesh, td.shard_table(tmesh, [lead, k32, ids]))
    want = np.lexsort([ids, k32, lead])
    assert np.array_equal(_i64(tr), want)
    assert np.array_equal(torch.cat(tl).numpy(), lead[want])
    assert np.array_equal(torch.cat(tk).numpy().view(np.uint32), k32[want])


def test_non_power_of_two_raises():
    tmesh = td.make_mesh(3, "cpu")
    keys = td.shard_table(tmesh, [np.arange(6, dtype=np.uint64)])
    with pytest.raises(ValueError, match="power-of-two"):
        td.distributed_sort(tmesh, keys)
    with pytest.raises(ValueError, match="power-of-two"):
        td.distributed_grouped_aggregate_sharded(
            tmesh, None, keys, keys, ["sum"])


ORDER_CASES = {
    "int32_asc": ([np.int32], [False]),
    "int32_desc": ([np.int32], [True]),
    "uint16_desc": ([np.uint16], [True]),
    "int64_then_uint64_desc": ([np.int64, np.uint64], [False, True]),
    "bool_then_uint32": ([np.bool_, np.uint32], [True, False]),
}


def _column(dtype, n, rng):
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if dtype == np.uint64:
        return rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2)
    info = np.iinfo(dtype)
    lo, hi = (int(info.min), int(info.max)) if dtype != np.int64 else (-1000, 1000)
    return rng.integers(lo, hi, n, endpoint=True).astype(dtype)


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_order_permutation_matches_jax(case):
    """The ORDER BY permutation of narrow and wide columns, ascending and
    descending: the columns in the port's order equal them in the JAX
    function's, and the permutation holds every row once."""
    dtypes, descs = ORDER_CASES[case]
    jmesh, tmesh = _meshes(8)
    n = 8 * 64
    rng = np.random.default_rng(len(case))
    cols = [_column(dt, n, rng) for dt in dtypes]
    jcols = jd.shard_table(jmesh, cols)
    jperm = np.asarray(jax.jit(functools.partial(
        jd.distributed_order_permutation, jmesh, descendings=descs))(jcols))
    tperm = _i64(td.distributed_order_permutation(
        tmesh, td.shard_table(tmesh, cols), descs,
        [np.dtype(dt).kind in "ub" for dt in dtypes]))
    assert np.array_equal(np.sort(tperm), np.arange(n))
    for c in cols:
        assert np.array_equal(c[tperm], c[jperm])


def _jax_bucket(jmesh, keys, pay, **kw):
    kd, pd = jd.shard_table(jmesh, [keys, pay])
    fn = jax.jit(lambda k, p: jd.distributed_bucket_sort(jmesh, k, p, **kw))
    return [np.asarray(x) for x in fn(kd, pd)]


BUCKET_PATTERNS = ["uniform", "sorted", "reverse", "equal", "zipf", "high", "filtered"]


@pytest.mark.parametrize("pattern", BUCKET_PATTERNS)
@pytest.mark.parametrize("P", [1, 2, 8])
def test_bucket_sort_matches_jax(P, pattern):
    """Keys, row-id payloads, per-shard counts and the overflow flag equal
    the JAX function's shard by shard; all-equal keys overflow, and so do
    sorted or reverse-sorted keys on 8 shards (a shard's whole run falls
    in one bucket). Where nothing overflowed, the valid prefixes hold the
    non-sentinel keys in order."""
    jmesh, tmesh = _meshes(P)
    n = P * 256
    if pattern == "filtered":  # most rows keyed to the sentinel, as a WHERE makes them
        keys = _keys("uniform", n, seed=P)
        keys[np.random.default_rng(P).random(n) < 0.9] = U64_MAX
    else:
        keys = _keys(pattern, n, seed=P + 100 * BUCKET_PATTERNS.index(pattern))
    ids = np.arange(n, dtype=np.uint64)
    jk, jp, jc, jo = _jax_bucket(jmesh, keys, ids)
    with td.exchange_tally(tmesh) as tally:
        tk, tp, tc, to = td.distributed_bucket_sort(tmesh, *td.shard_table(tmesh, [keys, ids]))
    assert np.array_equal(_u64(tk), jk)
    assert np.array_equal(_u64(tp), jp)
    assert tc.numpy().tolist() == jc.tolist() and bool(to) == bool(jo)
    assert set(tally.by_op()) == ({"bucket_samples", "bucket_all_to_all", "bucket_overflow"}
                                  if P > 1 else {"bucket_samples", "bucket_overflow"})
    if pattern == "equal" and P > 2:  # a shard's run outgrows C = 2 n_local / P
        assert bool(to)
    if not bool(to):
        cap = len(tk[0])
        got = np.concatenate([_u64([t])[:c] for t, c in zip(tk, tc.tolist())])
        assert np.array_equal(got, np.sort(keys[keys != U64_MAX]))
        assert cap == max(1, int(2.0 * (n // P) / P)) * P


def test_bucket_sort_capacity_and_oversample_match_jax():
    """A tighter capacity that overflows on skewed keys and a larger
    oversample, each against the JAX function."""
    jmesh, tmesh = _meshes(4)
    n = 4 * 512
    keys = _keys("zipf", n, seed=9)
    ids = np.arange(n, dtype=np.uint64)
    for kw in ({"capacity_factor": 1.0}, {"oversample": 200, "capacity_factor": 3.0}):
        jk, jp, jc, jo = _jax_bucket(jmesh, keys, ids, **kw)
        tk, tp, tc, to = td.distributed_bucket_sort(
            tmesh, *td.shard_table(tmesh, [keys, ids]), **kw)
        assert np.array_equal(_u64(tk), jk) and np.array_equal(_u64(tp), jp)
        assert tc.numpy().tolist() == jc.tolist() and bool(to) == bool(jo), kw


def test_bucket_sort_without_payload():
    jmesh, tmesh = _meshes(8)
    keys = _keys("uniform", 8 * 64, seed=3)
    jk, _jp, jc, jo = jax.jit(lambda k: jd.distributed_bucket_sort(jmesh, k))(
        jd.shard_table(jmesh, [keys])[0])
    tk, tp, tc, to = td.distributed_bucket_sort(tmesh, td.shard_table(tmesh, [keys])[0])
    assert tp is None
    assert np.array_equal(_u64(tk), np.asarray(jk))
    assert tc.numpy().tolist() == np.asarray(jc).tolist() and bool(to) == bool(jo)
