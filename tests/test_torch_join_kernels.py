"""The port's join kernels module (eventql_tpu_torch/kernels/join.py)
against the JAX package's (eventql_tpu/kernels/join.py).

The same seeded numpy inputs go through the JAX functions (the Pallas
kernels in interpret mode, as tests/test_device_join.py runs them on the
CPU) and through the port's counterparts on CPU tensors, where each
wrapper uses its kernel's plain version. Buckets, counts and integer
sums are exact, so every comparison is an equality (tolerance 0). A
dict lookup in plain Python is the third, independent answer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventql_tpu.kernels import join as jjoin
from eventql_tpu_torch.kernels import join as tjoin

TOP = np.uint64(1 << 63)


def _t(arr):
    """numpy -> torch; uint64 / uint32 / uint16 as the signed tensor of
    the same bits."""
    arr = np.ascontiguousarray(arr)
    signed = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint16): np.int16}.get(arr.dtype)
    return torch.from_numpy(arr.view(signed) if signed else arr)


def _lookup(fact, dim_keys, dim_bucket):
    lut = {}
    for k, b in zip(dim_keys, dim_bucket):
        lut.setdefault(int(k), int(b))  # the lowest dimension row wins
    return np.array([lut.get(int(k), -1) for k in fact], dtype=np.int32)


def _fingerprint_collision(lo, hi):
    """A key with the high word ``hi`` whose 32-bit fingerprint
    (eventql_tpu/kernels/join.py:_fingerprint) equals that of the key
    (high word 0, low word ``lo``)."""
    f = (((hi << 13) & 0xFFFFFFFF) | ((hi >> 19) & 0x1FFF)) ^ ((hi >> 7) & 0x01FFFFFF)
    return np.uint64((hi << 32) | (lo ^ f))


def _case(name):
    """(dim_keys u64[D], dim_bucket i32[D], fact_keys u64[n])."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one dim":
        dk = np.array([42], np.uint64)
        fact = rng.choice(np.array([41, 42, 43], np.uint64), 300)
    elif name == "half miss":
        dk = rng.permutation(np.arange(777, dtype=np.uint64) * 104729 + 11)
        fact = rng.integers(0, 777 * 2, 5000).astype(np.uint64) * 104729 + 11
    elif name == "top-bit keys":
        # keys on both sides of 2^63, and the two ends of the range
        dk = rng.permutation(np.arange(500, dtype=np.uint64) * 977 + 5)
        dk[::2] |= TOP
        dk = np.concatenate([dk, np.array([0, 0xFFFFFFFFFFFFFFFF], np.uint64)])
        fact = np.concatenate([
            dk[rng.integers(0, len(dk), 3000)],
            dk[rng.integers(0, len(dk), 500)] ^ TOP,  # same low bits: misses
            np.array([0, 1, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFE], np.uint64),
        ])
    elif name in ("8192 dims", "8193 dims"):
        d = int(name.split()[0])
        dk = rng.permutation(np.arange(d, dtype=np.uint64) * 104729 + 11)
        fact = rng.integers(0, d + d // 2, 4096).astype(np.uint64) * 104729 + 11
    elif name == "dims outnumber facts":
        dk = rng.permutation(np.arange(20_000, dtype=np.uint64) * 7 + 1)
        fact = rng.integers(0, 40_000, 1000).astype(np.uint64) * 7 + 1
    elif name == "one hot key":
        dk = np.arange(2000, dtype=np.uint64) * 5 + 2
        fact = np.concatenate([np.full(3000, 42 * 5 + 2, np.uint64),
                               rng.integers(0, 2000, 100).astype(np.uint64) * 5 + 2])
    else:
        raise KeyError(name)
    db = rng.integers(0, 70_000, len(dk)).astype(np.int32)
    return dk, db, fact


DIM_CASES = ["one dim", "half miss", "top-bit keys", "8192 dims"]
PROBE_CASES = DIM_CASES + ["8193 dims", "dims outnumber facts", "one hot key"]


@pytest.mark.parametrize("name", DIM_CASES)
def test_dim_join_gid_equals_pallas_dim_join_gid(name):
    dk, db, fact = _case(name)
    assert jjoin.dim_fingerprints_unique(dk)  # the JAX kernel's precondition
    # the JAX kernel recovers the bucket from two int8 limbs: 16 bits
    db = db % 65536
    want = np.asarray(jjoin.pallas_dim_join_gid(
        jnp.asarray(fact), jnp.asarray(dk), jnp.asarray(db)))
    got = tjoin.dim_join_gid(_t(fact), _t(dk), _t(db))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _lookup(fact, dk, db))
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_join_gid_equals_merge_join_gid(name):
    """merge_join_gid wants its facts sorted and answers in that order;
    the port probes in row order, so the JAX answer goes back through
    the sort permutation."""
    dk, db, fact = _case(name)
    db = db % 65536
    order = np.argsort(fact, kind="stable")
    want_sorted = np.asarray(jjoin.merge_join_gid(
        jnp.asarray(fact[order]), jnp.asarray(dk), jnp.asarray(db),
        block=1024, window=512))
    want = np.empty_like(want_sorted)
    want[order] = want_sorted
    sk, perm = tjoin.build_side(_t(dk))
    got = tjoin.probe_join_gid(_t(fact), sk, _t(db)[perm].contiguous())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _lookup(fact, dk, db))
    # the tier switch gives the same answer on either side of the boundary
    np.testing.assert_array_equal(tjoin.join_gid(_t(fact), _t(dk), _t(db)).numpy(), want)


@pytest.mark.parametrize("name", PROBE_CASES)
def test_whole_int32_bucket_comes_back(name):
    """Buckets beyond 16 bits (the JAX kernels cannot return them)."""
    dk, db, fact = _case(name)
    db = db + 1_000_000
    want = _lookup(fact, dk, db)
    np.testing.assert_array_equal(tjoin.join_gid(_t(fact), _t(dk), _t(db)).numpy(), want)


def test_colliding_fingerprints_are_an_ordinary_input():
    """Dimension keys whose fingerprints collide fail the JAX kernel's
    precondition (its caller then takes dim_join_gather); the port's
    dim_join_gid takes them, and agrees with dim_join_gather."""
    rng = np.random.default_rng(3)
    lows = rng.choice(1 << 31, 200, replace=False)
    dk = np.concatenate([
        lows.astype(np.uint64),
        np.array([_fingerprint_collision(int(lo), 1 + i) for i, lo in enumerate(lows)]),
    ])
    assert len(np.unique(dk)) == len(dk)
    assert not jjoin.dim_fingerprints_unique(dk)
    db = rng.integers(0, 512, len(dk)).astype(np.int32)
    fact = np.concatenate([dk[rng.integers(0, len(dk), 4000)],
                           rng.integers(0, 1 << 31, 1000).astype(np.uint64)])
    jsk, jperm = jjoin.build_side(jnp.asarray(dk))
    idx, matched = jjoin.dim_join_gather(jsk, jperm, jnp.asarray(fact))
    want = np.where(np.asarray(matched), db[np.maximum(np.asarray(idx), 0)], -1)
    got = tjoin.dim_join_gid(_t(fact), _t(dk), _t(db))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _lookup(fact, dk, db))


def test_empty_dimension_table_gives_all_misses():
    fact = np.array([1, 2, 3], np.uint64)
    none_k, none_b = np.array([], np.uint64), np.array([], np.int32)
    want = np.asarray(jjoin.merge_join_gid(
        jnp.asarray(fact), jnp.asarray(none_k), jnp.asarray(none_b)))
    assert list(want) == [-1, -1, -1]
    for fn in (tjoin.dim_join_gid, tjoin.probe_join_gid, tjoin.join_gid,
               tjoin.dim_join_gid_plain, tjoin.probe_join_gid_plain):
        assert list(fn(_t(fact), _t(none_k), _t(none_b)).numpy()) == [-1, -1, -1]


def test_duplicate_dimension_keys_take_the_lowest_row():
    dk = np.array([7, 9, 7, 3, 9, 7], np.uint64)
    db = np.array([10, 11, 12, 13, 14, 15], np.int32)
    fact = np.array([7, 9, 3, 8], np.uint64)
    assert list(tjoin.dim_join_gid(_t(fact), _t(dk), _t(db)).numpy()) == [10, 11, 13, -1]
    sk, perm = tjoin.build_side(_t(dk))
    got = tjoin.probe_join_gid(_t(fact), sk, _t(db)[perm].contiguous())
    assert list(got.numpy()) == [10, 11, 13, -1]


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_narrowed_fact_key_stream_zero_extends(dtype):
    """A fact key column whose values fit 16 / 32 bits reaches the
    probe as the signed tensor of that width; payloads with the narrow
    type's top bit set must not sign-extend."""
    rng = np.random.default_rng(8)
    top = np.iinfo(dtype).max
    dk = np.unique(np.concatenate([rng.integers(0, top, 300).astype(np.uint64),
                                   np.array([top, top - 1], np.uint64)]))
    dk = rng.permutation(dk)
    db = rng.integers(0, 99, len(dk)).astype(np.int32)
    fact = np.concatenate([dk[rng.integers(0, len(dk), 2000)],
                           rng.integers(0, top, 500).astype(np.uint64)]).astype(dtype)
    want = _lookup(fact, dk, db)
    assert (fact.view(np.dtype(dtype).str.replace("u", "i")) < 0).any()
    for n in (None, 1234):
        got = tjoin.join_gid(_t(fact), _t(dk), _t(db), n)
        np.testing.assert_array_equal(got.numpy(), want[:n])
        sk, perm = tjoin.build_side(_t(dk))
        got = tjoin.probe_join_gid(_t(fact), sk, _t(db)[perm].contiguous(), n)
        np.testing.assert_array_equal(got.numpy(), want[:n])


def test_torch_op_functions_equal_the_jax_functions():
    """build_side, probe_ranges, dim_join_gather, _gather_gid."""
    rng = np.random.default_rng(21)
    build = rng.integers(0, 50, 400).astype(np.uint64) * 3
    build[::5] |= TOP
    probe = np.concatenate([build[rng.integers(0, 400, 300)],
                            rng.integers(0, 200, 100).astype(np.uint64)])
    jsk, jperm = jjoin.build_side(jnp.asarray(build))
    sk, perm = tjoin.build_side(_t(build))
    np.testing.assert_array_equal(sk.numpy().view(np.uint64), np.asarray(jsk))
    # equal keys: both sorts are stable, so the permutations agree too
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    jstart, jcount = jjoin.probe_ranges(jsk, jnp.asarray(probe))
    start, count = tjoin.probe_ranges(sk, _t(probe))
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    jidx, jmatched = jjoin.dim_join_gather(jsk, jperm, jnp.asarray(probe))
    idx, matched = tjoin.dim_join_gather(sk, perm, _t(probe))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jmatched))
    np.testing.assert_array_equal(idx.numpy()[matched.numpy()],
                                  np.asarray(jidx)[np.asarray(jmatched)])
    assert (idx.numpy()[~matched.numpy()] == -1).all()
    bucket = rng.integers(0, 9, 400).astype(np.int32)
    mask = rng.random(len(probe)) < 0.7
    jgid, jm = jjoin._gather_gid(jnp.asarray(bucket), jidx, jmatched, jnp.asarray(mask))
    gid, m = tjoin._gather_gid(_t(bucket), idx, matched, _t(mask))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(gid.numpy()[m.numpy()], np.asarray(jgid)[np.asarray(jm)])


def _agg_inputs(n_dim, n_fact, K, seed, value_hi=1000):
    rng = np.random.default_rng(seed)
    dk = rng.permutation(np.arange(n_dim, dtype=np.uint64) * 104729 + 17)
    db = rng.integers(0, K, n_dim).astype(np.int32)
    fk = np.where(rng.random(n_fact) < 0.7,
                  rng.integers(0, n_dim, n_fact).astype(np.uint64) * 104729 + 17,
                  rng.integers(0, 1 << 62, n_fact).astype(np.uint64))
    fv = rng.integers(0, value_hi, n_fact).astype(np.uint64)
    mask = rng.random(n_fact) < 0.8
    return fk, fv, mask, dk, db


def _numpy_join_agg(fk, fv, mask, dk, db, K):
    gid = _lookup(fk, dk, db)
    ok = mask & (gid >= 0)
    counts = np.bincount(gid[ok], minlength=K).astype(np.uint64)
    sums = np.zeros(K, np.uint64)
    np.add.at(sums, gid[ok], fv[ok])
    return counts, sums


@pytest.mark.parametrize("n_dim", [200, 3000, tjoin.MAX_COMPARE_DIMS + 300])
def test_fact_dim_join_aggregate_equals_jax(n_dim):
    K = 16
    fk, fv, mask, dk, db = _agg_inputs(n_dim, 20_000, K, seed=n_dim)
    jc, js = jjoin.fact_dim_join_aggregate(
        jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(mask), jnp.asarray(dk),
        jnp.asarray(db), K)
    c, s = tjoin.fact_dim_join_aggregate(_t(fk), _t(fv), _t(mask), _t(dk), _t(db), K)
    np.testing.assert_array_equal(c.numpy().view(np.uint64), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy().view(np.uint64), np.asarray(js))
    ec, es = _numpy_join_agg(fk, fv, mask, dk, db, K)
    np.testing.assert_array_equal(np.asarray(jc), ec)
    np.testing.assert_array_equal(np.asarray(js), es)


@pytest.mark.parametrize("value_bits, key_bound", [(64, None), (21, None), (16, "span")])
def test_sorted_merge_join_aggregate_equals_jax(value_bits, key_bound):
    """value_bits and key_bound only made the TPU's sort cheaper: with
    values that fit value_bits the answers are the same with or without
    them, in both packages."""
    K = 64
    fk, fv, mask, dk, db = _agg_inputs(
        5000, 30_000, K, seed=value_bits, value_hi=1 << min(value_bits, 20))
    if key_bound == "span":
        # keys > 2^32 whose span fits 32 bits (the JAX hint's contract)
        fk = fk % np.uint64(1 << 31) + np.uint64(7_000_000_000)
        dk = np.unique(fk)[::3].copy()
        db = (np.arange(len(dk)) % K).astype(np.int32)
        key_bound = (int(fk.min()), int(fk.max()))
    jc, js = jjoin.sorted_merge_join_aggregate(
        jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(mask), jnp.asarray(dk),
        jnp.asarray(db), K, block=1024, window=512, value_bits=value_bits,
        key_bound=key_bound)
    c, s = tjoin.sorted_merge_join_aggregate(
        _t(fk), _t(fv), _t(mask), _t(dk), _t(db), K, block=1024, window=512,
        value_bits=value_bits, key_bound=key_bound)
    np.testing.assert_array_equal(c.numpy().view(np.uint64), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy().view(np.uint64), np.asarray(js))
    ec, es = _numpy_join_agg(fk, fv, mask, dk, db, K)
    np.testing.assert_array_equal(np.asarray(jc), ec)
    np.testing.assert_array_equal(np.asarray(js), es)
    assert int(ec.sum()) > 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    fact, dk, db = _t(np.arange(8, dtype=np.uint64)), _t(np.arange(4, dtype=np.uint64)), \
        _t(np.arange(4, dtype=np.int32))
    with pytest.raises(TypeError):
        tjoin.dim_join_gid(fact.to(torch.float64), dk, db)
    with pytest.raises(TypeError):
        tjoin.dim_join_gid(fact, dk, db.to(torch.int64))
    with pytest.raises(TypeError):
        tjoin.probe_join_gid(fact, dk, db[:3])
    with pytest.raises(ValueError):
        tjoin.dim_join_gid(fact, dk, db, n=9)
    with pytest.raises(ValueError):
        tjoin.dim_join_gid(fact[::2], dk, db)
    big = torch.arange(tjoin.MAX_COMPARE_DIMS + 1)
    with pytest.raises(ValueError):
        tjoin.dim_join_gid(fact, big, big.to(torch.int32))
    with pytest.raises(ValueError):
        tjoin.dim_join_gid_plain(fact, big, big.to(torch.int32))


def test_cpu_tensors_launch_nothing():
    before = dict(tjoin.LAUNCHES)
    dk, db, fact = _case("half miss")
    tjoin.join_gid(_t(fact), _t(dk), _t(db))
    assert tjoin.LAUNCHES == before


# -- the hash-table probe: dimension rows in any order, duplicates ---------------


def _merge_join_rows(fact, dk, db):
    """The JAX package's merge_join_gid (its Pallas kernel in interpret
    mode on the CPU) on the facts sorted, mapped back to row order."""
    order = np.argsort(fact, kind="stable")
    want_sorted = np.asarray(jjoin.merge_join_gid(
        jnp.asarray(fact[order]), jnp.asarray(dk), jnp.asarray(db),
        block=1024, window=512))
    want = np.empty_like(want_sorted)
    want[order] = want_sorted
    return want


def _reorder(dk, order):
    if order == "given":
        return np.arange(len(dk))
    if order == "reversed":
        return np.arange(len(dk))[::-1].copy()
    if order == "sorted":
        return np.argsort(dk, kind="stable")
    raise KeyError(order)


@pytest.mark.parametrize("order", ["given", "reversed", "sorted"])
@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_join_gid_takes_dimension_rows_in_any_order(name, order):
    """probe_join_gid is handed the dimension side as it comes: the same
    rows in three orders give merge_join_gid's answer, and dim_join_gid's
    where that one takes the table."""
    dk, db, fact = _case(name)
    db = db % 65536
    want = _merge_join_rows(fact, dk, db)
    o = _reorder(dk, order)
    got = tjoin.probe_join_gid(_t(fact), _t(dk[o]), _t(db[o]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if len(dk) <= tjoin.MAX_COMPARE_DIMS:
        np.testing.assert_array_equal(
            tjoin.dim_join_gid(_t(fact), _t(dk[o]), _t(db[o])).numpy(), want)


@pytest.mark.parametrize("n_dims", [10, 5000, 8193, 20_000])
def test_probe_join_gid_duplicate_keys_lowest_row_wins(n_dims):
    """Every third dimension key appears again further down with another
    bucket: the lowest row's bucket comes back, as from merge_join_gid
    given only each key's first row."""
    rng = np.random.default_rng(n_dims)
    dk = rng.permutation(np.arange(n_dims, dtype=np.uint64) * 104729 + 11)
    dk[::2] |= TOP
    dk = np.concatenate([dk, dk[::3]])
    db = rng.integers(0, 60_000, len(dk)).astype(np.int32)
    fact = np.concatenate([dk[rng.integers(0, len(dk), 3000)],
                           rng.integers(0, 1 << 40, 500).astype(np.uint64)])
    want = _lookup(fact, dk, db)
    got = tjoin.probe_join_gid(_t(fact), _t(dk), _t(db))
    np.testing.assert_array_equal(got.numpy(), want)
    _, first = np.unique(dk, return_index=True)
    first.sort()
    np.testing.assert_array_equal(_merge_join_rows(fact, dk[first], db[first]), want)
    np.testing.assert_array_equal(tjoin.join_gid(_t(fact), _t(dk), _t(db)).numpy(), want)
    if len(dk) <= tjoin.MAX_COMPARE_DIMS:
        np.testing.assert_array_equal(
            tjoin.dim_join_gid(_t(fact), _t(dk), _t(db)).numpy(), want)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("n_dims, tier", [(tjoin.MAX_COMPARE_DIMS, "dim_join_gid"),
                                          (tjoin.MAX_COMPARE_DIMS + 1, "probe_join_gid")])
def test_join_gid_hands_the_dimension_side_over_unsorted(monkeypatch, n_dims, tier):
    """On either side of the tier boundary join_gid passes the dimension
    tensors on as they are: it neither sorts nor gathers them."""
    dk, db, fact = _case(f"{n_dims} dims")
    t_dk, t_db = _t(dk), _t(db)
    seen = []
    real = getattr(tjoin, tier)

    def recording(fact_keys, dim_keys, dim_bucket, n=None):
        seen.append((dim_keys, dim_bucket))
        return real(fact_keys, dim_keys, dim_bucket, n)

    def no_sort(_keys):
        raise AssertionError("join_gid sorted the dimension side")

    monkeypatch.setattr(tjoin, tier, recording)
    monkeypatch.setattr(tjoin, "build_side", no_sort)
    monkeypatch.setattr(tjoin, tier + "_plain", lambda *a: torch.zeros(1))
    tjoin.join_gid(_t(fact), t_dk, t_db)
    assert len(seen) == 1 and seen[0][0] is t_dk and seen[0][1] is t_db


def test_sorted_merge_join_aggregate_hands_the_dimension_side_over_unsorted(monkeypatch):
    fk, fv, mask, dk, db = _agg_inputs(300, 2000, 8, seed=5)
    t_dk, t_db = _t(dk), _t(db)
    seen = []
    real = tjoin.probe_join_gid
    monkeypatch.setattr(
        tjoin, "probe_join_gid",
        lambda f, k, b, n=None: seen.append((k, b)) or real(f, k, b, n))
    c, _s = tjoin.sorted_merge_join_aggregate(_t(fk), _t(fv), _t(mask), t_dk, t_db, 8)
    assert len(seen) == 1 and seen[0][0] is t_dk and seen[0][1] is t_db
    assert int(c.sum()) > 0


@pytest.mark.parametrize("n_dims", [1, 2, 3, 4, 5, 8192, 8193, 1 << 18, (1 << 18) + 1,
                                    1 << 22, (1 << 30) - 1, 1 << 30, (1 << 31) - 1])
def test_table_slots_is_a_power_of_two_at_load_one_half(n_dims):
    slots = tjoin.table_slots(n_dims)
    assert slots & (slots - 1) == 0 and slots >= 2
    assert 2 * n_dims <= slots < max(4 * n_dims, 3)
    assert slots <= 1 << 32  # what the kernel's 32-bit slot index spans


@pytest.mark.parametrize("key_bytes", [2, 4, 8])
@pytest.mark.parametrize("n_dims", [1, 2, 3, 127, 1000, 1024, 2048, 2049, 3584, 4096,
                                    4097, 7000, 8192])
def test_dim_table_is_a_power_of_two_within_its_load_and_memory(n_dims, key_bytes):
    """dim_join_gid's shared-memory table: a power of two of slots, at a
    load of at most one half (an empty slot ends every search), at the
    measured load (1/8 for 8-byte slots, 1/4 for 12-byte ones) wherever
    the shared memory allows, never beyond a block's 227 KB."""
    t = tjoin.dim_table(n_dims, key_bytes)
    assert t.slots & (t.slots - 1) == 0 and t.slots >= 2 * n_dims
    assert t.slot_bytes == (12 if key_bytes == 8 else 8)
    assert t.key_bits == 8 * key_bytes
    assert t.slots * t.slot_bytes <= tjoin.DIM_TABLE_SHARED_BYTES < 227 * 1024
    per_row = tjoin.DIM_SLOTS_PER_ROW[t.slot_bytes]
    measured = 1 << (per_row * n_dims - 1).bit_length()
    if measured * t.slot_bytes <= tjoin.DIM_TABLE_SHARED_BYTES:
        assert t.slots == measured
    else:
        assert t.slots == tjoin.table_slots(n_dims) or (
            t.slots * t.slot_bytes <= tjoin.DIM_TABLE_SHARED_BYTES
            < 2 * t.slots * t.slot_bytes)


@pytest.mark.parametrize("n_dims, key_bytes, slots", [
    (1024, 4, 8192),  # the join query's: 64 KB, load 1/8
    (1024, 2, 8192),
    (1024, 8, 4096),  # 48 KB, load 1/4
    (2048, 8, 8192),  # 96 KB
    (4096, 8, 16384),  # 192 KB
    (4096, 4, 16384),  # 256 KB at 1/8 would not fit a block: load 1/4
    (8192, 2, 16384),  # load 1/2
    (8192, 4, 16384),
    (8192, 8, 16384),  # 192 KB, the largest table
])
def test_dim_table_slots_at_the_measured_shapes(n_dims, key_bytes, slots):
    assert tjoin.dim_table(n_dims, key_bytes).slots == slots


def test_dim_table_refuses_what_the_kernel_does_not_take():
    for n_dims, key_bytes in ((0, 4), (tjoin.MAX_COMPARE_DIMS + 1, 4), (100, 3), (100, 1)):
        with pytest.raises(ValueError):
            tjoin.dim_table(n_dims, key_bytes)


def _keys_past_the_word(rng, dtype=np.uint32, n_low=2000, n_high=1000):
    """Dimension keys that fit ``dtype`` (with its all-ones key) and keys
    beyond it: half of those carry the low bits of a narrow key of the
    set, half low bits that are no key. Returns (dim keys u64, fact keys
    as ``dtype``) with every key cut to the width among the facts, random
    keys of the width and its all-ones key."""
    bits = 8 * np.dtype(dtype).itemsize
    top = np.uint64((1 << bits) - 1)
    low = rng.choice(int(top), n_low + n_high, replace=False).astype(np.uint64)
    low[0] = top
    high_lo = np.concatenate([low[:n_high // 2], low[n_low:n_low + n_high - n_high // 2]])
    high = (rng.integers(1, 1 << 32, n_high).astype(np.uint64) << np.uint64(bits)) | high_lo
    dk = rng.permutation(np.concatenate([low[:n_low], high]))
    fact = np.concatenate([dk[rng.integers(0, len(dk), 4000)] & top,
                           rng.integers(0, 1 << bits, 1000).astype(np.uint64),
                           np.full(50, top, np.uint64)])
    return dk, rng.permutation(fact).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_narrow_table_needs_only_the_keys_of_the_streams_width(dtype):
    """A u16 / u32 stream can only equal a dimension key below 2^key_bits:
    the table that holds only those gives every answer of the full set."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    dk, fact = _keys_past_the_word(rng, dtype)
    db = rng.integers(0, 1 << 20, len(dk)).astype(np.int32)
    bits = tjoin.dim_table(len(dk), np.dtype(dtype).itemsize).key_bits
    held = dk < np.uint64(1 << bits)
    assert held.any() and not held.all()
    want = _lookup(fact, dk, db)
    assert (want >= 0).any() and (want < 0).any()
    np.testing.assert_array_equal(tjoin.dim_join_gid(_t(fact), _t(dk), _t(db)).numpy(), want)
    np.testing.assert_array_equal(
        tjoin.dim_join_gid(_t(fact), _t(dk[held]), _t(db[held])).numpy(), want)


def _narrow_case(name):
    """(dim_keys u64[D], dim_bucket i32[D], fact_keys stored narrow)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "u32 stream, dimension keys of 2^32 and more":
        dk, fact = _keys_past_the_word(rng)
    elif name == "the 32-bit all-ones key":
        dk = rng.permutation(np.concatenate([
            rng.choice(1 << 31, 600, replace=False).astype(np.uint64),
            np.array([0xFFFFFFFF, 0xFFFFFFFE, 0x1FFFFFFFF], np.uint64)]))
        fact = np.concatenate([dk[rng.integers(0, len(dk), 3000)] & np.uint64(0xFFFFFFFF),
                               np.full(300, 0xFFFFFFFF, np.uint64)])
        fact = rng.permutation(np.concatenate([fact, rng.integers(0, 1 << 32, 700).astype(
            np.uint64)])).astype(np.uint32)
    elif name == "8192 dims, u32 stream":
        dk = rng.permutation(np.arange(8192, dtype=np.uint64) * 104729 + 11)
        fact = (rng.integers(0, 8192 + 4096, 4096).astype(np.uint64) * 104729 + 11).astype(
            np.uint32)
    elif name == "8192 dims, u16 stream":
        dk = rng.choice(1 << 16, 8192, replace=False).astype(np.uint64)
        fact = rng.integers(0, 1 << 16, 4096).astype(np.uint16)
    else:
        raise KeyError(name)
    return dk, rng.integers(0, 70_000, len(dk)).astype(np.int32), fact


@pytest.mark.parametrize("name", ["u32 stream, dimension keys of 2^32 and more",
                                  "the 32-bit all-ones key", "8192 dims, u32 stream",
                                  "8192 dims, u16 stream"])
def test_dim_join_gid_plain_equals_pallas_on_narrow_streams(name):
    """dim_join_gid_plain (what the kernel is held against on the card)
    against the JAX kernel in interpret mode on the narrow streams the
    narrow table serves."""
    dk, db, fact = _narrow_case(name)
    assert jjoin.dim_fingerprints_unique(dk)
    db = db % 65536
    want = np.asarray(jjoin.pallas_dim_join_gid(
        jnp.asarray(fact), jnp.asarray(dk), jnp.asarray(db)))
    got = tjoin.dim_join_gid_plain(_t(fact), _t(dk), _t(db))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _lookup(fact, dk, db))
    assert (want >= 0).any() and (want < 0).any()
    if "all-ones" in name:
        assert (want[fact == 0xFFFFFFFF] == db[dk == 0xFFFFFFFF][0]).all()


def test_table_slots_needs_a_dimension_row():
    with pytest.raises(ValueError):
        tjoin.table_slots(0)


def test_build_join_table_is_for_the_card_only():
    """The table exists on the card alone: the plain version has none,
    and a CPU tensor raises instead of building one some other way."""
    with pytest.raises(ValueError):
        tjoin.build_join_table(_t(np.arange(4, dtype=np.uint64)),
                               _t(np.arange(4, dtype=np.int32)))
    assert tjoin.LAUNCHES["build_join_table"] == 0
