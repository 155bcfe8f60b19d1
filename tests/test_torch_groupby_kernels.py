"""The port's GROUP BY kernels against the TPU kernels they replace.

The same numpy inputs (made from a seed) go through the Pallas kernels
of eventql_tpu/kernels/pallas_groupby.py (interpret mode on the CPU
backend) and through the wrappers of
eventql_tpu_torch/kernels/groupby_agg.py on CPU tensors, where each
wrapper runs its plain PyTorch version. Tolerance: none. Integer adds
commute, so counts and sums (mod 2^64) must agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventql_tpu.kernels.pallas_groupby import (
    pallas_count,
    pallas_count_fused,
    pallas_multi_sum,
    pallas_sum_count,
    pallas_sum_count_fused,
)
from eventql_tpu_torch.kernels import groupby_agg as ga

# -- the TPU kernels' entry points, expressed with the port's wrappers --------
# The port has two wrappers, groupby_agg and groupby_multi_agg. These
# adapters give them the pallas_* signatures, so each test calls both
# sides with the same arguments.


def sum_count(mask, gid, values, num_buckets, value_bits=64, **unsigned):
    """``pallas_sum_count``: (counts, sums), int64[K] each."""
    out = ga.groupby_agg(gid, gid.shape[0], num_buckets, values=values,
                         value_bits=value_bits, mask=mask, **unsigned)
    return out[0], out[1]


def count(mask, gid, num_buckets):
    """``pallas_count``: int64[K]."""
    return ga.groupby_agg(gid, gid.shape[0], num_buckets, mask=mask)[0]


def sum_count_fused(gid, values, thr, n_real, num_buckets, pred=None,
                    value_bits=32, pred_op="lt", gid_base=0, pred2=None,
                    pred2_op=None, thr2=0, pred2_is_value=False,
                    pred_combine="and", gid_unsigned=False,
                    values_unsigned=False, pred_unsigned=False,
                    pred2_unsigned=False):
    """``pallas_sum_count_fused``: ``pred`` defaults to the value stream
    itself; rows >= n_real are ignored."""
    if pred is None:
        preds = [ga.Pred("value", pred_op, thr)]
    else:
        preds = [ga.Pred("stream", pred_op, thr, pred, pred_unsigned)]
    if pred2_op is not None:
        if pred2_is_value:
            preds.append(ga.Pred("value", pred2_op, thr2))
        else:
            preds.append(
                ga.Pred("stream", pred2_op, thr2, pred2, pred2_unsigned))
    out = ga.groupby_agg(gid, min(int(n_real), gid.shape[0]), num_buckets,
                         values=values, value_bits=value_bits, preds=preds,
                         combine=pred_combine, gid_base=gid_base,
                         gid_unsigned=gid_unsigned,
                         values_unsigned=values_unsigned)
    return out[0], out[1]


def count_fused(gid, thr, n_real, num_buckets, pred=None, pred_op="ge",
                gid_base=0, pred_on_gid=False, pred2=None, pred2_op=None,
                thr2=0, pred_combine="and"):
    """``pallas_count_fused``: without ``pred`` the compare reads the key
    stream itself (before the base subtract)."""
    if pred is not None and not pred_on_gid:
        preds = [ga.Pred("stream", pred_op, thr, pred)]
    else:
        preds = [ga.Pred("gid", pred_op, thr)]
    if pred2_op is not None:
        if pred2 is not None:
            preds.append(ga.Pred("stream", pred2_op, thr2, pred2))
        else:
            preds.append(ga.Pred("gid", pred2_op, thr2))
    return ga.groupby_agg(gid, min(int(n_real), gid.shape[0]), num_buckets,
                          preds=preds, combine=pred_combine,
                          gid_base=gid_base)[0]


def multi_sum(mask, gid, streams, stream_limbs, num_buckets,
              streams_unsigned=None):
    """``pallas_multi_sum``: ``stream_limbs[s]`` is the payload width of
    stream s in bytes. Returns (counts, sums per stream)."""
    out = ga.groupby_multi_agg(gid, gid.shape[0], num_buckets, streams,
                               [8 * nl for nl in stream_limbs], mask=mask,
                               streams_unsigned=streams_unsigned)
    return out[0], tuple(out[1:])


_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def _t(arr):
    """numpy -> torch tensor of the same bits (unsigned as signed)."""
    if arr is None:
        return None
    arr = np.ascontiguousarray(arr)
    view = _SIGNED.get(arr.dtype)
    return torch.from_numpy(arr.view(view) if view else arr)


def _u16(arr):
    return arr is not None and arr.dtype == np.uint16


def _u64(t):
    return t.numpy().view(np.uint64)


def _same(jax_out, torch_out):
    a = np.asarray(jax_out).astype(np.uint64)
    b = _u64(torch_out)
    assert a.shape == b.shape
    assert np.array_equal(a, b)


def _stream(rng, dtype, hi, n):
    return rng.integers(0, hi, n).astype(dtype)


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_sum_count_fused_ops(op):
    """Every compare op on the value stream itself; n_real < n drops
    the tail rows in both."""
    rng = np.random.default_rng(3)
    n, K, thr = 5000, 300, 512
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    vals[::97] = thr  # make eq / ne see both outcomes
    jc, js = pallas_sum_count_fused(
        jnp.asarray(gid), jnp.asarray(vals), jnp.int32(thr),
        jnp.int32(n - 37), K, value_bits=16, pred_op=op,
    )
    tc, ts = sum_count_fused(
        _t(gid), _t(vals), thr, n - 37, K, value_bits=16, pred_op=op,
    )
    _same(jc, tc)
    _same(js, ts)
    assert int(_u64(tc).sum()) > 0


@pytest.mark.parametrize(
    "gid_dt,val_dt,pred_dt,value_bits",
    [
        (np.int16, np.uint16, np.uint16, 16),  # unsigned payloads > 2^15
        (np.uint16, np.uint16, np.int16, 16),
        (np.int32, np.uint32, np.uint16, 32),
        (np.int16, np.uint64, np.int32, 64),
        (np.int32, np.int16, np.int32, 32),  # signed 16-bit values sign-extend
    ],
)
def test_sum_count_fused_widths(gid_dt, val_dt, pred_dt, value_bits):
    """Key, value and predicate streams at every stored width."""
    rng = np.random.default_rng(4)
    n, K = 4000, 129
    gid = rng.integers(0, K, n).astype(gid_dt)
    val_hi = {np.uint16: 60000, np.uint32: 1 << 32, np.uint64: 1 << 62,
              np.int16: 1 << 15}[val_dt]
    vals = _stream(rng, val_dt, val_hi, n)
    if val_dt == np.int16:
        vals = (vals - 9000).astype(np.int16)
    pred_hi = {np.uint16: 65535, np.int16: 1 << 15, np.int32: 200000}[pred_dt]
    pred = _stream(rng, pred_dt, pred_hi, n)
    thr = pred_hi // 2
    jc, js = pallas_sum_count_fused(
        jnp.asarray(gid), jnp.asarray(vals), jnp.int32(thr), jnp.int32(n), K,
        pred=jnp.asarray(pred), value_bits=value_bits, pred_op="ge",
    )
    tc, ts = sum_count_fused(
        _t(gid), _t(vals), thr, n, K, pred=_t(pred), value_bits=value_bits,
        pred_op="ge", gid_unsigned=_u16(gid), values_unsigned=_u16(vals),
        pred_unsigned=_u16(pred),
    )
    _same(jc, tc)
    _same(js, ts)


@pytest.mark.parametrize("combine", ["and", "or"])
@pytest.mark.parametrize("second", ["value", "stream"])
def test_sum_count_fused_two_predicates(combine, second):
    rng = np.random.default_rng(6)
    n, K = 4000, 64
    gid = rng.integers(0, K, n).astype(np.int16)
    vals = rng.integers(0, 1000, n).astype(np.uint16)
    pred2 = rng.integers(0, 1 << 20, n).astype(np.int32)
    kw = dict(value_bits=16, pred_op="ge", pred2_op="lt",
              pred_combine=combine)
    if second == "value":
        jkw = dict(kw, thr2=jnp.int32(700), pred2_is_value=True)
        tkw = dict(kw, thr2=700, pred2_is_value=True)
        p2j = p2t = None
    else:
        jkw = dict(kw, thr2=jnp.int32(1 << 19))
        tkw = dict(kw, thr2=1 << 19)
        p2j, p2t = jnp.asarray(pred2), _t(pred2)
    jc, js = pallas_sum_count_fused(
        jnp.asarray(gid), jnp.asarray(vals), jnp.int32(100), jnp.int32(n), K,
        pred2=p2j, **jkw,
    )
    tc, ts = sum_count_fused(
        _t(gid), _t(vals), 100, n, K, pred2=p2t, values_unsigned=True, **tkw,
    )
    _same(jc, tc)
    _same(js, ts)


@pytest.mark.parametrize("base", [-1000, 0, 20_000_000])
def test_count_fused_gid_base(base):
    """Count-only form: always-true compare, compare on the key itself
    (before the base subtract), separate stream, second compare on the
    key; numeric-key base negative, zero and far above the bucket span."""
    rng = np.random.default_rng(9)
    n, K = 4000, 200
    keys = rng.integers(base, base + K, n).astype(np.int32)
    pred = rng.integers(0, 1000, n).astype(np.int32)
    jk, tk = jnp.asarray(keys), _t(keys)

    _same(
        pallas_count_fused(jk, jnp.int32(-(1 << 31)), jnp.int32(n), K,
                           pred_op="ge", gid_base=jnp.int32(base)),
        count_fused(tk, -(1 << 31), n, K, pred_op="ge", gid_base=base),
    )
    thr = base + 77
    _same(
        pallas_count_fused(jk, jnp.int32(thr), jnp.int32(n), K, pred_op="lt",
                           pred_on_gid=True, gid_base=jnp.int32(base)),
        count_fused(tk, thr, n, K, pred_op="lt", pred_on_gid=True,
                       gid_base=base),
    )
    _same(
        pallas_count_fused(jk, jnp.int32(500), jnp.int32(n), K,
                           pred=jnp.asarray(pred), pred_op="ge",
                           gid_base=jnp.int32(base), pred2_op="ge",
                           thr2=jnp.int32(base + 20)),
        count_fused(tk, 500, n, K, pred=_t(pred), pred_op="ge",
                       gid_base=base, pred2_op="ge", thr2=base + 20),
    )


def test_count_fused_u32_base_wraps():
    """A u32 key stream whose payloads read as negative int32: the
    modular base subtract still lands in [0, K)."""
    rng = np.random.default_rng(10)
    n, K, base = 3000, 150, (1 << 32) - 400
    keys = (rng.integers(0, K, n) + base).astype(np.uint32)
    base_i32 = ((base & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    jc = pallas_count_fused(
        jnp.asarray(keys).astype(jnp.int32), jnp.int32(-(1 << 31)),
        jnp.int32(n), K, pred_op="ge", gid_base=jnp.int32(base_i32),
    )
    tc = count_fused(_t(keys), -(1 << 31), n, K, pred_op="ge",
                        gid_base=base)
    _same(jc, tc)
    assert int(_u64(tc).sum()) == n


def test_count_fused_all_rows_filtered():
    rng = np.random.default_rng(11)
    n, K = 2000, 40
    gid = rng.integers(0, K, n).astype(np.int16)
    pred = rng.integers(0, 100, n).astype(np.int16)
    jc = pallas_count_fused(jnp.asarray(gid), jnp.int32(1000), jnp.int32(n),
                            K, pred=jnp.asarray(pred), pred_op="gt")
    tc = count_fused(_t(gid), 1000, n, K, pred=_t(pred), pred_op="gt")
    _same(jc, tc)
    assert int(_u64(tc).sum()) == 0


@pytest.mark.parametrize("K", [1, 1024, 70000])
def test_count_fused_bucket_counts(K):
    """One bucket, a mid-size table and K > 65536 (past the 16-bit key
    range and the TPU kernel's single-pass bound) at a tiny n."""
    rng = np.random.default_rng(12)
    n = 3000
    gid = rng.integers(-3, K + 3, n).astype(np.int32)  # some out of range
    jc = pallas_count_fused(jnp.asarray(gid), jnp.int32(-(1 << 31)),
                            jnp.int32(n), K, pred_op="ge")
    tc = count_fused(_t(gid), -(1 << 31), n, K, pred_op="ge")
    _same(jc, tc)


@pytest.mark.parametrize("value_bits", [16, 32, 48, 64])
def test_sum_count_masked(value_bits):
    """Row-mask form (pallas_sum_count): only the low value_bits of each
    value are summed, and 64-bit sums wrap mod 2^64."""
    rng = np.random.default_rng(8)
    n, K = 4000, 37
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    mask = rng.random(n) < 0.7
    jc, js = pallas_sum_count(jnp.asarray(mask), jnp.asarray(gid),
                              jnp.asarray(vals), K, value_bits=value_bits)
    tc, ts = sum_count(_t(mask), _t(gid), _t(vals), K,
                          value_bits=value_bits)
    _same(jc, tc)
    _same(js, ts)


def test_sum_count_masked_large_k():
    rng = np.random.default_rng(13)
    n, K = 3000, 66000
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1 << 48, n).astype(np.uint64)
    mask = rng.random(n) < 0.7
    jc, js = pallas_sum_count(jnp.asarray(mask), jnp.asarray(gid),
                              jnp.asarray(vals), K, value_bits=48)
    tc, ts = sum_count(_t(mask), _t(gid), _t(vals), K, value_bits=48)
    _same(jc, tc)
    _same(js, ts)


def test_count_masked():
    rng = np.random.default_rng(14)
    n, K = 5000, 1024
    gid = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    _same(pallas_count(jnp.asarray(mask), jnp.asarray(gid), K),
          count(_t(mask), _t(gid), K))


@pytest.mark.parametrize(
    "limbs,K", [((2, 4), 300), ((2, 3, 1), 300), ((3,) * 5, 3000)]
)
def test_multi_sum(limbs, K):
    """Several summed streams under one pass: each stream's low
    8*limbs bits, sums exact mod 2^64 (not truncated to the payload)."""
    rng = np.random.default_rng(1)
    n = 4000
    gid = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    streams = [
        rng.integers(0, 1 << 32, n, dtype=np.uint32).view(np.int32)
        for _ in limbs
    ]
    jc, jt = pallas_multi_sum(
        jnp.asarray(mask), jnp.asarray(gid),
        tuple(jnp.asarray(s) for s in streams), tuple(limbs), K,
    )
    tc, tt = multi_sum(_t(mask), _t(gid), [_t(s) for s in streams],
                          tuple(limbs), K)
    _same(jc, tc)
    assert len(jt) == len(tt) == len(limbs)
    for a, b in zip(jt, tt):
        _same(a, b)


def test_multi_sum_narrow_streams():
    """The route hands the narrowed u16 / u32 columns over as stored:
    same sums as the TPU kernel fed their int32 words."""
    rng = np.random.default_rng(2)
    n, K = 4000, 20
    gid = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    a = rng.integers(0, 1 << 16, n).astype(np.uint16)
    b = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    jc, jt = pallas_multi_sum(
        jnp.asarray(mask), jnp.asarray(gid),
        (jnp.asarray(a).astype(jnp.int32), jnp.asarray(b).astype(jnp.int32)),
        (2, 4), K,
    )
    tc, tt = multi_sum(_t(mask), _t(gid), [_t(a), _t(b)], (2, 4), K,
                          streams_unsigned=(True, True))
    _same(jc, tc)
    for x, y in zip(jt, tt):
        _same(x, y)
    want = np.bincount(gid[mask], weights=b[mask].astype(np.float64),
                       minlength=K).astype(np.uint64)
    assert np.array_equal(_u64(tt[1]), want)


def test_wrappers_reject_bad_input():
    gid = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        ga.groupby_agg(gid, 11, 4)
    with pytest.raises(ValueError):
        ga.groupby_agg(gid[::2], 5, 4)
    with pytest.raises(TypeError):
        ga.groupby_agg(gid.to(torch.float32), 10, 4)
    with pytest.raises(ValueError):
        ga.groupby_agg(gid, 10, 4, preds=[ga.Pred("value", "lt", 1)])
    with pytest.raises(ValueError):
        ga.groupby_multi_agg(gid, 10, 4, [], [])


def test_cpu_tensors_never_launch():
    before = dict(ga.LAUNCHES)
    gid = torch.arange(10, dtype=torch.int32) % 3
    out = ga.groupby_agg(gid, 10, 3)
    assert out.tolist() == [[4, 3, 3]]
    assert ga.LAUNCHES == before


# -- streams that start inside an allocation, and the shortest streams ----------
# The kernel reads runs of rows with 16-byte loads where a stream starts
# on a 16-byte boundary and falls back to scalar loads where it does not;
# the wrapper must hand both over unchanged. On the CPU these cases pin
# the wrapper and the plain version at the same offsets and lengths the
# card's tests use.


@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("n", list(range(1, 18)))
def test_sum_count_fused_on_sliced_streams(offset, n):
    """Key, value and predicate streams sliced ``offset`` rows into
    their allocations, n = 1 .. 17 rows."""
    rng = np.random.default_rng(100 * offset + n)
    K = 5
    gid = rng.integers(-1, K + 1, n + offset).astype(np.int16)
    vals = rng.integers(0, 60000, n + offset).astype(np.uint16)
    pred = rng.integers(0, 1000, n + offset).astype(np.int32)
    jc, js = pallas_sum_count_fused(
        jnp.asarray(gid[offset:]), jnp.asarray(vals[offset:]), jnp.int32(700),
        jnp.int32(n), K, pred=jnp.asarray(pred[offset:]), value_bits=16,
        pred_op="lt",
    )
    tg, tv, tp = _t(gid)[offset:], _t(vals)[offset:], _t(pred)[offset:]
    assert tg.storage_offset() == offset and tg.is_contiguous()
    tc, ts = sum_count_fused(tg, tv, 700, n, K, pred=tp, value_bits=16,
                             pred_op="lt", values_unsigned=True)
    _same(jc, tc)
    _same(js, ts)
    keep = (pred[offset:] < 700) & (gid[offset:] >= 0) & (gid[offset:] < K)
    assert int(_u64(tc).sum()) == int(keep.sum())


@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 9, 16, 17])
def test_multi_sum_on_sliced_streams(offset, n):
    """Three summed streams of three widths and the byte mask, each
    sliced ``offset`` rows into its allocation."""
    rng = np.random.default_rng(1000 * offset + n)
    K = 4
    gid = rng.integers(0, K, n + offset).astype(np.int32)
    mask = rng.random(n + offset) < 0.8
    a = rng.integers(0, 1 << 16, n + offset).astype(np.uint16)
    b = rng.integers(0, 1 << 32, n + offset, dtype=np.uint32)
    c = rng.integers(0, 1 << 32, n + offset, dtype=np.uint32).view(np.int32)
    o = offset
    jc, jt = pallas_multi_sum(
        jnp.asarray(mask[o:]), jnp.asarray(gid[o:]),
        (jnp.asarray(a[o:]).astype(jnp.int32), jnp.asarray(b[o:]).astype(jnp.int32),
         jnp.asarray(c[o:])),
        (2, 4, 3), K,
    )
    tc, tt = multi_sum(_t(mask)[o:], _t(gid)[o:], [_t(a)[o:], _t(b)[o:], _t(c)[o:]],
                       (2, 4, 3), K, streams_unsigned=(True, True, False))
    _same(jc, tc)
    for x, y in zip(jt, tt):
        _same(x, y)


def test_sums_carry_past_32_bits():
    """The card's table adds 32-bit words and carries: 64-bit values on
    one hot key, whose low words wrap on almost every add, and the sum
    itself wraps mod 2^64."""
    rng = np.random.default_rng(15)
    n, K = 3000, 2
    gid = np.zeros(n, np.int32)
    vals = rng.integers(1 << 63, 1 << 64, n, dtype=np.uint64)
    vals[::7] = 0xFFFFFFFF  # low word all ones, high word zero
    vals[1::7] = 0xFFFFFFFF00000000
    mask = np.ones(n, bool)
    jc, js = pallas_sum_count(jnp.asarray(mask), jnp.asarray(gid),
                              jnp.asarray(vals), K, value_bits=64)
    tc, ts = sum_count(_t(mask), _t(gid), _t(vals), K, value_bits=64)
    _same(jc, tc)
    _same(js, ts)
    assert int(_u64(ts)[0]) == int(vals.sum(dtype=np.uint64))


# -- where the accumulation table lives ------------------------------------------

_OPTIN = 232448  # bytes a block may opt in to on an H100 (227 KB)


@pytest.mark.parametrize(
    "K, nsums, want",
    [
        (1, 0, True),
        (1025, 1, True),
        (4096, 0, True),
        (29056, 0, True),        # 29056 x 8 = 232448 exactly
        (29057, 0, False),
        (14528, 1, True),
        (14529, 1, False),
        (9685, 2, True),
        (9686, 2, False),
        (3228, 8, True),         # 9 planes
        (3229, 8, False),
        (100_000, 1, False),
        (131_072, 0, False),
        (131_073, 8, False),
    ],
)
def test_table_in_shared_memory_edges(K, nsums, want):
    assert ga.table_in_shared_memory(K, nsums, _OPTIN) is want


@pytest.mark.parametrize("optin", [48 * 1024, 101_376, 166_912, _OPTIN])
@pytest.mark.parametrize("nsums", [0, 1, 2, 8])
def test_table_in_shared_memory_is_the_exact_byte_count(optin, nsums):
    """For any device: the largest K that fits is optin / (8 x planes),
    the next does not, and the answer is monotone in K and in S."""
    whole = optin // (8 * (1 + nsums))
    assert ga.table_in_shared_memory(whole, nsums, optin)
    assert not ga.table_in_shared_memory(whole + 1, nsums, optin)
    assert ga.table_in_shared_memory(1, nsums, optin)
    assert not ga.table_in_shared_memory(whole, nsums + 1, optin)
