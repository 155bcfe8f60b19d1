"""kernels/groupby.py (sort keys) and kernels/sort.py of the port
against the JAX package's functions.

Inputs are made with numpy from a seed and handed to both packages. The
port carries unsigned keys in the signed type of their width, so its
results are compared as bit patterns (``.view(np.uint64)``). Where the
JAX function reaches a Pallas kernel (the histogram and extraction
kernels inside ``fast_topk_*``) it runs in interpret mode; the port's
kernels run as their plain versions (CPU tensors). Tolerance: exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventql_tpu.kernels import groupby as jgroupby
from eventql_tpu.kernels import sort as jsort
from eventql_tpu_torch.kernels import extract as ex
from eventql_tpu_torch.kernels import groupby as tgroupby
from eventql_tpu_torch.kernels import groupby_agg as ga
from eventql_tpu_torch.kernels import sort as tsort

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def _tensor(arr):
    """numpy -> torch; an unsigned array travels as the signed type of
    its width, as the port's columns do."""
    arr = np.ascontiguousarray(arr)
    view = _SIGNED.get(arr.dtype)
    return torch.from_numpy(arr.view(view) if view else arr)


def _bits(t, dtype=np.uint64):
    return t.numpy().view(dtype)


def _column(dtype, rng, n=4000):
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        x = rng.standard_normal(n) * 1e3
        x[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324]
        return x
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    x[:4] = [info.min, info.max, 0, 1]
    return x


DTYPES = ["uint64", "int64", "float64", "bool", "int32", "uint32", "int16", "uint16"]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sortable_u64_matches_jax(dtype, descending):
    x = _column(dtype, np.random.default_rng(5))
    want = np.asarray(jgroupby.sortable_u64(jnp.asarray(x), descending))
    got = tgroupby.sortable_u64(
        _tensor(x), descending, unsigned=np.dtype(dtype).kind == "u"
    )
    assert got.dtype == torch.int64
    assert (_bits(got) == want).all()
    if dtype != "float64":  # the key order is the value order (NaN has none)
        order = np.argsort(_bits(got), kind="stable")
        vals = x[order].astype(np.float64)
        assert (np.diff(vals) <= 0).all() if descending else (np.diff(vals) >= 0).all()


def test_f64_sort_bits_orders_the_special_values():
    x = np.array([np.nan, -np.inf, -1.5, -5e-324, -0.0, 0.0, 5e-324, 2.0, np.inf])
    want = np.asarray(jgroupby.f64_sort_bits(jnp.asarray(x)))
    got = _bits(tgroupby.f64_sort_bits(torch.from_numpy(x)))
    assert (got == want).all()
    # total order: -inf < ... < -0.0 < +0.0 < ... < +inf < NaN
    assert (np.diff(got[1:].astype(object)) > 0).all()
    assert got[0] > got[-1]


def test_sortable_u64_refuses_unknown_dtypes():
    with pytest.raises(TypeError):
        tgroupby.sortable_u64(torch.zeros(3, dtype=torch.float32))


# -- order_permutation --------------------------------------------------------

ORDER_CASES = {
    "one u64 key": (["uint64"], [False]),
    "one i64 key desc": (["int64"], [True]),
    "float desc": (["float64"], [True]),
    "u64 ties then float desc": (["ties", "float64"], [False, True]),
    "bool, i16 desc, u32": (["bool", "int16", "uint32"], [False, True, False]),
    "ties, ties desc, i64": (["ties", "ties", "int64"], [False, True, False]),
}


def _order_columns(kinds, rng, n):
    cols = []
    for kind in kinds:
        if kind == "ties":
            cols.append(rng.integers(0, 5, n).astype(np.uint64))
        elif kind == "float64":
            cols.append(rng.integers(-64, 64, n) / 8.0)
        else:
            cols.append(_column(kind, rng, n))
    return cols


@pytest.mark.parametrize("label", ORDER_CASES)
def test_order_permutation_matches_jax_and_lexsort(label):
    kinds, desc = ORDER_CASES[label]
    cols = _order_columns(kinds, np.random.default_rng(17), 3000)
    jkeys = jsort.make_sort_keys([jnp.asarray(c) for c in cols], desc)
    want = np.asarray(jsort.order_permutation(jkeys)).astype(np.int64)
    tkeys = tsort.make_sort_keys(
        [_tensor(c) for c in cols], desc, [c.dtype.kind == "u" for c in cols]
    )
    got = tsort.order_permutation(tkeys)
    assert got.dtype == torch.int64
    assert (got.numpy() == want).all()
    # and the plain definition: a stable lexsort over the same keys
    lex = np.lexsort([np.asarray(k) for k in reversed(jkeys)])
    assert (got.numpy() == lex).all()


def test_order_permutation_mixed_key_widths():
    """A bool mask key, a u32 key held in int32 (top bit set in half the
    rows) and a u64 key held in int64, as the ORDER BY routes pass them."""
    rng = np.random.default_rng(23)
    n = 5000
    mask = rng.random(n) < 0.3
    k32 = rng.integers(0, 1 << 32, n, dtype=np.uint32) & np.uint32(0xC0000000)
    k64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    want = np.asarray(
        jsort.order_permutation(
            (jnp.asarray(mask).astype(jnp.uint32), jnp.asarray(k32), jnp.asarray(k64))
        )
    )
    got = tsort.order_permutation((_tensor(mask), _tensor(k32), _tensor(k64)))
    assert (got.numpy() == want).all()
    assert (got.numpy() == np.lexsort((k64, k32, mask))).all()


# -- top-k --------------------------------------------------------------------


def test_topk_ties_break_toward_the_lowest_index():
    """torch.topk leaves the order of equal keys open; the contract of
    the JAX package (lax.top_k) is the lowest index first."""
    key = torch.tensor([5, 5, 5, 1], dtype=torch.int64)
    assert tsort.topk_permutation(key, 2).tolist() == [0, 1]
    assert tsort.topk_permutation(key.to(torch.int32), 3).tolist() == [0, 1, 2]
    want = np.asarray(jsort.topk_permutation(jnp.asarray([5, 5, 5, 1], jnp.uint64), 2))
    assert want.tolist() == [0, 1]


def _topk_keys(kind, width, n, rng):
    dtype = np.uint64 if width == 64 else np.uint32
    if kind == "uniform":
        return rng.integers(0, 1 << width, n, dtype=dtype, endpoint=False)
    if kind == "heavy ties":
        return (rng.integers(0, 3, n).astype(dtype)) << dtype(width - 2)
    if kind == "shared top prefix":  # every key in one 24-bit bucket: overflow
        low = rng.integers(0, 1 << (width - 24), n, dtype=dtype)
        return (dtype(0x5A5F0F) << dtype(width - 24)) | low
    if kind == "zeros and a few":  # filtered rows carry key 0
        k = np.zeros(n, dtype)
        hot = rng.choice(n, 40, replace=False)
        k[hot] = rng.integers(1, 1 << width, 40, dtype=dtype)
        return k
    raise AssertionError(kind)


KINDS = ["uniform", "heavy ties", "shared top prefix", "zeros and a few"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width, log2n, k", [(64, 16, 57), (64, 18, 1), (32, 17, 300),
                                             (32, 16, 57)])
def test_fast_topk_matches_jax(width, log2n, k, kind, monkeypatch):
    extractions = []
    real_extract = ex.extract_ge
    monkeypatch.setattr(
        ex, "extract_ge",
        lambda *a, **kw: extractions.append(a[2]) or real_extract(*a, **kw),
    )
    n = 1 << log2n
    keys = _topk_keys(kind, width, n, np.random.default_rng(31 + log2n))
    jfn, tfn = ((jsort.fast_topk_u64, tsort.fast_topk_u64) if width == 64
                else (jsort.fast_topk_u32, tsort.fast_topk_u32))
    want = np.asarray(jfn(jnp.asarray(keys), k))
    before = (dict(ga.LAUNCHES), dict(ex.LAUNCHES))
    got = tfn(_tensor(keys), k)
    assert got.dtype == torch.int64 and got.shape == (k,)
    assert (got.numpy() == want).all()
    # and the definition: the k largest, ties to the lowest row
    assert (got.numpy() == np.argsort(~keys, kind="stable")[:k]).all()
    assert (dict(ga.LAUNCHES), dict(ex.LAUNCHES)) == before  # CPU: plain versions
    # the candidate branch for spread keys, the overflow branch (one full
    # sort, no extraction) when one 24-bit bucket holds too many rows
    # (so does a k that reaches into the mass of zero keys)
    overflow = kind in ("heavy ties", "shared top prefix") or (
        kind == "zeros and a few" and k > 40
    )
    assert len(extractions) == (0 if overflow else 1)


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("n, k", [(1, 1), (1000, 1000), (5000, 17), (70_000, 5000)])
def test_topk_permutation_matches_jax(n, k, dtype):
    """Below 2^22 rows (or above k = 4096) both packages take the exact
    branch; ties go to the lowest row in both."""
    rng = np.random.default_rng(n + k)
    keys = rng.integers(0, 50, n).astype(dtype) << dtype(20)
    want = np.asarray(jsort.topk_permutation(jnp.asarray(keys), k))
    got = tsort.topk_permutation(_tensor(keys), k)
    assert (got.numpy() == want).all()


def test_topk_permutation_takes_the_histograms_from_2_22_rows(monkeypatch):
    """The routing decision of the JAX package: n >= 2^22 and k <= 4096
    go to fast_topk_u32 / fast_topk_u64 by key width."""
    seen = []
    monkeypatch.setattr(tsort, "fast_topk_u32", lambda key, k: seen.append((32, k)))
    monkeypatch.setattr(tsort, "fast_topk_u64", lambda key, k: seen.append((64, k)))
    n = 1 << 22
    tsort.topk_permutation(torch.zeros(n, dtype=torch.int32), 9)
    tsort.topk_permutation(torch.zeros(n, dtype=torch.int64), 4096)
    assert seen == [(32, 9), (64, 4096)]
    assert tsort.topk_permutation(torch.zeros(n, dtype=torch.int64), 4097).shape == (4097,)
    assert tsort.topk_permutation(torch.zeros(n - 1, dtype=torch.int64), 9).shape == (9,)
    assert seen == [(32, 9), (64, 4096)]
    with pytest.raises(ValueError):
        tsort.topk_permutation(torch.zeros(4, dtype=torch.int64), 5)


@pytest.mark.parametrize("k", [1, 5, 100, 4096])
def test_threshold_level_matches_jax(k):
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 4, 4096).astype(np.uint64)
    counts[rng.integers(0, 4096, 8)] = 500
    T, n_ge = jsort._threshold_level(jnp.asarray(counts), jnp.uint64(k))
    assert tsort._threshold_level(counts.astype(np.int64), k) == (int(T), int(n_ge))


def test_fast_topk_counts_its_readbacks():
    keys = np.random.default_rng(2).integers(0, 1 << 63, 1 << 16, dtype=np.uint64)
    before = tsort.READBACKS
    tsort.fast_topk_u64(_tensor(keys), 10)
    assert tsort.READBACKS - before == 2  # one per histogram level
