"""Order-preserving 64-bit keys, and the grouped aggregation in plain
torch.

The counterpart of eventql_tpu/kernels/groupby.py: ``sortable_u64`` and
``f64_sort_bits`` (the ORDER BY routes' keys), and below them the
masked grouped aggregate and count_distinct that the general GROUP BY
route runs on the CPU and that kernels/hash_groupby.py is held to.

torch cannot compute with its unsigned types, so a uint64 key is the
int64 tensor of the same 64 bits: ``~k``, ``k - lo``, ``k == 0`` and
xor are the same on both, shifts need ``(k >> s) & mask``, and the
unsigned order of two keys is the signed order of ``k ^ (1 << 63)``
(kernels/sort.py sorts that way). An unsigned input column arrives the
same way, as the signed tensor of its width, and is named by the
``unsigned`` flag.
"""

from __future__ import annotations

import torch

_SIGN = -(1 << 63)  # int64 with only the top bit set


def f64_sort_bits(data: torch.Tensor) -> torch.Tensor:
    """float64 -> u64 keys (int64 bit patterns) whose unsigned ascending
    order equals the float order, and whose equality is bit equality:
    the IEEE-754 total-order trick on the value's own bits."""
    bits = data.contiguous().view(torch.int64)
    return torch.where(bits < 0, ~bits, bits ^ _SIGN)


def sortable_u64(
    data: torch.Tensor, descending: bool = False, unsigned: bool = False
) -> torch.Tensor:
    """Map a column to u64 keys (int64 bit patterns) whose unsigned
    order equals the SQL order of the values: 64-bit unsigned and bool
    are the identity, floats take the total-order trick, and every other
    integer goes through int64 with the sign bit flipped (a narrow
    unsigned payload zero-extends first), so narrow values keep their
    numeric order."""
    if data.dtype == torch.float64:
        k = f64_sort_bits(data)
    elif data.dtype in (torch.bool, torch.uint8):
        k = data.to(torch.int64)
    elif data.dtype == torch.int64:
        k = data if unsigned else data ^ _SIGN
    elif data.dtype in (torch.int32, torch.int16):
        k = data.to(torch.int64)
        if unsigned:
            k = k & ((1 << (8 * data.element_size())) - 1)
        k = k ^ _SIGN
    else:
        raise TypeError(f"no sortable key for dtype {data.dtype}")
    if descending:
        k = ~k
    return k


# -- the grouped aggregation (the general device GROUP BY) ----------------------
#
# The counterparts of masked_grouped_aggregate / masked_grouped_count_distinct
# / _op_identity in eventql_tpu/kernels/groupby.py, in plain torch: one
# torch.unique of the masked-in key tuples, then scatter_reduce_ /
# index_add_ over its inverse. The TPU formulation (one multi-payload
# key sort, segmented associative scans, a 1-bit partition sort to
# compact) worked around the TPU's missing scatter and is not carried
# over. kernels/hash_groupby.py computes the same on the card with a
# hash table; this is its plain version.
#
# Contract (the JAX docstrings'): masked-out rows belong to no group; a
# group is a distinct key tuple among the masked-in rows, with its
# smallest row index (``first_index``); count is exact; an integer sum
# is exact mod 2^64; min / max of a u64 stream take the unsigned order
# (C1's flip: scatter_reduce_ on int64 bit patterns alone would order
# 2^63 below 5); min / max / mean propagate NaN, as np.minimum.at does,
# and return the NaN 0x7FF8000000000000; min / max read -0.0 as +0.0
# (what the JAX device route returns for any table of two rows or
# more); count_distinct counts distinct 64-bit payloads per group. Keys
# compare by their bits (a float64 key by its own 64 bits: -0.0 and
# +0.0 are two groups, as in the JAX route). Groups come in ascending
# key order here and in no particular order from the kernel: callers
# order them by ``first_index``. Float sums follow no guaranteed order
# (index_add_ on the card is atomic), so two runs, or this version and
# the kernel, agree exactly only where every partial sum is exact.

_NAN_BITS = 0x7FF8000000000000
_I64_MAX = (1 << 63) - 1

AGG_KINDS = ("sum", "min", "max", "mean")


def _op_identity(dtype: torch.dtype, kind: str):
    """The identity of ``kind`` ("min" or "max") on ``dtype``: +inf /
    -inf for floats, the type's ends for integers."""
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def widen(t: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """A stream as int64: narrow integers sign-extend, or zero-extend
    when ``unsigned``; bool and uint8 give 0 / 1 / the byte; a float64
    stream gives its own 64 bits."""
    if t.dtype == torch.float64:
        return t.contiguous().view(torch.int64)
    wide = t.to(torch.int64)
    if unsigned and t.dtype in (torch.int16, torch.int32):
        wide = wide & ((1 << (8 * t.element_size())) - 1)
    return wide


def _group_rows(mask, key_arrays, n: int):
    """(masked-in rows, group of each, number of groups): the groups in
    ascending order of their key tuples' bits."""
    dev = key_arrays[0].device if key_arrays else (
        mask.device if mask is not None else torch.device("cpu"))
    if mask is None:
        rows = torch.arange(n, dtype=torch.int64, device=dev)
    else:
        rows = torch.nonzero(mask[:n]).flatten()
    if rows.numel() == 0:
        return rows, rows, 0
    if not key_arrays:
        return rows, torch.zeros_like(rows), 1
    keys = [widen(k[:n])[rows] for k in key_arrays]
    if len(keys) == 1:
        uniq, inverse = torch.unique(keys[0], return_inverse=True)
    else:
        uniq, inverse = torch.unique(torch.stack(keys, 1), dim=0, return_inverse=True)
    return rows, inverse, uniq.shape[0]


def _float_extreme(x, inverse, G, kind):
    """min / max of float64 values per group through their order-keeping
    bits: -0.0 reads as +0.0, and a NaN takes the extreme key, which no
    number has, so that it wins and comes out as NaN."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    key = f64_sort_bits(x)
    nan_key = 0 if kind == "min" else -1  # u64 0 / all ones
    key = torch.where(torch.isnan(x), torch.full_like(key, nan_key), key)
    best = torch.full((G,), _op_identity(torch.int64, kind), dtype=torch.int64,
                      device=x.device)
    best.scatter_reduce_(0, inverse, key ^ _SIGN, "amin" if kind == "min" else "amax")
    best = best ^ _SIGN
    bits = torch.where(best < 0, best ^ _SIGN, ~best)
    bits = torch.where(best == nan_key, torch.full_like(bits, _NAN_BITS), bits)
    return bits.view(torch.float64)


def masked_grouped_aggregate(mask, key_arrays, value_arrays, agg_kinds,
                             values_unsigned=None, n=None):
    """Group the first ``n`` rows that ``mask`` keeps (all when None) by
    the tuple of ``key_arrays`` and reduce each of ``value_arrays`` by
    its kind in ``agg_kinds`` ("sum", "min", "max", "mean"; "mean"
    needs a float64 stream). Integer streams are read as int64 (a narrow
    one sign-extends, or zero-extends where ``values_unsigned`` says so,
    which also makes min / max unsigned). Returns (first_index int64[G],
    counts int64[G], aggregates: one int64 (integer streams, u64 as bit
    patterns) or float64 tensor [G] each)."""
    n = _rows(mask, key_arrays, value_arrays, n)
    if values_unsigned is None:
        values_unsigned = (False,) * len(value_arrays)
    rows, inverse, G = _group_rows(mask, key_arrays, n)
    dev = rows.device
    first = torch.full((G,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inverse, rows, "amin")
    counts = torch.zeros(G, dtype=torch.int64, device=dev)
    counts.index_add_(0, inverse, torch.ones_like(rows))
    outs = []
    for v, kind, uns in zip(value_arrays, agg_kinds, values_unsigned):
        if kind not in AGG_KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        if v.dtype == torch.float64:
            x = v[:n][rows]
            if kind in ("min", "max"):
                outs.append(_float_extreme(x, inverse, G, kind))
                continue
            s = torch.zeros(G, dtype=torch.float64, device=dev)
            s.index_add_(0, inverse, x)
            outs.append(s / counts if kind == "mean" else s)
            continue
        if kind == "mean":
            raise TypeError("mean needs a float64 stream")
        x = widen(v[:n], uns)[rows]
        if kind == "sum":
            s = torch.zeros(G, dtype=torch.int64, device=dev)
            outs.append(s.index_add_(0, inverse, x))
            continue
        flip = _SIGN if uns else 0  # unsigned order = signed order of x ^ 2^63
        best = torch.full((G,), _op_identity(torch.int64, kind), dtype=torch.int64,
                          device=dev)
        best.scatter_reduce_(0, inverse, x ^ flip, "amin" if kind == "min" else "amax")
        outs.append(best ^ flip)
    return first, counts, tuple(outs)


def masked_grouped_count_distinct(mask, key_arrays, values, n=None):
    """Per group of ``masked_grouped_aggregate`` (same groups, same
    order): the number of distinct 64-bit payloads of ``values`` among
    its rows. Returns int64[G]."""
    n = _rows(mask, key_arrays, (values,), n)
    rows, inverse, G = _group_rows(mask, key_arrays, n)
    out = torch.zeros(G, dtype=torch.int64, device=rows.device)
    if G:
        pairs = torch.unique(torch.stack([inverse, widen(values[:n])[rows]], 1), dim=0)
        out.index_add_(0, pairs[:, 0], torch.ones_like(pairs[:, 0]))
    return out


def _rows(mask, key_arrays, value_arrays, n):
    if n is not None:
        return int(n)
    for t in (*key_arrays, *value_arrays, mask):
        if t is not None:
            return t.shape[0]
    raise ValueError("no stream to take the row count from: pass n")
