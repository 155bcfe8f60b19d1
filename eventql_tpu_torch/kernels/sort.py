"""Device sort / top-k (ORDER BY [LIMIT]).

The counterpart of eventql_tpu/kernels/sort.py. ORDER BY is a stable
multi-key sort over order-preserving unsigned keys, ORDER BY + LIMIT k
over a single key is a top-k whose ties break toward the lowest row
index, and large inputs take the histogram-threshold algorithm below.

Keys are unsigned integers carried in the signed type of their width
(kernels/groupby.py): int64 tensors hold u64 keys, int32 tensors hold
u32 keys (a route downcasts a key whose static bounds prove it fits),
and a bool / uint8 tensor is a key as it stands (the filter mask that
leads a full sort). Their unsigned order is the signed order of the key
with its top bit flipped, which is what every sort here compares.

torch has no multi-operand sort and ``torch.topk`` leaves the order of
equal keys open, so both are built from ``torch.sort(stable=True)``
(a radix sort on CUDA): a chain from the last key to the first, and a
descending stable sort whose equal keys stay in row order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from eventql_tpu_torch.kernels.groupby import sortable_u64
from eventql_tpu_torch.utils import trace

# device -> host copies the host waits on (each one a synchronisation
# on a CUDA device), and the bytes they copied, counted since import
READBACKS = 0
READBACK_BYTES = 0


def read_host(t: torch.Tensor) -> "np.ndarray":
    """``t`` copied to host numpy, under a ``readback`` span."""
    global READBACKS, READBACK_BYTES
    nbytes = t.numel() * t.element_size()
    READBACKS += 1
    READBACK_BYTES += nbytes
    with trace.span("readback") as sp:
        sp.set("bytes", nbytes)
        return t.cpu().numpy()


def _signed_order(key: torch.Tensor) -> torch.Tensor:
    """A tensor whose signed order is the key's unsigned order."""
    if key.dtype == torch.int64:
        return key ^ -(1 << 63)
    if key.dtype == torch.int32:
        return key ^ -(1 << 31)
    if key.dtype == torch.bool:
        return key.to(torch.uint8)
    if key.dtype == torch.uint8:
        return key
    raise TypeError(f"unsupported sort key dtype {key.dtype}")


def order_permutation(sort_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation (int64) ordering rows by the given
    pre-transformed unsigned key tensors, ascending, the first key most
    significant (callers apply sortable_u64 with their descending flags
    and may pass 32-bit keys where a static bound proves the key fits):
    one stable sort per key, from the last key to the first."""
    perm = None
    for key in reversed(tuple(sort_keys)):
        s = _signed_order(key)
        if perm is not None:
            s = s[perm]
        idx = torch.sort(s, stable=True)[1]
        perm = idx if perm is None else perm[idx]
    if perm is None:
        raise ValueError("order_permutation: no sort key")
    return perm


def make_sort_keys(columns, descendings, unsigneds=None) -> Tuple[torch.Tensor, ...]:
    if unsigneds is None:
        unsigneds = (False,) * len(columns)
    return tuple(
        sortable_u64(c, descending=d, unsigned=u)
        for c, d, u in zip(columns, descendings, unsigneds)
    )


def _exact_topk(sort_key: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k by a descending stable sort: equal keys keep their row
    order, so ties go to the lowest index (torch.topk promises no such
    thing)."""
    return torch.sort(_signed_order(sort_key), descending=True, stable=True)[1][:k]


def topk_permutation(sort_key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int64) of the k rows with the LARGEST pre-transformed
    keys, in descending key order. For ORDER BY x DESC LIMIT k pass
    sortable_u64(x); for ORDER BY x ASC LIMIT k pass
    sortable_u64(x, descending=True) (the flip makes the smallest x the
    largest key). Ties break toward the lowest row index.

    Large inputs with a small k take the histogram-threshold algorithm
    (fast_topk_u64 / fast_topk_u32), everything else one stable sort."""
    n = sort_key.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"top-k needs 0 < k <= n, got k = {k}, n = {n}")
    if n >= (1 << 22) and k <= 4096:
        if sort_key.dtype == torch.int32:
            return fast_topk_u32(sort_key, k)
        return fast_topk_u64(sort_key, k)
    return _exact_topk(sort_key, k)


# histogram-threshold top-k ------------------------------------------------
#
# 1. histogram the top PREFIX_BITS of every key with the count-only form
#    of the grouped-aggregate kernel (kernels/groupby_agg.py)
# 2. threshold: T = the largest prefix whose from-the-top cumulative
#    count reaches k: every true top-k row has prefix >= T. A second
#    histogram over the next PREFIX_BITS of the rows in bucket T makes
#    the threshold exact to 24 bits
# 3. extract the candidate indices with the stream-compaction kernel
#    (kernels/extract.py) and run the exact top-k on just the candidates
# 4. pathological skew (too many keys sharing the threshold prefix)
#    falls back to the full sort
#
# The thresholds are read back to the host (the second histogram takes
# the first threshold as the literal of its in-kernel compare, and the
# choice between 3 and 4 is the host's), so one call waits on the card
# twice before its result exists.

PREFIX_BITS = 12


def _threshold_level(counts: "np.ndarray", k: int):
    """T = largest bucket whose from-the-top cumulative count reaches k;
    returns (T, count of rows in buckets >= T). ``counts`` is on the
    host."""
    nb = counts.shape[0]
    csum_desc = np.cumsum(counts[::-1])[::-1]
    ge_k = csum_desc >= k
    T = (nb - 1) - int(np.argmax(ge_k[::-1]))
    return T, int(csum_desc[T])


def _fast_topk(sort_key: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """Histogram-threshold top-k over unsigned keys of the given bit
    width (64 for u64 keys in int64; 32 for statically-bounded keys the
    device routes downcast: the narrow stream halves the bytes of the
    prefix passes)."""
    from eventql_tpu_torch.kernels.extract import extract_ge
    from eventql_tpu_torch.kernels.groupby_agg import Pred, groupby_agg

    n = sort_key.shape[0]
    nbuckets = 1 << PREFIX_BITS

    # the top 24 bits of every key, as a non-negative int32 (the shift
    # of a signed tensor is arithmetic, hence the mask; it is applied
    # after the narrowing, which keeps the low 32 bits)
    f24 = (sort_key >> (width - 2 * PREFIX_BITS)).to(torch.int32) & (
        nbuckets * nbuckets - 1
    )

    # level 1: top 12 bits, the count-only kernel form (no value stream)
    p1 = f24 >> PREFIX_BITS
    counts1 = read_host(groupby_agg(p1, n, nbuckets)[0])
    T1, n_ge1 = _threshold_level(counts1, k)
    n_gt1 = n_ge1 - int(counts1[T1])  # rows strictly above bucket T1 (< k)

    # level 2: next 12 bits, restricted in the kernel to bucket T1's rows
    p2 = f24 & (nbuckets - 1)
    counts2 = read_host(
        groupby_agg(p2, n, nbuckets, preds=[Pred("stream", "eq", T1, p1)])[0]
    )
    k2 = k - n_gt1  # still needed from bucket T1 (>= 1)
    T2, n_ge2 = _threshold_level(counts2, k2)

    # exact 24-bit threshold; candidates = rows with f24 >= t24
    t24 = T1 * nbuckets + T2
    n_candidates = n_gt1 + n_ge2

    # static cap: k + 4x the expected 24-bit threshold-bucket mass
    cap = int(min(n, k + max(4 * n // (nbuckets * nbuckets), 2 * k, 256)))
    if n_candidates > cap:
        return _exact_topk(sort_key, k)

    # ascending row indices, so the stable sort below keeps ties in row
    # order; the -1 padding lies past n_candidates
    cand = extract_ge(f24, t24, cap, n)[:n_candidates].to(torch.int64)
    return cand[_exact_topk(sort_key[cand], k)]


def fast_topk_u64(sort_key: torch.Tensor, k: int) -> torch.Tensor:
    return _fast_topk(sort_key, k, 64)


def fast_topk_u32(sort_key: torch.Tensor, k: int) -> torch.Tensor:
    return _fast_topk(sort_key, k, 32)
