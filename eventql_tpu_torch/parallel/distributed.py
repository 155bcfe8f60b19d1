"""The mesh tier's exchange layer: shards, their devices, and the
collectives that move accumulator tables between them.

The counterpart of eventql_tpu/parallel/distributed.py. There a table
lies sharded on the row axis of a ``jax.sharding.Mesh`` and one XLA
program per query runs every shard under ``jax.shard_map``; its
collectives (all_gather, psum, ppermute over ICI) take the place of the
reference's QUERY_PARTIALAGGR fan-out and coordinator merge (reference:
sql/statements/select/groupby.cc:438-714). Here one Python process
drives every shard as well (a single controller, as ``shard_map`` is):

* a ``Mesh`` is the list of the shards' torch devices. A device may
  repeat: several shards on one card are the counterpart of the JAX
  package's virtual CPU mesh, and shard i of a mesh made for "cuda" lies
  on ``cuda:(i mod visible cards)``;
* the collectives act on the list of per-shard tensors and move them
  with ``.to(device, non_blocking=True)`` (peer to peer between cards).
  The one controller needs a gathered or summed table once, so
  ``_xch_all_gather`` and ``_xch_psum`` bring it to the merge shard
  (shard 0) instead of to every shard;
* each collective records the bytes that cross from one shard to
  another, whether or not the two share a device, by ``op`` name, in
  every ``exchange_tally`` open on the mesh.

Multi-process ``torch.distributed`` (the port of parallel/multihost.py)
is a later slice; NCCL refuses two ranks on one card, so on a one-card
machine it could not exchange anything.

The kernel-tier functions below run the port's hand-written kernels on
every shard and exchange only O(num_buckets) accumulator words, O(groups)
partials or O(k) candidates: ``distributed_sum_count`` (the JAX
``distributed_pallas_sum_count``), ``distributed_join_aggregate`` and
``distributed_multi_join_aggregate`` (B1 / B2, B4 / B5),
``distributed_topk`` (B1 and B3 through the histogram top-k),
``distributed_grouped_aggregate``, ``distributed_count_distinct`` and
``distributed_grouped_aggregate_sharded`` (H1 on each shard, the merge
of the mesh GROUP BY). The sorts move whole runs: ``distributed_sort``
(the compare-split network), ``distributed_order_permutation`` and
``distributed_bucket_sort`` (the sample sort). Their keys are u64 as
int64 bit patterns, compared in unsigned order (ROADMAP C1).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.exec.device_exec import _to_tensor
from eventql_tpu_torch.exec.torch_expr import _fold_i64


class Mesh:
    """The shards' devices, shard i on ``devices[i]``; shard 0 is where
    gathered tables merge."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self._tallies: List["exchange_tally"] = []

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_shards: int, device: str = "cuda") -> Mesh:
    """``n_shards`` shards on the visible cards, round robin ("cuda"; raises
    where there is none), or all on the CPU ("cpu", for the tests)."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards = {n_shards}: need at least 1")
    if device == "cpu":
        return Mesh([torch.device("cpu")] * n_shards)
    if device != "cuda":
        raise ValueError(f"make_mesh: device {device!r} is neither 'cuda' nor 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError_(
            "make_mesh(device='cuda'): no CUDA device is available;"
            " pass device='cpu' to run the shards through the plain PyTorch versions"
        )
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % count) for i in range(n_shards)])


class exchange_tally:
    """Context manager: the exchange records of every collective on
    ``mesh`` while it is open, dicts ``{"op", "bytes"}``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.records: List[dict] = []

    def __enter__(self):
        self.mesh._tallies.append(self)
        return self

    def __exit__(self, *exc):
        self.mesh._tallies.remove(self)
        return False

    def bytes(self, op: Optional[str] = None) -> int:
        return sum(r["bytes"] for r in self.records if op is None or r["op"] == op)

    def by_op(self) -> dict:
        out: dict = {}
        for r in self.records:
            out[r["op"]] = out.get(r["op"], 0) + r["bytes"]
        return out


def _record(mesh: Mesh, op: str, nbytes: int) -> None:
    for t in mesh._tallies:
        t.records.append({"op": op, "bytes": int(nbytes)})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _xch_all_gather(mesh: Mesh, parts: Sequence[torch.Tensor],
                    op: str = "all_gather") -> torch.Tensor:
    """The shards' tensors, concatenated in shard order on the merge
    shard's device. Records the bytes of every part but shard 0's."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    _record(mesh, op, sum(_nbytes(p) for p in parts[1:]))
    return torch.cat([p.to(mesh.root, non_blocking=True) for p in parts])


def _xch_psum(mesh: Mesh, parts: Sequence[torch.Tensor], op: str = "psum") -> torch.Tensor:
    """The elementwise sum of the shards' equally shaped tensors (integers
    wrap mod 2^64) on the merge shard's device. Records the bytes of
    every part but shard 0's."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    _record(mesh, op, sum(_nbytes(p) for p in parts[1:]))
    out = parts[0].to(mesh.root, copy=True)
    for p in parts[1:]:
        out += p.to(mesh.root, non_blocking=True)
    return out


def _xch_ppermute(mesh: Mesh, parts: Sequence[torch.Tensor], perm,
                  op: str = "ppermute") -> List[torch.Tensor]:
    """``out[d] = parts[s]`` moved to shard d's device for each pair
    ``(s, d)`` of ``perm`` (a permutation of the shards). Records the
    bytes of every pair with s != d."""
    if sorted(d for _s, d in perm) != list(range(mesh.size)):
        raise ValueError(f"{perm} is not a permutation of {mesh.size} shards")
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    moved = 0
    for s, d in perm:
        out[d] = parts[s].to(mesh.devices[d], non_blocking=True)
        moved += _nbytes(parts[s]) if s != d else 0
    _record(mesh, op, moved)
    return out


# -- compact partials and their merge ------------------------------------------
#
# One shard's H1 partial keeps only the groups it has; the merge gathers
# them, O(groups) words a shard, and groups them once more with H1. The
# mesh routes (exec/mesh_exec.py) and the kernel-tier aggregates below
# share both.

_MERGE_KIND = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


class _Partial(NamedTuple):
    """One shard's groups (only those it has): each group's key bits (the
    key streams at its first row, in their own dtypes), count, one
    aggregate per value stream, first global row; and per count_distinct
    stream the distinct (keys..., value) pairs as (key bits list, first
    global row)."""

    keys: list
    counts: torch.Tensor
    aggs: list
    first: torch.Tensor
    pairs: list


def _compact(res, keys, g0: int):
    """The occupied groups of a ``hash_groupby`` result (a direct tier
    returns every slot): key bits, counts, aggregates, global first rows."""
    occ = torch.nonzero(res.counts > 0).flatten()
    first = res.first_index[occ]
    return ([k[first] for k in keys], res.counts[occ], [a[occ] for a in res.aggregates],
            first + g0)


def _local_partial(keys, spans, n, mask, values, kinds, unsigned, distinct, dspans, g0):
    """One shard's H1 partial. A mean is summed here and divided after the
    merge."""
    from eventql_tpu_torch.kernels.hash_groupby import hash_groupby

    local_kinds = ["sum" if k == "mean" else k for k in kinds]
    res = hash_groupby(keys, n, mask, values, local_kinds, unsigned, (), spans)
    kc, counts, aggs, first = _compact(res, keys, g0)
    del res
    pairs = []
    for d, dspan in zip(distinct, dspans):
        pres = hash_groupby([*keys, d], n, mask, key_spans=[*spans, dspan])
        pk, _counts, _aggs, pfirst = _compact(pres, [*keys, d], g0)
        pairs.append((pk, pfirst))
        del pres
    return _Partial(kc, counts, aggs, first, pairs)


class _Merged(NamedTuple):
    """The merged groups on the merge shard, in the order of their first
    global rows."""

    keys: list
    counts: torch.Tensor
    aggs: list
    first: torch.Tensor
    distinct: list


def _merge(mesh, parts, spans, kinds, unsigned, dspans, op) -> Optional[_Merged]:
    """Gather the shards' compact partials and merge them with H1 on the
    merge shard: counts and sums add, min / max by ``kinds`` (the local
    kinds; a mean's sum adds), first rows by min. count_distinct: the
    gathered pairs are deduplicated, then counted per key. None when no
    shard has a group."""
    from eventql_tpu_torch.kernels.hash_groupby import hash_groupby

    def gather(rows):
        return _xch_all_gather(mesh, rows, op)

    nk = len(spans)
    keys = [gather([p.keys[j] for p in parts]) for j in range(nk)]
    counts = gather([p.counts for p in parts])
    aggs = [gather([p.aggs[j] for p in parts]) for j in range(len(kinds))]
    first = gather([p.first for p in parts])
    G = counts.shape[0]
    if G == 0:
        return None
    merge_kinds = ["sum", *(_MERGE_KIND.get(k, "sum") for k in kinds), "min"]
    res = hash_groupby(keys, G, None, [counts, *aggs, first], merge_kinds,
                       [False, *unsigned, False], (), spans)
    occ = torch.nonzero(res.counts > 0).flatten()
    m_first = res.aggregates[-1][occ]
    order = occ[torch.argsort(m_first)]
    rows = res.first_index[order]
    merged = _Merged([k[rows] for k in keys], res.aggregates[0][order],
                     [a[order] for a in res.aggregates[1:-1]], res.aggregates[-1][order], [])
    del res
    for j, dspan in enumerate(dspans):
        pkeys = [gather([p.pairs[j][0][i] for p in parts]) for i in range(nk + 1)]
        pfirst = gather([p.pairs[j][1] for p in parts])
        # the same pair on several shards: once, with its first row
        dedup = hash_groupby(pkeys, pfirst.shape[0], None, [pfirst], ["min"], None, (),
                             [*spans, dspan])
        occ = torch.nonzero(dedup.counts > 0).flatten()
        at = dedup.first_index[occ]
        per_key = hash_groupby([k[at] for k in pkeys[:nk]], occ.shape[0], None,
                               [dedup.aggregates[0][occ]], ["min"], None, (), spans)
        occ = torch.nonzero(per_key.counts > 0).flatten()
        # a key's first pair row is the key's first row: the order above
        occ = occ[torch.argsort(per_key.aggregates[0][occ])]
        if occ.shape[0] != merged.counts.shape[0]:
            raise AssertionError("count_distinct groups differ from the merged groups")
        merged.distinct.append(per_key.counts[occ])
    return merged


def padded_rows(n: int, n_shards: int) -> int:
    """Rows padded to a multiple of ``n_shards`` (at least one row a
    shard): every shard gets the same number of rows."""
    return max(n_shards, -(-int(n) // n_shards) * n_shards)


def shard_table(mesh: Mesh, arrays) -> List[List[torch.Tensor]]:
    """Host arrays (or CPU tensors) as equal row blocks, block i on shard
    i's device; each array is padded with zeros to ``padded_rows``. A
    padding row of a fact table must be masked out by the caller (a
    ``False`` mask padding does it); unsigned arrays travel as the
    signed type of their width."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else _to_tensor(np.asarray(a), "cpu")
        n = t.shape[0]
        n_p = padded_rows(n, mesh.size)
        if n_p > n:
            t = torch.cat([t, torch.zeros(n_p - n, dtype=t.dtype, device=t.device)])
        local = n_p // mesh.size
        out.append([t[i * local:(i + 1) * local].to(dev)
                    for i, dev in enumerate(mesh.devices)])
    return out


def _replicas(mesh: Mesh, t: torch.Tensor) -> dict:
    """``t`` on every distinct device of the mesh (a replicated input,
    as a ``P()`` input of shard_map: placed, not exchanged)."""
    return {dev: t.to(dev) for dev in dict.fromkeys(mesh.devices)}


def _probe(fact_keys, dim_keys, dim_bucket, n, probe):
    """Per fact row its dimension row's bucket or -1: ``probe`` "compare"
    is the small-table probe (B4, ``dim_join_gid``), "search" the hash
    probe for any size (B5, ``probe_join_gid``), None either by the
    dimension count (``join_gid``). The JAX ``_probe_gid``."""
    from eventql_tpu_torch.kernels import join

    if probe is None:
        return join.join_gid(fact_keys, dim_keys, dim_bucket, n)
    if probe == "compare":
        return join.dim_join_gid(fact_keys, dim_keys, dim_bucket, n)
    if probe == "search":
        return join.probe_join_gid(fact_keys, dim_keys, dim_bucket, n)
    raise ValueError(f"probe {probe!r}: need None, 'compare' or 'search'")


def _sum_count(gid, n, mask, values, num_buckets):
    from eventql_tpu_torch.kernels.groupby_agg import groupby_agg

    # a bucket outside [0, K) (-1: no dimension row) is dropped by B1 itself
    return groupby_agg(gid, n, num_buckets, values=values, mask=mask,
                       values_unsigned=True)


def _psum_tables(mesh, tables, op):
    counts = _xch_psum(mesh, [t[0] for t in tables], op)
    sums = _xch_psum(mesh, [t[1] for t in tables], op)
    return counts, sums


def distributed_sum_count(mesh: Mesh, mask, gid, values, num_buckets: int):
    """Scan + filter + GROUP BY count / sum over a sharded table: B1 on
    each shard (``groupby_agg``: a bucket outside [0, num_buckets) is
    dropped), then one psum of the count and sum tables, O(num_buckets)
    words a shard whatever the rows or their skew.

    mask, gid, values: lists of per-shard tensors (bool, int32 buckets,
    u64 values as int64 or narrower unsigned streams). Returns (counts,
    sums), int64[num_buckets] on the merge shard's device; sums are
    exact mod 2^64."""
    tables = [_sum_count(g, g.shape[0], m, v, num_buckets)
              for m, g, v in zip(mask, gid, values)]
    return _psum_tables(mesh, tables, "groupby_psum")


# the JAX package's name, so that a reader finds the counterpart
distributed_pallas_sum_count = distributed_sum_count


def distributed_join_aggregate(mesh: Mesh, fact_keys, fact_values, fact_mask,
                               dim_keys, dim_bucket, num_buckets: int,
                               probe: Optional[str] = None):
    """Fact-dim join + GROUP BY count / sum over the mesh (a broadcast
    join): the facts stay sharded, the dimension side is placed on every
    shard's device, each shard probes (B4 up to MAX_COMPARE_DIMS
    dimension rows, B5 above, or as ``probe`` says) and aggregates its
    rows with B1, and the tables merge with one psum.

    fact_*: lists of per-shard tensors (u64 keys as int64 or a narrower
    unsigned stream, u64 values, bool mask); dim_keys int64 [D] and
    dim_bucket int32 [D] in [0, num_buckets). Returns (counts, sums) as
    ``distributed_sum_count``."""
    dk, db = _replicas(mesh, dim_keys), _replicas(mesh, dim_bucket)
    tables = []
    for fk, fv, fm in zip(fact_keys, fact_values, fact_mask):
        dev = fk.device
        gid = _probe(fk, dk[dev], db[dev], fk.shape[0], probe)
        tables.append(_sum_count(gid, fk.shape[0], fm, fv, num_buckets))
        del gid  # this shard's scratch goes before the next shard's
    return _psum_tables(mesh, tables, "join_psum")


def distributed_multi_join_aggregate(mesh: Mesh, fact_k1, fact_k2, fact_values,
                                     fact_mask, dim1_keys, dim1_bucket, dim2_keys,
                                     dim2_flag, num_buckets: int,
                                     probe: Optional[str] = None):
    """SELECT d1.bucket, sum(f.v), count(1)
         FROM facts f JOIN dim1 d1 ON f.k1 = d1.k JOIN dim2 d2 ON f.k2 = d2.k
        WHERE f.mask AND d2.flag = 1 GROUP BY d1.bucket

    Facts and dim1 are sharded (dim1 too large to replicate), dim2 is
    placed on every shard. Each shard probes its facts against the dim1
    shard it holds, then the dim1 shards move one step around the ring
    (``_xch_ppermute``), P probes in all. Dimension keys are unique and
    each probe compares the full 64-bit key, so at most one ring step
    finds a fact row's key: the partial buckets combine with
    ``max(-1, ...)``. Then B1 per shard and one psum.

    dim1_keys / dim1_bucket: lists of per-shard tensors whose rows split
    evenly over the shards (a zero key in ``shard_table``'s padding
    would be a dimension row); dim2_flag int32 [D2]. Returns (counts,
    sums) as ``distributed_sum_count``."""
    P = mesh.size
    d2k, d2f = _replicas(mesh, dim2_keys), _replicas(mesh, dim2_flag)
    ring = [(i, (i + 1) % P) for i in range(P)]
    # join 2 (on every shard): WHERE d2.flag = 1
    masks = []
    for fk2, fm in zip(fact_k2, fact_mask):
        dev = fk2.device
        active = _probe(fk2, d2k[dev], d2f[dev], fk2.shape[0], probe) == 1
        masks.append(active if fm is None else fm & active)
    # join 1: the dim1 shards go around the ring
    gid = [torch.full((fk.shape[0],), -1, dtype=torch.int32, device=fk.device)
           for fk in fact_k1]
    dk, db = list(dim1_keys), list(dim1_bucket)
    for step in range(P):
        for s in range(P):
            g = _probe(fact_k1[s], dk[s], db[s], fact_k1[s].shape[0], probe)
            gid[s] = torch.maximum(gid[s], g)
            del g
        if step + 1 < P:
            dk = _xch_ppermute(mesh, dk, ring, op="join_ring")
            db = _xch_ppermute(mesh, db, ring, op="join_ring")
    tables = [_sum_count(g, g.shape[0], m, fv, num_buckets)
              for g, m, fv in zip(gid, masks, fact_values)]
    return _psum_tables(mesh, tables, "join_psum")


# -- order keys on the u64 convention -------------------------------------------
#
# A u64 key travels as the int64 of its bits (ROADMAP C1): its unsigned
# order is the signed order of ``key ^ 2^63`` (kernels/sort.py
# ``_signed_order``), which every compare, search and min / max below
# takes. The sentinel 0xFFFF_FFFF_FFFF_FFFF, the largest key, is -1.

_SIGN63 = 1 << 63
_M64 = (1 << 64) - 1
SENTINEL = -1

# the bounds of the u64 key ``sortable_u64`` makes of each narrow stream,
# by (dtype, unsigned): narrow integers go through int64 with the sign
# bit flipped, so they lie in [2^63 - 2^(b-1), 2^63 + 2^(b-1) - 1], or
# [2^63, 2^63 + 2^b - 1] zero-extended
_SORTKEY_DTYPE_BOUNDS = {
    (torch.bool, False): (0, 1),
    (torch.bool, True): (0, 1),
    (torch.int32, True): (_SIGN63, _SIGN63 + (1 << 32) - 1),
    (torch.int32, False): (_SIGN63 - (1 << 31), _SIGN63 + (1 << 31) - 1),
    (torch.int16, True): (_SIGN63, _SIGN63 + (1 << 16) - 1),
    (torch.int16, False): (_SIGN63 - (1 << 15), _SIGN63 + (1 << 15) - 1),
}


def _sortkey_bounds(dtype, unsigned: bool, descending: bool = False):
    """The static [lo, hi] of a stream's sortable key (after the
    descending flip), or None for a 64-bit stream."""
    b = _SORTKEY_DTYPE_BOUNDS.get((dtype, bool(unsigned)))
    if b is not None and descending:
        b = ((~b[1]) & _M64, (~b[0]) & _M64)
    return b


def _narrow_u32(key: torch.Tensor, lo: int) -> torch.Tensor:
    """``key - lo`` of a u64 key within [lo, lo + 2^32) as a u32 (int32
    tensor): a strictly monotonic bijection, so order and ties hold."""
    return (key - _fold_i64(lo)).to(torch.int32)


def _widen_u32(key: torch.Tensor, lo: int) -> torch.Tensor:
    """The inverse of ``_narrow_u32``: the u64 key as an int64."""
    return (key.to(torch.int64) & 0xFFFFFFFF) + _fold_i64(lo)


def _lex_lt(a_keys, b_keys):
    """Elementwise lexicographic ``a < b`` and ``a == b`` over two lists
    of key tensors (each pair of one dtype), each key in its unsigned
    order."""
    from eventql_tpu_torch.kernels.sort import _signed_order

    lt = eq = None
    for a, b in zip(a_keys, b_keys):
        sa, sb = _signed_order(a), _signed_order(b)
        if lt is None:
            lt, eq = sa < sb, sa == sb
        else:
            lt = lt | (eq & (sa < sb))
            eq = eq & (sa == sb)
    return lt, eq


def _sorted_run(cols, nk: int):
    """The columns of one shard in the stable order of their first ``nk``
    (key) columns."""
    from eventql_tpu_torch.kernels.sort import order_permutation

    perm = order_permutation(cols[:nk])
    return [c[perm] for c in cols]


def _shard_lengths(mesh: Mesh, columns, what: str) -> int:
    """The rows a shard of ``columns`` (lists of per-shard tensors) holds,
    the same on every shard."""
    lengths = {c.shape[0] for col in columns for c in col}
    if len(lengths) != 1 or any(len(col) != mesh.size for col in columns):
        raise ValueError(f"{what}: every column needs {mesh.size} shards of equal length")
    return lengths.pop()


# -- distributed sorts ------------------------------------------------------------


def distributed_sort(mesh: Mesh, sort_keys, payloads=(), key_bounds=None):
    """Global ORDER BY of a sharded table: the compare-split network over
    the shards (the JAX ``distributed_sort``).

    Each shard sorts its run once (``order_permutation``, stable). Then,
    for each of the log2(P) (log2(P) + 1) / 2 stages, shard i swaps runs
    with partner ``i ^ j`` (``_xch_ppermute``, tallied as
    ``sort_exchange``), reverses the partner's run, keeps the elementwise
    lexicographic min (or max) half of the pair, taking its own element
    on a tie, and puts the kept half back in order with a stable sort.
    The output is balanced: shard i holds global ranks
    ``[i * n_local, (i + 1) * n_local)``.

    sort_keys: per key a list of per-shard tensors, all shards of equal
      length; u64 keys as int64 bit patterns (``make_sort_keys``), or
      int32 (u32) / bool keys, compared unsigned, the first key most
      significant.
    payloads: per payload column a list of per-shard tensors, carried.
    key_bounds: optional per-key static (lo, hi) u64 bounds; an int64 key
      whose span fits 32 bits is sorted and exchanged as a u32 (``key -
      lo``) and comes back as the u64 it was.
    Returns (sorted keys, sorted payloads), per column a list of
    per-shard tensors. Rows equal on every key may come out in any order,
    as in JAX. A mesh whose size is not a power of two raises
    ValueError."""
    P = mesh.size
    if P & (P - 1):
        raise ValueError(f"distributed_sort needs a power-of-two number of shards, got {P}")
    keys = [list(k) for k in sort_keys]
    pays = [list(p) for p in payloads]
    nk = len(keys)
    if nk == 0:
        raise ValueError("distributed_sort: no sort key")
    _shard_lengths(mesh, keys + pays, "distributed_sort")
    los = [None] * nk
    for i, b in enumerate(key_bounds or ()):
        if b is not None and keys[i][0].dtype == torch.int64 and b[1] - b[0] <= 0xFFFFFFFF:
            los[i] = b[0]
            keys[i] = [_narrow_u32(k, b[0]) for k in keys[i]]
    runs = [_sorted_run([c[s] for c in keys + pays], nk) for s in range(P)]
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(P)]
            moved = [_xch_ppermute(mesh, [r[c] for r in runs], perm, "sort_exchange")
                     for c in range(len(runs[0]))]
            new = []
            for i in range(P):
                mine, other = runs[i], [m[i].flip(0) for m in moved]
                lt, eq = _lex_lt(mine[:nk], other[:nk])
                # shard i's block ascends iff bit k of i is clear; it keeps
                # the low half iff that direction matches its place in the pair
                keep_low = ((i & j) == 0) == ((i & k) == 0)
                take = (lt | eq) if keep_low else ~lt
                new.append(_sorted_run([torch.where(take, a, b) for a, b in zip(mine, other)],
                                       nk))
                del mine, other, lt, eq, take
            runs, moved = new, None
            j //= 2
        k *= 2
    out_keys = [[r[c] for r in runs] for c in range(nk)]
    for c, lo in enumerate(los):
        if lo is not None:
            out_keys[c] = [_widen_u32(t, lo) for t in out_keys[c]]
    return tuple(out_keys), tuple([r[nk + c] for r in runs] for c in range(len(pays)))


def _row_ids(mesh: Mesh, n_local: int) -> List[torch.Tensor]:
    """Each shard's global row ids (int64)."""
    return [torch.arange(n_local, dtype=torch.int64, device=dev) + s * n_local
            for s, dev in enumerate(mesh.devices)]


def distributed_order_permutation(mesh: Mesh, columns, descendings, unsigneds=None):
    """The global ORDER BY permutation of a sharded table (the JAX
    ``distributed_order_permutation``): per column a list of per-shard
    tensors (narrow unsigned streams in the signed type of their width,
    ``unsigneds`` saying which), keys made by ``make_sort_keys``, a
    narrow column's key sorted as a u32 (its static bound), and
    ``distributed_sort`` with the global row ids as payload. Returns the
    row ids in order, a list of per-shard int64 tensors (shard i: global
    ranks ``[i * n_local, (i + 1) * n_local)``)."""
    from eventql_tpu_torch.kernels.sort import make_sort_keys

    if unsigneds is None:
        unsigneds = (False,) * len(columns)
    n_local = _shard_lengths(mesh, columns, "distributed_order_permutation")
    bounds = [_sortkey_bounds(col[0].dtype, u, d)
              for col, d, u in zip(columns, descendings, unsigneds)]
    keys = [make_sort_keys([col[s] for col in columns], descendings, unsigneds)
            for s in range(mesh.size)]
    _, (perm,) = distributed_sort(mesh, [[k[c] for k in keys] for c in range(len(columns))],
                                  (_row_ids(mesh, n_local),), key_bounds=bounds)
    return perm


def _xch_broadcast(mesh: Mesh, t: torch.Tensor, op: str) -> dict:
    """``t`` from the merge shard on every distinct device of the mesh.
    Records its bytes once for every shard but shard 0."""
    _record(mesh, op, _nbytes(t) * (mesh.size - 1))
    return _replicas(mesh, t)


def distributed_bucket_sort(mesh: Mesh, sort_key, payload=None, oversample: int = 64,
                            capacity_factor: float = 2.0):
    """The padded-bucket sample sort (the JAX ``distributed_bucket_sort``):
    one exchange round in place of the compare-split's stages, with
    buckets of a fixed capacity.

    1. each shard sorts its run (stable, on the key);
    2. ``s = min(oversample, n_local)`` evenly spaced keys of every run
       are gathered (``bucket_samples``) and sorted, and the P - 1
       splitters are the quantiles at ``(arange(1, P) * P * s) // P``;
    3. each run splits at the splitters (``searchsorted``, side left, in
       unsigned order); its sentinel rows (key u64 max: filtered rows by
       contract) are left out; each bucket is packed into C = max(1,
       int(capacity_factor * n_local / P)) slots, and a bucket of more
       than C rows on some shard sets ``overflow`` (``bucket_overflow``);
    4. one ``_xch_ppermute`` per destination distance moves the buckets
       (``bucket_all_to_all``);
    5. each shard sorts the P * C entries it received (stable on the key:
       sources in shard order, each in its run's order).

    sort_key: a list of per-shard u64 keys (int64 bit patterns), all
    shards of equal length; payload: None or a list of per-shard tensors.
    Ties keep the payload's shard order and, within a shard, its input
    order: for ascending global row ids that is the JAX function's
    (key, payload) order, and then every output equals the JAX
    function's shard by shard.

    Returns (keys, payloads or None, counts, overflow): per shard P * C
    keys in order with the sentinel past its count, the payload alike
    (padded with 0), counts int64[P] and overflow a bool tensor, both on
    the merge shard. On overflow the buckets lost rows: the caller falls
    back to ``distributed_sort``, which is always exact.

    ``oversample`` and ``capacity_factor`` keep the JAX function's
    contract; the port's SQL route takes their defaults."""
    from eventql_tpu_torch.kernels.sort import _signed_order

    P = mesh.size
    cols = [sort_key] + ([payload] if payload is not None else [])
    n_local = _shard_lengths(mesh, cols, "distributed_bucket_sort")
    if sort_key[0].dtype != torch.int64:
        raise TypeError("distributed_bucket_sort: the key must be u64 (int64 bits)")
    C = max(1, int(capacity_factor * n_local / P))
    s = min(oversample, n_local)
    runs = [_sorted_run([c[i] for c in cols], 1) for i in range(P)]
    sample_at = (torch.arange(s, dtype=torch.int64) * n_local) // s
    samples = [r[0][sample_at.to(r[0].device)] for r in runs]
    gathered = _signed_order(_xch_all_gather(mesh, samples, "bucket_samples"))
    q = (torch.arange(1, P, dtype=torch.int64) * (P * s)) // P
    splitters = _xch_broadcast(mesh, torch.sort(gathered)[0][q.to(gathered.device)],
                               "bucket_samples")
    sends, overflows = [], []
    for i, r in enumerate(runs):
        dev = r[0].device
        skey = _signed_order(r[0])
        # the sentinel's place in signed order is INT64_MAX
        n_valid = torch.searchsorted(skey, torch.full((1,), (1 << 63) - 1, device=dev))
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.searchsorted(skey, splitters[dev])])
        ends = torch.minimum(torch.cat([starts[1:], n_valid]), n_valid)
        starts = torch.minimum(starts, n_valid)
        sizes = ends - starts
        overflows.append((sizes > C).any().to(torch.int32))
        slot = torch.arange(C, dtype=torch.int64, device=dev)
        pos = torch.clamp(starts[:, None] + slot[None, :], max=n_local - 1)
        inside = slot[None, :] < sizes[:, None]
        # one tensor a bucket, so that each goes once its destination has it
        sends.append([[torch.where(inside[j], c[pos[j]], torch.full((), fill, dtype=c.dtype,
                                                                    device=dev))
                       for j in range(P)] for c, fill in zip(r, (SENTINEL, 0))])
        runs[i] = None  # this shard's run goes before the next shard's buckets come
        del r, skey, pos, inside
    # destination d receives block d of every source, in source order
    recv = [[[None] * P for _ in cols] for _ in range(P)]
    for d in range(P):
        for c in range(len(cols)):
            recv[d][c][d] = sends[d][c][d]
    for dist in range(1, P):
        perm = [(i, (i - dist) % P) for i in range(P)]
        for c in range(len(cols)):
            got = _xch_ppermute(mesh, [sends[i][c][(i - dist) % P] for i in range(P)], perm,
                                "bucket_all_to_all")
            for d in range(P):
                recv[d][c][(d + dist) % P] = got[d]
            del got
    del sends
    outs, ms = [], []
    for d in range(P):
        bucket = [torch.cat(blocks) for blocks in recv[d]]
        recv[d] = None
        ms.append((bucket[0] != SENTINEL).sum().reshape(1))
        outs.append(_sorted_run(bucket, 1))
    counts = torch.cat([m.to(mesh.root) for m in ms])
    overflow = _xch_psum(mesh, overflows, "bucket_overflow") > 0
    return ([o[0] for o in outs], [o[1] for o in outs] if payload is not None else None,
            counts, overflow)


# -- kernel-tier top-k and grouped aggregates ---------------------------------------


def distributed_topk(mesh: Mesh, sort_key, payload_index, k: int, key_bound=None):
    """ORDER BY ... LIMIT k over a sharded table (the JAX
    ``distributed_topk``): each shard's top min(k, n_local) by
    ``topk_permutation`` (B1 twice and B3 on the card for a large shard),
    a gather of the candidates (``topk_gather``), and the top k of them,
    ties to the lowest position (the gather keeps shard order and each
    shard its rows' order): the order of JAX's ``lax.top_k``.

    sort_key: per-shard u64 keys (int64 bits), larger first;
    payload_index: per-shard int64 row ids. ``key_bound=(lo, hi)`` with a
    32-bit span clamps every key to the bound and runs the top-k on
    ``key - lo`` as a u32 (the JAX function's contract; no route of the
    port passes a bound). Returns (keys int64 [k] as u64 bits, row ids
    [k]) on the merge shard."""
    from eventql_tpu_torch.kernels.sort import _signed_order, topk_permutation

    _shard_lengths(mesh, [sort_key, payload_index], "distributed_topk")
    lo = None
    if key_bound is not None and key_bound[1] - key_bound[0] <= 0xFFFFFFFF:
        lo = key_bound[0]
        flo, fhi = _fold_i64(key_bound[0]) ^ -_SIGN63, _fold_i64(key_bound[1]) ^ -_SIGN63
        sort_key = [_narrow_u32(torch.clamp(_signed_order(t), flo, fhi) ^ -_SIGN63, lo)
                    for t in sort_key]
    vals, rows = [], []
    for key_l, idx_l in zip(sort_key, payload_index):
        pos = topk_permutation(key_l, min(k, key_l.shape[0]))
        vals.append(key_l[pos])
        rows.append(idx_l[pos])
    all_vals = _xch_all_gather(mesh, vals, "topk_gather")
    all_rows = _xch_all_gather(mesh, rows, "topk_gather")
    top = topk_permutation(all_vals, k)
    out = all_vals[top]
    return (out if lo is None else _widen_u32(out, lo)), all_rows[top]


def _agg_streams(value_arrays, agg_kinds, values_unsigned):
    """The H1 streams of kernel-tier aggregates: count needs none (the
    partial's row count serves), the others reduce their stream. Returns
    (stream indices, kinds, unsigned flags)."""
    for kind in agg_kinds:
        if kind not in _MERGE_KIND:
            raise ValueError(f"unknown aggregate kind {kind!r}: need one of {list(_MERGE_KIND)}")
    if values_unsigned is None:
        values_unsigned = (False,) * len(value_arrays)
    idx = [j for j, kind in enumerate(agg_kinds) if kind != "count"]
    return idx, [agg_kinds[j] for j in idx], [bool(values_unsigned[j]) for j in idx]


def _shard_partials(mesh, mask, key_arrays, value_arrays, idx, kinds, unsigned,
                    distinct=None):
    """Every shard's compact H1 partial (no key spans: the hash tier)."""
    n_local = _shard_lengths(mesh, list(key_arrays), "kernel-tier aggregate")
    nk = len(key_arrays)
    parts = []
    for s in range(mesh.size):
        parts.append(_local_partial(
            [k[s] for k in key_arrays], [None] * nk, n_local,
            None if mask is None else mask[s], [value_arrays[j][s] for j in idx], kinds,
            unsigned, [] if distinct is None else [distinct[s]],
            [] if distinct is None else [None], s * n_local))
    return parts


def _in_key_order(keys, keys_unsigned):
    """The permutation that puts groups in ascending key order: the order
    of the JAX ``masked_grouped_aggregate`` (``sortable_u64`` keys,
    lexicographic)."""
    from eventql_tpu_torch.kernels.groupby import sortable_u64
    from eventql_tpu_torch.kernels.sort import order_permutation

    if keys_unsigned is None:
        keys_unsigned = (False,) * len(keys)
    return order_permutation([sortable_u64(k, unsigned=u) for k, u in zip(keys, keys_unsigned)])


def _empty_groups(mesh, key_arrays, value_arrays, agg_kinds):
    dev = mesh.root
    keys = [torch.empty(0, dtype=k[0].dtype, device=dev) for k in key_arrays]
    aggs = [torch.empty(0, dtype=torch.float64 if kind != "count"
                        and value_arrays[j][0].dtype == torch.float64 else torch.int64,
                        device=dev) for j, kind in enumerate(agg_kinds)]
    return keys, aggs, torch.empty(0, dtype=torch.bool, device=dev)


def distributed_grouped_aggregate(mesh: Mesh, mask, key_arrays, value_arrays, agg_kinds,
                                  values_unsigned=None, keys_unsigned=None):
    """Filter + GROUP BY + merge over a sharded table (the JAX
    ``distributed_grouped_aggregate``): H1 on each shard, an O(groups)
    gather of the compact partials (``groupby_gather``) and one H1 merge
    on the merge shard (``_MERGE_KIND``), shared with the mesh GROUP BY.

    mask: a list of per-shard bool tensors (or None: every row);
    key_arrays / value_arrays: per stream a list of per-shard tensors;
    agg_kinds: "count", "sum", "min" or "max" per value stream (a count
    ignores its stream). ``values_unsigned`` makes a stream's min / max
    unsigned (u64 bits) and zero-extends a narrow one; ``keys_unsigned``
    orders a key as unsigned.

    Returns (group_keys, aggs, valid) on the merge shard: every group,
    in ascending key order (that of JAX's ``masked_grouped_aggregate``),
    keys in their own dtypes, counts and integer aggregates int64 (sums
    exact mod 2^64), float ones float64, and ``valid`` all true. JAX pads
    the three to P * n_local entries behind the valid prefix; here they
    end with the last group."""
    idx, kinds, unsigned = _agg_streams(value_arrays, agg_kinds, values_unsigned)
    parts = _shard_partials(mesh, mask, key_arrays, value_arrays, idx, kinds, unsigned)
    merged = _merge(mesh, parts, [None] * len(key_arrays), kinds, unsigned, (),
                    "groupby_gather")
    if merged is None:
        return _empty_groups(mesh, key_arrays, value_arrays, agg_kinds)
    order = _in_key_order(merged.keys, keys_unsigned)
    it = iter(merged.aggs)
    aggs = [merged.counts if kind == "count" else next(it) for kind in agg_kinds]
    return ([k[order] for k in merged.keys], [a[order] for a in aggs],
            torch.ones(order.shape[0], dtype=torch.bool, device=order.device))


def distributed_count_distinct(mesh: Mesh, mask, key_arrays, values, keys_unsigned=None):
    """Exact COUNT(DISTINCT values) GROUP BY keys over a sharded table (the
    JAX ``distributed_count_distinct``): each shard's distinct (keys,
    value) pairs by H1, gathered (``distinct_gather``), deduplicated
    again and counted per key, as the mesh GROUP BY's count_distinct.
    Values compare by their 64 bits (a float64 stream by its own bits).

    Returns (group_keys, distinct counts int64, valid) on the merge
    shard, every group in ascending key order, ``valid`` all true (JAX
    pads to P * n_local entries)."""
    values = [v.view(torch.int64) if v.dtype == torch.float64 else v for v in values]
    parts = _shard_partials(mesh, mask, key_arrays, [], [], [], [], distinct=values)
    merged = _merge(mesh, parts, [None] * len(key_arrays), [], [], [None], "distinct_gather")
    if merged is None:
        keys, (counts,), valid = _empty_groups(mesh, key_arrays, [], ["count"])
        return keys, counts, valid
    order = _in_key_order(merged.keys, keys_unsigned)
    return ([k[order] for k in merged.keys], merged.distinct[0][order],
            torch.ones(order.shape[0], dtype=torch.bool, device=order.device))


def _masked_reduce(x, match, kind: str, unsigned: bool):
    """Per row e of ``match`` [E, F]: the ``kind`` reduction of ``x[f]``
    over the f where ``match[e, f]`` (sum, or min / max, a u64 stream in
    unsigned order). A row with no match gives the kind's identity."""
    from eventql_tpu_torch.kernels.groupby import _op_identity

    xs = x[None, :].expand(match.shape)
    if kind == "sum":
        return torch.where(match, xs, torch.zeros((), dtype=x.dtype, device=x.device)).sum(1)
    flip = -_SIGN63 if unsigned and x.dtype == torch.int64 else 0
    if flip:
        xs = xs ^ flip
    ident = torch.full((), _op_identity(x.dtype, kind), dtype=x.dtype, device=x.device)
    red = torch.where(match, xs, ident)
    out = red.amin(1) if kind == "min" else red.amax(1)
    return out ^ flip if flip else out


def distributed_grouped_aggregate_sharded(mesh: Mesh, mask, key_arrays, value_arrays,
                                          agg_kinds, values_unsigned=None,
                                          keys_unsigned=None):
    """GROUP BY whose result stays sharded (the JAX
    ``distributed_grouped_aggregate_sharded``), for more groups than one
    shard should hold:

    1. H1 on each shard combines its rows to one entry a group;
    2. ``distributed_sort`` orders the entries of every shard by
       (invalid, keys), the partial states as payload, so that each key's
       entries lie in one run, across adjacent shards at most;
    3. H1 on each shard combines its run again (``_MERGE_KIND``);
    4. a key can still span shards only through their first and last
       entries: the 2P edge entries are gathered (``boundary_gather``),
       and the highest shard holding a key takes its merged total while
       the lower copies go invalid (``boundary_patch`` returns each
       shard's two edges).

    Arguments as ``distributed_grouped_aggregate``; kinds count, sum,
    min, max (a u64 min / max in unsigned order). Returns (group_keys,
    aggs, valid), each a list of per-shard tensors: shard i holds the
    groups of its run in ascending key order, valid groups unique across
    shards and ascending from shard to shard. JAX gives each shard
    n_local entries with the valid ones first; here a shard's entries end
    with its last group."""
    from eventql_tpu_torch.kernels.groupby import sortable_u64
    from eventql_tpu_torch.kernels.hash_groupby import hash_groupby

    P, nk = mesh.size, len(key_arrays)
    if P & (P - 1):
        raise ValueError(f"distributed_grouped_aggregate_sharded needs a power-of-two"
                         f" number of shards, got {P}")
    if keys_unsigned is None:
        keys_unsigned = (False,) * nk
    idx, kinds, unsigned = _agg_streams(value_arrays, agg_kinds, values_unsigned)
    parts = _shard_partials(mesh, mask, key_arrays, value_arrays, idx, kinds, unsigned)
    # the partial states, one per aggregate, and their merge
    state_kinds = [_MERGE_KIND[kind] for kind in agg_kinds]
    state_uns = [bool(u) for u in (values_unsigned or (False,) * len(agg_kinds))]

    def states(p):
        it = iter(p.aggs)
        return [p.counts if kind == "count" else next(it) for kind in agg_kinds]

    L = max(1, max(p.counts.shape[0] for p in parts))

    def pad(t):
        return torch.cat([t, torch.zeros(L - t.shape[0], dtype=t.dtype, device=t.device)])

    invalid, skeys, pkeys = [], [[] for _ in range(nk)], [[] for _ in range(nk)]
    pstates = [[] for _ in agg_kinds]
    for p in parts:
        dev = p.counts.device
        invalid.append(torch.arange(L, device=dev) >= p.counts.shape[0])
        for c, (k, u) in enumerate(zip(p.keys, keys_unsigned)):
            kp = pad(k)
            pkeys[c].append(kp)
            skeys[c].append(sortable_u64(kp, unsigned=u))
        for c, st in enumerate(states(p)):
            pstates[c].append(pad(st))
    del parts
    bounds = [(0, 1)] + [_sortkey_bounds(k[0].dtype, u) for k, u in zip(key_arrays,
                                                                         keys_unsigned)]
    (inv_s, *_), pay = distributed_sort(mesh, [invalid, *skeys], [*pkeys, *pstates],
                                        key_bounds=bounds)
    del invalid, skeys, pkeys, pstates
    keys_s, states_s = pay[:nk], pay[nk:]

    # 3. each shard's run combined again, its groups in key order
    out_keys, out_aggs, valid, edges = [], [], [], []
    for s in range(P):
        res = hash_groupby([k[s] for k in keys_s], L, ~inv_s[s], [a[s] for a in states_s],
                           state_kinds, state_uns)
        occ = torch.nonzero(res.counts > 0).flatten()
        order = occ[torch.argsort(res.first_index[occ])]
        at = res.first_index[order]
        out_keys.append([k[s][at] for k in keys_s])
        out_aggs.append([a[order] for a in res.aggregates])
        mng = order.shape[0]
        valid.append(torch.ones(mng, dtype=torch.bool, device=order.device))
        edges.append(mng)
        del res, occ, order, at
    if P == 1:
        return ([[k[c] for k in out_keys] for c in range(nk)],
                [[a[c] for a in out_aggs] for c in range(len(agg_kinds))], valid)

    # 4. the boundary patch over the 2P edge entries
    def edge_pair(t, mng):
        return t[[0, max(mng - 1, 0)]] if mng else torch.zeros(2, dtype=t.dtype,
                                                               device=t.device)

    dev0 = mesh.root
    contrib = _xch_all_gather(mesh, [torch.tensor([m > 0, m >= 2], device=d)
                                     for m, d in zip(edges, mesh.devices)], "boundary_gather")
    bkeys = [_xch_all_gather(mesh, [edge_pair(k[c], m) for k, m in zip(out_keys, edges)],
                             "boundary_gather") for c in range(nk)]
    baggs = [_xch_all_gather(mesh, [edge_pair(a[c], m) for a, m in zip(out_aggs, edges)],
                             "boundary_gather") for c in range(len(agg_kinds))]
    match = contrib[None, :] & contrib[:, None]
    for bk in bkeys:
        match = match & (bk[:, None] == bk[None, :])
    bshard = torch.arange(2 * P, device=dev0) // 2
    cnt = match.sum(1)
    owner = torch.where(match, bshard[None, :], -1).amax(1)
    spans = cnt > 1
    is_owner = spans & (owner == bshard)
    drop = spans & (owner != bshard)
    totals = [_masked_reduce(ba, match, kind, u)
              for ba, kind, u in zip(baggs, state_kinds, state_uns)]
    patch = torch.stack([is_owner.to(torch.int64), drop.to(torch.int64)]
                        + [t.view(torch.int64) if t.dtype == torch.float64 else t
                           for t in totals])
    for s, (dev, mng) in enumerate(zip(mesh.devices, edges)):
        if mng == 0:
            continue
        rows = patch[:, 2 * s:2 * s + 2]
        _record(mesh, "boundary_patch", _nbytes(rows) if s else 0)
        rows = rows.to(dev, non_blocking=True)
        for e, pos in enumerate([0, mng - 1] if mng >= 2 else [0]):
            own, gone = rows[0, e:e + 1] != 0, rows[1, e:e + 1] != 0
            for c, a in enumerate(out_aggs[s]):
                t = rows[2 + c, e:e + 1]
                t = t.view(torch.float64) if a.dtype == torch.float64 else t
                a[pos:pos + 1] = torch.where(own, t, a[pos:pos + 1])
            valid[s][pos:pos + 1] &= ~gone
    return ([[k[c] for k in out_keys] for c in range(nk)],
            [[a[c] for a in out_aggs] for c in range(len(agg_kinds))], valid)
