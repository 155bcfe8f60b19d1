"""The mesh tier's exchange layer: shards, their devices, and the
collectives that move accumulator tables between them.

The counterpart of eventql_tpu/parallel/distributed.py. There a table
lies sharded on the row axis of a ``jax.sharding.Mesh`` and one XLA
program per query runs every shard under ``jax.shard_map``; its
collectives (all_gather, psum, ppermute over ICI) take the place of the
reference's QUERY_PARTIALAGGR fan-out and coordinator merge (reference:
sql/statements/select/groupby.cc:438-714). Here a ``Mesh`` is driven
either by one Python process (``make_mesh``: a single controller, as
``shard_map`` is) or by several (``parallel/multihost.py``'s
``global_mesh`` over ``torch.distributed``, as the JAX package's global
mesh spans processes); one implementation serves both, the single
controller being the mesh whose one process owns every shard:

* a ``Mesh`` lists the shards' torch devices and the process (rank) that
  drives each. A device may repeat: several shards on one card are the
  counterpart of the JAX package's virtual CPU mesh, and shard i of a
  mesh made for "cuda" lies on ``cuda:(i mod visible cards)``. Every
  per-shard argument and result is a list of ``mesh.size`` tensors,
  indexed by global shard id; on a process mesh the entries of another
  process's shards are None, and each function touches only
  ``mesh.local``;
* the collectives act on those lists. Within a process they move tensors
  with ``.to(device, non_blocking=True)`` (peer to peer between cards);
  between processes through ``torch.distributed`` (gloo takes host
  tensors, so a CUDA tensor is staged through pinned host memory; NCCL
  takes it where it is). A gathered table is needed once, so
  ``_xch_all_gather`` brings it to the merging process (the owner of
  shard 0), which merges it; a merged result every process returns is
  then broadcast (``_replicate``), so that every process holds the same
  bits (a float sum through H1's atomics follows no fixed order, so
  merging on every process would not);
* each collective records the bytes that cross from one shard to
  another, whether or not the two share a device, by ``op`` name, in
  every ``exchange_tally`` open on the mesh; on a process mesh each
  process records what its own shards send, so the sum over the
  processes equals the single controller's tally of the same call, op by
  op, and two ops exist there alone: ``gather_lengths`` (the row counts
  exchanged before a gather of unequal parts) and ``result_broadcast``
  (a merged or replicated result sent to the other processes). Each
  record also states the bytes that crossed processes and the host
  milliseconds spent staging them.

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

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.exec.device_exec import _to_tensor
from eventql_tpu_torch.exec.torch_expr import _fold_i64


class Mesh:
    """The shards: shard i on ``devices[i]``, driven by process (rank)
    ``owners[i]``.

    ``make_mesh`` gives the single controller: one process, ``owners``
    all 0. ``multihost.global_mesh`` gives a process mesh: ``group`` is
    the ``torch.distributed`` group of the owners, and ``devices[i]`` is
    None for a shard of another process. ``local`` lists the shards this
    process drives; the owner of shard 0 merges gathered tables
    (``merges``); ``root``, the device of this process's first shard, is
    where it keeps merged and replicated results."""

    def __init__(self, devices: Sequence, owners: Optional[Sequence[int]] = None,
                 rank: int = 0, group=None):
        self.devices = [None if d is None else torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.owners = [0] * len(self.devices) if owners is None else [int(o) for o in owners]
        self.rank = int(rank)
        self.local = [i for i, o in enumerate(self.owners) if o == self.rank]
        if not self.local or any(self.devices[i] is None for i in self.local):
            raise ValueError(f"process {self.rank} drives no shard of {self.owners}, or one"
                             " of its shards has no device")
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.backend = None if group is None else dist.get_backend(group)
        self._tallies: List["exchange_tally"] = []

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        return self.devices[self.local[0]]

    @property
    def merges(self) -> bool:
        return self.owners[0] == self.rank

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, owners={self.owners})"


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
    ``mesh`` while it is open, dicts ``{"op", "bytes", "cross",
    "stage_ms"}``: the bytes this process's shards sent to other shards,
    those of them that crossed processes, and the host milliseconds spent
    staging them through host memory (gloo)."""

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

    def cross_bytes(self) -> int:
        return sum(r["cross"] for r in self.records)

    def stage_ms(self) -> float:
        return sum(r["stage_ms"] for r in self.records)


def _record(mesh: Mesh, op: str, nbytes: int, cross: int = 0, stage_ms: float = 0.0) -> None:
    for t in mesh._tallies:
        t.records.append({"op": op, "bytes": int(nbytes), "cross": int(cross),
                          "stage_ms": stage_ms})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_map(mesh: Mesh, fn) -> list:
    """``fn(i)`` for each shard i this process drives, None for the others:
    a per-shard list."""
    out = [None] * mesh.size
    for i in mesh.local:
        out[i] = fn(i)
    return out


# -- between processes ------------------------------------------------------------

# gloo's host buffers from this size on are pinned (faster copies to and
# from the card; the caching host allocator keeps them for the next call)
_PIN_BYTES = 1 << 20
# what a replicated result's header can name
_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
           torch.float32, torch.float64)


class _Wire:
    """One collective's tensors on their way to and from the backend: gloo
    takes host tensors, so a CUDA tensor goes through (pinned) host memory
    and back; NCCL takes tensors on this process's card. ``ms``: the host
    milliseconds of those copies, the copies back to the card waited for
    in ``done``."""

    def __init__(self, mesh: Mesh):
        self.host = mesh.backend == "gloo"
        self.comm = torch.device("cpu") if self.host else mesh.root
        self.ms = 0.0
        self._cards = set()

    def _pinned(self, nbytes: int) -> bool:
        return self.host and torch.cuda.is_available() and nbytes >= _PIN_BYTES

    def out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.device == self.comm:
            return t
        t0 = time.perf_counter()
        buf = torch.empty(t.shape, dtype=t.dtype, device=self.comm,
                          pin_memory=self._pinned(_nbytes(t)))
        buf.copy_(t)
        self.ms += (time.perf_counter() - t0) * 1e3
        return buf

    def empty(self, shape, dtype) -> torch.Tensor:
        """A buffer the backend receives into."""
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        return torch.empty(shape, dtype=dtype, device=self.comm, pin_memory=self._pinned(n))

    def back(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if t.device == dev:
            return t
        t0 = time.perf_counter()
        # to the host it waits: a non-blocking copy there would be read
        # (row counts, a maximum) before the card has written it
        to_card = dev.type == "cuda"
        out = t.to(dev, non_blocking=to_card)
        if to_card:
            self._cards.add(dev)
        self.ms += (time.perf_counter() - t0) * 1e3
        return out

    def done(self) -> None:
        t0 = time.perf_counter()
        for dev in self._cards:
            torch.cuda.synchronize(dev)
        self.ms += (time.perf_counter() - t0) * 1e3
        self._cards.clear()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, flat (gloo takes no int16)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _all_reduce(mesh: Mesh, t: torch.Tensor, how=None):
    """``t`` reduced over the processes (sum, or ``how``), on t's device,
    and the host ms spent staging it."""
    wire = _Wire(mesh)
    w = wire.out(t)
    dist.all_reduce(w, op=dist.ReduceOp.SUM if how is None else how, group=mesh.group)
    out = wire.back(w, t.device)
    wire.done()
    return out, wire.ms


def _process_rows(mesh: Mesh, rows) -> List[int]:
    """Every shard's row count on every process, from each process's
    ``rows`` of its own shards (a per-shard list), by one all-reduce
    (``gather_lengths``: each process's counts sent to the others)."""
    v = torch.zeros(mesh.size, dtype=torch.int64)
    for i in mesh.local:
        v[i] = int(rows[i])
    v, ms = _all_reduce(mesh, v)
    nb = 8 * len(mesh.local) * (mesh.world - 1)
    _record(mesh, "gather_lengths", nb, nb, ms)
    return v.tolist()


def _process_max(mesh: Mesh, x: int) -> int:
    """The largest ``x`` of the processes (``gather_lengths``)."""
    if mesh.group is None:
        return x
    v, ms = _all_reduce(mesh, torch.tensor([int(x)], dtype=torch.int64), dist.ReduceOp.MAX)
    nb = 8 * (mesh.world - 1)
    _record(mesh, "gather_lengths", nb, nb, ms)
    return int(v[0])


def _replicate(mesh: Mesh, tensors, op: str = "result_broadcast",
               nbytes: Optional[int] = None) -> list:
    """Tensors the merging process computed (None on every other process),
    the same bits on every process, each on its ``root``; on one process,
    returned as they are. The merging process records their bytes once
    for every other process under ``op`` (``nbytes`` instead, for an op
    the single controller records), all of them as crossing; a header of
    dtypes and shapes goes first."""
    if mesh.group is None:
        return list(tensors)
    wire = _Wire(mesh)
    src = mesh.owners[0]
    head = torch.zeros((len(tensors), 4), dtype=torch.int64)
    if mesh.merges:
        for j, t in enumerate(tensors):
            if t.dim() > 2:
                raise ValueError(f"_replicate: a {t.dim()}-d tensor")
            head[j, 0], head[j, 1] = _DTYPES.index(t.dtype), t.dim()
            head[j, 2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        payload = torch.cat([_as_bytes(t).to(mesh.root) for t in tensors])
    head = wire.out(head)
    dist.broadcast(head, src, group=mesh.group)
    shapes = [(_DTYPES[int(h[0])], tuple(int(x) for x in h[2:2 + int(h[1])]))
              for h in head.cpu()]
    sizes = [int(np.prod(s)) * torch.empty((), dtype=d).element_size() for d, s in shapes]
    if mesh.merges:
        payload = wire.out(payload)
    else:
        payload = wire.empty((sum(sizes),), torch.uint8)
    if payload.numel():
        dist.broadcast(payload, src, group=mesh.group)
    out, at = [], 0
    for (dtype, shape), size in zip(shapes, sizes):
        out.append(wire.back(payload[at:at + size].clone(), mesh.root).view(dtype).reshape(shape))
        at += size
    wire.done()
    if mesh.merges:
        cross = (payload.numel() + _nbytes(head)) * (mesh.world - 1)
        _record(mesh, op, cross if nbytes is None else nbytes, cross, wire.ms)
    return out


# -- the collectives ----------------------------------------------------------------


def _xch_gather(mesh: Mesh, columns, op: str) -> list:
    """Per column (a per-shard list; the columns of one shard have the same
    rows) the shards' tensors concatenated in shard order, on the merging
    process's ``root``; None on every other process. Records the bytes
    of every part but shard 0's. Between processes the shards' row counts
    go first (``gather_lengths``), and each process's parts travel as one
    run of bytes padded to the longest."""
    P = mesh.size
    for parts in columns:
        if len(parts) != P:
            raise ValueError(f"{len(parts)} parts for a mesh of {P} shards")
    moved = sum(_nbytes(parts[i]) for parts in columns for i in mesh.local if i)
    if mesh.group is None:
        _record(mesh, op, moved)
        return [torch.cat([p.to(mesh.root, non_blocking=True) for p in parts])
                for parts in columns]
    rows = _process_rows(mesh, _local_map(mesh, lambda i: columns[0][i].shape[0]))
    per_process = [0] * mesh.world
    for i, r in enumerate(rows):
        per_process[mesh.owners[i]] += r
    longest = max(per_process)
    wire, cross, out = _Wire(mesh), 0, []
    for parts in columns:
        first = parts[mesh.local[0]]
        tail = tuple(first.shape[1:])
        row_bytes = first.element_size() * int(np.prod(tail))
        if longest == 0:
            out.append(torch.empty((0,) + tail, dtype=first.dtype, device=mesh.root))
            continue
        mine = _as_bytes(torch.cat([parts[i] for i in mesh.local]))
        send = torch.zeros(longest * row_bytes, dtype=torch.uint8, device=mine.device)
        send[:mine.numel()] = mine
        send = wire.out(send)
        bufs = ([wire.empty((longest * row_bytes,), torch.uint8) for _ in range(mesh.world)]
                if mesh.merges else None)
        dist.gather(send, bufs, dst=mesh.owners[0], group=mesh.group)
        if not mesh.merges:
            cross += send.numel()
            out.append(None)
            continue
        # shard i: its process's run, after that process's earlier shards
        pieces, at = [], [0] * mesh.world
        for i, r in enumerate(rows):
            o = mesh.owners[i]
            pieces.append(bufs[o][at[o]:at[o] + r * row_bytes])
            at[o] += r * row_bytes
        g = wire.back(torch.cat(pieces), mesh.root)
        out.append(g.view(first.dtype).reshape((-1,) + tail))
    wire.done()
    _record(mesh, op, moved, cross, wire.ms)
    return out


def _xch_all_gather(mesh: Mesh, parts: Sequence[torch.Tensor],
                    op: str = "all_gather") -> torch.Tensor:
    """The shards' tensors, concatenated in shard order on the merging
    process's ``root`` (None on any other process). Records the bytes of
    every part but shard 0's."""
    return _xch_gather(mesh, [parts], op)[0]


def _xch_psum(mesh: Mesh, parts: Sequence[torch.Tensor], op: str = "psum") -> torch.Tensor:
    """The elementwise sum of the shards' equally shaped tensors (integers
    wrap mod 2^64) on this process's ``root``: the process's own parts
    summed, then one all-reduce over the processes, so that every process
    holds the sum. Records the bytes of every part but shard 0's, and on
    a process mesh the sum's way back to the other processes
    (``result_broadcast``)."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    moved = sum(_nbytes(parts[i]) for i in mesh.local if i)
    out = parts[mesh.local[0]].to(mesh.root, copy=True)
    for i in mesh.local[1:]:
        out += parts[i].to(mesh.root, non_blocking=True)
    if mesh.group is None:
        _record(mesh, op, moved)
        return out
    out, ms = _all_reduce(mesh, out)
    _record(mesh, op, moved, 0 if mesh.merges else _nbytes(out), ms)
    if mesh.merges:
        back = _nbytes(out) * (mesh.world - 1)
        _record(mesh, "result_broadcast", back, back)
    return out


def _xch_ppermute(mesh: Mesh, parts: Sequence[torch.Tensor], perm,
                  op: str = "ppermute") -> List[torch.Tensor]:
    """``out[d] = parts[s]`` moved to shard d's device for each pair
    ``(s, d)`` of ``perm`` (a permutation of the shards), every part of
    one shape and dtype (as in ``ppermute``). A pair within one process
    moves with ``.to()``, a pair across processes by a send and a receive,
    all of a call in one batch; a received part is placed by its source.
    Records the bytes of every pair with s != d (by the process of s)."""
    if sorted(d for _s, d in perm) != list(range(mesh.size)):
        raise ValueError(f"{perm} is not a permutation of {mesh.size} shards")
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    moved = cross = 0
    wire, ops, landed = _Wire(mesh), [], []
    for tag, (s, d) in enumerate(perm):
        mine_s, mine_d = mesh.owners[s] == mesh.rank, mesh.owners[d] == mesh.rank
        if mine_s and s != d:
            moved += _nbytes(parts[s])
        if mine_s and mine_d:
            out[d] = parts[s].to(mesh.devices[d], non_blocking=True)
        elif mine_s:
            b = wire.out(_as_bytes(parts[s]))
            cross += b.numel()
            ops.append(dist.P2POp(dist.isend, b, mesh.owners[d], group=mesh.group, tag=tag))
        elif mine_d:
            like = parts[d]
            b = wire.empty((_nbytes(like),), torch.uint8)
            ops.append(dist.P2POp(dist.irecv, b, mesh.owners[s], group=mesh.group, tag=tag))
            landed.append((d, b, like))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for d, b, like in landed:
        out[d] = wire.back(b, mesh.devices[d]).view(like.dtype).reshape(like.shape)
    wire.done()
    _record(mesh, op, moved, cross, wire.ms)
    return out


def _xch_broadcast(mesh: Mesh, t: Optional[torch.Tensor], op: str) -> dict:
    """``t`` from the merging process (None on the others) on every
    distinct device of this process's shards. The merging process
    records its bytes once for every shard but shard 0."""
    if mesh.group is None:
        _record(mesh, op, _nbytes(t) * (mesh.size - 1))
    else:
        (t,) = _replicate(mesh, [t], op, None if t is None else _nbytes(t) * (mesh.size - 1))
    return _replicas(mesh, t)


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
    returns every slot), in slot order: key bits, counts, aggregates,
    global first rows."""
    from eventql_tpu_torch.kernels.hash_groupby import compact_groups

    g, kc = compact_groups(res, order=None, gather=keys)
    return kc, g.counts, list(g.aggregates), g.first_index + g0


def _local_partial(keys, spans, n, mask, values, kinds, unsigned, distinct, dspans, g0,
                   device):
    """One shard's H1 partial on ``device``. A mean is summed here and
    divided after the merge."""
    from eventql_tpu_torch.kernels.hash_groupby import hash_groupby

    local_kinds = ["sum" if k == "mean" else k for k in kinds]
    res = hash_groupby(keys, n, mask, values, local_kinds, unsigned, (), spans,
                       device=device)
    kc, counts, aggs, first = _compact(res, keys, g0)
    del res
    pairs = []
    for d, dspan in zip(distinct, dspans):
        pres = hash_groupby([*keys, d], n, mask, key_spans=[*spans, dspan], device=device)
        pk, _counts, _aggs, pfirst = _compact(pres, [*keys, d], g0)
        pairs.append((pk, pfirst))
        del pres
    return _Partial(kc, counts, aggs, first, pairs)


class _Merged(NamedTuple):
    """The merged groups, on this process's ``root`` (on a process mesh the
    same bits on every process), in the order of their first global rows."""

    keys: list
    counts: torch.Tensor
    aggs: list
    first: torch.Tensor
    distinct: list


def _merge(mesh, parts, spans, kinds, unsigned, dspans, op) -> Optional[_Merged]:
    """Gather the shards' compact partials (``parts``, a per-shard list) and
    merge them with H1 on the merging process: counts and sums add, min /
    max by ``kinds`` (the local kinds; a mean's sum adds), first rows by
    min. count_distinct: the gathered pairs are deduplicated, then
    counted per key. On a process mesh the merged groups are then
    broadcast, so that every process returns them. None when no shard
    has a group."""
    nk, na = len(spans), len(kinds)
    groups = _xch_gather(
        mesh, [[None if p is None else p.keys[j] for p in parts] for j in range(nk)]
        + [[None if p is None else p.counts for p in parts]]
        + [[None if p is None else p.aggs[j] for p in parts] for j in range(na)]
        + [[None if p is None else p.first for p in parts]], op)
    pairs = [_xch_gather(
        mesh, [[None if p is None else p.pairs[j][0][i] for p in parts] for i in range(nk + 1)]
        + [[None if p is None else p.pairs[j][1] for p in parts]], op)
        for j in range(len(dspans))]
    fields = (_merge_gathered(groups, pairs, spans, kinds, unsigned, dspans) if mesh.merges
              else [None] * (nk + na + 2 + len(dspans)))
    fields = _replicate(mesh, fields)
    if fields[nk].shape[0] == 0:
        return None
    return _Merged(fields[:nk], fields[nk], fields[nk + 1:nk + 1 + na], fields[nk + 1 + na],
                   fields[nk + 2 + na:])


def _merge_gathered(groups, pairs, spans, kinds, unsigned, dspans) -> list:
    """``_merge``'s H1 work on the gathered partials: the merged keys,
    counts, aggregates, first rows and count_distinct counts, as one list
    (the gathered, empty columns where no shard has a group)."""
    from eventql_tpu_torch.kernels.hash_groupby import compact_groups, hash_groupby

    nk = len(spans)
    keys, counts, aggs, first = groups[:nk], groups[nk], groups[nk + 1:-1], groups[-1]
    G = counts.shape[0]
    device = counts.device
    if G == 0:
        return [*groups, *(torch.zeros(0, dtype=torch.int64, device=device)
                           for _ in dspans)]
    merge_kinds = ["sum", *(_MERGE_KIND.get(k, "sum") for k in kinds), "min"]
    res = hash_groupby(keys, G, None, [counts, *aggs, first], merge_kinds,
                       [False, *unsigned, False], (), spans, device=device)
    # in the order of the merged first global rows
    merged, mkeys = compact_groups(res, order=res.aggregates[-1], gather=keys)
    out = [*mkeys, *merged.aggregates]
    ng = merged.counts.shape[0]
    del res, merged
    for (*pkeys, pfirst), dspan in zip(pairs, dspans):
        # the same pair on several shards: once, with its first row
        dedup = hash_groupby(pkeys, pfirst.shape[0], None, [pfirst], ["min"], None, (),
                             [*spans, dspan], device=device)
        dedup, at_keys = compact_groups(dedup, order=None, gather=pkeys[:nk])
        per_key = hash_groupby(at_keys, dedup.counts.shape[0], None, [dedup.aggregates[0]],
                               ["min"], None, (), spans, device=device)
        # a key's first pair row is the key's first row: the order above
        per_key, _ = compact_groups(per_key, order=per_key.aggregates[0])
        if per_key.counts.shape[0] != ng:
            raise AssertionError("count_distinct groups differ from the merged groups")
        out.append(per_key.counts)
    return out


def padded_rows(n: int, n_shards: int) -> int:
    """Rows padded to a multiple of ``n_shards`` (at least one row a
    shard): every shard gets the same number of rows."""
    return max(n_shards, -(-int(n) // n_shards) * n_shards)


def shard_table(mesh: Mesh, arrays) -> List[List[torch.Tensor]]:
    """Host arrays (or CPU tensors) as equal row blocks, block i on shard
    i's device (on a process mesh this process places only its own
    shards' blocks, None for the others); each array is padded with zeros
    to ``padded_rows``. A padding row of a fact table must be masked out
    by the caller (a ``False`` mask padding does it); unsigned arrays
    travel as the signed type of their width."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else _to_tensor(np.asarray(a), "cpu")
        n = t.shape[0]
        n_p = padded_rows(n, mesh.size)
        if n_p > n:
            t = torch.cat([t, torch.zeros(n_p - n, dtype=t.dtype, device=t.device)])
        local = n_p // mesh.size
        out.append(_local_map(mesh, lambda i: t[i * local:(i + 1) * local].to(mesh.devices[i])))
    return out


def _replicas(mesh: Mesh, t: torch.Tensor) -> dict:
    """``t`` on every distinct device of this process's shards (a
    replicated input, as a ``P()`` input of shard_map: placed, not
    exchanged; on a process mesh every process passes the same ``t``)."""
    return {dev: t.to(dev) for dev in dict.fromkeys(mesh.devices[i] for i in mesh.local)}


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
    counts = _xch_psum(mesh, [None if t is None else t[0] for t in tables], op)
    sums = _xch_psum(mesh, [None if t is None else t[1] for t in tables], op)
    return counts, sums


def distributed_sum_count(mesh: Mesh, mask, gid, values, num_buckets: int):
    """Scan + filter + GROUP BY count / sum over a sharded table: B1 on
    each shard (``groupby_agg``: a bucket outside [0, num_buckets) is
    dropped), then one psum of the count and sum tables, O(num_buckets)
    words a shard whatever the rows or their skew.

    mask, gid, values: lists of per-shard tensors (bool, int32 buckets,
    u64 values as int64 or narrower unsigned streams). Returns (counts,
    sums), int64[num_buckets] on this process's ``root`` (on a process
    mesh every process holds them); sums are exact mod 2^64."""
    tables = _local_map(mesh, lambda i: _sum_count(gid[i], gid[i].shape[0], mask[i], values[i],
                                                   num_buckets))
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

    def table(i):
        fk = fact_keys[i]
        # this shard's bucket ids go before the next shard's are made
        gid = _probe(fk, dk[fk.device], db[fk.device], fk.shape[0], probe)
        return _sum_count(gid, fk.shape[0], fact_mask[i], fact_values[i], num_buckets)

    return _psum_tables(mesh, _local_map(mesh, table), "join_psum")


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
    def where(i):
        fk2, fm = fact_k2[i], fact_mask[i]
        active = _probe(fk2, d2k[fk2.device], d2f[fk2.device], fk2.shape[0], probe) == 1
        return active if fm is None else fm & active

    masks = _local_map(mesh, where)
    # join 1: the dim1 shards go around the ring (across processes too)
    gid = _local_map(mesh, lambda i: torch.full((fact_k1[i].shape[0],), -1, dtype=torch.int32,
                                                device=fact_k1[i].device))
    dk, db = list(dim1_keys), list(dim1_bucket)
    for step in range(P):
        for s in mesh.local:
            g = _probe(fact_k1[s], dk[s], db[s], fact_k1[s].shape[0], probe)
            gid[s] = torch.maximum(gid[s], g)
            del g
        if step + 1 < P:
            dk = _xch_ppermute(mesh, dk, ring, op="join_ring")
            db = _xch_ppermute(mesh, db, ring, op="join_ring")
    tables = _local_map(mesh, lambda i: _sum_count(gid[i], gid[i].shape[0], masks[i],
                                                   fact_values[i], num_buckets))
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
    """The rows a shard of ``columns`` (per-shard lists) holds, the same on
    every shard (on a process mesh: every shard of this process)."""
    if any(len(col) != mesh.size for col in columns):
        raise ValueError(f"{what}: every column needs {mesh.size} shards of equal length")
    lengths = {col[i].shape[0] for col in columns for i in mesh.local}
    if len(lengths) != 1:
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
        if (b is not None and keys[i][mesh.local[0]].dtype == torch.int64
                and b[1] - b[0] <= 0xFFFFFFFF):
            los[i] = b[0]
            keys[i] = _local_map(mesh, lambda s, c=keys[i], lo=b[0]: _narrow_u32(c[s], lo))
    runs = _local_map(mesh, lambda s: _sorted_run([c[s] for c in keys + pays], nk))
    ncols = nk + len(pays)
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(P)]
            moved = [_xch_ppermute(mesh, [None if r is None else r[c] for r in runs], perm,
                                   "sort_exchange")
                     for c in range(ncols)]
            new = [None] * P
            for i in mesh.local:
                mine, other = runs[i], [m[i].flip(0) for m in moved]
                lt, eq = _lex_lt(mine[:nk], other[:nk])
                # shard i's block ascends iff bit k of i is clear; it keeps
                # the low half iff that direction matches its place in the pair
                keep_low = ((i & j) == 0) == ((i & k) == 0)
                take = (lt | eq) if keep_low else ~lt
                new[i] = _sorted_run([torch.where(take, a, b) for a, b in zip(mine, other)], nk)
                del mine, other, lt, eq, take
            runs, moved = new, None
            j //= 2
        k *= 2
    out = [_local_map(mesh, lambda s, c=c: runs[s][c]) for c in range(ncols)]
    for c, lo in enumerate(los):
        if lo is not None:
            out[c] = _local_map(mesh, lambda s, t=out[c], lo=lo: _widen_u32(t[s], lo))
    return tuple(out[:nk]), tuple(out[nk:])


def _row_ids(mesh: Mesh, n_local: int) -> List[torch.Tensor]:
    """Each shard's global row ids (int64), on every process the global
    ones."""
    return _local_map(mesh, lambda s: torch.arange(n_local, dtype=torch.int64,
                                                   device=mesh.devices[s]) + s * n_local)


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
    bounds = [_sortkey_bounds(col[mesh.local[0]].dtype, u, d)
              for col, d, u in zip(columns, descendings, unsigneds)]
    keys = _local_map(mesh, lambda s: make_sort_keys([col[s] for col in columns], descendings,
                                                     unsigneds))
    _, (perm,) = distributed_sort(
        mesh, [[None if k is None else k[c] for k in keys] for c in range(len(columns))],
        (_row_ids(mesh, n_local),), key_bounds=bounds)
    return perm


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
    (padded with 0), counts int64[P] (each shard's count, as the JAX
    function's sharded ``counts``) and overflow a bool tensor, both on
    this process's ``root`` (on a process mesh, every process holds
    both). On overflow the buckets lost rows: the caller falls back to
    ``distributed_sort``, which is always exact.

    ``oversample`` and ``capacity_factor`` keep the JAX function's
    contract; the port's SQL route takes their defaults."""
    from eventql_tpu_torch.kernels.sort import _signed_order

    P = mesh.size
    cols = [sort_key] + ([payload] if payload is not None else [])
    n_local = _shard_lengths(mesh, cols, "distributed_bucket_sort")
    if sort_key[mesh.local[0]].dtype != torch.int64:
        raise TypeError("distributed_bucket_sort: the key must be u64 (int64 bits)")
    C = max(1, int(capacity_factor * n_local / P))
    s = min(oversample, n_local)
    runs = _local_map(mesh, lambda i: _sorted_run([c[i] for c in cols], 1))
    sample_at = (torch.arange(s, dtype=torch.int64) * n_local) // s
    samples = _local_map(mesh, lambda i: runs[i][0][sample_at.to(runs[i][0].device)])
    gathered = _xch_all_gather(mesh, samples, "bucket_samples")
    quantiles = None
    if mesh.merges:
        gathered = _signed_order(gathered)
        q = (torch.arange(1, P, dtype=torch.int64) * (P * s)) // P
        quantiles = torch.sort(gathered)[0][q.to(gathered.device)]
    splitters = _xch_broadcast(mesh, quantiles, "bucket_samples")
    sends, overflows = [None] * P, [None] * P
    for i in mesh.local:
        r = runs[i]
        dev = r[0].device
        skey = _signed_order(r[0])
        # the sentinel's place in signed order is INT64_MAX
        n_valid = torch.searchsorted(skey, torch.full((1,), (1 << 63) - 1, device=dev))
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.searchsorted(skey, splitters[dev])])
        ends = torch.minimum(torch.cat([starts[1:], n_valid]), n_valid)
        starts = torch.minimum(starts, n_valid)
        sizes = ends - starts
        overflows[i] = (sizes > C).any().to(torch.int32)
        slot = torch.arange(C, dtype=torch.int64, device=dev)
        pos = torch.clamp(starts[:, None] + slot[None, :], max=n_local - 1)
        inside = slot[None, :] < sizes[:, None]
        # one tensor a bucket, so that each goes once its destination has it
        sends[i] = [[torch.where(inside[j], c[pos[j]], torch.full((), fill, dtype=c.dtype,
                                                                  device=dev))
                     for j in range(P)] for c, fill in zip(r, (SENTINEL, 0))]
        runs[i] = None  # this shard's run goes before the next shard's buckets come
        del r, skey, pos, inside
    # destination d receives block d of every source, placed by source
    recv = _local_map(mesh, lambda d: [[None] * P for _ in cols])
    for d in mesh.local:
        for c in range(len(cols)):
            recv[d][c][d] = sends[d][c][d]
    for hop in range(1, P):
        perm = [(i, (i - hop) % P) for i in range(P)]
        for c in range(len(cols)):
            got = _xch_ppermute(
                mesh, [None if sends[i] is None else sends[i][c][(i - hop) % P]
                       for i in range(P)], perm, "bucket_all_to_all")
            for d in mesh.local:
                recv[d][c][(d + hop) % P] = got[d]
            del got
    del sends
    outs, ms = [None] * P, [None] * P
    for d in mesh.local:
        bucket = [torch.cat(blocks) for blocks in recv[d]]
        recv[d] = None
        ms[d] = (bucket[0] != SENTINEL).sum().reshape(1)
        outs[d] = _sorted_run(bucket, 1)
    counts = _shard_counts(mesh, ms)
    overflow = _xch_psum(mesh, overflows, "bucket_overflow") > 0
    return (_local_map(mesh, lambda d: outs[d][0]),
            _local_map(mesh, lambda d: outs[d][1]) if payload is not None else None,
            counts, overflow)


def _shard_counts(mesh: Mesh, ms) -> torch.Tensor:
    """One number a shard (a per-shard list of int64 [1]) as int64 [P] on
    this process's ``root``: read where the single controller holds them
    all; on a process mesh every process's own entries summed over the
    processes (``result_broadcast``: each process's numbers to the others)."""
    if mesh.group is None:
        return torch.cat([m.to(mesh.root) for m in ms])
    v = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.root)
    for i in mesh.local:
        v[i:i + 1] = ms[i]
    v, stage_ms = _all_reduce(mesh, v)
    nb = 8 * len(mesh.local) * (mesh.world - 1)
    _record(mesh, "result_broadcast", nb, nb, stage_ms)
    return v


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
    [k]) on this process's ``root``: the merging process picks them, and
    on a process mesh broadcasts them to the others."""
    from eventql_tpu_torch.kernels.sort import _signed_order, topk_permutation

    _shard_lengths(mesh, [sort_key, payload_index], "distributed_topk")
    lo = None
    if key_bound is not None and key_bound[1] - key_bound[0] <= 0xFFFFFFFF:
        lo = key_bound[0]
        flo, fhi = _fold_i64(key_bound[0]) ^ -_SIGN63, _fold_i64(key_bound[1]) ^ -_SIGN63
        sort_key = _local_map(mesh, lambda i, keys=sort_key: _narrow_u32(
            torch.clamp(_signed_order(keys[i]), flo, fhi) ^ -_SIGN63, lo))
    pos = _local_map(mesh, lambda i: topk_permutation(sort_key[i], min(k, sort_key[i].shape[0])))
    all_vals, all_rows = _xch_gather(
        mesh, [_local_map(mesh, lambda i: sort_key[i][pos[i]]),
               _local_map(mesh, lambda i: payload_index[i][pos[i]])], "topk_gather")
    out = None
    if mesh.merges:
        top = topk_permutation(all_vals, k)
        out = [all_vals[top], all_rows[top]]
    vals, rows = _replicate(mesh, out or [None, None])
    return (vals if lo is None else _widen_u32(vals, lo)), rows


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
    # each shard's first global row: s * n_local on every process
    return _local_map(mesh, lambda s: _local_partial(
        [k[s] for k in key_arrays], [None] * nk, n_local,
        None if mask is None else mask[s], [value_arrays[j][s] for j in idx], kinds,
        unsigned, [] if distinct is None else [distinct[s]],
        [] if distinct is None else [None], s * n_local, mesh.devices[s]))


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
    dev, s = mesh.root, mesh.local[0]
    keys = [torch.empty(0, dtype=k[s].dtype, device=dev) for k in key_arrays]
    aggs = [torch.empty(0, dtype=torch.float64 if kind != "count"
                        and value_arrays[j][s].dtype == torch.float64 else torch.int64,
                        device=dev) for j, kind in enumerate(agg_kinds)]
    return keys, aggs, torch.empty(0, dtype=torch.bool, device=dev)


def distributed_grouped_aggregate(mesh: Mesh, mask, key_arrays, value_arrays, agg_kinds,
                                  values_unsigned=None, keys_unsigned=None):
    """Filter + GROUP BY + merge over a sharded table (the JAX
    ``distributed_grouped_aggregate``): H1 on each shard, an O(groups)
    gather of the compact partials (``groupby_gather``) and one H1 merge
    on the merging process (``_MERGE_KIND``), shared with the mesh GROUP
    BY.

    mask: a list of per-shard bool tensors (or None: every row);
    key_arrays / value_arrays: per stream a list of per-shard tensors;
    agg_kinds: "count", "sum", "min" or "max" per value stream (a count
    ignores its stream). ``values_unsigned`` makes a stream's min / max
    unsigned (u64 bits) and zero-extends a narrow one; ``keys_unsigned``
    orders a key as unsigned.

    Returns (group_keys, aggs, valid) on this process's ``root`` (on a
    process mesh the same bits on every process): every group,
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

    Returns (group_keys, distinct counts int64, valid) as
    ``distributed_grouped_aggregate``, every group in ascending key
    order, ``valid`` all true (JAX pads to P * n_local entries)."""
    values = [v.view(torch.int64) if v is not None and v.dtype == torch.float64 else v
              for v in values]
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
    from eventql_tpu_torch.kernels.hash_groupby import compact_groups, hash_groupby

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

    # one length on every shard of every process, as the sort needs
    L = _process_max(mesh, max(1, max(parts[i].counts.shape[0] for i in mesh.local)))

    def pad(t):
        return torch.cat([t, torch.zeros(L - t.shape[0], dtype=t.dtype, device=t.device)])

    invalid = [None] * P
    skeys, pkeys = [[None] * P for _ in range(nk)], [[None] * P for _ in range(nk)]
    pstates = [[None] * P for _ in agg_kinds]
    for i in mesh.local:
        p = parts[i]
        invalid[i] = torch.arange(L, device=p.counts.device) >= p.counts.shape[0]
        for c, (k, u) in enumerate(zip(p.keys, keys_unsigned)):
            pkeys[c][i] = pad(k)
            skeys[c][i] = sortable_u64(pkeys[c][i], unsigned=u)
        for c, st in enumerate(states(p)):
            pstates[c][i] = pad(st)
    del parts, p
    bounds = [(0, 1)] + [_sortkey_bounds(k[mesh.local[0]].dtype, u)
                         for k, u in zip(key_arrays, keys_unsigned)]
    (inv_s, *_), pay = distributed_sort(mesh, [invalid, *skeys], [*pkeys, *pstates],
                                        key_bounds=bounds)
    del invalid, skeys, pkeys, pstates
    keys_s, states_s = pay[:nk], pay[nk:]

    # 3. each shard's run combined again, its groups in key order
    out_keys, out_aggs, valid, edges = [None] * P, [None] * P, [None] * P, [None] * P
    for s in mesh.local:
        res = hash_groupby([k[s] for k in keys_s], L, ~inv_s[s], [a[s] for a in states_s],
                           state_kinds, state_uns, device=mesh.devices[s])
        res, out_keys[s] = compact_groups(res, gather=[k[s] for k in keys_s])
        out_aggs[s] = list(res.aggregates)
        edges[s] = res.counts.shape[0]
        valid[s] = torch.ones(edges[s], dtype=torch.bool, device=mesh.devices[s])
        del res

    def result():
        return ([_local_map(mesh, lambda s, c=c: out_keys[s][c]) for c in range(nk)],
                [_local_map(mesh, lambda s, c=c: out_aggs[s][c]) for c in range(len(agg_kinds))],
                valid)

    if P == 1:
        return result()

    # 4. the boundary patch over the 2P edge entries
    def edge_pair(t, mng):
        return t[[0, max(mng - 1, 0)]] if mng else torch.zeros(2, dtype=t.dtype,
                                                               device=t.device)

    contrib, *edge_cols = _xch_gather(
        mesh, [_local_map(mesh, lambda s: torch.tensor([edges[s] > 0, edges[s] >= 2],
                                                       device=mesh.devices[s]))]
        + [_local_map(mesh, lambda s, c=c: edge_pair(out_keys[s][c], edges[s]))
           for c in range(nk)]
        + [_local_map(mesh, lambda s, c=c: edge_pair(out_aggs[s][c], edges[s]))
           for c in range(len(agg_kinds))], "boundary_gather")
    patch, nb = None, 0
    if mesh.merges:
        bkeys, baggs = edge_cols[:nk], edge_cols[nk:]
        match = contrib[None, :] & contrib[:, None]
        for bk in bkeys:
            match = match & (bk[:, None] == bk[None, :])
        bshard = torch.arange(2 * P, device=mesh.root) // 2
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
        # each shard with a group but shard 0 is sent its two columns
        has = [m > 0 for m in edges] if mesh.group is None else contrib[0::2].tolist()
        nb = _nbytes(patch[:, :2]) * sum(1 for s in range(1, P) if has[s])
    if mesh.group is None:
        _record(mesh, "boundary_patch", nb)
    else:
        (patch,) = _replicate(mesh, [patch], "boundary_patch", nb)
    for s in mesh.local:
        mng = edges[s]
        if mng == 0:
            continue
        rows = patch[:, 2 * s:2 * s + 2].to(mesh.devices[s], non_blocking=True)
        for e, pos in enumerate([0, mng - 1] if mng >= 2 else [0]):
            own, gone = rows[0, e:e + 1] != 0, rows[1, e:e + 1] != 0
            for c, a in enumerate(out_aggs[s]):
                t = rows[2 + c, e:e + 1]
                t = t.view(torch.float64) if a.dtype == torch.float64 else t
                a[pos:pos + 1] = torch.where(own, t, a[pos:pos + 1])
            valid[s][pos:pos + 1] &= ~gone
    return result()
