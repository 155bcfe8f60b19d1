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
every shard (kernels/groupby_agg.py, kernels/join.py) and exchange only
O(num_buckets) accumulator words: ``distributed_sum_count`` (the JAX
``distributed_pallas_sum_count``), ``distributed_join_aggregate`` and
``distributed_multi_join_aggregate``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.exec.device_exec import _to_tensor


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
