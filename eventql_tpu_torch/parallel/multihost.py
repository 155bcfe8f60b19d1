"""Multi-process execution tier: one mesh whose shards are driven by
several processes, over ``torch.distributed``.

The counterpart of eventql_tpu/parallel/multihost.py. The reference
scales a query across machines by shipping plan shards to partition
servers over TCP and merging result frames on the coordinator
(reference: server/sql/scheduler.cc:164-264); the JAX package connects
the processes with ``jax.distributed`` and lets one global mesh span
them. Here ``init_multihost`` joins a ``torch.distributed`` process
group, ``global_mesh`` builds a ``Mesh`` whose shards belong to the
processes in global order, and every kernel-tier function of
parallel/distributed.py runs on it unchanged: each process drives its
own shards, and the collectives cross processes where the shards' owners
differ. A process owns the table rows of its shards
(``make_global_table``), the counterpart of a partition server's data.

Backends: "nccl" needs a card for each process (NCCL refuses two ranks
on one card); "gloo" runs on the CPU and where processes share a card,
its CUDA tensors staged through host memory. The SQL mesh routes
(exec/mesh_exec.py) stay on a single-controller mesh.

    init_multihost("127.0.0.1:29500", 2, rank, backend="gloo")
    mesh = global_mesh(4, "cpu")          # 8 shards, 4 a process
    mask, keys, vals = make_global_table(mesh, [mask_np, keys_np, vals_np])
    gk, aggs, valid = distributed_grouped_aggregate(mesh, mask, [keys], [vals], ["sum"])
"""

from __future__ import annotations

import datetime
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.parallel.distributed import (
    Mesh,
    _replicate,
    _xch_all_gather,
    shard_table,
)

BACKENDS = ("gloo", "nccl")


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   backend: str, timeout_s: float = 300.0) -> None:
    """Join the process group at ``coordinator_address`` ("host:port", the
    store of process 0) as ``process_id`` of ``num_processes``. A
    collective that waits longer than ``timeout_s`` for a lost peer
    raises. ``backend`` "nccl" puts process i on card i (the processes of
    one host) and raises where there is no card i; "gloo" needs no card
    and lets processes share one (card i mod the visible cards).
    Idempotent per process."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: need one of {BACKENDS}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and process_id >= cards:
        raise RuntimeError_(
            f"init_multihost(backend='nccl'): process {process_id} needs a card of its own,"
            f" {cards} visible; NCCL refuses two ranks on one card: use 'gloo'")
    if cards:
        torch.cuda.set_device(process_id % cards)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (
                num_processes, process_id, backend):
            raise RuntimeError_("init_multihost: this process already joined another group")
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(shards_per_process: int, device: str = "cuda") -> Mesh:
    """A mesh of ``world * shards_per_process`` shards, shard i driven by
    process ``i // shards_per_process`` (global order, as the JAX
    ``global_mesh``): this process's shards on its card ("cuda", the card
    ``init_multihost`` chose; raises where there is none) or on the CPU
    ("cpu"; not with NCCL). Every process must pass the same
    ``shards_per_process``: one all-gather of it checks."""
    spp = int(shards_per_process)
    if spp < 1:
        raise ValueError(f"shards_per_process = {spp}: need at least 1")
    if not dist.is_initialized():
        raise RuntimeError_("global_mesh: call init_multihost first")
    backend = dist.get_backend()
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError_("global_mesh(device='cuda'): no CUDA device is available;"
                                " pass device='cpu' (with backend 'gloo')")
        dev = torch.device("cuda", torch.cuda.current_device())
    elif device == "cpu":
        if backend == "nccl":
            raise ValueError("global_mesh(device='cpu'): NCCL moves CUDA tensors only")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"global_mesh: device {device!r} is neither 'cuda' nor 'cpu'")
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = torch.tensor([spp], dtype=torch.int64, device=dev if backend == "nccl" else "cpu")
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    seen = [int(t) for t in every]
    if len(set(seen)) != 1:
        raise ValueError(f"global_mesh: the processes pass shards_per_process {seen}")
    owners = [i // spp for i in range(world * spp)]
    return Mesh([dev if o == rank else None for o in owners], owners=owners, rank=rank,
                group=dist.group.WORLD)


def make_global_table(mesh: Mesh, arrays: Sequence[np.ndarray]):
    """The arrays sharded on their rows, each process placing only its own
    shards' blocks (per array a per-shard list, None for another
    process's shard). Every process passes the same full arrays; rows
    that do not divide by the shard count raise ValueError (the JAX
    contract; ``shard_table`` pads instead)."""
    for a in arrays:
        n = a.shape[0]
        if n % mesh.size:
            raise ValueError(f"rows ({n}) must divide evenly over {mesh.size} shards")
    return tuple(shard_table(mesh, arrays))


def fetch_replicated(t: torch.Tensor) -> np.ndarray:
    """A replicated result on the host (any process)."""
    return t.cpu().numpy()


def fetch_sharded(mesh: Mesh, parts) -> np.ndarray:
    """A sharded result (a per-shard list) in shard order on every
    process: gathered to the merging process and broadcast (only for
    results, never for table data)."""
    whole = _xch_all_gather(mesh, parts, "fetch")
    return _replicate(mesh, [whole], "fetch")[0].cpu().numpy()
