"""Mesh-resident table provider: SQL over a table sharded on its rows.

The counterpart of eventql_tpu/parallel/mesh_provider.py. The reference's
distributed scheduler rewrites a query into per-partition partial plans
fanned out over TCP (reference: server/sql/scheduler.cc:55-264); here the
table lies in equal row blocks on the shards of a ``Mesh``
(parallel/distributed.py) and exec/mesh_exec.py runs GROUP BY, JOIN +
GROUP BY, ORDER BY ... LIMIT and ORDER BY plans shard by shard,
exchanging accumulator tables, top-k candidates or sorted runs.

The provider keeps the host Relation (it IS a RelationTableProvider), so
every plan the mesh routes decline is served by the host engine.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from eventql_tpu_torch.exec.runtime import RelationTableProvider
from eventql_tpu_torch.parallel.distributed import Mesh, make_mesh, padded_rows


class MeshTableProvider(RelationTableProvider):
    """Tables sharded on the row axis over ``mesh`` (or over a new mesh of
    ``n_shards`` shards on ``device``: "cuda", the visible cards round
    robin, one shard per card by default; "cpu" for the tests). Rows pad
    to a multiple of ``n_shards`` so that every shard holds as many rows
    as the next."""

    def __init__(self, n_shards: Optional[int] = None, device: str = "cuda",
                 mesh: Optional[Mesh] = None):
        super().__init__()
        if mesh is None:
            if n_shards is None:
                import torch

                n_shards = torch.cuda.device_count() if device == "cuda" else 1
            mesh = make_mesh(n_shards, device)
        if mesh.group is not None:
            raise ValueError("MeshTableProvider: the SQL mesh routes run on a single-controller"
                             " mesh (make_mesh), not on a process mesh")
        self.mesh = mesh
        self.n_shards = mesh.size
        self._shard_cache: Dict[Tuple, Tuple] = {}
        self._lock = threading.Lock()

    def add_table(self, name, rel, stypes=None):
        super().add_table(name, rel, stypes)
        # columns are immutable: a replaced relation must not serve the
        # old relation's shards
        with self._lock:
            for k in [k for k in self._shard_cache if k[0] == name]:
                del self._shard_cache[k]

    def padded_rows(self, n: int) -> int:
        return padded_rows(n, self.n_shards)

    def sharded_scan_columns(self, table_name: str, input_columns):
        """The scan's input columns on the shards: ``(shards, n, n_p)``,
        ``shards[i]`` the list of ``torch_expr.DeviceCol`` of shard i, each
        ``n_p / n_shards`` rows of the narrowed column (``_narrow_np``)
        and its validity, padded with zeros past row ``n``.

        Cached per (table, column, relation identity, n_p): a warm column
        pays no host -> device copy. Whatever bounds a column (its
        dictionary, its min / max cached by ``_narrow_np``) is the whole
        column's, so every shard reads the same key spans
        (``device_exec._stored_span``) and takes the same tier of the hash
        aggregate."""
        from eventql_tpu_torch.exec import torch_expr
        from eventql_tpu_torch.exec.device_exec import _narrow_np, _to_tensor

        rel = self.get_table_data(table_name)
        n = rel.num_rows
        n_p = self.padded_rows(n)
        local = n_p // self.n_shards
        by_name = dict(zip(rel.names, rel.columns))
        per_column = []
        for cname, _t in input_columns:
            c = by_name[cname]
            key = (table_name, cname, id(c), n_p)
            with self._lock:
                cached = self._shard_cache.get(key)
                if cached is None:
                    data, valid = _narrow_np(c), c.valid
                    if n_p > n:
                        data = np.pad(data, (0, n_p - n))
                        valid = np.pad(valid, (0, n_p - n))
                    cached = self._shard_cache[key] = tuple(
                        (_to_tensor(data[i * local:(i + 1) * local], dev),
                         _to_tensor(valid[i * local:(i + 1) * local], dev))
                        for i, dev in enumerate(self.mesh.devices))
            per_column.append((c.stype, cached))
        shards = [[torch_expr.DeviceCol(stype, *cached[i]) for stype, cached in per_column]
                  for i in range(self.n_shards)]
        return shards, n, n_p
