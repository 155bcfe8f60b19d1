"""Partition placement allocation.

Re-implements the decision rule of the reference's ServerAllocator
(reference: db/server_allocator.cc — pick N distinct live servers for a
new partition, preferring the least loaded; load comes from the
per-server stats each node's Monitor publishes into the coordination
service, falling back to partition-placement counts).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory
from eventql_tpu_torch.core.errors import RuntimeError_


def placement_load(cdir: ConfigDirectory, db: str = "default") -> Dict[str, int]:
    """Partition placements per server across every table's derived
    partition map (the allocator's fallback load signal)."""
    load: Dict[str, int] = {}
    doc = cdir._read()
    for _table, cfg in doc["namespaces"].get(db, {}).get("tables", {}).items():
        for e in (cfg.get("metadata") or {}).get("partitions", []):
            for sid in e.get("servers", []):
                load[sid] = load.get(sid, 0) + 1
    return load


def allocate(
    cdir: ConfigDirectory,
    n: int,
    db: str = "default",
    exclude: Iterable[str] = (),
) -> List[str]:
    """n distinct live servers, least-loaded first (reference:
    ServerAllocator::allocateServers with ALLOC_PREFER_UNLOADED). Falls
    back to fewer servers only if the cluster is smaller than n."""
    exclude = set(exclude)
    live = [
        s.server_id
        for s in cdir.list_servers()
        if s.server_status == SERVER_UP and s.server_id not in exclude
    ]
    if not live:
        raise RuntimeError_("no live servers to allocate from")
    load = placement_load(cdir, db)
    # monitor-published load (partitions hosted) takes precedence when
    # present (reference: load factor from ServerStats)
    for s in cdir.list_servers():
        published = getattr(s, "load_partitions", None)
        if published is not None and s.server_id in live:
            load[s.server_id] = max(load.get(s.server_id, 0), int(published))
    live.sort(key=lambda sid: (load.get(sid, 0), sid))
    return live[: max(1, min(n, len(live)))]
