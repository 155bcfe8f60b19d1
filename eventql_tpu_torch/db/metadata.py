"""Table partition metadata: the keyrange → placement map.

Re-implements the reference's metadata-file semantics
(reference: db/metadata_file.h:49-66 PartitionMapEntry — sorted begin
keys over a typed keyspace, each entry placed on N servers;
db/metadata_client.cc findPartition; splits create two adjacent
entries). Stored in the standalone ConfigDirectory as part of the
table config, read by the coordinator for write routing (all replicas,
majority ack — table_service.cc:933-1058) and query scoping (one
replica per partition, keyrange-filtered scans — server/sql/
scheduler.cc:55-159).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_

KEYSPACE_UINT64 = "uint64"
KEYSPACE_STRING = "string"


def _cmp_key(keyspace: str, a, b) -> int:
    """Compare partition keys; '' is negative infinity (the first
    partition's begin), like the reference's empty begin key."""
    if a == "" and b == "":
        return 0
    if a == "":
        return -1
    if b == "":
        return 1
    if keyspace == KEYSPACE_UINT64:
        a, b = int(a), int(b)
    else:
        a, b = str(a), str(b)
    return -1 if a < b else (1 if a > b else 0)


@dataclass
class PartitionMapEntry:
    begin: object  # "" = -inf; else int (uint64 keyspace) or str
    partition_id: str
    servers: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "begin": self.begin,
            "partition_id": self.partition_id,
            "servers": list(self.servers),
        }

    @staticmethod
    def from_json(d: dict) -> "PartitionMapEntry":
        return PartitionMapEntry(
            d["begin"], d["partition_id"], list(d.get("servers", []))
        )


@dataclass
class TableMetadata:
    keyspace: str
    partition_key: str  # the routing column (first PRIMARY KEY column)
    entries: List[PartitionMapEntry] = field(default_factory=list)

    # -- construction ----------------------------------------------------
    @staticmethod
    def initial(
        keyspace: str,
        partition_key: str,
        table_name: str,
        servers: List[str],
    ) -> "TableMetadata":
        pid = hashlib.sha1(f"{table_name}\x00".encode()).hexdigest()[:20]
        return TableMetadata(
            keyspace,
            partition_key,
            [PartitionMapEntry("", pid, list(servers))],
        )

    # -- lookup ----------------------------------------------------------
    def lookup(self, key) -> PartitionMapEntry:
        """The entry owning `key`: the last entry with begin <= key
        (reference: metadata_file.cc:68-99)."""
        out = self.entries[0]
        for e in self.entries[1:]:
            if _cmp_key(self.keyspace, e.begin, key) <= 0:
                out = e
            else:
                break
        return out

    def find(self, partition_id: str) -> Optional[PartitionMapEntry]:
        for e in self.entries:
            if e.partition_id == partition_id:
                return e
        return None

    def keyrange(self, partition_id: str) -> Tuple[object, object]:
        """[begin, end) of a partition; '' bounds are infinite."""
        for i, e in enumerate(self.entries):
            if e.partition_id == partition_id:
                end = (
                    self.entries[i + 1].begin
                    if i + 1 < len(self.entries)
                    else ""
                )
                return e.begin, end
        raise RuntimeError_(f"partition not found: {partition_id}")

    # -- split -----------------------------------------------------------
    def split(self, partition_id: str, split_point) -> None:
        """Split a partition at split_point into [begin, split) and
        [split, end) — same placements (no data movement needed: every
        replica already holds the full keyrange; queries scope by
        keyrange)."""
        for i, e in enumerate(self.entries):
            if e.partition_id != partition_id:
                continue
            end = (
                self.entries[i + 1].begin if i + 1 < len(self.entries) else ""
            )
            if _cmp_key(self.keyspace, e.begin, split_point) >= 0 or (
                end != "" and _cmp_key(self.keyspace, split_point, end) >= 0
            ):
                raise RuntimeError_("split point outside partition keyrange")
            new_pid = hashlib.sha1(
                f"{partition_id}\x00{split_point}".encode()
            ).hexdigest()[:20]
            self.entries.insert(
                i + 1,
                PartitionMapEntry(split_point, new_pid, list(e.servers)),
            )
            return
        raise RuntimeError_(f"partition not found: {partition_id}")

    # -- (de)serialization ----------------------------------------------
    def to_json(self) -> dict:
        return {
            "keyspace": self.keyspace,
            "partition_key": self.partition_key,
            "partitions": [e.to_json() for e in self.entries],
        }

    @staticmethod
    def from_json(d: dict) -> "TableMetadata":
        return TableMetadata(
            d["keyspace"],
            d["partition_key"],
            [PartitionMapEntry.from_json(e) for e in d["partitions"]],
        )
