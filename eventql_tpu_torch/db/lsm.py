"""LSM-style durable table storage.

The observable storage contract of the reference's partition engine
(reference: db/partition_writer.cc LSMPartitionWriter — in-memory
arena → immutable columnar segment flush (commit :269-348), minor→major
compaction (:360+), primary-key upsert semantics via newest-wins
version resolution; read path merges segments newest→oldest with a
seen-key filter, server/sql/partition_cursor.cc:83-195), built on our
cstable v0.1 reader/writer.

Layout on disk:
  <datadir>/<table>/table.json          schema + metadata
  <datadir>/<table>/segment-<nnn>.cst   immutable columnar segments
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from eventql_tpu_torch.columnar.cstable import CSTableReader
from eventql_tpu_torch.columnar.cstable_v2 import write_cstable_v2 as write_cstable
from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType, SValue
from eventql_tpu_torch.db.table_service import (
    MemoryTable,
    TableService,
    _flatten_columns,
)
from eventql_tpu_torch.exec.relation import Column, Relation

# reference: db/partition_writer.cc:64-65 (scaled down: rows per
# segment flush; the 512 MB / 2M-row numbers are partition-split
# thresholds there)
DEFAULT_ARENA_FLUSH_ROWS = 100_000


def _defs_to_json(defs):
    out = []
    for d in defs or []:
        out.append(
            {
                "name": d.column_name,
                "type": d.column_type,
                "repeated": d.repeated,
                "not_null": d.not_null,
                "subcolumns": _defs_to_json(d.subcolumns)
                if d.subcolumns is not None
                else None,
            }
        )
    return out


def _defs_from_json(data):
    from eventql_tpu_torch.plan.nodes import ColumnDefinition

    out = []
    for d in data or []:
        out.append(
            ColumnDefinition(
                d["name"],
                d["type"],
                repeated=d.get("repeated", False),
                not_null=d.get("not_null", False),
                subcolumns=_defs_from_json(d["subcolumns"])
                if d.get("subcolumns") is not None
                else None,
            )
        )
    return out


class LSMTable(MemoryTable):
    """A MemoryTable whose rows durably persist as LSM segments."""

    def __init__(
        self,
        base_dir: str,
        name: str,
        columns,
        primary_key,
        partition_key,
        properties,
        arena_flush_rows: int = DEFAULT_ARENA_FLUSH_ROWS,
        column_defs=None,
    ):
        super().__init__(
            name, columns, primary_key, partition_key, properties,
            column_defs=column_defs,
        )
        self.base_dir = base_dir
        self.dir = os.path.join(base_dir, name)
        self.arena_flush_rows = arena_flush_rows
        os.makedirs(self.dir, exist_ok=True)
        self._write_config()
        self._segments: List[str] = self._list_segments()
        self._segment_readers = {}

    # -- config ---------------------------------------------------------
    def _write_config(self):
        cfg = {
            "table": self.name,
            "columns": [
                {"name": n, "type": int(t), "repeated": r}
                for n, t, r in self.columns
            ],
            "primary_key": self.primary_key,
            "partition_key": self.partition_key,
            "properties": self.properties,
            "column_defs": _defs_to_json(self.column_defs),
        }
        tmp = os.path.join(self.dir, "table.json.tmp")
        with open(tmp, "w") as f:
            json.dump(cfg, f)
        os.replace(tmp, os.path.join(self.dir, "table.json"))

    @staticmethod
    def open(base_dir: str, name: str) -> "LSMTable":
        path = os.path.join(base_dir, name, "table.json")
        with open(path) as f:
            cfg = json.load(f)
        t = LSMTable(
            base_dir,
            name,
            [(c["name"], SType(c["type"]), c["repeated"]) for c in cfg["columns"]],
            cfg["primary_key"],
            cfg.get("partition_key"),
            list(cfg.get("properties", {}).items()),
            column_defs=_defs_from_json(cfg.get("column_defs")),
        )
        return t

    # -- segment manifest (crash consistency) ---------------------------
    # The set AND order of live segments is committed atomically through
    # `segments.json` (tmp + fsync + rename). A segment file becomes
    # durable-visible only once the manifest names it, so a crash at any
    # point of commit/compaction leaves either the old or the new
    # manifest — never a half state. Files on disk but not in the
    # manifest (a crash between segment write and manifest commit, or
    # between a compaction's manifest flip and its old-file retirement)
    # are orphans: ignored and swept to .trash on reopen. This is the
    # role the reference's double-metablock flip + FileTracker refs play
    # (io/cstable/cstable_writer.cc:283-292, db/file_tracker.cc).
    _MANIFEST = "segments.json"

    def _list_segments(self) -> List[str]:
        mpath = os.path.join(self.dir, self._MANIFEST)
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    segs = list(json.load(f)["segments"])
            except (OSError, ValueError, KeyError):
                segs = None
            if segs is not None:
                self._sweep_orphans(segs)
                return segs
        # legacy dir (pre-manifest): adopt the name-sorted scan
        segs = sorted(
            f
            for f in os.listdir(self.dir)
            if f.startswith("segment-") and f.endswith(".cst")
        )
        self._write_manifest_file(segs)
        return segs

    def _write_manifest_file(self, segments: List[str]):
        tmp = os.path.join(self.dir, self._MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"segments": list(segments)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, self._MANIFEST))

    def _sweep_orphans(self, live: List[str]):
        """Move segment/index/tmp files the manifest does not name into
        .trash — the remains of a crashed commit or compaction."""
        from eventql_tpu_torch.db.tablet_index import INDEX_SUFFIX

        keep = set(live) | {s + INDEX_SUFFIX for s in live}
        for f in os.listdir(self.dir):
            stray = (
                f.endswith(".tmp")
                or (
                    f.startswith("segment-")
                    and (f.endswith(".cst") or f.endswith(INDEX_SUFFIX))
                    and f not in keep
                )
            )
            if stray:
                _trash_file(self.dir, f)

    def _next_segment_name(self) -> str:
        """A name no live OR orphaned file holds (crash remains are
        swept at open, but a same-process retry must not collide)."""
        seq = 0
        for f in self._segments:
            try:
                seq = max(seq, int(f.split("-")[1].split(".")[0]) + 1)
            except (IndexError, ValueError):
                pass
        while True:
            name = f"segment-{seq:06d}.cst"
            if not os.path.exists(os.path.join(self.dir, name)):
                return name
            seq += 1

    @staticmethod
    def _crash_point(name: str):
        """Deterministic fault injection for the crash-recovery test
        tier: EVENTQL_TPU_CRASH_POINT=<name> hard-kills the process at
        this point (os._exit — no cleanup, like kill -9)."""
        if os.environ.get("EVENTQL_TPU_CRASH_POINT") == name:
            os._exit(137)

    # -- writes ---------------------------------------------------------
    def insert_row(self, row: Dict[str, SValue], obj=None, version=None):
        with self._write_lock:
            out = super().insert_row(row, obj=obj, version=version)
            if self.arena_rows() >= self.arena_flush_rows:
                self.commit()
            return out

    def insert_batch(self, rel, versions=None, record_ids=None):
        with self._write_lock:
            out = super().insert_batch(
                rel, versions=versions, record_ids=record_ids
            )
            if self.arena_rows() >= self.arena_flush_rows:
                self.commit()
            return out

    def commit(self):
        """Flush the arena to an immutable segment
        (reference: LSMPartitionWriter::commit, partition_writer.cc:
        269-348 — arena → cstable, then arena cleared)."""
        with self._write_lock:
            self._commit_locked()

    def _commit_locked(self):
        if not self.arena_rows():
            return
        seg_name = self._next_segment_name()
        tmp = os.path.join(self.dir, seg_name + ".tmp")
        self._crash_point("commit_pre_segment")
        if self.has_repeated:
            # Dremel-shredded v0.2 segment: every leaf (flat + repeated)
            # persists as level/value streams
            from eventql_tpu_torch.columnar.shredder import shred_records

            _write_nested_segment(
                tmp, shred_records(self.column_defs, self.objs), len(self.objs)
            )
        else:
            rel = MemoryTable.to_relation(self)
            write_cstable(tmp, rel)
        self._crash_point("commit_pre_replace")
        os.replace(tmp, os.path.join(self.dir, seg_name))
        self._crash_point("commit_post_segment")
        # sibling pk→version index: stale-record checks on later
        # inserts resolve against flushed segments without reading them
        # (reference: LSMTableIndex written at commit,
        # partition_writer.cc:269-348 + tablet_index.cc). Ordered
        # BEFORE the manifest commit: a manifest-live segment always
        # has its complete .idx sidecar.
        if self.primary_key and self._arena_index:
            from eventql_tpu_torch.db.tablet_index import (
                index_path_for,
                write_index,
            )

            write_index(
                index_path_for(os.path.join(self.dir, seg_name)),
                self._arena_index,
            )
        self._crash_point("commit_post_index")
        # durability point: the manifest rename makes the segment live
        self._write_manifest_file(self._segments + [seg_name])
        self._crash_point("commit_post_manifest")
        self._arena_index = {}
        self._segments.append(seg_name)
        self.rows = []
        self.objs = []
        self._batches = []
        self._relation_cache = None
        self._reader_cache = None

    def truncate(self):
        """Unload: clear the arena and trash every segment (files move
        to .trash for the GC sweep, like dereferenced segments)."""
        super().truncate()
        self._write_manifest_file([])  # durability point first
        for seg in self._segments:
            self._drop_segment_index(seg)
            _trash_file(self.dir, seg)
        self._segments = []
        self._segment_readers = {}

    # -- pk → version indexes -------------------------------------------
    def _drop_segment_index(self, seg: str):
        from eventql_tpu_torch.db.tablet_index import (
            INDEX_SUFFIX,
            global_index_cache,
            index_path_for,
        )

        path = index_path_for(os.path.join(self.dir, seg))
        global_index_cache().invalidate(path)
        if os.path.exists(path):
            _trash_file(self.dir, seg + INDEX_SUFFIX)

    def _segment_index(self, seg: str):
        from eventql_tpu_torch.db.tablet_index import (
            global_index_cache,
            index_path_for,
        )

        return global_index_cache().lookup(
            index_path_for(os.path.join(self.dir, seg))
        )

    def _head_versions(self, rec_ids):
        """Arena versions plus every segment index (reference:
        partition_writer.cc:113-165 walks lsm_tables newest→oldest
        through the index cache)."""
        head = super()._head_versions(rec_ids)
        for seg in reversed(self._segments):
            idx = self._segment_index(seg)
            if idx is not None:
                head = idx.lookup_max(rec_ids, head)
        return head

    def _merged_index_map(self):
        """Union of all segment indexes (max version per id) — the new
        index for a compacted segment."""
        merged = {}
        for seg in self._segments:
            idx = self._segment_index(seg)
            if idx is None:
                continue
            for i in range(len(idx.ids)):
                rid = bytes(idx.ids[i])
                v = int(idx.versions[i])
                if v > merged.get(rid, 0):
                    merged[rid] = v
        return merged

    def compact(self):
        """Fold all segments into one major segment with upsert
        resolution applied (reference: LSMPartitionWriter::compact +
        SimpleCompactionStrategy, db/compaction_strategy.h:58-77).
        Serialized against concurrent ingest by the per-table write
        lock (reference: the commit/compact mutexes,
        partition_writer.cc:270,361)."""
        with self._write_lock:
            self._compact_locked()

    def _compact_locked(self):
        self.commit()
        if self.has_repeated:
            return self._compact_nested()
        if not self._segments:
            return
        rel = self.to_relation()
        merged_idx = self._merged_index_map() if self.primary_key else {}
        # crash-safe order: build the major segment under a FRESH name,
        # flip the manifest (the atomic durability point), only then
        # retire the old files — a kill at any point leaves either the
        # old segment set or the new one, never neither (the pre-r4
        # code trashed the minors before writing the major: a crash in
        # between lost the table)
        old = list(self._segments)
        new_segs = []
        if rel.num_rows:
            seg_name = self._next_segment_name()
            tmp = os.path.join(self.dir, seg_name + ".tmp")
            write_cstable(tmp, rel)
            os.replace(tmp, os.path.join(self.dir, seg_name))
            if merged_idx:
                from eventql_tpu_torch.db.tablet_index import (
                    index_path_for,
                    write_index,
                )

                write_index(
                    index_path_for(os.path.join(self.dir, seg_name)),
                    merged_idx,
                )
            new_segs = [seg_name]
        self._crash_point("compact_pre_manifest")
        self._write_manifest_file(new_segs)
        self._crash_point("compact_post_manifest")
        for seg in old:
            self._drop_segment_index(seg)
            _trash_file(self.dir, seg)
        self._segments = new_segs
        self._relation_cache = None

    # -- reads ----------------------------------------------------------
    def to_relation(self) -> Relation:
        """Merged view: arena + segments newest→oldest with primary-key
        upsert (newest wins), like the reference's partition cursor
        visibility rules."""
        if self._relation_cache is not None:
            return self._relation_cache

        parts: List[Relation] = []
        if self.arena_rows():
            parts.append(MemoryTable.to_relation(self))
        for seg in reversed(self._segments):
            parts.append(self._read_segment(seg))

        if not parts:
            rel = MemoryTable.to_relation(self)  # empty, correct schema
            self._relation_cache = rel
            return rel

        if self.primary_key:
            merged = self._merge_upsert(parts)
        else:
            merged = _concat_relations(list(reversed(parts)))
        self._relation_cache = merged
        return merged

    def stream_chunks(self, chunk_rows: int):
        """Segment-at-a-time streaming source: yields the exact row
        stream of to_relation() while holding at most ONE segment's
        columns in memory (plus an O(distinct keys) seen-set for
        primary-key visibility) — the bounded-memory cursor the
        reference gets from pulling 1024-row batches through
        LSMPartitionReader (sql/result_cursor.h:35-75,
        transport/native/ops/query.cc:136-230).

        With a primary key, visibility needs newer parts' keys before
        older parts emit, so a first pass reads ONLY the pk columns of
        each part (columnar segment layout makes that cheap) and builds
        keep masks newest-first; the emission pass then walks parts
        oldest-first, gathers the kept rows, and yields chunk_rows-row
        slices."""
        if (
            self._relation_cache is not None
            or self.has_repeated
            or not self._segments
        ):
            # merged view already in RAM / nested path / arena-only:
            # the memory-table slicer is already optimal
            yield from MemoryTable.stream_chunks(self, chunk_rows)
            return

        # Snapshot the part set WITH pinned file descriptors, under the
        # write lock: a concurrent compaction can retire segment files
        # mid-stream (moved to .trash, then unlinked by the GC sweep),
        # but POSIX keeps open descriptors readable, so the stream
        # serves exactly the snapshot it started from — the role the
        # reference's FileTracker references play (db/file_tracker.cc).
        # The lock is held only for the snapshot + arena copy, not the
        # stream's lifetime.
        with self._write_lock:
            segs = list(self._segments)
            fds: Dict[str, int] = {}
            try:
                for s in segs:
                    fds[s] = os.open(os.path.join(self.dir, s), os.O_RDONLY)
            except OSError:
                for fd in fds.values():
                    os.close(fd)
                raise
            # parts newest-first: arena (if any rows), then segments
            # newest→oldest; None stands for the arena part
            part_ids: List[Optional[str]] = []
            arena_rel = None
            if self.arena_rows():
                part_ids.append(None)
                # compute the arena view without poisoning
                # to_relation's merged-view cache
                saved = self._relation_cache
                arena_rel = MemoryTable.to_relation(self)
                self._relation_cache = saved
            part_ids += list(reversed(segs))

        try:
            masks: Optional[List[np.ndarray]] = None
            if self.primary_key:
                pk_parts = []
                for pid in part_ids:
                    if pid is None:
                        pk_cols = [
                            arena_rel.columns[arena_rel.names.index(k)]
                            for k in self.primary_key
                        ]
                        pk_parts.append((pk_cols, arena_rel.num_rows))
                    else:
                        pk_parts.append(
                            self._segment_pk_columns(pid, fd=fds[pid])
                        )
                masks = self._upsert_keep_masks(pk_parts)

            # emission: oldest part first (to_relation's output order)
            for rev_i in range(len(part_ids) - 1, -1, -1):
                pid = part_ids[rev_i]
                rel = (
                    arena_rel
                    if pid is None
                    else self._read_segment(pid, fd=fds[pid])
                )
                if masks is not None:
                    keep = masks[rev_i]
                    if not keep.all():
                        rel = rel.gather(np.nonzero(keep)[0])
                yield from rel.iter_chunks(chunk_rows)
        finally:
            for fd in fds.values():
                os.close(fd)

    def _segment_pk_columns(self, seg: str, fd: int = None):
        """Read ONLY the primary-key columns of a segment (pk-visibility
        pre-pass for stream_chunks); schema-aligned like _read_segment."""
        reader = CSTableReader(os.path.join(self.dir, seg), fd=fd)
        n = reader.num_rows
        from eventql_tpu_torch.exec.relation import dtype_for

        cols = []
        for k in self.primary_key:
            if reader.column_config(k) is not None:
                cols.append(reader.flat_column(k))
            else:
                ctype = next(t for c, t, _r in self.columns if c == k)
                if ctype == SType.STRING:
                    cols.append(
                        Column(
                            SType.STRING,
                            np.zeros(n, np.int32),
                            np.zeros(n, bool),
                            np.array([b""], dtype=object),
                        )
                    )
                else:
                    cols.append(
                        Column(
                            ctype,
                            np.zeros(n, dtype=dtype_for(ctype)),
                            np.zeros(n, bool),
                        )
                    )
        return cols, n

    def _compact_nested(self):
        """Merge all nested segments through the composite Dremel reader
        (upsert-resolved) into one major segment."""
        reader = self.get_reader()
        if reader is None:
            return
        from eventql_tpu_torch.columnar.shredder import leaf_metas

        streams = {}
        for m in leaf_metas(self.column_defs):
            dec = reader.decode_column(m.path)
            streams[m.path] = (dec.rlvls, dec.dlvls, dec.values, m)
        merged_idx = self._merged_index_map() if self.primary_key else {}
        # same write-then-retire order as the flat compaction: the
        # manifest flip is the durability point
        old = list(self._segments)
        new_segs = []
        if reader.num_rows:
            seg_name = self._next_segment_name()
            tmp = os.path.join(self.dir, seg_name + ".tmp")
            _write_nested_segment(tmp, streams, reader.num_rows)
            os.replace(tmp, os.path.join(self.dir, seg_name))
            if merged_idx:
                from eventql_tpu_torch.db.tablet_index import (
                    index_path_for,
                    write_index,
                )

                write_index(
                    index_path_for(os.path.join(self.dir, seg_name)),
                    merged_idx,
                )
            new_segs = [seg_name]
        self._crash_point("compact_pre_manifest")
        self._write_manifest_file(new_segs)
        self._crash_point("compact_post_manifest")
        for seg in old:
            self._drop_segment_index(seg)
            _trash_file(self.dir, seg)
            self._segment_readers.pop(seg, None)
        self._segments = new_segs
        self._relation_cache = None
        self._reader_cache = None

    def _segment_reader(self, seg: str) -> CSTableReader:
        if seg not in self._segment_readers:
            self._segment_readers[seg] = CSTableReader(
                os.path.join(self.dir, seg)
            )
        return self._segment_readers[seg]

    def get_reader(self):
        """Merged Dremel view over arena + segments with newest-wins
        primary-key dedup (nested analog of to_relation)."""
        if not self.has_repeated or not self.column_defs:
            return None
        if self._reader_cache is not None:
            return self._reader_cache
        from eventql_tpu_torch.columnar.shredder import (
            CompositeNestedReader,
            ShreddedTableReader,
        )

        # newest first: arena, then segments newest→oldest
        sources_newest = []
        if self.objs:
            arena = ShreddedTableReader(self.column_defs, self.objs)
            sources_newest.append((arena, self._arena_pks()))
        for seg in reversed(self._segments):
            r = self._segment_reader(seg)
            sources_newest.append((r, self._segment_pks(r)))

        seen = set()
        with_keep = []
        for reader, pks in sources_newest:
            if pks is None:  # no primary key: keep everything
                keep = np.ones(reader.num_rows, dtype=bool)
            else:
                # reverse scan: within a source, later rows are newer
                # (same argument as _merge_upsert)
                keep = np.zeros(len(pks), dtype=bool)
                for i in range(len(pks) - 1, -1, -1):
                    if pks[i] not in seen:
                        seen.add(pks[i])
                        keep[i] = True
            with_keep.append((reader, keep))

        self._reader_cache = CompositeNestedReader(
            self.column_defs, list(reversed(with_keep))
        )
        return self._reader_cache

    def _arena_pks(self):
        if not self.primary_key:
            return None
        out = []
        for rel in self._batches:
            pk_cols = [
                rel.columns[rel.names.index(k)] for k in self.primary_key
            ]
            for i in range(rel.num_rows):
                out.append(
                    tuple(
                        c.value_at(i).payload() if c.valid[i] else None
                        for c in pk_cols
                    )
                )
        for row in self.rows:
            out.append(
                tuple(
                    row[k].payload() if k in row and not row[k].is_null else None
                    for k in self.primary_key
                )
            )
        return out

    def _segment_pks(self, reader):
        if not self.primary_key:
            return None
        cols = [reader.flat_column(k) for k in self.primary_key]
        out = []
        for i in range(reader.num_rows):
            out.append(
                tuple(
                    c.value_at(i).payload() if c.valid[i] else None
                    for c in cols
                )
            )
        return out

    def _read_segment(self, seg: str, fd: int = None) -> Relation:
        reader = CSTableReader(os.path.join(self.dir, seg), fd=fd)
        rel = reader.to_relation(flat_only=True)
        # align to current schema (columns added later are NULL)
        cols, names = [], []
        by_name = dict(zip(rel.names, rel.columns))
        n = rel.num_rows
        from eventql_tpu_torch.exec.relation import dtype_for

        for cname, ctype, rep in self.columns:
            if rep:
                continue  # repeated columns only exist on the nested path
            names.append(cname)
            if cname in by_name:
                cols.append(by_name[cname])
            elif ctype == SType.STRING:
                cols.append(
                    Column(
                        SType.STRING,
                        np.zeros(n, np.int32),
                        np.zeros(n, bool),
                        np.array([b""], dtype=object),
                    )
                )
            else:
                cols.append(
                    Column(ctype, np.zeros(n, dtype=dtype_for(ctype)), np.zeros(n, bool))
                )
        return Relation(names, cols, n)

    @staticmethod
    def _upsert_keep_masks(pk_parts_newest_first) -> List[np.ndarray]:
        """Newest-first upsert visibility (the reference's seen-id
        filter): one bool mask per part marking the rows whose primary
        key was not seen in any newer part nor in a later row of the
        same part. Within a part, LATER rows are newer (append-order
        arenas flush in insertion order), so each part scans in
        reverse — a same-segment upsert keeps the newest write,
        matching the reference where the arena replaces records in
        place before the flush. Takes (pk_columns, num_rows) pairs so
        callers can feed pk-only column reads (streaming pre-pass)."""
        seen = set()
        masks: List[np.ndarray] = []
        for pk_cols, nrows in pk_parts_newest_first:
            keep = np.zeros(nrows, dtype=bool)
            for r in range(nrows - 1, -1, -1):
                key = tuple(c.value_at(r).payload() for c in pk_cols)
                if key in seen:
                    continue
                seen.add(key)
                keep[r] = True
            masks.append(keep)
        return masks

    def _merge_upsert(self, parts_newest_first: List[Relation]) -> Relation:
        """Newest-first scan keeping one row per primary key (see
        _upsert_keep_masks for the visibility rule)."""
        pk_idx = [
            [i for i, c in enumerate(self.columns) if c[0] == k][0]
            for k in self.primary_key
        ]
        masks = self._upsert_keep_masks(
            [
                ([rel.columns[i] for i in pk_idx], rel.num_rows)
                for rel in parts_newest_first
            ]
        )
        keep_parts = [
            rel.gather(np.nonzero(keep)[0])
            for rel, keep in zip(parts_newest_first, masks)
        ]
        # output order: oldest part first, insertion order within
        return _concat_relations(list(reversed(keep_parts)))


def _concat_relations(parts: List[Relation]) -> Relation:
    from eventql_tpu_torch.parallel.partitioned import _concat_columns

    names = parts[0].names
    cols = [
        _concat_columns([p.columns[i] for p in parts])
        for i in range(len(names))
    ]
    return Relation(list(names), cols, sum(p.num_rows for p in parts))


def _trash_file(table_dir: str, name: str):
    """Move a dereferenced segment into the trash dir instead of
    unlinking it (reference: FileTracker dereference + trash-dir GC,
    db/garbage_collector.cc / db/file_tracker.cc) — readers holding the
    old file keep working until the GC sweep."""
    trash = os.path.join(table_dir, ".trash")
    os.makedirs(trash, exist_ok=True)
    src = os.path.join(table_dir, name)
    try:
        os.replace(src, os.path.join(trash, name))
    except OSError:
        pass


def collect_garbage(datadir: str, min_age_seconds: float = 0.0) -> int:
    """Delete trashed segment files older than min_age_seconds; returns
    the number removed (reference: GarbageCollector::runOnce)."""
    import time as _time

    removed = 0
    now = _time.time()
    for root, dirs, _files in os.walk(datadir):
        if ".trash" not in dirs:
            continue
        trash = os.path.join(root, ".trash")
        for f in os.listdir(trash):
            p = os.path.join(trash, f)
            try:
                if now - os.path.getmtime(p) >= min_age_seconds:
                    os.unlink(p)
                    removed += 1
            except OSError:
                pass
    return removed


def _write_nested_segment(path: str, streams, num_rows: int):
    """streams: {path: (rlvls, dlvls, values, meta)} from the shredder
    (or re-decoded from a composite reader)."""
    from eventql_tpu_torch.columnar.cstable_v2 import CSTableV2Writer, _flat_encoding

    w = CSTableV2Writer(path)
    for cpath, (rlvls, dlvls, values, m) in streams.items():
        enc = _flat_encoding(m.stype)
        w.add_column(cpath, enc, m.rlevel_max, m.dlevel_max)
        vals = values
        if m.stype == SType.STRING:
            vals = [bytes(v) for v in values]
        elif not isinstance(values, np.ndarray):
            vals = np.asarray(values, dtype=np.uint64)
        elif m.stype != SType.FLOAT64:
            vals = values.astype(np.uint64, copy=False)
        w.set_column_values(cpath, rlvls, dlvls, vals)
    w.commit(num_rows)


class DurableTableService(TableService):
    """TableService persisting to an on-disk datadir (the standalone
    evqld storage mode)."""

    # compact once a table accumulates this many segments (the analog of
    # SimpleCompactionStrategy's small-table threshold,
    # db/compaction_strategy.cc:40-76)
    COMPACT_SEGMENT_THRESHOLD = 8

    def __init__(self, datadir: str, arena_flush_rows: int = DEFAULT_ARENA_FLUSH_ROWS):
        super().__init__()
        self.datadir = datadir
        self.arena_flush_rows = arena_flush_rows
        self._compaction_thread = None
        self._compaction_stop = threading.Event()
        os.makedirs(datadir, exist_ok=True)
        for name in sorted(os.listdir(datadir)):
            if os.path.exists(os.path.join(datadir, name, "table.json")):
                self.tables[name] = LSMTable.open(datadir, name)

    # -- background compaction (reference: db/compaction_worker.cc —
    # a worker thread drains a queue of partitions needing compaction;
    # here a periodic sweep over tables past the segment threshold) ----
    def start_compaction_worker(self, interval: float = 5.0):
        from eventql_tpu_torch.utils.stats import evqld_stats

        def run():
            while not self._compaction_stop.wait(interval):
                pending = [
                    t
                    for t in list(self.tables.values())
                    if len(t._segments) >= self.COMPACT_SEGMENT_THRESHOLD
                ]
                evqld_stats().compaction_queue_length.set(len(pending))
                for t in pending:
                    t.compact()
                evqld_stats().compaction_queue_length.set(0)
                collect_garbage(self.datadir, min_age_seconds=interval)

        self._compaction_thread = threading.Thread(target=run, daemon=True)
        self._compaction_thread.start()

    def stop_compaction_worker(self):
        if self._compaction_thread:
            self._compaction_stop.set()
            self._compaction_thread.join(timeout=10)
            self._compaction_thread = None

    def create_table(self, node) -> None:
        if node.table_name in self.tables:
            raise RuntimeError_(f"table already exists: '{node.table_name}'")
        columns = _flatten_columns(node.columns)
        if node.primary_key:
            by_name = {c[0]: c[1] for c in columns}
            first = node.primary_key[0]
            if first not in by_name:
                raise RuntimeError_(f"column not found: '{first}'")
            if by_name[first] not in (
                SType.TIMESTAMP64,
                SType.STRING,
                SType.UINT64,
            ):
                raise RuntimeError_(
                    "first column in the PRIMARY KEY must be of type "
                    "DATETIME, STRING or UINT64"
                )
        self.tables[node.table_name] = LSMTable(
            self.datadir,
            node.table_name,
            columns,
            list(node.primary_key),
            node.partition_key,
            node.properties,
            self.arena_flush_rows,
            column_defs=list(node.columns),
        )
        self.bump_schema_version()

    def drop_table(self, table_name: str) -> None:
        table = self.tables.get(table_name)
        if table is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        import shutil

        shutil.rmtree(table.dir, ignore_errors=True)
        del self.tables[table_name]
        self.bump_schema_version()

    def commit_all(self):
        for t in self.tables.values():
            if isinstance(t, LSMTable):
                t.commit()
