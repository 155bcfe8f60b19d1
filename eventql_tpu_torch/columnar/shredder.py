"""Record shredding + materialization (the Dremel write path).

Re-implements the reference's RecordShredder/RecordMaterializer pair
(reference: io/cstable/RecordShredder.cc:37-223 — walks a record
against the schema emitting (rlevel, dlevel, value) per leaf column;
io/cstable/RecordMaterializer.cc — the inverse). Works on parsed JSON
objects against the DDL column tree (plan/nodes.py ColumnDefinition):

  rlevel_max(path) = number of REPEATED fields on the path
  dlevel_max(path) = number of optional-or-repeated fields on the path
  (all fields are optional unless NOT NULL; NOT NULL fields don't get
   a definition level, matching MessageSchema's level assignment)

The shredded streams feed CSTableV2Writer directly and also back the
in-memory nested scan path (ShreddedTableReader plugs into the same
Dremel assembly state machine as cstable files).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.columnar.cstable import ColumnConfig, DecodedColumn
from eventql_tpu_torch.plan.nodes import ColumnDefinition


@dataclass
class _LeafMeta:
    path: str
    stype: SType
    rlevel_max: int
    dlevel_max: int
    repeated: bool


def leaf_metas(
    defs: List[ColumnDefinition], prefix: str = "", r: int = 0, d: int = 0
) -> List[_LeafMeta]:
    from eventql_tpu_torch.db.table_service import stype_from_name

    out = []
    for cd in defs:
        path = prefix + cd.column_name
        rmax = r + (1 if cd.repeated else 0)
        dmax = d + (0 if cd.not_null and not cd.repeated else 1)
        if cd.subcolumns is not None:
            out.extend(leaf_metas(cd.subcolumns, path + ".", rmax, dmax))
        else:
            out.append(
                _LeafMeta(
                    path, stype_from_name(cd.column_type), rmax, dmax, cd.repeated
                )
            )
    return out


class _Sink:
    def __init__(self, meta: _LeafMeta):
        self.meta = meta
        self.rlvls: List[int] = []
        self.dlvls: List[int] = []
        self.values: List = []

    def emit(self, r: int, d: int, value=None):
        if value is None and d >= self.meta.dlevel_max and self.meta.dlevel_max > 0:
            raise RuntimeError_(
                f"missing value for NOT NULL field: '{self.meta.path}'"
            )
        self.rlvls.append(r)
        self.dlvls.append(d)
        if d == self.meta.dlevel_max and value is not None:
            self.values.append(value)


def _coerce_leaf(v, stype: SType):
    from eventql_tpu_torch.db.table_service import _coerce, _from_json

    sv = _coerce(_from_json(v), stype)
    if sv.is_null:
        return None
    p = sv.payload()
    return p


def shred_records(defs: List[ColumnDefinition], records: List[dict]):
    """Shred parsed JSON records into per-leaf level/value streams.
    Returns {path: (rlvls u32, dlvls u32, values, meta)}."""
    metas = leaf_metas(defs)
    sinks = {m.path: _Sink(m) for m in metas}

    def emit_missing(cd: ColumnDefinition, prefix: str, r: int, d: int):
        """Record that a field (and everything beneath) is absent."""
        path = prefix + cd.column_name
        if cd.subcolumns is not None:
            for sc in cd.subcolumns:
                emit_missing(sc, path + ".", r, d)
        else:
            sinks[path].emit(r, d)

    def visit(cd: ColumnDefinition, value, prefix: str, r: int, d: int, r_here: int):
        """r = repetition level to emit for the FIRST value; r_here = the
        field's own rlevel_max (emitted for siblings in a repeated set)
        (RecordShredder.cc:120-213)."""
        path = prefix + cd.column_name
        if cd.repeated:
            vals = value if isinstance(value, list) else [value]
            vals = [v for v in vals]
            if not vals:
                emit_missing(cd, prefix, r, d)
                return
            for i, v in enumerate(vals):
                rr = r if i == 0 else r_here
                if cd.subcolumns is not None:
                    if not isinstance(v, dict):
                        raise RuntimeError_(
                            f"expected object for record column '{path}'"
                        )
                    for sc in cd.subcolumns:
                        if sc.column_name in v and v[sc.column_name] is not None:
                            visit(
                                sc, v[sc.column_name], path + ".", rr, d + 1,
                                r_here + (1 if sc.repeated else 0),
                            )
                        else:
                            emit_missing(sc, path + ".", rr, d + 1)
                else:
                    meta = sinks[path].meta
                    p = _coerce_leaf(v, meta.stype)
                    if p is None:
                        sinks[path].emit(rr, d)
                    else:
                        sinks[path].emit(rr, meta.dlevel_max, p)
        else:
            if cd.subcolumns is not None:
                if not isinstance(value, dict):
                    raise RuntimeError_(
                        f"expected object for record column '{path}'"
                    )
                dd = d if cd.not_null else d + 1
                for sc in cd.subcolumns:
                    if sc.column_name in value and value[sc.column_name] is not None:
                        visit(
                            sc, value[sc.column_name], path + ".", r, dd,
                            r_here + (1 if sc.repeated else 0),
                        )
                    else:
                        emit_missing(sc, path + ".", r, dd)
            else:
                meta = sinks[path].meta
                p = _coerce_leaf(value, meta.stype)
                if p is None:
                    sinks[path].emit(r, d)
                else:
                    sinks[path].emit(r, meta.dlevel_max, p)

    for rec in records:
        for cd in defs:
            if cd.column_name in rec and rec[cd.column_name] is not None:
                visit(
                    cd, rec[cd.column_name], "", 0, 0,
                    1 if cd.repeated else 0,
                )
            else:
                emit_missing(cd, "", 0, 0)

    out = {}
    for m in metas:
        s = sinks[m.path]
        out[m.path] = (
            np.asarray(s.rlvls, dtype=np.uint32),
            np.asarray(s.dlvls, dtype=np.uint32),
            s.values,
            m,
        )
    return out


# -- nested-scan-compatible reader over shredded streams --------------------

_STYPE_ENC = {  # encoding tags only matter for file output
    SType.STRING: 100,
    SType.BOOL: 1,
    SType.FLOAT64: 14,
}


class ShreddedTableReader:
    """Exposes shredded in-memory records through the same API as
    CSTableReader (has_column/decode_column/column_config/num_rows), so
    the Dremel assembly scan works over memory tables with repeated
    fields exactly like over cstable files."""

    def __init__(self, defs: List[ColumnDefinition], records: List[dict]):
        self.num_rows = len(records)
        self._streams = shred_records(defs, records)
        self._configs = {}
        for path, (_r, _d, _v, m) in self._streams.items():
            self._configs[path] = ColumnConfig(
                path,
                _STYPE_ENC.get(m.stype, 13),
                m.stype,
                m.rlevel_max,
                m.dlevel_max,
                0,
                0,
            )

    def has_column(self, name: str) -> bool:
        return name in self._streams

    def column_config(self, name: str) -> Optional[ColumnConfig]:
        return self._configs.get(name)

    def decode_column(self, name: str) -> DecodedColumn:
        rlvls, dlvls, values, m = self._streams[name]
        vals = values
        if m.stype == SType.STRING:
            vals = [v if isinstance(v, bytes) else str(v).encode() for v in values]
        elif values and not isinstance(values, np.ndarray):
            vals = np.asarray(values)
        elif not values:
            vals = np.zeros(0, dtype=np.uint64)
        return DecodedColumn(self._configs[name], rlvls, dlvls, vals)


def materialize_records(reader, paths: List[str]) -> List[dict]:
    """Re-assemble records from level streams (RecordMaterializer.cc) —
    one (possibly nested-list) dict per record, used for JSON export."""
    out = [dict() for _ in range(reader.num_rows)]
    for path in paths:
        dec = reader.decode_column(path)
        cfg = dec.config
        rec_idx = -1
        vpos = 0
        for i in range(len(dec.rlvls)):
            r = int(dec.rlvls[i])
            d = int(dec.dlvls[i])
            if r == 0:
                rec_idx += 1
            if d < cfg.dlevel_max:
                continue
            v = dec.values[vpos]
            vpos += 1
            if isinstance(v, bytes):
                v = v.decode("utf-8", errors="surrogateescape")
            elif isinstance(v, np.generic):
                v = v.item()
            tgt = out[rec_idx]
            parts = path.split(".")
            for p in parts[:-1]:
                tgt = tgt.setdefault(p, {})
            if cfg.rlevel_max > 0:
                tgt.setdefault(parts[-1], []).append(v)
            else:
                tgt[parts[-1]] = v
    return out


# -- record-level stream surgery (for LSM upsert merges) --------------------


def record_spans(rlvls: np.ndarray, dlvls: np.ndarray, dlevel_max: int):
    """Per-record (level-slot span, value span) boundaries: records
    begin at rlvl == 0 slots."""
    n = len(rlvls)
    starts = np.nonzero(rlvls == 0)[0]
    ends = np.append(starts[1:], n)
    vcounts = np.zeros(len(starts), dtype=np.int64)
    defined = (dlvls == dlevel_max).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(defined)])
    vstarts = csum[starts]
    vends = csum[ends]
    return starts, ends, vstarts, vends


def filter_decoded(dec: DecodedColumn, keep: np.ndarray) -> DecodedColumn:
    """Keep only the records selected by the boolean mask (newest-wins
    primary-key dedup cuts superseded records out of level streams)."""
    if keep.all():
        return dec
    starts, ends, vstarts, vends = record_spans(
        dec.rlvls, dec.dlvls, dec.config.dlevel_max
    )
    sel = np.nonzero(keep)[0]
    slot_idx = np.concatenate(
        [np.arange(starts[i], ends[i]) for i in sel]
    ) if len(sel) else np.zeros(0, np.int64)
    rlvls = dec.rlvls[slot_idx]
    dlvls = dec.dlvls[slot_idx]
    if isinstance(dec.values, list):
        values = []
        for i in sel:
            values.extend(dec.values[vstarts[i] : vends[i]])
    else:
        vidx = np.concatenate(
            [np.arange(vstarts[i], vends[i]) for i in sel]
        ) if len(sel) else np.zeros(0, np.int64)
        values = np.asarray(dec.values)[vidx]
    return DecodedColumn(dec.config, rlvls, dlvls, values)


def concat_decoded(cfg: ColumnConfig, decs: List[DecodedColumn]) -> DecodedColumn:
    rlvls = np.concatenate([d.rlvls for d in decs]) if decs else np.zeros(0, np.uint32)
    dlvls = np.concatenate([d.dlvls for d in decs]) if decs else np.zeros(0, np.uint32)
    if any(isinstance(d.values, list) for d in decs):
        values = []
        for d in decs:
            values.extend(list(d.values))
    else:
        values = (
            np.concatenate([np.asarray(d.values) for d in decs])
            if decs
            else np.zeros(0, np.uint64)
        )
    return DecodedColumn(cfg, rlvls, dlvls, values)


def _missing_records(cfg: ColumnConfig, n: int) -> DecodedColumn:
    """n records with the column entirely absent."""
    return DecodedColumn(
        cfg,
        np.zeros(n, np.uint32),
        np.zeros(n, np.uint32),
        [] if cfg.stype == SType.STRING else np.zeros(0, np.uint64),
    )


class CompositeNestedReader:
    """Merged Dremel view over several sources (LSM segments + arena),
    each with a per-record keep mask from the newest-wins primary-key
    dedup. Source order here = output record order (oldest first, like
    the flat merge in db/lsm.py)."""

    def __init__(self, defs: List[ColumnDefinition], sources):
        """sources: [(reader, keep_mask bool[nrecords])] oldest first."""
        self.defs = defs
        self.sources = sources
        self.num_rows = int(sum(k.sum() for _r, k in sources))
        self._configs = {}
        for m in leaf_metas(defs):
            self._configs[m.path] = ColumnConfig(
                m.path,
                _STYPE_ENC.get(m.stype, 13),
                m.stype,
                m.rlevel_max,
                m.dlevel_max,
                0,
                0,
            )
        self._cache = {}

    def has_column(self, name: str) -> bool:
        return name in self._configs

    def column_config(self, name: str):
        return self._configs.get(name)

    def decode_column(self, name: str) -> DecodedColumn:
        if name in self._cache:
            return self._cache[name]
        cfg = self._configs.get(name)
        if cfg is None:
            raise RuntimeError_(f"column(s) not found: '{name}'")
        parts = []
        for reader, keep in self.sources:
            nkeep = int(keep.sum())
            if nkeep == 0:
                continue
            if reader.has_column(name):
                dec = reader.decode_column(name)
                parts.append(
                    DecodedColumn(cfg, *_filtered_streams(dec, keep))
                )
            else:
                parts.append(_missing_records(cfg, nkeep))
        out = concat_decoded(cfg, parts)
        self._cache[name] = out
        return out


def _filtered_streams(dec: DecodedColumn, keep: np.ndarray):
    f = filter_decoded(dec, keep)
    return f.rlvls, f.dlvls, f.values
