"""cstable_tool — cstable file forensics CLI.

Mirrors the reference's `cstable_tool` binary
(reference: io/cstable/cstable_tool.cc:43-195):

  dump <file.cst>                    structural dump: record count, column
                                     index (+ v0.2 page index), and every
                                     (rlevel, dlevel, value) triple per column
  dump-json <file.cst> <schema.json> materialize records against a
                                     MessageSchema-format JSON schema and
                                     print one JSON object per line
  index-lookup <table_dir> <sha1>    look up a primary-key SHA1 across an LSM
                                     table's rows and print the newest
                                     position holding it (the reference's
                                     LSMTableIndex maps pk-SHA1 → version,
                                     cstable_tool.cc:144-164; this engine
                                     resolves upserts by key equality at
                                     merge time, so the analog reports the
                                     winning row's location)
"""

from __future__ import annotations

import hashlib
import json
import sys
from typing import List

from eventql_tpu_torch.core.types import SType


def _schema_to_defs(schema: dict) -> List:
    """Reference MessageSchema JSON (util/protobuf/MessageSchema.cc:434-497:
    name + columns[{id,name,type,optional,repeated,schema?}]) → this
    engine's ColumnDefinition tree."""
    from eventql_tpu_torch.plan.nodes import ColumnDefinition

    type_map = {
        "object": "RECORD",
        "bool": "bool",
        "boolean": "bool",
        "uint32": "uint64",
        "uint64": "uint64",
        "string": "string",
        "double": "double",
        "datetime": "datetime",
    }
    defs = []
    for col in schema.get("columns", []):
        tname = type_map.get(str(col.get("type", "")).lower())
        if tname is None:
            raise SystemExit(f"error: unknown field type: {col.get('type')}")
        sub = None
        if tname == "RECORD":
            sub = _schema_to_defs(col.get("schema", {}))
        defs.append(
            ColumnDefinition(
                column_name=col["name"],
                column_type=tname,
                repeated=bool(col.get("repeated", False)),
                not_null=not bool(col.get("optional", True)),
                subcolumns=sub,
            )
        )
    return defs


def _value_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="surrogateescape")
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def cstable_dump(args: List[str], out) -> int:
    if len(args) < 1:
        print("usage: cstable_tool dump <file>", file=sys.stderr)
        return 1
    from eventql_tpu_torch.columnar.cstable import CSTableReader

    reader = CSTableReader(args[0])
    print("== GENERAL ==", file=out)
    print(f" >> number of records: {reader.num_rows}", file=out)

    print("\n\n== INDEX ==", file=out)
    col_ids = getattr(reader, "_col_ids", None)
    for c in reader.columns:
        cid = col_ids[c.name] if col_ids else 0
        print(f">>  column_id={cid}, column_name={c.name}", file=out)
    page_index = getattr(reader, "_page_index", None)
    if page_index:
        type_names = {0x1: "DATA", 0x2: "RLVL", 0x3: "DLVL"}
        for (etype, cid), pages in sorted(page_index.items()):
            for off, size in pages:
                print(
                    f">>  column_id={cid} type={type_names.get(etype, etype)}"
                    f" offset={off} size={size}",
                    file=out,
                )

    for c in reader.columns:
        cid = col_ids[c.name] if col_ids else 0
        print(f"\n\n== COLUMN DATA for {cid}/{c.name} ==", file=out)
        dec = reader.decode_column(c.name)
        vpos = 0
        rec = 0
        for j in range(len(dec.rlvls)):
            r = int(dec.rlvls[j])
            d = int(dec.dlvls[j])
            if j > 0 and r == 0:
                rec += 1
            if d == c.dlevel_max:
                data = _value_str(dec.values[vpos])
                vpos += 1
            else:
                data = ""
            print(
                f">>  idx={rec + 1}/{j + 1} rlvl={r} dlvl={d}"
                f" data=({len(data)}) '{data}'",
                file=out,
            )
    return 0


def cstable_dump_json(args: List[str], out) -> int:
    if len(args) < 2:
        print(
            "usage: cstable_tool dump-json <file.cst> <schema.json>",
            file=sys.stderr,
        )
        return 1
    from eventql_tpu_torch.columnar.cstable import CSTableReader
    from eventql_tpu_torch.columnar.shredder import leaf_metas, materialize_records

    with open(args[1]) as f:
        schema = json.load(f)
    defs = _schema_to_defs(schema)
    reader = CSTableReader(args[0])
    paths = [m.path for m in leaf_metas(defs) if reader.has_column(m.path)]
    for rec in materialize_records(reader, paths):
        print(json.dumps(rec), file=out)
    return 0


def cstable_index_lookup(args: List[str], out) -> int:
    if len(args) < 2:
        print(
            "usage: cstable_tool index-lookup <table_dir> <sha1>",
            file=sys.stderr,
        )
        return 1
    import os

    from eventql_tpu_torch.db.lsm import LSMTable
    from eventql_tpu_torch.db.shredded_record_list import _wire_str

    table_dir = args[0].rstrip("/")
    want = args[1].lower()
    base, name = os.path.split(table_dir)
    table = LSMTable.open(base, name)
    rel = table.to_relation()
    pk = table.primary_key or [n for n, _t, _r in table.columns]
    pk_idx = [rel.names.index(k) for k in pk]
    found = False
    for i in range(rel.num_rows):
        key = b"\x00".join(
            _wire_str(rel.columns[j].value_at(i).payload()) for j in pk_idx
        )
        digest = hashlib.sha1(key).hexdigest()
        if digest == want:
            print(f"INDEXENT: {digest} => {i}", file=out)
            found = True
    if not found:
        print(f"INDEXENT: {want} => 0", file=out)
    return 0


def main(argv=None, out=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = out or sys.stdout
    if not argv:
        print("usage: cstable_tool <cmd> ...", file=sys.stderr)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd == "dump":
        return cstable_dump(args, out)
    if cmd == "dump-json":
        return cstable_dump_json(args, out)
    if cmd == "index-lookup":
        return cstable_index_lookup(args, out)
    print(f"error: unknown command: {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
