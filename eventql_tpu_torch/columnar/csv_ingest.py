"""CSV table ingest (reference: sql/drivers/csv/CSVTableProvider.cc +
util/csv/CSVInputStream.cc).

Parity notes:
* every column is a nullable STRING (CSVTableProvider ctor)
* the parser is the reference's byte loop: a quote char toggles quoted
  mode and is dropped; separators/newlines end fields/rows only when
  unquoted; no escape-doubling (CSVInputStream.cc:59-99)
* a final row not terminated by the row separator is DROPPED (the
  reference's readNextRow returns false at EOF even when it collected
  data, and all callers stop there)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.exec.relation import Column, Relation


def parse_csv(
    data: bytes,
    column_separator: bytes = b",",
    row_separator: bytes = b"\n",
    quote_char: bytes = b'"',
) -> List[List[bytes]]:
    rows: List[List[bytes]] = []
    sep = column_separator[0]
    rowsep = row_separator[0]
    quote = quote_char[0]

    row: List[bytes] = []
    field = bytearray()
    quoted = False
    ended_clean = True
    for b in data:
        ended_clean = False
        if not quoted and b == sep:
            row.append(bytes(field))
            field = bytearray()
            continue
        if not quoted and b == rowsep:
            row.append(bytes(field))
            rows.append(row)
            row = []
            field = bytearray()
            ended_clean = True
            continue
        if b == quote:
            quoted = not quoted
            continue
        field.append(b)

    # mirror the reference: data after the last row separator is dropped
    return rows


def load_csv_table(
    path: str,
    column_separator: bytes = b",",
    row_separator: bytes = b"\n",
    quote_char: bytes = b'"',
) -> Relation:
    if isinstance(column_separator, str):
        column_separator = column_separator.encode()
    if isinstance(row_separator, str):
        row_separator = row_separator.encode()
    if isinstance(quote_char, str):
        quote_char = quote_char.encode()
    with open(path, "rb") as f:
        data = f.read()
    rows = parse_csv(data, column_separator, row_separator, quote_char)
    if not rows:
        raise RuntimeError_("can't read CSV headers")
    headers = [h.decode("utf-8", errors="surrogateescape") for h in rows[0]]
    body = rows[1:]

    columns = []
    for ci in range(len(headers)):
        vals: List[Optional[bytes]] = []
        for r in body:
            vals.append(r[ci] if ci < len(r) else b"")
        columns.append(Column.from_strings(vals))
    return Relation(headers, columns, len(body))
