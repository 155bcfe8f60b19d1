"""The comparison that decides ``correct``: a query's rows, as the program
printed them, against the plain reference's groups.

The reference gives every group (Python str / int / float per column).
The comparison applies the query's ORDER BY and LIMIT as SQL defines
them: rows that tie on the order keys may come in any order, and under
LIMIT any of the rows tied at the boundary may be the ones returned.
Two numbers come out:

- ``mismatches``: string and integer cells that differ, floats that do
  not parse or are not finite, rows missing or extra, rows with an
  unknown or repeated key, rows out of order, and rows whose order key
  lies outside the reference's first LIMIT. Exact: its limit is 0.
- ``mean_gap_e6``: the largest gap between a printed float and the
  reference's float64, in units of 1e-6 (a float cell is printed with
  six decimals, so a sound answer reads at most about 0.5).
"""

import math


def format_rows(rows):
    """Print reference rows as the program prints its cells (the control
    stands in the program's place through this)."""
    return [[("%f" % v) if isinstance(v, float) else str(v) for v in row] for row in rows]


def ordered(reference, query):
    """The reference's groups as the query returns them: sorted by its ORDER
    BY (ties in the reference's order) and cut to its LIMIT."""
    rows = sorted(reference, key=lambda r: _order_key(r, query["order_by"]))
    return rows if query["limit"] is None else rows[: query["limit"]]


def _parse(text, like):
    if isinstance(like, str):
        return text
    if isinstance(like, float):
        return float(text)
    return int(text)


def _order_key(row, order):
    out = []
    for i, direction in order:
        v = row[i]
        if direction == "desc":
            v = tuple(-b for b in v.encode()) if isinstance(v, str) else -v
        out.append(v)
    return tuple(out)


def compare(rows, reference, query):
    """Return (mismatches, mean_gap_e6 or None) of the program's ``rows``
    (lists of str) against ``reference`` (tuples) for a traffic ``query``."""
    keys, order = query["group_by"], query["order_by"]
    expected = ordered(reference, query)
    mismatches = abs(len(rows) - len(expected))
    if not reference:
        return mismatches, None
    width = len(reference[0])
    by_key = {tuple(r[i] for i in keys): r for r in reference}
    gap, seen, matched = None, set(), []
    for row in rows:
        try:
            if len(row) != width:
                raise ValueError("row width")
            key = tuple(_parse(row[i], reference[0][i]) for i in keys)
        except ValueError:
            mismatches += 1
            continue
        ref = by_key.get(key)
        if ref is None or key in seen:
            mismatches += 1
            continue
        seen.add(key)
        matched.append(ref)
        for text, want in zip(row, ref):
            try:
                got = _parse(text, want)
            except ValueError:
                mismatches += 1
                continue
            if isinstance(want, float):
                if not math.isfinite(got):
                    mismatches += 1
                    continue
                d = abs(got - want) * 1e6
                gap = d if gap is None else max(gap, d)
            elif got != want:
                mismatches += 1
    if order:
        ranks = [_order_key(r, order) for r in matched]
        mismatches += sum(1 for a, b in zip(ranks, ranks[1:]) if b < a)
        left = {}
        for r in expected:
            k = _order_key(r, order)
            left[k] = left.get(k, 0) + 1
        for k in ranks:
            if left.get(k, 0) > 0:
                left[k] -= 1
            else:
                mismatches += 1
    return mismatches, gap
