"""Query results (reference: sql/result_list.h/.cc, result_cursor.h).

Row formatting is DEFERRED (round-5 serving-tail work): the engine
returns a ResultList holding the result Relation, and rows format to
strings only when a consumer touches them — `rows` materializes (and
caches) everything, `iter_rows(lo, hi)` formats just a window, which is
what the paging transports frame (the reference formats each row as it
encodes the result frame too: transport/native/ops/query.cc:136-230 via
sql_tostring). For the flagship GROUP BY this takes the O(groups)
string formatting off the query wall unless the client actually reads
those rows."""

from __future__ import annotations

from typing import List, Optional

from eventql_tpu_torch.exec.relation import Relation
from eventql_tpu_torch.utils import trace


class ResultList:
    # the query that made the result (its transaction's id), which the
    # query.emit span carries, and the list of a traced transaction
    query_id = None
    trace_sink = None

    def __init__(
        self,
        columns: List[str],
        rows: Optional[List[List[str]]] = None,
        relation: Optional[Relation] = None,
    ):
        self.columns = columns
        self._rows = rows
        self._rel = relation
        if rows is None and relation is None:
            self._rows = []

    @staticmethod
    def from_relation(result_columns: List[str], rel: Relation) -> "ResultList":
        return ResultList(list(result_columns), relation=rel)

    def _format_window(self, lo: int, hi: int) -> List[List[str]]:
        ncols = len(self.columns)
        cols = self._rel.columns[:ncols]
        if not cols:
            return [[] for _ in range(lo, hi)]
        # whole-column formatting (vectorized sql_tostring) of just the
        # window, then a zip-transpose into rows
        formatted = [c.slice_rows(lo, hi).format_all() for c in cols]
        return [list(r) for r in zip(*formatted)]

    @property
    def rows(self) -> List[List[str]]:
        if self._rows is None:
            with trace.stage("query.emit", self.query_id, self.trace_sink):
                self._rows = self._format_window(0, self._rel.num_rows)
        return self._rows

    def iter_rows(self, lo: int = 0, hi: Optional[int] = None):
        """Formatted rows [lo, hi) without materializing the rest.
        Already-materialized results serve slices from the cache."""
        n = self.num_rows
        hi = n if hi is None else min(hi, n)
        lo = min(lo, hi)
        if self._rows is not None:
            yield from self._rows[lo:hi]
            return
        yield from self._format_window(lo, hi)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        if self._rows is not None:
            return len(self._rows)
        return self._rel.num_rows

    def get_row(self, i: int) -> List[str]:
        if self._rows is not None:
            return self._rows[i]
        if i < 0:  # list semantics for the lazy path too
            i += self.num_rows
        if not 0 <= i < self.num_rows:
            raise IndexError("row index out of range")
        return self._format_window(i, i + 1)[0]

    def debug_csv(self, sep=";") -> str:
        out = [sep.join(self.columns)]
        for r in self.rows:
            out.append(sep.join(r))
        return "\n".join(out) + "\n"
