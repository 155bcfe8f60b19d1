"""Query runtime: parse → plan → execute.

Mirrors the reference's Runtime/Transaction/QueryPlan composition
(reference: sql/runtime/runtime.cc:35-85, sql/query_plan.cc,
sql/transaction.h) in a single embeddable object, exactly like the
golden-file SQL test harness uses it (reference: test/sql_tests.cc).

A Runtime is bound to one torch device. The default is "cuda": GROUP BY
plans of the routable shape run on the card (exec/device_exec.py), and
constructing the Runtime without a card raises. device="cpu" runs the
same route through the kernels' plain PyTorch versions, which is what
the CPU test-suite does; device=None is the pure host engine. A
Transaction carries the device of the Runtime that made it; one made by
hand names its device, and a Runtime refuses a transaction of another.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from eventql_tpu_torch.core.errors import RuntimeError_, SQLError
from eventql_tpu_torch.core.types import SType, SValue
from eventql_tpu_torch.exec.operators import execute_node
from eventql_tpu_torch.exec.relation import Relation
from eventql_tpu_torch.exec.result import ResultList
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.builder import QueryPlanBuilder, TableProvider
from eventql_tpu_torch.plan.functions import DEFAULT_REGISTRY
from eventql_tpu_torch.plan.scalar_eval import evaluate_scalar
from eventql_tpu_torch.sql.parser import Parser
from eventql_tpu_torch.utils import trace as _trace


class TableInfo:
    def __init__(self, table_name: str, columns):
        self.table_name = table_name
        self.columns = columns  # List[(name, SType)]


class RelationTableProvider(TableProvider):
    """Serves queries from in-memory Relations (what the CSV / cstable
    ingest layers produce)."""

    def __init__(self):
        self._tables: Dict[str, Relation] = {}
        self._schema_version = 0

    def add_table(self, name: str, rel: Relation, stypes: Optional[List[SType]] = None):
        self._tables[name] = rel
        self._schema_version += 1

    def plan_cache_key(self):
        return self._schema_version

    def describe(self, table_name: str) -> Optional[TableInfo]:
        rel = self._tables.get(table_name)
        if rel is None:
            return None
        cols = [(n, c.stype) for n, c in zip(rel.names, rel.columns)]
        return TableInfo(table_name, cols)

    def list_tables(self):
        return [self.describe(n) for n in sorted(self._tables)]

    def get_table_data(self, table_name: str) -> Relation:
        rel = self._tables.get(table_name)
        if rel is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return rel

    def get_table_chunks(self, table_name: str, chunk_rows: int):
        """Chunked view for the streaming cursor (bounds the downstream
        formatted-row footprint; the relation itself is in RAM)."""
        yield from self.get_table_data(table_name).iter_chunks(chunk_rows)


class Transaction:
    def __init__(
        self, tables: TableProvider, query_cache=None, trace=None, *, device
    ):
        from eventql_tpu_torch.exec.exec_context import ExecutionContext

        self.tables = tables
        self.query_cache = query_cache
        # device of the GROUP BY route, or None for the host engine. No
        # default: a transaction made by hand names its device, as one
        # made by Runtime.new_transaction takes the Runtime's
        self.device = _resolve_device(device)
        # per-query stats + shard progress (reference:
        # sql/scheduler/execution_context.h:30-54)
        self.exec_ctx = ExecutionContext()
        # the query's spans (survey §5: the reference has no tracer — an
        # addition of this engine): every span of this transaction's
        # plan, execution and emit carries its id. Passing trace=[] or
        # EVENTQL_TRACE=1 traces the transaction: the tracer is on while
        # its stages run, and their spans land in this list
        # (utils/trace.py)
        self.query_id = _trace.next_query_id()
        import os as _os

        if trace is None and _os.environ.get("EVENTQL_TRACE") == "1":
            trace = []
        self.trace = trace

    def get_table_data(self, table_name: str) -> Relation:
        rel = self.tables.get_table_data(table_name)
        # every operator-layer table materialization is a scan for the
        # query's stats (rows/bytes-scanned in QUERY_PROGRESS and
        # QUERY_RESULT; the reference defines those wire fields but
        # zeroes them, frames/query_progress.cc:63-70). Deduped per
        # (table, relation identity) within the transaction: the device
        # GROUP BY / top-k routes fetch the table while PROBING
        # eligibility and the fallback path fetches it again — one
        # logical scan must not count 2-3x.
        seen = getattr(self, "_scan_counted", None)
        if seen is None:
            seen = self._scan_counted = set()
        key = (table_name, id(rel))
        if key not in seen:
            seen.add(key)
            self.exec_ctx.count_scan(
                rel.num_rows,
                sum(c.data.nbytes + c.valid.nbytes for c in rel.columns),
            )
        return rel

    def trace_report(self) -> str:
        """The query's spans as a tree: operators in pre-order, each
        with its milliseconds and rows, the routes, expressions,
        kernels and readbacks nested where they ran."""
        return _trace.report(self.trace or [])


class PlanCache:
    """Server-side LRU cache of built plan-node lists, keyed by
    (provider identity, provider schema version, query text).

    The reference re-parses and re-plans every query per request (its
    only caching is of partial-aggregate RESULTS, QueryCache); repeated
    dashboard queries here skip parse + plan-build entirely. Plans are
    safe to share: execution never mutates plan nodes (device-route
    rewrites copy expressions first), and all table DATA is read through
    the transaction at execute time, so a cached plan stays correct
    across inserts. Schema changes invalidate via the provider's
    plan_cache_key() version. Only read-only statement plans are cached
    (DDL/DML re-build, and any DDL bumps the version key anyway)."""

    def __init__(self, max_entries: int = 256):
        import threading
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._entries = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            nodes = self._entries.get(key)
            if nodes is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return nodes

    def put(self, key, nodes):
        with self._lock:
            self._entries[key] = nodes
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)


class QueryPlan:
    def __init__(self, runtime: "Runtime", txn: Transaction, nodes: List[qn.QueryTreeNode]):
        self.runtime = runtime
        self.txn = txn
        self.nodes = nodes

    @property
    def num_queries(self) -> int:
        return len(self.nodes)

    def execute(self, idx: int) -> ResultList:
        node = self.nodes[idx]
        if isinstance(node, qn.ExplainNode):
            # render the logical plan (reference parses EXPLAIN but
            # never plans it — parser.cc:914; this exceeds it)
            lines = qn.explain_lines(node.child)
            return ResultList(["QUERY PLAN"], [[l] for l in lines])
        with _trace.stage("query.execute", self.txn.query_id, self.txn.trace):
            rel = execute_node(node, self.txn)
        res = ResultList.from_relation(node.get_result_columns(), rel)
        res.query_id, res.trace_sink = self.txn.query_id, self.txn.trace
        return res

    def execute_stream(self, idx: int):
        """Execute statement `idx` with bounded memory when its plan
        shape allows: returns a StreamingResultList whose rows generator
        pulls storage chunks through the row-local operators as the
        transport consumes them (reference: ResultCursor,
        sql/result_cursor.h:35-75); falls back to the materializing
        execute() for blocking shapes (GROUP BY / ORDER BY / JOIN), which
        take the transaction's device routes."""
        from eventql_tpu_torch.exec import streaming

        node = self.nodes[idx]
        if streaming.streamable(node, self.txn):
            return streaming.StreamingResultList(
                node.get_result_columns(),
                streaming.stream_node(node, self.txn),
            )
        return self.execute(idx)


def _resolve_device(device):
    """torch.device for the route, or None for the host engine. A CUDA
    device that is not there raises: nothing falls back to the CPU."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError_(
                f"Runtime(device={device!r}): no CUDA device is available;"
                " pass device='cpu' to run the route's plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError_(f"unsupported device: {device!r}")
    return dev


class Runtime:
    def __init__(
        self,
        registry=DEFAULT_REGISTRY,
        plan_cache: Optional[PlanCache] = None,
        device="cuda",
    ):
        self.registry = registry
        self.plan_cache = plan_cache
        self.device = _resolve_device(device)

    def new_transaction(
        self, tables: Optional[TableProvider] = None, query_cache=None
    ) -> Transaction:
        return Transaction(
            tables or RelationTableProvider(), query_cache, device=self.device
        )

    def build_query_plan(self, txn: Transaction, query: str) -> QueryPlan:
        if txn.device != self.device:
            raise RuntimeError_(
                f"transaction on device {txn.device} given to a Runtime on"
                f" {self.device}"
            )
        with _trace.stage("query.plan", txn.query_id, txn.trace) as sp:
            key = None
            if self.plan_cache is not None:
                version_fn = getattr(txn.tables, "plan_cache_key", None)
                if version_fn is not None:
                    key = (id(txn.tables), version_fn(), query)
                    nodes = self.plan_cache.get(key)
                    sp.set("plan_cache", "miss" if nodes is None else "hit")
                    if nodes is not None:
                        return QueryPlan(self, txn, nodes)
            parser = Parser()
            statements = parser.parse(query)
            builder = QueryPlanBuilder(self.registry)
            nodes = builder.build_statements(statements, txn.tables)
            if key is not None and all(
                isinstance(n, qn.TableExpressionNode) for n in nodes
            ):
                self.plan_cache.put(key, nodes)
            return QueryPlan(self, txn, nodes)

    def execute_query(self, txn: Transaction, query: str) -> List[ResultList]:
        plan = self.build_query_plan(txn, query)
        return [plan.execute(i) for i in range(plan.num_queries)]

    def evaluate_const_expression(self, txn: Transaction, expr_str: str) -> SValue:
        # reference: Runtime::evaluateConstExpression (runtime.cc:126-150)
        parser = Parser()
        ast = parser.parse_value_expression(expr_str)
        builder = QueryPlanBuilder(self.registry)
        from eventql_tpu_torch.plan.builder import _empty_resolver

        expr = builder.build_value_expression(ast, _empty_resolver)
        return evaluate_scalar(expr)
