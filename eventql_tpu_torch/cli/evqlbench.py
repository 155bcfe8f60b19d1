"""Local SQL microbenchmark (reference: cli/benchmarks/local_sql.cc +
evqlbench.cc): run a query repeatedly against an embedded runtime and
report rows/s."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="evqlbench")
    ap.add_argument("benchmark", nargs="?", default="local-sql")
    ap.add_argument("-q", "--query", default=None)
    ap.add_argument("-t", "--table", default=None, help="name=path.cst|csv table import")
    ap.add_argument("-n", "--num_rounds", type=int, default=10)
    ap.add_argument("--rows", type=int, default=1_000_000, help="synthetic table rows")
    ap.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the query's routes run: the card, or the kernels'"
        " plain versions on the CPU",
    )
    args = ap.parse_args(argv)

    import numpy as np

    from eventql_tpu_torch.columnar.providers import (
        CompositeTableProvider,
        CSTableScanProvider,
        CSVTableProvider,
    )
    from eventql_tpu_torch.core.types import SType
    from eventql_tpu_torch.exec.relation import Column, Relation
    from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime

    if args.table:
        name, _, path = args.table.partition("=")
        tables = CompositeTableProvider()
        if path.endswith(".cst"):
            tables.add(CSTableScanProvider(name, path))
        else:
            tables.add(CSVTableProvider(name, path))
        query = args.query or f"select count(1) from {name};"
    else:
        # synthetic benchmark table (the local_sql benchmark generates
        # its own data too)
        n = args.rows
        rng = np.random.default_rng(42)
        rel = Relation(
            ["k", "v"],
            [
                Column(
                    SType.UINT64,
                    rng.integers(0, 1024, n).astype(np.uint64),
                    np.ones(n, bool),
                ),
                Column(
                    SType.UINT64,
                    rng.integers(0, 1000, n).astype(np.uint64),
                    np.ones(n, bool),
                ),
            ],
            n,
        )
        tables = RelationTableProvider()
        tables.add_table("benchmark", rel)
        query = (
            args.query
            or "select k, sum(v), count(1) from benchmark where v < 800"
            " group by k;"
        )

    rt = Runtime(device=args.device)
    txn = rt.new_transaction(tables)

    # warmup
    plan = rt.build_query_plan(txn, query)
    result = plan.execute(0)

    input_rows = None
    if not args.table:
        input_rows = args.rows

    times = []
    for _ in range(args.num_rounds):
        t0 = time.perf_counter()
        plan = rt.build_query_plan(txn, query)
        result = plan.execute(0)
        times.append(time.perf_counter() - t0)

    best = min(times)
    avg = sum(times) / len(times)
    print(f"query: {query}")
    print(f"rounds: {args.num_rounds}  best: {best * 1e3:.2f} ms  avg: {avg * 1e3:.2f} ms")
    print(f"result rows: {result.num_rows}")
    if input_rows:
        print(f"throughput: {input_rows / best / 1e6:.2f} M input rows/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
