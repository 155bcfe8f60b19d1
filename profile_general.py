#!/usr/bin/env python3
"""Where the host time of the port's general GROUP BY goes.

    python3 profile_general.py [--label NAME]   # from the root of the checkout
    python3 profile_general.py --device cpu --rows 20000   # a rehearsal, no card

Needs one CUDA device and nvcc (or ``--device cpu`` for a rehearsal of
the control flow at a small size: no time it prints is a device time).
Builds the table of chip_smoke.py at its size (chip_smoke.N_ROWS), runs
each general GROUP BY query of its phase 4 (G1-G5, the sparse-span pair
G6 / G7), J1, the headline GROUP BY (B1) and the small-dimension join
(B4 + B1) REPS times, and splits each warm run's end-to-end time
(host clock, ending in a synchronise) into:

* ``kernel_ms``: the hash aggregate's call (``hash_groupby``, a
  synchronise after it, so that its device time lands here);
* ``wait_ms`` and ``copy_ms``: in each device -> host copy
  (``kernels/sort.read_host``), the synchronise before it (the device
  work queued since: on the card the compaction's gathers and sort) and
  the copy itself; ``readbacks`` and ``readback_bytes`` (the copies'
  sizes, measured here, so that a tree without the port's own byte
  counter is measured alike);
* ``gather_ms``: ``Column.gather`` on the host (the first rows' input
  columns where they are gathered there);
* ``evaluate_ms``: the host evaluator (``evaluate_vector``, outermost
  calls) over the groups' aggregates and first rows;
* ``result_ms``: ``ResultList.from_relation``;
* ``rest_ms``: the end-to-end time less all of the above: the plan, the
  scan's expressions and, where a tree compacts on the host, the
  compaction and the sort of the groups by first row.

The medians of the warm runs are printed, one JSON line a query, with
the first run's end-to-end time and ``rows_ms``, the time to format the
ResultList's rows (outside the end-to-end time: a consumer's). The
script patches module attributes only, so that it measures any tree of
the port alike: copy it into another checkout's root and run it there to
compare two trees on one card (parent, change, change, parent).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke
from eventql_tpu_torch.exec import relation, result, vector_eval
from eventql_tpu_torch.exec.runtime import PlanCache, Runtime
from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.kernels import hash_groupby as hg
from eventql_tpu_torch.kernels import sort as ksort

REPS = 5  # the first warms the column cache and the plan cache
SPARSE_WHERE = f"big < {chip_smoke.BIG_BASE + 10}"  # chip_smoke.py's G6 / G7
QUERIES = {
    **chip_smoke.GENERAL_SQL,
    "G6_sparse_span": f"select w, count(1), sum(v) from t where {SPARSE_WHERE} group by w;",
    "G7_hash_tier": f"select w + 1, count(1), sum(v) from t where {SPARSE_WHERE}"
                    " group by w + 1;",
    chip_smoke.J1[0]: chip_smoke.J1[1],
    # the bounded routes, whose buckets are compacted the same way
    "headline": "select k, count(1), sum(v) from t where v < 800 group by k;",
    "join_small_dim": "select d1.region, count(1), sum(t.v) from t join d1 on t.dk = d1.k"
                      " group by d1.region;",
}
PARTS = ("kernel_ms", "wait_ms", "copy_ms", "gather_ms", "evaluate_ms", "result_ms")


class _Split:
    """While active, the patched functions add their host time to the
    current run's parts."""

    def __init__(self, sync):
        self.sync, self.run, self.depth, self.saved = sync, None, 0, []

    def _patch(self, owner, name, make):
        real = owner.__dict__[name]
        self.saved.append((owner, name, real))
        setattr(owner, name, make(real))

    def _timed(self, part, fn, sync_after=False):
        def call(*a, **k):
            if self.run is None:
                return fn(*a, **k)
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync_after:
                self.sync()
            self.run[part] += (time.perf_counter() - t) * 1e3
            return out

        return call

    def __enter__(self):
        self._patch(hg, "hash_groupby", lambda f: self._timed("kernel_ms", f, True))
        self._patch(relation.Column, "gather", lambda f: self._timed("gather_ms", f))
        self._patch(result.ResultList, "from_relation",
                    lambda f: staticmethod(self._timed("result_ms", f.__func__)))

        def read_host(real):
            def call(t):
                if self.run is None:
                    return real(t)
                t0 = time.perf_counter()
                self.sync()
                t1 = time.perf_counter()
                out = real(t)
                self.run["wait_ms"] += (t1 - t0) * 1e3
                self.run["copy_ms"] += (time.perf_counter() - t1) * 1e3
                self.run["readbacks"] += 1
                self.run["readback_bytes"] += t.numel() * t.element_size()
                return out

            return call

        def evaluate(real):
            timed = self._timed("evaluate_ms", real)

            def call(*a, **k):
                self.depth += 1
                try:
                    return timed(*a, **k) if self.depth == 1 else real(*a, **k)
                finally:
                    self.depth -= 1

            return call

        self._patch(ksort, "read_host", read_host)
        self._patch(vector_eval, "evaluate_vector", evaluate)
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.saved):
            setattr(owner, name, real)
        self.saved.clear()


def split_query(rt, provider, sql, sync):
    """REPS runs of one query: the medians of the warm runs' parts, the
    first run's end-to-end time, and the last run's rows and their
    formatting time."""
    runs = []
    with _Split(sync) as split:
        for _ in range(REPS):
            split.run = dict.fromkeys(PARTS, 0.0)
            split.run.update(readbacks=0, readback_bytes=0)
            t = time.perf_counter()
            res = chip_smoke.run_query(rt, provider, sql)
            sync()
            split.run["e2e_ms"] = (time.perf_counter() - t) * 1e3
            split.run["rest_ms"] = split.run["e2e_ms"] - sum(split.run[p] for p in PARTS)
            runs.append(split.run)
            split.run = None
    t = time.perf_counter()
    rows = res.rows
    rows_ms = (time.perf_counter() - t) * 1e3
    warm = runs[1:]
    out = {k: statistics.median(r[k] for r in warm)
           for k in ("e2e_ms", *PARTS, "rest_ms", "readbacks", "readback_bytes")}
    out.update(first_e2e_ms=runs[0]["e2e_ms"], rows_ms=rows_ms, groups=len(rows))
    return out, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this tree, printed on each line")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=chip_smoke.N_ROWS)
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("profile_general: no CUDA device is available")
        device = torch.device("cuda", torch.cuda.current_device())
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        _build.build_all()
        sync = torch.cuda.synchronize
    else:
        device, card, sync = torch.device("cpu"), "cpu (no device time)", lambda: None
    print(card, flush=True)
    n = args.rows
    cols, dictionary = chip_smoke.make_table(n, seed=42)
    dims = chip_smoke.make_dims(seed=43)
    provider = chip_smoke.add_dims(chip_smoke.provider_of(cols, dictionary, n), dims)
    rt, host = Runtime(plan_cache=PlanCache(), device=device), Runtime(device=None)
    for name, sql in QUERIES.items():
        out, rows = split_query(rt, provider, sql, sync)
        if n <= chip_smoke.N_PREFIX_ROWS:
            # small tables: the answer against the host engine as well
            # (the headline's route keeps bucket order, the host engine first rows)
            want = chip_smoke.run_query(host, provider, sql).rows
            if sorted(rows) != sorted(want) or (name != "headline" and rows != want):
                sys.exit(f"profile_general: {name}: the route and the host engine differ")
        print(json.dumps({"label": args.label, "query": name, "rows": n, "card": card,
                          **out}), flush=True)


if __name__ == "__main__":
    main()
