"""The port's own spans laid on a traced run's device timeline.

    python3 gpubench/spans.py --workload <cell> --seed <n> --seconds <s> [--trace 1]

The port records query-scoped spans (``eventql_tpu_torch/utils/trace.py``)
on ``time.time_ns()``, the clock of the Chrome trace that ``torch.profiler``
exports (``baseTimeNanoseconds`` + ``ts`` x 1000). This script runs one cell
as ``gpubench/run.py`` does, with the port's tracer switched on before the
warm-up pass, and with ``--trace 1`` maps the spans onto the profiled window
and prints on its last line, as one JSON object:

- the device's idle time split by the innermost program span open at each
  idle instant (an interval intersection, not a gap's midpoint), a query:
  ``expr_idle_ms``, ``kernel_idle_ms``, ``route_idle_ms``,
  ``readback_idle_ms``, ``emit_idle_ms``, ``plan_idle_ms`` and
  ``unnamed_idle_ms``, which sum to ``host_ms_per_query``, and the unnamed
  part by the benchmark's stage span (plan, execute, emit) open then;
- ``upload_ms``: host milliseconds of the ``upload`` spans (the warm-up's);
- the idle gaps named as ``Trace.idle_gaps`` names them (the midpoint
  rule), with the innermost program span between the benchmark's span and
  the host operation, and the share of idle time in gaps that cross a
  program span's boundary;
- device milliseconds a query by the program span open at each kernel's
  launch (the kernel matched to its launch by the trace's ``correlation``),
  and by that span and the kernel's name;
- the share of the hand-written kernels' launches that fall inside a
  ``kernel.*`` span.

With ``--trace 0`` it prints the untraced run's end-to-end metrics with
the tracer on; ``gpubench/run.py --trace 0`` with the same seed is the run
with it off, and the two give the tracer's cost. Not part of a benchmark
run: ``gpubench/harness.py`` does not switch the program's tracer on.
"""

import bisect
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    # as gpubench/run.py: caches inside the checkout, modules from its root
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = ROOT

from gpubench import harness, tracing  # noqa: E402

# where the device's idle time is charged, by the innermost program span:
# (reading, span names or name prefixes ending in ".")
IDLE_OF = (
    ("expr_idle_ms", ("expr",)),
    ("kernel_idle_ms", ("kernel.", "build")),
    ("route_idle_ms", ("route.", "upload")),
    ("readback_idle_ms", ("readback",)),
    ("emit_idle_ms", ("query.emit", "op.")),
    ("plan_idle_ms", ("query.plan", "query.execute")),
)
UNNAMED = "unnamed_idle_ms"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def reading_of(name):
    for reading, names in IDLE_OF:
        if any(name == n or (n.endswith(".") and name.startswith(n)) for n in names):
            return reading
    return UNNAMED


def label(span):
    role = span.attrs.get("role")
    return f"{span.name}[{role}]" if role else span.name


def on_trace_time(spans, base_ns):
    """(label, start_us, end_us, span) of each span in the export's time."""
    return [(label(s), (s.start_ns - base_ns) * 1e-3, (s.end_ns - base_ns) * 1e-3, s)
            for s in spans]


def innermost_segments(items):
    """Pieces (start, end, item) of the timeline, each where ``item`` is the
    innermost of the nested ``items`` (label, start, end, span) open; no
    piece where none is."""
    segs, stack, t = [], [], None
    for item in sorted(items, key=lambda x: (x[1], -x[2])):
        s = item[1]
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            segs.append((t, top[2], top))
            t = top[2]
        if stack and s > t:
            segs.append((t, s, stack[-1]))
        if stack and item[2] > stack[-1][2]:
            item = (item[0], s, stack[-1][2], item[3])  # clipped to its parent
        stack.append(item)
        t = s
    while stack:
        top = stack.pop()
        segs.append((t, top[2], top))
        t = top[2]
    return [x for x in segs if x[1] > x[0]]


def idle_intervals(trace):
    edges = [trace.start] + [x for iv in trace.busy_intervals for x in iv] + [trace.end]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def charge(intervals, items, key):
    """Seconds of the sorted, disjoint ``intervals`` by ``key(item)`` of
    the innermost of ``items`` open at each instant, the pieces no item
    covers, and the seconds of the intervals that more than one piece (an
    item, or none) shares."""
    out = {}
    segs = innermost_segments(items)
    starts = [s for s, _e, _i in segs]
    uncovered, crossing = [], 0.0
    for g0, g1 in intervals:
        t, pieces = g0, 0
        j = max(0, bisect.bisect_right(starts, g0) - 1)
        while j < len(segs) and segs[j][0] < g1:
            s, e, item = segs[j]
            lo, hi = max(s, g0), min(e, g1)
            if hi > lo:
                k = key(item)
                out[k] = out.get(k, 0.0) + (hi - lo) * 1e-6
                if lo > t:
                    uncovered.append((t, lo))
                    pieces += 1
                t = hi
                pieces += 1
            j += 1
        if g1 > t:
            uncovered.append((t, g1))
            pieces += 1
        if pieces > 1:
            crossing += (g1 - g0) * 1e-6
    return out, uncovered, crossing


def idle_split(trace, items):
    """Seconds of device idle time in the window by the reading of the
    innermost program span open at each idle instant (``UNNAMED`` where
    none is), the seconds of idle time in gaps that cross a span's edge,
    and the unnamed seconds by the benchmark's stage span open then."""
    split, uncovered, crossing = charge(idle_intervals(trace), items,
                                        lambda item: reading_of(item[3].name))
    out = {reading: split.get(reading, 0.0) for reading, _ in IDLE_OF}
    out[UNNAMED] = sum(e - s for s, e in uncovered) * 1e-6
    stages = [(name[len("gpubench."):], s, e, None) for name, s, e, _ in trace.spans]
    by_stage, outside, _ = charge(uncovered, stages, lambda item: item[0])
    by_stage["between queries"] = sum(e - s for s, e in outside) * 1e-6
    return out, crossing, by_stage


def named_idle_gaps(trace, items, top=10):
    """``Trace.idle_gaps`` with the innermost program span at each gap's
    middle between the benchmark's span and the host operation."""
    spans = tracing._Nest(trace.spans)
    program = tracing._Nest([(lab, s, e, "program") for lab, s, e, _ in items])
    host = tracing._Nest(trace.host)
    by = {}
    for s, t in idle_intervals(trace):
        mid = (s + t) / 2
        span, prog, op = spans.innermost(mid), program.innermost(mid), host.innermost(mid)
        name = (span[len("gpubench."):] if span else "between queries")
        name += (f" > {prog}" if prog else "") + (f": {op}" if op else "")
        by[name] = by.get(name, 0.0) + (t - s) * 1e-6
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]


def _launches(events):
    """correlation id -> (launch time, kernel event) of the window's kernels."""
    launch, kernels = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in LAUNCHES:
            launch[corr] = float(e["ts"])
        elif e.get("cat") == "kernel":
            kernels[corr] = e
    return {c: (launch[c], k) for c, k in kernels.items() if c in launch}


def _short(kernel):
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(noise, "")
    return kernel[:120]


def device_by_launching_span(trace, events, items, top=25):
    """Device seconds of the window's kernels by the innermost program span
    open at each kernel's launch ("none" where none was), and by that span
    and the kernel's name."""
    program = tracing._Nest([(lab, s, e, "program") for lab, s, e, _ in items])
    by, by_kernel = {}, {}
    for at, k in _launches(events).values():
        s = float(k["ts"])
        t = s + float(k["dur"])
        if t <= trace.start or s >= trace.end:
            continue
        where = program.innermost(at) or "none"
        secs = (min(t, trace.end) - max(s, trace.start)) * 1e-6
        by[where] = by.get(where, 0.0) + secs
        pair = f"{where} | {_short(k.get('name', ''))}"
        by_kernel[pair] = by_kernel.get(pair, 0.0) + secs

    def ranked(d):
        return sorted(([n, v] for n, v in d.items()), key=lambda x: -x[1])[:top]

    return ranked(by), ranked(by_kernel)


def kernel_launch_coverage(trace, events, items, names):
    """(launches of the kernels named ``names`` in the window, of them
    inside a ``kernel.*`` span)."""
    import re

    pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    inside = tracing._Nest([(lab, s, e, "program") for lab, s, e, _ in items
                            if lab.startswith("kernel.")])
    total = hit = 0
    for at, k in _launches(events).values():
        if not (trace.start <= at <= trace.end) or not pattern.search(k.get("name", "")):
            continue
        total += 1
        hit += inside.innermost(at) is not None
    return total, hit


def readings(trace, events, base_ns, spans, queries, kernel_names):
    """Every reading of a traced run with the program's spans."""
    items = on_trace_time(spans, base_ns)
    window = [x for x in items if x[2] > trace.start and x[1] < trace.end]
    split, crossing, unnamed_by_stage = idle_split(trace, window)
    idle_s = trace.window_s - trace.busy_s
    total, hit = kernel_launch_coverage(trace, events, window, kernel_names)
    out = {k: 1e3 * v / queries for k, v in split.items()}
    out["upload_ms"] = sum(s.ms for s in spans if s.name == "upload")
    out["host_ms_per_query"] = 1e3 * idle_s / queries
    out["idle_share_in_crossing_gaps"] = crossing / idle_s if idle_s > 0 else None
    out["kernel_launches"] = total
    out["kernel_launches_in_kernel_spans"] = hit
    out["idle_gaps"] = named_idle_gaps(trace, window)
    by_span, by_kernel = device_by_launching_span(trace, events, window)
    out["device_ms_by_launching_span"] = [[n, 1e3 * v / queries] for n, v in by_span]
    out["device_ms_by_launching_span_and_kernel"] = [[n, 1e3 * v / queries] for n, v in by_kernel]
    out["unnamed_idle_ms_by_stage"] = {k: 1e3 * v / queries for k, v in unnamed_by_stage.items()}
    out["spans_in_window"] = len(window)
    return out


class _KeepRaw:
    """``tracing.read`` that also keeps the export's events and base time."""

    last = None

    def __call__(self, prof):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-spans-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        t = tracing.Trace(data["traceEvents"])
        self.last = (t, data["traceEvents"], int(data["baseTimeNanoseconds"]))
        return t


def run(workload_name, seed, seconds, trace, device="cuda", sizes=None):
    """One run of the cell with the program's tracer on; returns (the
    harness's result line, this script's readings, None without
    ``trace``)."""
    from eventql_tpu_torch.exec import device_exec
    from eventql_tpu_torch.kernels import _build
    from eventql_tpu_torch.utils import trace as ptrace

    t_start = time.perf_counter()
    keep = _KeepRaw()
    read, tracing.read = tracing.read, keep
    dropped = ptrace.DROPPED
    ptrace.drain()
    ptrace.enable()
    try:
        result = harness.run_cell(workload_name, seed, seconds, trace, t_start,
                                  device=device, sizes=sizes)
    finally:
        tracing.read = read
        ptrace.disable()
    spans = ptrace.drain()
    out = None
    if keep.last is not None:
        t, events, base_ns = keep.last
        queries = result["attempted"] - result["failed"]
        kernel_names = harness.Cell(workload_name, sizes).layers["kernels"]["kernels"]
        out = readings(t, events, base_ns, spans, queries, kernel_names)
        out["spans"] = len(spans)
        out["dropped"] = ptrace.DROPPED - dropped
        out["column_uploads"] = device_exec.COLUMN_UPLOADS
        out["upload_bytes"] = device_exec.UPLOAD_BYTES
        out["builds"] = dict(_build.BUILDS)
    return result, out


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("gpubench/spans.py: no CUDA device")
        return 2
    result, out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    for row in (out or {}).get("device_ms_by_launching_span", []):
        harness.log(f"spans: device ms a query {row[1]:.4f} launched under {row[0]}")
    line = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
            "correct": result["correct"],
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": {k: m["value"] for k, m in result["metrics"].items()},
            "device": result["device"], "spans": out}
    if "breakdown" in result:
        line["idle_gaps"] = result["breakdown"]["idle_gaps"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
