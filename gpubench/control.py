"""Readings that set the limits of ``correct`` for a cell.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: a short run of the cell as the benchmark
makes it (the program's readings: the numbers ``correct`` compares), then
the control, which is the plain reference one precision below the
configuration's (int32 integers, float32 means) put in the program's
place and judged by the same comparison. One JSON line a seed, then the
largest program reading and the smallest control reading of each number.
Not part of a benchmark run.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    # as gpubench/run.py: caches inside the checkout, modules from its root
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = ROOT

from gpubench import compare, harness, workload  # noqa: E402


def control_readings(workload_name, seed, device, sizes=None, bench=None):
    """The control's numbers on one seed: the reference at the lower
    precision, printed as the program prints, against the reference.
    ``bench`` (tests only) names another benchmark file than BENCHMARK.json."""
    cell = harness.Cell(workload_name, sizes, bench)
    instances, _ = workload.plan(cell.traffic, seed)
    tables = cell.generate(seed, device)
    expected = harness.reference_answers(cell, tables, instances)
    low = harness.reference_answers(cell, tables, instances, low=True)
    answers = [(i, compare.format_rows(compare.ordered(rows, inst["query"])))
               for i, (rows, inst) in enumerate(zip(low, instances))]
    mismatches, gap = harness.judge(instances, answers, expected)
    out = {"mismatches": mismatches}
    if "mean_gap_e6" in cell.traffic["checks"]:
        out["mean_gap_e6"] = gap
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(args.workload, seed, args.seconds, False, time.perf_counter())
        line = {"seed": seed, "correct": result["correct"], "attempted": result["attempted"],
                "program": {k: c["value"] for k, c in result["checks"].items()},
                "control": control_readings(args.workload, seed, "cuda")}
        print(json.dumps(line), flush=True)
        readings.append(line)

    def extreme(side, pick):
        names = {k for r in readings for k in r[side]}
        return {k: pick((r[side][k] for r in readings if r[side].get(k) is not None), default=None)
                for k in names}

    print(json.dumps({"workload": args.workload, "program_max": extreme("program", max),
                      "control_min": extreme("control", min)}))
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
