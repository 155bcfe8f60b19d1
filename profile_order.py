#!/usr/bin/env python3
"""Where the device time of the port's ORDER BY and JOIN queries goes.

    python3 profile_order.py     # from the root of the checkout; no arguments

Needs one CUDA device and nvcc. Builds the table of chip_smoke.py at its
size (chip_smoke.N_ROWS), runs each of its ORDER BY queries and of its
routed JOIN + GROUP BY queries until warm, then once more under
torch.profiler, and prints per query: the wall time of the profiled
run, the summed device time, the device's idle share of the wall time,
and the device time by kernel name (the largest first); for a join query
also the host time its plan analysis took in that run (the dimension
side is evaluated on the host there). Then the same for the full ORDER
BYs of chip_smoke.py phase 6 over its mesh of shards on the one card,
with the kernel launches and the host time by operator. The profiler
slows the host side, so the wall time here is not the query's latency
(chip_smoke.py reports that); the split of the device time is the point.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.runtime import PlanCache, Runtime
from eventql_tpu_torch.kernels import _build


def _short(kernel_name):
    """A kernel's name without its template arguments and namespaces:
    PyTorch's elementwise kernels differ only in a functor far down."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    name = name.split("<")[0].split("(")[0].replace("void ", "")
    functor = ""
    for part in ("bitwise", "BUnaryFunctor", "AUnaryFunctor", "direct_copy",
                 "compare", "where", "index", "RadixSort", "reduce", "scatter",
                 "nonzero", "flag", "Select"):
        if part in kernel_name:
            functor = f" [{part}]"
            break
    return name.split("::")[-1] + functor


def main():
    if len(sys.argv) > 1:
        sys.exit("profile_order: takes no arguments; the size is chip_smoke's")
    if not torch.cuda.is_available():
        sys.exit("profile_order: no CUDA device is available")
    n = chip_smoke.N_ROWS
    device = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    cols, dictionary = chip_smoke.make_table(n, seed=42)
    dims = chip_smoke.make_dims(seed=43)
    provider = chip_smoke.add_dims(chip_smoke.provider_of(cols, dictionary, n), dims)
    rt = Runtime(plan_cache=PlanCache(), device=device)

    # the join route's plan analysis, on the host clock
    analysis_ms = []
    analyse = device_exec.join_groupby_analysis

    def timed_analysis(node, txn):
        t = time.perf_counter()
        plan = analyse(node, txn)
        analysis_ms.append((time.perf_counter() - t) * 1e3)
        return plan

    device_exec.join_groupby_analysis = timed_analysis
    queries = chip_smoke.order_queries(cols, dictionary, n) + [
        q for q in chip_smoke.join_queries(cols, dims, n) if q[-1] is not None]
    for name, sql, *_rest in queries:
        out = _profiled(rt, provider, name, sql, n)
        if name.startswith("join"):
            out["host_plan_analysis_ms"] = analysis_ms[-1]
        print(json.dumps(out), flush=True)

    # the full ORDER BYs of chip_smoke.py phase 6 over its mesh of shards
    # on the one card (Runtime(device=None): the mesh route alone)
    from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

    small, small_qs = chip_smoke.small_order_table(seed=47)
    mesh = MeshTableProvider(n_shards=chip_smoke.MESH_SHARDS, device="cuda")
    mesh.add_table("t", provider.get_table_data("t"))
    mesh.add_table("o", small)
    mesh_qs = [(name, sql) for name, sql, route, *_rest in chip_smoke.order_queries(
        cols, dictionary, n) if route == "order"]
    mesh_qs += [(name, sql) for name, sql, *_rest in
                chip_smoke.mesh_order_queries(cols, dictionary) + small_qs]
    for name, sql in mesh_qs:
        out = _profiled(Runtime(device=None), mesh, name, sql, n)
        out["mesh_shards"] = chip_smoke.MESH_SHARDS
        print(json.dumps(out), flush=True)


def _profiled(rt, provider, name, sql, n):
    """The query run until warm, then once under torch.profiler: its
    wall time, device time, idle share and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        chip_smoke.run_query(rt, provider, sql)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        chip_smoke.run_query(rt, provider, sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel, host_by_op = {}, {}
    launches = 0
    for ev in prof.key_averages():
        # kernel events only: an operator's entry repeats the time of
        # the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            if ev.key.startswith("aten::"):
                host_by_op[ev.key] = ev.self_cpu_time_total / 1e3
            continue
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0:
            key = _short(ev.key)
            by_kernel[key] = by_kernel.get(key, 0.0) + dev_us / 1e3
            launches += ev.count
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]
    return {
        "query": name, "rows": n, "profiled_wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_launches": launches,
        "device_ms_by_kernel": {k: round(v, 4) for k, v in top},
        "host_ms_by_op": {k: round(v, 3) for k, v in
                          sorted(host_by_op.items(), key=lambda kv: -kv[1])[:8]},
    }


if __name__ == "__main__":
    main()
