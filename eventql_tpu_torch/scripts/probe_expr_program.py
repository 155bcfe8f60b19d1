"""Probe: the expression program alone, at the benchmark's expressions.

Four expressions of gpubench/traffic, each compiled by
``exec/torch_expr.py`` over ``--n`` rows (2^26 by default) of LINEITEM
columns drawn on the device with the spans of
gpubench/configs/tpch_sf10_lineitem.json and stored as the column cache
narrows them (u16 quantity, discount, tax and ship date, u32 price):

- ``q1_charge``: Q1's ``l_extendedprice * (100 - l_discount) * (100 +
  l_tax)``, three narrow inputs and one int64 output;
- ``q1_mean_quantity``: ``mean(l_quantity)``'s conversion (u16 to float64);
- ``q6_where``: Q6's five compares and four ANDs (a bool output);
- ``q6_revenue``: Q6's ``l_extendedprice * l_discount``.

Each runs once and is held against the PyTorch path
(``torch_expr.compile_torch``) bit for bit, then is timed (CUDA events,
the whole ``compile_expr`` call) beside that path and beside its bound:
each input stream read once at its stored width and the result written
once, over 3.35 TB/s.

    python3 -m eventql_tpu_torch.scripts.probe_expr_program [--n N] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import torch_expr
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.scripts import bound_ms, card, cuda_ms, device_of, fmt_ms

# column -> (low, high) of gpubench/configs/tpch_sf10_lineitem.json
SPANS = {"l_quantity": (1, 50), "l_extendedprice": (90000, 10495000),
         "l_discount": (0, 10), "l_tax": (0, 8), "l_shipdate": (8036, 10561)}

CASES = {
    "q1_charge": "l_extendedprice * (100 - l_discount) * (100 + l_tax)",
    "q1_mean_quantity": "to_float64(l_quantity)",
    "q6_where": "l_shipdate >= 8766 and l_shipdate < 9131 and l_discount >= 5"
                " and l_discount <= 7 and l_quantity < 24",
    "q6_revenue": "l_extendedprice * l_discount",
}


def _schema_provider():
    """A small LINEITEM with the same spans (so the same stored dtypes):
    what the planner reads."""
    lo = np.array([lo for lo, _hi in SPANS.values()], np.uint64)
    hi = np.array([hi for _lo, hi in SPANS.values()], np.uint64)
    rel = relation_from_numpy(
        list(SPANS), [(SType.UINT64, np.array([a, b], np.uint64), np.ones(2, bool), None)
                      for a, b in zip(lo, hi)])
    p = RelationTableProvider()
    p.add_table("lineitem", rel)
    return p


def _columns(n, device, seed):
    """Each column as the column cache stores it: the narrowest signed
    dtype of its span's width, an all-valid plane."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, (lo, hi) in SPANS.items():
        dtype = torch.int16 if hi < (1 << 16) else torch.int32
        data = torch.randint(lo, hi + 1, (n,), generator=gen, device=device,
                             dtype=torch.int64).to(dtype)
        out[name] = torch_expr.DeviceCol(SType.UINT64, data,
                                         torch.ones(n, dtype=torch.bool, device=device))
    return out


def probe(device, n=1 << 26, iters=20, seed=21):
    smi = card(device)
    provider = _schema_provider()
    rt = Runtime(device=None)
    columns = _columns(n, device, seed)
    out = {"card": smi, "device": str(device), "n": n, "cases": {}}
    for name, text in CASES.items():
        plan = rt.build_query_plan(rt.new_transaction(provider), f"select {text} from lineitem;")
        scan = plan.nodes[0]
        while not hasattr(scan, "input_columns"):
            scan = scan.table
        expr = scan.select_list[0].expr
        cols = [columns[c] for c, _t in scan.input_columns]
        prog = torch_expr.program_for(expr, cols)
        if prog is None:
            raise AssertionError(f"probe_expr_program: {name}: the program does not take it")
        got = torch_expr.compile_expr(expr, cols, n, device)
        want = torch_expr.compile_torch(expr, cols, n, device)
        if not (got.data.dtype == want.data.dtype
                and torch.equal(got.data, want.data.expand(n))):
            raise AssertionError(f"probe_expr_program: {name}: the program and the PyTorch"
                                 f" path differ")
        del got, want
        nbytes = n * (sum(cols[j].data.element_size() if plane == "data" else 1
                          for j, plane, _kind in prog.streams)
                      + torch.empty((), dtype=prog.dtype).element_size())
        ms = cuda_ms(lambda: torch_expr.compile_expr(expr, cols, n, device), iters,
                     device=device)
        plain_ms = cuda_ms(lambda: torch_expr.compile_torch(expr, cols, n, device), 3,
                           warmup=1, device=device)
        bound = bound_ms(nbytes)
        out["cases"][name] = {
            "expr": text, "ops": prog.ops, "streams": [k for _j, _p, k in prog.streams],
            "slots": prog.nslots, "bytes": nbytes, "bound_ms": bound, "ms": ms,
            "plain_ms": plain_ms, "share_of_peak": None if ms is None else bound / ms,
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 26)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    res = probe(device_of(args.device), args.n)
    print(f"probe_expr_program: {res['card']}, n = {res['n']}")
    for name, c in res["cases"].items():
        share = "not measured" if c["ms"] is None else f"{100 * c['share_of_peak']:.1f} %"
        print(f"  {name}: {c['ops']} instructions over {c['streams']}; {fmt_ms(c['ms'])}"
              f" (bound {c['bound_ms']:.5f} ms by bytes, {share} of 3.35 TB/s),"
              f" PyTorch path {fmt_ms(c['plain_ms'])}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
