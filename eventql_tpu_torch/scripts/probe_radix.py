"""Probe: the four constants of a block-radix partition, on the card.

The counterpart of scripts/probe_radix.py. A partition of the rows by
key range (per-block histogram -> exclusive (block, bucket) prefix ->
per-block grouping -> placement of each (block, bucket) run -> per-bucket
sorts) rests on four constants, each measured here with CUDA events and
printed beside its bound (bytes over the card's 3.35 TB/s) and the card's
name and power limit:

  A. sort rate against block size: a stable ``torch.sort`` of a u32 key
     (carried as the int32 of the flipped word, so signed order is
     unsigned order) with an i32 payload gathered through its
     permutation, flat and as (C, B) blocks sorted along B, C = 64, 512,
     2048;
  B. run placement against run length: ``kernels/probes.place_runs`` at
     runs of 256, 1024, 4096 and 16384 elements over the whole array,
     each run to a random slot, as ns a run and Grows/s, beside its plain
     version and ``index_copy_`` of whole runs (the library yardstick);
  C. histogram rate: ``groupby_agg`` count-only at S = 256 and 2048
     buckets (the TPU probe's ``pallas_count``), beside ``torch.bincount``;
  D. gather rate: ``index_select`` through a random permutation and
     through one sorted within windows of 65536.

    python3 -m eventql_tpu_torch.scripts.probe_radix [--quick] [--n N] [--json PATH]

``--quick`` takes 2^23 elements, the default 2^25. Every result is checked
(sorted and stable, placed runs equal to their sources, counts equal to
bincount, gathers equal to the host's); a failed check raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from eventql_tpu_torch.kernels import probes
from eventql_tpu_torch.kernels.groupby_agg import groupby_agg
from eventql_tpu_torch.scripts import bound_ms, card, cuda_ms, device_of, fmt_ms

RUNS = (256, 1024, 4096, 16384)  # elements a run
BLOCKS = (64, 512, 2048)  # blocks of the batched sort
BUCKETS = (256, 2048)
WINDOW = 65536


def grows(n, ms):
    return None if ms is None else n / ms / 1e6


def _rate(r) -> str:
    return "not measured" if r is None else f"{r:7.3f} Grows/s"


def _share(bound, ms) -> str:
    return "" if ms is None else f", {bound / ms:.2f} of it"


def _check(cond, what):
    if not cond:
        raise AssertionError(f"probe_radix: {what}")


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint32)


def _line(smi, text):
    print(f"  {text} [{smi}]", flush=True)


# -- A. sorts ------------------------------------------------------------------


def _sorted_ok(keys, k, p):
    """Each row of k ascending, k the keys the payload (row numbers of
    ``keys``) points to, ties in payload order: a stable sort."""
    up = k[..., 1:] >= k[..., :-1]
    ties = k[..., 1:] == k[..., :-1]
    stable = ~ties | (p[..., 1:] > p[..., :-1])
    return bool(up.all()) and torch.equal(keys[p.long()], k) and bool(stable.all())


def probe_sorts(n, device, iters=5):
    smi = card(device)
    print(f"\n-- A. sort rates at n = {n} (u32 key + i32 payload, stable)", flush=True)
    rng = np.random.default_rng(7)
    keys = torch.from_numpy((_u32(rng, n) ^ np.uint32(0x80000000)).view(np.int32)).to(device)
    payload = torch.arange(n, dtype=torch.int32, device=device)
    out = []

    def flat():
        k, idx = torch.sort(keys, stable=True)
        return k, payload[idx]

    k, p = flat()
    _check(_sorted_ok(keys, k, p), "the flat sort")
    cases = [("flat", n, n, flat)]
    for c in BLOCKS:
        b = n // c
        kb, pb = keys[: c * b].view(c, b), payload[: c * b].view(c, b)

        def batched(kb=kb, pb=pb):
            k, idx = torch.sort(kb, dim=1, stable=True)
            return k, torch.gather(pb, 1, idx)

        k, p = batched()
        _check(_sorted_ok(keys, k, p), f"the sort of {c} blocks")
        cases.append((f"C = {c:>4}, B = {b:>8}", c * b, b, batched))
    del k, p
    for label, m, block, fn in cases:
        ms = cuda_ms(fn, iters, device=device)
        bound = bound_ms(16 * m)  # key and payload read once and written once
        out.append(dict(sort=label, rows=m, block=block, ms=ms, bound_ms=bound,
                        grows=grows(m, ms)))
        _line(smi, f"{label:<24} {_rate(grows(m, ms))} ({fmt_ms(ms)}; bound"
                   f" {bound:.5f} ms by bytes{_share(bound, ms)})")
    return out


# -- B. run placement ------------------------------------------------------------


def probe_placement(n, device, iters=10, runs=RUNS):
    """``place_runs`` over the whole array at each run length: every run
    of the source to a random slot (a permutation of the runs)."""
    smi = card(device)
    print(f"\n-- B. run placement at n = {n} u32 (a warp a run, 16-byte words;"
          f" runs to a random permutation of their slots)", flush=True)
    rng = np.random.default_rng(3)
    src = torch.from_numpy(_u32(rng, n).view(np.int32).reshape(-1, probes.ROW_WORDS)).to(device)
    dst = torch.empty_like(src)
    out = []
    for chunk in runs:
        rows = chunk // probes.ROW_WORDS
        nruns = src.shape[0] // rows
        perm = torch.from_numpy(rng.permutation(nruns)).to(device)
        src_off = torch.arange(nruns, dtype=torch.int32, device=device) * rows
        dst_off = (perm * rows).to(torch.int32)
        placed = probes.place_runs(src, src_off, dst_off, rows, out=dst)
        whole = src[: nruns * rows].view(nruns, -1)
        _check(torch.equal(placed[: nruns * rows].view(nruns, -1)[perm], whole),
               f"runs of {chunk}: a run did not land in its slot")
        plain = probes.place_runs_plain(src, src_off, dst_off, rows, out=torch.empty_like(src))
        _check(torch.equal(plain[: nruns * rows], placed[: nruns * rows]),
               f"runs of {chunk}: the kernel and its plain version differ")
        del plain
        ms = cuda_ms(lambda: probes.place_runs(src, src_off, dst_off, rows, out=dst),
                     iters, device=device)
        plain_ms = cuda_ms(lambda: probes.place_runs_plain(src, src_off, dst_off, rows, out=dst),
                           3, warmup=1, device=device)
        view = dst[: nruns * rows].view(nruns, -1)
        library_ms = cuda_ms(lambda: view.index_copy_(0, perm, whole), iters, device=device)
        copied = nruns * chunk
        nbytes = 8 * copied + 8 * nruns
        bound = bound_ms(nbytes)
        ns_run = None if ms is None else ms * 1e6 / nruns
        out.append(dict(run=chunk, rows=rows, runs=nruns, ms=ms, ns_per_run=ns_run,
                        grows=grows(copied, ms), bound_ms=bound, bytes=nbytes,
                        plain_ms=plain_ms, library_ms=library_ms))
        ns = "" if ns_run is None else f", {ns_run:.3f} ns/run"
        _line(smi, f"run = {chunk:>5}: {_rate(grows(copied, ms))} ({nruns} runs{ns},"
                   f" {fmt_ms(ms)}; bound {bound:.5f} ms by bytes{_share(bound, ms)};"
                   f" plain {fmt_ms(plain_ms)}; index_copy_ {fmt_ms(library_ms)})")
    return out


# -- C. histogram ---------------------------------------------------------------


def probe_histogram(n, device, iters=10):
    smi = card(device)
    print(f"\n-- C. histogram (groupby_agg, count only) at n = {n}", flush=True)
    rng = np.random.default_rng(5)
    keys = _u32(rng, n)
    out = []
    for S in BUCKETS:
        bits = S.bit_length() - 1
        gid_h = (keys >> np.uint32(32 - bits)).astype(np.int32)
        gid = torch.from_numpy(gid_h).to(device)
        counts = groupby_agg(gid, n, S)
        _check(counts[0].cpu().numpy().tolist() == np.bincount(gid_h, minlength=S).tolist(),
               f"S = {S}: counts differ from bincount")
        ms = cuda_ms(lambda: groupby_agg(gid, n, S), iters, device=device)
        library_ms = cuda_ms(lambda: torch.bincount(gid, minlength=S), iters, device=device)
        bound = bound_ms(4 * n + 8 * S)
        out.append(dict(buckets=S, ms=ms, grows=grows(n, ms), bound_ms=bound,
                        library_ms=library_ms))
        _line(smi, f"S = {S:>5}: {_rate(grows(n, ms))} ({fmt_ms(ms)}; bound {bound:.5f} ms"
                   f" by bytes{_share(bound, ms)}; bincount {fmt_ms(library_ms)})")
    return out


# -- D. gather --------------------------------------------------------------------


def probe_gather(n, device, iters=10):
    smi = card(device)
    print(f"\n-- D. gather (permutation apply) at n = {n}", flush=True)
    rng = np.random.default_rng(9)
    vals_h = _u32(rng, n).view(np.int32)
    perm_h = rng.permutation(n).astype(np.int32)
    windowed_h = np.sort(perm_h.reshape(-1, min(WINDOW, n)), axis=1).reshape(-1)
    vals = torch.from_numpy(vals_h).to(device)
    out = []
    for label, p_h in (("random permutation", perm_h), ("window-sorted", windowed_h)):
        p = torch.from_numpy(p_h).to(device)
        got = torch.index_select(vals, 0, p)
        sample = slice(0, min(n, 1 << 16))
        _check(got[sample].cpu().numpy().tolist() == vals_h[p_h[sample]].tolist(),
               f"{label}: the gather differs from the host's")
        ms = cuda_ms(lambda: torch.index_select(vals, 0, p), iters, device=device)
        bound = bound_ms(12 * n)  # index and value read once, value written once
        out.append(dict(gather=label, ms=ms, grows=grows(n, ms), bound_ms=bound))
        _line(smi, f"{label:<20} {_rate(grows(n, ms))} ({fmt_ms(ms)}; bound {bound:.5f} ms"
                   f" by bytes{_share(bound, ms)})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="probe_radix")
    ap.add_argument("--quick", action="store_true", help="2^23 elements")
    ap.add_argument("--n", type=int, default=1 << 25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="write the numbers to this file")
    args = ap.parse_args(argv)
    n = (1 << 23) if args.quick else args.n
    if n < 16384 or n % 16384:
        ap.error("n must be a positive multiple of 16384 (the longest run)")
    device = device_of(args.device)
    smi = card(device)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {device}: {smi}", flush=True)
    result = dict(card=smi, n=n, sorts=probe_sorts(n, device),
                  histogram=probe_histogram(n, device), gather=probe_gather(n, device),
                  placement=probe_placement(n, device))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
