"""Probe: the int8-plane sum/count probe's function on the card.

The counterpart of scripts/probe_groupby_i8.py, whose ``sum_count_i8``
computes B1's contract (an exact count and a u64 sum of the low
``value_bits`` of each value per bucket, rows under a mask) with int8
one-hot and limb planes on the TPU's MXU. That is a TPU workaround; on
the card the same function is ``groupby_agg`` (kernels/groupby_agg.py).
This probe checks it against numpy on the TPU probe's own shape (2^24
rows, K = 1024 buckets, values < 1000, the mask ``values < 800``) and
times it beside ``index_add_`` on int64 (sums only, no mask, no count:
the library yardstick) and its plain version, each beside its bound.

    python3 -m eventql_tpu_torch.scripts.probe_groupby_i8 [--rows N] [--keys K]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from eventql_tpu_torch.kernels.groupby_agg import groupby_agg, groupby_agg_plain
from eventql_tpu_torch.scripts import bound_ms, card, cuda_ms, device_of, fmt_ms


def probe_sum_count(n, n_keys, device, iters=10):
    smi = card(device)
    rng = np.random.default_rng(42)
    gid_h = rng.integers(0, n_keys, n).astype(np.int32)
    values_h = rng.integers(0, 1000, n).astype(np.uint64)
    mask_h = values_h < 800
    # the TPU probe's width: the values' bits plus one, in whole bytes
    value_bits = max(8, int(values_h.max()).bit_length() + 1)
    value_bits = -(-value_bits // 8) * 8
    want_counts = np.bincount(gid_h[mask_h], minlength=n_keys)
    want_sums = np.bincount(gid_h[mask_h], weights=values_h[mask_h].astype(np.float64),
                            minlength=n_keys).astype(np.uint64)
    gid = torch.from_numpy(gid_h).to(device)
    values = torch.from_numpy(values_h.view(np.int64)).to(device)
    mask = torch.from_numpy(mask_h).to(device)

    def call():
        return groupby_agg(gid, n, n_keys, values=values, value_bits=value_bits, mask=mask)

    got = call().cpu().numpy()
    counts_ok = got[0].tolist() == want_counts.tolist()
    sums_ok = got[1].view(np.uint64).tolist() == want_sums.tolist()
    print(f"groupby_agg counts exact: {counts_ok} sums exact: {sums_ok}"
          f" (n = {n}, K = {n_keys}, value_bits = {value_bits}) [{smi}]", flush=True)
    if not (counts_ok and sums_ok):
        raise AssertionError("probe_groupby_i8: groupby_agg differs from numpy")
    ms = cuda_ms(call, iters, device=device)
    plain_ms = cuda_ms(lambda: groupby_agg_plain(gid, n, n_keys, values=values,
                                                 value_bits=value_bits, mask=mask),
                       3, warmup=1, device=device)
    idx64 = gid.to(torch.int64)
    acc = torch.zeros(n_keys, dtype=torch.int64, device=device)
    library_ms = cuda_ms(lambda: acc.index_add_(0, idx64, values), iters, device=device)
    nbytes = n * (4 + 8 + 1) + 2 * 8 * n_keys  # key, value, mask read; counts, sums written
    bound = bound_ms(nbytes)
    rate = "" if ms is None else f", {n / ms / 1e6:.2f} Grows/s, {bound / ms:.2f} of the bound"
    print(f"groupby_agg: {fmt_ms(ms)}{rate}; bound {bound:.5f} ms by bytes; plain"
          f" {fmt_ms(plain_ms)}; index_add_ (int64, sums only, no mask) {fmt_ms(library_ms)}"
          f" [{smi}]", flush=True)
    return dict(card=smi, rows=n, keys=n_keys, value_bits=value_bits, exact=True, ms=ms,
                bound_ms=bound, bytes=nbytes, plain_ms=plain_ms, library_ms=library_ms)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="probe_groupby_i8")
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--keys", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return probe_sum_count(args.rows, args.keys, device_of(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
