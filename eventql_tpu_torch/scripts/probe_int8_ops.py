"""Probe: the five int8 forms of scripts/probe_int8_ops.py on the card.

The TPU probe asks which int8 forms its compiler accepts, one kernel a
form over an (8, 128) int32 tile. Here the five forms are one kernel,
``kernels/probes.int8_form``, with the form as a parameter: each runs at
(8, 128) on the TPU probe's own inputs (``arange % 7``, ``arange % 5``)
and on values around +-128 (where int8 wraps), against its plain
version at tolerance 0, then over ``--n`` elements (2^24 by default),
timed beside its plain version, its bound (12 B an element, 8 for
``convert_i32_i8``) and, where one PyTorch call computes the form
(``LIBRARY``), that call.

    python3 -m eventql_tpu_torch.scripts.probe_int8_ops [--n N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from eventql_tpu_torch.kernels import probes
from eventql_tpu_torch.scripts import bound_ms, card, cuda_ms, device_of, fmt_ms

TILE = (8, 128)


def _low_byte(t):
    """The low byte of each int32 as a signed byte: a view (the card and
    the host are little-endian), no copy."""
    return t.view(torch.int8)[..., ::4]


# one PyTorch call that computes a form into an int32 ``out``, where there
# is one: a compare casts to a non-bool ``out``, and int8 operands multiply
# in int8 (wrapping) before the cast. select_i8_value and mul_i32_then_i8
# (the same function) take two: a compare, then a select or a multiply.
LIBRARY = {
    "select_i8_const": ("torch.eq(a, b, out=int32)", lambda a, b, o: torch.eq(a, b, out=o)),
    "muli_i8": ("torch.mul(low bytes of a, low bytes of b, out=int32)",
                lambda a, b, o: torch.mul(_low_byte(a), _low_byte(b), out=o)),
    "convert_i32_i8": ("int32.copy_(low bytes of a)", lambda a, b, o: o.copy_(_low_byte(a))),
}


def probe_inputs(shape, seed):
    """a around +-128 and b equal to a on about half the elements."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-300, 300, shape).astype(np.int32)
    b = np.where(rng.random(shape) < 0.5, a, rng.integers(-300, 300, shape)).astype(np.int32)
    return a, b


def probe_forms(device, n=1 << 24, iters=10):
    smi = card(device)
    tile = np.arange(TILE[0] * TILE[1]).reshape(TILE)
    tiles = [("the probe's tile", tile % 7, tile % 5), ("+-128 tile", *probe_inputs(TILE, 11))]
    tiles = [(label, torch.from_numpy(a.astype(np.int32)).to(device),
              torch.from_numpy(b.astype(np.int32)).to(device)) for label, a, b in tiles]
    a_big, b_big = (torch.from_numpy(x).to(device) for x in probe_inputs(n, 12))
    out = {}
    for case in probes.INT8_CASES:
        for label, a, b in tiles + [(f"{n} elements", a_big, b_big)]:
            got = probes.int8_form(a, b, case)
            want = probes.int8_form_plain(a, b, case)
            if not torch.equal(got, want):
                raise AssertionError(f"probe_int8_ops: {case} on {label}: the kernel and its"
                                     f" plain version differ")
        sample = probes.int8_form(tiles[0][1], tiles[0][2], case)[0, :4].tolist()
        ms = cuda_ms(lambda: probes.int8_form(a_big, b_big, case), iters, device=device)
        plain_ms = cuda_ms(lambda: probes.int8_form_plain(a_big, b_big, case), 3,
                           warmup=1, device=device)
        library, library_ms = "none: no single call computes the form", None
        if case in LIBRARY:
            library, call = LIBRARY[case]
            buf = torch.empty_like(a_big)
            if not torch.equal(call(a_big, b_big, buf), probes.int8_form(a_big, b_big, case)):
                raise AssertionError(f"probe_int8_ops: {case}: {library} and the kernel differ")
            library_ms = cuda_ms(lambda: call(a_big, b_big, buf), iters, device=device)
        nbytes = probes.int8_form_bytes(case, n)
        bound = bound_ms(nbytes)
        out[case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=library_ms,
                         library=library, bytes=nbytes, n=n, sample=sample)
        share = "" if ms is None else f", {bound / ms:.2f} of it"
        print(f"{case}: OK  sample={sample}; {n} elements {fmt_ms(ms)} (bound {bound:.5f} ms"
              f" by bytes{share}; plain {fmt_ms(plain_ms)}; library {library}"
              f"{'' if library_ms is None else ' ' + fmt_ms(library_ms)}) [{smi}]", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="probe_int8_ops")
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return probe_forms(device_of(args.device), args.n)


if __name__ == "__main__":
    main(sys.argv[1:])
