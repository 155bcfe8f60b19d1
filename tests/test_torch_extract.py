"""kernels/extract.py of the port against the JAX package's Pallas
stream-compaction kernel.

The same int32 values (made with numpy from a seed) go through
``eventql_tpu.kernels.extract.extract_ge`` (its Pallas kernel in
interpret mode, as on any CPU backend) and through the port's
``extract_ge``, which on a CPU tensor is its plain PyTorch version.
Tolerance: exact equality of the int32 index arrays.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventql_tpu.kernels.extract import extract_ge as jax_extract_ge
from eventql_tpu_torch.kernels import extract as ex

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import extract_cases  # noqa: E402  (torch only, no jax)

# the kernel's tile edges: one row either side of one and of two tiles
T = ex.TILE_ROWS
SIZES = [1, T - 1, T, T + 1, 2 * T - 1, 2 * T, 2 * T + 1, 50_000]
N_CASES = 17


def _case(n, i):
    cases = list(extract_cases(n, np.random.default_rng(100 + n)))
    assert len(cases) == N_CASES
    return cases[i]


def _reference(values, threshold, cap, rows):
    """The contract, written out in numpy."""
    rows = len(values) if rows is None else rows
    idx = np.nonzero(values[:rows] >= threshold)[0][:cap]
    out = np.full(cap, -1, np.int32)
    out[: len(idx)] = idx
    return out


@pytest.mark.parametrize("i", range(N_CASES))
@pytest.mark.parametrize("n", SIZES)
def test_extract_ge_matches_jax_kernel(n, i):
    label, values, threshold, cap, rows = _case(n, i)
    got = ex.extract_ge(torch.from_numpy(values), threshold, cap, rows)
    assert got.dtype == torch.int32 and got.shape == (cap,)
    assert (got.numpy() == _reference(values, threshold, cap, rows)).all(), label
    # the JAX kernel has no row count of its own: it sees the prefix
    seen = values if rows is None else values[:rows]
    want = np.asarray(jax_extract_ge(jnp.asarray(seen), jnp.int32(threshold), cap))
    assert (got.numpy() == want).all(), label


@pytest.mark.parametrize("i", range(N_CASES))
def test_extract_ge_plain_equals_wrapper_on_cpu(i):
    label, values, threshold, cap, rows = _case(20_003, i)
    v = torch.from_numpy(values)
    before = dict(ex.LAUNCHES)
    assert torch.equal(
        ex.extract_ge(v, threshold, cap, rows),
        ex.extract_ge_plain(v, threshold, cap, rows),
    ), label
    assert ex.LAUNCHES == before  # a CPU tensor launches nothing


def test_extract_ge_empty_prefix():
    v = torch.arange(10, dtype=torch.int32)
    assert ex.extract_ge(v, 0, 4, n=0).tolist() == [-1, -1, -1, -1]


@pytest.mark.parametrize(
    "values, threshold, cap, n, error",
    [
        (torch.zeros(4, dtype=torch.int64), 0, 2, None, TypeError),
        (torch.zeros((2, 2), dtype=torch.int32), 0, 2, None, ValueError),
        (torch.zeros(8, dtype=torch.int32)[::2], 0, 2, None, ValueError),
        (torch.zeros(4, dtype=torch.int32), 0, 0, None, ValueError),
        (torch.zeros(4, dtype=torch.int32), 0, 2, 5, ValueError),
        (torch.zeros(4, dtype=torch.int32), 1 << 31, 2, None, ValueError),
    ],
)
def test_extract_ge_refuses_what_the_kernel_does_not_take(
    values, threshold, cap, n, error
):
    for fn in (ex.extract_ge, ex.extract_ge_plain):
        with pytest.raises(error):
            fn(values, threshold, cap, n)
