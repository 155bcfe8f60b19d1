"""Order-preserving 64-bit keys for device sorts and group keys.

The counterpart of eventql_tpu/kernels/groupby.py; of that module only
``sortable_u64`` and ``f64_sort_bits`` are here so far (the ORDER BY
routes need them), the sort-based grouped aggregation is not.

torch cannot compute with its unsigned types, so a uint64 key is the
int64 tensor of the same 64 bits: ``~k``, ``k - lo``, ``k == 0`` and
xor are the same on both, shifts need ``(k >> s) & mask``, and the
unsigned order of two keys is the signed order of ``k ^ (1 << 63)``
(kernels/sort.py sorts that way). An unsigned input column arrives the
same way, as the signed tensor of its width, and is named by the
``unsigned`` flag.
"""

from __future__ import annotations

import torch

_SIGN = -(1 << 63)  # int64 with only the top bit set


def f64_sort_bits(data: torch.Tensor) -> torch.Tensor:
    """float64 -> u64 keys (int64 bit patterns) whose unsigned ascending
    order equals the float order, and whose equality is bit equality:
    the IEEE-754 total-order trick on the value's own bits."""
    bits = data.contiguous().view(torch.int64)
    return torch.where(bits < 0, ~bits, bits ^ _SIGN)


def sortable_u64(
    data: torch.Tensor, descending: bool = False, unsigned: bool = False
) -> torch.Tensor:
    """Map a column to u64 keys (int64 bit patterns) whose unsigned
    order equals the SQL order of the values: 64-bit unsigned and bool
    are the identity, floats take the total-order trick, and every other
    integer goes through int64 with the sign bit flipped (a narrow
    unsigned payload zero-extends first), so narrow values keep their
    numeric order."""
    if data.dtype == torch.float64:
        k = f64_sort_bits(data)
    elif data.dtype in (torch.bool, torch.uint8):
        k = data.to(torch.int64)
    elif data.dtype == torch.int64:
        k = data if unsigned else data ^ _SIGN
    elif data.dtype in (torch.int32, torch.int16):
        k = data.to(torch.int64)
        if unsigned:
            k = k & ((1 << (8 * data.element_size())) - 1)
        k = k ^ _SIGN
    else:
        raise TypeError(f"no sortable key for dtype {data.dtype}")
    if descending:
        k = ~k
    return k
