"""Plain reference for the ClickBench cells: Q2, Q7, Q8 and Q9 over the
generated ``hits`` columns, in PyTorch on whatever device the columns are
on. Same interface as the TPC-H reference: every group as a tuple of
Python values in the query's select order; ``low=True`` is the control
(int32 integers, float32 means)."""

import torch


def _types(low):
    return (torch.int32, torch.float32) if low else (torch.int64, torch.float64)


def _means(total_int, count, values, inverse, groups, low):
    if low:
        f = torch.zeros(groups, dtype=torch.float32, device=values.device)
        f.index_add_(0, inverse, values.to(torch.float32))
        return (f / count.to(torch.float32)).tolist()
    return [int(s) / int(c) for s, c in zip(total_int.tolist(), count.tolist())]


def _by_region(cols, low):
    """RegionID values, the inverse index and per-region sums and counts."""
    it, _ = _types(low)
    region, inverse = torch.unique(cols["RegionID"], return_inverse=True)
    groups = region.numel()

    def sums(v):
        return torch.zeros(groups, dtype=it, device=v.device).index_add_(0, inverse, v.to(it))

    return region, inverse, groups, sums


def _distinct_users(cols, inverse, groups):
    """Distinct UserIDs per region: sort by user, then stably by region,
    and count the starts of new (region, user) runs."""
    order = torch.argsort(cols["UserID"], stable=True)
    reg, usr = inverse[order], cols["UserID"][order]
    order = torch.argsort(reg, stable=True)
    reg, usr = reg[order], usr[order]
    new = torch.ones_like(reg, dtype=torch.int64)
    new[1:] = ((reg[1:] != reg[:-1]) | (usr[1:] != usr[:-1])).to(torch.int64)
    return torch.zeros(groups, dtype=torch.int64, device=reg.device).index_add_(0, reg, new)


def q2(cols, dicts, p, low=False):
    it, ft = _types(low)
    adv, width = cols["AdvEngineID"], cols["ResolutionWidth"]
    n = width.numel()
    mean = float(width.to(ft).sum() / n) if low else int(width.sum()) / n
    return [(int(adv.to(it).sum(dtype=it)), n, mean)]


def q7(cols, dicts, p, low=False):
    adv = cols["AdvEngineID"]
    values, counts = torch.unique(adv[adv != 0], return_counts=True)
    return list(zip(values.tolist(), counts.tolist()))


def q8(cols, dicts, p, low=False):
    region, inverse, groups, _ = _by_region(cols, low)
    return list(zip(region.tolist(), _distinct_users(cols, inverse, groups).tolist()))


def q9(cols, dicts, p, low=False):
    region, inverse, groups, sums = _by_region(cols, low)
    count = sums(torch.ones_like(inverse))
    width = cols["ResolutionWidth"]
    means = _means(sums(width), count, width, inverse, groups, low)
    return list(zip(region.tolist(), sums(cols["AdvEngineID"]).tolist(), count.tolist(), means,
                    _distinct_users(cols, inverse, groups).tolist()))
