"""Plain reference for the TPC-H cells: Q1 and Q6 over the generated
LINEITEM columns, in PyTorch on whatever device the columns are on.

Each function takes the columns (int64 values, int32 dictionary ids),
the dictionaries, and one parameter set of the traffic file, and returns
every group as a tuple of Python values in the query's select order:
str for a key, int for a count or integer sum, float for a mean. Ordering
and LIMIT are the comparison's job. ``low=True`` computes the same
answer one precision below the configuration's (int32 integers, float32
means): the control that the comparison must refuse.
"""

import torch


def _types(low):
    return (torch.int32, torch.float32) if low else (torch.int64, torch.float64)


def _sums(gid, groups, values):
    return torch.zeros(groups, dtype=values.dtype, device=values.device).index_add_(0, gid, values)


def q1(cols, dicts, p, low=False):
    it, ft = _types(low)
    keep = cols["l_shipdate"] <= p["cutoff"]
    n_status = len(dicts["l_linestatus"])
    gid = (cols["l_returnflag"].long() * n_status + cols["l_linestatus"].long())[keep]
    groups = len(dicts["l_returnflag"]) * n_status
    qty, price, disc, tax = (
        cols[c][keep].to(it) for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    count = _sums(gid, groups, torch.ones_like(qty)).tolist()
    s_qty, s_price, s_disc_price, s_charge, s_disc = (
        _sums(gid, groups, v).tolist() for v in (qty, price, disc_price, charge, disc))
    if low:
        # float32 sums and division
        fc = _sums(gid, groups, torch.ones_like(qty).to(ft))
        means = [(_sums(gid, groups, v.to(ft)) / fc).tolist() for v in (qty, price, disc)]
    else:
        # the float64 of the exact sum over the count
        means = [[s / c if c else 0.0 for s, c in zip(v, count)] for v in (s_qty, s_price, s_disc)]
    return [(dicts["l_returnflag"][g // n_status], dicts["l_linestatus"][g % n_status],
             s_qty[g], s_price[g], s_disc_price[g], s_charge[g],
             means[0][g], means[1][g], means[2][g], count[g])
            for g in range(groups) if count[g]]


def q6(cols, dicts, p, low=False):
    it, _ = _types(low)
    ship, disc, qty = cols["l_shipdate"], cols["l_discount"], cols["l_quantity"]
    lo, hi = p["date"]
    d_lo, d_hi = p["disc"]
    keep = (ship >= lo) & (ship < hi) & (disc >= d_lo) & (disc <= d_hi) & (qty < p["quantity"])
    revenue = (cols["l_extendedprice"][keep].to(it) * disc[keep].to(it)).sum(dtype=it)
    return [(int(revenue),)]
