"""Plain reference for the two-table fixture's ``join_mean``, in a file of
its own: the inner join by a Python dictionary of the dimension keys,
then the float64 of each group's exact sum over its count. ``low=True``
is the control (float32 sums and division)."""

import torch


def join_mean(tables, dicts, p, low=False):
    facts, dims = tables["facts"], tables["dims"]
    group_of = dict(zip(dims["d_k"].tolist(), dims["d_grp"].tolist()))
    rows = [(group_of[k], w) for k, w, day in zip(*(facts[c].tolist() for c in ("f_k", "f_w", "f_day")))
            if k in group_of and day < p["day"]]
    n = len(dicts["d_grp"])
    counts = [0] * n
    for g, _ in rows:
        counts[g] += 1
    if low:
        group = torch.tensor([g for g, _ in rows], dtype=torch.int64)
        values = torch.tensor([w for _, w in rows], dtype=torch.float32)
        sums = torch.zeros(n, dtype=torch.float32).index_add_(0, group, values)
        means = (sums / torch.tensor(counts, dtype=torch.float32)).tolist()
    else:
        sums = [0] * n
        for g, w in rows:
            sums[g] += w
        means = [s / c if c else 0.0 for s, c in zip(sums, counts)]
    return [(dicts["d_grp"][g], means[g], counts[g]) for g in range(n) if counts[g]]
