"""Plain reference for the two-table fixture's ``join_sum``: the inner
join by sorted search of the dimension keys, then sums by group.
``low=True`` is the control (int32 integers)."""

import torch


def join_sum(tables, dicts, p, low=False):
    it = torch.int32 if low else torch.int64
    facts, dims = tables["facts"], tables["dims"]
    keys, order = torch.sort(dims["d_k"])
    at = torch.searchsorted(keys, facts["f_k"]).clamp_(max=keys.numel() - 1)
    keep = (keys[at] == facts["f_k"]) & (facts["f_day"] >= p["day"])
    group = dims["d_grp"].long()[order[at[keep]]]
    n = len(dicts["d_grp"])
    sums = torch.zeros(n, dtype=it, device=group.device).index_add_(0, group, facts["f_v"][keep].to(it)).tolist()
    counts = torch.zeros(n, dtype=torch.int64, device=group.device).index_add_(0, group, torch.ones_like(group)).tolist()
    return [(dicts["d_grp"][g], sums[g], counts[g]) for g in range(n) if counts[g]]
