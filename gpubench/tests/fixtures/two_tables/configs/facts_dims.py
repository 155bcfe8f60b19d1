"""Generator of the two-table test fixture: a fact table whose key column
refers to a dimension table's distinct keys (a share of the fact rows to
none), as the configuration file's ``assumed`` says."""

import torch

_MASK63 = (1 << 63) - 1
_MUL = 0x1E3779B97F4A7C15


def key(index):
    """Distinct positive 63-bit keys of distinct non-negative indices."""
    x = (index + 1) * _MUL & _MASK63
    return x ^ (x >> 29)


def generate(cfg, seed, device):
    """Return {"facts": {...}, "dims": {...}} drawn from ``seed`` on ``device``
    (int64 values, int32 dictionary ids)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, d = cfg["facts"], cfg["dims"]
    spec = {c["name"]: c for cols in cfg["tables"].values() for c in cols}

    def draw(name, k):
        lo, hi = spec[name]["range"]
        return torch.randint(lo, hi + 1, (k,), generator=g, device=device)

    index = torch.randint(0, d, (n,), generator=g, device=device)
    miss = torch.rand(n, generator=g, device=device) < cfg["miss_share"]
    groups = len(spec["d_grp"]["values"])
    return {
        "facts": {
            "f_k": key(torch.where(miss, index + d, index)),
            "f_v": draw("f_v", n),
            "f_w": draw("f_w", n),
            "f_day": draw("f_day", n),
        },
        "dims": {
            "d_k": key(torch.randperm(d, generator=g, device=device)),
            "d_grp": torch.randint(0, groups, (d,), generator=g, device=device).to(torch.int32),
        },
    }
