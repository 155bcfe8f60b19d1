"""Generator of ClickBench's ``hits`` table, restricted to the four columns
that queries Q2, Q7, Q8 and Q9 read. The distributions are the ones the
configuration file lists under ``assumed``."""

import torch

_MASK63 = (1 << 63) - 1
# multipliers of a bijection on [0, 2^63) (odd, so invertible mod 2^63)
_MUL1 = 0x1E3779B97F4A7C15
_MUL2 = 0x3F58476D1CE4E5B9


def user_id(rank):
    """Map user ranks (distinct, >= 0) to distinct positive 63-bit UserIDs."""
    x = (rank + 1) * _MUL1 & _MASK63
    x = x ^ (x >> 29)
    x = x * _MUL2 & _MASK63
    return x ^ (x >> 32)


def _zipf_cdf(count, exponent, device):
    w = torch.arange(1, count + 1, dtype=torch.float64, device=device).pow(-exponent)
    return torch.cumsum(w, 0) / w.sum()


def _pick(cdf, u):
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def generate(cfg, seed, device):
    """Return {"hits": {column: int64 tensor}} drawn from ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, users = cfg["rows"], cfg["distinct_users"]

    def uniform(k):
        return torch.rand(k, generator=g, device=device, dtype=torch.float64)

    # every user once, the rest by rank r = floor(U * v^(1 / (1 - a)))
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[:users] = torch.arange(users, device=device)
    power = 1.0 / (1.0 - cfg["user_rank_exponent"])
    rank[users:] = (uniform(n - users).pow_(power) * users).to(torch.int64).clamp_(max=users - 1)
    rank = rank[torch.randperm(n, generator=g, device=device)]

    home = _pick(_zipf_cdf(cfg["regions"], cfg["region_zipf_exponent"], device), uniform(users))
    home = 1 + torch.remainder(home * cfg["region_id_stride"], cfg["region_id_modulus"])
    region = home[rank]
    del home

    engines = torch.tensor(cfg["adv_engine_ids"], dtype=torch.int64, device=device)
    engine = engines[_pick(_zipf_cdf(len(engines), cfg["adv_zipf_exponent"], device), uniform(n))]
    adv = torch.where(uniform(n) < cfg["adv_nonzero_share"], engine, 0)
    del engine

    weights = torch.tensor(cfg["resolution_weights"], dtype=torch.float64, device=device)
    widths = torch.tensor(cfg["resolution_widths"], dtype=torch.int64, device=device)
    width = widths[_pick(torch.cumsum(weights, 0) / weights.sum(), uniform(n))]
    return {
        "hits": {
            "AdvEngineID": adv,
            "ResolutionWidth": width,
            "RegionID": region,
            "UserID": user_id(rank),
        }
    }
