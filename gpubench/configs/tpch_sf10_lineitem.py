"""Generator of TPC-H LINEITEM at a scale factor, by clause 4.2.3's rules.

Only the seven columns TPC-H Q1 and Q6 read are returned. Orders, part
keys and receipt dates are drawn here and dropped. Decimals are integer
hundredths, dates are days since 1970-01-01, and the two flags are
dictionary ids into the configuration's sorted value lists.
"""

import torch


def generate(cfg, seed, device):
    """Return {"lineitem": {column: tensor}} drawn from ``seed`` on ``device``
    (int64 values, int32 dictionary ids for the flags)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def draw(lo_hi, n):
        lo, hi = lo_hi
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    n_orders = cfg["orders"]
    lines = draw(cfg["lines_per_order"], n_orders)
    order_date = torch.repeat_interleave(draw(cfg["order_date_days"], n_orders), lines)
    del lines
    n = order_date.numel()
    ship = order_date + draw(cfg["ship_after_order_days"], n)
    del order_date
    receipt = ship + draw(cfg["receipt_after_ship_days"], n)
    quantity = draw(cfg["quantity"], n)
    part = draw([1, cfg["part_keys"]], n)
    # P_RETAILPRICE in cents (clause 4.2.3): 90000 + ((key / 10) mod 20001)
    # + 100 * (key mod 1000), over 100 for dollars
    retail = 90000 + torch.remainder(part // 10, 20001) + 100 * torch.remainder(part, 1000)
    del part
    price = quantity * retail
    del retail
    today = cfg["current_date_day"]
    # ids into ["A", "N", "R"]: R or A at random once received, else N
    returned = torch.randint(0, 2, (n,), generator=g, device=device) * 2
    returnflag = torch.where(receipt <= today, returned, 1).to(torch.int32)
    del returned, receipt
    # ids into ["F", "O"]
    linestatus = (ship > today).to(torch.int32)
    return {
        "lineitem": {
            "l_quantity": quantity,
            "l_extendedprice": price,
            "l_discount": draw(cfg["discount_hundredths"], n),
            "l_tax": draw(cfg["tax_hundredths"], n),
            "l_shipdate": ship,
            "l_returnflag": returnflag,
            "l_linestatus": linestatus,
        }
    }
