"""The one traffic generator: turns a traffic file and a seed into the
cell's query instances and the order the client sends them in.

A traffic file (``traffic/<cell>.json``) holds query templates, the
parameters to draw for them and the client's order. Parameters are drawn
with Python's ``random.Random(seed)``: an ``{"int": [lo, hi]}`` range or a
``{"choice": [...]}`` list, ``"distinct": true`` to draw the sets without
replacement. Each parameter set fills every template
(``str.format``), in the file's order.
"""

import random


def _draw(spec, rng):
    n = spec["parameter_sets"]
    sets = [{} for _ in range(n)]
    for name, p in spec["parameters"].items():
        pool = list(range(p["int"][0], p["int"][1] + 1)) if "int" in p else p["choice"]
        values = rng.sample(pool, n) if p.get("distinct") else [rng.choice(pool) for _ in range(n)]
        for s, v in zip(sets, values):
            s[name] = v
    return sets


def plan(spec, seed):
    """Return (instances, order): every (parameter set, template) pair as a
    dict with ``shape``, ``sql``, ``params`` and ``query`` (the template),
    and an endless iterator of instance indices in the client's order."""
    rng = random.Random(seed)
    instances = [
        {"shape": q["shape"], "sql": q["sql"].format(**params), "params": params, "query": q}
        for params in _draw(spec, rng)
        for q in spec["queries"]
    ]
    how = spec["client"]["order"]
    if how not in ("cycle", "shuffle_each_round"):
        raise ValueError(f"unknown client order {how!r}")

    def order():
        ids = list(range(len(instances)))
        round_ = rng.sample(ids, len(ids))
        while True:
            yield from round_
            if how == "shuffle_each_round":
                round_ = rng.sample(ids, len(ids))

    return instances, order()
