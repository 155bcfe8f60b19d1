"""The 95th percentile (nearest rank) of every window query's latency:
send to formatted rows, after a device synchronise."""

import math


def read(run):
    lat = sorted(q["latency_s"] for q in run.queries)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
