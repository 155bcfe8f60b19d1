"""The window's logical bytes at the card's peak bandwidth, over the
device's busy time: the share of the HBM roofline the queries reach.

A query's logical bytes are every column it reads, once, at the
narrowest width that holds the generated column's span, plus its result
once (8 bytes a cell). The benchmark counts them from the data, so they
do not move with the implementation."""


def read(run):
    if run.trace is None or run.peak_bandwidth is None or run.trace.busy_s <= 0:
        return None
    floor_s = sum(q["bytes"] for q in run.queries) / run.peak_bandwidth
    return 100.0 * floor_s / run.trace.busy_s
