"""Sizes that a CPU test run holds: a few thousand rows a table."""

TINY = {
    "tpch_sf10_lineitem": {"orders": 3000},
    "clickbench_hits": {"rows": 20000, "distinct_users": 3500, "regions": 60},
}
CELLS = ("tpch_q1", "tpch_q6", "hits_dashboard")
CONFIGS = ("tpch_sf10_lineitem", "clickbench_hits")


def sizes(cell):
    from gpubench import harness

    return TINY[harness.Cell(cell).workload["config"]]
