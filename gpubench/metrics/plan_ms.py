"""Mean milliseconds a window query spends in Runtime.build_query_plan
(a plan-cache hit after warm-up), by the benchmark's span around it."""


def read(run):
    return 1e3 * sum(q["plan_s"] for q in run.queries) / len(run.queries)
