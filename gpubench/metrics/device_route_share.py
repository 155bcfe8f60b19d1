"""Share of the window's queries that a device route served: the deltas
of the route counters that layers.json lists under "routes", over the
number of queries."""


def read(run):
    routed = sum(run.counters.get(name, 0) for name in run.layers["routes"]["counters"])
    return 100.0 * routed / len(run.queries)
