"""Milliseconds a query in which the device was idle: the traced window
less the union of device activity, over the queries."""


def read(run):
    if run.trace is None:
        return None
    return 1e3 * (run.trace.window_s - run.trace.busy_s) / len(run.queries)
