"""Rows of the tables scanned by the window's completed queries, over the
window's seconds (first send to last answer)."""


def read(run):
    return sum(q["rows"] for q in run.queries) / run.window_s
