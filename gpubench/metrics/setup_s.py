"""Seconds from the process's start to the first timed query."""


def read(run):
    return run.setup_s
