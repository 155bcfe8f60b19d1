"""Milliseconds of the first warm-up pass (each of the cell's query texts
once, in the cell's order), which uploads the columns to the card."""


def read(run):
    return 1e3 * run.first_pass_s
