"""The program's device-memory peak (torch.cuda.max_memory_allocated,
counted from after the data was generated and copied to the host) over
the rows of the cell's tables."""


def read(run):
    return run.peak_bytes / run.table_rows
