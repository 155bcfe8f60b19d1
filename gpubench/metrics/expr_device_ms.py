"""Device milliseconds a query of the kernels that layers.json does not
list as the port's hand-written ones: PyTorch's own kernels, which
exec/torch_expr.py's expression passes launch (and any other library
call on the path). Copies and memsets are not counted."""


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.kernel_seconds(run.layers["kernels"]["kernels"], listed=False)
    return 1e3 * secs / len(run.queries)
