"""Device milliseconds a query of the port's hand-written CUDA kernels,
by the __global__ names that layers.json lists under "kernels"."""


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.kernel_seconds(run.layers["kernels"]["kernels"], listed=True)
    return 1e3 * secs / len(run.queries)
