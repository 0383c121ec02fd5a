"""Device kernels, copies and memsets per profiled batched step."""


def read(run):
    r = run.reading
    return r.device_ops / r.steps if r.steps and r.device_ops else None
