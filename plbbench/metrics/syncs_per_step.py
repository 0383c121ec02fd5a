"""Host waits on the device (the profiler's *Synchronize runtime calls)
per profiled batched step, its fetch included."""


def read(run):
    r = run.reading
    return r.syncs / r.steps if r.steps and r.device_ops else None
