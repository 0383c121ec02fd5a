"""`torch.cuda.max_memory_allocated()` over set-up and window, GiB."""


def read(run):
    return run.outcome["peak_bytes"] / 2 ** 30 if run.outcome["peak_bytes"] else None
