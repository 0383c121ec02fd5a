"""Share of the profiled steps' span in which no device operation runs, %."""


def read(run):
    r = run.reading
    return 100.0 * (1.0 - r.busy_s / r.span_s) if r.busy_s > 0 and r.span_s > 0 else None
