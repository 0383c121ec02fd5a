"""The profiled steps' physics least time (`roofline.env_step_least_s`) as
a share of the device's busy time in their span, in %."""


def read(run):
    r = run.reading
    least = r.extra.get("physics_least_s")
    return 100.0 * least / r.busy_s if least and r.busy_s > 0 else None
