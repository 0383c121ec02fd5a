"""Device ms of one batched observation pass of the rgb env (the env's
observation function on the profiled steps' last state)."""


def read(run):
    r = run.reading
    return r.observe_device_s * 1e3 if r.observe_device_s else None
