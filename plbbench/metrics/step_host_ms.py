"""Host ms of a batched `VecPlasticineEnv.step` call, without the fetch:
the mean over the window's unprofiled steps of a traced run."""


def read(run):
    r = run.reading
    return r.extra.get("step_host_ms")
