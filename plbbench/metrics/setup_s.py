"""Process start to the first timed step: imports, library load (its build
in a checkout's first run), scene, envs and warm-up."""


def read(run):
    return run.outcome["setup_s"]
