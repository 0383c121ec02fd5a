"""Env steps completed per second: B x the batched steps of the window,
each ended by its host fetch, over the window's seconds (resets included)."""


def read(run):
    o = run.outcome
    return o["batch"] * o["steps"] / o["window_s"] if o["steps"] else None
