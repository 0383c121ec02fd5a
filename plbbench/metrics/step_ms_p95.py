"""95th percentile of the window's batched-step latencies, from the call to
`step` to the host holding its results, ms."""
import numpy as np


def read(run):
    lat = run.outcome["latencies"]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
