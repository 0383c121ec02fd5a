"""Wall-clock context-manager timer (counterpart of
`plasticinelab_tpu/utils/timer.py`; behavioral reference plb/utils/timer.py).
Work queued on a CUDA device is not waited for: callers that time device
work synchronise inside the block."""
from __future__ import annotations

import time


class Timer:
    """`with Timer() as t: ...` leaves the block's seconds in `t.elapsed`."""

    elapsed = None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
