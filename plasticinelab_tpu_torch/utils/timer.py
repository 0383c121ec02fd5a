"""Wall-clock context-manager timer (counterpart of
`plasticinelab_tpu/utils/timer.py`; behavioral reference plb/utils/timer.py).
Work queued on a CUDA device is not waited for: callers that time device
work synchronise inside the block."""
from __future__ import annotations

import time


class Timer:
    """`with Timer(name) as t: ...` leaves the block's seconds in
    `t.elapsed` and, with `print_on_exit`, prints "{name}: {elapsed}s"."""

    def __init__(self, name: str = "", print_on_exit: bool = True):
        self.name = name
        self.print_on_exit = print_on_exit
        self.elapsed = None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if self.print_on_exit:
            print(f"{self.name}: {self.elapsed:.6f}s")
        return False
