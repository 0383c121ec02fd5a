"""Reading a traced run's profile by the program's own spans.

The port marks its layers with spans named `plb.<layer>` (its
`utils/profiling.py`), torch.profiler annotations on the host's main thread
that nest as the calls do. `reduce` reads the same events as
`tracing.reduce`, in the same profiled steps (`plbbench.step`), and puts
each piece of work down to the spans open around it:

- a device operation (kernel, copy, memset) to the spans open when the host
  launched it: its runtime call (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...)
  is the host event with the operation's `correlation_id()`;
- a host wait on the device (`*Synchronize`) to the spans open at its start;
- a span's own host time to its name.

A span's numbers include those of the spans inside it. `metrics` turns a
reading into the per-layer numbers of the steps, per step; `counted`, the
difference of two `profiling.snapshot()`s taken around the steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tracing import STEP, _is_device, _union

PREFIX = "plb."
LAUNCH_GROUPS = ("cuda_stress", "cuda_transfer", "cuda_gridop", "cuda_voxelize")


@dataclass
class SpanReading:
    steps: int = 0
    busy_s: float = 0.0        # union of the steps' device operations, as tracing.reduce
    attributed_s: float = 0.0  # union of those launched inside some span
    host_s: Dict[str, float] = field(default_factory=dict)    # span name -> host time
    spans: Dict[str, int] = field(default_factory=dict)       # span name -> count
    device_s: Dict[str, float] = field(default_factory=dict)  # span name -> device union
    syncs: Dict[str, int] = field(default_factory=dict)       # span name -> host waits
    unattributed: List[Tuple[str, float]] = field(default_factory=list)  # op name -> s


class _Open:
    """The spans open at each of a rising series of times: a sweep over
    spans (start, end, name) in start order that keeps the open ones, which
    nest, on a stack."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.stack: list = []
        self.i = 0

    def at(self, t) -> list:
        while self.i < len(self.spans) and self.spans[self.i][0] <= t:
            nxt = self.spans[self.i]
            while self.stack and self.stack[-1][1] <= nxt[0]:
                self.stack.pop()
            self.stack.append(nxt)
            self.i += 1
        while self.stack and self.stack[-1][1] < t:
            self.stack.pop()
        return self.stack


def reduce(events, top: int = 10) -> SpanReading:
    """`prof.profiler.kineto_results.events()` -> SpanReading (times in s)."""
    host, device, threads, runtime_at = [], [], {}, {}
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        name = ev.name()
        if _is_device(ev):
            if not ev.is_user_annotation() and not name.startswith(("plbbench.", PREFIX)):
                device.append((start, end, name, ev.correlation_id()))
            continue
        host.append((start, end, name))
        threads.setdefault(ev.start_thread_id(), []).append(host[-1])
        if name.startswith("cu"):   # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...
            runtime_at[ev.correlation_id()] = start
    steps = [(s, e) for s, e, n in host if n == STEP]
    r = SpanReading(steps=len(steps))
    if not steps:
        return r
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    main = next(t for t in threads.values() if any(n == STEP for _, _, n in t))
    spans = [h for h in main if h[2].startswith(PREFIX) and lo <= h[0] < hi]
    for s, e, n in spans:
        r.host_s[n] = r.host_s.get(n, 0.0) + (min(e, hi) - s) * 1e-9
        r.spans[n] = r.spans.get(n, 0) + 1

    inside = [d for d in device if lo <= d[0] < hi]
    r.busy_s = _union([(s, min(e, hi)) for s, e, *_ in inside])[0] * 1e-9
    launched, unattributed = [], {}
    for s, e, n, corr in inside:
        t = runtime_at.get(corr)
        if t is None:
            unattributed[n] = unattributed.get(n, 0) + (min(e, hi) - s)
        else:
            launched.append((t, (s, min(e, hi))))
    by_span: Dict[str, list] = {}
    open_ = _Open(spans)
    attributed = []
    for t, interval in sorted(launched):
        names = {n for _, _, n in open_.at(t)}
        if names:
            attributed.append(interval)
        for n in names:
            by_span.setdefault(n, []).append(interval)
    r.attributed_s = _union(attributed)[0] * 1e-9
    r.device_s = {n: _union(iv)[0] * 1e-9 for n, iv in by_span.items()}
    r.unattributed = [(n, t * 1e-9) for n, t in
                      sorted(unattributed.items(), key=lambda kv: -kv[1])[:top]]

    waits = sorted(s for s, _, n in host if lo <= s < hi and "Synchronize" in n)
    open_ = _Open(spans)
    for t in waits:
        for n in {n for _, _, n in open_.at(t)}:
            r.syncs[n] = r.syncs.get(n, 0) + 1
    return r


def metrics(r: SpanReading) -> Dict[str, Optional[float]]:
    """The per-layer numbers of the profiled steps, per step (None where the
    profile holds no such span)."""
    if not r.steps:
        return {}

    def per_step(d, name, scale=1.0):
        return d[name] * scale / r.steps if name in d else None

    kernels = [t for n, t in r.host_s.items() if n.startswith(PREFIX + "kernel.")]
    return {
        "physics_host_ms": per_step(r.host_s, "plb.physics", 1e3),
        "physics_device_ms": per_step(r.device_s, "plb.physics", 1e3),
        "physics_syncs_per_step": (r.syncs.get("plb.physics", 0) / r.steps
                                   if "plb.physics" in r.spans else None),
        "kernel_host_ms": sum(kernels) * 1e3 / r.steps if kernels else None,
        "observe_host_ms": per_step(r.host_s, "plb.observe", 1e3),
        "render_march_device_ms": per_step(r.device_s, "plb.render.march", 1e3),
        "attributed_share": 100.0 * r.attributed_s / r.busy_s if r.busy_s > 0 else None,
    }


def counted(before: Dict[str, int], after: Dict[str, int], steps: int) -> Dict[str, float]:
    """Kernel launches and march steps per step from two
    `profiling.snapshot()`s taken around `steps` steps."""
    def diff(keys):
        return sum(after[k] - before.get(k, 0) for k in keys)

    launches = [k for k in after if k.split(".")[0] in LAUNCH_GROUPS]
    out = {"kernel_launches_per_step": diff(launches) / steps}
    if "render.march_iters" in after:
        out["render_march_iters_per_step"] = diff(["render.march_iters"]) / steps
    return out
