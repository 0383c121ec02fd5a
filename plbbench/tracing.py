"""Reading torch.profiler's trace of a traced run's profiled steps.

The harness profiles a fixed number of consecutive batched steps, each
under a `plbbench.step` annotation (the call and the host fetch), and then
one observation pass under `plbbench.observe`. `reduce` turns the raw
events into a `Reading`: the device's busy time and operations in the
span of the steps, the host's synchronisations there, the idle gaps
labelled by what the host was doing, and the observation pass's device
time. The per-layer metric readers read only a `Reading`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

STEP = "plbbench.step"
OBSERVE = "plbbench.observe"


@dataclass
class Reading:
    steps: int = 0                       # profiled batched steps
    span_s: float = 0.0                  # first step's call to last step's fetch
    busy_s: float = 0.0                  # union of device operations in the span
    device_ops: int = 0                  # kernels, copies and memsets in the span
    syncs: int = 0                       # host waits on the device in the span
    observe_device_s: Optional[float] = None
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    extra: Dict[str, float] = field(default_factory=dict)   # filled by the harness


def _union(intervals):
    """Total length and the gaps of a list of (start, end)."""
    total, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def reduce(events, top: int = 10) -> Reading:
    """`prof.profiler.kineto_results.events()` -> Reading (all times in s)."""
    host, device, threads = [], [], {}
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if _is_device(ev):
            # annotations mirrored onto the device's timeline are no work
            if not ev.is_user_annotation() and ev.name() not in (STEP, OBSERVE):
                device.append((start, end, ev.name()))
        else:
            host.append((start, end, ev.name()))
            threads.setdefault(ev.start_thread_id(), []).append(host[-1])
    steps = [(s, e) for s, e, n in host if n == STEP]
    r = Reading(steps=len(steps))
    if not steps:
        return r
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    r.span_s = (hi - lo) * 1e-9
    inside = [(s, e, n) for s, e, n in device if lo <= s < hi]
    r.device_ops = len(inside)
    busy, gaps = _union([(s, min(e, hi)) for s, e, _ in inside])
    r.busy_s = busy * 1e-9
    r.syncs = sum(1 for s, _, n in host if lo <= s < hi and "Synchronize" in n)
    by_name: Dict[str, int] = {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    r.top_ops = [(n, t * 1e-9) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    # gaps before the first and after the last operation count as idle too
    edges = sorted((s, e) for s, e, _ in inside)
    if edges:
        gaps = [(lo, edges[0][0])] + gaps + [(max(e for _, e in edges), hi)]
    else:
        gaps = [(lo, hi)]
    main = next(t for t in threads.values() if any(n == STEP for _, _, n in t))
    r.idle_gaps = _label_gaps([g for g in gaps if g[1] > g[0]], main, top)
    obs = [(s, e) for s, e, n in host if n == OBSERVE]
    if obs:
        os_, oe = obs[0]
        ops = [(s, e) for s, e, _ in device if os_ <= s < oe]
        r.observe_device_s = _union(ops)[0] * 1e-9 if ops else None
    return r


def _label_gaps(gaps, host, top):
    """Idle time summed by the innermost host event that holds each gap's
    middle, the `top` largest sums. `host` is one thread's events, which
    nest; a sweep over them in start order keeps the open ones on a stack."""
    host = sorted((s, e, n) for s, e, n in host if n != STEP)
    sums: Dict[str, int] = {}
    stack, i = [], 0
    for mid, length in sorted(((gs + ge) // 2, ge - gs) for gs, ge in gaps):
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "host outside the profiled calls"
        sums[label] = sums.get(label, 0) + length
    return [(n, t * 1e-9) for n, t in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
