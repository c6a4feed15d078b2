"""The device trace of a window, reduced in memory.

`Window` runs ``torch.profiler`` (CPU and CUDA activities, no shapes, no
stacks) around a block and marks the block with a ``record_function``
range, so the window has bounds on the profiler's clock. Nothing is
written to disk. `summarize` turns the events into what the per-layer
readers need:

* ``kernels``: every device operation (kernels, copies, sets) as
  (name, start_us, end_us, ops), ``ops`` the names of the host operations
  that launched it, innermost first (the launch call, the ATen op, the
  harness's ranges), found through the correlation id that a device
  event shares with the runtime call that launched it;
* ``busy_s``: the seconds in which some device operation ran: the
  length of the UNION of their intervals within the window, so
  operations that overlap on two streams count once;
* ``window_s``, and the longest idle stretches named by the innermost
  host operation running at their middle (``idle_gaps``), and the device
  operations that took most time (``device_ops``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
TOP = 10


class Window:
    """``with Window(enabled) as w:`` traces the block when enabled;
    ``w.summary`` is then `summarize`'s dict (None when disabled)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary: Optional[Dict] = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
            self.prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
        return False

    def close(self) -> Optional[Dict]:
        """Reduce the trace (after the window, outside any timing)."""
        if self.enabled and self.summary is None:
            self.summary = summarize(self.prof.events())
            self.prof = None
        return self.summary


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def _is_annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline: no
    device work."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("perfbench.")


def summarize(events) -> Dict:
    window = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not window:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    main_thread = window[0].thread
    launches: Dict[int, object] = {}
    host: List[Tuple[float, float, str]] = []
    device = []
    for e in events:
        if _is_device(e):
            if not _is_annotation(e):
                device.append(e)
            continue
        if e.name.startswith("cu"):  # a CUDA runtime or driver call: its id is the correlation id
            launches[e.id] = e
        if e.thread == main_thread and e.name != WINDOW:
            host.append((e.time_range.start, e.time_range.end, e.name))
    kernels = []
    for e in device:
        start, end = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if end <= start:
            continue
        kernels.append((e.name, start, end, _ancestors(launches.get(e.id))))
    busy, gaps = _union(sorted((k[1], k[2]) for k in kernels), w0, w1)
    per_name: Dict[str, float] = defaultdict(float)
    for name, s, t, _ in kernels:
        per_name[name] += (t - s) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": kernels,
        "device_ops": sorted(([n, v] for n, v in per_name.items()), key=lambda r: -r[1])[:TOP],
        "idle_gaps": _name_gaps(gaps, host),
    }


def _ancestors(e) -> Tuple[str, ...]:
    names = []
    while e is not None:
        names.append(e.name)
        e = getattr(e, "cpu_parent", None)
    return tuple(names)


def _union(intervals: List[Tuple[float, float]], w0: float, w1: float):
    """(length of the union of sorted intervals, the gaps between them
    within [w0, w1])."""
    busy, gaps, cur = 0.0, [], w0
    for s, t in intervals:
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _name_gaps(gaps: List[Tuple[float, float]], host: List[Tuple[float, float, str]]) -> List[list]:
    """Idle seconds by the innermost host operation (or harness range)
    running at each gap's middle, the largest ten."""
    host.sort()
    starts = [h[0] for h in host]
    total: Dict[str, float] = defaultdict(float)
    for s, t in gaps:
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(starts, mid)
        name = "python (no traced operation)"
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        total[name] += (t - s) / 1e6
    return sorted(([n, v] for n, v in total.items()), key=lambda r: -r[1])[:TOP]

