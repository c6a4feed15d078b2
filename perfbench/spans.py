"""The program's own spans in a reduced trace.

The port marks its layers with ``record_function`` ranges whose names
start with `PREFIX` (`modegpt_tpu_torch.utils.profiling.SPANS`). They lie
on the profiler's clock, and ``trace.summarize``'s ``kernels`` (name,
start_us, end_us, ops) list every range that encloses each kernel's
launch in ``ops``, innermost first. From those alone:

* `device_seconds`: the device time of the kernels launched inside a
  span, and `per_layer`, the same per compressed layer of a record;
* `idle_by_span`: each idle gap of the device, charged to the innermost
  program span that launched the kernel ending the gap (the host was
  issuing that launch when the device went back to work); the stretch
  before the first and after the last kernel goes under ``""`` with the
  gaps no span ended;
* `idle_pct`: one span's share of a record's traced window, in %.

A program without spans (the port before it had them) gives None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

from perfbench.trace import _union

PREFIX = "modegpt."


def device_seconds(kernels: Iterable[Sequence], name: str) -> float:
    """Seconds of the union of the device intervals of the kernels
    (name, start_us, end_us, ops) launched inside span ``name``."""
    spans = sorted((s, t) for _, s, t, ops in kernels if name in ops)
    if not spans:
        return 0.0
    busy, _ = _union(spans, spans[0][0], max(t for _, t in spans))
    return busy / 1e6


def per_layer(record: Dict, name: str) -> Optional[float]:
    """Device seconds under span ``name`` per compressed layer of a
    record; None where nothing ran under it."""
    tr = record.get("trace")
    if not tr or not record.get("layers"):
        return None
    secs = device_seconds(tr["kernels"], name)
    return secs / record["layers"] if secs > 0 else None


def _innermost(ops: Sequence[str]) -> str:
    return next((op for op in ops if op.startswith(PREFIX)), "")


def idle_by_span(kernels: Sequence[Sequence], window_s: float, busy_s: float) -> Dict[str, float]:
    """{span name: idle seconds} of a traced window of ``window_s``
    seconds in which the device was busy ``busy_s``: each gap between the
    union of the kernels' intervals goes to the innermost program span
    among the ops of the kernel that ends it, ``""`` holds the rest (no
    span, and the window's edges), so the values add up to the idle
    seconds."""
    total: Dict[str, float] = defaultdict(float)
    cur = None
    for _, s, t, ops in sorted(kernels, key=lambda k: (k[1], k[2])):
        if cur is not None and s > cur:
            total[_innermost(ops)] += (s - cur) / 1e6
        cur = t if cur is None else max(cur, t)
    inside = sum(total.values())
    total[""] += max(0.0, window_s - busy_s - inside)
    return dict(total)


def idle_pct(record: Dict, name: str) -> Optional[float]:
    """100 x the idle seconds `idle_by_span` charges to span ``name`` /
    the traced window's seconds; None without a trace or where no kernel
    was launched inside any program span."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    if not any(_innermost(k[3]) for k in tr["kernels"]):
        return None
    return 100.0 * idle_by_span(tr["kernels"], tr["window_s"], tr["busy_s"]).get(name, 0.0) / tr["window_s"]
