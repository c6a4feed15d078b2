"""Profiling utilities: `torch.profiler` traces and named phase timers.

Port of ``modegpt_tpu.utils.profiling``. The reference's observability is
wall clock and tok/s prints (reference: src/eval.py:169-216); here a
phase can be traced with `torch.profiler` into a Chrome trace (viewable
in Perfetto or chrome://tracing), and timed into the metrics registry.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["trace", "phase_timer"]


@contextlib.contextmanager
def trace(profile_dir: Optional[str], device: Optional[torch.device] = None) -> Iterator[None]:
    """Trace the block with `torch.profiler` into a Chrome trace
    ``trace_<ns>.json`` under `profile_dir` (a no-op if it is empty): the
    CPU activities, and the CUDA ones when `device` is a card."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def phase_timer(name: str, metrics: Optional[Dict] = None) -> Iterator[None]:
    """Wall-clock a named phase; records `<name>_seconds` into metrics."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        logger.info("phase %s: %.2fs", name, dt)
        if metrics is not None:
            metrics[f"{name}_seconds"] = dt
