"""Profiling utilities: `torch.profiler` traces and the program's spans.

Port of ``modegpt_tpu.utils.profiling``. The reference's observability is
wall clock and tok/s prints (reference: src/eval.py:169-216); here a
phase can be traced with `torch.profiler` into a Chrome trace (viewable
in Perfetto or chrome://tracing).

`span` marks a stretch of the program (a layer of the compression job or
of the serving step) as a ``record_function`` range, on the profiler's
own clock, so that a trace charges every kernel and every idle gap of
the device to the span open when it was launched or began. Spans cost a
flag check while no profiler runs, and appear whenever one does (a
``profile_dir`` job, or a caller's ``torch.profiler.profile``). Every
name is listed in `SPANS`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["trace", "span", "SPANS"]

# Every span the program opens. A name holds no solver op's name (a trace
# reader would take the kernels under it for a solver's) and does not
# start with "cu" (a CUDA runtime call's prefix).
SPANS = (
    "modegpt.compress.bi_prepass",  # compress.offload._bi_sweep: the BI-only forward before the tap sweep
    "modegpt.compress.taps",  # models.forward._layer: the Gram products of a collecting layer
    "modegpt.compress.decompose",  # compress.batched.solve_chunk_batched: the Type-I, II and III solves
    "modegpt.serve.step",  # models.serving.ContinuousBatcher.step: sweep, admission, scheduling, commits
    "modegpt.model.step",  # models.padded._model_step_padded: one dispatch of the padded stack
    "modegpt.serve.sample",  # the batcher's sampling tables and every token choice (serving._pick)
    "modegpt.moe.experts",  # models.forward._moe_mlp and _moe_mlp_dispatch: router, experts, weighted sum
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range called ``name`` while a profiler runs
    (on any thread), else a shared no-op context. ``name`` is one of
    `SPANS`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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
