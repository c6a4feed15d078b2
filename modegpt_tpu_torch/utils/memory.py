"""Device memory statistics and the host + device memory watchdog.

Port of ``modegpt_tpu.utils.memory``. On CUDA the numbers come from the
caching allocator (``torch.cuda.memory_stats``: bytes its live tensors
hold) and the CUDA runtime (``torch.cuda.mem_get_info``: the card's total
bytes); the streamed sweep's flush gate (`compress.offload`) reads
``bytes_limit``.

`start_memory_watchdog` is the reference's RSS monitor daemon
(src/model_utils.py:34-60: a 1 Hz dump to ``.mem-usage`` with a warning
near the host's limit), with the card's bytes beside it. Host RSS comes
from ``psutil`` when it imports (host monitoring only; without it the
file holds the device lines alone).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Optional

import torch

__all__ = ["device_memory_stats", "start_memory_watchdog"]


def device_memory_stats(devices: Optional[Iterable[torch.device]] = None) -> Dict[str, Dict[str, int]]:
    """{"cuda:N": {"bytes_in_use", "bytes_limit"}} for ``devices`` (default
    every CUDA device); CPU devices are skipped; {} without CUDA."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    indices = range(torch.cuda.device_count()) if devices is None else [
        torch.device(d).index or 0 for d in devices if torch.device(d).type == "cuda"
    ]
    for i in indices:
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(total),
        }
    return out


def start_memory_watchdog(
    path: str = "./.mem-usage",
    interval_s: float = 1.0,
    warn_gb: float = 60.0,
    stop_event: Optional[threading.Event] = None,
    devices: Optional[Iterable[torch.device]] = None,
) -> threading.Thread:
    """Start a daemon thread that rewrites ``path`` every ``interval_s``
    seconds with the process's RSS, the host's used share, a warning past
    ``warn_gb`` GB of RSS, and each card's bytes in use against its total
    (``devices``, default every CUDA device: pass a rank's own card so
    the thread touches no other). Setting ``stop_event`` (also the
    thread's ``_stop_event``) ends it."""
    stop = stop_event or threading.Event()
    devices = None if devices is None else list(devices)

    def loop():
        try:
            import psutil

            proc = psutil.Process(os.getpid())
        except ImportError:
            psutil = proc = None
        while not stop.is_set():
            lines = []
            if proc is not None:
                rss_gb = proc.memory_info().rss / 1024**3
                lines.append(f"[Monitor] Process RAM: {rss_gb:.2f} GB")
                lines.append(f"System RAM: {psutil.virtual_memory().percent}% used")
                if rss_gb > warn_gb:
                    lines.append("WARNING: process RSS near host memory limit")
            for dev, s in device_memory_stats(devices).items():
                lines.append(
                    f"{dev}: {s['bytes_in_use'] / 1024**3:.2f} GB in use / {s['bytes_limit'] / 1024**3:.2f} GB"
                )
            try:
                with open(path, "w") as f:
                    f.write("\n".join(lines))
            except OSError:
                pass
            stop.wait(interval_s)

    t = threading.Thread(target=loop, daemon=True, name="memory-watchdog")
    t._stop_event = stop
    t.start()
    return t
