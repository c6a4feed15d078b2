"""Device memory statistics.

Port of ``modegpt_tpu.utils.memory.device_memory_stats`` (the host RSS
watchdog beside it is not ported). On CUDA the numbers come from the
caching allocator (``torch.cuda.memory_stats``: bytes its live tensors
hold) and the CUDA runtime (``torch.cuda.mem_get_info``: the card's total
bytes); the streamed sweep's flush gate (`compress.offload`) reads
``bytes_limit``.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["device_memory_stats"]


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:N": {"bytes_in_use", "bytes_limit"}} for every CUDA device;
    {} where there is none."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(total),
        }
    return out
