"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Asking for
CUDA on a host without it raises: nothing carries on silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["parse_device", "resolve_device"]

DeviceLike = Union[str, int, torch.device]


def parse_device(device: DeviceLike) -> torch.device:
    """"cpu" | "cuda" | "cuda:N" | N (an int or a digit string, meaning
    "cuda:N") -> torch.device, without checking that it exists."""
    if isinstance(device, torch.device):
        dev = device
    elif isinstance(device, int) or (isinstance(device, str) and device.strip().isdigit()):
        dev = torch.device("cuda", int(device))
    else:
        try:
            dev = torch.device(str(device).strip())
        except RuntimeError as e:
            raise ValueError(f"device must be cpu, cuda, cuda:N or N, got {device!r}") from e
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu, cuda, cuda:N or N, got {device!r}")
    return dev


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """parse_device, then check the device is there: a CUDA device on a
    host without CUDA (or with fewer cards) raises RuntimeError."""
    dev = parse_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present"
            )
    return dev
