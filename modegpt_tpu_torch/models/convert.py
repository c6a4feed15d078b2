"""Carry a parameter tree of host arrays into the port's torch tree.

The JAX package's parameters, fetched to the host (``jax.device_get``
gives numpy leaves, bfloat16 as ml_dtypes' numpy type), have the same
dict/list layout as the port's; `params_from_numpy` rebuilds that tree
with torch tensors on ``device``. Integer leaves (rotary masks) keep
their integer dtype.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["params_from_numpy", "to_tensor", "to_numpy"]


def to_tensor(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy (including a bfloat16 numpy type) or tensor -> tensor on
    ``device``; floating leaves are cast to ``dtype`` when given."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            a = np.ascontiguousarray(a)
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy; bfloat16 comes back as float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_numpy(tree: Any, device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None) -> Any:
    """Map a nested dict/list tree of arrays to torch tensors on
    ``device``; None leaves stay None."""
    dev = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return to_tensor(node, dev, dtype)

    return conv(tree)
