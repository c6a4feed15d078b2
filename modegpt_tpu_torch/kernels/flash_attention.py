"""Causal flash attention: the hand-written CUDA kernel and its plain version.

Port of ``modegpt_tpu/kernels/flash_attention.py::flash_attention`` (the
Pallas TPU kernel). The CUDA source is ``csrc/flash_attention.cu``; its
header says what bounds it on an H100 and how it is laid out.

`flash_attention` keeps the JAX signature and the ``[B, H, T, hd]``
layout. On a CUDA tensor it launches the kernel (building it on first
use) or raises; on a CPU tensor it computes `flash_attention_reference`,
the plain PyTorch version, which the CPU tests and the card's
comparisons use. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_reference", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked float32-softmax attention with GQA — the XLA branch of
    ``modegpt_tpu.models.forward._attention``: scores in the input dtype
    times ``scale``, softmax in float32, probabilities cast back to the
    input dtype for the product with v. A key is visible iff
    ``q - window < k <= q``.

    q [B, H, T, hd], k [B, Hk, T, hd], v [B, Hk, T, hd_v] -> [B, H, T, hd_v].
    """
    B, H, T, hd = q.shape
    Hk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    G = H // Hk
    qg = q.reshape(B, Hk, G, T, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k) * scale
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask = mask & (ki > qi - window)
    scores = scores.to(torch.float32).masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v)
    return out.reshape(B, H, T, v.shape[-1])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must all be CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: tensors on different devices {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, T, d]")
    B, H, T, hd = q.shape
    Hk = k.shape[1]
    if k.shape != (B, Hk, T, hd) or v.shape[:3] != (B, Hk, T):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hk == 0 or H % Hk:
        raise ValueError(f"flash_attention: n_heads {H} is not a multiple of n_kv_heads {Hk}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= v.shape[-1] <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dims {hd}, {v.shape[-1]} outside [1, {MAX_HEAD_DIM}]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if B * H >= 2**31 or T >= 2**31:
        raise ValueError("flash_attention: B*H and T must fit in int32")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    Args:
      q: [B, H, T, hd]; k: [B, Hk, T, hd] (Hk divides H); v: [B, Hk, T, hd_v].
        float32 or bfloat16, contiguous; hd and hd_v at most 256.
      scale: score scale (default hd**-0.5); q is scaled in its dtype.
      window: sliding window (key visible iff q - window < k <= q).
    Returns [B, H, T, hd_v] in q's dtype.
    """
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, window)
    _check(q, k, v)
    from modegpt_tpu_torch.kernels.build import load_library

    lib = load_library("flash_attention")
    fn = lib.modegpt_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    B, H, T, hd = q.shape
    hd_v = v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # q is scaled in its own dtype, as the JAX wrapper does before its kernel
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    out = torch.empty((B, H, T, hd_v), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, k.shape[1], T, hd, hd_v, scale_q,
            0 if window is None else int(window), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
