"""Causal flash attention: the hand-written CUDA kernels and their plain versions.

Port of the two Pallas TPU kernels of
``modegpt_tpu/kernels/flash_attention.py``:

* `flash_attention` (K1), which the forward takes for ``128 <= T <= 8192``;
* `flash_attention_hbm` (K2), the long-context kernel, which the forward
  takes for ``T > 8192``.

Both are C entries of one CUDA source, ``csrc/flash_attention_hbm.cu``
(``modegpt_flash_attention`` and ``modegpt_flash_attention_hbm``), whose
one tile loop runs on the tensor cores (float32 as three TF32 products,
bfloat16 through wgmma) with K/V tiles fed by a producer warpgroup through
a TMA or cp.async ring, heaviest query tiles first; the two Pallas kernels
compute the same function.

The source's header says what bounds it on an H100 and how it is laid
out. Both keep the JAX signature and the ``[B, H, T, hd]`` layout.
On a CUDA tensor they launch their kernel (building it on first use) or
raise; on a CPU tensor they compute their plain PyTorch version, which
the CPU tests and the card's comparisons use: `flash_attention_reference`
(row-chunked; `flash_attention_hbm_reference` is the same function).
``flash_attention.launches`` and ``flash_attention_hbm.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

__all__ = [
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_hbm",
    "flash_attention_hbm_reference",
    "MAX_HEAD_DIM",
]

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# elements of one f32 score block [B, H, rows, T] of the plain version
# (2 GiB): it sets how many query rows a block takes
_REFERENCE_SCORES = 2**29


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Masked float32-softmax attention with GQA — the XLA branch of
    ``modegpt_tpu.models.forward._attention``: scores in the input dtype
    times ``scale``, then in float32 ``softcap * tanh(s / softcap)`` when
    a cap is given (gemma2; the kernels have none, so the forward routes
    a capped layer here), softmax in float32, probabilities cast back to
    the input dtype for the product with v. A key is visible iff
    ``q - window < k <= q``.

    It runs over blocks of query rows. Each row's softmax is independent
    of the others', so every row gets the arithmetic of the unchunked
    version; a block attends only the keys from its window's start to its
    causal frontier (the rest carry probability exactly 0). The unchunked
    ``[B, H, T, T]`` scores would be 34 GB per batch row at T = 16384; a
    block's stay at about 2 GB, and up to that size there is one block.

    q [B, H, T, hd], k [B, Hk, T, hd], v [B, Hk, T, hd_v] -> [B, H, T, hd_v].
    """
    B, H, T, hd = q.shape
    Hk, hd_v = k.shape[1], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    block_rows = max(1, _REFERENCE_SCORES // max(1, B * H * T))
    G = H // Hk
    qg = q.reshape(B, Hk, G, T, hd)
    out = torch.empty((B, Hk, G, T, hd_v), dtype=q.dtype, device=q.device)
    for r0 in range(0, T, block_rows):
        r1 = min(T, r0 + block_rows)
        k0 = 0 if window is None else max(0, r0 - window + 1)
        scores = torch.einsum("bkgsd,bktd->bkgst", qg[:, :, :, r0:r1], k[:, :, k0:r1]) * scale
        qi = torch.arange(r0, r1, device=q.device)[:, None]
        ki = torch.arange(k0, r1, device=q.device)[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (ki > qi - window)
        scores = scores.to(torch.float32)
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        del scores
        out[:, :, :, r0:r1] = torch.einsum("bkgst,bktd->bkgsd", probs, v[:, :, k0:r1])
        del probs
    return out.reshape(B, H, T, hd_v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name}: q, k and v must all be CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: tensors on different devices {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: dtypes must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [B, H, T, d]")
    B, H, T, hd = q.shape
    Hk = k.shape[1]
    if k.shape != (B, Hk, T, hd) or v.shape[:3] != (B, Hk, T):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hk == 0 or H % Hk:
        raise ValueError(f"{name}: n_heads {H} is not a multiple of n_kv_heads {Hk}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= v.shape[-1] <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dims {hd}, {v.shape[-1]} outside [1, {MAX_HEAD_DIM}]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if B * H >= 2**31 or T >= 2**31:
        raise ValueError(f"{name}: B*H and T must fit in int32")


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale, window) -> torch.Tensor:
    """Launch the C entry ``modegpt_<name>`` of ``csrc/flash_attention_hbm.cu``
    (both entries share one signature) on the current stream; raise if it
    was refused."""
    _check(q, k, v, name)
    from modegpt_tpu_torch.kernels.build import load_library

    fn = getattr(load_library("flash_attention_hbm"), f"modegpt_{name}")
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
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _check_window(name: str, window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got {window}")


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
    _check_window("flash_attention", window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, window)
    out = _launch("flash_attention", q, k, v, scale, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

# K2's plain version is K1's: the same function, at any T
flash_attention_hbm_reference = flash_attention_reference


def flash_attention_hbm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Long-context causal (optionally sliding-window) attention: the
    semantics and arguments of `flash_attention`, at any T; the forward
    routes T > 8192 here. Returns [B, H, T, hd_v] in q's dtype."""
    _check_window("flash_attention_hbm", window)
    if q.device.type == "cpu":
        return flash_attention_hbm_reference(q, k, v, scale, window)
    if (q.shape[2] + 63) // 64 > 65535:
        raise ValueError(f"flash_attention_hbm: T={q.shape[2]} exceeds 65535 query tiles of 64")
    out = _launch("flash_attention_hbm", q, k, v, scale, window)
    flash_attention_hbm.launches += 1
    return out


flash_attention_hbm.launches = 0
