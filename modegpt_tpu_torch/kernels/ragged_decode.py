"""Ragged GQA attention over a slot-table KV pool: the hand-written CUDA
kernel and its plain version.

Port of ``modegpt_tpu/kernels/ragged_decode.py::ragged_gqa_attend`` (the
Pallas TPU kernel) and its S=1 form ``ragged_gqa_decode``. The CUDA
source is ``csrc/ragged_decode.cu``; its header says what bounds it on an
H100 and how it is laid out.

Slot b's query s sits at absolute position ``pos[b] + s`` and attends
keys ``t`` in ``[max(0, pos[b]+s+1-window), pos[b]+s]`` that lie inside
the pool (``t < T``): causal over the S new positions, the full (or
windowed) prefix before them. Nothing past the pool is read: a masked
serving row whose ``pos`` sits at or past the pool's end attends the
pool's keys that its mask lets through (all of them without a window),
and a row with no live key at all comes out as zeros; the caller
discards both.

On a CUDA tensor `ragged_gqa_attend` launches the kernel (building it on
first use) or raises; on a CPU tensor it computes
`ragged_gqa_attend_reference`, which the CPU tests and the card's
comparisons use. The kernel splits each slot's keys and writes one
partial softmax per split to float32 scratch, which a second grid
combines; the wrapper allocates that scratch (its size comes from the
library, which owns the split rule). ``ragged_gqa_attend.launches``
counts calls that launched the kernel, one per call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "ragged_gqa_attend",
    "ragged_gqa_attend_reference",
    "ragged_gqa_decode",
    "MAX_RANK",
]

MAX_RANK = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the library's C entries, typed once; scratch floats by shape (a decode
# call is ~50 us of device work, so the host's per-call work matters)
_ENTRIES: list = []
_WORKSPACE: Dict[Tuple[int, ...], int] = {}


def _full(window) -> bool:
    return window is None or int(window) <= 0


def ragged_gqa_attend_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """The plain PyTorch version, with the Pallas kernel's arithmetic:
    float32 scores of the pre-scaled q against k (int8 codes cast
    exactly), times ``k_scale`` per key column, then softcap, then the
    mask; the softmax normaliser sums the unscaled probabilities, which
    are then multiplied by ``v_scale`` per key row and, for bfloat16,
    rounded to bfloat16 before the product with v. The output is
    ``acc / max(l, 1e-30)`` in q's dtype.

    q [B, H, S, Rq], k [B, Hk, T, Rq], v [B, Hk, T, Rv], pos [B] ->
    [B, H, S, Rv]."""
    B, H, S, Rq = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.to(torch.float32).reshape(B, Hk, G, S, Rq)
    s = torch.einsum("bkgsr,bktr->bkgst", qg, k.to(torch.float32))
    if k_scale is not None:
        s = s * k_scale.to(torch.float32)[:, :, None, None, :]
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    t_ids = torch.arange(T, device=q.device)
    limit = pos.to(q.device).long()[:, None] + torch.arange(S, device=q.device)[None, :]  # [B, S]
    live = t_ids[None, None, :] <= limit[:, :, None]
    if not _full(window):
        live = live & (t_ids[None, None, :] > limit[:, :, None] - int(window))
    live = live[:, None, None]  # [B, 1, 1, S, T]
    s = s.masked_fill(~live, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # rows with no live key
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.to(torch.float32)[:, :, None, None, :]
    if q.dtype != torch.float32:
        p = p.to(q.dtype).to(torch.float32)
    out = torch.einsum("bkgst,bktr->bkgsr", p, v.to(torch.float32)) / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, v.shape[-1]).to(q.dtype)


def _entries():
    """(attend, workspace) C functions of ``csrc/ragged_decode.cu``, built
    and typed on first use."""
    if not _ENTRIES:
        from modegpt_tpu_torch.kernels.build import load_library

        lib = load_library("ragged_decode")
        fn, ws_fn = lib.modegpt_ragged_gqa_attend, lib.modegpt_ragged_gqa_workspace
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws_fn.argtypes = [ctypes.c_int] * 7
        ws_fn.restype = ctypes.c_longlong
        _ENTRIES[:] = [fn, ws_fn]
    return _ENTRIES


def _raw_stream(device: int) -> int:
    """The current CUDA stream of `device` as a pointer (the private
    accessor PyTorch's own compiled kernels use: ~10 us cheaper a call
    than the public one)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(device) if get is not None else torch.cuda.current_stream(device).cuda_stream


def _check(q, k, v, pos, k_scale, v_scale) -> None:
    tensors = [q, k, v, pos] + ([k_scale, v_scale] if k_scale is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ragged_gqa_attend: every tensor must be a CUDA tensor")
    if any(t.get_device() != q.get_device() for t in tensors):
        raise ValueError("ragged_gqa_attend: tensors on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or pos.dim() != 1:
        raise ValueError("ragged_gqa_attend: q, k, v must be 4-d and pos 1-d")
    B, H, S, Rq = q.shape
    Hk, T = k.shape[1], k.shape[2]
    Rv = v.shape[-1]
    if k.shape != (B, Hk, T, Rq) or v.shape[:3] != (B, Hk, T) or pos.shape != (B,):
        raise ValueError(
            f"ragged_gqa_attend: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, pos {tuple(pos.shape)} disagree"
        )
    if Hk == 0 or H % Hk:
        raise ValueError(f"ragged_gqa_attend: n_heads {H} is not a multiple of n_kv_heads {Hk}")
    if not (1 <= Rq <= MAX_RANK and 1 <= Rv <= MAX_RANK):
        raise ValueError(f"ragged_gqa_attend: ranks {Rq}, {Rv} outside [1, {MAX_RANK}]")
    if min(B, S, T) < 1 or B * H * S >= 2**31 or T >= 2**31:
        raise ValueError("ragged_gqa_attend: empty shapes, or B*H*S or T past int32")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"ragged_gqa_attend: q must be float32 or bfloat16, got {q.dtype}")
    kv_dtype = torch.int8 if k_scale is not None else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(
            f"ragged_gqa_attend: k/v must be {kv_dtype} (q {q.dtype}, "
            f"{'int8 codes with scales' if k_scale is not None else 'no scales'}), got {k.dtype}, {v.dtype}"
        )
    if k_scale is not None and (
        k_scale.shape != (B, Hk, T) or v_scale.shape != (B, Hk, T)
        or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
    ):
        raise ValueError("ragged_gqa_attend: k_scale/v_scale must be float32 [B, Hk, T]")
    if pos.dtype != torch.int32:
        raise ValueError(f"ragged_gqa_attend: pos must be int32, got {pos.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_gqa_attend: every tensor must be contiguous")


def ragged_gqa_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """S-position ragged GQA attention over a slot-table cache.

    Args:
      q: [B, H, S, Rq], already scaled; float32 or bfloat16.
      k: [B, Hk, T, Rq] cache pool (Hk divides H), q's dtype, or int8
        codes when `k_scale` is given. A pool slice such as
        ``cache_k[layer]`` or ``cache_k[layer, s:s+1]`` is contiguous and
        is read in place.
      v: [B, Hk, T, Rv], like k.
      pos: [B] int32, each slot's first query position.
      k_scale, v_scale: [B, Hk, T] float32 per-position scales (int8
        KV), or None. Give both or neither.
      window: sliding window (None or 0 = full attention).
      softcap: logit softcap ``cap * tanh(s / cap)``, or None.
    Returns [B, H, S, Rv] in q's dtype.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k_scale and v_scale, or neither")
    if q.device.type == "cpu":
        return ragged_gqa_attend_reference(q, k, v, pos, k_scale, v_scale, window, softcap)
    _check(q, k, v, pos, k_scale, v_scale)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"ragged_gqa_attend: softcap must be > 0 or None, got {softcap}")
    fn, ws_fn = _entries()
    B, H, S, Rq = q.shape
    Hk, T, Rv = k.shape[1], k.shape[2], v.shape[-1]
    shape = (B, H, Hk, S, T, Rq, Rv)
    n_ws = _WORKSPACE.get(shape)
    if n_ws is None:
        n_ws = _WORKSPACE[shape] = ws_fn(*shape)
    out = torch.empty((B, H, S, Rv), dtype=q.dtype, device=q.device)
    workspace = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if k_scale is None else k_scale.data_ptr(),
        0 if v_scale is None else v_scale.data_ptr(),
        pos.data_ptr(), out.data_ptr(), workspace.data_ptr(),
        B, H, Hk, S, T, Rq, Rv, 0 if _full(window) else int(window),
        0.0 if softcap is None else float(softcap), _DTYPE_CODE[q.dtype],
    )
    dev = q.get_device()
    if dev == torch.cuda.current_device():
        err = fn(*args, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"ragged_gqa_attend kernel launch failed: CUDA error {err}")
    ragged_gqa_attend.launches += 1
    return out


ragged_gqa_attend.launches = 0


def ragged_gqa_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    counts: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One-position form: q [B, H, Rq]; slot b attends ``t < counts[b]``
    (counts >= 1, the length after the new token's K/V is written).
    Equal to `ragged_gqa_attend` with S = 1 and pos = counts - 1.
    Returns [B, H, Rv]."""
    pos = (counts - 1).to(torch.int32)
    out = ragged_gqa_attend(
        q[:, :, None, :].contiguous(), k, v, pos,
        k_scale=k_scale, v_scale=v_scale, window=window, softcap=softcap,
    )
    return out[:, :, 0, :]
