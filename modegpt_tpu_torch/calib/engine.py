"""Calibration engine: Gram statistics and Block-Influence scores.

Port of ``modegpt_tpu.calib.engine.calibrate`` (reference:
src/calibration.py:39-150). The functional forward returns the per-layer
Gram taps (``models/forward.py``); this module runs it over the
calibration batches and accumulates:

* ``accumulate="host"`` (parity): each batch's float32 Grams are computed
  on the model's device and summed in float64 on the CPU — the
  reference's "f32 matmul, f64 accumulate" (LlamaAdapter.py:110-113);
* ``accumulate="device"`` (speed): float32 running sums stay on the
  device and are normalised there, with no per-batch host transfer.

The windowed and streamed calibrations of the JAX package are not ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.models.forward import forward
from modegpt_tpu_torch.models.spec import ModelSpec

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["CalibrationResult", "calibrate"]


@dataclass
class CalibrationResult:
    """Normalised second-moment statistics keyed by ABSOLUTE layer index
    (only this chunk's target layers), and BI scores for every layer
    (reference: calibration.py:118-124, normalised as :141-146).
    Host accumulation gives float64 CPU tensors; device accumulation
    float32 tensors on the model's device."""

    cov_mlp: Dict[int, torch.Tensor]
    cov_q: Dict[int, torch.Tensor]
    cov_k: Dict[int, torch.Tensor]
    cov_x: Dict[int, torch.Tensor]
    bi_scores: List[float]
    n_sequences: int
    total_tokens: int


_FIELDS = ("cov_mlp", "cov_q", "cov_k", "cov_x")


def calibrate(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    target_layers: Sequence[int],
    accumulate: str = "host",
    gram_precision: str = "highest",
) -> CalibrationResult:
    """Run calibration forwards and accumulate statistics.

    Args:
      params: the parameter tree; the forwards run on its device.
      batches: list of [B, T] int token arrays (uniform T; B may vary on
        the last batch).
      target_layers: layers whose Grams are collected.
      accumulate: "host" (float64 on the CPU) or "device" (float32 on
        the model's device).
    """
    if accumulate not in ("host", "device"):
        raise ValueError(f"accumulate must be host or device, got {accumulate!r}")
    stats_layers = tuple(int(l) for l in target_layers)
    device = params["embed_tokens"].device
    acc_device = torch.device("cpu") if accumulate == "host" else device
    acc_dtype = torch.float64 if accumulate == "host" else torch.float32

    acc: Dict[str, torch.Tensor] = {}
    bi = torch.zeros(spec.n_layers, dtype=acc_dtype, device=acc_device)
    n_sequences = 0
    seq_len = int(batches[0].shape[1])
    for batch in batches:
        n_sequences += int(batch.shape[0])
        ids = torch.as_tensor(np.asarray(batch), device=device)
        _, stats = forward(
            spec, params, ids, stats_layers=stats_layers,
            gram_precision=gram_precision, want_logits=False,
        )
        for key in _FIELDS:
            s = getattr(stats, key).to(device=acc_device, dtype=acc_dtype)
            if key in acc:
                acc[key] += s
            else:
                acc[key] = s
        bi += stats.bi_acc.to(device=acc_device, dtype=acc_dtype)

    total_tokens = n_sequences * seq_len
    # Normalisation (reference: calibration.py:135-146): BI by sequence
    # count, covariances by token count (the actual seq_len, where the
    # reference hardcodes 2048).
    bi = bi.to(device="cpu", dtype=torch.float64) / n_sequences
    if accumulate == "host":
        for key in _FIELDS:
            acc[key] /= total_tokens
    else:
        inv = torch.tensor(1.0 / total_tokens, dtype=torch.float32, device=device)
        for key in _FIELDS:
            acc[key] *= inv
    logger.info(
        "calibration: %d sequences x %d tokens, %d target layers (%s accumulation)",
        n_sequences, seq_len, len(stats_layers), accumulate,
    )
    per_layer = {key: {l: acc[key][i] for i, l in enumerate(stats_layers)} for key in _FIELDS}
    return CalibrationResult(
        **per_layer,
        bi_scores=bi.tolist(),
        n_sequences=n_sequences,
        total_tokens=total_tokens,
    )
