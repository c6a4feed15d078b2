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

Taps are taken and summed per layer (`models.forward.forward_taps`), so
a mixed dense/MoE stack, whose layers' ``cov_mlp`` differ in shape
(``[D', D']`` dense, ``[E, D, D]`` MoE), calibrates in one pass over the
batches where the JAX pipeline runs one pass per kind (the same sums).

`calibrate_window` is the JAX package's windowed calibration (taps for
one layer window, BI for every layer, float32 on the device); the
streamed calibration is `compress.offload`.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.models.forward import forward_taps
from modegpt_tpu_torch.models.spec import ModelSpec

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["CalibrationResult", "calibrate", "calibrate_window"]


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
    # shared-expert Grams of the target layers that have one (qwen2_moe)
    cov_shared: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)


_FIELDS = ("cov_mlp", "cov_q", "cov_k", "cov_x", "cov_shared")


def calibrate(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    target_layers: Sequence[int],
    accumulate: str = "host",
    gram_precision: str = "highest",
    attn_impl: str = "auto",
) -> CalibrationResult:
    """Run calibration forwards and accumulate statistics.

    Args:
      params: the parameter tree; the forwards run on its device.
      batches: list of [B, T] int token arrays (uniform T; B may vary on
        the last batch).
      target_layers: layers whose Grams are collected.
      accumulate: "host" (float64 on the CPU) or "device" (float32 on
        the model's device).
      attn_impl: the forward's attention ("auto": the CUDA kernel on the
        card, the plain version elsewhere).
    """
    if accumulate not in ("host", "device"):
        raise ValueError(f"accumulate must be host or device, got {accumulate!r}")
    stats_layers = tuple(int(l) for l in target_layers)
    device = params["embed_tokens"].device
    acc_device = torch.device("cpu") if accumulate == "host" else device
    acc_dtype = torch.float64 if accumulate == "host" else torch.float32

    acc: Dict[str, Dict[int, torch.Tensor]] = {key: {} for key in _FIELDS}
    bi = torch.zeros(spec.n_layers, dtype=acc_dtype, device=acc_device)
    n_sequences = 0
    seq_len = int(batches[0].shape[1])
    for batch in batches:
        n_sequences += int(batch.shape[0])
        ids = torch.as_tensor(np.asarray(batch), device=device)
        _, taps, bi_acc = forward_taps(
            spec, params, ids, stats_layers=stats_layers, attn_impl=attn_impl,
            gram_precision=gram_precision, want_logits=False,
        )
        for l, layer_taps in taps.items():
            for key, gram in layer_taps.items():
                g = gram.to(device=acc_device, dtype=acc_dtype)
                if l in acc[key]:
                    acc[key][l] += g
                else:
                    acc[key][l] = g
        del taps
        bi += bi_acc.to(device=acc_device, dtype=acc_dtype)

    total_tokens = n_sequences * seq_len
    # Normalisation (reference: calibration.py:135-146): BI by sequence
    # count, covariances by token count (the actual seq_len, where the
    # reference hardcodes 2048).
    bi = bi.to(device="cpu", dtype=torch.float64) / n_sequences
    for per_layer in acc.values():
        for g in per_layer.values():
            if accumulate == "host":
                g /= total_tokens
            else:
                g *= 1.0 / total_tokens  # a float32 scale, on the device
    logger.info(
        "calibration: %d sequences x %d tokens, %d target layers (%s accumulation)",
        n_sequences, seq_len, len(stats_layers), accumulate,
    )
    per_layer = {key: {l: acc[key][l] for l in stats_layers if l in acc[key]} for key in _FIELDS}
    return CalibrationResult(
        **per_layer,
        bi_scores=bi.tolist(),
        n_sequences=n_sequences,
        total_tokens=total_tokens,
    )


def calibrate_window(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    start: int,
    width: int,
    attn_impl: str = "auto",
    gram_precision: str = "highest",
) -> CalibrationResult:
    """`calibrate` for the layer window ``[start, start+width)``, float32
    sums on the model's device (JAX ``calib/engine.py:432-488``): every
    batch runs the forward over every layer, taps only the window's
    layers and takes BI for all of them. Dense, MoE and mixed stacks.

    The JAX version is one compiled program for every window: a traced
    ``start``, a ``lax.cond`` that skips the Grams outside the window and
    an ``optimization_barrier`` that retires each layer's temporaries
    before the next layer runs. The eager loop here taps only the
    window's layers and frees each layer's temporaries as it goes, so it
    needs none of the three; the same uniformity checks are kept.
    """
    if len(set(spec.q_ranks)) != 1:
        raise ValueError("calibrate_window needs uniform attention ranks")
    dense_gates = {spec.gate_ranks[l] for l in range(spec.n_layers) if not spec.is_moe_layer(l)}
    if len(dense_gates) > 1:
        raise ValueError("calibrate_window needs uniform dense MLP widths")
    layers = [l for l in range(start, start + width) if l < spec.n_layers]
    return calibrate(
        spec, params, batches, layers, accumulate="device",
        gram_precision=gram_precision, attn_impl=attn_impl,
    )
