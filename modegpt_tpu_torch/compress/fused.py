"""Fused compression: calibrate, allocate, solve and surgery in one pass.

Port of ``modegpt_tpu.compress.fused``. The JAX module restructures the
job into three compiled programs and one host read, to beat per-dispatch
latency on remote accelerators: one calibration over every layer, the
BI allocator on the device, then every solver in padded, rank-free form
so that one program vmaps over the layer stack with a traced rank
vector.

Here the job is the pipeline's own steps for every layer at once, in
memory, with no factor store:

1. `calib.engine.calibrate` over every layer, float32 sums on the device;
2. the BI softmax allocator (`ops.allocation._allocate`) in float32 on
   the device, as the JAX job runs it; one host read: the keep ratios
   ``[L]``;
3. `compress.batched.solve_chunk_batched` over every layer at
   ``solver_precision="f32_device"`` (the JAX job solves in float32 on
   the device), factors kept on the device;
4. `compress.surgery.apply_factors`.

The eager loop takes each layer's rank as a number, so the padded
solvers the JAX package needs for its traced ranks have no counterpart:
the factors are the chunked pipeline's at ``f32_device`` (tested).
Scope: dense uniform RoPE-family stacks (gated MLP, pre-norms only,
bias-free attention); `fused_compress` raises ValueError outside it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.calib.engine import calibrate
from modegpt_tpu_torch.compress.batched import solve_chunk_batched
from modegpt_tpu_torch.compress.surgery import apply_factors
from modegpt_tpu_torch.config import CompressionConfig
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.allocation import _allocate

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["fused_compress", "supports_fused"]


def supports_fused(spec: ModelSpec) -> bool:
    return (
        spec.uses_rope
        and spec.gated_mlp
        and spec.pre_norms
        and not spec.post_norms
        and not spec.n_experts
        and not spec.attention_bias
        and spec.is_uniform
    )


@torch.no_grad()
def fused_compress(spec: ModelSpec, params: Dict, batches: Sequence[np.ndarray], config: CompressionConfig,
                   mesh=None):
    """Compress in one pass (module docstring), on the parameters'
    device. Returns (compressed_spec, compressed_params); ``params`` is
    not mutated, and the norms, embeddings and head pass through by
    reference.

    ``mesh``: a data-parallel `parallel.mesh.Mesh` (JAX
    ``fused.py:204-226``): with the full tree on every rank, each
    calibration batch's rows are split over its ``data`` axis and the
    Grams all-reduced; allocation, solves and surgery then run
    replicated on every rank, as the JAX job runs them."""
    if not supports_fused(spec):
        raise ValueError(
            "fused_compress covers uniform dense RoPE-family stacks (gated MLP, pre-norm, bias-free attention)"
        )
    layers = list(range(spec.n_layers))
    calib = calibrate(spec, params, batches, layers, accumulate="device", gram_precision=config.gram_precision,
                      mesh=mesh)
    # BI summed in float32 over the batches, divided by the sequence count
    # in float32 (the float64 quotient of two float32 values rounds to it)
    bi = torch.tensor(calib.bi_scores, dtype=torch.float32, device=params["embed_tokens"].device)
    keep, _ = _allocate(
        bi, float(config.compression_ratio), float(config.sparsity_smoothing), float(config.max_sparsity), False
    )
    keep_ratios = keep.tolist()  # the one host read: L floats
    factors = solve_chunk_batched(
        spec, params, layers, keep_ratios, calib, dataclasses.replace(config, solver_precision="f32_device"),
        "mlp,qk,vo", fetch="device",
    )
    del calib
    logger.info("fused compression: %d layers, one host read", spec.n_layers)
    return apply_factors(spec, params, factors["mlp"], factors["qk"], factors["vo"])
