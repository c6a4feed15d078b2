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

Under a `parallel.mesh.Mesh` every rank runs `calibrate` on its shard
(rows over ``data``; heads over ``model`` for a tensor-parallel tree, or
the sequence with ``shard_sequence``) and the sums meet at the end;
`parallel.ring.calibrate_ring` runs the same body with the sequence
split over ``context``.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.models.forward import forward_taps
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.parallel.mesh import all_gather, all_reduce, reduce_to, shard_batch

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
    mesh=None,
    shard_sequence: bool = False,
    shard_stats: bool = False,
) -> CalibrationResult:
    """Run calibration forwards and accumulate statistics.

    Args:
      params: the parameter tree; the forwards run on its device. Under
        a mesh, this rank's tree (`parallel.mesh.param_shardings`).
      batches: list of [B, T] int token arrays (uniform T; B may vary on
        the last batch).
      target_layers: layers whose Grams are collected.
      accumulate: "host" (float64 on the CPU) or "device" (float32 on
        the model's device).
      attn_impl: the forward's attention ("auto": the CUDA kernel on the
        card, the plain version elsewhere).
      mesh: a `parallel.mesh.Mesh` (JAX ``calib/engine.py:71-138``): each
        batch's rows are split over its ``data`` axis, and every rank's
        sums are all-reduced once, at the end (one collective per layer
        and statistic, not one per batch). Tensor-parallel trees give
        per-head Grams of this rank's heads, gathered over ``model`` at
        the end (accumulation is linear).
      shard_sequence: also split the sequence over the ``model`` axis
        (``params`` replicated): attention all-gathers q/k/v along T and
        runs on the full sequence (`models.forward._attention`); the
        chunks' sums are all-reduced over ``model``, BI is the mean of
        the equal chunks' means.
      shard_stats: each ``data`` rank receives only the Grams of the
        target layers it owns (``layer % data == coordinate``), reduced
        to it instead of all-reduced; the others are absent from its
        result. As in JAX, only when the target-layer count divides the
        data axis; otherwise every rank gets every layer.
    """
    seq_axis = "model" if (mesh is not None and shard_sequence and mesh.size("model") > 1) else None
    return _calibrate(spec, params, batches, target_layers, accumulate, gram_precision, attn_impl,
                      mesh, seq_axis, shard_stats)


def _calibrate(spec, params, batches, target_layers, accumulate, gram_precision, attn_impl,
               mesh=None, seq_axis: Optional[str] = None, shard_stats: bool = False) -> CalibrationResult:
    """`calibrate`'s body; ``seq_axis`` is the mesh axis the sequence is
    split over ("model" for shard_sequence, "context" for the ring)."""
    if accumulate not in ("host", "device"):
        raise ValueError(f"accumulate must be host or device, got {accumulate!r}")
    stats_layers = tuple(int(l) for l in target_layers)
    device = params["embed_tokens"].device
    acc_device = torch.device("cpu") if accumulate == "host" else device
    acc_dtype = torch.float64 if accumulate == "host" else torch.float32
    n_seq = mesh.size(seq_axis) if seq_axis is not None else 1

    acc: Dict[str, Dict[int, torch.Tensor]] = {key: {} for key in _FIELDS}
    bi = torch.zeros(spec.n_layers, dtype=acc_dtype, device=acc_device)
    n_sequences = 0
    seq_len = int(batches[0].shape[1])
    if seq_len % n_seq:
        raise ValueError(f"seq_len {seq_len} not divisible by the {seq_axis} axis ({n_seq})")
    for batch in batches:
        n_sequences += int(batch.shape[0])
        batch = np.asarray(batch)
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        if seq_axis is not None:
            C, c = seq_len // n_seq, mesh.coord(seq_axis)
            batch = batch[:, c * C : (c + 1) * C]
        ids = torch.as_tensor(np.ascontiguousarray(batch), device=device)
        _, taps, bi_acc = forward_taps(
            spec, params, ids, stats_layers=stats_layers, attn_impl=attn_impl,
            gram_precision=gram_precision, want_logits=False, mesh=mesh, seq_axis=seq_axis,
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

    if mesh is not None:
        bi, acc = _reduce_stats(spec, mesh, bi, acc, stats_layers, seq_axis, shard_stats)
        bi = bi / n_seq  # the mean over T: the mean of equal chunks' means
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


def _reduce_stats(spec, mesh, bi, acc, stats_layers, seq_axis, shard_stats):
    """Every rank's sums combined over the mesh: BI and Grams summed over
    ``data`` (and the sequence axis); with ``shard_stats`` each layer's
    Grams only at its owner on ``data``; a tensor-parallel rank's per-head
    Grams gathered over ``model``. Collectives run in one order on every
    rank of each group: layers ascending, statistics in field order."""
    axes = ("data",) + ((seq_axis,) if seq_axis else ())
    n_data = mesh.size("data")
    by_owner = shard_stats and n_data > 1 and len(stats_layers) % n_data == 0
    bi = all_reduce(mesh, bi, axes)
    out: Dict[str, Dict[int, torch.Tensor]] = {key: {} for key in _FIELDS}
    for l in stats_layers:
        for key in _FIELDS:
            if l not in acc[key]:
                continue
            g = acc[key].pop(l)
            if by_owner:
                if seq_axis:
                    g = all_reduce(mesh, g, seq_axis)
                g = reduce_to(mesh, g, "data", l % n_data)
                if g is None:
                    continue
            else:
                g = all_reduce(mesh, g, axes)
            heads = {"cov_q": spec.n_heads, "cov_k": spec.n_kv_heads}.get(key)
            if heads is not None and g.shape[0] != heads:  # this rank's heads
                g = all_gather(mesh, g, "model", dim=0)
            out[key][l] = g
    return bi, out


def calibrate_window(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    start: int,
    width: int,
    attn_impl: str = "auto",
    gram_precision: str = "highest",
    mesh=None,
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
        gram_precision=gram_precision, attn_impl=attn_impl, mesh=mesh,
    )
