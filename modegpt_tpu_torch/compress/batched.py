"""Solve a layer chunk: Type-I, Type-II and Type-III factors per layer.

Port of ``modegpt_tpu.compress.batched.solve_chunk_batched`` with the
same signature and outputs. The JAX module reshapes the chunk into
layer-batched, padded device programs and states that this is
bit-identical to the per-layer path (batched.py:20); here the body is
that per-layer path, a loop over the ported ops:

* Type-I:   `ops.mlp.nystrom_mlp`; on a MoE layer once per expert,
  against the Gram of the tokens routed to it, all experts at the
  layer's one rank (the JAX `_solve_mlp_moe`, the semantics of
  `pipeline.solve_layer`), and once more for a shared expert at its
  own rank;
* Type-II:  `ops.qk.compress_qk_layer_rope` / `compress_qk_layer_opt` on
  the covariance diagonals, as ``_solve_qk_host`` does, with a RoPE
  arch's q/k biases (qwen2, starcoder2, qwen2_moe) sliced through the
  rotary mask;
* Type-III: `ops.vo.vo_full_factors`, sliced to rank.

A MoE layer's experts are solved one after another: the ridge of each
Cholesky escalates on its own matrix (`ops.psd`), which a batch over
the experts would have to carry per matrix.

Precision follows ``config.solver_precision``: ``f64_cpu`` solves in
float64 on the CPU (VO whitening by eigh, the reference's); ``f32_device``
solves in float32 on the model's device (VO whitening by the escalated
Cholesky). Factors come back as host numpy arrays in HF layout, ready
for the factor store.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.calib.engine import CalibrationResult
from modegpt_tpu_torch.compress.surgery import compress_ranks_for_layer
from modegpt_tpu_torch.config import CompressionConfig
from modegpt_tpu_torch.models.convert import to_numpy
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.mlp import nystrom_mlp
from modegpt_tpu_torch.ops.qk import compress_qk_layer_opt, compress_qk_layer_rope
from modegpt_tpu_torch.ops.vo import vo_factors_from_full, vo_full_factors

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["solve_chunk_batched", "solver_placement"]


def solver_placement(config: CompressionConfig, model_device: torch.device):
    """(device, dtype) the solves run in for ``config.solver_precision``."""
    if config.solver_precision == "f64_cpu":
        return torch.device("cpu"), torch.float64
    if config.solver_precision == "f32_device":
        return model_device, torch.float32
    raise ValueError(f"unknown solver_precision {config.solver_precision!r}")


def solve_chunk_batched(
    spec: ModelSpec,
    params: Dict,
    target_layers: Sequence[int],
    keep_ratios: List[float],
    calib: CalibrationResult,
    config: CompressionConfig,
    order: str,
) -> Dict[str, Dict[int, Dict[str, np.ndarray]]]:
    """Solve every requested suffix (mlp, qk, vo) for ``target_layers``.

    Returns ``{suffix: {layer: {name: numpy array}}}`` in HF layout —
    the factor store's contents.
    """
    if config.qk_method != "cr" and "qk" in order:
        raise NotImplementedError(
            f"modegpt_tpu_torch.compress.batched: qk_method {config.qk_method!r} is not ported"
        )
    layers = list(target_layers)
    dev, dt = solver_placement(config, params["embed_tokens"].device)
    whiten = "eigh" if config.solver_precision == "f64_cpu" else "cholesky"
    H, Hk = spec.n_heads, spec.n_kv_heads

    def hf(lp, name):  # forward kernel [in, out] -> HF [out, in] in the solve's place
        return lp[name]["kernel"].to(device=dev, dtype=dt).T

    def stat(covs, l):
        return covs[l].to(device=dev, dtype=dt)

    def type_one(C, mp, keep, rank, gated=True):
        """One Type-I solve of the MLP ``mp`` (forward-layout kernels)."""
        return nystrom_mlp(
            C.to(device=dev, dtype=dt), hf(mp, "up"), hf(mp, "gate") if gated else None, hf(mp, "down"),
            keep, config.nystrom_ridge, rank=rank,
        )

    out: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {s: {} for s in ("mlp", "qk", "vo") if s in order}
    for l in layers:
        lp = params["layers"][l]
        if "mlp" in order and spec.is_moe_layer(l):
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "mlp", layer=l)
            ek, cov = lp["experts"], calib.cov_mlp[l]
            experts = [
                type_one(cov[e], {name: {"kernel": ek[name]["kernel"][e]} for name in ek}, keep_ratios[l], rank)
                for e in range(spec.n_experts)
            ]
            fd = {name: to_numpy(torch.stack([getattr(f, name) for f in experts]))
                  for name in ("up", "gate", "down", "idx")}
            del experts
            if spec.has_shared_expert(l):
                s_rank = compress_ranks_for_layer(spec, keep_ratios[l], "shared")
                f = type_one(calib.cov_shared[l], lp["shared"], keep_ratios[l], s_rank)
                fd.update({"shared_" + name: to_numpy(getattr(f, name)) for name in ("up", "gate", "down", "idx")})
                logger.info("[MLP-shared] layer %d: shared expert compressed to rank %d", l, s_rank)
            out["mlp"][l] = fd
            logger.info("[MLP-MoE] layer %d: %d experts compressed to rank %d", l, spec.n_experts, rank)
        elif "mlp" in order:
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "mlp", layer=l)
            f = type_one(calib.cov_mlp[l], lp, keep_ratios[l], rank, spec.gated_mlp)
            fd = {"up": to_numpy(f.up), "down": to_numpy(f.down), "idx": to_numpy(f.idx)}
            if spec.gated_mlp:
                fd["gate"] = to_numpy(f.gate)
            elif "bias" in lp["up"]:
                # OPT fc1/fc2 biases: keep the kept-row fc1 bias and the
                # rank-independent fc2 bias (the reference's surgery drops
                # them, model_adapter.py:199-207).
                fd["up_bias"] = to_numpy(lp["up"]["bias"])[fd["idx"]]
                fd["down_bias"] = to_numpy(lp["down"]["bias"])
            out["mlp"][l] = fd
            logger.info("[MLP] layer %d compressed to rank %d", l, rank)

        if "qk" in order:
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "qk")
            # scores read only the covariance diagonals: float64 on the host
            cov_q = calib.cov_q[l].to(device="cpu", dtype=torch.float64)
            cov_k = calib.cov_k[l].to(device="cpu", dtype=torch.float64)
            if spec.uses_rope:
                f = compress_qk_layer_rope(cov_q, cov_k, hf(lp, "q"), hf(lp, "k"), rank, config.ridge_qk)
                fd = {"q": to_numpy(f.q), "k": to_numpy(f.k), "rotary_mask": to_numpy(f.rotary_mask)}
                if "bias" in lp["q"]:
                    # qkv biases on a RoPE arch (qwen2, starcoder2,
                    # qwen2_moe): the kept coordinates of each head,
                    # through the same mask
                    masks = fd["rotary_mask"]
                    bq = to_numpy(lp["q"]["bias"]).reshape(H, -1)
                    bk = to_numpy(lp["k"]["bias"]).reshape(Hk, -1)
                    mq = np.repeat(masks, spec.group_size, axis=0)
                    fd["q_bias"] = np.concatenate([bq[h][mq[h]] for h in range(H)])
                    fd["k_bias"] = np.concatenate([bk[h][masks[h]] for h in range(Hk)])
            else:
                f = compress_qk_layer_opt(
                    cov_q, cov_k, hf(lp, "q"), hf(lp, "k"),
                    lp["q"]["bias"].to(device=dev, dtype=dt), lp["k"]["bias"].to(device=dev, dtype=dt),
                    rank, config.ridge_qk,
                )
                fd = {"q": to_numpy(f.q), "k": to_numpy(f.k),
                      "q_bias": to_numpy(f.q_bias), "k_bias": to_numpy(f.k_bias)}
            out["qk"][l] = fd
            logger.info("[QK] layer %d compressed to rank %d per head", l, rank)

        if "vo" in order:
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "vo")
            v_full, o_full = vo_full_factors(
                stat(calib.cov_x, l), hf(lp, "v"), hf(lp, "o"), H, Hk, config.ridge_vo, whiten
            )
            f = vo_factors_from_full(v_full, o_full, rank, H, Hk)
            fd = {"v": to_numpy(f.v), "o": to_numpy(f.o)}
            if "bias" in lp["v"]:
                # v bias folds exactly into the o bias (attention weights
                # sum to 1); GQA repeats each kv head's bias over its group.
                b_v = to_numpy(lp["v"]["bias"]).astype(np.float64)
                if Hk != H:
                    b_v = np.repeat(b_v.reshape(Hk, -1), spec.group_size, axis=0).reshape(-1)
                W_o = to_numpy(lp["o"]["kernel"]).T.astype(np.float64)
                b_o = to_numpy(lp["o"]["bias"]).astype(np.float64) if "bias" in lp["o"] else np.zeros(spec.d_model)
                fd["o_bias"] = b_o + W_o @ b_v
            out["vo"][l] = fd
            logger.info("[VO] layer %d compressed to rank %d per head", l, rank)
    return out
