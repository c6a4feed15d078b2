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
  rotary mask; with ``qk_method="svd"`` on a non-RoPE arch (OPT,
  GPT-2), `ops.qk.compress_qk_layer_svd` on the layer input's Gram and
  the q/k kernels of ``params`` (JAX ``_solve_qk_svd_batched``), never
  from ``host_params``: its factors are no row slices;
* Type-III: `ops.vo.vo_full_factors`, sliced to rank.

A MoE layer's experts are solved one after another: the ridge of each
Cholesky escalates on its own matrix (`ops.psd`), which a batch over
the experts would have to carry per matrix.

Under ``config.debug`` the first two layers' Grams are logged with
`ops.psd.psd_diagnostics` (JAX ``batched.py:1083-1096``): the Type-I
Gram (a MoE layer's, one expert at a time) and the attention input's.

Precision follows ``config.solver_precision``: ``f64_cpu`` solves in
float64 on the CPU (VO whitening by eigh, the reference's); ``f32_device``
solves in float32 on the model's device (VO whitening by the escalated
Cholesky).

Where the factors land (``fetch``, JAX ``batched.py:1033-1073``):
``"host"`` gives numpy arrays in HF layout, ready for the factor store,
and counts the bytes the solve's factors moved to the host in
`FETCHED_BYTES`; ``"device"`` keeps the kernel factors as tensors on the
solve's device in the model's dtype, for surgery with no copy (the
selection metadata, ``idx``, rotary masks and biases, is numpy either
way). ``host_params`` (per-layer trees on the CPU, the streamed sweep's
host-staged weights) gathers the selection-type factors, the Type-I
up/gate rows and the Type-II q/k rows, from those trees by index: they
are row slices of the dense kernels, so they come out bit-identical to
the device's slices and never cross from the device. ``scratch_params``
lets the solve pop a layer's projection leaves from ``params`` once all
its factors are solved (the streamed sweep's disposable staged window),
freeing device memory for the next layer's solve.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.calib.engine import CalibrationResult
from modegpt_tpu_torch.compress.surgery import compress_ranks_for_layer
from modegpt_tpu_torch.config import CompressionConfig
from modegpt_tpu_torch.models.convert import to_numpy
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.mlp import nystrom_down, nystrom_mlp, nystrom_scores, nystrom_select
from modegpt_tpu_torch.ops.psd import psd_diagnostics
from modegpt_tpu_torch.ops.qk import (
    compress_qk_layer_opt,
    compress_qk_layer_rope,
    compress_qk_layer_svd,
    gather_heads,
    qk_opt_mask,
    qk_rope_mask,
)
from modegpt_tpu_torch.ops.vo import vo_factors_from_full, vo_full_factors
from modegpt_tpu_torch.parallel.mesh import gather_objects
from modegpt_tpu_torch.utils.profiling import span

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["solve_chunk_batched", "solver_placement", "FETCHED_BYTES"]

class _FetchCounter:
    """Bytes of solved factors moved to host numpy (`_fetch`). The
    streamed sweep reads the difference across a run for its
    ``fetched_bytes``. Thread-safe: async window flushes solve on a worker
    thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.total += n


FETCHED_BYTES = _FetchCounter()


def _fetch(t: torch.Tensor) -> np.ndarray:
    out = to_numpy(t)
    FETCHED_BYTES.add(out.nbytes)
    return out


def _tree_device(tree) -> torch.device:
    """The device of a parameter tree's first tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    children = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for child in children:
        dev = _tree_device(child)
        if dev is not None:
            return dev
    return None


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
    fetch: str = "host",
    scratch_params: bool = False,
    host_params: Optional[Dict[int, Dict]] = None,
    mesh=None,
    axis: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, Dict[int, Dict]]:
    """Solve every requested suffix (mlp, qk, vo) for ``target_layers``.

    Returns ``{suffix: {layer: {name: array}}}`` in HF layout: numpy
    under ``fetch="host"`` (the factor store's contents), device tensors
    for the kernel factors under ``fetch="device"``. ``params`` needs
    only ``params["layers"]``, the full (unsharded) layers; the solves
    run on ``device`` (default its layers' device; the CPU under
    ``f64_cpu``). See the module docstring for ``scratch_params`` and
    ``host_params``.

    ``mesh`` (a `parallel.mesh.Mesh`; the pipeline passes it under
    ``solver_precision="f32_device"`` only, JAX ``batched.py:169-224``):
    layer-parallel solves over ``axis`` (default the mesh's first axis).
    The rank at coordinate c on it, and 0 on every other axis, solves the
    layers with ``layer % n == c``; the others solve nothing. Layers are
    independent, so there is no communication until the factors (numpy,
    ``fetch="host"``) are gathered to rank 0, which returns them all;
    every other rank returns empty dicts. Under ``shard_stats`` the
    pipeline passes ``axis="data"``: the layers a rank solves are then
    exactly those whose Grams `calib.engine.calibrate` reduced to it.
    """
    if fetch not in ("host", "device"):
        raise ValueError(f"fetch must be host or device, got {fetch!r}")
    layers = list(target_layers)
    if mesh is not None:
        if fetch != "host":
            raise ValueError("layer-parallel solves gather host factors: fetch must be host")
        axis = axis or mesh.axis_names[0]
        none = {s: {} for s in ("mlp", "qk", "vo") if s in order}
        if any(mesh.coord(a) for a in mesh.axis_names if a != axis):
            return none
        n, c = mesh.size(axis), mesh.coord(axis)
        mine = [l for l in layers if l % n == c]
        solved = solve_chunk_batched(spec, params, mine, keep_ratios, calib, config, order,
                                     scratch_params=scratch_params, device=device) if mine else none
        parts = gather_objects(mesh, solved, axis, owner=0)
        if parts is None:
            return none
        return {s: {l: f for part in parts for l, f in part[s].items()} for s in none}
    with span("modegpt.compress.decompose"):
        return _solve_layers(spec, params, layers, keep_ratios, calib, config, order, fetch, scratch_params,
                             host_params, device)


def _solve_layers(spec, params, layers, keep_ratios, calib, config, order, fetch, scratch_params, host_params,
                  device) -> Dict[str, Dict[int, Dict]]:
    """`solve_chunk_batched` on this process alone."""
    dev, dt = solver_placement(config, device or _tree_device(params["layers"][layers[0]]))
    whiten = "eigh" if config.solver_precision == "f64_cpu" else "cholesky"
    H, Hk = spec.n_heads, spec.n_kv_heads
    if fetch == "device" or not host_params or not all(l in host_params for l in layers):
        host_params = None

    def hf(lp, name):  # forward kernel [in, out] -> HF [out, in] in the solve's place
        return lp[name]["kernel"].to(device=dev, dtype=dt).T

    def host_rows(lp, name, idx):
        """HF rows ``idx`` of a host-tree kernel, in the solve's dtype:
        the same values the solve's device would slice."""
        kernel = lp[name]["kernel"]  # [in, out] (MoE: one expert's)
        rows = torch.index_select(kernel, kernel.dim() - 1, idx.cpu().long()).transpose(-1, -2)
        return to_numpy(rows.to(dt).contiguous())

    # device-fetched factors in the model's dtype where it is bfloat16
    # (JAX `_fetch_dtype`), else in the solve's
    fdt = torch.bfloat16 if config.model_dtype == "bfloat16" else None

    def out_factor(t):
        if fetch == "host":
            return _fetch(t)
        return t.to(fdt) if fdt is not None else t

    def meta(t):  # selection metadata: numpy on both fetch modes
        return to_numpy(t) if isinstance(t, torch.Tensor) else t

    def type_one(C, mp, keep, rank, gated, host_mp):
        """One Type-I solve of the MLP ``mp`` (forward-layout kernels):
        {"up", "gate"?, "down", "idx"}, up/gate from ``host_mp`` when given."""
        C = C.to(device=dev, dtype=dt)
        if host_mp is None:
            f = nystrom_mlp(C, hf(mp, "up"), hf(mp, "gate") if gated else None, hf(mp, "down"), keep,
                            config.nystrom_ridge, rank=rank)
            fd = {"up": out_factor(f.up), "down": out_factor(f.down), "idx": meta(f.idx)}
            if gated:
                fd["gate"] = out_factor(f.gate)
            return fd
        idx = nystrom_select(nystrom_scores(C, config.nystrom_ridge), rank)
        fd = {"down": _fetch(nystrom_down(C, hf(mp, "down"), idx)), "idx": meta(idx),
              "up": host_rows(host_mp, "up", idx)}
        if gated:
            fd["gate"] = host_rows(host_mp, "gate", idx)
        return fd

    def stack(arrs):
        return torch.stack(arrs) if isinstance(arrs[0], torch.Tensor) else np.stack(arrs)

    if config.debug:
        # covariance conditioning of the first two layers (reference:
        # sqrt_M's debug prints, compression_utils.py:28-45); a MoE
        # layer's Type-I Grams one expert at a time
        for l in layers[:2]:
            grams = []
            if "mlp" in order:
                cov = calib.cov_mlp[l]
                if cov.dim() == 3:
                    grams += [(f"cov_mlp expert {e}", c, config.nystrom_ridge) for e, c in enumerate(cov)]
                else:
                    grams.append(("cov_mlp", cov, config.nystrom_ridge))
            if "vo" in order:
                grams.append(("cov_x", calib.cov_x[l], config.ridge_vo))
            for name, g, ridge in grams:
                logger.info("[debug] layer %d %s: %s", l, name, psd_diagnostics(g.to(device=dev, dtype=dt), ridge))
    out: Dict[str, Dict[int, Dict]] = {s: {} for s in ("mlp", "qk", "vo") if s in order}
    # the leaves each solved suffix makes dead (scratch_params)
    dead = [key for s, keys in (("mlp", ("up", "gate", "down", "experts", "shared")), ("qk", ("q", "k")),
                                ("vo", ("v", "o"))) if s in order for key in keys]
    for l in layers:
        lp = params["layers"][l]
        src = host_params[l] if host_params is not None else lp  # biases and host-sliced rows
        if "mlp" in order and spec.is_moe_layer(l):
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "mlp", layer=l)
            ek, cov = lp["experts"], calib.cov_mlp[l]
            hek = host_params[l]["experts"] if host_params is not None else None
            experts = [
                type_one(
                    cov[e], {name: {"kernel": ek[name]["kernel"][e]} for name in ek}, keep_ratios[l], rank, True,
                    {name: {"kernel": hek[name]["kernel"][e]} for name in hek} if hek is not None else None,
                )
                for e in range(spec.n_experts)
            ]
            fd = {name: stack([f[name] for f in experts]) for name in ("up", "gate", "down", "idx")}
            del experts
            if spec.has_shared_expert(l):
                s_rank = compress_ranks_for_layer(spec, keep_ratios[l], "shared")
                f = type_one(calib.cov_shared[l], lp["shared"], keep_ratios[l], s_rank, True,
                             host_params[l]["shared"] if host_params is not None else None)
                fd.update({"shared_" + name: v for name, v in f.items()})
                logger.info("[MLP-shared] layer %d: shared expert compressed to rank %d", l, s_rank)
            out["mlp"][l] = fd
            logger.info("[MLP-MoE] layer %d: %d experts compressed to rank %d", l, spec.n_experts, rank)
        elif "mlp" in order:
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "mlp", layer=l)
            fd = type_one(calib.cov_mlp[l], lp, keep_ratios[l], rank, spec.gated_mlp,
                          src if host_params is not None else None)
            if not spec.gated_mlp and "bias" in src["up"]:
                # OPT fc1/fc2 biases: keep the kept-row fc1 bias and the
                # rank-independent fc2 bias (the reference's surgery drops
                # them, model_adapter.py:199-207).
                fd["up_bias"] = to_numpy(src["up"]["bias"])[fd["idx"]]
                fd["down_bias"] = to_numpy(src["down"]["bias"])
            out["mlp"][l] = fd
            logger.info("[MLP] layer %d compressed to rank %d", l, rank)

        if "qk" in order:
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "qk")
            # scores read only the covariance diagonals: float64 on the host
            cov_q = calib.cov_q[l].to(device="cpu", dtype=torch.float64)
            cov_k = calib.cov_k[l].to(device="cpu", dtype=torch.float64)
            if config.qk_method == "svd" and not spec.uses_rope:
                biases = [src[n]["bias"].to(device=dev, dtype=dt) if "bias" in src[n] else None for n in "qk"]
                f = compress_qk_layer_svd(calib.cov_x[l].to(device=dev, dtype=dt), hf(lp, "q"), hf(lp, "k"),
                                          *biases, rank, config.ridge_qk, H)
                fd = {"q": out_factor(f.q), "k": out_factor(f.k)}
                if f.q_bias is not None:
                    fd.update(q_bias=meta(f.q_bias), k_bias=meta(f.k_bias))
            elif host_params is not None:
                # the rows of the host tree's kernels, by the same masks
                mask = (qk_rope_mask if spec.uses_rope else qk_opt_mask)(cov_q, cov_k, rank, config.ridge_qk)
                q_mask = torch.repeat_interleave(mask, spec.group_size, dim=0) if spec.uses_rope else mask
                n_k = Hk if spec.uses_rope else H

                def host_heads(name, n_h, m):
                    w = src[name]["kernel"].T  # [n_h*hd, d] HF rows, a view
                    return to_numpy(gather_heads(w, n_h, m).to(dt))

                fd = {"q": host_heads("q", H, q_mask), "k": host_heads("k", n_k, mask)}
                if spec.uses_rope:
                    fd["rotary_mask"] = to_numpy(mask.to(torch.int32))
                else:
                    fd["q_bias"] = to_numpy(gather_heads(src["q"]["bias"][:, None], H, mask)[:, 0].to(dt))
                    fd["k_bias"] = to_numpy(gather_heads(src["k"]["bias"][:, None], H, mask)[:, 0].to(dt))
            elif spec.uses_rope:
                f = compress_qk_layer_rope(cov_q, cov_k, hf(lp, "q"), hf(lp, "k"), rank, config.ridge_qk)
                fd = {"q": out_factor(f.q), "k": out_factor(f.k), "rotary_mask": meta(f.rotary_mask)}
            else:
                f = compress_qk_layer_opt(
                    cov_q, cov_k, hf(lp, "q"), hf(lp, "k"),
                    lp["q"]["bias"].to(device=dev, dtype=dt), lp["k"]["bias"].to(device=dev, dtype=dt),
                    rank, config.ridge_qk,
                )
                fd = {"q": out_factor(f.q), "k": out_factor(f.k),
                      "q_bias": meta(f.q_bias), "k_bias": meta(f.k_bias)}
            if spec.uses_rope and "bias" in src["q"]:
                # qkv biases on a RoPE arch (qwen2, starcoder2,
                # qwen2_moe): the kept coordinates of each head,
                # through the same mask
                masks = fd["rotary_mask"]
                bq = to_numpy(src["q"]["bias"]).reshape(H, -1)
                bk = to_numpy(src["k"]["bias"]).reshape(Hk, -1)
                mq = np.repeat(masks, spec.group_size, axis=0)
                fd["q_bias"] = np.concatenate([bq[h][mq[h]] for h in range(H)])
                fd["k_bias"] = np.concatenate([bk[h][masks[h]] for h in range(Hk)])
            out["qk"][l] = fd
            logger.info("[QK] layer %d compressed to rank %d per head", l, rank)

        if "vo" in order:
            rank = compress_ranks_for_layer(spec, keep_ratios[l], "vo")
            v_full, o_full = vo_full_factors(
                calib.cov_x[l].to(device=dev, dtype=dt), hf(lp, "v"), hf(lp, "o"), H, Hk, config.ridge_vo, whiten
            )
            f = vo_factors_from_full(v_full, o_full, rank, H, Hk)
            fd = {"v": out_factor(f.v), "o": out_factor(f.o)}
            if "bias" in src["v"]:
                # v bias folds exactly into the o bias (attention weights
                # sum to 1); GQA repeats each kv head's bias over its group.
                b_v = to_numpy(src["v"]["bias"]).astype(np.float64)
                if Hk != H:
                    b_v = np.repeat(b_v.reshape(Hk, -1), spec.group_size, axis=0).reshape(-1)
                W_o = to_numpy(src["o"]["kernel"]).T.astype(np.float64)
                b_o = to_numpy(src["o"]["bias"]).astype(np.float64) if "bias" in src["o"] else np.zeros(spec.d_model)
                fd["o_bias"] = b_o + W_o @ b_v
            out["vo"][l] = fd
            logger.info("[VO] layer %d compressed to rank %d per head", l, rank)
        if scratch_params:
            # only once the whole layer is solved: a solve retried after
            # running out of memory finds the layer's leaves whole
            for key in dead:
                lp.pop(key, None)
    return out
