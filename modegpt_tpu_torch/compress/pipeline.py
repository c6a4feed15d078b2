"""End-to-end compression pipeline.

Port of ``modegpt_tpu.compress.pipeline.run_compression`` (reference
driver: src/run_modegpt.py:72-196): load -> baseline PPL -> per
layer-chunk (calibrate -> allocate sparsity -> Type-I/II/III solves) ->
surgery -> save -> reload -> compressed PPL -> metrics, on one device.

The per-layer factor store doubles as a resume checkpoint: layers whose
factor files exist are skipped on a re-run, guarded by a fingerprint of
the run (`_check_factor_store`).

Paths of the JAX pipeline that this port does not have raise
NotImplementedError up front: fused compression, windowed and streamed
calibration, meshes (data/model parallel, pipeline and ring), padded
compressed execution, qk_method=svd, quantised or orbax artifacts and
profiler traces.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import time
from typing import Dict, Optional

import torch

from modegpt_tpu_torch.calib.data import load_calibration_batches, load_eval_tokens
from modegpt_tpu_torch.calib.engine import calibrate
from modegpt_tpu_torch.compress.artifact import (
    load_compressed_model,
    load_layer_factors,
    save_compressed_model,
    save_layer_factors,
)
from modegpt_tpu_torch.compress.batched import solve_chunk_batched
from modegpt_tpu_torch.compress.surgery import apply_factors
from modegpt_tpu_torch.config import CompressionConfig
from modegpt_tpu_torch.evals.perplexity import compute_perplexity
from modegpt_tpu_torch.models.forward import check_supported
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.allocation import allocate_keep_ratios
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device
from modegpt_tpu_torch.utils.metrics import MetricsRegistry

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["run_compression"]


def _check_ported(config: CompressionConfig) -> None:
    """Raise for a knob that selects a path this port does not have."""
    unported = {
        "fused": config.fused,
        f"calib_exec={config.calib_exec}": config.calib_exec in ("window", "stream"),
        f"mesh_shape={config.mesh_shape!r} (modegpt_tpu_torch.parallel)": bool(config.mesh_shape),
        "shard_sequence": config.shard_sequence,
        "shard_stats": config.shard_stats,
        "compressed_exec=padded": config.compressed_exec == "padded",
        f"qk_method={config.qk_method}": config.qk_method != "cr",
        f"artifact_dtype={config.artifact_dtype}": config.artifact_dtype not in ("", "float32", "bfloat16"),
        f"artifact_backend={config.artifact_backend}": config.artifact_backend != "npz",
        "profile_dir": bool(config.profile_dir),
    }
    names = [name for name, on in unported.items() if on]
    if names:
        raise NotImplementedError(
            "modegpt_tpu_torch.compress.pipeline: not ported: " + ", ".join(names)
        )


def _suffixes(order: str):
    return [s for s in ("mlp", "qk", "vo") if s in order]


def _check_factor_store(config: CompressionConfig, spec: ModelSpec, order: str) -> None:
    """Guard the resume store against stale factors from a different run:
    a fingerprint sidecar makes resuming with factors solved for another
    model, ratio or order fail loudly (reference: temp_storage_dir,
    model_adapter.py:184-191)."""
    fingerprint = {
        "model": config.model,
        "spec": spec.to_dict(),
        "order": order,
        "compression_ratio": config.compression_ratio,
        "sparsity_smoothing": config.sparsity_smoothing,
        "max_sparsity": config.max_sparsity,
        "calib": [config.dataset, config.calib_size, config.seed],
        "ridges": [config.nystrom_ridge, config.ridge_qk, config.ridge_vo],
        "qk_method": config.qk_method,
    }
    # normalise through JSON so tuples compare equal to the reloaded lists
    fingerprint = json.loads(json.dumps(fingerprint))
    store = os.path.expandvars(config.temp_storage_dir)
    meta_path = os.path.join(store, "store_meta.json")
    os.makedirs(store, exist_ok=True)
    has_factors = any(f.startswith("layer_") for f in os.listdir(store))
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            existing = json.load(f)
        if existing != fingerprint:
            raise ValueError(
                f"temp_storage_dir {store!r} holds factors from a different "
                "run (model/ratio/order/ridges differ). Point "
                "--temp_storage_dir at a fresh directory or delete the old "
                "factors to re-solve."
            )
    elif has_factors:
        raise ValueError(
            f"temp_storage_dir {store!r} holds factor files with no "
            "fingerprint (pre-existing or foreign). Use a fresh directory."
        )
    with open(meta_path, "w") as f:
        json.dump(fingerprint, f, indent=2)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel()) if isinstance(params, torch.Tensor) else 0


def _to_device(tree, device: torch.device, dtype: Optional[torch.dtype] = None):
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        cast = dtype if (dtype is not None and tree.is_floating_point()) else None
        return tree.to(device=device, dtype=cast)
    return tree


class _Steps:
    """Wall seconds per pipeline step, the device drained at each end."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}

    def __call__(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - t0
        return now


def run_compression(
    config: CompressionConfig,
    spec: Optional[ModelSpec] = None,
    params: Optional[Dict] = None,
    tokenizer=None,
    calib_batches=None,
    eval_tokens=None,
    device: Optional[DeviceLike] = None,
) -> Dict:
    """Run the full pipeline. Pass (spec, params[, tokenizer]) or let it
    load ``config.model`` from disk. Runs on ``device`` (default
    ``config.device``, itself "cuda" by default; asking for CUDA without
    it raises). Returns a results dict with baseline/compressed PPL, the
    artifact path, the reloaded compressed (spec, params) and the wall
    seconds of each step."""
    from modegpt_tpu_torch.utils.logging import setup_logging

    setup_logging()
    _check_ported(config)
    dev = resolve_device(config.device if device is None else device)
    metrics = MetricsRegistry(config.metrics_dir)
    metrics["args"] = config.to_dict()
    metrics["note"] = config.note
    results: Dict = {}
    steps = _Steps(dev)

    t0 = time.perf_counter()
    if spec is None or params is None:
        from modegpt_tpu_torch.models.hf import load_hf_model

        spec, params, tokenizer = load_hf_model(config.model, device=dev)
    check_supported(spec)
    model_dtype = torch.bfloat16 if config.model_dtype == "bfloat16" else None
    params = _to_device(params, dev, model_dtype)
    order = config.order or "mlp,qk,vo"
    # Cap sequence length by the model's positional capacity
    # (reference: eval.py:127 min(2048, max_position_embeddings)).
    seq_len = min(config.seq_len, spec.max_position_embeddings)
    if seq_len != config.seq_len:
        logger.info("seq_len capped to max_position_embeddings: %d", seq_len)

    # ---- baseline PPL (reference: run_modegpt.py:91-99) ----
    if eval_tokens is None and not (config.skip_baseline_eval and config.skip_final_eval):
        eval_tokens = load_eval_tokens(
            tokenizer, config.dataset, seq_len, config.eval_max_samples, vocab_size=spec.vocab_size
        )
    attn_impl = "auto" if config.use_flash_attention else "xla"
    t = steps("load", t0)
    if not config.skip_baseline_eval:
        baseline_ppl = compute_perplexity(
            spec, params, eval_tokens, config.eval_batch_size, metrics=metrics.run, attn_impl=attn_impl
        )
        logger.info("Baseline ppl: %s", baseline_ppl)
        metrics["baseline-ppl"] = baseline_ppl
        results["baseline_ppl"] = baseline_ppl
        t = steps("baseline_eval", t)

    if calib_batches is None:
        calib_batches = load_calibration_batches(
            tokenizer, config.dataset, config.calib_size, config.calibs_batch_size, seq_len,
            vocab_size=spec.vocab_size,
        )

    # ---- layer-chunked calibrate + solve (reference: run_modegpt.py:107-156) ----
    t_compress = time.perf_counter()
    _check_factor_store(config, spec, order)
    suffixes = _suffixes(order)
    factors: Dict[str, Dict[int, Dict]] = {s: {} for s in suffixes}
    accumulate = "device" if config.solver_precision == "f32_device" else "host"
    for start in range(0, spec.n_layers, config.layers_per_step):
        target_layers = list(range(start, min(spec.n_layers, start + config.layers_per_step)))
        # Resume: skip layers whose factors are all on disk already.
        pending = [
            l for l in target_layers
            if not all(load_layer_factors(config.temp_storage_dir, l, s) is not None for s in suffixes)
        ]
        t = time.perf_counter()
        if pending:
            calib = calibrate(
                spec, params, calib_batches, pending,
                accumulate=accumulate, gram_precision=config.gram_precision,
            )
            t = steps("calibrate", t)
            keep_ratios, max_sp = allocate_keep_ratios(
                calib.bi_scores, config.compression_ratio,
                smoothing=config.sparsity_smoothing, max_sparsity=config.max_sparsity,
            )
            metrics["max_layer_sparsity"] = max_sp
            metrics["smoothing"] = config.sparsity_smoothing
            t = steps("allocate", t)
            chunk = solve_chunk_batched(spec, params, pending, keep_ratios, calib, config, order)
            t = steps("solve", t)
            for s, by_layer in chunk.items():
                for l, f in by_layer.items():
                    save_layer_factors(config.temp_storage_dir, l, s, f)
            del calib, chunk
            gc.collect()
        for l in target_layers:
            for s in suffixes:
                factors[s][l] = load_layer_factors(config.temp_storage_dir, l, s)
        steps("factor_store", t)
    compress_seconds = time.perf_counter() - t_compress
    metrics["compress_seconds"] = compress_seconds
    results["compress_seconds"] = compress_seconds

    # ---- surgery + artifact (reference: run_modegpt.py:158-166) ----
    # Count BEFORE surgery: release_dense pops replaced projections.
    t = time.perf_counter()
    n_before = count_params(params)
    comp_spec, comp_params = apply_factors(
        spec, params,
        mlp_factors=factors.get("mlp"), qk_factors=factors.get("qk"), vo_factors=factors.get("vo"),
        release_dense=config.release_dense,
    )
    del factors
    n_after = count_params(comp_params)
    metrics["params_before"] = n_before
    metrics["params_after"] = n_after
    metrics["achieved_compression"] = 1.0 - n_after / max(n_before, 1)
    metrics["rank_lists"] = {
        "q_ranks": list(comp_spec.q_ranks),
        "k_ranks": list(comp_spec.k_ranks),
        "v_ranks": list(comp_spec.v_ranks),
        "o_ranks": list(comp_spec.o_ranks),
        "gate_ranks": list(comp_spec.gate_ranks),
    }
    results["params_before"] = n_before
    results["params_after"] = n_after
    logger.info(
        "params: %.1fM -> %.1fM (%.1f%% reduction)",
        n_before / 1e6, n_after / 1e6, 100 * (1 - n_after / max(n_before, 1)),
    )
    t = steps("surgery", t)
    save_dir = os.path.join(config.output_dir, "model")
    save_compressed_model(
        save_dir, comp_spec, comp_params,
        tokenizer_source=config.model,
        metadata={"order": order, "compression_ratio": config.compression_ratio},
        dtype=config.artifact_dtype or config.model_dtype,
        backend=config.artifact_backend,
    )
    results["artifact_dir"] = save_dir
    t = steps("save_artifact", t)

    # ---- reload + compressed PPL (reference: run_modegpt.py:179-194) ----
    del comp_params, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    comp_spec, comp_params, _ = load_compressed_model(save_dir, device=dev)
    results["compressed_spec"] = comp_spec
    results["compressed_params"] = comp_params
    t = steps("reload_artifact", t)
    if not config.skip_final_eval:
        compressed_ppl = compute_perplexity(
            comp_spec, comp_params, eval_tokens, config.eval_batch_size,
            metrics=metrics.run, attn_impl=attn_impl, exec_mode=config.compressed_exec,
        )
        logger.info("Compressed ppl: %s", compressed_ppl)
        metrics[f"ppl-{config.dataset}"] = compressed_ppl
        results["compressed_ppl"] = compressed_ppl
        steps("compressed_eval", t)

    results["step_seconds"] = steps.seconds
    results["total_seconds"] = time.perf_counter() - t0
    metrics["step_seconds"] = steps.seconds
    metrics["total_seconds"] = results["total_seconds"]
    metrics.save()
    return results
