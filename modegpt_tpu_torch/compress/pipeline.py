"""End-to-end compression pipeline.

Port of ``modegpt_tpu.compress.pipeline.run_compression`` (reference
driver: src/run_modegpt.py:72-196): load -> baseline PPL -> per
layer-chunk (calibrate -> allocate sparsity -> Type-I/II/III solves) ->
surgery -> save -> reload -> compressed PPL -> metrics, on one device.

The per-layer factor store doubles as a resume checkpoint: layers whose
factor files exist are skipped on a re-run, guarded by a fingerprint of
the run (`_check_factor_store`).

Every architecture the spec parses runs: the dense llama, mistral,
qwen2, qwen3, phi3, starcoder2, gemma, gemma2, olmo2, opt and gpt2 and
the mixture-of-experts mixtral, qwen3_moe and qwen2_moe; a mixed
dense/MoE stack calibrates every layer in one pass (`calib.engine`). The compressed evaluation runs unrolled or padded
(`evals.perplexity.resolve_exec_mode`).

A quantised ``artifact_dtype`` (int8, int4, nf4) saves the artifact in
that format; the job reloads it dequantised and evaluates that, as the
JAX pipeline does.

Calibration and solve run one of four ways (JAX
``pipeline.py:441-538``):

* chunked (default): per ``layers_per_step`` chunk, `calib.engine.calibrate`
  then `compress.batched.solve_chunk_batched`;
* ``calib_exec="window"``: the same chunks through
  `calib.engine.calibrate_window`;
* ``calib_exec="stream"``: `compress.offload.stream_calibrate_solve`, one
  forward for the whole job with the weights staged per layer. Layer
  leaves stay where they are: a model loaded from disk is loaded to the
  CPU and host-staged, leaves on the card stay resident. A host-staged
  model's baseline evaluation runs on the card from a temporary device
  copy (beyond the card's memory, pass ``skip_baseline_eval``); its
  compressed model is assembled and saved on the CPU, and the compressed
  evaluation reloads it onto the card;
* ``fused``: `compress.fused.fused_compress` (dense uniform RoPE stacks;
  no factor store).

`compress_in_memory` is the compress-then-serve handoff: no disk, and no
factor copy to the host.

On a process mesh (``mesh_shape`` or ``mesh``, `parallel.mesh`; JAX
``pipeline.py:338-700``) every rank runs this function. A mesh with a
``stage`` axis that `parallel.pp.supports_pp` accepts stages both
evaluations (`perplexity_pp`) and calibrates every layer in one pass
(`calibrate_pp`); a ``context`` axis calibrates through the ring
(`parallel.ring.calibrate_ring`) unless ``calib_exec="window"`` is asked
for explicitly; otherwise a ``model`` axis shards the weights Megatron
style (`param_shardings`; replicated under ``shard_sequence``, which
splits the calibration sequence over it instead) and a ``data`` axis
splits the calibration and evaluation rows. The streamed sweep runs
only without a mesh. Under ``solver_precision="f32_device"`` the solves
are layer-parallel over the mesh (`compress.batched`), otherwise rank 0
solves. Under tensor or pipeline parallelism the full tree stays in
host memory and each rank's device holds its shard. Only rank 0 writes
the factor store, the artifact and the metrics JSON; every rank waits at
a barrier after each write, then reloads the artifact for the compressed
evaluation.

``profile_dir`` traces the calibrate + solve section (the fused job, the
streamed sweep and the chunked loop) with `torch.profiler`
(`utils.profiling.trace`) into one Chrome trace a job, in which the
program's spans (`utils.profiling.SPANS`) mark the BI pre-pass, the Gram
taps and the solves.

``artifact_backend="orbax"`` saves and reloads the artifact as an orbax
checkpoint (`compress.orbax_format`), float32 or bfloat16.

`solve_layer` is the JAX package's public one-layer solve: one layer's
factors, dense or MoE, as host numpy in HF layout.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import os
import time
from typing import Dict, Optional

import torch

from modegpt_tpu_torch.calib.data import load_calibration_batches, load_eval_tokens
from modegpt_tpu_torch.calib.engine import CalibrationResult, calibrate, calibrate_window
from modegpt_tpu_torch.compress import offload
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
from modegpt_tpu_torch.parallel.mesh import Mesh, make_mesh, param_shardings
from modegpt_tpu_torch.parallel.pp import calibrate_pp, perplexity_pp, supports_pp
from modegpt_tpu_torch.parallel.ring import calibrate_ring, supports_ring
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device
from modegpt_tpu_torch.utils.metrics import MetricsRegistry
from modegpt_tpu_torch.utils.profiling import trace

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["run_compression", "compress_in_memory", "solve_layer"]


def solve_layer(
    spec: ModelSpec,
    layer_params: Dict,
    layer_idx: int,
    keep_ratio: float,
    calib: CalibrationResult,
    config: CompressionConfig,
    order: str,
    device: Optional[torch.device] = None,
) -> Dict[str, Dict]:
    """Run the requested solvers (``order``: mlp, qk, vo) for one layer;
    returns factor dicts keyed by suffix, every array host numpy in HF
    layout (JAX ``pipeline.solve_layer``). A MoE layer solves each
    expert against its routed tokens' Gram at the layer's one rank, and
    a shared expert at its own. The solves run where
    ``config.solver_precision`` puts them (`compress.batched`)."""
    out = solve_chunk_batched(spec, {"layers": {layer_idx: layer_params}}, [layer_idx],
                              {layer_idx: keep_ratio}, calib, config, order, device=device)
    return {suffix: factors[layer_idx] for suffix, factors in out.items()}


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


def _to_device(tree, device: Optional[torch.device], dtype: Optional[torch.dtype] = None):
    """The tree on ``device`` (None: each leaf where it is), floating
    leaves cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        cast = dtype if (dtype is not None and tree.is_floating_point()) else None
        return tree.to(device=device if device is not None else tree.device, dtype=cast)
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
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Run the full pipeline. Pass (spec, params[, tokenizer]) or let it
    load ``config.model`` from disk. Runs on ``device`` (default
    ``config.device``, itself "cuda" by default; asking for CUDA without
    it raises). ``mesh`` (default: built from ``config.mesh_shape``, on
    every rank of a launched job) runs the job SPMD over it (module
    docstring). Returns a results dict with baseline/compressed PPL, the
    artifact path, the reloaded compressed (spec, params) and the wall
    seconds of each step."""
    from modegpt_tpu_torch.utils.logging import setup_logging

    setup_logging()
    dev = resolve_device(config.device if device is None else device)
    if mesh is None and config.mesh_shape:
        mesh = make_mesh(config.mesh_shape, device=dev)
    if mesh is not None:
        dev = mesh.device
        logger.info("mesh: %s", mesh)
    rank0 = mesh is None or mesh.rank == 0
    metrics = MetricsRegistry(config.metrics_dir)
    metrics["args"] = config.to_dict()
    metrics["note"] = config.note
    results: Dict = {}
    steps = _Steps(dev)

    t0 = time.perf_counter()
    # the streamed sweep stages layer leaves from wherever they are; it
    # runs only without a mesh
    stream = config.calib_exec == "stream" and not config.fused and mesh is None
    if spec is None or params is None:
        from modegpt_tpu_torch.models.hf import load_hf_model

        spec, params, tokenizer = load_hf_model(config.model, device="cpu" if stream or mesh is not None else dev)
    check_supported(spec)
    pp_mode = supports_pp(spec, mesh)
    ring_mode = not pp_mode and config.calib_exec != "window" and supports_ring(spec, mesh)
    # tensor parallelism: each rank's device holds its shard, the full
    # tree (for the solves and surgery) stays in host memory, as it does
    # for the pipeline's stages
    tp = (mesh is not None and mesh.size("model") > 1 and not (pp_mode or ring_mode)
          and not config.fused and not config.shard_sequence)
    chunked = not (pp_mode or ring_mode or config.fused or config.calib_exec == "window")
    if mesh is not None and config.shard_stats and chunked and config.solver_precision != "f32_device":
        raise ValueError(
            "shard_stats leaves each data rank only its own layers' Grams; it needs the "
            "layer-parallel solves of solver_precision='f32_device'"
        )
    model_dtype = torch.bfloat16 if config.model_dtype == "bfloat16" else None
    params = _to_device(params, torch.device("cpu") if (tp or pp_mode) else None if stream else dev, model_dtype)
    local = param_shardings(mesh, spec, params) if tp else params  # what this rank's forwards run
    host_staged = stream and offload._host_staged(params, dev)
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
        # a host-staged model evaluates on the card from a temporary copy
        # (what the JAX jit does with host numpy), never on the CPU
        if pp_mode:
            # stage-sharded: the dense model never has to fit one device
            baseline_ppl = perplexity_pp(spec, params, eval_tokens, mesh, config.eval_batch_size, attn_impl)
        else:
            eval_params = _to_device(params, dev) if host_staged else local
            baseline_ppl = compute_perplexity(
                spec, eval_params, eval_tokens, config.eval_batch_size, metrics=metrics.run,
                attn_impl=attn_impl, mesh=mesh,
            )
            del eval_params
        logger.info("Baseline ppl: %s", baseline_ppl)
        metrics["baseline-ppl"] = baseline_ppl
        results["baseline_ppl"] = baseline_ppl
        t = steps("baseline_eval", t)

    if calib_batches is None:
        calib_batches = load_calibration_batches(
            tokenizer, config.dataset, config.calib_size, config.calibs_batch_size, seq_len,
            vocab_size=spec.vocab_size,
        )

    # ---- calibrate + solve (reference: run_modegpt.py:107-156) ----
    t_compress = time.perf_counter()
    if rank0:
        _check_factor_store(config, spec, order)
    if mesh is not None:
        mesh.barrier()
    suffixes = _suffixes(order)
    factors: Dict[str, Dict[int, Dict]] = {s: {} for s in suffixes}
    accumulate = "device" if config.solver_precision == "f32_device" else "host"
    fused_result = None
    t = time.perf_counter()
    with trace(config.profile_dir, dev):
        if config.fused:
            # the whole calibrate -> allocate -> solve -> surgery job at once;
            # bypasses the factor store and resume
            from modegpt_tpu_torch.compress.fused import fused_compress

            fused_result = fused_compress(spec, params, calib_batches, config, mesh=mesh)
            t = steps("fused", t)
        elif stream:
            # one forward for the whole job, weights staged per layer; the
            # factors persist window by window, so the sweep resumes like the
            # chunked loop below (which then only loads them)
            pending_all = [
                l for l in range(spec.n_layers)
                if not all(load_layer_factors(config.temp_storage_dir, l, s) is not None for s in suffixes)
            ]
            if pending_all:

                def persist(layers_done, chunk):
                    for s, by_layer in chunk.items():
                        for l, f in by_layer.items():
                            save_layer_factors(config.temp_storage_dir, l, s, f)

                stream_stats: Dict = {}
                _, bi_scores, _ = offload.stream_calibrate_solve(
                    spec, params, calib_batches, config, order,
                    on_window=persist, target_layers=pending_all, stats_out=stream_stats, device=dev,
                )
                metrics["stream_async_flush"] = bool(stream_stats["async_flush"])
                metrics["stream_flush_wait_s"] = stream_stats["flush_wait_s"]
                results["stream_stats"] = stream_stats
                _, max_sp = allocate_keep_ratios(
                    bi_scores, config.compression_ratio,
                    smoothing=config.sparsity_smoothing, max_sparsity=config.max_sparsity,
                )
                metrics["max_layer_sparsity"] = max_sp
                metrics["smoothing"] = config.sparsity_smoothing
                gc.collect()
                t = steps("stream", t)
        # the pipeline's stages split the accumulators: every layer in one pass
        layers_per_step = spec.n_layers if pp_mode else config.layers_per_step
        for start in range(0, 0 if fused_result else spec.n_layers, layers_per_step):
            target_layers = list(range(start, min(spec.n_layers, start + layers_per_step)))
            # Resume: skip layers whose factors are all on disk already.
            pending = [
                l for l in target_layers
                if not all(load_layer_factors(config.temp_storage_dir, l, s) is not None for s in suffixes)
            ]
            t = time.perf_counter()
            if pending:
                if pp_mode:
                    calib = calibrate_pp(spec, params, calib_batches, mesh, attn_impl)
                elif ring_mode:
                    # the sequence split over the context axis, K/V on a
                    # ring; an explicit calib_exec="window" wins over it
                    calib = calibrate_ring(spec, local, calib_batches, pending, mesh)
                elif config.calib_exec == "window":
                    # taps for the window only, BI for every layer, one forward
                    # over every layer a batch (the weights stay in place)
                    calib = calibrate_window(
                        spec, local, calib_batches, start, config.layers_per_step,
                        gram_precision=config.gram_precision, mesh=mesh,
                    )
                else:
                    calib = calibrate(
                        spec, local, calib_batches, pending,
                        accumulate=accumulate, gram_precision=config.gram_precision, mesh=mesh,
                        shard_sequence=config.shard_sequence, shard_stats=config.shard_stats,
                    )
                t = steps("calibrate", t)
                keep_ratios, max_sp = allocate_keep_ratios(
                    calib.bi_scores, config.compression_ratio,
                    smoothing=config.sparsity_smoothing, max_sparsity=config.max_sparsity,
                )
                metrics["max_layer_sparsity"] = max_sp
                metrics["smoothing"] = config.sparsity_smoothing
                t = steps("allocate", t)
                if mesh is not None and config.solver_precision == "f32_device":
                    # layer-parallel; the factors are gathered to rank 0
                    chunk = solve_chunk_batched(
                        spec, params, pending, keep_ratios, calib, config, order, mesh=mesh,
                        axis="data" if config.shard_stats else None, device=dev,
                    )
                elif rank0:
                    chunk = solve_chunk_batched(spec, params, pending, keep_ratios, calib, config, order, device=dev)
                else:
                    chunk = {}
                t = steps("solve", t)
                if rank0:
                    for s, by_layer in chunk.items():
                        for l, f in by_layer.items():
                            save_layer_factors(config.temp_storage_dir, l, s, f)
                if mesh is not None:
                    mesh.barrier()  # every rank reads the same store next
                del calib, chunk
                gc.collect()
            if rank0:
                for l in target_layers:
                    for s in suffixes:
                        factors[s][l] = load_layer_factors(config.temp_storage_dir, l, s)
            steps("factor_store", t)
    compress_seconds = time.perf_counter() - t_compress
    metrics["compress_seconds"] = compress_seconds
    results["compress_seconds"] = compress_seconds

    # ---- surgery + artifact (reference: run_modegpt.py:158-166), rank 0 ----
    # Count BEFORE surgery: release_dense pops replaced projections.
    t = time.perf_counter()
    n_before = count_params(params)
    del local
    save_dir = os.path.join(config.output_dir, "model")
    if rank0:
        if fused_result is not None:
            comp_spec, comp_params = fused_result
        else:
            # lands where the embedding is: a host-staged model is assembled
            # on the CPU (the compressed weights may not fit the card either)
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
            **({"shared_gate_ranks": list(comp_spec.shared_gate_ranks)} if comp_spec.shared_gate_ranks else {}),
        }
        results["params_before"] = n_before
        results["params_after"] = n_after
        logger.info(
            "params: %.1fM -> %.1fM (%.1f%% reduction)",
            n_before / 1e6, n_after / 1e6, 100 * (1 - n_after / max(n_before, 1)),
        )
        t = steps("surgery", t)
        save_compressed_model(
            save_dir, comp_spec, comp_params,
            tokenizer_source=config.model,
            metadata={"order": order, "compression_ratio": config.compression_ratio},
            dtype=config.artifact_dtype or config.model_dtype,
            backend=config.artifact_backend,
        )
    if mesh is not None:
        mesh.barrier()  # the artifact is on disk for every rank
    results["artifact_dir"] = save_dir
    t = steps("save_artifact", t)

    # ---- reload + compressed PPL (reference: run_modegpt.py:179-194) ----
    comp_params = params = fused_result = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the pipeline's stages each copy their own layers to the device
    comp_spec, comp_params, _ = load_compressed_model(save_dir, device="cpu" if pp_mode else dev)
    results["compressed_spec"] = comp_spec
    results["compressed_params"] = comp_params
    if not rank0:
        results["params_before"] = n_before
        results["params_after"] = count_params(comp_params)
    t = steps("reload_artifact", t)
    if not config.skip_final_eval:
        if pp_mode:
            from modegpt_tpu_torch.models.padded import pad_to_uniform

            compressed_ppl = perplexity_pp(
                comp_spec, comp_params, eval_tokens, mesh, config.eval_batch_size, attn_impl,
                padded=pad_to_uniform(comp_spec, comp_params),
            )
        else:
            compressed_ppl = compute_perplexity(
                comp_spec, comp_params, eval_tokens, config.eval_batch_size,
                metrics=metrics.run, attn_impl=attn_impl, exec_mode=config.compressed_exec, mesh=mesh,
            )
        logger.info("Compressed ppl: %s", compressed_ppl)
        metrics[f"ppl-{config.dataset}"] = compressed_ppl
        results["compressed_ppl"] = compressed_ppl
        steps("compressed_eval", t)

    results["step_seconds"] = steps.seconds
    results["total_seconds"] = time.perf_counter() - t0
    metrics["step_seconds"] = steps.seconds
    metrics["total_seconds"] = results["total_seconds"]
    if rank0:
        metrics.save()
    return results


def compress_in_memory(
    spec: ModelSpec,
    params: Dict,
    config: CompressionConfig,
    tokenizer=None,
    device: Optional[DeviceLike] = None,
):
    """Dense model in memory -> compressed model in memory, with no disk
    (JAX ``pipeline.py:54-110``): the compress-then-serve handoff. The
    reference has no such flow; it round-trips save_pretrained and a
    reload (run_modegpt.py:158-183).

    ``config.fused`` takes `compress.fused.fused_compress`; otherwise the
    layer-streamed sweep runs with device-fetched factors
    (``stream_fetch="device"``), releasing each dense projection as its
    factors land, and surgery consumes the factors on the card
    (``apply_factors(release_dense=True)``), so no factor is copied to
    the host. The tree is placed on ``device`` (default ``config.device``)
    first; the caller's tree is not mutated. Returns (compressed_spec,
    compressed_params).
    """
    dev = resolve_device(config.device if device is None else device)
    batches = load_calibration_batches(
        tokenizer, config.dataset, config.calib_size, config.calibs_batch_size,
        min(config.seq_len, spec.max_position_embeddings), vocab_size=spec.vocab_size,
    )
    # device-resident weights are the prerequisite for device fetch
    params = _to_device(params, dev)
    if config.fused:
        from modegpt_tpu_torch.compress.fused import fused_compress

        return fused_compress(spec, params, batches, config)

    model_dtype = "bfloat16" if params["embed_tokens"].dtype == torch.bfloat16 else "float32"
    cfg = dataclasses.replace(config, stream_fetch="device", model_dtype=model_dtype)
    factors, _, _ = offload.stream_calibrate_solve(
        spec, params, batches, cfg, order=config.order or "mlp,qk,vo", release_params=True, device=dev
    )
    return apply_factors(
        spec, params, factors.get("mlp", {}), factors.get("qk", {}), factors.get("vo", {}), release_dense=True
    )
