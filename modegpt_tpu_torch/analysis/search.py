"""Hyperparameter search for compression knobs.

Port of ``modegpt_tpu.analysis.search``: the same search space, the same
trial draws from the same seed and the same staged scheme, with the
port's `run_compression` and `compute_perplexity` on the config's device
(CUDA by default). The reference's harness is an optuna study minimising
compressed perplexity over nystrom_ridge / sparsity_smoothing / ridge_vo
/ ridge_qk (reference: src/analysis/optuna.py). Optuna is not installed
everywhere, so this module provides:

* `objective(trial, base_config, ...)`: an optuna objective over the
  reference's search space (optuna.py:16-31);
* `run_optuna_study(...)`: the full study, gated on importing optuna;
* `random_search(...)`: a dependency-free log-uniform sampler over the
  same space;
* `make_proxy_run_fn(...)` / `staged_search(...)`: a population of trials
  scored by a cheap proxy (the job without its baseline and final
  evaluations, a fresh factor store per trial, then perplexity at a
  short sequence length on a small fixed eval subset), and only the top
  finalists scored again at 4x the context and samples.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random
from typing import Callable, Dict, List, Optional, Tuple

from modegpt_tpu_torch.config import CompressionConfig

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = [
    "SEARCH_SPACE",
    "objective",
    "run_optuna_study",
    "random_search",
    "make_proxy_run_fn",
    "staged_search",
]

# The reference's search space (src/analysis/optuna.py:17-24).
SEARCH_SPACE = {
    "nystrom_ridge": (1e-6, 1e-1, "log"),
    "sparsity_smoothing": (1e-3, 0.3, "log"),
    "ridge_vo": (1e-7, 1e-2, "log"),
    "ridge_qk": (1e-7, 1e-1, "log"),
}


def _apply_params(base_config: CompressionConfig, params: Dict) -> CompressionConfig:
    return dataclasses.replace(base_config, **params)


def objective(trial, base_config: CompressionConfig, run_fn: Optional[Callable] = None):
    """Optuna objective: minimize compressed PPL (reference: optuna.py:9-35)."""
    params = {
        name: trial.suggest_float(name, lo, hi, log=(scale == "log"))
        for name, (lo, hi, scale) in SEARCH_SPACE.items()
    }
    config = _apply_params(base_config, params)
    if run_fn is None:
        from modegpt_tpu_torch.compress.pipeline import run_compression

        run_fn = lambda cfg: run_compression(cfg)["compressed_ppl"]
    return run_fn(config)


def run_optuna_study(
    base_config: CompressionConfig,
    n_trials: int = 20,
    storage: str = "sqlite:///optuna_modegpt.db",
    study_name: str = "modegpt_tpu",
    run_fn: Optional[Callable] = None,
):
    """Reference-parity study (sqlite storage, minimize)."""
    try:
        import optuna
    except ImportError as e:
        raise ImportError(
            "optuna is not installed in this environment; use "
            "modegpt_tpu_torch.analysis.search.random_search instead"
        ) from e

    study = optuna.create_study(
        study_name=study_name, storage=storage, direction="minimize", load_if_exists=True
    )
    study.optimize(lambda t: objective(t, base_config, run_fn), n_trials=n_trials)
    logger.info("best params: %s (ppl %.4f)", study.best_params, study.best_value)
    return study


def random_search(
    base_config: CompressionConfig,
    run_fn: Callable[[CompressionConfig], float],
    n_trials: int = 20,
    seed: int = 1234,
) -> Tuple[Dict, float, List[Tuple[Dict, float]]]:
    """Dependency-free log-uniform random search over the same space."""
    rng = random.Random(seed)
    history: List[Tuple[Dict, float]] = []
    best: Optional[Tuple[Dict, float]] = None
    for i in range(n_trials):
        params = {}
        for name, (lo, hi, scale) in SEARCH_SPACE.items():
            if scale == "log":
                params[name] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            else:
                params[name] = rng.uniform(lo, hi)
        value = run_fn(_apply_params(base_config, params))
        history.append((params, value))
        if best is None or value < best[1]:
            best = (params, value)
        logger.info("trial %d/%d: %.4f (best %.4f)", i + 1, n_trials, value, best[1])
    return best[0], best[1], history


def make_proxy_run_fn(
    base_config: CompressionConfig,
    spec,
    params,
    tokenizer=None,
    proxy_seq_len: int = 256,
    proxy_samples: int = 32,
    proxy_batch_size: int = 8,
) -> Callable[[CompressionConfig], float]:
    """Cheap trial objective: the compression job without its baseline
    and final evaluations (a fresh factor store and artifact directory
    per trial under ``temp_storage_dir``, removed once the job has
    reloaded its artifact: unlike the JAX function, a search leaves no
    artifact per trial on disk), scored by perplexity at a short sequence
    length on a small fixed eval subset."""
    import os
    import shutil
    import tempfile

    from modegpt_tpu_torch.calib.data import load_calibration_batches, load_eval_tokens
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.evals.perplexity import compute_perplexity

    seq_len = min(proxy_seq_len, spec.max_position_embeddings)
    eval_tokens = load_eval_tokens(
        tokenizer, base_config.dataset, seq_len, proxy_samples, vocab_size=spec.vocab_size
    )
    calib_batches = load_calibration_batches(
        tokenizer,
        base_config.dataset,
        base_config.calib_size,
        base_config.calibs_batch_size,
        min(base_config.seq_len, spec.max_position_embeddings),
        vocab_size=spec.vocab_size,
    )
    root = os.path.join(base_config.temp_storage_dir, "proxy_trials")

    def run(cfg: CompressionConfig) -> float:
        trial_dir = tempfile.mkdtemp(prefix="trial_", dir=_ensure(root))
        cfg = dataclasses.replace(
            cfg,
            skip_baseline_eval=True,
            skip_final_eval=True,
            temp_storage_dir=os.path.join(trial_dir, "layers"),
            output_dir=os.path.join(trial_dir, "out"),
        )
        try:
            res = run_compression(
                cfg, spec=spec, params=params, tokenizer=tokenizer, calib_batches=calib_batches
            )
        finally:
            shutil.rmtree(trial_dir, ignore_errors=True)  # the model is in memory now
        return compute_perplexity(
            res["compressed_spec"],
            res["compressed_params"],
            eval_tokens,
            proxy_batch_size,
            progress=False,
        )

    return run


def _ensure(d):
    import os

    os.makedirs(d, exist_ok=True)
    return d


def staged_search(
    base_config: CompressionConfig,
    spec,
    params,
    tokenizer=None,
    n_trials: int = 16,
    top_k: int = 3,
    seed: int = 1234,
    full_run_fn: Optional[Callable] = None,
    **proxy_kw,
) -> Tuple[Dict, float, List[Tuple[Dict, float]]]:
    """Population-then-finalists search: n_trials proxy-scored candidates,
    the top_k re-scored by `full_run_fn` (default: the proxy at 4x the
    context and samples). Returns (best_params, best_full_score, proxy
    history)."""
    proxy = make_proxy_run_fn(base_config, spec, params, tokenizer, **proxy_kw)
    _, _, history = random_search(base_config, proxy, n_trials=n_trials, seed=seed)

    if full_run_fn is None:
        full_run_fn = make_proxy_run_fn(
            base_config,
            spec,
            params,
            tokenizer,
            proxy_seq_len=4 * proxy_kw.get("proxy_seq_len", 256),
            proxy_samples=4 * proxy_kw.get("proxy_samples", 32),
        )
    finalists = sorted(history, key=lambda kv: kv[1])[:top_k]
    logger.info(
        "staged search: %d proxy trials -> %d finalists (proxy best %.4f)",
        n_trials, len(finalists), finalists[0][1],
    )
    scored = [(p, full_run_fn(_apply_params(base_config, p))) for p, _ in finalists]
    best_params, best_val = min(scored, key=lambda kv: kv[1])
    logger.info("staged search best: %s (full score %.4f)", best_params, best_val)
    return best_params, best_val, history
