"""Perplexity over sequential eval windows.

Port of ``modegpt_tpu.evals.perplexity.compute_perplexity`` (reference:
src/eval.py:134-225): shifted cross-entropy summed over every position
of every window, and ``ppl = exp(sum_nll / (n_samples * (seq_len - 1)))``
(eval.py:220). Heterogeneous-rank models run unrolled, layer by layer;
the JAX package's padded execution is not ported (``auto`` means
unrolled here; both give the same perplexity up to float reassociation).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from modegpt_tpu_torch.models.forward import forward
from modegpt_tpu_torch.models.spec import ModelSpec

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["compute_perplexity"]


def _batch_nll(spec: ModelSpec, params: Dict, batch: torch.Tensor, attn_impl: str) -> torch.Tensor:
    """Sum of shifted per-position NLL over the batch, in float32."""
    logits, _ = forward(spec, params, batch, attn_impl=attn_impl)
    V = logits.shape[-1]
    return F.cross_entropy(
        logits[:, :-1, :].reshape(-1, V).to(torch.float32),
        batch[:, 1:].reshape(-1).long(),
        reduction="sum",
    )


def compute_perplexity(
    spec: ModelSpec,
    params: Dict,
    eval_tokens: np.ndarray,
    batch_size: int = 16,
    metrics: Optional[Dict] = None,
    progress: bool = True,
    attn_impl: str = "auto",
    exec_mode: str = "auto",
) -> float:
    """Perplexity over pre-chunked eval windows [n, seq_len], on the
    parameters' device."""
    if exec_mode == "padded":
        raise NotImplementedError(
            "modegpt_tpu_torch.evals.perplexity: compressed_exec=padded is not ported "
            "(auto and unrolled run unrolled)"
        )
    if exec_mode not in ("auto", "unrolled"):
        raise ValueError(f"exec_mode must be auto, unrolled or padded, got {exec_mode!r}")
    device = params["embed_tokens"].device
    n_samples, seq_len = eval_tokens.shape
    total_nll = 0.0
    t_start = time.perf_counter()
    for i in range(0, n_samples, batch_size):
        j = min(i + batch_size, n_samples)
        batch = torch.as_tensor(np.asarray(eval_tokens[i:j]), device=device)
        total_nll += float(_batch_nll(spec, params, batch, attn_impl))
        if progress and i > 0:
            elapsed = time.perf_counter() - t_start
            running = math.exp(total_nll / (j * (seq_len - 1)))
            print(
                f"\rsample {j}/{n_samples} | ppl: {running:.2f} | "
                f"{j * seq_len / max(elapsed, 1e-9):,.0f} tok/s | {elapsed:.1f}s   ",
                end="", flush=True,
            )
    elapsed = time.perf_counter() - t_start  # float() above synchronised the device
    tps = n_samples * seq_len / max(elapsed, 1e-9)
    if progress:
        print()
    logger.info("eval: %d tokens in %.2fs -> %.0f tok/s", n_samples * seq_len, elapsed, tps)
    if metrics is not None:
        metrics["throughput_tok/s"] = tps
        metrics["throughput_ktok/s"] = tps / 1000
    return math.exp(total_nll / (n_samples * (seq_len - 1)))
