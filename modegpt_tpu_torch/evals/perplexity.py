"""Perplexity over sequential eval windows.

Port of ``modegpt_tpu.evals.perplexity.compute_perplexity`` (reference:
src/eval.py:134-225): shifted cross-entropy summed over every position
of every window, and ``ppl = exp(sum_nll / (n_samples * (seq_len - 1)))``
(eval.py:220). A heterogeneous-rank model runs either unrolled, layer by
layer at its exact ranks, or padded (`models.padded.forward_padded`,
every layer zero-padded to the stack's widest ranks); ``auto`` takes
padded when the padding costs less than 1.5x the exact FLOPs, as the JAX
package does. Both give the same perplexity up to float reassociation.
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
from modegpt_tpu_torch.models.padded import forward_padded, pad_to_uniform, padding_overhead
from modegpt_tpu_torch.models.spec import ModelSpec

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["compute_perplexity", "resolve_exec_mode"]


def _nll_from_logits(logits: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """Sum of shifted per-position NLL over the batch, in float32."""
    V = logits.shape[-1]
    return F.cross_entropy(
        logits[:, :-1, :].reshape(-1, V).to(torch.float32),
        batch[:, 1:].reshape(-1).long(),
        reduction="sum",
    )


def resolve_exec_mode(spec: ModelSpec, exec_mode: str) -> str:
    """"padded" or "unrolled" for ``exec_mode`` auto|padded|unrolled: auto
    pads a non-uniform spec whose padding overhead is below 1.5x
    (reference rule: modegpt_tpu/evals/perplexity.py:89-96; mixed
    dense/MoE stacks never reach here, MoE is not ported)."""
    if exec_mode not in ("auto", "unrolled", "padded"):
        raise ValueError(f"exec_mode must be auto, unrolled or padded, got {exec_mode!r}")
    if exec_mode == "auto":
        return "padded" if not spec.is_uniform and padding_overhead(spec) < 1.5 else "unrolled"
    return exec_mode


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
    parameters' device. exec_mode: auto | unrolled | padded (see
    `resolve_exec_mode`)."""
    mode = resolve_exec_mode(spec, exec_mode)
    if mode == "padded":
        pm = pad_to_uniform(spec, params)
        logger.info("eval: padded-uniform execution (%.1f%% FLOP overhead)", (padding_overhead(spec) - 1) * 100)

        def logits_of(batch):
            return forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, batch, attn_impl=attn_impl)
    else:
        def logits_of(batch):
            return forward(spec, params, batch, attn_impl=attn_impl)[0]

    device = params["embed_tokens"].device
    n_samples, seq_len = eval_tokens.shape
    total_nll = 0.0
    t_start = time.perf_counter()
    for i in range(0, n_samples, batch_size):
        j = min(i + batch_size, n_samples)
        batch = torch.as_tensor(np.asarray(eval_tokens[i:j]), device=device)
        total_nll += float(_nll_from_logits(logits_of(batch), batch))
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
