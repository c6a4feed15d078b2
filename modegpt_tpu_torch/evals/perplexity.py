"""Perplexity over sequential eval windows, and per-sample alpaca perplexity.

Port of ``modegpt_tpu.evals.perplexity``. `compute_perplexity`
(reference: src/eval.py:134-225): shifted cross-entropy summed over every
position of every window, and
``ppl = exp(sum_nll / (n_samples * (seq_len - 1)))`` (eval.py:220).
`compute_perplexity_alpaca` (reference: eval.py:257-295): each text
truncated on its own, mean NLL per text, texts weighted by their full
length. A heterogeneous-rank model runs either unrolled, layer by
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
from modegpt_tpu_torch.parallel.mesh import all_reduce, shard_batch

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["compute_perplexity", "compute_perplexity_alpaca", "resolve_exec_mode"]


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
    pads a non-uniform spec whose padding overhead is below 1.5x, except
    a mixed dense/MoE stack, which stays unrolled (padded, every layer
    would carry zero kernels of the other kind; reference rule:
    modegpt_tpu/evals/perplexity.py:84-96). An all-MoE stack pads like a
    dense one."""
    if exec_mode not in ("auto", "unrolled", "padded"):
        raise ValueError(f"exec_mode must be auto, unrolled or padded, got {exec_mode!r}")
    if exec_mode == "auto":
        mixed_moe = bool(spec.n_experts and spec.moe_layers)
        use_padded = not spec.is_uniform and not mixed_moe and padding_overhead(spec) < 1.5
        return "padded" if use_padded else "unrolled"
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
    mesh=None,
) -> float:
    """Perplexity over pre-chunked eval windows [n, seq_len], on the
    parameters' device. exec_mode: auto | unrolled | padded (see
    `resolve_exec_mode`).

    ``mesh`` (a `parallel.mesh.Mesh`, JAX ``perplexity.py:82-102``): each
    batch's windows are split over its ``data`` axis (the batch size must
    divide it) and the NLL sums all-reduced over it; ``params`` may be a
    tensor-parallel tree of its ``model`` axis. A mesh without a ``data``
    axis (stage-only) splits nothing. The padded path is single-device:
    with a ``data`` axis the unrolled one runs, with a warning, as in
    JAX."""
    mode = resolve_exec_mode(spec, exec_mode)
    rows_mesh = mesh if (mesh is not None and "data" in mesh.axis_names) else None
    if mode == "padded" and rows_mesh is not None:
        logger.warning("exec_mode=padded is single-device; the unrolled path runs because a mesh was passed")
        mode = "unrolled"
    if mode == "padded":
        pm = pad_to_uniform(spec, params)
        logger.info("eval: padded-uniform execution (%.1f%% FLOP overhead)", (padding_overhead(spec) - 1) * 100)

        def logits_of(batch):
            return forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, batch, attn_impl=attn_impl)
    else:
        def logits_of(batch):
            return forward(spec, params, batch, attn_impl=attn_impl, mesh=mesh)[0]

    device = params["embed_tokens"].device
    progress = progress and (mesh is None or mesh.rank == 0)
    n_samples, seq_len = eval_tokens.shape
    total_nll = 0.0
    local_rows = 0
    t_start = time.perf_counter()
    for i in range(0, n_samples, batch_size):
        j = min(i + batch_size, n_samples)
        rows = np.asarray(eval_tokens[i:j])
        if rows_mesh is not None:
            rows = shard_batch(rows_mesh, rows)
        batch = torch.as_tensor(rows, device=device)
        total_nll += float(_nll_from_logits(logits_of(batch), batch))
        local_rows += rows.shape[0]
        if progress and i > 0:
            elapsed = time.perf_counter() - t_start
            running = math.exp(total_nll / (local_rows * (seq_len - 1)))
            print(
                f"\rsample {j}/{n_samples} | ppl: {running:.2f} | "
                f"{j * seq_len / max(elapsed, 1e-9):,.0f} tok/s | {elapsed:.1f}s   ",
                end="", flush=True,
            )
    if rows_mesh is not None:
        total_nll = float(all_reduce(rows_mesh, torch.tensor(total_nll, dtype=torch.float64), "data"))
    elapsed = time.perf_counter() - t_start  # float() above synchronised the device
    tps = n_samples * seq_len / max(elapsed, 1e-9)
    if progress:
        print()
    logger.info("eval: %d tokens in %.2fs -> %.0f tok/s", n_samples * seq_len, elapsed, tps)
    if metrics is not None:
        metrics["throughput_tok/s"] = tps
        metrics["throughput_ktok/s"] = tps / 1000
    return math.exp(total_nll / (n_samples * (seq_len - 1)))


@torch.no_grad()
def _per_sample_nll(spec: ModelSpec, params: Dict, batch: torch.Tensor, lens: torch.Tensor, attn_impl: str = "auto"):
    """Per-row (sum of shifted NLL, valid position count) of right-padded
    rows: causal attention keeps the pad tokens out of the valid
    positions, so only the loss is masked."""
    logits, _ = forward(spec, params, batch, attn_impl=attn_impl)
    logp = torch.log_softmax(logits[:, :-1, :].to(torch.float32), dim=-1)
    del logits
    nll = -torch.gather(logp, -1, batch[:, 1:, None].long())[..., 0]  # [B, T-1]
    counts = torch.clamp(lens - 1, min=0)
    mask = torch.arange(nll.shape[1], device=nll.device)[None, :] < counts[:, None]
    return torch.sum(nll * mask, dim=1), counts


def compute_perplexity_alpaca(
    spec: ModelSpec,
    params: Dict,
    tokenizer,
    texts=None,
    max_length: int = 2048,
    batch_size: int = 8,
    progress: bool = True,
) -> float:
    """Per-sample truncated-window alpaca perplexity (the reference's
    ``evaluate_perplexity_alpaca``, eval.py:257-295): each held-out text
    is tokenized on its own WITH special tokens and truncated to
    ``max_length``; its loss is the mean shifted cross-entropy over its
    own window; texts combine weighted by their full length
    (``exp(sum loss_i * L_i / sum L_i)``), and non-finite losses are
    skipped. Texts are sorted by length and right-padded to power-of-two
    widths, a batch of ``batch_size`` per forward, on the parameters'
    device. ``texts`` defaults to the alpaca holdout
    (`calib.data._alpaca_texts`)."""
    if texts is None:
        from modegpt_tpu_torch.calib import data

        texts = data._alpaca_texts(tokenizer, calib=False)

    seqs = [
        np.asarray(tokenizer(t, truncation=True, max_length=max_length)["input_ids"], dtype=np.int32)
        for t in texts
    ]
    # per-text losses are independent, so the length order changes
    # nothing but the padding
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    device = params["embed_tokens"].device
    total_loss = 0.0
    total_tokens = 0
    for start in range(0, len(order), batch_size):
        chunk = [seqs[i] for i in order[start : start + batch_size]]
        lens = np.asarray([len(s) for s in chunk], dtype=np.int32)
        width = 1 << max(int(np.ceil(np.log2(max(int(lens.max()), 2)))), 1)
        width = min(width, max_length)
        batch = np.zeros((len(chunk), width), dtype=np.int32)
        for r, s in enumerate(chunk):
            batch[r, : len(s)] = s
        sums, counts = _per_sample_nll(
            spec, params, torch.as_tensor(batch, device=device), torch.as_tensor(lens, device=device)
        )
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        for r in range(len(chunk)):
            if counts[r] == 0:
                continue  # a one-token text: loss undefined (reference: isfinite skip)
            loss = sums[r] / counts[r]
            if not np.isfinite(loss):
                logger.warning("non-finite loss on a sample; skipping (reference: eval.py:279)")
                continue
            total_loss += float(loss) * int(lens[r])
            total_tokens += int(lens[r])
        if progress:
            print(f"\ralpaca sample {start + len(chunk)}/{len(order)}   ", end="", flush=True)
    if progress:
        print()
    if total_tokens == 0:
        return float("inf")
    return math.exp(total_loss / total_tokens)
