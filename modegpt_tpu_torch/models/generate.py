"""Next-token sampling.

Port of ``modegpt_tpu.models.generate._sample``: greedy argmax, or
temperature sampling with HF's filter order temperature -> top-k ->
top-p (nucleus) -> min-p. The knobs are plain Python values fixed per
call, as the JAX function's static arguments are.

Random draws come from an explicit ``torch.Generator`` where the JAX
function takes a PRNG key. The two generators give different numbers
from the same seed, so a sampled stream here differs from the JAX
package's by construction; greedy decoding (temperature 0) is exact and
identical in both.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["_sample"]


def _sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float,
    top_k: Optional[int],
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample (or argmax) next tokens from [..., V] logits; returns int64
    ids of shape [...]. ``generator`` lives on the logits' device (None:
    torch's default generator); greedy ignores it. Ties in the argmax go
    to the lowest id, as in JAX."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep a token if the mass BEFORE it is < top_p; the top token
        # always survives (HF min_tokens_to_keep=1)
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        thr = torch.amin(sorted_desc.masked_fill(~keep, float("inf")), dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thr, float("-inf"))
    if min_p is not None and min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        pmax = torch.amax(probs, dim=-1, keepdim=True)
        # tokens tied at pmax always survive (min_p >= 1 -> argmax)
        logits = logits.masked_fill((probs < min_p * pmax) & (probs < pmax), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])
