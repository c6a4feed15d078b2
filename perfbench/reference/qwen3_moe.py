"""The plain Qwen3-MoE decoder (``qwen3_moe``) in float32, dense or
MoDeGPT-compressed.

Written from the published description (HF ``Qwen3MoeForCausalLM``): the
attention half of a Qwen3 layer (`qwen3.layer`: RMSNorm, per-head q/k
RMSNorm, RoPE, grouped-query causal attention) and, in place of the
dense MLP, a sparse mixture of experts on every layer
(``decoder_sparse_step`` 1, no ``mlp_only_layers``): after the pre-MLP
RMSNorm a router ``x @ W_r`` gives ``num_experts`` logits per token, a
float32 softmax over all of them, the top ``num_experts_per_tok``
(ties to the lower expert index), renormalised to sum to 1 when
``norm_topk_prob``; each chosen expert is a SiLU-gated MLP whose output
is added, weighted by its routing weight. No shared expert. A
compressed layer's experts keep ``rm`` of their columns each (one rank
for every expert of a layer); widths are read off the kernels.

Each expert runs only on the tokens routed to it, gathered by index,
and its weighted output is scattered back with an add: the experts'
work is the routed work, never the all-experts product. Parameters are
a tree in the port's layout (kernels ``[in, out]``; ``router`` [d, E];
``experts.{gate,up}`` [E, d, rm], ``experts.down`` [E, rm, d]). TF32
must be off (`qwen3.matmul_precision`) for float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import qwen3


def route(cfg: dict, router: torch.Tensor, x: torch.Tensor):
    """Routing of tokens x [n, d]: (weights [n, k] float32, experts [n, k]
    int64), the experts in descending order of probability."""
    probs = torch.softmax((x @ router).float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)  # a tie keeps the lower index first
    k = cfg["num_experts_per_tok"]
    w, idx = w[:, :k], idx[:, :k]
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, idx


def moe_mlp(cfg: dict, lp: Dict, x: torch.Tensor, grams: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts over normed tokens x [B, T, d] -> [B, T, d].
    ``grams`` [E, rm, rm]: each expert's Gram of its gated intermediate
    over the tokens routed to it is added in (unweighted by the routing
    weight: the rows its down projection sees)."""
    B, T, d = x.shape
    x2 = x.reshape(-1, d)
    w, idx = route(cfg, lp["router"]["kernel"], x2)
    ek = lp["experts"]
    y = torch.zeros_like(x2)
    for e in range(cfg["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x2[tok]
        h = F.silu(xe @ ek["gate"]["kernel"][e]) * (xe @ ek["up"]["kernel"][e])
        if grams is not None:
            grams[e].add_(h.T @ h)
        y.index_add_(0, tok, (h @ ek["down"]["kernel"][e]) * w[tok, slot, None])
    return y.view(B, T, d)


def _attention_half(cfg: dict, lp: Dict, x: torch.Tensor, cos, sin, taps: Optional[Dict]) -> torch.Tensor:
    """x plus the layer's attention, through `qwen3.layer` given an MLP of
    one column of zero weights, whose output is exact zeros; its
    attention taps are added into ``taps``, its ``cov_mlp`` dropped."""
    d = x.shape[-1]
    zero = x.new_zeros((d, 1))
    attn_lp = dict(lp, gate={"kernel": zero}, up={"kernel": zero}, down={"kernel": zero.T})
    attn_taps = None if taps is None else {}
    out = qwen3.layer(cfg, attn_lp, x, cos, sin, attn_taps)
    if taps is not None:
        del attn_taps["cov_mlp"]
        for key, g in attn_taps.items():
            qwen3._acc(taps, key, g)
    return out


def layer(cfg: dict, lp: Dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
          taps: Optional[Dict] = None) -> torch.Tensor:
    """One decoder layer over x [B, T, d]. ``taps`` gathers `qwen3.layer`'s
    attention statistics (``cov_x``, ``cov_q``, ``cov_k``) and each
    expert's routed Gram (``cov_mlp`` [E, rm, rm]), as sums over tokens."""
    x = _attention_half(cfg, lp, x, cos, sin, taps)
    xm = qwen3.rms_norm(x, lp["mlp_norm"]["scale"], cfg["rms_norm_eps"])
    grams = None
    if taps is not None:
        rm = lp["experts"]["up"]["kernel"].shape[-1]
        grams = taps.setdefault("cov_mlp", x.new_zeros((cfg["num_experts"], rm, rm)))
    return x + moe_mlp(cfg, lp, xm, grams)


def hidden(cfg: dict, params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """The final-norm hidden states [B, T, d] of tokens ids [B, T]."""
    T = ids.shape[1]
    cos, sin = qwen3.rope_tables(T, cfg["head_dim"], float(cfg["rope_theta"]), ids.device)
    x = params["embed_tokens"][ids.long()]
    for lp in params["layers"]:
        x = layer(cfg, lp, x, cos, sin)
    return qwen3.rms_norm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
