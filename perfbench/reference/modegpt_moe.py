"""MoDeGPT compression of a Qwen3-MoE model, written plainly from the method.

The attention half of each layer is compressed as the dense reference
does it (`modegpt`: Block Influence and its allocation, Type-II on the
raw q/k Grams, Type-III on the attention input's Gram). The MLP half is
a stack of routed experts, and each expert gets its own Type-I solve
(`modegpt.type_one`: ridge-leverage Nystrom selection and the down
re-solve) against the Gram of its own intermediate.

Departures from the published method, which has no mixture of experts,
each as the port and the JAX package do it (`models/forward._moe_gram`,
`compress/batched` per expert, JAX ``_solve_mlp_moe``):

* an expert's Gram sums its gated intermediate over the tokens routed
  to it only, unweighted by the routing weight (the rows its down
  projection sees), and is divided by the calibration's whole token
  count, not by the expert's own count of routed tokens;
* every expert of a layer keeps the same number of columns,
  ``int(moe_intermediate_size * keep)``, the layer's keep ratio from the
  allocation applied to one expert's width; the router is kept whole.

Statistics are float32 sums over tokens; the experts run on their
routed tokens alone (`qwen3_moe.moe_mlp`). Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import modegpt, qwen3, qwen3_moe


def calibrate(cfg: dict, params: Dict, batches: List[np.ndarray], device) -> Tuple[List[float], List[Dict]]:
    """(BI of every layer over the sequences, each layer's Grams divided
    by the token count: ``cov_x``, ``cov_q``, ``cov_k`` and the experts'
    ``cov_mlp`` [E, rm, rm]), from one forward pass over every batch."""
    T = int(batches[0].shape[1])
    cos, sin = qwen3.rope_tables(T, cfg["head_dim"], float(cfg["rope_theta"]), device)
    xs = [params["embed_tokens"][torch.as_tensor(b, device=device).long()] for b in batches]
    n_seq = sum(int(b.shape[0]) for b in batches)
    bi, grams = [], []
    for lp in params["layers"]:
        taps: Dict = {}
        s = 0.0
        for i, x in enumerate(xs):
            y = qwen3_moe.layer(cfg, lp, x, cos, sin, taps)
            s += qwen3.block_influence(x, y)
            xs[i] = y
        bi.append(s / n_seq)
        grams.append({k: v / (n_seq * T) for k, v in taps.items()})
    return bi, grams


def ranks_for(cfg: dict, keep: float) -> Dict[str, float]:
    """`modegpt.ranks_for` with an expert's width as the MLP's."""
    return modegpt.ranks_for(dict(cfg, intermediate_size=cfg["moe_intermediate_size"]), keep)


def type_one_experts(cov: torch.Tensor, experts: Dict, rank: int, ridge: float, solve_ridge: float) -> Dict:
    """`modegpt.type_one` for each expert against its own Gram, stacked
    back into an expert tree at ``rank`` columns each."""
    solved = [modegpt.type_one(cov[e], {n: {"kernel": experts[n]["kernel"][e]} for n in ("gate", "up", "down")},
                               rank, ridge, solve_ridge) for e in range(cov.shape[0])]
    return {n: {"kernel": torch.stack([s[n]["kernel"] for s in solved])} for n in ("gate", "up", "down")}


def compress(cfg: dict, params: Dict, batches: List[np.ndarray], comp: Dict, ridges: Dict, device):
    """The compressed model (a tree in the port's layout, the dense
    embedding, head, norms and routers shared) and what it came from:
    ``{"bi", "keep", "ranks", "params"}``."""
    bi, grams = calibrate(cfg, params, batches, device)
    keep = modegpt.allocate(bi, comp["compression_ratio"], ridges["sparsity_smoothing"], ridges["max_sparsity"])
    layers, ranks = [], []
    for l, g in enumerate(grams):
        r = ranks_for(cfg, keep[l])
        lp = params["layers"][l]
        new = {k: lp[k] for k in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "router")}
        new["experts"] = type_one_experts(g["cov_mlp"], lp["experts"], r["mlp"], ridges["nystrom_ridge"],
                                          ridges["nystrom_solve_ridge"])
        new.update(modegpt.type_two(cfg, g["cov_q"], g["cov_k"], lp, r["qk"], ridges["qk_sqrt_ridge"],
                                    ridges["ridge_qk"]))
        new.update(modegpt.type_three(cfg, g["cov_x"], lp, r["vo"], ridges["ridge_vo"]))
        layers.append(new)
        ranks.append(r)
        del g
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = layers
    return {"bi": bi, "keep": keep, "ranks": ranks, "params": out}
