"""MoDeGPT compression of a Qwen3 model, written plainly from the method.

MoDeGPT (Lin et al., 2024) compresses each decoder layer in closed form
from calibration statistics:

* Block Influence of each layer (the mean of 1 - cos(x_in, x_out) over
  calibration tokens) sets the layer's share of the global ratio:
  sparsity = L * ratio * softmax(-BI / smoothing), capped at
  ``max_sparsity`` with the excess shared out among the others, and
  keep = 1 - sparsity;
* Type-I (MLP): ridge-leverage Nystrom selection. Keep the ``rank``
  intermediate columns with the smallest diag((C + lambda I)^-1) of the
  intermediate Gram C, slice gate and up, and solve the down projection
  W_d' = (C_SS + eps I)^-1 C_S: W_d;
* Type-II (Q/K, RoPE): score each kv head's rotary frequency pairs by
  the column energies of sqrt(C_q + 1e-4 I) and sqrt(C_k + ridge_qk I)
  (||sqrt(C + r I)[:, j]||^2 = C_jj + r), summed over the group's query
  heads; keep the top ``rank/2`` pairs, best first, as the
  mask concat(pairs, pairs + hd/2), and gather the q and k rows;
* Type-III (V/O, grouped): whiten by S = (C_x + ridge_vo I)^(1/2),
  U, s, Vh = svd(S W_v,g^T) per kv head, V' = S^-1 U[:, :r] and each
  query head's O' = diag(s)[:r] Vh[:r] W_o,h^T.

Ranks round as the method's code does: int(width * keep), per-head Q/K and
V/O ranks even. Statistics are float32 sums over tokens, divided by the
token count; the allocation runs in float64. Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import qwen3


def calibrate(cfg: dict, params: Dict, batches: List[np.ndarray], device) -> Tuple[List[float], List[Dict]]:
    """(BI of every layer over the sequences, each layer's Grams divided
    by the token count), from one forward pass over every batch."""
    L, hd = cfg["num_hidden_layers"], cfg["head_dim"]
    T = int(batches[0].shape[1])
    cos, sin = qwen3.rope_tables(T, hd, float(cfg["rope_theta"]), device)
    xs = [params["embed_tokens"][torch.as_tensor(b, device=device).long()] for b in batches]
    bi, grams = [], []
    n_seq = sum(int(b.shape[0]) for b in batches)
    n_tok = n_seq * T
    for l in range(L):
        taps: Dict = {}
        s = 0.0
        for i, x in enumerate(xs):
            y = qwen3.layer(cfg, params["layers"][l], x, cos, sin, taps)
            s += qwen3.block_influence(x, y)
            xs[i] = y
        bi.append(s / n_seq)
        grams.append({k: v / n_tok for k, v in taps.items()})
    return bi, grams


def allocate(bi: List[float], ratio: float, smoothing: float, max_sparsity: float) -> List[float]:
    s = np.asarray(bi, dtype=np.float64)
    w = np.exp(-(s - s.min()) / smoothing)
    w /= w.sum()
    sp = w * len(s) * ratio
    for _ in range(10_000):
        over = sp > max_sparsity
        if not over.any():
            break
        excess = float((sp[over] - max_sparsity).sum())
        sp[over] = max_sparsity
        free = w * ~over
        if free.sum() <= 0:
            break
        sp = sp + excess * free / free.sum()
    return (1.0 - np.minimum(sp, max_sparsity)).tolist()


def ranks_for(cfg: dict, keep: float) -> Dict[str, float]:
    """Each rank and the unrounded width * keep it comes from."""
    hd, di = cfg["head_dim"], cfg["intermediate_size"]
    head = int(hd * keep)
    head = max(2, min(head - head % 2, hd))
    return {"mlp": max(1, int(di * keep)), "qk": head, "vo": head,
            "mlp_exact": di * keep, "head_exact": hd * keep}


def type_one(C: torch.Tensor, lp: Dict, rank: int, ridge: float, solve_ridge: float) -> Dict:
    n = C.shape[0]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    scores = torch.cholesky_inverse(torch.linalg.cholesky(C + ridge * eye)).diagonal()
    idx = torch.sort(torch.argsort(scores, stable=True)[:rank]).values
    del eye
    C_S = C[idx]
    eye_r = torch.eye(rank, dtype=C.dtype, device=C.device)
    down = torch.linalg.solve(C_S[:, idx] + solve_ridge * eye_r, C_S @ lp["down"]["kernel"])  # [rank, d]
    return {"gate": {"kernel": lp["gate"]["kernel"][:, idx].contiguous()},
            "up": {"kernel": lp["up"]["kernel"][:, idx].contiguous()},
            "down": {"kernel": down}}


def type_two(cfg: dict, cov_q: torch.Tensor, cov_k: torch.Tensor, lp: Dict, rank: int,
             q_ridge: float, k_ridge: float) -> Dict:
    H, Hk, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    half, group = hd // 2, H // Hk
    eq = (torch.diagonal(cov_q, dim1=-2, dim2=-1).double() + q_ridge).view(Hk, group, hd)
    ek = (torch.diagonal(cov_k, dim1=-2, dim2=-1).double() + k_ridge)[:, None, :]
    score = torch.sqrt((eq[..., :half] * ek[..., :half] + eq[..., half:] * ek[..., half:]).sum(dim=1))
    pairs = torch.argsort(-score, dim=-1, stable=True)[:, : rank // 2]
    mask = torch.cat([pairs, pairs + half], dim=-1)  # [Hk, rank]

    def rows(kernel: torch.Tensor, n_heads: int, m: torch.Tensor) -> torch.Tensor:
        cols = (torch.arange(n_heads, device=m.device)[:, None] * hd + m).reshape(-1)
        return kernel[:, cols.to(kernel.device)].contiguous()

    return {"q": {"kernel": rows(lp["q"]["kernel"], H, mask.repeat_interleave(group, dim=0))},
            "k": {"kernel": rows(lp["k"]["kernel"], Hk, mask)},
            "rotary_mask": mask.to(device=lp["q"]["kernel"].device, dtype=torch.int32)}


def type_three(cfg: dict, C_x: torch.Tensor, lp: Dict, rank: int, ridge: float) -> Dict:
    H, Hk, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    d, group = C_x.shape[0], H // Hk
    w, Q = torch.linalg.eigh(C_x + ridge * torch.eye(d, dtype=C_x.dtype, device=C_x.device))
    w = torch.clamp(w, min=0.0)
    S = (Q * w.sqrt()) @ Q.T
    S_inv = (Q * (1.0 / torch.clamp(w.sqrt(), min=1e-12))) @ Q.T
    Wv = lp["v"]["kernel"].T.reshape(Hk, hd, d)  # each kv head's [hd, d] rows
    U, s, Vh = torch.linalg.svd(S @ Wv.transpose(1, 2), full_matrices=False)  # [Hk, d, hd]
    v_new = (S_inv @ U[:, :, :rank]).permute(0, 2, 1).reshape(Hk * rank, d)  # rows, HF layout
    Wo = lp["o"]["kernel"].reshape(H, hd, d).reshape(Hk, group, hd, d)  # [in rows of each head, d]
    sVh = s[:, :rank, None] * Vh[:, :rank, :]  # [Hk, r, hd]
    o_new = torch.einsum("hre,hged->hgrd", sVh, Wo).reshape(H * rank, d)
    return {"v": {"kernel": v_new.T.contiguous()}, "o": {"kernel": o_new.contiguous()}}


def compress(cfg: dict, params: Dict, batches: List[np.ndarray], comp: Dict, ridges: Dict, device):
    """The compressed model (a tree in the port's layout, the dense
    embedding, head and norms shared) and what it came from:
    ``{"bi", "keep", "ranks", "params"}``."""
    bi, grams = calibrate(cfg, params, batches, device)
    keep = allocate(bi, comp["compression_ratio"], ridges["sparsity_smoothing"], ridges["max_sparsity"])
    layers, ranks = [], []
    for l, g in enumerate(grams):
        r = ranks_for(cfg, keep[l])
        lp = params["layers"][l]
        new = {k: lp[k] for k in ("attn_norm", "mlp_norm", "q_norm", "k_norm")}
        new.update(type_one(g["cov_mlp"], lp, r["mlp"], ridges["nystrom_ridge"], ridges["nystrom_solve_ridge"]))
        new.update(type_two(cfg, g["cov_q"], g["cov_k"], lp, r["qk"], ridges["qk_sqrt_ridge"], ridges["ridge_qk"]))
        new.update(type_three(cfg, g["cov_x"], lp, r["vo"], ridges["ridge_vo"]))
        layers.append(new)
        ranks.append(r)
        del g
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = layers
    return {"bi": bi, "keep": keep, "ranks": ranks, "params": out}
