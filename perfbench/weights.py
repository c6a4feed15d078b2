"""Seeded random weights, made on the device in a few large calls.

Both the program and the plain reference are handed what these functions
make from ``--seed``: a parameter tree in the port's layout (kernels
``[in, out]``, ``y = x @ kernel``; per-layer dicts under ``"layers"``).
Each part of the model (the embedding, head and final norm; each layer)
is one float32 buffer drawn by one ``normal_`` call from its own seeded
``torch.Generator`` on the device and cut into views, so a part can be
freed alone and any part can be drawn again, alike, from the seed.
Kernels and embeddings are N(0, ``initializer_range``); norm weights
1 + N(0, ``init_norm_std``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one part of the model, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _draw(layout: List[Tuple[str, Tuple[int, ...], str]], seed: int, cfg: dict, device) -> Dict:
    """One buffer for ``layout`` ((path, shape, kind) with kind "w" or
    "norm"), drawn in one call and cut into a nested dict of views."""
    n_w = sum(int(np.prod(s)) for _, s, k in layout if k == "w")
    n_n = sum(int(np.prod(s)) for _, s, k in layout if k == "norm")
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(n_w + n_n, dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    buf[:n_w].mul_(float(cfg["initializer_range"]))
    buf[n_w:].mul_(float(cfg["assumed"]["init_norm_std"])).add_(1.0)
    tree: Dict = {}
    offs = {"w": 0, "norm": n_w}
    for path, shape, kind in layout:
        n = int(np.prod(shape))
        view = buf[offs[kind]:offs[kind] + n].view(shape)
        offs[kind] += n
        node = tree
        for key in path.split("/")[:-1]:
            node = node.setdefault(key, {})
        node[path.split("/")[-1]] = view
    return tree


def _other_layout(cfg: dict):
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    return [("embed_tokens", (V, d), "w"), ("lm_head/kernel", (d, V), "w"), ("final_norm/scale", (d,), "norm")]


def _layer_layout(cfg: dict, rq: int, rv: int, rm: int):
    d, H, Hk, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return [
        ("q/kernel", (d, H * rq), "w"),
        ("k/kernel", (d, Hk * rq), "w"),
        ("v/kernel", (d, Hk * rv), "w"),
        ("o/kernel", (H * rv, d), "w"),
        ("gate/kernel", (d, rm), "w"),
        ("up/kernel", (d, rm), "w"),
        ("down/kernel", (rm, d), "w"),
        ("attn_norm/scale", (d,), "norm"),
        ("mlp_norm/scale", (d,), "norm"),
        ("q_norm/scale", (hd,), "norm"),
        ("k_norm/scale", (hd,), "norm"),
    ]


def other_params(cfg: dict, seed: int, device) -> Dict:
    """The embedding, LM head and final norm."""
    return _draw(_other_layout(cfg), sub_seed(seed, 0), cfg, device)


def layer_params(cfg: dict, seed: int, layer: int, device, ranks: Optional[Tuple[int, int, int]] = None) -> Dict:
    """Layer ``layer``'s tree: dense widths, or compressed per-head
    ranks ``(rq, rv, rm)`` with a rotary mask [Hk, rq] of kept RoPE
    pairs (each kv head a random subset, in random order, as the Q/K
    selection lays them out: ``concat(pairs, pairs + hd/2)``)."""
    hd, Hk = cfg["head_dim"], cfg["num_key_value_heads"]
    rq, rv, rm = ranks if ranks is not None else (hd, hd, cfg["intermediate_size"])
    lp = _draw(_layer_layout(cfg, rq, rv, rm), sub_seed(seed, 1, layer), cfg, device)
    if ranks is not None:
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, layer))
        pairs = torch.rand((Hk, hd // 2), generator=gen, device=device).argsort(dim=-1)[:, : rq // 2]
        lp["rotary_mask"] = torch.cat([pairs, pairs + hd // 2], dim=-1).to(torch.int32)
    return lp


def model_params(cfg: dict, seed: int, device, ranks: Optional[Tuple[int, int, int]] = None) -> Dict:
    params = other_params(cfg, seed, device)
    params["layers"] = [layer_params(cfg, seed, l, device, ranks) for l in range(cfg["num_hidden_layers"])]
    return params


def spec_of(cfg: dict):
    """The port's ModelSpec for a configuration file's published keys."""
    from types import SimpleNamespace

    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    return spec_from_hf_config(SimpleNamespace(**cfg))
