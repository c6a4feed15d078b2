"""Random parameter initialisation for a ModelSpec (no HF dependency).

Port of ``modegpt_tpu.models.init``: a plain scaled normal for every
kernel and embedding, ones/zeros for norms and biases, drawn from the
caller's ``torch.Generator`` directly on ``device``. The two packages
draw different numbers from the same seed; tests that compare them make
weights with numpy and convert (``models/convert.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from modegpt_tpu_torch.models.forward import check_supported
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["init_params"]


def init_params(
    spec: ModelSpec,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    scale: float = 0.02,
    device: Optional[DeviceLike] = None,
) -> Dict:
    """Random parameter tree for ``spec`` on ``device`` (default: the
    generator's device). On the ``"meta"`` device the tree has shapes and
    no storage, for counting."""
    check_supported(spec)
    if str(device) == "meta":
        dev = torch.device("meta")
    else:
        dev = resolve_device(generator.device if device is None else device)

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * scale).to(dtype)

    def norm_p():
        p = {"scale": torch.ones(spec.d_model, dtype=dtype, device=dev)}
        if spec.norm == "layernorm":
            p["bias"] = torch.zeros(spec.d_model, dtype=dtype, device=dev)
        return p

    def linear(shape, bias: bool):
        p = {"kernel": dense(shape)}
        if bias:
            p["bias"] = torch.zeros(shape[1], dtype=dtype, device=dev)
        return p

    params: Dict = {
        "embed_tokens": dense((spec.vocab_size, spec.d_model)),
        "final_norm": norm_p(),
        "lm_head": None if spec.tie_word_embeddings else {"kernel": dense((spec.d_model, spec.vocab_size))},
    }
    if spec.arch == "opt":
        params["embed_positions"] = dense((spec.max_position_embeddings + 2, spec.d_model))
    elif spec.arch == "gpt2":
        params["embed_positions"] = dense((spec.max_position_embeddings, spec.d_model))

    layers = []
    for l in range(spec.n_layers):
        ab = spec.attention_bias
        mb = spec.mlp_bias or spec.arch in ("opt", "gpt2")
        lp = {}
        if spec.pre_norms or not spec.do_layer_norm_before:
            lp.update(attn_norm=norm_p(), mlp_norm=norm_p())
        if spec.post_norms:  # gemma2's sandwich norms, olmo2's only norms
            lp.update(post_attn_norm=norm_p(), post_mlp_norm=norm_p())
        lp.update(
            q=linear((spec.d_model, spec.q_ranks[l]), ab),
            k=linear((spec.d_model, spec.k_ranks[l]), ab),
            v=linear((spec.d_model, spec.v_ranks[l]), ab),
            o=linear((spec.o_ranks[l], spec.d_model), ab and spec.arch in ("opt", "gpt2", "starcoder2")),
        )
        if spec.is_moe_layer(l):
            # the router, the stacked experts [E, d, r] / [E, r, d] and,
            # for qwen2_moe, the shared expert and its scalar gate
            E, rg = spec.n_experts, spec.gate_ranks[l]
            lp["router"] = {"kernel": dense((spec.d_model, E))}
            lp["experts"] = {
                "gate": {"kernel": dense((E, spec.d_model, rg))},
                "up": {"kernel": dense((E, spec.d_model, rg))},
                "down": {"kernel": dense((E, rg, spec.d_model))},
            }
            if spec.shared_d_int:
                rs = spec.shared_rank(l)
                lp["shared"] = {
                    "gate": {"kernel": dense((spec.d_model, rs))},
                    "up": {"kernel": dense((spec.d_model, rs))},
                    "down": {"kernel": dense((rs, spec.d_model))},
                }
                if spec.shared_expert_gate:
                    lp["shared_gate"] = {"kernel": dense((spec.d_model, 1))}
        else:
            lp["up"] = linear((spec.d_model, spec.gate_ranks[l]), mb)
            lp["down"] = linear((spec.gate_ranks[l], spec.d_model), mb)
            if spec.gated_mlp:
                lp["gate"] = linear((spec.d_model, spec.gate_ranks[l]), spec.mlp_bias)
        if spec.qk_norm:
            lp["q_norm"] = {"scale": torch.ones(spec.head_dim, dtype=dtype, device=dev)}
            lp["k_norm"] = {"scale": torch.ones(spec.head_dim, dtype=dtype, device=dev)}
        elif spec.flat_qk_norm:  # olmo2: one weight over the whole projection
            lp["q_norm"] = {"scale": torch.ones(spec.n_heads * spec.head_dim, dtype=dtype, device=dev)}
            lp["k_norm"] = {"scale": torch.ones(spec.n_kv_heads * spec.head_dim, dtype=dtype, device=dev)}
        layers.append(lp)
    params["layers"] = layers
    return params
