"""Artifact inspection CLI: ``python -m modegpt_tpu_torch.inspect_artifact <dir> [--device cpu]``.

Port of ``python -m modegpt_tpu.inspect_artifact``: prints the same JSON
summary of a compressed artifact (written by either package): per-layer
ranks, rotary masks, parameter counts and the compression achieved
against the dense shape. The artifact loads onto ``--device`` (CUDA by
default); the dense tree it is measured against is built on the
``meta`` device, so nothing of it is allocated.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="modegpt-tpu-torch-inspect")
    p.add_argument("artifact", help="compressed artifact directory")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N, N or cpu")
    return p


def main(argv=None) -> int:
    import torch

    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.compress.pipeline import count_params
    from modegpt_tpu_torch.models.init import init_params

    args = _parser().parse_args(argv)
    spec, params, tok_src = load_compressed_model(args.artifact, device=args.device)
    n = count_params(params)
    del params

    dense_spec = dataclasses.replace(
        spec,
        q_ranks=(spec.n_heads * spec.head_dim,) * spec.n_layers,
        k_ranks=(spec.n_kv_heads * spec.head_dim,) * spec.n_layers,
        v_ranks=(spec.n_kv_heads * spec.head_dim,) * spec.n_layers,
        o_ranks=(spec.n_heads * spec.head_dim,) * spec.n_layers,
        gate_ranks=(spec.d_int,) * spec.n_layers,
        shared_gate_ranks=(),  # dense = shared_d_int on every MoE layer
        has_rotary_masks=False,
    )
    n_dense = count_params(init_params(dense_spec, torch.Generator(), device="meta"))

    info = {
        "arch": spec.arch,
        "n_layers": spec.n_layers,
        "d_model": spec.d_model,
        "heads": f"{spec.n_heads}q/{spec.n_kv_heads}kv x {spec.head_dim}",
        "d_int": spec.d_int,
        "tokenizer_source": tok_src,
        "params": n,
        "dense_params": n_dense,
        "achieved_compression": round(1 - n / max(n_dense, 1), 4),
        "has_rotary_masks": spec.has_rotary_masks,
        **({"n_experts": spec.n_experts, "experts_per_tok": spec.experts_per_tok} if spec.n_experts else {}),
        "per_layer": [
            {
                "layer": l,
                "q": spec.q_ranks[l],
                "k": spec.k_ranks[l],
                "v": spec.v_ranks[l],
                "o": spec.o_ranks[l],
                "mlp": spec.gate_ranks[l],
                **({"shared": spec.shared_rank(l)} if spec.has_shared_expert(l) else {}),
            }
            for l in range(spec.n_layers)
        ],
    }
    print(json.dumps(info, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
