"""What each rank of `tests/test_torch_tp_serving.py`'s library launch runs.

No tests here. Run as a script (by `test_torch_parallel_ranks.Launch`), a
rank::

    python tests/test_torch_tp_serving_ranks.py <workdir> [cpu|cuda]

joins the group, reads ``<workdir>/inputs.pt`` (cases by name: a kind, a
mesh shape and the kind's inputs, written by the test process), runs
every case on its own mesh of the same world, and writes
``<workdir>/rank<r>.pt``: one result per case, tensors as numpy arrays.
Kinds:

* ``shards``: `shard_serving` of a padded model and a serve state; every
  leaf of this rank's stack, ``other``, ``q_hd_true`` and pools;
* ``step``: one `_model_step_padded` of the sharded stack against its
  sharded pools (K3's wrapper on the attention); the logits and the
  rank's pools after the writes;
* ``serve``: a `ContinuousBatcher` on the mesh; the requests' tokens and
  counters, and K3's launches (on the card);
* ``forward``: `param_shardings` and the unrolled TP forward's logits.

This module imports torch and the port only, never JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.numpy() if t.dtype != torch.bfloat16 else t.float().numpy()
    return np.asarray(t)


def leaves(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _state(case):
    from modegpt_tpu_torch.models.serving import ServeState

    st = case["state"]
    scales = st.get("k_scale") is not None
    return ServeState(
        cache_k=torch.from_numpy(st["cache_k"].copy()), cache_v=torch.from_numpy(st["cache_v"].copy()),
        lengths=np.array(st["lengths"]), last_token=torch.from_numpy(st["last_token"].copy()),
        k_scale=torch.from_numpy(st["k_scale"].copy()) if scales else None,
        v_scale=torch.from_numpy(st["v_scale"].copy()) if scales else None,
    )


def _pools(state):
    return {k: _np(getattr(state, k)) for k in ("cache_k", "cache_v", "k_scale", "v_scale")
            if getattr(state, k) is not None}


def run_shards(mesh, case):
    from modegpt_tpu_torch.parallel.mesh import shard_serving

    pm, state = shard_serving(mesh, case["pm"], _state(case))
    return {"layers": {k: _np(v) for k, v in leaves(pm.layers).items()},
            "other": {k: _np(v) for k, v in leaves(pm.other).items()},
            "q_hd_true": _np(pm.q_hd_true), "pools": _pools(state), "lengths": np.array(state.lengths),
            "last_token": _np(state.last_token)}


def run_step(mesh, case):
    from modegpt_tpu_torch.models.padded import _model_step_padded
    from modegpt_tpu_torch.parallel.mesh import shard_serving

    pm, state = shard_serving(mesh, case["pm"], _state(case))
    tokens = torch.from_numpy(case["tokens"]).to(mesh.device)
    logits, _ = _model_step_padded(
        pm.spec, pm.layers, pm.other, pm.q_hd_true, tokens, state.cache_k, state.cache_v,
        case["state"]["lengths"], cache_scales=state.scales, decode_attn="ragged",
        moe=case.get("moe", "dense"), moe_capacity=case.get("moe_capacity", 2.0), mesh=pm.mesh,
    )
    return {"logits": _np(logits), "pools": _pools(state)}


def run_serve(mesh, case):
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    b = ContinuousBatcher(case["pm"], mesh=mesh, **case["kw"])
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(case["prompts"], case["budgets"])]
    before = ragged_gqa_attend.launches
    done = b.run()
    return {"tokens": [list(map(int, done[r])) for r in rids], "prefix_hits": b.prefix_hits,
            "stats": {rids.index(r): v for r, v in b.stats.items()}, "comm_bytes": mesh.comm_bytes,
            "device": str(b.device), "pool_heads": int(b.state.cache_k.shape[2]),
            "k3_launches": ragged_gqa_attend.launches - before}


def run_forward(mesh, case):
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.parallel.mesh import param_shardings

    local = param_shardings(mesh, case["spec"], case["params"])
    logits, _ = forward(case["spec"], local, torch.from_numpy(case["ids"]).to(mesh.device), mesh=mesh)
    return {"logits": _np(logits)}


KINDS = {"shards": run_shards, "step": run_step, "serve": run_serve, "forward": run_forward}


def main(workdir: str, device: str = "cpu") -> None:
    import torch.distributed as dist

    from modegpt_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(device)
    cases = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        mesh = make_mesh(case["mesh"], device=device)
        out[name] = dict(KINDS[case["kind"]](mesh, case), coords=dict(mesh.coords))
    torch.save(out, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(*sys.argv[1:])
