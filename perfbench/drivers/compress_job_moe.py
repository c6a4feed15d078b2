"""Compression jobs back to back on a Qwen3-MoE model: `compress.pipeline.compress_in_memory`.

The job, its window and its end-to-end metrics are `compress_job`'s
(``compress_s_per_layer``, ``compress_peak_gib``), on a tree whose every
layer holds a router and a stack of routed experts (`model_params`).
Set-up warms up with one whole job, not the first layer alone: the
allocation gives each layer its own rank, so only a whole job runs every
solve shape the window will. The record carries `compress_job`'s keys,
so the compression cell's per-layer readers read this cell too, with the
job's FLOPs counted for the routed model (`counts.moe`), and the expert
layer's own: the program's counters ``_moe_mlp.calls`` and ``.tokens``
over the window (None on a program without them) beside the harness's
own count of the calls the job makes (one per layer and calibration
batch in each of the BI pre-pass and the tap sweep), and the calls'
least time (`counts.moe.experts_bound_s`).

Correct: the last job's compressed model against the plain reference
(`reference.modegpt_moe` over `reference.qwen3_moe`), re-derived from
the same weights drawn again from the seed and the same calibration
tokens: the rank lists, and the final hidden states over held-out
tokens as a share of how far the compression moved them
(``hidden_gap``). See ``limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from perfbench import trace, weights
from perfbench.counts import k1, moe
from perfbench.drivers.compress_job import _config, _sync, check_tokens, rank_mismatches
from perfbench.reference import modegpt_moe, qwen3, qwen3_moe, synthetic


def _layer_layout(cfg: dict):
    d, H, Hk, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    E, D = cfg["num_experts"], cfg["moe_intermediate_size"]
    return [
        ("q/kernel", (d, H * hd), "w"),
        ("k/kernel", (d, Hk * hd), "w"),
        ("v/kernel", (d, Hk * hd), "w"),
        ("o/kernel", (H * hd, d), "w"),
        ("router/kernel", (d, E), "w"),
        ("experts/gate/kernel", (E, d, D), "w"),
        ("experts/up/kernel", (E, d, D), "w"),
        ("experts/down/kernel", (E, D, d), "w"),
        ("attn_norm/scale", (d,), "norm"),
        ("mlp_norm/scale", (d,), "norm"),
        ("q_norm/scale", (hd,), "norm"),
        ("k_norm/scale", (hd,), "norm"),
    ]


def model_params(cfg: dict, seed: int, device) -> Dict:
    """The dense MoE tree: `weights.other_params`, and each layer one
    buffer drawn from its own seed (`weights.sub_seed`) in the port's
    layout (``router`` [d, E], ``experts.{gate,up}`` [E, d, D],
    ``experts.down`` [E, D, d])."""
    params = weights.other_params(cfg, seed, device)
    params["layers"] = [weights._draw(_layer_layout(cfg), weights.sub_seed(seed, 1, l), cfg, device)
                        for l in range(cfg["num_hidden_layers"])]
    return params


def _moe_counters():
    """(calls, tokens) of the program's `_moe_mlp`, or None where it has
    no such counters."""
    from modegpt_tpu_torch.models import forward

    calls, tokens = getattr(forward._moe_mlp, "calls", None), getattr(forward._moe_mlp, "tokens", None)
    return (calls, tokens) if isinstance(calls, int) and isinstance(tokens, int) else None


def run(ctx) -> Dict:
    from modegpt_tpu_torch.compress.pipeline import compress_in_memory
    from modegpt_tpu_torch.kernels import flash_attention as k1_mod

    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    phases = {"start": time.perf_counter() - ctx.t_start}
    spec = weights.spec_of(cfg)
    ccfg = _config(traffic, dev)
    params = model_params(cfg, ctx.seed, dev)
    _sync(dev)
    phases["weights"] = time.perf_counter() - ctx.t_start

    # warm-up: one whole job. Each layer's Type-I solves run at that
    # layer's own rank, so the first layer alone would leave the other
    # layers' solve shapes, and the allocator's blocks for them, to the
    # window's first job.
    compress_in_memory(spec, params, ccfg, device=dev)
    gc.collect()
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    L = cfg["num_hidden_layers"]
    c = traffic["compression"]
    seq_len = min(c["seq_len"], cfg["max_position_embeddings"])
    k1_before = k1_mod.flash_attention.launches
    moe_before = _moe_counters()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    jobs = []
    out = None
    with trace.Window(ctx.trace) as tw:
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < ctx.seconds:
            out = None  # the previous job's model is dropped before the next job starts
            t0 = time.perf_counter()
            with torch.profiler.record_function("perfbench.job"):
                out = compress_in_memory(spec, params, ccfg, device=dev)
            _sync(dev)
            jobs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    k1_launches = k1_mod.flash_attention.launches - k1_before
    moe_after = _moe_counters()
    summary = tw.close()

    window_s = float(sum(jobs))
    layers = len(jobs) * L
    tokens_per_call = c["calibs_batch_size"] * seq_len
    expected_calls = len(jobs) * L * 2 * (c["calib_size"] // c["calibs_batch_size"])
    record = {
        "window_s": window_s, "layers": layers, "jobs": jobs, "trace": summary,
        "flops": len(jobs) * moe.compress_job_flops(cfg, c["calib_size"], seq_len),
        "k1_launches": k1_launches,
        "k1_launch_bound_s": k1.bound_s(c["calibs_batch_size"], cfg["num_attention_heads"],
                                        cfg["num_key_value_heads"], seq_len, cfg["head_dim"], cfg["head_dim"], 4),
        "moe_expected_calls": expected_calls, "moe_expected_tokens": expected_calls * tokens_per_call,
        "moe_calls": None, "moe_tokens": None, "experts_bound_s": None,
    }
    if moe_before is not None and moe_after is not None:
        calls, tokens = moe_after[0] - moe_before[0], moe_after[1] - moe_before[1]
        record.update(moe_calls=calls, moe_tokens=tokens)
        if calls:
            record["experts_bound_s"] = calls * moe.experts_bound_s(cfg, tokens // calls)
    e2e = {"compress_s_per_layer": window_s / layers, "compress_peak_gib": peak / 2**30}

    comp_spec, comp_params = out
    del out, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(cfg, traffic, ctx.seed, dev, comp_spec, comp_params, ctx.cell.limits)
    phases["warm-up"] = setup_s
    return {"setup_s": setup_s, "setup_phases": phases, "e2e": e2e, "record": record, "memory_peak_bytes": peak,
            "attempted": len(jobs), "failed": 0, "checks": checks, "check_s": time.perf_counter() - t_check}


def reference_model(cfg: Dict, traffic: Dict, seed: int, dev, tf32: bool) -> Dict:
    """The reference's compression of the seed's dense model (TF32 on for
    the control)."""
    c = traffic["compression"]
    seq_len = min(c["seq_len"], cfg["max_position_embeddings"])
    batches = synthetic.calibration_batches(cfg["vocab_size"], c["calib_size"], c["calibs_batch_size"], seq_len)
    dense = model_params(cfg, seed, dev)
    with torch.no_grad(), qwen3.matmul_precision(tf32):
        ref = modegpt_moe.compress(cfg, dense, batches, c, traffic["ridges_of_the_defaults"], dev)
    ref["dense"] = dense
    return ref


def hidden_gap(cfg: Dict, ids: torch.Tensor, dense: Dict, ref: Dict, got: Dict) -> float:
    """||h(got) - h(ref)|| / ||h(ref) - h(dense)||, final-norm hidden states."""
    with torch.no_grad(), qwen3.matmul_precision(False):
        h_ref = qwen3_moe.hidden(cfg, ref, ids)
        moved = float((h_ref - qwen3_moe.hidden(cfg, dense, ids)).norm())
        gap = float((qwen3_moe.hidden(cfg, got, ids) - h_ref).norm())
    return gap / moved


def check(cfg, traffic, seed, dev, comp_spec, comp_params, limits) -> Dict:
    """The compared numbers, each beside its limit."""
    ref = reference_model(cfg, traffic, seed, dev, tf32=False)
    ids = check_tokens(cfg, traffic, seed, dev)
    gap = hidden_gap(cfg, ids, ref["dense"], ref["params"], comp_params)
    return {
        "rank_mismatch": {"value": rank_mismatches(comp_spec, ref["ranks"]), "limit": limits["rank_mismatch"]},
        "hidden_gap": {"value": gap, "limit": limits["hidden_gap"]},
    }


def control_reading(cell, seed: int, dev) -> Dict:
    """The control: the reference computed with TF32 on, put in the
    program's place, against the reference in float32."""
    cfg, traffic = cell.config, cell.traffic
    low = reference_model(cfg, traffic, seed, dev, tf32=True)
    H, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    low_spec = weights.spec_of(cfg).with_ranks(
        q_ranks=[r["qk"] * H for r in low["ranks"]], k_ranks=[r["qk"] * Hk for r in low["ranks"]],
        v_ranks=[r["vo"] * Hk for r in low["ranks"]], o_ranks=[r["vo"] * H for r in low["ranks"]],
        gate_ranks=[r["mlp"] for r in low["ranks"]], has_rotary_masks=True,
    )
    low_params = low["params"]
    del low
    return check(cfg, traffic, seed, dev, low_spec, low_params, cell.limits)
