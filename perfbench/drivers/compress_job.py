"""Compression jobs back to back: `compress.pipeline.compress_in_memory`.

Set-up draws the dense model on the card from the seed (the caller's
tree, held through the window as ``serve --compress_ratio`` holds it) and
warms the cell's shapes through the same public entry on the model's
first layer alone, with one calibration batch: one batch through one
layer, one solve at the full widths, K1 built. The window then runs whole
jobs on the held tree; none starts after ``--seconds``, and the last one
counts whole.

End to end: ``compress_s_per_layer`` (the jobs' wall seconds over the
decoder layers they compressed) and ``compress_peak_gib`` (the window's
``max_memory_allocated``, reset at its start: the held dense tree and
the job's own memory, its compressed model included).

Correct: the last job's compressed model against the plain reference
(`reference.modegpt`), re-derived from the same dense weights, drawn
again from the seed, and the same calibration tokens (a frozen copy of
the port's corpus): the rank lists, and the final hidden states of the
two compressed models over held-out tokens, as a share of how far the
compression moved them (``hidden_gap``). See ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict

import torch

from perfbench import trace, weights
from perfbench.counts import k1, model_flops
from perfbench.reference import modegpt, qwen3, synthetic


def _config(traffic: Dict, device):
    from modegpt_tpu_torch.config import CompressionConfig

    c = traffic["compression"]
    return CompressionConfig(
        compression_ratio=c["compression_ratio"], dataset=c["dataset"], calib_size=c["calib_size"],
        calibs_batch_size=c["calibs_batch_size"], seq_len=c["seq_len"], solver_precision=c["solver_precision"],
        device=str(device),
    ).validate()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> Dict:
    from modegpt_tpu_torch.compress.pipeline import compress_in_memory
    from modegpt_tpu_torch.kernels import flash_attention as k1_mod

    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    phases = {"start": time.perf_counter() - ctx.t_start}
    spec = weights.spec_of(cfg)
    ccfg = _config(traffic, dev)
    params = weights.model_params(cfg, ctx.seed, dev)
    _sync(dev)
    phases["weights"] = time.perf_counter() - ctx.t_start

    # warm-up: the first layer alone, one calibration batch
    one = dict(params, layers=params["layers"][:1])
    warm_cfg = dataclasses.replace(ccfg, calib_size=ccfg.calibs_batch_size)
    compress_in_memory(weights.spec_of(dict(cfg, num_hidden_layers=1)), one, warm_cfg, device=dev)
    del one
    gc.collect()
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    L = cfg["num_hidden_layers"]
    c = traffic["compression"]
    seq_len = min(c["seq_len"], cfg["max_position_embeddings"])
    k1_before = k1_mod.flash_attention.launches
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
    summary = tw.close()

    window_s = float(sum(jobs))
    layers = len(jobs) * L
    record = {
        "window_s": window_s, "layers": layers, "jobs": jobs, "trace": summary,
        "flops": len(jobs) * model_flops.compress_job_flops(cfg, c["calib_size"], seq_len),
        "k1_launches": k1_launches,
        "k1_launch_bound_s": k1.bound_s(c["calibs_batch_size"], cfg["num_attention_heads"],
                                        cfg["num_key_value_heads"], seq_len, cfg["head_dim"], cfg["head_dim"], 4),
    }
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
    dense = weights.model_params(cfg, seed, dev)
    with torch.no_grad(), qwen3.matmul_precision(tf32):
        ref = modegpt.compress(cfg, dense, batches, c, traffic["ridges_of_the_defaults"], dev)
    ref["dense"] = dense
    return ref


def check_tokens(cfg: Dict, traffic: Dict, seed: int, dev) -> torch.Tensor:
    """Held-out tokens from the seed, from the calibration corpus's
    distribution."""
    t = traffic["check_tokens"]
    ids = synthetic.chunks(cfg["vocab_size"], t["seq_len"], t["sequences"], seed=weights.sub_seed(seed, 9))
    return torch.as_tensor(ids, device=dev)


def hidden_gap(cfg: Dict, ids: torch.Tensor, dense: Dict, ref: Dict, got: Dict) -> float:
    """||h(got) - h(ref)|| / ||h(ref) - h(dense)||, final-norm hidden states."""
    with torch.no_grad(), qwen3.matmul_precision(False):
        h_ref = qwen3.hidden(cfg, ref, ids)
        moved = float((h_ref - qwen3.hidden(cfg, dense, ids)).norm())
        gap = float((qwen3.hidden(cfg, got, ids) - h_ref).norm())
    return gap / moved


def rank_mismatches(spec, ref_ranks) -> int:
    """Ranks that differ from the reference's. Where the reference's
    width * keep lies within 0.05 of a whole number, float32 statistics
    may round it either way: the MLP rank may then differ by one and a
    per-head rank (kept even) by two."""
    H, Hk = spec.n_heads, spec.n_kv_heads
    bad = 0
    for l, r in enumerate(ref_ranks):
        got = {"mlp": [spec.gate_ranks[l]], "qk": [spec.q_ranks[l] // H, spec.k_ranks[l] // Hk],
               "vo": [spec.v_ranks[l] // Hk, spec.o_ranks[l] // H]}
        for kind, exact, step in (("mlp", r["mlp_exact"], 1), ("qk", r["head_exact"], 2),
                                  ("vo", r["head_exact"], 2)):
            allowed = step if abs(exact - round(exact)) < 0.05 else 0
            bad += sum(abs(g - r[kind]) > allowed for g in got[kind])
    return bad


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
    low_spec = weights.spec_of(cfg).with_ranks(
        q_ranks=[r["qk"] * cfg["num_attention_heads"] for r in low["ranks"]],
        k_ranks=[r["qk"] * cfg["num_key_value_heads"] for r in low["ranks"]],
        v_ranks=[r["vo"] * cfg["num_key_value_heads"] for r in low["ranks"]],
        o_ranks=[r["vo"] * cfg["num_attention_heads"] for r in low["ranks"]],
        gate_ranks=[r["mlp"] for r in low["ranks"]], has_rotary_masks=True,
    )
    low_params = low["params"]
    del low
    return check(cfg, traffic, seed, dev, low_spec, low_params, cell.limits)
