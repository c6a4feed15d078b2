#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (modegpt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernel

Phases, each printing one JSON line:

1. build  — compile every CUDA source in modegpt_tpu_torch/csrc with nvcc
   for sm_90a (modegpt_tpu_torch/_build/), all at once.
2. kernel — hold each kernel against its plain PyTorch version on the card
   at the main path's shapes and a few edge shapes, and time the kernel,
   the plain version and the nearest single PyTorch call (library_ms).
3. main   — one full compression job through
   `modegpt_tpu_torch.compress.pipeline.run_compression` at the published
   Meta-Llama-3-8B widths (hidden 4096, intermediate 14336, 32 heads,
   8 kv heads, head_dim 128, vocab 128256, rope_theta 5e5, untied head),
   depth cut 32 -> 4 layers, random f32 weights from a seed, on the
   offline synthetic corpus, solving in float32 on the card. Every kernel
   launch counter is zeroed just before the job and read just after.

Then a `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi reports them, and last `{"ok": true, "device": {...}}`. Any
failed phase exits non-zero without that last line. Without CUDA, or
without the package beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and dense
# FLOP/s by input type (float32 on the CUDA cores, bf16 on tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# K1 edge cases beside the main path's dense shape (B=2, H=32, Hk=8,
# T=2048, hd=hd_v=128, the eval and calibration batches of the job).
KERNEL_CASES = [
    dict(name="dense_f32", B=2, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="dense_bf16", B=2, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="bfloat16", window=None),
    dict(name="compressed_f32", B=2, H=32, Hk=8, T=2048, hd=88, hd_v=90, dtype="float32", window=None),
    dict(name="ragged_T300", B=2, H=32, Hk=8, T=300, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="window100", B=2, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="float32", window=100),
    dict(name="mha", B=2, H=32, Hk=32, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
]
# The JAX package's own kernel tolerances (tests/test_models.py).
TOLERANCE = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

N_LAYERS = 4  # Meta-Llama-3-8B's 32 layers cut to 4: about 7.7 GB of f32 weights
LLAMA3_8B = dict(  # Meta-Llama-3-8B config.json
    model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu",
    tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rope_scaling=None,
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(T: int, window) -> int:
    """(query, key) pairs with q - window < k <= q."""
    if window is None or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def phase_build() -> dict:
    from modegpt_tpu_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    for name, log in build.BUILD_LOGS.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    return {"phase": "build", "sources": sorted(seconds), "seconds": time.perf_counter() - t0}


def phase_kernel(records: dict) -> list:
    import torch
    import torch.nn.functional as F

    from modegpt_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    lines = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in KERNEL_CASES:
        B, H, Hk, T, hd, hd_v, w = (case[k] for k in ("B", "H", "Hk", "T", "hd", "hd_v", "window"))
        dt = getattr(torch, case["dtype"])
        q = torch.randn((B, H, T, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Hk, T, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Hk, T, hd_v), generator=gen, device="cuda").to(dt)
        scale = hd**-0.5
        got = flash_attention(q, k, v, scale=scale, window=w)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v, scale=scale, window=w)
        err = float((got.float() - want.float()).abs().max())
        tol = TOLERANCE[case["dtype"]]
        ok = bool(torch.allclose(got.float(), want.float(), **tol)) and bool(torch.isfinite(got).all())

        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, scale=scale, window=w), iters=10)
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, scale=scale, window=w), iters=5)
        # One PyTorch call computing the same function (a yardstick only:
        # the port never calls it).
        mask = None
        if w is not None:
            i = torch.arange(T, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
        kw = dict(attn_mask=mask, is_causal=mask is None, scale=scale)
        try:
            F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw), iters=10
            )
        except (TypeError, RuntimeError) as e:  # no kernel for this shape/dtype
            print(f"[kernel {case['name']}] SDPA not timed: {e}", file=sys.stderr)
            library_ms = None

        flops = 2.0 * B * H * visible_pairs(T, w) * (hd + hd_v)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        t_ops = flops / PEAK_FLOPS[case["dtype"]]
        t_bytes = nbytes / HBM_BYTES_PER_S
        line = {
            "phase": "kernel", "kernel": "flash_attention", "case": case["name"],
            "shape": {k_: case[k_] for k_ in ("B", "H", "Hk", "T", "hd", "hd_v", "window")},
            "dtype": case["dtype"], "max_abs_err": err, "tolerance": tol, "ok": ok,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        emit(line)
        lines.append(line)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    main = lines[0]
    records["flash_attention"] = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "modegpt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "modegpt_tpu/kernels/flash_attention.py:156",
        "launches": None,
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }
    bad = [ln["case"] for ln in lines if not ln["ok"]]
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain version at {bad}")
    return lines


def _profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _profile_line(prof, wall_s: float) -> dict:
    """Device busy time (the sum of every kernel's and copy's device
    time, from the profiler's CUDA trace) against the job's wall time,
    and the ten largest device-time entries."""
    import torch

    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op rows would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e3
    return {
        "phase": "profile", "wall_s": wall_s, "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "top_device": [{"name": k[:80], "ms": ms, "count": n} for k, ms, n in rows[:10]],
    }


def phase_main(records: dict, profile: bool = False) -> dict:
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(SimpleNamespace(**{**LLAMA3_8B, "num_hidden_layers": N_LAYERS}))
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_") as tmp:
        config = CompressionConfig(
            model="random-llama3-8b-widths", device="cuda",
            seq_len=2048, calib_size=8, calibs_batch_size=2, eval_batch_size=2,
            eval_max_samples=4, compression_ratio=0.3, dataset="synthetic",
            solver_precision="f32_device",
            output_dir=os.path.join(tmp, "out"),
            temp_storage_dir=os.path.join(tmp, "layers"),
            metrics_dir=os.path.join(tmp, "metrics"),
        ).validate()
        torch.cuda.reset_peak_memory_stats()
        prof = _profiler() if profile else contextlib.nullcontext()
        t_run = time.perf_counter()
        fa_mod.flash_attention.launches = 0
        with prof:
            results = run_compression(config, spec=spec, params=params)
        launches = fa_mod.flash_attention.launches
        t_run = time.perf_counter() - t_run
        del params
        if profile:
            emit(_profile_line(prof, t_run))

        n_eval = min(config.eval_max_samples, 16)  # the synthetic eval set
        n_batches = 2 * math.ceil(n_eval / config.eval_batch_size) + math.ceil(
            config.calib_size / config.calibs_batch_size
        )
        expected = N_LAYERS * n_batches
        cspec = results["compressed_spec"]
        # reload the artifact once more: its shapes validate against the spec
        spec2, params2, _ = load_compressed_model(results["artifact_dir"], device="cuda")
        # the compressed model's logits through the kernel agree with the
        # plain attention path on one eval batch (unaligned head dims)
        eval_tokens = load_eval_tokens(None, "synthetic", 512, 1, vocab_size=spec.vocab_size)
        ids = torch.as_tensor(eval_tokens, device="cuda")
        with torch.no_grad():
            lk, _ = forward(spec2, params2, ids, attn_impl="flash")
            lp, _ = forward(spec2, params2, ids, attn_impl="xla")
        logit_err = float((lk - lp).abs().max())
        logit_ok = bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3))
        del params2, lk, lp

    records["flash_attention"]["launches"] = launches
    line = {
        "phase": "main", "model": "Meta-Llama-3-8B widths", "n_layers": N_LAYERS,
        "init_seconds": init_s,
        "step_seconds": results["step_seconds"],
        "total_seconds": results["total_seconds"],
        "baseline_ppl": results["baseline_ppl"], "compressed_ppl": results["compressed_ppl"],
        "params_before": results["params_before"], "params_after": results["params_after"],
        "ranks": {
            "q": list(cspec.q_ranks), "k": list(cspec.k_ranks), "v": list(cspec.v_ranks),
            "o": list(cspec.o_ranks), "gate": list(cspec.gate_ranks),
        },
        "launches": {"flash_attention": launches}, "expected_launches": {"flash_attention": expected},
        "compressed_logits_max_abs_err": logit_err,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(line)
    problems = []
    if launches != expected:
        problems.append(f"flash_attention launched {launches} times, expected {expected}")
    for key in ("baseline_ppl", "compressed_ppl"):
        if not math.isfinite(results[key]):
            problems.append(f"{key} is not finite")
    if not (0 < sum(cspec.gate_ranks) < sum(spec.gate_ranks)
            and 0 < sum(cspec.q_ranks) < sum(spec.q_ranks)
            and 0 < sum(cspec.v_ranks) < sum(spec.v_ranks)):
        problems.append("rank lists did not shrink")
    if spec2 != cspec:
        problems.append("reloaded artifact's spec differs from the compressed spec")
    if not logit_ok:
        problems.append(f"compressed logits: kernel vs plain attention differ by {logit_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return line


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernel,main")
    ap.add_argument("--profile", action="store_true",
                    help="trace the main phase with torch.profiler; print its device busy time")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import modegpt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the modegpt_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2

    print(f"chip_smoke: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", file=sys.stderr)
    records: dict = {}
    if "build" in phases:
        emit(phase_build())
    if "kernel" in phases:
        phase_kernel(records)
    if "main" in phases:
        if "flash_attention" not in records:
            raise SystemExit("chip_smoke: the main phase needs the kernel phase's records")
        phase_main(records, args.profile)
    emit({"kernels": list(records.values())})
    print(card_line(), flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
