"""The port's spans, on the CPU.

* `utils.profiling.span`: no ``record_function`` without a profiler; a
  range under one, on the main thread and on a worker thread (the gate
  is the profiler module's flag, which every thread reads);
* `utils.profiling.SPANS`: every name a trace reader can take for the
  program's, and every span the program opens listed;
* a streamed `compress_in_memory`: one BI pre-pass, Gram taps only in
  the tap sweep, every solver op under a solve;
* the batcher: every dispatch of the stack inside a step, the sampling
  span present, the same tokens with and without a profiler.
"""

import contextlib
import os
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from modegpt_tpu_torch.compress.pipeline import compress_in_memory  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig  # noqa: E402
from modegpt_tpu_torch.models.init import init_params  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec  # noqa: E402
from modegpt_tpu_torch.utils import profiling  # noqa: E402
from modegpt_tpu_torch.utils.profiling import SPANS, span  # noqa: E402
from perfbench.counts.solvers import SOLVER_OPS  # noqa: E402

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "modegpt_tpu_torch")


def _spec(n_layers=2, d_model=64, d_int=144):
    return ModelSpec(
        arch="llama", vocab_size=128, d_model=d_model, n_layers=n_layers, n_heads=4, n_kv_heads=2,
        head_dim=d_model // 4, d_int=d_int, max_position_embeddings=128, act="silu", norm="rmsnorm",
        norm_eps=1e-6, rope_theta=10000.0, attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
        q_ranks=(d_model,) * n_layers, k_ranks=(d_model // 2,) * n_layers, v_ranks=(d_model // 2,) * n_layers,
        o_ranks=(d_model,) * n_layers, gate_ranks=(d_int,) * n_layers,
    )


def _params(spec, seed=0):
    return init_params(spec, torch.Generator().manual_seed(seed), device="cpu")


def _ranges(prof, name):
    """[(start, end)] of the CPU ranges called ``name``."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]


def _inside(iv, outer):
    return any(s <= iv[0] and iv[1] <= t for s, t in outer)


def test_span_enters_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = span("modegpt.serve.step")
    with first:
        with span("modegpt.model.step"):
            pass
    assert span("modegpt.serve.sample") is first  # one shared no-op


def test_span_emits_under_a_profiler_on_every_thread(monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("modegpt.serve.step"):
            torch.ones(4).add_(1)
    assert len(_ranges(prof, "modegpt.serve.step")) == 1

    opened = []
    real = torch.profiler.record_function

    def recording(name):
        opened.append((name, threading.current_thread().name))
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)

    def worker():
        with span("modegpt.compress.decompose"):
            torch.ones(4).mul_(2)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=worker, name="flush-worker")
        t.start()
        t.join()
    assert opened == [("modegpt.compress.decompose", "flush-worker")]


def test_span_names_stay_out_of_the_readers_other_buckets():
    assert len(set(SPANS)) == len(SPANS)
    for name in SPANS:
        assert name.startswith("modegpt.") and not name.startswith(("cu", "perfbench."))
        assert not any(op in name.lower() for op in SOLVER_OPS), name
    opened = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    opened |= set(re.findall(r"\bspan\(\"([^\"]+)\"\)", fh.read()))
    assert opened == set(SPANS)
    assert profiling.__all__ == ["trace", "span", "SPANS"]


def test_streamed_job_spans():
    spec = _spec()
    config = CompressionConfig(
        model="mem", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=32, compression_ratio=0.3,
        sparsity_smoothing=0.5, solver_precision="f32_device", device="cpu", bi_stage_dtype="bf16",
    )
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        compress_in_memory(spec, _params(spec), config)
    prepass = _ranges(prof, "modegpt.compress.bi_prepass")
    taps = _ranges(prof, "modegpt.compress.taps")
    solves = _ranges(prof, "modegpt.compress.decompose")
    assert len(prepass) == 1
    # two tap blocks a layer a batch (attention, MLP), none in the pre-pass
    assert len(taps) == 2 * spec.n_layers * 2 and not any(_inside(t, prepass) for t in taps)
    assert solves and all(t[1] <= solves[-1][0] for t in taps)
    # every solver op; the BI pieces' vector norms belong to the forwards
    linalg = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith("aten::linalg_") and e.name != "aten::linalg_vector_norm"]
    assert linalg and all(_inside(iv, solves) for iv in linalg)


def _run(pm, prefill_exec, profile, prompts):
    b = ContinuousBatcher(pm, slots=3, max_len=96, prefill_bucket=16, prefill_exec=prefill_exec,
                          per_request_sampling=True)
    for i, p in enumerate(prompts):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.9)
        b.submit(p, max_new_tokens=5, **kw)
    gen = torch.Generator().manual_seed(7)
    out = {}
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if profile else None
    with prof or contextlib.nullcontext():
        while b.queue or any(r is not None for r in b.slot_req):
            out.update(b.step(gen)[0])
    return out, prof


@pytest.mark.parametrize("prefill_exec", ["per_slot", "batched"])
def test_batcher_spans_and_tokens(prefill_exec):
    spec = _spec()
    pm = pad_to_uniform(spec, _params(spec, seed=1))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (20, 5, 40, 17, 9)]
    traced, prof = _run(pm, prefill_exec, True, prompts)
    plain, _ = _run(pm, prefill_exec, False, prompts)
    assert traced == plain and len(traced) == len(prompts)

    steps = _ranges(prof, "modegpt.serve.step")
    model = _ranges(prof, "modegpt.model.step")
    assert steps and model and all(_inside(m, steps) for m in model)
    assert _ranges(prof, "modegpt.serve.sample")

