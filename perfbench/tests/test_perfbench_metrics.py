"""The metric arithmetic on synthetic records and events."""

import math
import types

import numpy as np
import pytest
import torch
from tiny_cells import ROOT  # noqa: F401  (puts the checkout on sys.path)

from perfbench import harness, peaks, trace
from perfbench.counts import k1, k3, model_flops
from perfbench.drivers import serve_loop as serve


def test_busy_time_is_the_union_of_overlapping_intervals():
    busy, gaps = trace._union([(0, 10), (5, 12), (20, 30), (25, 26)], -5, 40)
    assert busy == 22
    assert gaps == [(-5, 0), (12, 20), (30, 40)]


def test_idle_share_and_named_gaps_from_events():
    class E:
        def __init__(self, name, s, t, device=False, eid=0, parent=None):
            self.name, self.thread, self.id, self.cpu_parent = name, 1, eid, parent
            self.time_range = types.SimpleNamespace(start=s, end=t)
            self.device_type = trace.torch.autograd.DeviceType.CUDA if device else trace.torch.autograd.DeviceType.CPU

    win = E(trace.WINDOW, 0, 100)
    mm = E("aten::mm", 5, 10, eid=42, parent=win)  # an op's id may equal a launch's
    launch = E("cudaLaunchKernel", 6, 7, eid=42, parent=mm)
    step = E("perfbench.step", 40, 90, parent=win)
    events = [win, mm, launch, step,
              E("sgemm_kernel", 10, 30, device=True, eid=42),
              E("other", 20, 40, device=True),
              E("late", 60, 70, device=True)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert s["kernels"][0][3] == ("cudaLaunchKernel", "aten::mm", trace.WINDOW)
    gaps = dict(s["idle_gaps"])
    assert gaps["perfbench.step"] == pytest.approx(50e-6)  # [40, 60] and [70, 90] lie inside the step
    assert sum(gaps.values()) == pytest.approx(60e-6)
    idle = harness.load_metric("idle_pct.serve", ROOT).read({"trace": s})
    assert idle == pytest.approx(60.0)


def test_the_tails_of_every_request_and_every_token_gap():
    reqs = {i: serve.Request(i, np.zeros(4), 2, True, t_submit=float(i)) for i in range(100)}
    for i, r in reqs.items():
        r.t_first = r.t_submit + (0.001 * i)
        r.times = [r.t_first, r.t_first, r.t_first + 0.002 * i]  # two tokens of one step: a gap of 0
    loop = types.SimpleNamespace(reqs=reqs)
    e2e = serve.end_to_end({"t_open": 0.0, "t_close": 150.0, "loop": loop})
    gaps = [0.0] * 100 + [2.0 * i for i in range(100)]
    assert e2e["itl_p95_ms"] == pytest.approx(np.percentile(gaps, 95))
    assert e2e["ttft_p95_ms"] == pytest.approx(np.percentile(np.arange(100.0), 95))
    assert serve.token_gaps_ms(loop, 0.0, 50.0)[:2] == [0.0, 0.0]
    ttft = serve.ttft_ms(reqs.values(), 0.0, 100.0)
    assert len(ttft) == 100  # every request due in the window, served or late
    got = harness.load_metric("ttft_p50_ms", ROOT).read({"ttft_ms": ttft})
    assert got == pytest.approx(np.percentile(np.arange(100.0), 50))


def test_k1_counts():
    B, H, Hk, T, hd = 4, 64, 8, 2048, 128
    assert k1.flops(B, H, T, hd, hd) == 2 * B * H * (T * (T + 1) // 2) * 2 * hd
    nbytes = k1.nbytes(B, H, Hk, T, hd, hd, 4)
    assert nbytes == 4 * (2 * B * H * T * hd + 2 * B * Hk * T * hd)
    assert k1.bound_s(B, H, Hk, T, hd, hd, 4) == max(k1.flops(B, H, T, hd, hd) / peaks.TF32_FLOPS,
                                                      nbytes / peaks.HBM_BYTES_PER_S)
    rec = {"trace": {"kernels": [("attention_tile_loop<float>", 0, 2000, ()), ("x", 0, 5, ())] * 3},
           "k1_launches": 3, "k1_launch_bound_s": 1e-3}
    assert harness.load_metric("k1_roofline_pct", ROOT).read(rec) == pytest.approx(50.0)
    assert harness.load_metric("k1_roofline_pct", ROOT).read(dict(rec, k1_launches=4)) is None


def test_k3_counts_decode_and_chunk_rows():
    H, Hk, R = 32, 8, 88
    f, b = k3.launch_counts([(99, 1)], H, Hk, R, R, 4)  # one decode row at length 99: 100 keys
    assert f == 2 * H * 100 * 2 * R
    assert b == 4 * (Hk * 100 * 2 * R + H * 2 * R)
    f, b = k3.launch_counts([(128, 3)], H, Hk, R, R, 4)  # a chunk of 3 tokens at offset 128
    assert f == 2 * H * (129 + 130 + 131) * 2 * R
    assert b == 4 * (Hk * 131 * 2 * R + H * 3 * 2 * R)
    rec = {"trace": {"kernels": [("decode_split", 0, 3e6, ()), ("combine_splits", 0, 1e6, ())]},
           "k3_launches": 36, "k3_expected_launches": 36, "k3_bound_s": 1.0}
    assert harness.load_metric("k3_roofline_pct", ROOT).read(rec) == pytest.approx(25.0)
    assert harness.load_metric("k3_roofline_pct", ROOT).read(dict(rec, k3_expected_launches=72)) is None


def test_model_flops_and_mfu():
    cfg = dict(hidden_size=5120, num_attention_heads=64, num_key_value_heads=8, head_dim=128,
               intermediate_size=25600, num_hidden_layers=2, vocab_size=151936)
    per_layer = model_flops.compress_job_flops(cfg, 32, 2048) / 2
    # 0.49 B weights a layer, 65536 tokens: about 64 TFLOP forward, 86 TFLOP of MLP Gram
    assert per_layer == pytest.approx(2 * 65536 * 487_587_840 + k1.flops(32, 64, 2048, 128, 128)
                                      + 2 * 65536 * (5120**2 + 72 * 128**2 + 25600**2))
    assert 150e12 < per_layer < 160e12
    mfu = harness.load_metric("mfu_pct.compress", ROOT).read({"flops": peaks.TF32_FLOPS, "window_s": 4.0})
    assert mfu == pytest.approx(25.0)
    assert model_flops.decode_token_flops(dict(cfg, num_hidden_layers=1), 88, 88, 100) == \
        2 * (5120 * 64 * 88 * 2 + 5120 * 8 * 88 * 2 + 3 * 5120 * 100)


def test_shares_of_a_peak_never_clip():
    rec = {"trace": {"kernels": [("attention_tile_loop", 0, 1000, ())]}, "k1_launches": 1,
           "k1_launch_bound_s": 2e-3}
    assert harness.load_metric("k1_roofline_pct", ROOT).read(rec) == pytest.approx(200.0)
    assert not math.isnan(harness.load_metric("mfu_pct.serve", ROOT).read({"flops": 1.0, "untraced_s": 1.0}))


def test_serving_lengths_and_arrivals_are_a_fixed_set_in_the_seeds_order():
    tr = {"pool": 64, "arrivals": {"rate_per_s": 2.0}, "prompt_len": {"median": 512, "sigma": 0.7, "min": 64, "max": 2048},
          "output_len": {"median": 64, "sigma": 0.7, "min": 16, "max": 256}, "greedy_every": 2,
          "sampled": {"temperature": 0.7, "top_p": 0.9}}
    a, b = serve.Traffic(tr, 1, 1000), serve.Traffic(tr, 2**31 + 7, 1000)
    da = [a.draw() for _ in range(64)]
    db = [b.draw() for _ in range(64)]
    assert sorted((len(p), n, g) for p, n, g, _ in da) == sorted((len(p), n, g) for p, n, g, _ in db)
    assert sorted(x[3] for x in da) == sorted(x[3] for x in db)
    assert [len(p) for p, *_ in da] != [len(p) for p, *_ in db]
    assert min(len(p) for p, *_ in da) >= 64 and max(x[1] for x in da) <= 256
    assert sum(x[3] for x in da) / 64 == pytest.approx(0.5, rel=0.1)  # the mean gap at 2 a second
    assert [x[3] for x in da] != [x[3] for x in db]  # the same gaps in another order


def test_the_nucleus_floor_is_the_least_logit_top_p_keeps():
    logits = torch.tensor([[4.0, 3.0, 0.0, -1.0], [0.0, 0.0, 0.0, 0.0]])
    # probabilities 0.718, 0.264, 0.013, 0.005: the mass before the third is 0.982
    assert serve.nucleus_floor(logits, 1.0, 0.9).tolist() == pytest.approx([3.0, 0.0])
    assert serve.nucleus_floor(logits, 1.0, 0.5).tolist() == pytest.approx([4.0, 0.0])
    assert serve.nucleus_floor(logits, 0.5, 0.9).tolist() == pytest.approx([3.0, 0.0])  # 0.881 before the second
