"""The program's spans in a reduced trace, on synthetic events."""

import types

import pytest
from tiny_cells import ROOT

from perfbench import harness, spans, trace

COMPRESS = {"prepass_s_per_layer": "modegpt.compress.bi_prepass", "taps_s_per_layer": "modegpt.compress.taps",
            "decompose_s_per_layer": "modegpt.compress.decompose"}
SERVE = {"idle_model_pct.serve": "modegpt.model.step", "idle_sample_pct.serve": "modegpt.serve.sample",
         "idle_batcher_pct.serve": "modegpt.serve.step"}

STEP = ("modegpt.serve.step", "perfbench.step", trace.WINDOW)
MODEL = ("cudaLaunchKernel", "aten::mm", "modegpt.model.step") + STEP
SAMPLE = ("cudaLaunchKernel", "aten::softmax", "modegpt.serve.sample") + STEP
BATCHER = ("cudaMemcpyAsync", "aten::copy_") + STEP
HARNESS = ("cudaLaunchKernel", "aten::add", "perfbench.step", trace.WINDOW)
# a window [0, 200] us: busy 10+20+5+10+15+10 = 70, idle 130
SERVE_KERNELS = [
    ("index", 10, 20, BATCHER),  # the gap [0, 10] is the window's edge
    ("mm", 30, 50, MODEL),  # [20, 30] ended by the model step
    ("mm2", 45, 50, MODEL),  # overlaps: no gap
    ("sample", 60, 65, SAMPLE),  # [50, 60]
    ("index", 100, 110, BATCHER),  # [65, 100]
    ("add", 115, 130, HARNESS),  # [110, 115]: no program span
    ("mm", 170, 180, MODEL),  # [130, 170]; [180, 200] is the edge
]
SERVE_TRACE = {"window_s": 200e-6, "busy_s": 70e-6, "kernels": SERVE_KERNELS}


def test_idle_goes_to_the_span_that_ends_the_gap():
    got = spans.idle_by_span(SERVE_KERNELS, 200e-6, 70e-6)
    assert got["modegpt.model.step"] == pytest.approx(50e-6)
    assert got["modegpt.serve.sample"] == pytest.approx(10e-6)
    assert got["modegpt.serve.step"] == pytest.approx(35e-6)
    assert got[""] == pytest.approx(5e-6 + 10e-6 + 20e-6)  # no span, and the window's two edges
    assert sum(got.values()) == pytest.approx(130e-6)


def test_idle_of_kernels_out_of_order_and_nested():
    """Kernels come in device order per stream, not in start order; one
    inside another ends no gap."""
    kernels = [("b", 40, 50, MODEL), ("a", 0, 30, BATCHER), ("inner", 5, 10, SAMPLE)]
    assert spans.idle_by_span(kernels, 60e-6, 40e-6) == pytest.approx({"modegpt.model.step": 10e-6, "": 10e-6})


def test_device_seconds_under_a_span_are_a_union():
    kernels = [
        ("sgemm", 0, 10, ("cudaLaunchKernel", "aten::mm", "modegpt.compress.taps", "perfbench.job")),
        ("copy", 5, 15, ("cudaMemcpyAsync", "modegpt.compress.taps")),  # another stream, overlapping
        ("getrf", 20, 30, ("cudaLaunchKernel", "aten::linalg_lu_factor_ex", "modegpt.compress.decompose")),
        ("elementwise", 40, 41, ("cudaLaunchKernel", "aten::add")),
    ]
    assert spans.device_seconds(kernels, "modegpt.compress.taps") == pytest.approx(15e-6)
    assert spans.device_seconds(kernels, "modegpt.compress.decompose") == pytest.approx(10e-6)
    assert spans.device_seconds(kernels, "modegpt.compress.bi_prepass") == 0.0


@pytest.mark.parametrize("metric", sorted(COMPRESS))
def test_the_compression_span_readers(metric):
    span = COMPRESS[metric]
    kernels = [("k", 0, 3e6, ("cudaLaunchKernel", "aten::mm", span)), ("k", 1e6, 5e6, ("cudaLaunchKernel", span)),
               ("other", 0, 9e6, ("cudaLaunchKernel", "aten::mm"))]
    reader = harness.load_metric(metric, ROOT)
    assert reader.read({"trace": {"kernels": kernels}, "layers": 2}) == pytest.approx(2.5)
    # what the parent program's trace reads: no span, nothing to read
    assert reader.read({"trace": {"kernels": kernels[2:]}, "layers": 2}) is None
    assert reader.read({"trace": None, "layers": 2}) is None


@pytest.mark.parametrize("metric", sorted(SERVE))
def test_the_serving_idle_readers(metric):
    want = {"modegpt.model.step": 25.0, "modegpt.serve.sample": 5.0, "modegpt.serve.step": 17.5}[SERVE[metric]]
    reader = harness.load_metric(metric, ROOT)
    assert reader.read({"trace": SERVE_TRACE}) == pytest.approx(want)
    # what the parent program's trace reads: no span, nothing to read
    bare = [(n, s, t, tuple(op for op in ops if not op.startswith("modegpt."))) for n, s, t, ops in SERVE_KERNELS]
    assert reader.read({"trace": dict(SERVE_TRACE, kernels=bare)}) is None
    assert reader.read({"trace": None}) is None


def test_the_serving_split_adds_up_to_the_idle_share():
    idle = harness.load_metric("idle_pct.serve", ROOT).read({"trace": SERVE_TRACE})
    parts = sum(harness.load_metric(m, ROOT).read({"trace": SERVE_TRACE}) for m in SERVE)
    outside = 100 * spans.idle_by_span(SERVE_KERNELS, 200e-6, 70e-6)[""] / 200e-6
    assert parts + outside == pytest.approx(idle)


def test_summarize_carries_the_spans_to_the_kernels():
    class E:
        def __init__(self, name, s, t, device=False, eid=0, parent=None, annotation=False):
            self.name, self.thread, self.id, self.cpu_parent = name, 1, eid, parent
            self.is_user_annotation = annotation
            self.time_range = types.SimpleNamespace(start=s, end=t)
            self.device_type = trace.torch.autograd.DeviceType.CUDA if device else trace.torch.autograd.DeviceType.CPU

    win = E(trace.WINDOW, 0, 100)
    job = E("perfbench.job", 1, 99, parent=win)
    taps = E("modegpt.compress.taps", 5, 20, parent=job)
    mm = E("aten::mm", 6, 10, eid=7, parent=taps)
    launch = E("cudaLaunchKernel", 7, 8, eid=7, parent=mm)
    events = [win, job, taps, mm, launch,
              E("sgemm", 10, 30, device=True, eid=7),
              E("modegpt.compress.taps", 10, 30, device=True, annotation=True)]  # the range's device mirror
    s = trace.summarize(events)
    assert [k[0] for k in s["kernels"]] == ["sgemm"]
    assert s["kernels"][0][3] == ("cudaLaunchKernel", "aten::mm", "modegpt.compress.taps", "perfbench.job",
                                  trace.WINDOW)
    assert s["busy_s"] == pytest.approx(20e-6)
    got = harness.load_metric("taps_s_per_layer", ROOT).read({"trace": s, "layers": 1})
    assert got == pytest.approx(20e-6)
