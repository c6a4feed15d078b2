"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: a step that returns its state unchanged, half of the
batch left out, an answer or a token altered where it is produced, and
for the sampled requests a filter left out. (The exchange between chips
is no fault of a one-card cell.)"""

import pytest
import torch
from tiny_cells import compress_cell, context, serve_cell

from perfbench import harness
from perfbench.drivers import compress_job, serve_loop


def _state_unchanged(monkeypatch):
    from modegpt_tpu_torch.compress import offload

    real = offload._layer

    def layer(spec, l, p, x, *a, **k):
        _, taps = real(spec, l, p, x, *a, **k)
        return x, taps

    monkeypatch.setattr(offload, "_layer", layer)


def _half_batch(monkeypatch):
    from modegpt_tpu_torch.compress import pipeline

    real = pipeline.load_calibration_batches

    def half(*a, **k):
        batches = real(*a, **k)
        return batches[: max(1, len(batches) // 2)]

    monkeypatch.setattr(pipeline, "load_calibration_batches", half)


def _answer_altered(monkeypatch):
    from modegpt_tpu_torch.compress import pipeline

    real = pipeline.compress_in_memory

    def altered(*a, **k):
        spec, params = real(*a, **k)
        mask = params["layers"][0]["rotary_mask"]
        half, hd = mask.shape[1] // 2, spec.head_dim
        spare = sorted(set(range(hd // 2)) - set(mask[0, :half].tolist()))[0]
        mask[0, 0], mask[0, half] = spare, spare + hd // 2
        return spec, params

    monkeypatch.setattr(pipeline, "compress_in_memory", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_compression_faults_are_caught(monkeypatch, fault):
    fault(monkeypatch)
    res = compress_job.run(context(compress_cell()))
    assert not harness.correct(res["checks"]), res["checks"]


def _cache_unchanged(monkeypatch):
    from modegpt_tpu_torch.models import padded

    monkeypatch.setattr(padded, "_scatter", lambda cache, new, ix: None)


def _half_the_rows(monkeypatch):
    from modegpt_tpu_torch.models import serving

    real = serving._step

    def half(*a, **k):
        out = real(*a, **k)
        n = out.shape[0] // 2
        if n:
            out[n: 2 * n] = out[:n]
        return out

    monkeypatch.setattr(serving, "_step", half)


def _token_altered(monkeypatch):
    from modegpt_tpu_torch.models import serving

    real = serving._pick

    def pick(*a, **k):
        nxt, *rest = real(*a, **k)
        return ((nxt + 1) % 512, *rest)

    monkeypatch.setattr(serving, "_pick", pick)


def _filter_skipped(monkeypatch):
    """The sampled rows drawn from the whole distribution: temperature
    applied, the top_p filter left out (the greedy rows are untouched)."""
    from modegpt_tpu_torch.models import generate

    monkeypatch.setattr(generate, "filter_rows", lambda scaled, samp, samp_dev=None: scaled)


@pytest.mark.parametrize("fault", [_cache_unchanged, _half_the_rows, _token_altered, _filter_skipped])
def test_serving_faults_are_caught(monkeypatch, fault):
    fault(monkeypatch)
    res = serve_loop.run(context(serve_cell(), seconds=2.0))
    assert not harness.correct(res["checks"]), res["checks"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    """The control (the reference with TF32 on, in the program's place)
    reads more than three times what the program does, at a small size
    on the card; at the cells' sizes `tools/readings.py` measures both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    cell = compress_cell()
    cell.config.update(hidden_size=1024, intermediate_size=2816, num_attention_heads=8, num_key_value_heads=2,
                       head_dim=128)
    cell.traffic["compression"].update(calib_size=8, seq_len=512)
    dev = torch.device("cuda")
    prog = compress_job.run(context(cell, device="cuda"))["checks"]["hidden_gap"]["value"]
    ctrl = compress_job.control_reading(cell, 2**31 + 12345, dev)["hidden_gap"]["value"]
    assert ctrl > 3 * prog
