"""The expert layer's span and counters, on the CPU.

* ``modegpt.moe.experts`` is one of `utils.profiling.SPANS` and opens in
  `models.forward._moe_mlp` (once a MoE layer, around the routed work)
  and in `_moe_mlp_dispatch`;
* ``_moe_mlp.calls`` and ``_moe_mlp.tokens`` count one forward exactly:
  a call and B * T tokens for each MoE layer, none for a dense one;
* the outputs, the calibration Grams with them, are bit-equal with the
  profiler on and off.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from modegpt_tpu_torch.models import forward as fwd  # noqa: E402
from modegpt_tpu_torch.models.init import init_params  # noqa: E402
from modegpt_tpu_torch.models.spec import spec_from_hf_config  # noqa: E402
from modegpt_tpu_torch.utils.profiling import SPANS  # noqa: E402

SPAN = "modegpt.moe.experts"


def _spec(mlp_only_layers=()):
    return spec_from_hf_config(SimpleNamespace(
        model_type="qwen3_moe", vocab_size=96, hidden_size=32, intermediate_size=48, moe_intermediate_size=16,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, attention_bias=False, rope_scaling=None, num_experts=6,
        num_experts_per_tok=2, norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=list(mlp_only_layers),
        use_sliding_window=False, sliding_window=None,
    ))


def _ranges(prof, name):
    return [e for e in prof.events() if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_the_span_is_listed():
    assert SPAN in SPANS


@pytest.mark.parametrize("mlp_only_layers", [(), (1,)])
def test_forward_counts_and_spans_each_moe_layer(mlp_only_layers):
    spec = _spec(mlp_only_layers)
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    ids = torch.randint(0, 96, (2, 24), generator=torch.Generator().manual_seed(1))
    moe = tuple(l for l in range(spec.n_layers) if spec.is_moe_layer(l))
    n_moe = len(moe)
    calls, tokens = fwd._moe_mlp.calls, fwd._moe_mlp.tokens
    (logits, stats), prof = _profiled(lambda: fwd.forward(spec, params, ids, stats_layers=moe))
    assert fwd._moe_mlp.calls - calls == n_moe
    assert fwd._moe_mlp.tokens - tokens == n_moe * 2 * 24
    assert len(_ranges(prof, SPAN)) == n_moe
    plain, plain_stats = fwd.forward(spec, params, ids, stats_layers=moe)
    assert torch.equal(logits, plain)
    assert torch.equal(stats.cov_mlp, plain_stats.cov_mlp)


def test_dispatch_opens_the_span_and_is_bit_equal():
    spec = _spec()
    lp = init_params(spec, torch.Generator().manual_seed(2), device="cpu")["layers"][0]
    x = torch.randn((2, 10, 32), generator=torch.Generator().manual_seed(3))
    calls = fwd._moe_mlp.calls
    y, prof = _profiled(lambda: fwd._moe_mlp_dispatch(spec, lp, x, 3.0))
    assert len(_ranges(prof, SPAN)) == 1
    assert fwd._moe_mlp.calls == calls  # the counters are the dense path's
    assert torch.equal(y, fwd._moe_mlp_dispatch(spec, lp, x, 3.0))
