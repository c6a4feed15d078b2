"""The Qwen3-MoE compression cell at a tiny size on the CPU: 4 layers,
hidden 64, 8 experts of 24, top 2.

* a whole run of `drivers.compress_job_moe` agrees with the plain
  reference (every rank, ``hidden_gap`` under 1e-4) on two seeds;
* the reference's routed MoE layer gives the port's `_moe_mlp` output;
* the routed FLOP and byte counts against a hand count;
* three faults planted in the program read above the cell's limit:
  routing weights left unnormalised, an expert's Gram over every token,
  the (k+1)-th ranked expert taken in place of the k-th.
"""

import copy
from types import SimpleNamespace

import pytest
import torch
from tiny_cells import ROOT, context

from perfbench import harness, peaks
from perfbench.counts import moe
from perfbench.drivers import compress_job_moe
from perfbench.reference import qwen3, qwen3_moe

# initializer_range 0.1 at hidden 64 gives each product the spread that
# 0.02 gives at the published hidden 2048 (0.1 * 8 ~ 0.02 * 45), so the
# experts weigh in the residual stream as much as at the published widths
TINY_MOE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=512,
                num_experts=8, moe_intermediate_size=24, num_experts_per_tok=2, num_hidden_layers=4,
                initializer_range=0.1)
SEEDS = (2**31 + 12345, 7)


def moe_cell():
    cell = harness.Cell("qwen3-30b-a3b.compress", ROOT)
    tr = copy.deepcopy(cell.traffic)
    tr["compression"].update(calib_size=8, calibs_batch_size=4, seq_len=128)
    tr["check_tokens"] = dict(sequences=2, seq_len=128)
    return SimpleNamespace(config=dict(cell.config, **TINY_MOE), traffic=tr, limits=cell.limits, root=ROOT)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_driver_agrees_with_the_reference(seed):
    res = compress_job_moe.run(context(moe_cell(), seed=seed))
    assert res["checks"]["rank_mismatch"]["value"] == 0
    assert res["checks"]["hidden_gap"]["value"] < 1e-4, res["checks"]
    assert harness.correct(res["checks"])
    rec = res["record"]
    assert rec["moe_calls"] == rec["moe_expected_calls"] > 0
    assert rec["moe_tokens"] == rec["moe_expected_tokens"] == rec["moe_calls"] * 4 * 128


def test_the_reference_moe_layer_gives_the_ports():
    from modegpt_tpu_torch.models.forward import _moe_mlp

    cfg = moe_cell().config
    lp = compress_job_moe.model_params(cfg, 11, "cpu")["layers"][0]
    spec = compress_job_moe.weights.spec_of(cfg)
    x = torch.randn((2, 40, cfg["hidden_size"]), generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), qwen3.matmul_precision(False):
        y_port, h_routed, _ = _moe_mlp(spec, lp, x, collect=True)
        grams = torch.zeros((cfg["num_experts"], 24, 24))
        y_ref = qwen3_moe.moe_mlp(cfg, lp, x, grams)
    torch.testing.assert_close(y_ref, y_port, rtol=0, atol=1e-5)
    torch.testing.assert_close(grams, torch.einsum("btef,bteg->efg", h_routed, h_routed), rtol=0, atol=1e-5)


def test_routed_counts_by_hand():
    cfg = dict(hidden_size=2048, num_attention_heads=32, num_key_value_heads=4, head_dim=128,
               moe_intermediate_size=768, num_experts=128, num_experts_per_tok=8, num_hidden_layers=4)
    n = 8192
    # router 2*n*2048*128; 8 experts a token, 3 products of 2048 x 768 each
    assert moe.experts_flops(cfg, n) == 2 * n * 2048 * 128 + 2 * n * 8 * 3 * 2048 * 768
    # 128 experts' three [2048, 768] kernels and the [2048, 128] router once;
    # each of the 8 routed rows of a token read and written once
    assert moe.experts_bytes(cfg, n, 4) == 4 * (128 * 3 * 2048 * 768 + 2048 * 128 + n * 8 * 2 * 2048)
    assert moe.experts_bound_s(cfg, n) == max(moe.experts_flops(cfg, n) / peaks.TF32_FLOPS,
                                              moe.experts_bytes(cfg, n, 4) / peaks.HBM_BYTES_PER_S)
    # at the cell's calls the products bound it: 622.8 GFLOP in 1.26 ms
    assert moe.experts_bound_s(cfg, n) == pytest.approx(622.8e9 / 494.7e12, rel=1e-3)
    # the job: each expert's Gram over its routed rows (n * k rows of D x D)
    N = 32 * 2048
    attn = 2.0 * N * (2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048) + 2.0 * 32 * 32 * (2048 * 2049 // 2) * 256
    taps = 2.0 * N * (2048**2 + 32 * 128**2 + 4 * 128**2 + 8 * 768**2)
    assert moe.compress_job_flops(cfg, 32, 2048) == pytest.approx(4 * (attn + moe.experts_flops(cfg, N) + taps))


def _unnormalised(monkeypatch):
    from modegpt_tpu_torch.models import forward

    def route(spec, p, x):
        probs = torch.softmax(forward._linear(x, p["router"]).to(torch.float32), dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return w[..., : spec.experts_per_tok], idx[..., : spec.experts_per_tok]

    monkeypatch.setattr(forward, "_route", route)


def _gram_of_every_token(monkeypatch):
    from modegpt_tpu_torch.models import forward

    real = forward._moe_mlp

    def moe_mlp(spec, p, x, collect, tp=None):
        y, _, h_shared = real(spec, p, x, False, tp)
        if not collect:
            return y, None, h_shared
        x2 = x.reshape(-1, x.shape[-1])
        h = forward._act(torch.matmul(x2, p["experts"]["gate"]["kernel"]), spec.act)
        h = h * torch.matmul(x2, p["experts"]["up"]["kernel"])  # [E, N, D], no routing mask
        return y, h.transpose(0, 1).reshape(*x.shape[:2], *h.shape[::2]), h_shared

    moe_mlp.calls = moe_mlp.tokens = 0  # the program counts on the name it calls
    monkeypatch.setattr(forward, "_moe_mlp", moe_mlp)


def _next_ranked_expert(monkeypatch):
    from modegpt_tpu_torch.models import forward

    def route(spec, p, x):
        probs = torch.softmax(forward._linear(x, p["router"]).to(torch.float32), dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = spec.experts_per_tok
        keep = list(range(k - 1)) + [k]  # the (k+1)-th in place of the k-th
        w, idx = w[..., keep], idx[..., keep]
        return w / w.sum(dim=-1, keepdim=True), idx

    monkeypatch.setattr(forward, "_route", route)


@pytest.mark.parametrize("fault", [_unnormalised, _gram_of_every_token, _next_ranked_expert])
def test_moe_faults_read_above_the_limit(monkeypatch, fault):
    fault(monkeypatch)
    res = compress_job_moe.run(context(moe_cell()))
    gap = res["checks"]["hidden_gap"]
    assert gap["value"] > gap["limit"], res["checks"]
    assert not harness.correct(res["checks"])
