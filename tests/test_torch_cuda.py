"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode): it
carries the ``cuda`` marker and skips without a card. The file imports
torch, numpy and the port only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are the JAX package's own kernel tolerances: float32 rtol
2e-4 / atol 2e-5, bfloat16 2e-2.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from modegpt_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_hbm,
    flash_attention_hbm_reference,
    flash_attention_reference,
)
from modegpt_tpu_torch.models.forward import forward  # noqa: E402
from modegpt_tpu_torch.models.init import init_params  # noqa: E402
from modegpt_tpu_torch.models.spec import spec_from_hf_config  # noqa: E402

pytestmark = pytest.mark.cuda

CASES = {
    "gqa_T160_hd24": dict(B=2, H=4, Hk=2, T=160, hd=24, hd_v=24, window=None),
    "T300": dict(B=1, H=4, Hk=2, T=300, hd=32, hd_v=32, window=None),
    "window8": dict(B=1, H=4, Hk=2, T=256, hd=16, hd_v=16, window=8),
    "window100": dict(B=1, H=4, Hk=4, T=256, hd=16, hd_v=16, window=100),
    "hd44_hdv40": dict(B=1, H=4, Hk=2, T=192, hd=44, hd_v=40, window=None),
    "hd256": dict(B=1, H=2, Hk=1, T=130, hd=256, hd_v=256, window=None),
    # the dense archs' shapes: groups of 7 (qwen2) and 9
    # (starcoder2) query heads a kv head, phi3's 96-wide heads with a
    # window just under T, gemma's 256-wide heads without grouping
    "G7": dict(B=1, H=7, Hk=1, T=160, hd=32, hd_v=32, window=None),
    "G9": dict(B=2, H=9, Hk=1, T=200, hd=32, hd_v=32, window=None),
    "hd96_window255": dict(B=1, H=4, Hk=4, T=256, hd=96, hd_v=96, window=255),
    "mha_hd256": dict(B=1, H=2, Hk=2, T=192, hd=256, hd_v=256, window=None),
}
TOLERANCE = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    B, H, Hk, T, hd, hd_v = (case[k] for k in ("B", "H", "Hk", "T", "hd", "hd_v"))
    shapes = ((B, H, T, hd), (B, Hk, T, hd), (B, Hk, T, hd_v))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda_device, name, dtype):
    case = CASES[name]
    q, k, v = _inputs(case, cuda_device, getattr(torch, dtype))
    scale = case["hd"] ** -0.5
    before = flash_attention.launches
    got = flash_attention(q, k, v, scale=scale, window=case["window"])
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (case["B"], case["H"], case["T"], case["hd_v"]) and got.dtype == q.dtype
    want = flash_attention_reference(q, k, v, scale=scale, window=case["window"])
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCE[dtype])


def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _inputs(CASES["T300"], cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*_inputs(dict(CASES["T300"], hd=264, hd_v=8), cuda_device, torch.float32))


def test_forward_goes_through_the_kernel(cuda_device):
    """A tiny Llama's logits through the kernel match the plain attention,
    and every layer launches the kernel once."""
    cfg = SimpleNamespace(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rope_scaling=None,
    )
    spec = spec_from_hf_config(cfg)
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device=cuda_device)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 160))).to(cuda_device)
    before = flash_attention.launches
    got, _ = forward(spec, params, ids)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + spec.n_layers
    want, _ = forward(spec, params, ids, attn_impl="xla")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- K2: the long-context kernel ----

HBM_CASES = {
    "gqa_T640_hd32": dict(B=1, H=4, Hk=2, T=640, hd=32, hd_v=32, window=None),
    "ragged_T300": dict(B=2, H=4, Hk=2, T=300, hd=64, hd_v=64, window=None),
    "window64": dict(B=1, H=4, Hk=2, T=640, hd=32, hd_v=32, window=64),
    "hd44_hdv40": dict(B=1, H=4, Hk=2, T=384, hd=44, hd_v=40, window=None),
    # rows that are not whole 16-byte chunks: the producers' cp.async copies
    "hd88_hdv90": dict(B=1, H=4, Hk=2, T=384, hd=88, hd_v=90, window=None),  # TMA K (f32), 8-/4-byte V copies
    "hd126": dict(B=1, H=4, Hk=2, T=384, hd=126, hd_v=126, window=None),  # a compressed model's padded rank
    "odd_hd45_hdv33": dict(B=1, H=2, Hk=1, T=200, hd=45, hd_v=33, window=None),  # 2-byte bf16 copies
    "hd256": dict(B=1, H=2, Hk=1, T=130, hd=256, hd_v=256, window=None),  # 32-key tiles
    "mha_T8193": dict(B=1, H=2, Hk=2, T=8193, hd=64, hd_v=64, window=None),
    # a window crossing key-tile edges, at a T that ends mid-tile
    "window100_T777": dict(B=1, H=4, Hk=2, T=777, hd=64, hd_v=64, window=100),
    "hd8": dict(B=1, H=4, Hk=2, T=300, hd=8, hd_v=8, window=None),  # one MMA step, TMA boxes past d
    "hd256_T600": dict(B=1, H=2, Hk=1, T=600, hd=256, hd_v=256, window=None),  # many 32-key tiles
    "hd128_hdv90": dict(B=1, H=4, Hk=2, T=500, hd=128, hd_v=90, window=None),  # TMA K beside cp.async V
    "odd_hd201_hdv255": dict(B=1, H=2, Hk=1, T=300, hd=201, hd_v=255, window=None),  # odd widths, 32-key tiles
    "T5_hd45": dict(B=1, H=2, Hk=1, T=5, hd=45, hd_v=45, window=None),  # one tile, most rows past T
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(HBM_CASES))
def test_hbm_kernel_matches_plain(cuda_device, name, dtype):
    case = HBM_CASES[name]
    q, k, v = _inputs(case, cuda_device, getattr(torch, dtype))
    scale = case["hd"] ** -0.5
    before = (flash_attention.launches, flash_attention_hbm.launches)
    got = flash_attention_hbm(q, k, v, scale=scale, window=case["window"])
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_hbm.launches) == (before[0], before[1] + 1)
    assert got.shape == (case["B"], case["H"], case["T"], case["hd_v"]) and got.dtype == q.dtype
    want = flash_attention_hbm_reference(q, k, v, scale=scale, window=case["window"])
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCE[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["hd44_hdv40", "window64", "ragged_T300"])
def test_hbm_kernel_agrees_with_k1(cuda_device, name, dtype):
    """K2 runs on the tensor cores (3xTF32 for f32) and K1 on the CUDA
    cores: where both take the input they agree within the kernel
    tolerances."""
    case = HBM_CASES[name]
    q, k, v = _inputs(case, cuda_device, getattr(torch, dtype), seed=2)
    got = flash_attention_hbm(q, k, v, window=case["window"])
    want = flash_attention(q, k, v, window=case["window"])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCE[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hbm_kernel_on_views_with_an_offset(cuda_device, dtype):
    """K/V whose data pointers are 8- but not 16-byte aligned (contiguous
    views 8 bytes into a buffer) take cp.async copies in place of TMA."""
    case = HBM_CASES["hd44_hdv40"]
    dt = getattr(torch, dtype)
    q, k, v = _inputs(case, cuda_device, dt)

    def shifted(t):
        off = 8 // t.element_size()
        buf = torch.empty(t.numel() + off, device=cuda_device, dtype=dt)
        view = buf[off:].view(t.shape)
        view.copy_(t)
        return view

    ks, vs = shifted(k), shifted(v)
    assert ks.data_ptr() % 16 == 8 and ks.is_contiguous()
    got = flash_attention_hbm(q, ks, vs)
    torch.cuda.synchronize()
    want = flash_attention_hbm_reference(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCE[dtype])


def test_hbm_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _inputs(HBM_CASES["ragged_T300"], cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_hbm(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_hbm(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_hbm(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_hbm(*_inputs(dict(HBM_CASES["ragged_T300"], hd=264, hd_v=8), cuda_device, torch.float32))
    with pytest.raises(ValueError, match="n_kv_heads"):
        flash_attention_hbm(*_inputs(dict(HBM_CASES["ragged_T300"], H=3), cuda_device, torch.float32))
    with pytest.raises(ValueError, match="window"):
        flash_attention_hbm(q, k, v, window=0)


def test_long_forward_goes_through_k2(cuda_device):
    """A tiny Llama with llama3 RoPE scaling at T = 8200: every layer
    launches K2 once and K1 never, and the logits match the row-chunked
    plain attention."""
    cfg = SimpleNamespace(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=16384, rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu",
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    )
    spec = spec_from_hf_config(cfg)
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device=cuda_device)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 8200))).to(cuda_device)
    before = (flash_attention.launches, flash_attention_hbm.launches)
    got, _ = forward(spec, params, ids)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_hbm.launches) == (before[0], before[1] + spec.n_layers)
    want, _ = forward(spec, params, ids, attn_impl="xla")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- K3: ragged GQA attention over a slot-table pool ----

RAGGED_CASES = {
    "decode_gqa_rq40_rv24": dict(B=3, H=4, Hk=2, T=300, S=1, Rq=40, Rv=24),
    "chunk_S16": dict(B=1, H=4, Hk=2, T=200, S=16, Rq=32, Rv=32),
    "S4_window8": dict(B=3, H=4, Hk=2, T=300, S=4, Rq=32, Rv=32, window=8),
    "S4_softcap": dict(B=3, H=4, Hk=2, T=300, S=4, Rq=32, Rv=32, softcap=5.0),
    "int8": dict(B=3, H=4, Hk=2, T=300, S=4, Rq=32, Rv=48, int8=True),
    "mha_r256": dict(B=2, H=4, Hk=4, T=130, S=1, Rq=256, Rv=256),
    "edge_row": dict(B=3, H=4, Hk=2, T=100, S=1, Rq=32, Rv=32, edge=True),
    # the split-K decode and the tensor-core chunk form
    "decode_T4096": dict(B=2, H=8, Hk=2, T=4096, S=1, Rq=64, Rv=64),  # many splits
    "decode_pos0": dict(B=3, H=4, Hk=2, T=300, S=1, Rq=32, Rv=32, pos=0),  # one live key
    "decode_rank126": dict(B=3, H=8, Hk=2, T=500, S=1, Rq=126, Rv=126),  # 504-byte f32 rows, 8-byte copies
    "chunk_S64_int8": dict(B=2, H=4, Hk=2, T=400, S=64, Rq=32, Rv=48, int8=True),
    "chunk_rq88_rv90": dict(B=2, H=4, Hk=2, T=300, S=32, Rq=88, Rv=90),
    "window5": dict(B=3, H=4, Hk=2, T=300, S=4, Rq=32, Rv=32, window=5),  # a window shorter than a split
    # gemma2's soft cap at padded ranks of 256: the decode form and the
    # chunk form's 256-column branch
    "softcap_r256_decode": dict(B=3, H=4, Hk=2, T=300, S=1, Rq=256, Rv=256, softcap=5.0),
    "softcap_r256_chunk": dict(B=2, H=4, Hk=2, T=300, S=32, Rq=256, Rv=256, softcap=5.0),
    "G7_decode": dict(B=3, H=7, Hk=1, T=300, S=1, Rq=128, Rv=128),
    "G9_decode": dict(B=3, H=9, Hk=1, T=300, S=1, Rq=128, Rv=128),
    # the batcher's dispatches: a batched/mixed prefill round (every slot's
    # chunk at its own offset: one at 0, one within a chunk of the pool's
    # end, an idle row past it) and a verify dispatch (last token + 4
    # drafts, G = 4: 20 rows a kv head)
    "batched_chunk_B8_S128": dict(B=8, H=8, Hk=2, T=300, S=128, Rq=32, Rv=32, pos=[0, 250, 305, 17, 120, 64, 199, 3]),
    "batched_chunk_B8_S128_int8": dict(B=8, H=8, Hk=2, T=300, S=128, Rq=32, Rv=32, int8=True,
                                       pos=[0, 250, 305, 17, 120, 64, 199, 3]),
    "verify_B8_S5": dict(B=8, H=8, Hk=2, T=300, S=5, Rq=32, Rv=32),
    # a rank of tensor-parallel serving on model:2: its 16 of 32 heads over
    # 4 of 8 kv heads (Llama-3-8B widths, the main artifact's ranks of 126)
    # or over 2 of 4 (Qwen3-30B-A3B widths, G = 8)
    "tp_H16_Hk4_decode": dict(B=8, H=16, Hk=4, T=1024, S=1, Rq=126, Rv=126),
    "tp_H16_Hk4_batched_chunk": dict(B=8, H=16, Hk=4, T=1024, S=128, Rq=126, Rv=126,
                                     pos=[0, 964, 1029, 17, 120, 64, 199, 3]),
    "tp_H16_Hk4_decode_int8": dict(B=8, H=16, Hk=4, T=1024, S=1, Rq=126, Rv=126, int8=True),
    "tp_H16_Hk2_decode": dict(B=8, H=16, Hk=2, T=1024, S=1, Rq=128, Rv=128),
    "tp_H16_Hk2_chunk": dict(B=1, H=16, Hk=2, T=1024, S=128, Rq=128, Rv=128, pos=384),
}


def _ragged_inputs(case, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    B, H, Hk, T, S, Rq, Rv = (case[k] for k in ("B", "H", "Hk", "T", "S", "Rq", "Rv"))

    def t(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    pos = rng.integers(0, T - S + 1, B).astype(np.int32)
    if "pos" in case:
        pos[:] = case["pos"]
    if case.get("edge"):
        pos[0] = T + 3  # a masked serving row past the pool's end
    q = t((rng.standard_normal((B, H, S, Rq)) * Rq**-0.5).astype(np.float32), dtype)
    if case.get("int8"):
        k, v = (t(rng.integers(-127, 128, (B, Hk, T, r), dtype=np.int8)) for r in (Rq, Rv))
        ks, vs = (t((rng.uniform(0.5, 1.5, (B, Hk, T)) / 127).astype(np.float32)) for _ in range(2))
    else:
        k, v = (t(rng.standard_normal((B, Hk, T, r)).astype(np.float32), dtype) for r in (Rq, Rv))
        ks = vs = None
    return q, k, v, t(pos), dict(k_scale=ks, v_scale=vs, window=case.get("window"), softcap=case.get("softcap"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_kernel_matches_plain(cuda_device, name, dtype):
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend, ragged_gqa_attend_reference

    q, k, v, pos, kw = _ragged_inputs(RAGGED_CASES[name], cuda_device, getattr(torch, dtype))
    before = ragged_gqa_attend.launches
    got = ragged_gqa_attend(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert ragged_gqa_attend.launches == before + 1
    want = ragged_gqa_attend_reference(q, k, v, pos, **kw)
    assert got.shape == want.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCE[dtype])


def test_ragged_kernel_rejects_what_it_does_not_take(cuda_device):
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend

    q, k, v, pos, _ = _ragged_inputs(RAGGED_CASES["chunk_S16"], cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_gqa_attend(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, pos)
    with pytest.raises(ValueError, match="int32"):
        ragged_gqa_attend(q, k, v, pos.long())
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_gqa_attend(q, k.cpu(), v, pos)
    with pytest.raises(ValueError, match="ranks"):
        ragged_gqa_attend(*_ragged_inputs(dict(RAGGED_CASES["chunk_S16"], Rq=264), cuda_device, torch.float32)[:4])


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_padded_serving_steps_go_through_the_ragged_kernel(cuda_device, kv_dtype):
    """A tiny Llama served on the card: a prefill chunk and a decode step
    through K3 match its plain version, one launch per layer each."""
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import _one_decode_step, _prefill_chunk, init_serve_state

    cfg = SimpleNamespace(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rope_scaling=None,
    )
    spec = spec_from_hf_config(cfg)
    pm = pad_to_uniform(spec, init_params(spec, torch.Generator(device="cuda").manual_seed(0), device=cuda_device))
    states = {a: init_serve_state(pm, 3, 64, kv_dtype=kv_dtype) for a in ("ragged", "xla")}
    toks = {}
    for attn, state in states.items():
        before = ragged_gqa_attend.launches
        for slot, n in ((0, 13), (2, 5)):
            piece = np.random.default_rng(slot).integers(0, 256, n)
            toks[attn, slot] = _prefill_chunk(pm, state, slot, piece, 0, 16, True, 0.0, None, decode_attn=attn)
        toks[attn, "decode"] = _one_decode_step(
            pm, state, np.array([True, False, True]), 0.0, None, None, decode_attn=attn
        ).tolist()
        torch.cuda.synchronize()
        launched = ragged_gqa_attend.launches - before
        assert launched == (3 * spec.n_layers if attn == "ragged" else 0)
    assert toks["ragged", 0] == toks["xla", 0] and toks["ragged", 2] == toks["xla", 2]
    assert toks["ragged", "decode"][0::2] == toks["xla", "decode"][0::2]
    a, b = states["ragged"], states["xla"]
    np.testing.assert_array_equal(a.lengths, b.lengths)
    # int8 codes may sit one rounding step apart
    torch.testing.assert_close(a.cache_k.float(), b.cache_k.float(), rtol=1e-4, atol=1e-4 if kv_dtype == "model" else 1.0)


def _tiny_llama_on(device):
    spec = spec_from_hf_config(SimpleNamespace(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rope_scaling=None,
    ))
    return spec, init_params(spec, torch.Generator(device="cuda").manual_seed(0), device=device)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_fused_decode_equals_single_steps_on_the_card(cuda_device, kv_dtype):
    """One fused 4-step decode dispatch (its indices uploaded once, no
    host wait between the steps) gives the tokens, lengths and cache of
    four single decode steps, with 4 K3 launches a layer."""
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import (
        _decode_slots_multi, _one_decode_step, _prefill_chunk, init_serve_state,
    )

    spec, params = _tiny_llama_on(cuda_device)
    pm = pad_to_uniform(spec, params)
    states = [init_serve_state(pm, 3, 64, kv_dtype=kv_dtype) for _ in range(2)]
    for state in states:
        for slot, n in ((0, 13), (2, 5)):
            _prefill_chunk(pm, state, slot, np.random.default_rng(slot).integers(0, 256, n), 0, 16, True, 0.0, None,
                           decode_attn="ragged")
    active = np.array([True, False, True])
    single = np.stack([_one_decode_step(pm, states[0], active, 0.0, None, None, decode_attn="ragged").cpu().numpy()
                       for _ in range(4)])
    before = ragged_gqa_attend.launches
    toks, emitted = _decode_slots_multi(pm, states[1], active, np.array([9, 0, 9]), None, 4, 0.0, None,
                                        decode_attn="ragged")
    assert ragged_gqa_attend.launches - before == 4 * spec.n_layers
    assert emitted[:, 0].all() and emitted[:, 2].all() and not emitted[:, 1].any()
    np.testing.assert_array_equal(toks[:, active], single[:, active])
    np.testing.assert_array_equal(states[1].lengths, states[0].lengths)
    torch.testing.assert_close(states[1].cache_k, states[0].cache_k)


SCHED_MODES = {
    "mixed_fused": dict(prefill_exec="batched", steps_per_dispatch=4),
    "batched_unmixed": dict(prefill_exec="batched", mixed_prefill_decode=False),
    "prefix_cache": dict(prefix_cache=True),
    "prompt_lookup": dict(spec_decode="prompt_lookup", n_draft=4),
    "self_draft": dict(spec_decode="draft", n_draft=3),
}


@pytest.mark.parametrize("mode", sorted(SCHED_MODES))
def test_batcher_modes_on_the_card(cuda_device, mode):
    """Each execution mode of the batcher through K3 on the card gives the
    per-slot single-step batcher's greedy tokens, including a slot that
    comes within a bucket of the pool's end."""
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    spec, params = _tiny_llama_on(cuda_device)
    pm = pad_to_uniform(spec, params)
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 256, 32)
    prompts = [np.concatenate([shared, rng.integers(1, 256, n)]) for n in (3, 20)] + [
        rng.integers(1, 256, n) for n in (50, 7, 12)]
    budgets = [8, 6, 5, 20, 9]
    served = {}
    for name, kw in (("plain", {}), (mode, SCHED_MODES[mode])):
        extra = {"draft_pm": pm} if kw.get("spec_decode") == "draft" else {}
        b = ContinuousBatcher(pm, slots=2, max_len=64, prefill_bucket=16, decode_attn="ragged", **kw, **extra)
        rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
        done = b.run()
        served[name] = [list(map(int, done[r])) for r in rids]
    assert served[mode] == served["plain"]


# the decode forms in use, by rows a kv head (G*S = 1 ... 16; 8 heads)
ROW_SWEEP = [(1, 1), (2, 1), (1, 3), (4, 1), (1, 5), (8, 1), (4, 3), (8, 2)]


@pytest.mark.parametrize("G,S", ROW_SWEEP, ids=[f"rows{G * S}_G{G}_S{S}" for G, S in ROW_SWEEP])
def test_ragged_decode_forms_by_rows(cuda_device, G, S):
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend, ragged_gqa_attend_reference

    case = dict(B=4, H=8, Hk=8 // G, T=700, S=S, Rq=126, Rv=126)
    q, k, v, pos, kw = _ragged_inputs(case, cuda_device, torch.float32, seed=G * 16 + S)
    got = ragged_gqa_attend(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ragged_gqa_attend_reference(q, k, v, pos, **kw), **TOLERANCE["float32"])


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_ragged_one_row_form(cuda_device, pool):
    """Multi-head decode (G*S = 1) takes the one-row form, whose P.V key
    loop stays rolled: against the plain version in every pool dtype."""
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend, ragged_gqa_attend_reference

    case = dict(B=4, H=8, Hk=8, T=700, S=1, Rq=126, Rv=126, int8=pool == "int8")
    dtype = torch.float32 if pool == "int8" else getattr(torch, pool)
    q, k, v, pos, kw = _ragged_inputs(case, cuda_device, dtype, seed=3)
    got = ragged_gqa_attend(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    want = ragged_gqa_attend_reference(q, k, v, pos, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCE[str(dtype).split(".")[1]])


_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=512,
             rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True, rope_scaling=None)
TINY_CONFIGS = {
    # alternating sliding (8) and full layers, caps that bite at this scale
    "gemma2": dict(_TINY, model_type="gemma2", hidden_activation="gelu_pytorch_tanh", sliding_window=8,
                   query_pre_attn_scalar=24, attn_logit_softcapping=3.0, final_logit_softcapping=30.0),
    "olmo2": dict(_TINY, model_type="olmo2", hidden_act="silu", tie_word_embeddings=False),
}


@pytest.mark.parametrize("arch", sorted(TINY_CONFIGS))
def test_tiny_model_served_on_the_card(cuda_device, arch):
    """A tiny gemma2 (K3 with the soft cap, alternating windows; no K1)
    and olmo2 (the flat q/k norm; K1): the forward on the card against the
    CPU, and greedy serving through K3 token for token against the plain
    cache attention."""
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    spec = spec_from_hf_config(SimpleNamespace(**TINY_CONFIGS[arch]))
    cpu = init_params(spec, torch.Generator().manual_seed(0), scale=0.2, device="cpu")
    card = _tree_to(cpu, cuda_device)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 160)))
    before = flash_attention.launches
    got, _ = forward(spec, card, ids.to(cuda_device))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + (0 if spec.attn_logit_softcap else spec.n_layers)
    want, _ = forward(spec, cpu, ids)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    pm = pad_to_uniform(spec, card)
    prompts = [np.random.default_rng(n).integers(1, 256, n) for n in (5, 40, 17)]
    served = {}
    for attn in ("ragged", "xla"):
        b = ContinuousBatcher(pm, slots=2, max_len=96, prefill_bucket=16, decode_attn=attn)
        rids = [b.submit(p, max_new_tokens=8) for p in prompts]
        before = ragged_gqa_attend.launches
        done = b.run()
        assert (ragged_gqa_attend.launches > before) == (attn == "ragged")
        served[attn] = [list(map(int, done[r])) for r in rids]
    assert served["ragged"] == served["xla"]


@pytest.mark.parametrize("moe", ["dense", "dispatch"])
def test_moe_forward_on_the_card_matches_the_cpu(cuda_device, moe):
    """A tiny qwen2_moe-shaped model (a mixed stack: shared expert, a dense
    middle layer) on the card against the same weights on the CPU: the
    unrolled forward through K1, and the padded stack with dense or
    dispatched experts."""
    from modegpt_tpu_torch.models.padded import forward_padded, pad_to_uniform

    cfg = SimpleNamespace(
        model_type="qwen2_moe", vocab_size=256, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=48, shared_expert_intermediate_size=80, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, rms_norm_eps=1e-6,
        rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False, num_experts=8,
        num_experts_per_tok=2, norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[1],
        rope_scaling=None,
    )
    spec = spec_from_hf_config(cfg)
    cpu = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    card = _tree_to(cpu, cuda_device)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 160)))
    before = flash_attention.launches
    got, _ = forward(spec, card, ids.to(cuda_device))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + spec.n_layers
    want, _ = forward(spec, cpu, ids)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    pm, pm_cpu = pad_to_uniform(spec, card), pad_to_uniform(spec, cpu)
    cap = spec.n_experts / spec.experts_per_tok
    lp = forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, ids.to(cuda_device), moe=moe, moe_capacity=cap)
    lc = forward_padded(pm_cpu.spec, pm_cpu.layers, pm_cpu.other, pm_cpu.q_hd_true, ids, moe=moe, moe_capacity=cap)
    torch.testing.assert_close(lp.cpu(), lc, rtol=1e-4, atol=1e-4)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


# ---- quantised products (torch._int_mm and the dequantised copy) ----

QUANT_MOE = SimpleNamespace(
    model_type="qwen2_moe", vocab_size=256, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=50, shared_expert_intermediate_size=80, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, rms_norm_eps=1e-6,
    rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False, num_experts=8,
    num_experts_per_tok=2, norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[],
    rope_scaling=None,
)


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("form", ["int8", "int4"])
def test_weight_only_linear_on_the_card_matches_the_cpu(cuda_device, form):
    """Weight-only ``_linear`` (the codes converted to the activation's
    dtype, the scale on the output) at unaligned widths, int8 codes and
    packed int4, with a bias."""
    from modegpt_tpu_torch.models.forward import _linear, pack_int4
    from modegpt_tpu_torch.models.quantize import quantize_linear

    p = quantize_linear({"kernel": _normal((126, 250), 0), "bias": _normal((250,), 1)})
    if form == "int4":
        p = dict(p, kernel_q=pack_int4(torch.clamp(p["kernel_q"], -7, 7)))
    x = _normal((3, 7, 126), 2)
    got = _linear(x.to(cuda_device), {k: v.to(cuda_device) for k, v in p.items()})
    torch.testing.assert_close(got.cpu(), _linear(x, p), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mkn", [(24, 64, 56), (48, 56, 80), (130, 56, 32), (130, 64, 400), (1, 126, 250),
                                 (8, 4096, 1008)], ids=str)
def test_int_mm_takes_every_shape(cuda_device, mkn):
    """Shapes the card's ``torch._int_mm`` refuses with a row-major
    weight (M = 24 and 48 at K = 56/64, M = 130 at K = 56/64) or at all
    (M < 17, K or N not a multiple of 8): exact all the same."""
    from modegpt_tpu_torch.models.forward import _int_mm

    M, K, N = mkn
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8)) for s in ((M, K), (K, N)))
    got = _int_mm(a.to(cuda_device), b.to(cuda_device))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), a.int() @ b.int())


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 130])
def test_w8a8_dot_on_the_card_is_exact(cuda_device, rows):
    """``_dot_w8a8`` at unaligned K = 126 and N = 250 and at row counts
    below the 17 that the card's ``torch._int_mm`` takes: codes, scales,
    the int32 accumulator and the rescaled output equal the CPU's bit for
    bit (zero padding adds exact zeros)."""
    from modegpt_tpu_torch.models.forward import _act_quant, _dot_w8a8, _int_mm
    from modegpt_tpu_torch.models.quantize import quantize_linear

    p = quantize_linear({"kernel": _normal((126, 250), 3)})
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    for name in ("kernel_q", "scale"):  # the quantiser on the card: the CPU's codes and scales
        assert torch.equal(quantize_linear({"kernel": _normal((126, 250), 3).to(cuda_device)})[name].cpu(), p[name])
    x = _normal((rows, 126), 4)
    xq, xs = _act_quant(x)
    gq, gs = _act_quant(x.to(cuda_device))
    assert torch.equal(gq.cpu(), xq) and torch.equal(gs.cpu(), xs)
    acc = _int_mm(gq, pc["kernel_q"])
    assert acc.dtype == torch.int32 and acc.shape == (rows, 250)
    assert torch.equal(acc.cpu(), xq.int() @ p["kernel_q"].int())
    assert torch.equal(_dot_w8a8(x.to(cuda_device), pc["kernel_q"], pc["scale"]).cpu(),
                       _dot_w8a8(x, p["kernel_q"], p["scale"]))


@pytest.mark.parametrize("moe", ["dense", "dispatch"])
def test_w8a8_moe_on_the_card_matches_the_cpu(cuda_device, moe):
    """The W8A8 view of a quantised MoE layer (expert width 50: unaligned)
    through the all-experts form (one int8 GEMM over the (expert, column)
    axis for gate and up, the down products expert by expert) and through
    dispatch (one int8 GEMM per expert), against the CPU."""
    from modegpt_tpu_torch.models.forward import _moe_mlp, _moe_mlp_dispatch
    from modegpt_tpu_torch.models.quantize import quantize_params, with_act_quant

    spec = spec_from_hf_config(QUANT_MOE)
    cpu = with_act_quant(quantize_params(init_params(spec, torch.Generator().manual_seed(5), scale=0.1,
                                                     device="cpu")))["layers"][0]
    assert "kernel_qa" in cpu["experts"]["down"] and "kernel_qa" in cpu["shared"]["up"]
    card = _tree_to(cpu, cuda_device)
    x = _normal((2, 12, 64), 6)
    if moe == "dense":
        got, want = _moe_mlp(spec, card, x.to(cuda_device), False)[0], _moe_mlp(spec, cpu, x, False)[0]
    else:
        cap = spec.n_experts / spec.experts_per_tok
        got, want = _moe_mlp_dispatch(spec, card, x.to(cuda_device), cap), _moe_mlp_dispatch(spec, cpu, x, cap)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def _nf4_numpy(a):
    """The one-shot NF4 quantiser in numpy, as the JAX package writes it
    (modegpt_tpu/compress/artifact.py::_quantize_nf4)."""
    from modegpt_tpu_torch.compress.artifact import _NF4_BLOCK, _NF4_CODE

    flat = a.reshape(-1)
    pad = (-flat.size) % _NF4_BLOCK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, _NF4_BLOCK)
    absmax = np.max(np.abs(blocks), axis=1, keepdims=True)
    absmax = np.where(absmax == 0.0, 1.0, absmax)
    codes = np.argmin(np.abs((blocks / absmax)[..., None] - _NF4_CODE), axis=-1).astype(np.uint8)
    flat = codes.reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    return (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8), absmax.reshape(-1).astype(np.float32)


def test_artifact_quantisers_on_the_card_match_numpy(cuda_device):
    """The artifact's quantisers on the card: NF4 in chunks of blocks
    against the one-shot numpy form, int8 and int4 against the CPU's, all
    byte for byte."""
    from modegpt_tpu_torch.compress import artifact

    from modegpt_tpu_torch.compress.artifact import _NF4_CODE

    a = _normal((3, 257, 130), 7).numpy()
    a[0, :, :5] = 0.0
    block = a.reshape(-1)[640:704]  # one 64-value block, a view
    block[:] = 0.0
    block[:15] = (_NF4_CODE[:-1] + _NF4_CODE[1:]) / 2  # exact ties between two levels ...
    block[15] = 1.0  # ... at a max-abs of 1
    card = torch.from_numpy(a).to(cuda_device)
    packed, scale, shape = artifact._quantize_nf4(card, chunk_blocks=100)
    want_packed, want_scale = _nf4_numpy(a)
    np.testing.assert_array_equal(packed.cpu().numpy(), want_packed)
    np.testing.assert_array_equal(scale.cpu().numpy(), want_scale)
    assert shape == a.shape
    for fn in (artifact._quantize_int8, artifact._quantize_int4):
        for got, want in zip(fn(card), fn(torch.from_numpy(a))):
            if isinstance(got, torch.Tensor):
                assert torch.equal(got.cpu(), want), fn.__name__


# ---- the streamed sweep's staging and a streamed job on the card ----


def _host_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "q": {"kernel": torch.randn(64, 96, generator=g)},
        "down": {"kernel": torch.randn(200, 64, generator=g).to(torch.bfloat16)},
        "norm": {"scale": torch.randn(64, generator=g)},
        "odd": {"kernel": torch.randn(3, 5, 7, generator=g)},
    }


def test_pinned_staging_arrives_bit_equal(cuda_device):
    """Host leaves staged through the pinned buffers and the copy stream
    arrive on the card bit for bit, buffer reuse included; device leaves
    pass through untouched."""
    from modegpt_tpu_torch.compress import offload

    stager = offload._PinnedStager(cuda_device, stats := {})
    resident = torch.ones(8, device=cuda_device)
    for seed in range(3):  # the third call reuses the first call's buffer
        tree = {**_host_tree(seed), "resident": resident}
        got = offload._ready(stager(tree), cuda_device)
        torch.cuda.synchronize()
        assert got["resident"] is resident
        for name in ("q", "down", "norm", "odd"):
            leaf = next(iter(tree[name].values()))
            out = next(iter(got[name].values()))
            assert out.is_cuda and out.dtype == leaf.dtype and out.shape == leaf.shape
            assert torch.equal(out.cpu(), leaf), name
    per_call = sum(t.numel() * t.element_size() for t in offload._leaves(_host_tree()))
    assert stats["staged_bytes"] == 3 * per_call


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_staging_dequantised_on_the_card_equals_the_cpu(cuda_device, dtype):
    from modegpt_tpu_torch.compress import offload

    tree = _host_tree(1)
    kinds, payload = offload._quantize_host_tree(tree, dtype)
    want = offload._dequant_staged(kinds, payload)
    got, _ = offload._stage_quantized(tree, dtype, offload._PinnedStager(cuda_device, None))
    for a, b in zip(offload._leaves(got), offload._leaves(want)):
        assert a.is_cuda and torch.equal(a.cpu(), b)


def test_streamed_job_on_the_card_equals_the_chunked_job(cuda_device):
    """A tiny host-staged streamed job on the card (T = 128, so K1 runs)
    gives the chunked job's ranks and factors, with K1 launched in its
    forwards."""
    import copy
    import tempfile

    from modegpt_tpu_torch.calib.data import load_calibration_batches
    from modegpt_tpu_torch.calib.engine import calibrate
    from modegpt_tpu_torch.compress.batched import solve_chunk_batched
    from modegpt_tpu_torch.compress.offload import _tree_map, stream_calibrate_solve
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.ops.allocation import allocate_keep_ratios

    spec = spec_from_hf_config(SimpleNamespace(
        model_type="qwen3", vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, max_position_embeddings=256,
        rms_norm_eps=1e-6, rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False,
    ))
    host = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    batches = load_calibration_batches(None, "synthetic", 4, 2, 128, vocab_size=spec.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        config = CompressionConfig(device="cuda", solver_precision="f32_device", layers_per_step=1,
                                   compression_ratio=0.3, sparsity_smoothing=0.5, bi_stage_dtype="bf16",
                                   temp_storage_dir=tmp)
        fa_mod.flash_attention.launches = 0
        stats = {}
        factors, bi, keep = stream_calibrate_solve(spec, copy.deepcopy(host), batches, config, stats_out=stats)
        assert fa_mod.flash_attention.launches == 2 * spec.n_layers * len(batches)
    assert stats["staged_bytes"] > 0 and stats["async_flush"] is True
    card = _tree_map(lambda t: t.to(cuda_device), host)
    calib = calibrate(spec, card, batches, list(range(spec.n_layers)), accumulate="device")
    want_keep, _ = allocate_keep_ratios(calib.bi_scores, 0.3, 0.5, 0.8)
    np.testing.assert_allclose(bi, calib.bi_scores, rtol=1e-5)
    want = solve_chunk_batched(spec, card, list(range(spec.n_layers)), want_keep, calib, config, "mlp,qk,vo")
    for s in want:
        for l in want[s]:
            for k, v in want[s][l].items():
                if k in ("idx", "rotary_mask"):
                    np.testing.assert_array_equal(factors[s][l][k], v, err_msg=f"{s}[{l}][{k}]")
                else:
                    np.testing.assert_allclose(factors[s][l][k], v, rtol=2e-3, atol=2e-4, err_msg=f"{s}[{l}][{k}]")


# knob rows (temperature, top_k, top_p, min_p, repetition, presence,
# frequency): greedy, each filter, all together, and degenerate knobs
SAMPLING_ROWS = np.asarray([
    [0.0, 0, 1.0, 0.0, 1.0, 0.0, 0.0],
    [0.7, 10, 1.0, 0.0, 1.0, 0.0, 0.0],
    [1.0, 0, 0.9, 0.0, 1.0, 0.0, 0.0],
    [1.3, 0, 1.0, 0.05, 1.0, 0.0, 0.0],
    [0.8, 20, 0.95, 0.02, 1.2, 0.4, 0.3],
    [0.0, 0, 1.0, 0.0, 2.0, 1.1, 0.6],
    [1.0, 0, 0.0, 0.0, 1.0, 0.0, 0.0],
    [1.0, 0, 1.0, 5.0, 1.0, 0.0, 0.0],
], np.float32)


@pytest.mark.parametrize("V", [97, 128256])
def test_sample_rows_on_the_card_matches_the_cpu(cuda_device, V):
    """Penalised logits, greedy tokens and each row's kept set under its
    filters are the CPU's on the same inputs, at a small vocabulary and
    at Llama-3's; sampled tokens lie in their kept set."""
    from modegpt_tpu_torch.models.generate import filter_rows, penalize_rows, sample_rows

    rng = np.random.default_rng(0)
    S = SAMPLING_ROWS.shape[0]
    logits = torch.from_numpy((rng.standard_normal((S, V)) * 3.0).astype(np.float32))
    presence = torch.from_numpy(rng.random((S, V)) < 0.1)
    counts = torch.from_numpy((rng.integers(0, 3, (S, V)) * (rng.random((S, V)) < 0.1)).astype(np.int32))
    on = [t.to(cuda_device) for t in (logits, presence, counts)]
    scale = torch.clamp(torch.from_numpy(SAMPLING_ROWS[:, :1]), min=1e-6)
    cpu = penalize_rows(logits, SAMPLING_ROWS, presence, counts)
    gpu = penalize_rows(*on[:1], SAMPLING_ROWS, *on[1:])
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-6, atol=1e-6)
    kept_cpu = torch.isfinite(filter_rows(cpu / scale, SAMPLING_ROWS))
    final_gpu = filter_rows(gpu / scale.to(cuda_device), SAMPLING_ROWS)
    assert torch.equal(torch.isfinite(final_gpu).cpu(), kept_cpu)
    greedy = SAMPLING_ROWS[:, 0] == 0.0
    seeds = torch.arange(S, dtype=torch.int64) + 3
    toks = sample_rows(*on[:1], SAMPLING_ROWS, None, *on[1:], seeds=seeds.to(cuda_device),
                       counts=torch.zeros(S, dtype=torch.int64, device=cuda_device)).cpu()
    ref = sample_rows(logits, SAMPLING_ROWS, None, presence, counts, seeds=seeds,
                      counts=torch.zeros(S, dtype=torch.int64))
    assert torch.equal(toks[greedy], ref[greedy])
    assert bool(kept_cpu[torch.arange(S), toks].all())


def test_seeded_stream_on_the_card_is_the_same_alone_batched_fused_and_mixed(cuda_device):
    """A seeded request's sampled tokens on the card are the same alone,
    beside other traffic, with steps_per_dispatch=4 and under batched
    prefill with mixed rounds, all through K3; another seed changes
    them."""
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    spec, params = _tiny_llama_on(cuda_device)
    pm = pad_to_uniform(spec, params)
    rng = np.random.default_rng(11)
    prompt, other = rng.integers(1, 256, 19), rng.integers(1, 256, 33)
    knobs = dict(temperature=0.9, top_k=40, top_p=0.95, min_p=0.01, repetition_penalty=1.1, frequency_penalty=0.2)

    def run(seed, traffic, **kw):
        b = ContinuousBatcher(pm, slots=3, max_len=96, prefill_bucket=16, per_request_sampling=True,
                              decode_attn="ragged", **kw)
        for t in traffic:
            b.submit(other, 12, temperature=t)
        rid = b.submit(prompt, 12, seed=seed, **knobs)
        b.submit(other, 5, temperature=0.7, seed=99)
        return b.run(max_steps=2000)[rid]

    alone = run(7, [])
    assert len(alone) == 19 + 12
    assert run(7, [0.0, 1.2]) == alone
    assert run(7, [0.8], steps_per_dispatch=4) == alone
    assert run(7, [0.0], prefill_exec="batched") == alone
    assert run(7, [1.0, 0.0], prefill_exec="batched", steps_per_dispatch=4) == alone
    assert run(8, []) != alone


# ---- the whitened-SVD Q/K solve and streaming generation ----


def test_svd_qk_solve_on_the_card_matches_the_cpu_f64(cuda_device):
    """`compress_qk_layer_svd` in float32 on the card (cuSOLVER) against
    the same solve in float64 on the CPU: each head's bilinear form
    Q_h^T K_h (free of the SVD's per-pair signs) within 1e-3 relative,
    and the bias cross-terms b_q'^T K_h within 1e-3 relative."""
    from modegpt_tpu_torch.ops.qk import compress_qk_layer_svd

    H, hd, d, r = 4, 32, 128, 12
    rng = np.random.default_rng(5)
    X = rng.standard_normal((4 * d, d)) * rng.uniform(0.3, 2.0, d)
    host = [X.T @ X / X.shape[0], rng.standard_normal((H * hd, d)) / 8, rng.standard_normal((H * hd, d)) / 8,
            rng.standard_normal(H * hd) / 8, rng.standard_normal(H * hd) / 8]
    want = compress_qk_layer_svd(*(torch.from_numpy(a) for a in host), r, 1e-6, H)
    got = compress_qk_layer_svd(*(torch.from_numpy(a).float().to(cuda_device) for a in host), r, 1e-6, H)
    assert got.q.device.type == "cuda" and got.q.dtype == torch.float32

    def heads(t):
        return t.detach().cpu().double().reshape(H, r, -1)

    gq, gk, wq, wk = heads(got.q), heads(got.k), heads(want.q), heads(want.k)
    gb, wb = got.q_bias.cpu().double().reshape(H, 1, r), want.q_bias.reshape(H, 1, r)
    for h in range(H):
        form_g, form_w = gq[h].T @ gk[h], wq[h].T @ wk[h]
        assert float((form_g - form_w).abs().max() / form_w.abs().max()) < 1e-3
        cross_g, cross_w = gb[h] @ gk[h], wb[h] @ wk[h]
        assert float((cross_g - cross_w).abs().max() / cross_w.abs().max()) < 1e-3


def test_svd_qk_solve_on_the_card_layer_normed_gram(cuda_device):
    """The same float32 solve on the card on a layer norm's Gram (pre-LN
    OPT: one direction of almost no energy, which a float32 eigh can put
    below minus the ridge) stays within 1e-3 of the CPU's float64 solve
    (each head's Q_h^T K_h)."""
    from modegpt_tpu_torch.ops.qk import compress_qk_layer_svd

    H, hd, d, r, ridge = 4, 32, 256, 12, 1e-8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4 * d, d)) * rng.uniform(0.5, 2.0, d)
    x -= x.mean(1, keepdims=True)
    x /= np.sqrt((x**2).mean(1, keepdims=True))
    g, b = 1 + 0.02 * rng.standard_normal(d), 0.02 * rng.standard_normal(d)
    x = x * g + b - g * (b / g).sum() / d
    host = [(x.T @ x / x.shape[0]).astype(np.float32), rng.standard_normal((H * hd, d)) / 8,
            rng.standard_normal((H * hd, d)) / 8, rng.standard_normal(H * hd) / 8, rng.standard_normal(H * hd) / 8]
    want = compress_qk_layer_svd(*(torch.from_numpy(a).double() for a in host), r, ridge, H)
    got = compress_qk_layer_svd(*(torch.from_numpy(a).float().to(cuda_device) for a in host), r, ridge, H)
    forms = [f.q.detach().cpu().double().reshape(H, r, d).transpose(1, 2) @ f.k.detach().cpu().double().reshape(H, r, d)
             for f in (got, want)]
    assert float((forms[0] - forms[1]).abs().max() / forms[1].abs().max()) < 1e-3


def test_streaming_step_on_the_card_matches_the_cpu(cuda_device):
    """`streaming_generate` of a tiny llama on the card against the same
    weights on the CPU: equal tokens beyond the window (evictions
    included) and every step's logits within 1e-4."""
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.streaming import streaming_generate

    spec, card = _tiny_llama_on(cuda_device)
    cpu = _tree_to(card, "cpu")
    ids = np.random.default_rng(6).integers(1, 256, (2, 20))
    logits = {}
    tokens = {}
    for name, tree in (("card", card), ("cpu", cpu)):
        seen = logits.setdefault(name, [])
        tokens[name] = streaming_generate(pad_to_uniform(spec, tree), ids, max_new_tokens=28, window=16, n_sink=2,
                                          on_step=lambda g, lg, seen=seen: seen.append(lg.cpu()))
    np.testing.assert_array_equal(tokens["card"], tokens["cpu"])
    assert len(logits["card"]) == 20 + 27
    for a, b in zip(logits["card"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_ranks_sharing_the_card_match_one_rank(cuda_device, tmp_path):
    """2 ranks on the one card over gloo (asked for explicitly: NCCL
    takes one rank a card): a data:2 calibrate and a model:2 forward
    (K1 on each rank's heads, T = 160), each against this process's
    single-rank result on the card."""
    import os
    import sys

    from modegpt_tpu_torch.calib.engine import calibrate

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_parallel_ranks import Launch

    spec, params = _tiny_llama_on(cuda_device)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (2, 160)).astype(np.int32) for _ in range(2)]
    ids = rng.integers(0, 256, (2, 160)).astype(np.int32)
    host = _tree_to(params, "cpu")
    cases = {
        "calibrate": dict(kind="calibrate", mesh="data:2", spec=spec, params=host, batches=batches, targets=[0, 1]),
        "forward": dict(kind="forward", mesh="model:2", spec=spec, params=host, ids=ids, attn_impl="auto"),
    }
    torch.save(cases, tmp_path / "inputs.pt")
    ranks = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_parallel_ranks.py")
    outs = Launch(2, tmp_path, [ranks, str(tmp_path), "cuda"], name="card").outputs()

    want = calibrate(spec, params, batches, [0, 1])
    logits, _ = forward(spec, params, torch.as_tensor(ids, device=cuda_device))
    for out in outs:
        got = out["calibrate"]
        for field in ("cov_mlp", "cov_q", "cov_k", "cov_x"):
            for l in (0, 1):
                np.testing.assert_allclose(got[field][l], getattr(want, field)[l].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["bi"], want.bi_scores, rtol=1e-5)
        np.testing.assert_allclose(out["forward"]["logits"], logits.cpu().double().numpy(), rtol=2e-4, atol=2e-4)


def test_tp_serving_ranks_run_k3_on_their_heads(cuda_device, tmp_path):
    """The batcher on model:2, 2 ranks sharing the card over gloo, each
    through K3 on its 2 of 4 heads over 1 of 2 kv heads (batched prefill,
    fused decode): the tokens of this process's one-rank batcher on the
    card, and K3 launched on each rank."""
    import os
    import sys

    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_parallel_ranks import Launch

    spec, params = _tiny_llama_on(cuda_device)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, n) for n in (5, 19, 11)]
    kw = dict(slots=2, max_len=64, prefill_bucket=8, prefill_exec="batched", steps_per_dispatch=3,
              decode_attn="auto")
    host = pad_to_uniform(spec, _tree_to(params, "cpu"))
    torch.save({"serve": dict(kind="serve", mesh="data:1,model:2", pm=host, kw=kw, prompts=prompts,
                              budgets=[8] * 3)}, tmp_path / "inputs.pt")
    ranks = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_tp_serving_ranks.py")
    outs = Launch(2, tmp_path, [ranks, str(tmp_path), "cuda"], name="tp_card").outputs()
    b = ContinuousBatcher(pad_to_uniform(spec, params), **kw)
    rids = [b.submit(p, max_new_tokens=8) for p in prompts]
    done = b.run()
    for out in outs:
        assert out["serve"]["tokens"] == [list(map(int, done[r])) for r in rids]
        assert out["serve"]["pool_heads"] == spec.n_kv_heads // 2 and out["serve"]["k3_launches"] > 0


def _tiny_checkpoint(path):
    """A tiny llama HF checkpoint with a word-piece tokenizer saved beside
    it (ids below the model's 128), as the CLIs load it."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(path)
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(["the quick brown fox jumps over the lazy dog", "user says hello world again"],
                            trainers.BpeTrainer(vocab_size=100, special_tokens=["<unk>", "<s>", "</s>"]))
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
                                         pad_token="</s>").save_pretrained(path)
    return str(path)


CLI_PROMPTS = ["the quick brown fox", "user says hello world again and the lazy dog", "over the"]
SERVE_FLAG_SETS = {
    "batched_fused_prefix": ["--prefill_exec", "batched", "--steps_per_dispatch", "4", "--prefix_cache"],
    "int8_w8a8_kv8": ["--quantize_int8", "--a8_prefill", "--kv_dtype", "int8"],
}


@pytest.mark.parametrize("flags", sorted(SERVE_FLAG_SETS))
def test_serve_cli_on_the_card_equals_the_cpu(cuda_device, tmp_path, flags):
    """`serve.main` on the card (K3 on every dispatch) returns the tokens
    of the same call with --device cpu."""
    from modegpt_tpu_torch import serve
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend

    ckpt = _tiny_checkpoint(tmp_path)
    argv = ["--model", ckpt, *(a for p in CLI_PROMPTS for a in ("--prompt", p)), "--max_new_tokens", "12",
            "--slots", "2", "--max_len", "64", "--prefill_bucket", "8", *SERVE_FLAG_SETS[flags]]
    before = ragged_gqa_attend.launches
    card = serve.main(argv + ["--device", "cuda"])
    assert ragged_gqa_attend.launches > before
    assert card == serve.main(argv + ["--device", "cpu"])


def test_eval_cli_prompt_lookup_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """`evals.cli.main --generate --prompt_lookup` on the card (K3 on the
    padded stack) prints the text of the same call with --device cpu."""
    from modegpt_tpu_torch.evals import cli
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend

    ckpt = _tiny_checkpoint(tmp_path)
    argv = ["--model", ckpt, "--generate", "the quick brown fox the quick brown fox the quick", "--prompt_lookup",
            "--max_new_tokens", "16"]
    before = ragged_gqa_attend.launches
    card = cli.main(argv + ["--device", "cuda"])
    assert ragged_gqa_attend.launches > before
    cpu = cli.main(argv + ["--device", "cpu"])
    assert card["generation"] == cpu["generation"] and card["prompt_lookup"] == cpu["prompt_lookup"]


ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_orbax_llama")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert (x is None) == (y is None), path
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_orbax_round_trip_on_the_card(cuda_device, tmp_path, dtype):
    """An orbax artifact saved from the card reloads on it bit for bit,
    and equals its reload on the CPU."""
    from modegpt_tpu_torch.compress.artifact import load_compressed_model, save_compressed_model

    spec, params = _tiny_llama_on(cuda_device)
    d = str(tmp_path / "orbax")
    save_compressed_model(d, spec, params, "tok", dtype=dtype, backend="orbax")
    s2, card, tok = load_compressed_model(d, device="cuda")
    assert s2 == spec and tok == "tok"
    assert card["layers"][0]["q"]["kernel"].is_cuda
    want = getattr(torch, dtype)
    _same_leaves(card, _cast_floats(params, want))
    _same_leaves(card, load_compressed_model(d, device="cpu")[1])


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree is not None and tree.is_floating_point() else tree


@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_jax_written_orbax_fixture_on_the_card(cuda_device, variant):
    """The committed JAX-written artifact (zstd chunks) loads on the card
    equal to its npz twin: the hand-written decoder on the card's host."""
    from modegpt_tpu_torch.compress.artifact import load_compressed_model

    spec, got, _ = load_compressed_model(os.path.join(ORBAX_FIXTURE, variant), device="cuda")
    twin_spec, twin, _ = load_compressed_model(os.path.join(ORBAX_FIXTURE, "npz"), device="cuda")
    assert spec == twin_spec and got["layers"][0]["q"]["kernel"].is_cuda
    _same_leaves(got, _cast_floats(twin, torch.float32 if variant == "f32" else torch.bfloat16))


# ---- the whole-table decode dispatch as a CUDA graph (models.padded.DecodeGraph) ----


def _tiny_qwen3(device):
    """A tiny compressed Qwen3: per-head q/k norm, a rotary mask of kept
    RoPE pairs a kv head, and ranks that differ by layer (so the stack is
    padded), weights on ``device``."""
    from modegpt_tpu_torch.models.padded import pad_to_uniform

    spec = spec_from_hf_config(SimpleNamespace(
        model_type="qwen3", vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=512,
        rms_norm_eps=1e-6, rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False,
        attention_bias=False, rope_scaling=None,
    ))
    H, Hk, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    rq, rv, rm = (12, 16, 8), (16, 12, 16), (96, 70, 50)
    spec = spec.with_ranks(q_ranks=[H * r for r in rq], k_ranks=[Hk * r for r in rq], v_ranks=[Hk * r for r in rv],
                           o_ranks=[H * r for r in rv], gate_ranks=list(rm), has_rotary_masks=True)
    params = init_params(spec, torch.Generator().manual_seed(0), scale=0.2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for lp, r in zip(params["layers"], rq):
        pairs = torch.rand((Hk, hd // 2), generator=gen).argsort(dim=-1)[:, : r // 2]
        lp["rotary_mask"] = torch.cat([pairs, pairs + hd // 2], dim=-1).to(torch.int32)
    return pad_to_uniform(spec, _tree_to(params, device))


def _graph_counts():
    from modegpt_tpu_torch.models.padded import DecodeGraph

    return np.array([DecodeGraph.captures, DecodeGraph.replays, DecodeGraph.eager])


def _pools_of(state):
    return [p for p in (state.cache_k, state.cache_v, state.k_scale, state.v_scale) if p is not None]


def _graphed_and_eager(pm, slots, max_len, kv_dtype="model"):
    """Two empty slot tables: one with its decode graph, one without."""
    from modegpt_tpu_torch.models.serving import init_serve_state

    graphed = init_serve_state(pm, slots, max_len, kv_dtype=kv_dtype)
    return graphed, init_serve_state(pm, slots, max_len, kv_dtype=kv_dtype)._replace(graph=None)


def _prefill_both(pm, states, slot, piece):
    from modegpt_tpu_torch.models.serving import _prefill_chunk

    for st in states:
        _prefill_chunk(pm, st, slot, piece, 0, 32, True, 0.0, None, decode_attn="ragged")


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_decode_graph_replays_the_eager_dispatch_bit_for_bit(cuda_device, kv_dtype):
    """20 whole-table decode dispatches over 8 slots whose lengths change
    (rows advance or stall, a slot restarts with a new prompt): the
    replayed logits and the pools equal the op-by-op dispatch's bit for
    bit, the graph is captured once, and every dispatch, the capturing
    one and each replay, adds one K3 launch a layer."""
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend
    from modegpt_tpu_torch.models.serving import _step

    pm = _tiny_qwen3(cuda_device)
    L = pm.spec.n_layers
    graphed, eager = _graphed_and_eager(pm, 8, 64, kv_dtype)
    rng = np.random.default_rng(3)
    for s in range(8):
        _prefill_both(pm, (graphed, eager), s, rng.integers(0, 256, int(rng.integers(1, 20))))
    counts = _graph_counts()
    for i in range(20):
        if i % 7 == 3:
            _prefill_both(pm, (graphed, eager), int(rng.integers(8)), rng.integers(0, 256, int(rng.integers(1, 20))))
        before = ragged_gqa_attend.launches
        got = _step(pm, graphed, graphed.last_token[:, None], graphed.lengths, decode_attn="ragged").clone()
        assert ragged_gqa_attend.launches - before == L
        want = _step(pm, eager, eager.last_token[:, None], eager.lengths, decode_attn="ragged")
        assert torch.equal(got, want), f"dispatch {i}"
        active = rng.random(8) < 0.7
        nxt = torch.argmax(got[:, -1], dim=-1)
        for st in (graphed, eager):
            st.last_token.copy_(torch.where(torch.from_numpy(active).to(cuda_device), nxt, st.last_token))
            st.lengths[active] += 1
    torch.cuda.synchronize()
    assert (_graph_counts() - counts).tolist() == [1, 19, 1]
    for a, b in zip(_pools_of(graphed), _pools_of(eager)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_batcher_with_the_decode_graph_serves_the_eager_tokens(cuda_device, kv_dtype):
    """A tiny Qwen3 batcher on 8 slots, 20 steps of greedy and seeded
    sampled requests of changing lengths: every step's tokens equal those
    of the same batcher without its decode graph, and its decode
    dispatches replay."""
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    pm = _tiny_qwen3(cuda_device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, int(n)) for n in rng.integers(3, 40, 12)]
    budgets = [int(n) for n in rng.integers(2, 12, 12)]
    served, replays = {}, {}
    for name in ("graph", "eager"):
        b = ContinuousBatcher(pm, slots=8, max_len=96, prefill_bucket=16, decode_attn="ragged",
                              per_request_sampling=True, kv_dtype=kv_dtype)
        if name == "eager":
            b.state = b.state._replace(graph=None)
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            b.submit(p, max_new_tokens=n, **({} if i % 2 == 0 else dict(temperature=0.7, top_p=0.9, seed=i)))
        counts = _graph_counts()
        steps = []
        for _ in range(20):
            b.step(torch.Generator(device=cuda_device).manual_seed(0))
            steps.append([list(map(int, out)) for out in b.slot_out])
        served[name], replays[name] = steps, (_graph_counts() - counts)[1]
    assert served["graph"] == served["eager"]
    assert replays["graph"] >= 10 and replays["eager"] == 0


def test_decode_graph_row_at_the_pools_end_runs_eager(cuda_device):
    """A whole-table decode with a row at the pool's end runs op by op
    (its write is dropped on the host) and leaves the pool as the eager
    path does; with the row back inside the pool the graph replays
    again, not captured anew."""
    from modegpt_tpu_torch.models.serving import _step

    pm = _tiny_qwen3(cuda_device)
    T = 32
    graphed, eager = _graphed_and_eager(pm, 4, T)
    rng = np.random.default_rng(5)
    for s, n in enumerate((5, 9, 3, 7)):
        _prefill_both(pm, (graphed, eager), s, rng.integers(0, 256, n))
    for row_len, counted in ((None, [1, 0, 1]), (T, [0, 0, 1]), (10, [0, 1, 0])):
        if row_len is not None:
            for st in (graphed, eager):
                st.lengths[1] = row_len
        counts = _graph_counts()
        got = _step(pm, graphed, graphed.last_token[:, None], graphed.lengths, decode_attn="ragged").clone()
        want = _step(pm, eager, eager.last_token[:, None], eager.lengths, decode_attn="ragged")
        torch.cuda.synchronize()
        assert (_graph_counts() - counts).tolist() == counted
        assert torch.equal(got, want)
        for a, b in zip(_pools_of(graphed), _pools_of(eager)):
            assert torch.equal(a, b)


_GRAPH_TINY = dict(_TINY, num_hidden_layers=2)
GRAPH_ARCHS = {
    "llama": dict(_GRAPH_TINY, model_type="llama", hidden_act="silu", tie_word_embeddings=False),
    "llama_int8_weights": dict(_GRAPH_TINY, model_type="llama", hidden_act="silu", tie_word_embeddings=False),
    "mistral": dict(_GRAPH_TINY, model_type="mistral", hidden_act="silu", sliding_window=8),
    "qwen2": dict(_GRAPH_TINY, model_type="qwen2", hidden_act="silu", use_sliding_window=False),
    "gemma": dict(_GRAPH_TINY, model_type="gemma", hidden_activation="gelu_pytorch_tanh"),
    "gemma2": dict(TINY_CONFIGS["gemma2"], num_hidden_layers=2),
    "olmo2": dict(TINY_CONFIGS["olmo2"], num_hidden_layers=2),
    "phi3": dict(_GRAPH_TINY, model_type="phi3", hidden_act="silu", sliding_window=8),
    "starcoder2": dict(_GRAPH_TINY, model_type="starcoder2", hidden_act="gelu_pytorch_tanh", use_bias=True,
                       sliding_window=8),
    "gpt2": dict(model_type="gpt2", vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_inner=None,
                 n_positions=128, activation_function="gelu_new", layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "opt_post_ln": dict(model_type="opt", vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        ffn_dim=128, max_position_embeddings=128, activation_function="relu",
                        do_layer_norm_before=False, tie_word_embeddings=True, enable_bias=True),
    "qwen2_moe_dense_experts": dict(vars(QUANT_MOE)),
}


@pytest.mark.parametrize("arch", sorted(GRAPH_ARCHS))
def test_decode_graph_for_every_arch(cuda_device, arch):
    """Every architecture's whole-table decode captures (no read back to
    the host inside the step: gemma's and gemma2's scalar factors are
    host constants) and replays the eager dispatch's logits and pools bit
    for bit; int8 weight-only and a dense-expert MoE stack too."""
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.quantize import quantize_padded
    from modegpt_tpu_torch.models.serving import _step

    spec = spec_from_hf_config(SimpleNamespace(**GRAPH_ARCHS[arch]))
    params = init_params(spec, torch.Generator().manual_seed(0), scale=0.2, device="cpu")
    pm = pad_to_uniform(spec, _tree_to(params, cuda_device))
    if arch.endswith("int8_weights"):
        pm = quantize_padded(pm)
    graphed, eager = _graphed_and_eager(pm, 4, 64)
    rng = np.random.default_rng(2)
    for s, n in enumerate((5, 12, 1, 30)):
        _prefill_both(pm, (graphed, eager), s, rng.integers(0, 256, n))
    counts = _graph_counts()
    for i in range(3):
        got = _step(pm, graphed, graphed.last_token[:, None], graphed.lengths, decode_attn="ragged").clone()
        want = _step(pm, eager, eager.last_token[:, None], eager.lengths, decode_attn="ragged")
        assert torch.equal(got, want), f"dispatch {i}"
        nxt = torch.argmax(got[:, -1], dim=-1)
        for st in (graphed, eager):
            st.last_token.copy_(nxt)
            st.lengths[:] += 1
    torch.cuda.synchronize()
    assert (_graph_counts() - counts).tolist() == [1, 2, 1]
    for a, b in zip(_pools_of(graphed), _pools_of(eager)):
        assert torch.equal(a, b)
