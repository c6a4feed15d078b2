"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode): it
carries the ``cuda`` marker and skips without a card. The file imports
torch, numpy and the port only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are the JAX package's own kernel tolerances: float32 rtol
2e-4 / atol 2e-5, bfloat16 2e-2.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from modegpt_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
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
