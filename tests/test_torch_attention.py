"""Parity: the port's flash attention against the JAX package's.

On the CPU the port's `flash_attention` computes its plain version
(`flash_attention_reference`); it is held to the Pallas kernel run in
interpret mode, as tests/test_models.py runs it, and to the JAX
forward's XLA attention. Tolerances are the JAX package's own kernel
tolerances: float32 rtol 2e-4 / atol 2e-5, bfloat16 2e-2.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them to the plain version there and skips elsewhere. What can be
checked here is the arithmetic the long-context kernel (K2) does on the
tensor cores for float32: each product split into TF32 parts, three
passes (`test_three_tf32_passes_keep_f32_accuracy`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from modegpt_tpu.models.forward import _attention as j_attention  # noqa: E402
from modegpt_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
)

CASES = {
    "gqa_T160_hd24": dict(B=2, H=4, Hk=2, T=160, hd=24, hd_v=24, window=None),
    "T300": dict(B=1, H=4, Hk=2, T=300, hd=32, hd_v=32, window=None),
    "window8": dict(B=1, H=4, Hk=2, T=256, hd=16, hd_v=16, window=8),
    "window100": dict(B=1, H=4, Hk=4, T=256, hd=16, hd_v=16, window=100),
    "hd44_hdv40": dict(B=1, H=4, Hk=2, T=192, hd=44, hd_v=40, window=None),
}
F32 = dict(rtol=2e-4, atol=2e-5)


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    B, H, Hk, T, hd, hd_v = (case[k] for k in ("B", "H", "Hk", "T", "hd", "hd_v"))
    return (
        rng.standard_normal((B, H, T, hd)).astype(np.float32),
        rng.standard_normal((B, Hk, T, hd)).astype(np.float32),
        rng.standard_normal((B, Hk, T, hd_v)).astype(np.float32),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel_and_xla(name):
    case = CASES[name]
    q, k, v = _inputs(case)
    scale = case["hd"] ** -0.5
    w = case["window"]
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale, window=w)
    assert got.shape == (case["B"], case["H"], case["T"], case["hd_v"]) and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = j_flash(jq, jk, jv, scale=scale, window=w, block_q=128, block_k=128)
    want_xla = j_attention(jq, jk, jv, scale, w, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **F32)


def test_bf16_matches_jax_kernel():
    case = dict(B=1, H=4, Hk=2, T=256, hd=32, hd_v=32, window=None)
    q, k, v = _inputs(case, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, scale=32**-0.5)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want = j_flash(jq, jk, jv, scale=32**-0.5, block_q=128, block_k=128)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2e-2, atol=2e-2
    )


def test_window_must_be_positive():
    q = torch.zeros(1, 1, 4, 2)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in float32 from TF32 parts: x = big + small, big = tf32(x),
    small = tf32(x - big). Three passes add big.big + big.small +
    small.big; one pass is big.big alone. A product of two TF32 values is
    exact in float32, so only the accumulation rounds, as on the tensor
    cores."""
    a_big, b_big = _tf32(a), _tf32(b)
    out = a_big @ b_big
    if passes == 3:
        out = out + a_big @ _tf32(b - b_big) + _tf32(a - a_big) @ b_big
    return out


def _split_attention(q, k, v, scale, window, passes):
    """Causal GQA attention with both products split into TF32 parts, the
    f32 route of csrc/flash_attention_hbm.cu: q scaled in float32, scores
    and the softmax in float32, the unnormalised probabilities times v,
    then divided by the row sums."""
    B, H, T, _ = q.shape
    G = H // k.shape[1]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = _split_matmul(q * scale, kr.transpose(-1, -2), passes)
    i = torch.arange(T)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _split_matmul(p, vr, passes) / p.sum(dim=-1, keepdim=True)


SPLIT_CASES = {
    "causal_T1024_hd128": dict(B=1, H=4, Hk=4, T=1024, hd=128, hd_v=128, window=None),
    "gqa_hd126": dict(B=1, H=4, Hk=2, T=384, hd=126, hd_v=126, window=None),
    "window100_hd88_hdv90": dict(B=1, H=4, Hk=2, T=300, hd=88, hd_v=90, window=100),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_three_tf32_passes_keep_f32_accuracy(name):
    """Three TF32 passes per product stay within the float32 tolerance of
    the plain attention; one pass does not. This is why the long-context
    kernel issues every float32 tensor-core product three times."""
    case = SPLIT_CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    scale, w = case["hd"] ** -0.5, case["window"]
    want = flash_attention_reference(q, k, v, scale=scale, window=w)
    three = _split_attention(q, k, v, scale, w, passes=3)
    one = _split_attention(q, k, v, scale, w, passes=1)
    torch.testing.assert_close(three, want, **F32)
    assert not torch.allclose(one, want, **F32)
    assert (one - want).abs().max() > 10 * (three - want).abs().max()
