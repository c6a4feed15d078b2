"""Parity: the port's flash attention against the JAX package's.

On the CPU the port's `flash_attention` computes its plain version
(`flash_attention_reference`); it is held to the Pallas kernel run in
interpret mode, as tests/test_models.py runs it, and to the JAX
forward's XLA attention. Tolerances are the JAX package's own kernel
tolerances: float32 rtol 2e-4 / atol 2e-5, bfloat16 2e-2.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py
holds it to the plain version there and skips elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from modegpt_tpu.models.forward import _attention as j_attention  # noqa: E402
from modegpt_tpu_torch.kernels.flash_attention import flash_attention  # noqa: E402

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
