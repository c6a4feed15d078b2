"""Parity: the port's allocation and Type-I/II/III solvers against JAX.

Same numpy inputs into both packages, float64 throughout. Selections
(indices, rotary masks, kept rows) must match exactly; re-solved factors
to rtol 1e-8. The V/O factors carry an SVD sign per basis vector that
LAPACK builds may choose differently, so the sign-free per-head product
``O_h @ V_kv`` is compared, and the factors themselves after pinning
each basis vector's sign.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.ops.allocation import allocate_keep_ratios as j_alloc  # noqa: E402
from modegpt_tpu.ops.mlp import nystrom_mlp as j_nystrom  # noqa: E402
from modegpt_tpu.ops.qk import compress_qk_layer_opt as j_qk_opt  # noqa: E402
from modegpt_tpu.ops.qk import compress_qk_layer_rope as j_qk_rope  # noqa: E402
from modegpt_tpu.ops.vo import compress_vo_layer as j_vo  # noqa: E402
from modegpt_tpu_torch.ops.allocation import allocate_keep_ratios as t_alloc  # noqa: E402
from modegpt_tpu_torch.ops.mlp import nystrom_mlp as t_nystrom  # noqa: E402
from modegpt_tpu_torch.ops.qk import compress_qk_layer_opt as t_qk_opt  # noqa: E402
from modegpt_tpu_torch.ops.qk import compress_qk_layer_rope as t_qk_rope  # noqa: E402
from modegpt_tpu_torch.ops.vo import compress_vo_layer as t_vo  # noqa: E402

T = torch.from_numpy


def _gram(rng, n, tokens=None):
    X = rng.standard_normal((tokens or 3 * n, n)) * rng.uniform(0.2, 2.0, n)
    return X.T @ X / X.shape[0]


@pytest.mark.parametrize(
    "ratio,smoothing,max_sp",
    [(0.3, 0.15, 0.8), (0.5, 0.015, 0.8), (0.6, 0.02, 0.7)],
)
def test_allocation_matches_jax(ratio, smoothing, max_sp):
    """Keep ratios agree to the last ulps of exp (XLA's and ATen's exp
    differ there); the integer ranks derived from them are identical."""
    bi = np.random.default_rng(3).uniform(0.01, 0.3, 12)
    want, want_max = j_alloc(bi, ratio, smoothing=smoothing, max_sparsity=max_sp)
    got, got_max = t_alloc(bi, ratio, smoothing=smoothing, max_sparsity=max_sp)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    assert abs(got_max - want_max) <= 1e-13
    for d in (11008, 14336, 128):
        assert [int(d * k) for k in got] == [int(d * k) for k in want]


@pytest.mark.parametrize("gated", [True, False])
def test_nystrom_mlp(gated):
    rng = np.random.default_rng(11)
    d, D = 24, 64
    C = _gram(rng, D)
    W_u, W_g, W_d = rng.standard_normal((D, d)), rng.standard_normal((D, d)), rng.standard_normal((d, D))
    want = j_nystrom(jnp.asarray(C), jnp.asarray(W_u), jnp.asarray(W_g) if gated else None,
                     jnp.asarray(W_d), 0.6, 1e-2)
    got = t_nystrom(T(C), T(W_u), T(W_g) if gated else None, T(W_d), 0.6, 1e-2)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.up.numpy(), np.asarray(want.up))
    if gated:
        np.testing.assert_array_equal(got.gate.numpy(), np.asarray(want.gate))
    np.testing.assert_allclose(got.down.numpy(), np.asarray(want.down), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (8, 2)])
def test_qk_rope_masks_and_rows(n_heads, n_kv):
    rng = np.random.default_rng(n_heads)
    hd, d = 16, 40
    cov_q = np.stack([_gram(rng, hd) for _ in range(n_heads)])
    cov_k = np.stack([_gram(rng, hd) for _ in range(n_kv)])
    W_q = rng.standard_normal((n_heads * hd, d))
    W_k = rng.standard_normal((n_kv * hd, d))
    want = j_qk_rope(jnp.asarray(cov_q), jnp.asarray(cov_k), jnp.asarray(W_q), jnp.asarray(W_k), 10, 1e-6)
    got = t_qk_rope(T(cov_q), T(cov_k), T(W_q), T(W_k), 10, 1e-6)
    np.testing.assert_array_equal(got.rotary_mask.numpy(), np.asarray(want.rotary_mask))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    # the mask pairs each kept frequency with its rotate_half partner
    m = got.rotary_mask.numpy()
    np.testing.assert_array_equal(m[:, 5:], m[:, :5] + hd // 2)


def test_qk_opt_rows_and_biases():
    rng = np.random.default_rng(2)
    H, hd, d = 4, 12, 48
    cov_q = np.stack([_gram(rng, hd) for _ in range(H)])
    cov_k = np.stack([_gram(rng, hd) for _ in range(H)])
    W_q, W_k = rng.standard_normal((H * hd, d)), rng.standard_normal((H * hd, d))
    b_q, b_k = rng.standard_normal(H * hd), rng.standard_normal(H * hd)
    args = (cov_q, cov_k, W_q, W_k, b_q, b_k)
    want = j_qk_opt(*map(jnp.asarray, args), 7, 1e-6)
    got = t_qk_opt(*map(T, args), 7, 1e-6)
    for name in ("q", "k", "q_bias", "k_bias"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def _pin_signs(v, o, n_heads, n_kv, r):
    """Flip each kept basis vector (a row of v per kv head, and the
    matching rows of the group's o heads) so its largest entry is
    positive."""
    v, o = v.copy(), o.copy()
    G = n_heads // n_kv
    for kv in range(n_kv):
        for j in range(r):
            row = kv * r + j
            s = np.sign(v[row, np.argmax(np.abs(v[row]))])
            v[row] *= s
            for g in range(G):
                o[:, (kv * G + g) * r + j] *= s
    return v, o


@pytest.mark.parametrize("whiten", ["eigh", "cholesky"])
@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (8, 2)])
def test_vo_factors(n_heads, n_kv, whiten):
    rng = np.random.default_rng(7 + n_kv)
    hd, d, r = 8, 32, 6
    C = _gram(rng, d)
    W_v = rng.standard_normal((n_kv * hd, d))
    W_o = rng.standard_normal((d, n_heads * hd))
    want = j_vo(jnp.asarray(C), jnp.asarray(W_v), jnp.asarray(W_o), r, n_heads, n_kv, 1e-4, whiten)
    got = t_vo(T(C), T(W_v), T(W_o), r, n_heads, n_kv, 1e-4, whiten)
    wv, wo = np.asarray(want.v), np.asarray(want.o)
    gv, go = got.v.numpy(), got.o.numpy()
    G = n_heads // n_kv
    for h in range(n_heads):
        kv = h // G
        prod_w = wo[:, h * r:(h + 1) * r] @ wv[kv * r:(kv + 1) * r]
        prod_g = go[:, h * r:(h + 1) * r] @ gv[kv * r:(kv + 1) * r]
        np.testing.assert_allclose(prod_g, prod_w, rtol=1e-8, atol=1e-10 * np.abs(prod_w).max())
    gv, go = _pin_signs(gv, go, n_heads, n_kv, r)
    wv, wo = _pin_signs(wv, wo, n_heads, n_kv, r)
    np.testing.assert_allclose(gv, wv, rtol=1e-8, atol=1e-10 * np.abs(wv).max())
    np.testing.assert_allclose(go, wo, rtol=1e-8, atol=1e-10 * np.abs(wo).max())
