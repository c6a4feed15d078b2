"""Parity: modegpt_tpu_torch.ops.psd against modegpt_tpu.ops.psd.

Inputs are made with numpy from a seed and fed to both packages; the
float64 results agree to rtol 1e-9 (both run LAPACK on the CPU, in
different summation orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.ops import psd as jpsd  # noqa: E402
from modegpt_tpu_torch.ops import psd as tpsd  # noqa: E402

RTOL = 1e-9


def _psd(seed, n, rank=None, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, rank or 2 * n))
    return (X @ X.T) * (scale / n)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("n", [8, 33])
def test_sqrt_and_inv_sqrt(n, scaled):
    M = _psd(n, n)
    want_s, want_i = jpsd.sqrt_and_inv_sqrt_psd(jnp.asarray(M), 1e-4, scaled=scaled)
    got_s, got_i = tpsd.sqrt_and_inv_sqrt_psd(torch.from_numpy(M), 1e-4, scaled=scaled)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=RTOL, atol=1e-12)
    got = tpsd.sqrt_psd(torch.from_numpy(M), 1e-4, scaled=scaled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_s), rtol=RTOL, atol=1e-12)


def test_sqrt_batched_over_heads():
    M = np.stack([_psd(s, 12) for s in range(3)])
    want = np.stack([np.asarray(jpsd.sqrt_psd(jnp.asarray(m), 1e-4)) for m in M])
    got = tpsd.sqrt_psd(torch.from_numpy(M), 1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("n", [16, 70])
def test_ridge_inverse_diag(n):
    C = _psd(n + 1, n)
    want = jpsd.ridge_inverse_diag(jnp.asarray(C), 1e-2)
    got = tpsd.ridge_inverse_diag(torch.from_numpy(C), 1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_cholesky_solve_ridged():
    rng = np.random.default_rng(5)
    A = _psd(4, 40)
    B = rng.standard_normal((40, 7))
    want = jpsd.cholesky_solve_ridged(jnp.asarray(A), jnp.asarray(B), 1e-6)
    got = tpsd.cholesky_solve_ridged(torch.from_numpy(A), torch.from_numpy(B), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_cholesky_escalated_well_conditioned_is_one_factorisation():
    A = _psd(6, 24)
    want = jpsd._cholesky_escalated(jnp.asarray(A), 1e-6)
    got = tpsd._cholesky_escalated(torch.from_numpy(A), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)
    # no escalation: L L^T reproduces A + ridge I
    np.testing.assert_allclose((got @ got.T).numpy(), A + 1e-6 * np.eye(24), rtol=1e-12, atol=1e-12)


def test_singular_f32_gram_escalates_ridge():
    """A rank-2 float32 Gram at scale 1e3: a 1e-6 ridge sits below f32
    rounding, the first factorisation fails, and both packages escalate
    to the rounding floor 8*eps*trace(A) and return finite factors."""
    A = _psd(7, 48, rank=2, scale=1e3).astype(np.float32)
    with pytest.raises(Exception):
        torch.linalg.cholesky(torch.from_numpy(A) + 1e-6 * torch.eye(48))
    got = tpsd._cholesky_escalated(torch.from_numpy(A), 1e-6)
    want = np.asarray(jpsd._cholesky_escalated(jnp.asarray(A), 1e-6))
    assert torch.isfinite(got).all() and np.isfinite(want).all()
    floor = 8 * np.finfo(np.float32).eps * np.trace(A.astype(np.float64))
    recon = (got.double() @ got.double().T).numpy()
    ridge = np.mean(np.diag(recon - A))
    assert floor * 0.99 <= ridge <= floor * 32 ** 8
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    # the f32 leverage scores built on it are finite too
    assert torch.isfinite(tpsd.ridge_inverse_diag(torch.from_numpy(A), 1e-6)).all()
