"""Parity: the port's ragged GQA attention (K3) on the CPU, its plain
version, against the JAX package's Pallas kernel in interpret mode.

Same numpy inputs to both; float32 tolerance rtol 1e-5 / atol 1e-6 (the
two sum the scores and the P.V product in different orders). Cases cover
ragged per-slot positions, S in {1, 4}, sliding windows (0 = full),
softcap, int8 codes with per-position scales, Rq != Rv, garbage in the
pool past each slot's live range, and the S=1 decode form.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.kernels import ragged_decode as j_ragged  # noqa: E402
from modegpt_tpu_torch.kernels import ragged_decode as t_ragged  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
B, H, HK, T = 3, 4, 2, 40


def _inputs(S, Rq, Rv, int8, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, Rq)) * Rq**-0.5).astype(np.float32)
    pos = np.asarray([0, 17, T - S], np.int32)  # ragged, first and last slot at the edges
    if int8:
        k = rng.integers(-127, 128, (B, HK, T, Rq), dtype=np.int8)
        v = rng.integers(-127, 128, (B, HK, T, Rv), dtype=np.int8)
        ks = (rng.uniform(0.5, 1.5, (B, HK, T)) / 127).astype(np.float32)
        vs = (rng.uniform(0.5, 1.5, (B, HK, T)) / 127).astype(np.float32)
        return q, k, v, pos, ks, vs
    k = rng.standard_normal((B, HK, T, Rq)).astype(np.float32)
    v = rng.standard_normal((B, HK, T, Rv)).astype(np.float32)
    return q, k, v, pos, None, None


def _port(q, k, v, pos, ks, vs, **kw):
    t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, pos, ks, vs)]
    return t_ragged.ragged_gqa_attend(*t[:4], k_scale=t[4], v_scale=t[5], **kw).numpy()


def _jax(q, k, v, pos, ks, vs, **kw):
    j = [None if a is None else jnp.asarray(a) for a in (q, k, v, pos, ks, vs)]
    return np.asarray(j_ragged.ragged_gqa_attend(
        *j[:4], k_scale=j[4], v_scale=j[5], block_t=128, interpret=True, **kw
    ))


CASES = {
    "S1_full": dict(S=1, window=None),
    "S4_full": dict(S=4, window=None),
    "S1_window0": dict(S=1, window=0),
    "S1_window8": dict(S=1, window=8),
    "S4_window8": dict(S=4, window=8),
    "S4_softcap": dict(S=4, softcap=5.0),
    "S1_int8": dict(S=1, int8=True),
    "S4_int8_window8": dict(S=4, int8=True, window=8),
    "S4_rq40_rv24": dict(S=4, Rq=40, Rv=24),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_ragged_matches_jax_kernel(name):
    case = dict(dict(S=1, Rq=32, Rv=32, int8=False, window=None, softcap=None), **CASES[name])
    args = _inputs(case["S"], case["Rq"], case["Rv"], case["int8"])
    kw = dict(window=case["window"], softcap=case["softcap"])
    got = _port(*args, **kw)
    assert got.shape == (B, H, case["S"], case["Rv"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(*args, **kw), **TOL)


def test_window_zero_is_full_attention():
    args = _inputs(4, 32, 32, False, seed=1)
    np.testing.assert_array_equal(_port(*args, window=0), _port(*args, window=None))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_garbage_past_the_live_range_is_ignored(int8):
    """Pool positions past each slot's last query never contribute."""
    q, k, v, pos, ks, vs = _inputs(4, 32, 24, int8, seed=2)
    k2, v2 = k.copy(), v.copy()
    ks2 = None if ks is None else ks.copy()
    for b, p in enumerate(pos):
        k2[b, :, p + 4:] = 100 if int8 else 1e4
        v2[b, :, p + 4:] = -100 if int8 else -1e4
        if ks2 is not None:
            ks2[b, :, p + 4:] = 50.0
    want = _port(q, k, v, pos, ks, vs)
    np.testing.assert_array_equal(_port(q, k2, v2, pos, ks2, vs), want)
    np.testing.assert_allclose(_jax(q, k2, v2, pos, ks2, vs), want, **TOL)


def test_decode_form_is_the_S1_case():
    q, k, v, pos, _, _ = _inputs(1, 32, 24, False, seed=3)
    counts = pos + 1
    attend = _port(q, k, v, pos, None, None)[:, :, 0]
    decode = t_ragged.ragged_gqa_decode(
        torch.from_numpy(q[:, :, 0]), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(counts)
    ).numpy()
    np.testing.assert_array_equal(decode, attend)
    j = np.asarray(j_ragged.ragged_gqa_decode(
        jnp.asarray(q[:, :, 0]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(counts), interpret=True
    ))
    np.testing.assert_allclose(decode, j, **TOL)


def test_bfloat16_rounds_p_before_pv():
    """bf16 inputs: float32 scores and accumulators, p rounded to bf16
    before the P.V product, output in bf16 (the Pallas kernel's order)."""
    q, k, v, pos, _, _ = _inputs(4, 32, 32, False, seed=4)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = t_ragged.ragged_gqa_attend(*bf, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    want = _jax(*[np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v)], pos, None, None)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=2e-2, atol=2e-2)


def test_scales_come_in_pairs():
    q, k, v, pos, ks, vs = _inputs(1, 32, 32, True)
    with pytest.raises(ValueError, match="both"):
        t_ragged.ragged_gqa_attend(*(torch.from_numpy(a) for a in (q, k, v, pos)), k_scale=torch.from_numpy(ks))


# ---- the CUDA kernel's split-K arithmetic, emulated in plain PyTorch ----

def _split_k(q, k, v, pos, ks, vs, window, softcap, split):
    """The kernel's flash-decoding on the CPU: for every split of `split`
    keys, each row's partial (m, l, acc) over the live keys in it (m =
    -1e30, l = 0, acc = 0 for a row with none), with l summing the
    unscaled p and acc the product of p * v_scale (rounded to bf16 for
    bf16 inputs) with v; then the combine, acc_i and l_i rescaled by
    exp(m_i - M) and summed, and acc / max(l, 1e-30)."""
    B, H, S, Rq = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    s = torch.einsum("bkrd,bktd->bkrt", q.float().reshape(B, Hk, G * S, Rq), k.float())
    if ks is not None:
        s = s * ks[:, :, None, :]
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    limit = pos.long()[:, None] + torch.arange(G * S)[None, :] % S  # [B, rows]: row g*S + s at pos + s
    t_ids = torch.arange(T)
    live = t_ids[None, None, :] <= limit[:, :, None]
    if window:
        live = live & (t_ids[None, None, :] > limit[:, :, None] - window)
    live = live[:, None]  # [B, 1, rows, T]
    parts = []
    for t0 in range(0, T, split):
        cut = slice(t0, min(T, t0 + split))
        sc = s[..., cut].masked_fill(~live[..., cut], float("-inf"))
        m = torch.amax(sc, dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30))
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        if vs is not None:
            p = p * vs[:, :, None, cut]
        if q.dtype != torch.float32:
            p = p.to(q.dtype).float()
        parts.append((m, l, p @ v[:, :, cut].float()))
    M = torch.amax(torch.stack([m for m, _, _ in parts]), dim=0)
    L = sum(torch.exp(m - M) * l for m, l, _ in parts)
    A = sum(torch.exp(m - M) * acc for m, _, acc in parts)
    return (A / torch.clamp(L, min=1e-30)).reshape(B, H, S, v.shape[-1]).to(q.dtype)


SPLIT_T = 40
SPLIT_CASES = {
    "edge_row": dict(pos=[5, SPLIT_T + 3, 21]),  # slot 1 past the pool's end
    "window_shorter_than_split": dict(pos=[9, 30, 36], window=3),
    "split_with_no_live_key": dict(pos=[30, 2, 36], window=6),  # early splits dead, and late ones for slot 1
    "int8_scales": dict(pos=[0, 17, 36], int8=True, softcap=5.0),
    "bf16_p_rounding": dict(pos=[0, 17, 36], dtype=torch.bfloat16),
}


@pytest.mark.parametrize("split", [1, 7, 64, SPLIT_T], ids=["split1", "split7", "split64", "splitT"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_k_combine_matches_plain(name, split):
    """Splitting the keys and combining the partials gives the plain
    version's output: float32 within rtol 2e-4 / atol 2e-5. bfloat16 is
    held to 2e-2, since each split rounds its p to bf16 relative to its
    own max (the plain version: to the row's max)."""
    case = dict(dict(window=None, softcap=None, int8=False, dtype=torch.float32), **SPLIT_CASES[name])
    rng = np.random.default_rng(7)
    S, Rq, Rv = 4, 24, 20
    q = torch.from_numpy((rng.standard_normal((B, H, S, Rq)) * Rq**-0.5).astype(np.float32)).to(case["dtype"])
    if case["int8"]:
        k, v = (torch.from_numpy(rng.integers(-127, 128, (B, HK, SPLIT_T, r), dtype=np.int8)) for r in (Rq, Rv))
        ks, vs = (torch.from_numpy((rng.uniform(0.5, 1.5, (B, HK, SPLIT_T)) / 127).astype(np.float32)) for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.standard_normal((B, HK, SPLIT_T, r)).astype(np.float32)).to(case["dtype"])
                for r in (Rq, Rv))
        ks = vs = None
    pos = torch.tensor(case["pos"], dtype=torch.int32)
    kw = dict(window=case["window"], softcap=case["softcap"])
    got = _split_k(q, k, v, pos, ks, vs, split=split, **kw)
    want = t_ragged.ragged_gqa_attend_reference(q, k, v, pos, k_scale=ks, v_scale=vs, **kw)
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    tol = dict(rtol=2e-4, atol=2e-5) if case["dtype"] == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
