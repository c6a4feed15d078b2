"""Pipeline-parallel calibration and evaluation: the layer stack staged.

Port of ``modegpt_tpu.parallel.pp``. Each rank of a ``stage`` mesh axis
holds L/S whole layers on its device; calibration (and evaluation)
microbatches flow stage to stage as the [B, T, d] boundary activation,
sent to the next stage's rank (``dist.send``/``recv``; the JAX package
shifts it round the whole ring with ``lax.ppermute``, the last stage's
send unused). Each stage accumulates the Gram statistics of ITS OWN
layers in float32 on its device, so the [D_int, D_int] accumulators,
the memory this mode exists for, are split across the stages.

The schedule is GPipe's forward: N + S - 1 steps for N microbatches
over S stages; at step t stage s runs microbatch t - s if there is one
(the JAX program computes and masks the idle steps, the port skips
them). Each entry of the calibration batch list is one microbatch. A
``data`` axis beside ``stage`` splits every microbatch's rows; the sums
are all-reduced over it.

Each stage runs its layers through the forward's own layer body
(`models.forward._layer`, or `models.padded._layer_padded` for a padded
compressed stack) with ``attn_impl="auto"``, so the CUDA kernel K1 runs
on every stage on the card. The JAX pipeline stages through
``scan_forward._one_layer`` with its ``xla`` attention default; the port
has no scanned forward.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.calib.engine import CalibrationResult
from modegpt_tpu_torch.evals.perplexity import _nll_from_logits
from modegpt_tpu_torch.models.forward import _bi_piece, _embed, _layer, _unembed
from modegpt_tpu_torch.models.padded import _layer_padded, _layer_params, _layer_window
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.rope import rope_cos_sin
from modegpt_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, recv_from, send_to, shard_batch

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["calibrate_pp", "perplexity_pp", "supports_pp", "STAGE_AXIS"]

STAGE_AXIS = "stage"
_HEAD_KEYS = ("embed_tokens", "embed_positions", "project_in", "project_out", "final_norm", "lm_head")


def supports_pp(spec: ModelSpec, mesh: Optional[Mesh]) -> bool:
    """PP calibration needs a 'stage' mesh axis, only stage (+ optional
    data) axes, a uniform dense layer stack (calibration runs on the
    dense model), and a layer count divisible by the stage count."""
    if mesh is None or STAGE_AXIS not in mesh.axis_names:
        return False
    if [a for a in mesh.axis_names if a not in (STAGE_AXIS, "data")]:
        return False
    if spec.n_experts or not spec.is_uniform:
        return False
    if spec.layer_types and len(set(spec.layer_types)) > 1:
        return False
    return spec.n_layers % mesh.size(STAGE_AXIS) == 0


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _rope(spec: ModelSpec, T: int, dtype: torch.dtype, device: torch.device):
    if not spec.uses_rope:
        return None, None
    positions = torch.arange(T, device=device, dtype=torch.int32)
    return rope_cos_sin(positions, spec.head_dim, spec.rope_theta, dtype=dtype, scaling=spec.rope_scaling)


def _impl(attn_impl: str, device: torch.device) -> str:
    """"auto" resolved as the forward resolves it: K1 on the card."""
    if attn_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return attn_impl


def _stage_batches(mesh: Mesh, batches: np.ndarray) -> np.ndarray:
    """[N, B, T] microbatches -> this rank's rows [N, B / data, T]."""
    return np.stack([shard_batch(mesh, b) for b in batches])


@torch.no_grad()
def _run_pipeline(mesh: Mesh, batches: np.ndarray, d_model: int, dtype: torch.dtype, embed_fn, stage_fn):
    """The GPipe forward schedule over this rank's microbatch rows
    ``batches`` [N, B, T]: at step t, stage s runs microbatch t - s: its
    input embedded (stage 0) or received from stage s - 1, ``stage_fn(x,
    mb)`` over its layers, its output sent to stage s + 1. Blocking sends
    cannot deadlock: a stage waits only on its neighbours' progress, and
    the last stage sends nothing."""
    S, s = mesh.size(STAGE_AXIS), mesh.coord(STAGE_AXIS)
    N, B, T = batches.shape
    like = torch.empty((B, T, d_model), dtype=dtype, device=mesh.device)
    for t in range(N + S - 1):
        mb = t - s
        if not 0 <= mb < N:
            continue
        if s == 0:
            x = embed_fn(torch.as_tensor(batches[mb], device=mesh.device))
        else:
            x = recv_from(mesh, like, STAGE_AXIS, s - 1)
        x = stage_fn(x, mb)
        if s < S - 1:
            send_to(mesh, x, STAGE_AXIS, s + 1)


@torch.no_grad()
def calibrate_pp(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    mesh: Mesh,
    attn_impl: str = "auto",
) -> CalibrationResult:
    """Pipeline-parallel calibration of ALL layers in one pass (JAX
    ``pp.py:72-248``). ``params`` is the full tree on any device; each
    stage copies only its layers (and stage 0 the embeddings) to its
    device. Each stage's float32 sums over its layers, all-reduced over
    ``data``, are all-gathered over ``stage`` at the end, so every rank
    returns every layer's statistics as float64 on the host, as the JAX
    function returns them fetched. There is no layers_per_step: the
    stages splitting the accumulators is the memory plan."""
    if not supports_pp(spec, mesh):
        raise ValueError("calibrate_pp needs a 'stage' mesh axis (with at most a 'data' axis beside it), "
                         "a uniform dense stack and a layer count divisible by the stage count")
    S, s = mesh.size(STAGE_AXIS), mesh.coord(STAGE_AXIS)
    L = spec.n_layers
    per_stage = L // S
    mine = list(range(s * per_stage, (s + 1) * per_stage))
    shapes = {np.asarray(b).shape for b in batches}
    if len(shapes) != 1:
        raise ValueError(
            f"pipeline calibration needs uniform microbatches, got shapes {shapes} "
            "(make calib_size a multiple of calibs_batch_size)"
        )
    stacked = np.stack([np.asarray(b) for b in batches])
    N, B, T = stacked.shape
    local = _stage_batches(mesh, stacked)
    dev = mesh.device
    layers = {l: _to(params["layers"][l], dev) for l in mine}
    head = _to({k: params[k] for k in ("embed_tokens", "embed_positions", "project_in") if k in params}, dev) \
        if s == 0 else None
    dtype = params["embed_tokens"].dtype
    cos, sin = _rope(spec, T, dtype, dev)
    impl = _impl(attn_impl, dev)

    acc: Dict[str, list] = {}
    bi = torch.zeros(per_stage, dtype=torch.float32, device=dev)

    def stage_fn(x, mb):
        nonlocal bi
        pieces = []
        for i, l in enumerate(mine):
            x_new, taps = _layer(spec, l, layers[l], x, cos, sin, True, impl)
            pieces.append(_bi_piece(x, x_new))
            for key, g in taps.items():
                slots = acc.setdefault(key, [None] * per_stage)
                slots[i] = g if slots[i] is None else slots[i] + g
            x = x_new
        bi = bi + torch.stack(pieces)
        return x

    _run_pipeline(mesh, local, spec.d_model, dtype, lambda ids: _embed(spec, head, ids), stage_fn)
    n_sequences = N * B
    total_tokens = n_sequences * T
    stats = {}
    for key in ("cov_mlp", "cov_q", "cov_k", "cov_x"):
        stage_sum = all_reduce(mesh, torch.stack(acc.pop(key)), "data")
        full = all_gather(mesh, stage_sum, STAGE_AXIS, dim=0)
        del stage_sum
        stats[key] = {l: full[l].to(device="cpu", dtype=torch.float64) / total_tokens for l in range(L)}
        del full
    bi = all_gather(mesh, all_reduce(mesh, bi, "data"), STAGE_AXIS, dim=0)
    logger.info(
        "pp calibration: %d microbatches x [%d, %d] over %d stages (bubble %.0f%%), all %d layers in one pass",
        N, B, T, S, 100 * (S - 1) / (N + S - 1), L,
    )
    return CalibrationResult(
        **stats,
        bi_scores=(bi.to(device="cpu", dtype=torch.float64) / n_sequences).tolist(),
        n_sequences=n_sequences,
        total_tokens=total_tokens,
    )


@torch.no_grad()
def perplexity_pp(
    spec: ModelSpec,
    params: Dict,
    eval_tokens: np.ndarray,
    mesh: Mesh,
    batch_size: int = 8,
    attn_impl: str = "auto",
    padded: Optional[object] = None,
) -> float:
    """Pipeline-parallel perplexity (JAX ``pp.py:251-424``): the stack
    staged as in `calibrate_pp`, the LAST stage computing the shifted
    cross-entropy of each microbatch as it drains; the NLL sums are
    all-reduced over ``stage`` and ``data``. A heterogeneous compressed
    model is evaluated through its `models.padded.PaddedModel`
    (``padded``): each stage then runs the padded layers (true-rank
    scaling, rotary masks), so a compressed model of any depth is
    stage-sharded too. Windows that do not fill a batch are dropped, as
    in JAX. Returns exp(sum_nll / (n * (seq_len - 1))) (reference:
    eval.py:220)."""
    if padded is not None:
        spec = padded.spec
        head_src = padded.other
    else:
        if not supports_pp(spec, mesh):
            raise ValueError("perplexity_pp needs a pipeline-compatible spec and mesh (see supports_pp)")
        head_src = params
    S, s = mesh.size(STAGE_AXIS), mesh.coord(STAGE_AXIS)
    if S == 1 or spec.n_layers % S:
        raise ValueError(f"{spec.n_layers} layers must divide the {S} stages")
    per_stage = spec.n_layers // S
    mine = list(range(s * per_stage, (s + 1) * per_stage))

    n_samples, T = eval_tokens.shape
    n_keep = (n_samples // batch_size) * batch_size
    if n_keep != n_samples:
        logger.info("pp eval: dropping %d samples to fill batches", n_samples - n_keep)
    batches = np.asarray(eval_tokens[:n_keep]).reshape(-1, batch_size, T)
    local = _stage_batches(mesh, batches)
    dev = mesh.device
    head = _to({k: head_src[k] for k in _HEAD_KEYS if head_src.get(k) is not None}, dev) \
        if s in (0, S - 1) else None
    dtype = head_src["embed_tokens"].dtype
    cos, sin = _rope(spec, T, dtype, dev)
    impl = _impl(attn_impl, dev)
    if padded is not None:
        layers = {l: (_to(_layer_params(padded.layers, l), dev), padded.q_hd_true[l].to(dev)) for l in mine}

        def run_layer(l, x):
            p, r_true = layers[l]
            return _layer_padded(spec, p, r_true, x, cos, sin, impl, _layer_window(spec, l), layer=l)
    else:
        layers = {l: _to(params["layers"][l], dev) for l in mine}

        def run_layer(l, x):
            return _layer(spec, l, layers[l], x, cos, sin, False, impl)[0]

    nll = torch.zeros((), dtype=torch.float64, device=dev)

    def stage_fn(x, mb):
        nonlocal nll
        for l in mine:
            x = run_layer(l, x)
        if s == S - 1:
            ids = torch.as_tensor(local[mb], device=dev)
            nll = nll + _nll_from_logits(_unembed(spec, head, x), ids).to(torch.float64)
        return x

    _run_pipeline(mesh, local, spec.d_model, dtype, lambda ids: _embed(spec, head, ids), stage_fn)
    total = float(all_reduce(mesh, nll, (STAGE_AXIS, "data")))
    logger.info("pp eval: %d samples x %d tokens over %d stages", n_keep, T, S)
    return math.exp(total / (n_keep * (T - 1)))
