"""Layer-streamed calibration and solve: models beyond device memory on one card.

Port of ``modegpt_tpu.compress.offload``. The reference compresses models
bigger than one GPU by spilling layers over devices and host with HF
accelerate's ``device_map="auto"`` (reference: src/model_utils.py:70,152).
This module follows the job's sequential structure instead:

The compression statistics are per-layer token sums, so the whole
calibration is ONE forward pass when layers are processed in order with
the activations held on the device:

  1. Embed every calibration sequence once: ``X [N, B, T, D]`` stays on
     the device.
  2. For each layer l: stage its weights onto the device, run every
     batch through the layer (`_stream_layer_step`), collect the layer's
     Gram taps and BI piece, and write the new activations over X.
  3. Every ``width`` layers, solve the window's factors from the device
     covariances (`compress.batched.solve_chunk_batched`) and drop the
     window's taps and staged weights.

Against the resident windowed path (`calib.engine.calibrate_window`) the
forward runs once rather than once per window, and since weights are
staged per layer the model never has to fit on the card: the peak is two
staged layers, the activations and one window's covariances and solve.

Where the weights live decides the staging: a tree whose layer leaves
are on the CPU while the sweep computes on a card is host-staged (the
pipeline keeps a model loaded from disk there); leaves already on the
compute device are resident and staging passes them through. Host
staging goes through two reusable pinned host buffers and a copy stream
(`_PinnedStager`): a copy from pageable memory would be synchronous.

Allocation: keep ratios come from Block-Influence scores over every
layer (reference: run_modegpt.py:126-133), which need a full sweep before
the first solve, so without ``keep_ratios`` a BI-only prepass
(`stream_bi_sweep`, no taps) runs first. It may stage int8 or int4 codes
of the weights (``bi_stage_dtype``): the layer ranking it feeds is
insensitive to the sub-percent forward error, while the tap sweep always
stages exact weights. Why the prepass cannot fold into the tap sweep: the
allocation is a softmax over all layers' BI, and the Type-I down
re-solve needs a layer's full ``[d_int, d_int]`` covariance once its rank
is known; holding that for every layer does not fit.

Not ported: the JAX module's recovery from a dropped connection to a
remote accelerator (host snapshots of the stacks every
``stream_checkpoint_every`` layers, a backend reset and a resume). A
CUDA error leaves the process's context unusable, so an in-process
reconnect has no counterpart; ``stream_checkpoint_every`` > 0 raises.
Nor its per-generation memory table (`utils.memory` reads the card's
size) or host-RSS trimming for the remote client.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from modegpt_tpu_torch.calib.engine import CalibrationResult
from modegpt_tpu_torch.config import CompressionConfig
from modegpt_tpu_torch.models.forward import _bi_piece, _embed, _layer
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.rope import rope_cos_sin
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device
from modegpt_tpu_torch.utils.profiling import span

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = ["stream_calibrate_solve", "stream_bi_sweep"]

_Q_MIN_SIZE = 1 << 12  # leaves below this stage raw (1-D norms and biases already do)
_LOWMEM_COV_BYTES = 4e8  # JAX batched.py:63: a dense cov_mlp beyond this solves "lowmem"
_PIN_ALIGN = 256  # byte alignment of each leaf inside a pinned buffer


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def _host_staged(params: Dict, device: torch.device) -> bool:
    """Whether the layer leaves wait on the CPU while the sweep computes
    on a card (staged per layer), rather than resident on the compute
    device."""
    return _leaves(params["layers"][0])[0].device.type == "cpu" and device.type != "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _PinnedStager:
    """Host layer trees -> the compute device.

    On CUDA each call packs the tree's CPU leaves into one of two
    reusable pinned host buffers (page-locked, so the copy to the card is
    asynchronous; pinning a whole 14-130 GB tree would cost seconds and
    double host memory) and copies them on a dedicated stream. The call
    returns the device tree and the event its copy records: the consumer
    makes its stream wait for the event just before it reads the layer,
    so the copy of layer l+1 overlaps layer l's forward. A buffer is
    refilled only after its previous copy has finished. The device
    tensors are marked used on the compute stream (``record_stream``), so
    the caching allocator does not hand out their blocks while the
    forward still reads them. Leaves already on the device pass through;
    on a CPU compute device staging is a plain ``.to``.

    ``stats["staged_bytes"]`` accumulates the bytes copied host -> device.
    """

    def __init__(self, device: torch.device, stats: Optional[Dict]):
        self.device = device
        self.stats = stats
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.buffers: List[Optional[torch.Tensor]] = [None, None]
        self.done: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def __call__(self, tree) -> Tuple[Dict, Optional["torch.cuda.Event"]]:
        host = [t for t in _leaves(tree) if t.device.type == "cpu"] if self.cuda else []
        if self.stats is not None:
            self.stats["staged_bytes"] = self.stats.get("staged_bytes", 0) + sum(
                t.numel() * t.element_size() for t in (host if self.cuda else _leaves(tree))
            )
        if not host:
            return _tree_map(lambda t: t.to(self.device), tree), None

        slot, self.turn = self.turn, self.turn ^ 1
        offsets, total = [], 0
        for t in host:
            offsets.append(total)
            total += -(-t.numel() * t.element_size() // _PIN_ALIGN) * _PIN_ALIGN
        if self.done[slot] is not None:
            self.done[slot].synchronize()  # this buffer's last copy has left it
        buf = self.buffers[slot]
        if buf is None or buf.numel() < total:
            buf = self.buffers[slot] = None  # free the old one first
            buf = self.buffers[slot] = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        compute = torch.cuda.current_stream(self.device)
        staged = {}
        with torch.cuda.stream(self.stream):
            for t, off in zip(host, offsets):
                n = t.numel() * t.element_size()
                pinned = buf[off:off + n].view(t.dtype).view(t.shape)
                pinned.copy_(t)
                dev = pinned.to(self.device, non_blocking=True)
                dev.record_stream(compute)
                staged[id(t)] = dev
            done = torch.cuda.Event()
            done.record(self.stream)
        self.done[slot] = done
        return _tree_map(lambda t: staged.get(id(t), t), tree), done


def _ready(staged: Tuple[Dict, Optional["torch.cuda.Event"]], device: torch.device) -> Dict:
    """The staged tree, once the compute stream is ordered after its copy."""
    tree, done = staged
    if done is not None:
        torch.cuda.current_stream(device).wait_event(done)
    return tree


def _quantize_host_tree(lp, dtype: str):
    """Host tree -> (kinds, payload tree) at the prepass's staging precision.

    Symmetric per-row (last-axis) quantisation of every large floating
    leaf on the CPU, in numpy, as the JAX package does (true division, so
    codes and scales are bit-equal to its): int8 one signed byte a value;
    int4 two codes a byte (offset-8 nibbles), the last axis padded to even
    and trimmed when dequantised. Small leaves (norms, biases), integer
    and device leaves pass raw. ``kinds`` maps each leaf's path to its
    recipe for `_dequant_staged`."""
    kinds: Dict[Tuple, Tuple] = {}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if (
            not isinstance(node, torch.Tensor)
            or node.device.type != "cpu"
            or node.dim() < 2
            or node.numel() < _Q_MIN_SIZE
            or not node.is_floating_point()
        ):
            kinds[path] = ("raw",)
            return node
        f = node.to(torch.float32).numpy()
        amax = np.abs(f).max(axis=-1, keepdims=True)
        if dtype == "int8":
            scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            q = np.clip(np.rint(f / scale), -127, 127).astype(np.int8)
            kinds[path] = ("q8", node.dtype)
            return {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
        scale = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(f / scale), -7, 7).astype(np.int8) + 8
        n = q.shape[-1]
        if n % 2:
            q = np.concatenate([q, np.full(q.shape[:-1] + (1,), 8, np.int8)], axis=-1)
        packed = (q[..., 0::2] | (q[..., 1::2] << 4)).astype(np.uint8)
        kinds[path] = ("q4", node.dtype, n)
        return {"q": torch.from_numpy(packed), "scale": torch.from_numpy(scale)}

    return kinds, walk(lp, ())


def _dequant_staged(kinds: Dict[Tuple, Tuple], payload):
    """The layer tree back from its staged payload, on the payload's
    device: exactly the inverse recipe of `_quantize_host_tree`."""

    def walk(node, path):
        kind = kinds.get(path)
        if kind is None:
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if kind[0] == "raw":
            return node
        q, scale = node["q"], node["scale"]
        if kind[0] == "q8":
            return (q.to(torch.float32) * scale).to(kind[1])
        lo = (q & 0xF).to(torch.int32) - 8
        hi = (q >> 4).to(torch.int32) - 8
        full = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1], -1)[..., : kind[2]]
        return (full.to(torch.float32) * scale).to(kind[1])

    return walk(payload, ())


def _stage_quantized(lp, dtype: str, stager: _PinnedStager, stats: Optional[Dict] = None) -> Dict:
    """Host leaves -> device leaves through per-row quantised staging: the
    copy carries 1 (int8) or 0.5 (int4) bytes a weight, dequantised on the
    device before the forward. Only the BI prepass (`stream_bi_sweep`)
    stages this way."""
    t0 = time.perf_counter()
    kinds, payload = _quantize_host_tree(lp, dtype)
    if stats is not None:
        stats["prepass_quant_s"] = stats.get("prepass_quant_s", 0.0) + time.perf_counter() - t0
    return _dequant_staged(kinds, _ready(stager(payload), stager.device)), None


def _slim_window_lp(spec: ModelSpec, l: int, lp: Dict, host_staged: bool, config: CompressionConfig) -> Dict:
    """The staged tree a flush window keeps for its solve.

    With host-staged weights the solve gathers the up/gate and q/k rows
    from the host tree (`solve_chunk_batched` ``host_params``) and reads
    only down, v and o on the device, and the forward is done by flush
    time: dropping the rest frees about half the staged layer (524 MB a
    window at Qwen3-32B widths in bf16) before the solve's workspace
    allocates beside it. MoE layers and dense layers whose ``cov_mlp`` is
    below the JAX package's low-memory threshold keep the whole tree, as
    there. The whitened-SVD Q/K solve (``config.qk_method == "svd"`` on a
    non-RoPE arch) reads the staged q/k kernels, so they stay too."""
    if not host_staged or spec.is_moe_layer(l) or spec.gate_ranks[l] ** 2 * 4 <= _LOWMEM_COV_BYTES:
        return lp
    keep = ("down", "v", "o", "shared")
    if config.qk_method == "svd" and not spec.uses_rope:
        keep += ("q", "k")
    return {k: v for k, v in lp.items() if k in keep}


def _flush_hbm_estimate(
    spec: ModelSpec, layer_bytes: int, stack_bytes: int, width: int, overlap: bool, depth: int = 1
) -> int:
    """Worst-case device bytes while ONE dense window flushes (JAX
    ``offload.py:396-425``, the same terms and numbers).

      taps      per dense layer: cov_mlp [d_int, d_int] f32 + cov_x
                [d, d] f32 + per-head Q/K Grams (bounded by 2 d^2)
      workspace the Type-I selection holds ~2x [d_int, d_int] f32 beside
                the covariance it factors
      staged    layer weights in flight (2 when the next layer's copy
                overlaps, 1 when deferred past the flush)
      stacks    the activation stacks the sweep carries
      overlap   an async flush solves window W while the sweep
                accumulates window W+1's taps, so taps count twice

    Deliberately coarse (no transients, no fragmentation): callers
    compare it with a conservative fraction of the card's memory."""
    d_int = max((spec.gate_ranks[l] for l in range(spec.n_layers)), default=0) or spec.d_int
    taps = 4 * (d_int * d_int + 3 * spec.d_model * spec.d_model) * width
    workspace = 2 * 4 * d_int * d_int
    staged = (2 if overlap else 1) * layer_bytes
    # depth > 1 lets the sweep accumulate that many extra windows' taps
    # while flushes drain: each pins one more window of taps
    extra = (depth - 1) * taps if overlap else 0
    return stack_bytes + staged + (2 if overlap else 1) * taps + workspace + extra


def _async_flush_fits(
    spec: ModelSpec, layer_bytes: int, stack_bytes: int, width: int, hbm_bytes: Optional[int], depth: int = 1
) -> bool:
    """Whether an async window flush (its solve racing the sweep) fits in
    ``hbm_bytes``; an unknown budget (the CPU) fits. The JAX package's
    margins: 0.85 of the memory at depth 1, 0.75 at depth 2."""
    if not hbm_bytes:
        return True
    est = _flush_hbm_estimate(spec, layer_bytes, stack_bytes, width, overlap=True, depth=depth)
    return est <= (0.85 if depth <= 1 else 0.75) * hbm_bytes


def _device_hbm_bytes() -> Optional[int]:
    """The smallest card's memory in bytes (`utils.memory`), or None."""
    from modegpt_tpu_torch.utils.memory import device_memory_stats

    limits = [s["bytes_limit"] for s in device_memory_stats().values() if s.get("bytes_limit")]
    return min(limits) if limits else None


def _checkpoint_every(config) -> int:
    """The JAX package's drop recovery: not ported (module docstring).
    ``auto`` (0) and ``-1`` resolve to 0; an explicit N > 0 raises."""
    every = int(getattr(config, "stream_checkpoint_every", 0) or 0)
    if every > 0:
        raise NotImplementedError(
            "modegpt_tpu_torch.compress.offload: stream_checkpoint_every > 0 is not ported: the JAX "
            "package snapshots the stacks to resume after a dropped connection to a remote "
            "accelerator, and a CUDA error leaves the process's context unusable, so an in-process "
            "reconnect and resume has no counterpart; leave it at 0 (auto) or -1"
        )
    return 0


def _release_solved(spec: ModelSpec, params: Dict, chunk: Dict) -> None:
    """Pop the dense projection leaves that ``chunk``'s factors replace
    (the leaves ``apply_factors(release_dense=True)`` pops): the sweep only
    moves forward and surgery consumes factors, not these leaves."""
    for l in chunk.get("qk", {}):
        params["layers"][l].pop("q", None)
        params["layers"][l].pop("k", None)
    for l in chunk.get("vo", {}):
        params["layers"][l].pop("v", None)
        params["layers"][l].pop("o", None)
    for l, f in chunk.get("mlp", {}).items():
        src = params["layers"][l]
        if spec.is_moe_layer(l):
            src.pop("experts", None)
            if f.get("shared_up") is not None:
                src.pop("shared", None)
        else:
            for key in ("up", "gate", "down"):
                src.pop(key, None)


def _group_batches(batches: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Stack uniform-shaped batches into [N, B, T] groups (a ragged tail
    batch becomes its own group)."""
    groups: Dict[Tuple[int, ...], List[np.ndarray]] = {}
    for b in batches:
        groups.setdefault(tuple(b.shape), []).append(np.asarray(b, dtype=np.int32))
    return [np.stack(g) for g in groups.values()]


def _embed_leaves(spec: ModelSpec, params: Dict) -> Dict:
    keep = {"embed_tokens"}
    if spec.arch in ("opt", "gpt2"):
        keep |= {"project_in", "embed_positions"}
    return {k: v for k, v in params.items() if k in keep}


def _embed_batches(spec: ModelSpec, other: Dict, tokens: np.ndarray, device: torch.device) -> torch.Tensor:
    """[N, B, T] tokens -> [N, B, T, D] embedded activations on ``device``."""
    N, B, T = tokens.shape
    ids = torch.as_tensor(tokens.reshape(N * B, T), device=device)
    return _embed(spec, other, ids).reshape(N, B, T, -1)


def _stream_layer_step(
    spec: ModelSpec, l: int, lp: Dict, x: torch.Tensor, collect: bool, attn_impl: str, gram_precision: str
):
    """Layer ``l`` over the whole stack ``x [N, B, T, D]``, batch by batch,
    overwriting x in place. Returns (the layer's Gram taps summed over
    the N batches, or {}, its BI piece summed in float32). The JAX step is
    one jitted ``lax.scan`` per layer signature (``_rep_index`` and
    ``_layer_signature`` only key its compile cache); here it is a loop
    over the batches, with the true layer index."""
    T = x.shape[2]
    cos = sin = None
    if spec.uses_rope:
        pos = torch.arange(T, device=x.device, dtype=torch.int32)
        cos, sin = rope_cos_sin(pos, spec.head_dim, spec.rope_theta, dtype=x.dtype, scaling=spec.rope_scaling)
    taps: Dict[str, torch.Tensor] = {}
    bi = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        x_new, t = _layer(spec, l, lp, x[i], cos, sin, collect, attn_impl, gram_precision)
        bi = bi + _bi_piece(x[i], x_new)
        x[i] = x_new
        for key, g in (t or {}).items():
            taps[key] = taps[key] + g if key in taps else g
    return taps, bi


def _resolve_attn(attn_impl: str, device: torch.device) -> str:
    if attn_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return attn_impl


def _is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError)


def stream_bi_sweep(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    attn_impl: str = "auto",
    stats_out: Optional[Dict] = None,
    stage_dtype: str = "bf16",
    adaptive: bool = False,
    config=None,
    device: Optional[DeviceLike] = None,
) -> List[float]:
    """BI-only streamed sweep (no taps): one forward's FLOPs, one pass of
    the weights to the device. Returns per-layer BI normalised by the
    sequence count (reference: calibration.py:135-136).

    ``stage_dtype``: "bf16" stages the exact model leaves (whatever their
    dtype; the JAX name); "int8"/"int4" stage per-row quantised codes and
    dequantise on the device (half and a quarter of bf16's bytes). BI
    feeds only the smoothed-softmax allocation, which the sub-percent
    forward error of quantised staging barely moves.

    ``adaptive`` (the "auto" policy) measures instead of assuming: layer 0
    stages raw and layer 1 int8, each timed up to a device synchronise,
    and the cheaper way stages the rest; when int8 wins, layer 2 tries
    int4 too. ``stats_out`` gets ``prepass_s``, the probe's seconds and
    the chosen dtype, and accumulates ``staged_bytes``.

    Runs on ``device`` (default ``config.device``, else "cuda").
    """
    dev = resolve_device(device if device is not None else (config.device if config is not None else "cuda"))
    if config is not None:
        _checkpoint_every(config)
    return _bi_sweep(
        spec, params, batches, _resolve_attn(attn_impl, dev), stats_out, stage_dtype, adaptive, dev,
        _PinnedStager(dev, stats_out),
    )


def _bi_sweep(spec, params, batches, attn_impl, stats_out, stage_dtype, adaptive, dev, stager) -> List[float]:
    """`stream_bi_sweep` through a given stager (the tap sweep reuses its
    pinned buffers)."""
    with span("modegpt.compress.bi_prepass"):
        t_pre = time.perf_counter()

        def stage_layer(lp, dtype):
            if dtype in ("int8", "int4"):
                return _stage_quantized(lp, dtype, stager, stats_out)
            return stager(lp)

        def timed(lp, dtype):
            t0 = time.perf_counter()
            staged = stage_layer(lp, dtype)
            _sync(dev)
            return staged, time.perf_counter() - t0

        stacks = [
            _embed_batches(spec, _ready(stager(_embed_leaves(spec, params)), dev), g, dev)
            for g in _group_batches(batches)
        ]
        n_seq = sum(int(b.shape[0]) for b in batches)
        bi = np.zeros(spec.n_layers, dtype=np.float64)

        if adaptive and stage_dtype in ("int8", "int4") and spec.n_layers >= 3:
            # measure the stagings on real layers, then stage the rest the
            # cheapest way; the probed layers keep the staging they got
            staged0, t_raw = timed(params["layers"][0], "bf16")
            staged1, t_q = timed(params["layers"][1], "int8")
            probe = {"bf16": t_raw, "quantized": t_q}
            prestaged = {0: staged0, 1: staged1}
            if t_raw <= t_q:
                stage_dtype = "bf16"
            elif spec.n_layers >= 4:
                prestaged[2], t_q4 = timed(params["layers"][2], "int4")
                probe["quantized_int4"] = t_q4
                stage_dtype = "int4" if t_q4 < t_q else "int8"
            if stats_out is not None:
                stats_out["bi_stage_probe_s"] = probe
                stats_out["bi_stage_dtype"] = stage_dtype
            logger.info("BI prepass staging probe: %s -> %s", probe, stage_dtype)
        else:
            prestaged = {0: stage_layer(params["layers"][0], stage_dtype)}

        staged = prestaged.pop(0)
        for l in range(spec.n_layers):
            lp = _ready(staged, dev)
            if l + 1 < spec.n_layers:  # the next layer's copy overlaps this layer's forward
                staged = prestaged.pop(l + 1, None) or stage_layer(params["layers"][l + 1], stage_dtype)
            for i in range(len(stacks)):
                _, bi_l = _stream_layer_step(spec, l, lp, stacks[i], False, attn_impl, "highest")
                bi[l] += float(bi_l)
            del lp
            logger.info("BI prepass: layer %d/%d done", l + 1, spec.n_layers)
        if stats_out is not None:
            stats_out["prepass_s"] = time.perf_counter() - t_pre
        return (bi / n_seq).tolist()


def stream_calibrate_solve(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    config: CompressionConfig,
    order: str = "mlp,qk,vo",
    keep_ratios: Optional[np.ndarray] = None,
    on_window=None,
    target_layers: Optional[Sequence[int]] = None,
    stats_out: Optional[Dict] = None,
    release_params: bool = False,
    device: Optional[DeviceLike] = None,
) -> Tuple[Dict[str, Dict[int, Dict]], List[float], np.ndarray]:
    """Calibrate and solve every layer in one streamed sweep.

    Args:
      params: the parameter tree; ``params["layers"][l]`` leaves on the CPU
        are host-staged when the sweep runs on a card, leaves on the
        compute device are resident.
      keep_ratios: per-layer keep ratios; None runs the BI prepass and
        allocates (reference: compression_utils.py:79).
      on_window: optional ``(layers, factors)`` callback as each window's
        factors land (incremental persistence).
      target_layers: layers to solve (default all). The others still run
        their forwards but take no taps: a resumed sweep skips solved
        layers' Grams.
      release_params: MUTATES ``params``: as each window's factors land,
        pop the dense projections they replace (`_release_solved`), so
        device memory (resident) or host memory (staged) shrinks as the
        sweep advances instead of holding the dense model until surgery.
      device: where the sweep computes (default ``config.device``).

    Returns (factors, bi_scores, keep_ratios); factors keyed
    ``[suffix][layer]``: host numpy under ``config.stream_fetch="host"``,
    kernel factors as device tensors in the model's dtype under
    ``"device"`` (resident weights only: surgery then consumes them on
    the card, with no copy to the host).

    ``stats_out`` receives the phase split: ``stage_s`` (main-thread
    seconds staging), ``sweep_s`` (forwards, synchronised per layer by
    the BI read), ``flush_run_s`` (the solves, overlapping the sweep when
    async), ``flush_wait_s`` (main-thread seconds waiting on flushes),
    ``staged_bytes``, ``fetched_bytes`` (solved factors moved to the
    host), ``factor_bytes``, ``async_flush``, ``flush_depth``,
    ``oom_retries`` and the prepass's keys.
    """
    from modegpt_tpu_torch.compress import batched as batched_mod
    from modegpt_tpu_torch.ops.allocation import allocate_keep_ratios

    dev = resolve_device(config.device if device is None else device)
    attn_impl = _resolve_attn("auto" if config.use_flash_attention else "xla", dev)
    width = max(1, min(config.layers_per_step, spec.n_layers))
    targets = set(range(spec.n_layers)) if target_layers is None else set(target_layers)
    _checkpoint_every(config)

    host_staged = _host_staged(params, dev)
    fetch_mode = config.stream_fetch
    if fetch_mode == "device" and host_staged:
        raise ValueError(
            "stream_fetch='device' requires device-resident weights: a host-staged sweep exists "
            "because the model does not fit on the card, and device factors (~keep_ratio x the "
            "model's bytes) would fill it again"
        )

    stager = _PinnedStager(dev, stats_out)
    bi_scores: List[float]
    if keep_ratios is None:
        # "auto" considers int8 staging exactly when the prepass copies
        # weights to a card, and then measures before committing
        bi_dtype, adaptive = config.bi_stage_dtype, False
        if bi_dtype == "auto":
            bi_dtype, adaptive = ("int8", True) if host_staged else ("bf16", False)
        if stats_out is not None:
            stats_out["bi_stage_dtype"] = bi_dtype
        bi_scores = _bi_sweep(spec, params, batches, attn_impl, stats_out, bi_dtype, adaptive, dev, stager)
        keep_ratios, _ = allocate_keep_ratios(
            bi_scores, config.compression_ratio,
            smoothing=config.sparsity_smoothing, max_sparsity=config.max_sparsity,
        )
    else:
        bi_scores = []
    keep_ratios = np.asarray(keep_ratios)

    # the embedding is dead once the stacks exist: a host-staged copy is
    # dropped here (resident callers keep theirs through ``params``)
    stacks = [
        _embed_batches(spec, _ready(stager(_embed_leaves(spec, params)), dev), g, dev)
        for g in _group_batches(batches)
    ]
    n_seq = sum(int(b.shape[0]) for b in batches)
    seq_len = int(batches[0].shape[1])
    total_tokens = n_seq * seq_len

    # Async window flush (JAX offload.py:969-1022): dense windows solve
    # on one worker thread while the main thread runs the next layers'
    # forwards, at most ``flush_depth`` windows in flight. Torch work on
    # the worker runs on the device's default stream, as the sweep's
    # does, so the two are ordered (correct, but serialised on the card).
    # Only host fetches go async ("auto": only host-staged sweeps, when
    # the coarse memory estimate fits); MoE windows always flush in line.
    layer_bytes = sum(t.numel() * t.element_size() for t in _leaves(params["layers"][0]))
    stack_bytes = sum(s.numel() * s.element_size() for s in stacks)
    use_async = fetch_mode == "host" and (
        config.stream_async_flush == "on"
        or (
            config.stream_async_flush == "auto"
            and host_staged
            and _async_flush_fits(spec, layer_bytes, stack_bytes, width, _device_hbm_bytes())
        )
    )
    flush_depth = int(config.stream_flush_depth or 0)
    if flush_depth == 0:
        # auto: one more window ahead of the drain only when a known
        # budget says its taps fit beside the solve's workspace
        hbm = _device_hbm_bytes()
        flush_depth = (
            2 if use_async and hbm and _async_flush_fits(spec, layer_bytes, stack_bytes, width, hbm, depth=2)
            else 1
        )

    fetched_at_start = batched_mod.FETCHED_BYTES.total
    executor = ThreadPoolExecutor(max_workers=1) if use_async else None
    pending: List = []
    timing = {"flush_wait_s": 0.0, "flush_run_s": 0.0, "stage_s": 0.0, "sweep_s": 0.0}
    oom_retries = 0

    def stage_timed(lp):
        t0 = time.perf_counter()
        out = stager(lp)
        timing["stage_s"] += time.perf_counter() - t0
        return out

    bi_pass = np.zeros(spec.n_layers, dtype=np.float64)
    factors: Dict[str, Dict[int, Dict]] = {}
    window_taps: Dict[int, Dict] = {}
    window_lp: Dict[int, Dict] = {}

    def merge(chunks: Dict[str, Dict[int, Dict]]):
        for s, by_layer in chunks.items():
            factors.setdefault(s, {}).update(by_layer)

    def retry_after_oom(run):
        """Run a flush that ran out of device memory once more, with the
        card otherwise quiet and the allocator's cached blocks returned."""
        nonlocal oom_retries
        oom_retries += 1
        logger.warning("window flush ran out of device memory; retrying once after empty_cache")
        _sync(dev)
        torch.cuda.empty_cache()
        merge(run())

    def drain(keep: int = 0):
        """Block until at most ``keep`` flushes remain in flight. A flush
        that ran out of memory on the worker is retried in line: every
        newer flush is collected first (nothing races the retry's
        workspace), async is off for the rest of the sweep (the estimate
        was optimistic), then the failed windows solve again one at a
        time from their taps, which a solve does not consume."""
        nonlocal use_async
        while len(pending) > keep:
            fut, run = pending.pop(0)
            t0 = time.perf_counter()
            failed = []
            try:
                merge(fut.result())
            except torch.cuda.OutOfMemoryError:
                failed.append(run)
            if failed:
                use_async = False
                logger.warning("async window flush ran out of device memory; going synchronous")
                while pending:
                    fut2, run2 = pending.pop(0)
                    try:
                        merge(fut2.result())
                    except torch.cuda.OutOfMemoryError:
                        failed.append(run2)
                for run_f in failed:
                    retry_after_oom(run_f)
            timing["flush_wait_s"] += time.perf_counter() - t0

    def flush_window():
        layers = sorted(window_taps)
        moe_layers = [l for l in layers if spec.is_moe_layer(l)]
        inv = 1.0 / total_tokens

        def scaled(l, key):  # in place: the sum and its scaled copy never coexist
            return window_taps[l].pop(key).mul_(inv)

        calib = CalibrationResult(
            cov_mlp={l: scaled(l, "cov_mlp") for l in layers},
            cov_q={l: scaled(l, "cov_q") for l in layers},
            cov_k={l: scaled(l, "cov_k") for l in layers},
            cov_x={l: scaled(l, "cov_x") for l in layers},
            bi_scores=list(bi_scores),
            n_sequences=n_seq,
            total_tokens=total_tokens,
            cov_shared={l: scaled(l, "cov_shared") for l in moe_layers if "cov_shared" in window_taps[l]},
        )
        # a mixed window reports each kind to on_window as its own group
        groups = [g for g in (moe_layers, [l for l in layers if l not in moe_layers]) if g]
        wlp = dict(window_lp)
        # the host trees the solve gathers selection rows from; taken now,
        # as release_params pops their leaves after the solve
        host_view = {l: params["layers"][l] for l in layers} if host_staged else None
        solved: Dict[str, Dict[int, Dict]] = {}

        def run() -> Dict[str, Dict[int, Dict]]:
            """Solve the window layer by layer. A layer's staged leaves
            are popped only once all its factors are in ``solved``
            (``scratch_params``), so a retry after running out of memory
            resumes at the layer that failed."""
            t_run = time.perf_counter()
            for g in groups:
                for l in g:
                    if any(l in by_layer for by_layer in solved.values()):
                        continue
                    chunk = batched_mod.solve_chunk_batched(
                        spec, {"layers": wlp}, [l], keep_ratios, calib, config, order,
                        fetch=fetch_mode, scratch_params=True, host_params=host_view,
                    )
                    for s, by_layer in chunk.items():
                        solved.setdefault(s, {}).update(by_layer)
                if on_window is not None:
                    on_window(g, {s: {l: by_layer[l] for l in g} for s, by_layer in solved.items()})
            if release_params:
                _release_solved(spec, params, solved)
            timing["flush_run_s"] += time.perf_counter() - t_run
            return solved

        if use_async and not moe_layers:
            drain(flush_depth - 1)  # bound the windows in flight
        else:
            drain()  # a synchronous flush runs with nothing beside it
        if use_async and not moe_layers:  # (a drained flush may have gone synchronous)
            pending.append((executor.submit(run), run))
        else:
            t0 = time.perf_counter()
            try:
                merge(run())
            except torch.cuda.OutOfMemoryError:
                retry_after_oom(run)
            timing["flush_wait_s"] += time.perf_counter() - t0
            logger.info("window %s flushed in %.1fs", layers, time.perf_counter() - t0)
        window_taps.clear()
        window_lp.clear()

    try:
        staged = stage_timed(params["layers"][0])
        for l in range(spec.n_layers):
            lp = _ready(staged, dev)
            collect = l in targets
            # MoE windows hold [E, d_int, d_int] taps, and a synchronous
            # flush is chosen exactly when memory is tight: there the next
            # layer's copy waits until the flush is done. One predicate
            # serves the deferral and the flush below.
            will_flush = len(window_taps) + (1 if collect else 0) >= width or l == spec.n_layers - 1
            defer = will_flush and (spec.is_moe_layer(l) or not use_async)
            if l + 1 < spec.n_layers and not defer:
                staged = stage_timed(params["layers"][l + 1])  # overlaps this layer's forward
            t_sweep = time.perf_counter()
            taps_l = None
            for i in range(len(stacks)):
                taps, bi_l = _stream_layer_step(spec, l, lp, stacks[i], collect, attn_impl, config.gram_precision)
                bi_pass[l] += float(bi_l)
                if collect:
                    taps_l = taps if taps_l is None else {k: taps_l[k] + taps[k] for k in taps_l}
            timing["sweep_s"] += time.perf_counter() - t_sweep
            if collect:
                window_taps[l] = taps_l
                window_lp[l] = _slim_window_lp(spec, l, lp, host_staged, config)
            del lp, taps_l
            logger.info("streamed sweep: layer %d/%d done", l + 1, spec.n_layers)
            if will_flush and window_taps:
                flush_window()
            if l + 1 < spec.n_layers and defer:
                staged = stage_timed(params["layers"][l + 1])
        drain()
    finally:
        if executor is not None:
            executor.shutdown(wait=True)

    if not bi_scores:
        bi_scores = (bi_pass / n_seq).tolist()
    if stats_out is not None:
        stats_out.update(timing)
        stats_out["async_flush"] = use_async
        stats_out["flush_depth"] = flush_depth if use_async else 0
        stats_out["fetch"] = fetch_mode
        stats_out["oom_retries"] = oom_retries
        stats_out["fetched_bytes"] = batched_mod.FETCHED_BYTES.total - fetched_at_start
        stats_out["factor_bytes"] = sum(
            a.nbytes
            for by_layer in factors.values()
            for f in by_layer.values()
            for a in f.values()
            if isinstance(a, np.ndarray)
        )
    logger.info(
        "streamed calibrate+solve: %d layers, %d sequences x %d tokens, width %d, async_flush=%s "
        "(main-thread flush wait %.2fs)",
        spec.n_layers, n_seq, seq_len, width, use_async, timing["flush_wait_s"],
    )
    return factors, bi_scores, keep_ratios
