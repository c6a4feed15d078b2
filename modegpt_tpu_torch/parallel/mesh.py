"""Process meshes, tensor-parallel parameter sharding and collectives.

Port of ``modegpt_tpu.parallel.mesh`` onto ``torch.distributed``. The
JAX package builds one ``jax.sharding.Mesh`` over the devices of one
program and lets GSPMD place every array and insert every collective.
Here the design is SPMD over processes: one process per rank, launched
by ``python -m torch.distributed.run`` (torchrun) or any launcher that
sets ``RANK`` and ``WORLD_SIZE``; every rank runs the same job on its
shard and calls the collectives below explicitly.

* ``data`` axis: calibration and evaluation rows are split over it
  (`shard_batch`); Gram sums and NLL sums are all-reduced over it.
* ``model`` axis: Megatron tensor parallelism (`param_shardings`):
  column-parallel q/k/v/up/gate, row-parallel o/down with one
  all-reduce each, expert stacks split by whole experts; or, with
  ``shard_sequence``, the calibration sequence split over it. Serving
  (`shard_serving`) cuts the padded stack the same way and the K/V
  pools by kv head.
* ``stage`` axis: the GPipe pipeline of `parallel.pp`.
* ``context`` axis: the ring attention of `parallel.ring`.

The mesh is the port's own small class (`Mesh`): the axis names and
sizes, this rank's coordinates and one process subgroup per axis, made
with ``dist.new_group`` in the same order on every rank. Ranks are laid
out row-major over the axes, as the JAX mesh lays out its devices.
Under SPMD the world size must EQUAL the product of the axes; the JAX
package takes the first N of more devices, the port raises.

Backends: NCCL when every rank has a card of its own
(``LOCAL_RANK < device_count()``, the rank's device ``cuda:LOCAL_RANK``).
Ranks that share a card (or run on the CPU) use gloo, and on a card
only when asked for explicitly (``MODEGPT_DIST_BACKEND=gloo``); more
ranks than cards otherwise raises. Under gloo a CUDA tensor is staged
through host memory by the collective helpers, explicitly; under NCCL
a CUDA tensor is used where it lies and a CPU tensor (the float64
host accumulators) is moved to the rank's card for the collective.
Every collective runs under the process group's timeout, so a dead
peer fails the run instead of hanging it.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "maybe_initialize_distributed",
    "rank_device",
    "parse_mesh_shape",
    "make_mesh",
    "shard_batch",
    "param_shardings",
    "shard_serving",
    "all_reduce",
    "all_gather",
    "reduce_to",
    "ring_shift",
    "send_to",
    "recv_from",
    "gather_objects",
]

DEFAULT_TIMEOUT_S = 600.0


def maybe_initialize_distributed(device: Union[str, torch.device] = "cuda") -> bool:
    """Join the process group when this process is one rank of a
    launched job; a no-op returning False on a single process.

    Gated as the JAX package gates ``jax.distributed.initialize``: by
    ``MODEGPT_DISTRIBUTED=1``, or by torchrun's ``WORLD_SIZE`` and
    ``RANK``. The rank and world size come from those variables; the
    rendezvous from ``MODEGPT_DIST_INIT_METHOD`` (e.g. ``file:///tmp/rdv``;
    default ``env://``: torchrun's ``MASTER_ADDR``/``MASTER_PORT``), the
    timeout of every collective from ``MODEGPT_DIST_TIMEOUT`` (seconds,
    default 600).

    ``device`` is the job's device type. On the CPU the backend is gloo.
    On CUDA it is NCCL, each rank on ``cuda:LOCAL_RANK``, which must
    exist: more ranks than cards raises. gloo on CUDA (ranks sharing a
    card, ``cuda:LOCAL_RANK % device_count()``) only when
    ``MODEGPT_DIST_BACKEND=gloo`` asks for it; gloo is never picked
    silently.
    Idempotent: True when the group already exists.
    """
    env = os.environ
    want = env.get("MODEGPT_DISTRIBUTED", "") == "1" or ("WORLD_SIZE" in env and "RANK" in env)
    if not want:
        return False
    if dist.is_initialized():
        return True
    rank, world = int(env.get("RANK", "0")), int(env.get("WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    kind = torch.device(device).type
    backend = (env.get("MODEGPT_DIST_BACKEND", "") or ("gloo" if kind == "cpu" else "nccl")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"distributed backend must be nccl or gloo, got {backend!r}")
    if kind == "cpu" and backend != "gloo":
        raise ValueError("a CPU job needs the gloo backend; NCCL runs on CUDA devices only")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a distributed CUDA job was asked for but CUDA is not available")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({n_cards} visible): NCCL needs one "
                "card per rank. To let ranks share cards, ask for gloo explicitly "
                "(MODEGPT_DIST_BACKEND=gloo)"
            )
        torch.cuda.set_device(local_rank % n_cards)
    timeout = float(env.get("MODEGPT_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        backend,
        init_method=env.get("MODEGPT_DIST_INIT_METHOD") or "env://",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return True


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """This rank's device for a job asked to run on ``device``: under a
    distributed CUDA job the card `maybe_initialize_distributed` bound
    the rank to, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def parse_mesh_shape(mesh_shape: str) -> Dict[str, int]:
    """Parse "data:4,model:2" into {"data": 4, "model": 2}."""
    out: Dict[str, int] = {}
    if not mesh_shape:
        return out
    for part in mesh_shape.split(","):
        name, _, size = part.partition(":")
        out[name.strip()] = int(size)
    return out


class Mesh:
    """This rank's view of a process mesh: the axes (name -> size, in
    order), its coordinate on each, its global rank, its device, the
    backend, and one subgroup per axis of size > 1 (the ranks that share
    every other coordinate). Axes not in the mesh have size 1 and
    coordinate 0.

    ``comm_seconds`` and ``comm_bytes`` add up this rank's collectives
    (the helpers below; axes of size 1 move nothing): host-clock seconds
    inside them, which under gloo include the staging copies and the
    transfer itself, and under NCCL only what the host waits for; bytes
    of the tensors this rank contributed."""

    def __init__(self, axes: Dict[str, int], device: torch.device):
        self.axes = dict(axes)
        self.axis_names = tuple(self.axes)
        self.device = torch.device(device)
        self.initialized = dist.is_initialized()
        self.rank = dist.get_rank() if self.initialized else 0
        self.backend = dist.get_backend() if self.initialized else "none"
        sizes = tuple(self.axes.values())
        layout = np.arange(math.prod(sizes)).reshape(sizes)
        self.coords = {name: int(c) for name, c in zip(self.axis_names, np.argwhere(layout == self.rank)[0])}
        self.comm_seconds = 0.0
        self.comm_bytes = 0
        self._groups: Dict[str, Tuple[object, List[int]]] = {}
        for i, name in enumerate(self.axis_names):
            if sizes[i] == 1:
                continue
            lines = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
            for line in lines:  # every rank makes every group, in one order
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = (group, ranks)

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """(process group, its global ranks in coordinate order) of this
        rank's line along ``axis``."""
        return self._groups[axis]

    @contextlib.contextmanager
    def counted(self, *tensors: torch.Tensor):
        """Add the block's host seconds and ``tensors``' bytes to the
        rank's collective counters. Under gloo the card is drained first
        (the staging copy would wait for it anyway), so the seconds are
        the collective's own."""
        if self.backend == "gloo" and any(t.is_cuda for t in tensors):
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.comm_seconds += time.perf_counter() - t0
            self.comm_bytes += sum(t.numel() * t.element_size() for t in tensors)

    def barrier(self) -> None:
        if not self.initialized:
            return
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, rank={self.rank}, coords={self.coords}, backend={self.backend}, device={self.device})"


def make_mesh(mesh_shape: str = "", device: Union[str, torch.device] = "cuda") -> Optional[Mesh]:
    """Build this rank's `Mesh` from a "name:size,..." spec, or None for
    "" (single-device execution: meshes are explicit opt-in, as in the
    JAX package). The world size must equal the product of the axes (a
    mesh of one rank also runs without a process group)."""
    axes = parse_mesh_shape(mesh_shape)
    if not axes:
        return None
    total = math.prod(axes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if total != world:
        raise ValueError(
            f"mesh {axes} needs {total} ranks but the world size is {world}: run one process per "
            f"rank (python -m torch.distributed.run --nproc_per_node {total} ...)"
        )
    return Mesh(axes, rank_device(device))


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a [B, ...] batch along the ``data`` axis
    (numpy or tensor). B must divide the axis."""
    n = mesh.size("data")
    B = batch.shape[0]
    if B % n:
        raise ValueError(f"batch size {B} must divide the data axis ({n})")
    step = B // n
    c = mesh.coord("data")
    return batch[c * step : (c + 1) * step]


# ---- collectives ----


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: gloo works on host memory (a
    CUDA tensor is copied there), NCCL on the rank's card (a CPU tensor
    is copied there)."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.cpu()
    if mesh.backend == "nccl" and not t.is_cuda:
        return t.to(mesh.device)
    return t.contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(mesh: Mesh, t: torch.Tensor, axes: Union[str, Sequence[str]], op: str = "sum") -> torch.Tensor:
    """Sum (or, with ``op="max"``, maximum) of ``t`` over the ranks of
    each axis in ``axes`` (axes of size 1 skipped); a tensor on ``t``'s
    device."""
    for axis in (axes,) if isinstance(axes, str) else tuple(axes):
        if mesh.size(axis) == 1:
            continue
        with mesh.counted(t):
            buf = _staged(mesh, t)
            if buf is t:
                buf = t.clone()
            dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axis)[0])
            t = buf.to(t.device)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in
    coordinate order (every rank's ``t`` of one shape)."""
    if mesh.size(axis) == 1:
        return t
    with mesh.counted(t):
        buf = _staged(mesh, t)
        parts = [torch.empty_like(buf) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, buf, group=mesh.group(axis)[0])
        return torch.cat(parts, dim=dim).to(t.device)


def reduce_to(mesh: Mesh, t: torch.Tensor, axis: str, owner: int) -> Optional[torch.Tensor]:
    """Sum of ``t`` over ``axis`` delivered to the rank at coordinate
    ``owner`` on it; None on the others."""
    if mesh.size(axis) == 1:
        return t
    group, ranks = mesh.group(axis)
    with mesh.counted(t):
        buf = _staged(mesh, t)
        if buf is t:
            buf = t.clone()
        dist.reduce(buf, dst=ranks[owner], group=group)
        return buf.to(t.device) if mesh.coord(axis) == owner else None


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(buf[at : at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def ring_shift(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """Every rank sends ``tensors`` to its next neighbour on ``axis``
    (coordinate + 1, wrapping) and receives its previous neighbour's,
    in one message (``dist.batch_isend_irecv``); the tensors of one
    rank and its neighbours share shapes and dtype. JAX ``lax.ppermute``
    with ``[(i, (i + 1) % N)]``."""
    n = mesh.size(axis)
    if n == 1:
        return list(tensors)
    group, ranks = mesh.group(axis)
    c = mesh.coord(axis)
    with mesh.counted(*tensors):
        send = _staged(mesh, _flat(tensors))
        recv = torch.empty_like(send)
        ops = [
            dist.P2POp(dist.isend, send, ranks[(c + 1) % n], group=group),
            dist.P2POp(dist.irecv, recv, ranks[(c - 1) % n], group=group),
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return _unflat(recv.to(tensors[0].device), tensors)


def send_to(mesh: Mesh, t: torch.Tensor, axis: str, coord: int) -> None:
    """Send ``t`` to the rank at ``coord`` on ``axis`` (blocking)."""
    group, ranks = mesh.group(axis)
    with mesh.counted(t):
        dist.send(_staged(mesh, t), dst=ranks[coord], group=group)


def recv_from(mesh: Mesh, like: torch.Tensor, axis: str, coord: int) -> torch.Tensor:
    """Receive a tensor shaped and typed as ``like`` from the rank at
    ``coord`` on ``axis``; it lands on ``like``'s device."""
    group, ranks = mesh.group(axis)
    with mesh.counted(like):
        buf = _staged(mesh, torch.empty_like(like))
        dist.recv(buf, src=ranks[coord], group=group)
        return buf.to(like.device)


def gather_objects(mesh: Mesh, obj, axis: str, owner: int = 0) -> Optional[list]:
    """The picklable ``obj`` of every rank on ``axis`` as a list in
    coordinate order at the rank at ``owner``; None on the others."""
    if mesh.size(axis) == 1:
        return [obj]
    group, ranks = mesh.group(axis)
    out = [None] * len(ranks) if mesh.coord(axis) == owner else None
    with mesh.counted():
        dist.gather_object(obj, out, dst=ranks[owner], group=group)
    return out


# ---- parameter sharding ----


_COLUMN = ("q", "k", "v", "up", "gate")  # split on the out axis (-1)
_ROW = ("o", "down")  # split on the in axis (-2)
_CODES = ("kernel", "kernel_q", "kernel_qa")


def _split(t: torch.Tensor, dim: int, n: int, c: int, what: str) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"{what}: dimension {t.shape[dim]} does not divide the model axis ({n})")
    step = t.shape[dim] // n
    return t.narrow(dim, c * step, step)


def _owned(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A shard view copied to ``dev`` into memory of its own (the full
    tensor is not kept alive through it), in its source's layout:
    column-major int8 codes (`models.forward.column_major`, what the
    card's int8 GEMM takes without a copy) stay column-major."""
    col_major = t.dim() >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1
    src = t.transpose(-1, -2) if col_major else t
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    out.copy_(src)
    return out.transpose(-1, -2) if col_major else out


def _tree_to(t, dev: torch.device):
    if isinstance(t, dict):
        return {k: _tree_to(v, dev) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_to(v, dev) for v in t]
    return t.to(dev) if isinstance(t, torch.Tensor) else t


def _shard_layers(mesh: Mesh, spec, layers: Dict, lead: int, dev: torch.device) -> Dict:
    """The Megatron layout of one layer's leaves (``lead`` = 0: a layer
    dict of the unrolled tree) or of the padded stack's ``[L, ...]``
    leaves (``lead`` = 1, every rule one axis right), cut to this rank's
    shard on the mesh's ``model`` axis and placed on ``dev``. Negative
    axes serve both: q/k/v/up/gate split their out axis (-1; codes,
    per-out-channel ``scale`` and bias alike), o/down their in axis (-2;
    scale and bias replicated: the row-parallel bias is added once, after
    the reduction); expert stacks ``[(L,) E, ., .]`` split their expert
    axis when ``n_experts`` divides the model axis (expert parallelism:
    E/n whole experts a rank, scales with them) and are replicated
    otherwise; the shared expert takes the column/row split; everything
    else (norms, router, shared_gate, rotary masks, q/k norm weights) is
    replicated, as in the JAX layout."""
    n, c = mesh.size("model"), mesh.coord("model")

    def rep(t):
        return _tree_to(t, dev)

    def cut(t, dim, what):
        return _owned(_split(t, dim, n, c, what), dev)

    def linear(sub, name, col: bool):
        out = {}
        for key, t in sub.items():
            what = f"{name}.{key}"
            if key in _CODES:
                if col and t.dtype == torch.uint8 and (sub["scale"].shape[-1] // n) % 2:
                    raise ValueError(f"{what}: packed int4 codes split on whole bytes; each rank's "
                                     f"{sub['scale'].shape[-1] // n} columns must be even")
                out[key] = cut(t, -1 if col else -2, what)
            elif key in ("scale", "bias"):
                out[key] = cut(t, -1, what) if col else rep(t)
            else:
                raise ValueError(f"modegpt_tpu_torch.parallel.mesh: unknown projection leaf {what}")
        return out

    out = {}
    for name, sub in layers.items():
        if name in _COLUMN or name in _ROW:
            out[name] = linear(sub, name, col=name in _COLUMN)
        elif name == "experts" and spec.n_experts % n == 0:
            out[name] = {k: {key: cut(t, lead, f"experts.{k}.{key}") if key != "bias" else rep(t)
                             for key, t in v.items()} for k, v in sub.items()}
        elif name == "shared":
            out[name] = {k: linear(v, f"shared.{k}", col=k != "down") for k, v in sub.items()}
        else:
            out[name] = rep(sub)
    return out


def param_shardings(mesh: Mesh, spec, params: Dict, device: Optional[torch.device] = None) -> Dict:
    """This rank's parameter tree under the mesh's ``model`` axis: the
    JAX ``param_shardings`` Megatron layout (``mesh.py:110-171``),
    applied to the full tree (the output of the port's weight
    conversion):

      q/k/v kernel [d, H*hd] and bias  -> column-parallel: this rank's heads
      up/gate      [d, d_int] and bias -> column-parallel: its d_int slice
      o kernel     [H*hd, d]           -> row-parallel: its heads' rows
      down         [d_int, d]          -> row-parallel: its d_int rows
      experts      [E, ., .]           -> expert-parallel: E/n whole experts
                                          (replicated when n does not divide E)
      shared expert                    -> column/row split, as a dense MLP
      o/down bias, norms, embeddings,
      router, rotary masks, LM head    -> replicated (the row-parallel bias
                                          is added once, after the reduction)

    A quantised projection's codes (``kernel_q``, ``kernel_qa``) split like
    the kernel they replace, its per-out-channel ``scale`` with the out
    axis (cut for column-parallel, replicated for row-parallel). Each leaf
    lands on ``device`` (default the mesh's); only the rank's shard is
    copied there. Without a ``model`` axis > 1 the tree is the full one,
    on ``device``. ``models.forward`` reads the local head and expert
    counts from the sharded widths, and this rank's rows of a replicated
    rotary mask from its coordinate."""
    dev = mesh.device if device is None else torch.device(device)
    if mesh.size("model") == 1:
        return _tree_to(params, dev)
    return {k: ([_shard_layers(mesh, spec, lp, 0, dev) for lp in v] if k == "layers" else _tree_to(v, dev))
            for k, v in params.items()}


def shard_serving(mesh: Mesh, pm, state):
    """This rank's serving stack over the mesh's ``model`` axis (JAX
    ``mesh.py:174-258``): returns ``(PaddedModel, ServeState)``.

    The padded stack's ``[L, ...]`` leaves take `param_shardings`' layout
    shifted one axis right (L leads, whole on every rank); the K/V pools
    ``[L, slots, Hk, max_len, R]`` and the int8 KV scales
    ``[L, slots, Hk, max_len]`` keep this rank's Hk/n kv heads, matching
    the k/v projections, so the cache writes and the ragged attention
    (K3 on the rank's own heads) stay local: the o and down reductions
    are a layer's only collectives. Lengths (host), last tokens,
    ``q_hd_true`` and ``other`` (embeddings, final norm, LM head) are
    replicated. Without a ``model`` axis > 1 everything is replicated on
    the mesh's device. The model records the mesh (``pm.mesh``), which
    the step functions hand to the layers. n_kv_heads must divide by
    the model axis (head-sharded attention)."""
    dev = mesh.device
    n = mesh.size("model")
    if n > 1 and pm.spec.n_kv_heads % n != 0:
        raise ValueError(
            f"serving TP needs n_kv_heads ({pm.spec.n_kv_heads}) divisible by the model axis ({n})"
        )
    layers = _shard_layers(mesh, pm.spec, pm.layers, 1, dev) if n > 1 else _tree_to(pm.layers, dev)
    pm = pm._replace(layers=layers, other=_tree_to(pm.other, dev), q_hd_true=pm.q_hd_true.to(dev), mesh=mesh)

    def pool(t):
        if t is None:
            return None
        return _owned(_split(t, 2, n, mesh.coord("model"), "kv pool"), dev) if n > 1 else t.to(dev)

    state = state._replace(
        cache_k=pool(state.cache_k), cache_v=pool(state.cache_v), lengths=np.array(state.lengths),
        last_token=state.last_token.to(dev), k_scale=pool(state.k_scale), v_scale=pool(state.v_scale),
    )
    return pm, state
