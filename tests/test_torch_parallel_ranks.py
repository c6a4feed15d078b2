"""The launcher of the port's SPMD tests, and what each rank runs.

No tests here. `Launch` starts one process per rank (a plain subprocess
of ``sys.executable`` with ``RANK``, ``WORLD_SIZE`` and
``MODEGPT_DIST_*`` set, a ``file://`` rendezvous in the work directory,
gloo, a 120 s collective timeout), for `tests/test_torch_parallel.py`
(on the CPU) and `tests/test_torch_cuda.py` (ranks sharing the card).
Run as a script, a rank::

    python tests/test_torch_parallel_ranks.py <workdir> [cpu|cuda]

joins the group, reads ``<workdir>/inputs.pt`` (cases by name: a kind,
a mesh shape and the kind's inputs, written by the test process), runs
every case on its own mesh of the same world, and writes
``<workdir>/rank<r>.pt``: one result per case. This module imports
torch and the port only, never JAX: the test process computes any JAX
side.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Launch:
    """``world`` ranks of ``argv`` (arguments to ``sys.executable``),
    started at once from the repository root; `wait` waits for them
    (``timeout`` seconds from the start, 120 by default, which also
    bounds every collective), kills any left, fails with every rank's log
    tail if one failed, and returns the logs; `outputs` returns the
    results the ranks script wrote."""

    def __init__(self, world: int, workdir, argv, name: str = "launch", timeout: float = TIMEOUT_S):
        self.world, self.workdir, self.name = world, str(workdir), name
        os.makedirs(self.workdir, exist_ok=True)
        self.logs = [os.path.join(self.workdir, f"{name}.rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            env = dict(
                os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MODEGPT_DISTRIBUTED="1",
                MODEGPT_DIST_BACKEND="gloo", MODEGPT_DIST_INIT_METHOD=f"file://{self.workdir}/{name}.rendezvous",
                MODEGPT_DIST_TIMEOUT=str(timeout), OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                USE_TF="0", USE_FLAX="0",  # a rank's transformers (tokenizers) imports neither
            )
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env, stdout=log,
                                                   stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + timeout
        self._done = False

    def wait(self):
        if not self._done:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self._done = True
        rcs = [p.returncode for p in self.procs]
        if any(rcs):
            tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n" + open(log).read()[-3000:]
                              for r, (rc, log) in enumerate(zip(rcs, self.logs)))
            raise AssertionError(f"{self.name}: ranks exited {rcs}\n{tails}")
        return [open(log).read() for log in self.logs]

    def outputs(self):
        self.wait()
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False) for r in range(self.world)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _np(t):
    return t.detach().to("cpu", torch.float64).numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _stats(res) -> dict:
    out = {field: {l: _np(g) for l, g in getattr(res, field).items()}
           for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "cov_shared")}
    out.update(bi=list(res.bi_scores), n_sequences=res.n_sequences, total_tokens=res.total_tokens)
    return out


def run_forward(mesh, case):
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.parallel.mesh import param_shardings, shard_batch

    local = param_shardings(mesh, case["spec"], case["params"])
    ids = torch.as_tensor(shard_batch(mesh, case["ids"]), device=mesh.device)
    logits, _ = forward(case["spec"], local, ids, attn_impl=case.get("attn_impl", "xla"), mesh=mesh)
    return {"logits": _np(logits)}


def run_calibrate(mesh, case):
    from modegpt_tpu_torch.calib.engine import calibrate
    from modegpt_tpu_torch.parallel.mesh import param_shardings

    params = param_shardings(mesh, case["spec"], case["params"]) if case.get("tp") \
        else _to(case["params"], mesh.device)
    res = calibrate(case["spec"], params, case["batches"], case["targets"], accumulate=case.get("accumulate", "host"),
                    mesh=mesh, shard_sequence=case.get("shard_sequence", False),
                    shard_stats=case.get("shard_stats", False))
    return _stats(res)


def run_calibrate_pp(mesh, case):
    from modegpt_tpu_torch.parallel.pp import calibrate_pp, supports_pp

    assert supports_pp(case["spec"], mesh)
    return _stats(calibrate_pp(case["spec"], case["params"], case["batches"], mesh))


def run_calibrate_ring(mesh, case):
    from modegpt_tpu_torch.parallel.ring import calibrate_ring, supports_ring

    assert supports_ring(case["spec"], mesh)
    return _stats(calibrate_ring(case["spec"], case["params"], case["batches"], case["targets"], mesh))


def run_ring_attention(mesh, case):
    from modegpt_tpu_torch.parallel.ring import ring_attention

    n, c = mesh.size("context"), mesh.coord("context")
    C = case["q"].shape[2] // n
    q, k, v = (torch.as_tensor(case[x][:, :, c * C : (c + 1) * C]) for x in "qkv")
    return {"out": _np(ring_attention(q, k, v, case["scale"], mesh, window=case.get("window")))}


def run_perplexity_pp(mesh, case):
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.parallel.pp import perplexity_pp

    padded = pad_to_uniform(case["spec"], case["params"]) if case.get("padded") else None
    return {"ppl": perplexity_pp(case["spec"], case["params"], case["tokens"], mesh,
                                 batch_size=case["batch_size"], padded=padded)}


def run_compression_case(mesh, case):
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig

    res = run_compression(CompressionConfig(**case["config"], device="cpu"), spec=case["spec"],
                          params=case["params"], mesh=mesh)
    cs = res["compressed_spec"]
    return {
        "ranks": {name: list(getattr(cs, name)) for name in ("q_ranks", "k_ranks", "v_ranks", "o_ranks", "gate_ranks")},
        "baseline_ppl": res.get("baseline_ppl"), "compressed_ppl": res.get("compressed_ppl"),
        "kernels": [{key: _np(lp[key]["kernel"]) for key in ("q", "k", "v", "o", "up", "down")}
                    for lp in res["compressed_params"]["layers"]],
    }


def run_collectives(mesh, case):
    """Every helper of `parallel.mesh` on small tensors, with the values
    they must give checked here."""
    from modegpt_tpu_torch.parallel import mesh as pm

    r = mesh.rank
    n, c = mesh.size("data"), mesh.coord("data")
    t = torch.full((2, 3), float(r + 1))
    summed = pm.all_reduce(mesh, t, "data")
    expect = sum(rank + 1 for rank in mesh.group("data")[1])
    gathered = pm.all_gather(mesh, torch.full((1, 2), float(c)), "data", dim=0)
    reduced = pm.reduce_to(mesh, torch.ones(3), "data", n - 1)
    shifted = pm.ring_shift(mesh, [torch.full((2,), float(c)), torch.full((3, 1), 10.0 * c)], "data")
    objs = pm.gather_objects(mesh, {"c": c}, "data", owner=0)
    checks = {
        "all_reduce": bool(torch.equal(summed, torch.full((2, 3), float(expect)))) and bool(torch.equal(t, torch.full((2, 3), float(r + 1)))),
        "all_gather": bool(torch.equal(gathered[:, 0], torch.arange(n, dtype=torch.float32))),
        "reduce_to": (reduced is None) if c != n - 1 else bool(torch.equal(reduced, torch.full((3,), float(n)))),
        "ring_shift": bool(torch.equal(shifted[0], torch.full((2,), float((c - 1) % n))))
        and bool(torch.equal(shifted[1], torch.full((3, 1), 10.0 * ((c - 1) % n)))),
        "gather_objects": objs == [{"c": i} for i in range(n)] if c == 0 else objs is None,
    }
    return {"checks": checks, "coords": dict(mesh.coords)}


KINDS = {
    "forward": run_forward,
    "calibrate": run_calibrate,
    "calibrate_pp": run_calibrate_pp,
    "calibrate_ring": run_calibrate_ring,
    "ring_attention": run_ring_attention,
    "perplexity_pp": run_perplexity_pp,
    "run_compression": run_compression_case,
    "collectives": run_collectives,
}


def main(workdir: str, device: str = "cpu") -> None:
    from modegpt_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(device)
    import torch.distributed as dist

    cases = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        mesh = make_mesh(case["mesh"], device=device)
        out[name] = dict(KINDS[case["kind"]](mesh, case), coords=dict(mesh.coords))
    torch.save(out, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(*sys.argv[1:])
