"""JAX and the JAX package are told apart by whole top-level names, and
the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from tiny_cells import ROOT

from perfbench import harness


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_loaded({"modegpt_tpu_torch": 1, "modegpt_tpu_torch.models.serving": 1,
                                     "jaxtyping": 1, "modegpt_tpu_tools": 1}) == []
    assert harness.forbidden_loaded({"jax.numpy": 1, "modegpt_tpu.ops": 1, "flax": 1, "jaxlib.xla": 1}) == \
        ["flax", "jax", "jaxlib", "modegpt_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "perfbench", "reference")
    names = [n for f in os.listdir(ref) if f.endswith(".py") for n in _imports(os.path.join(ref, f))]
    assert names
    assert all(n.split(".")[0] not in ("modegpt_tpu_torch", "modegpt_tpu", "jax", "jaxlib", "flax") for n in names)
    assert all(not n.startswith("perfbench.") or n.startswith("perfbench.reference") for n in names)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.argv = ['x']\n"
        "from tiny_cells import compress_cell, serve_cell, context\n"
        "from perfbench import harness\n"
        "from perfbench.drivers import compress_job, serve_loop\n"
        "compress_job.run(context(compress_cell()))\n"
        "serve_loop.run(context(serve_cell()))\n"
        "print('LOADED', harness.forbidden_loaded())\n"
    ) % os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, USE_FLAX="0", USE_TF="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
