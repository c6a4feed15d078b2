"""Parity of the port's mesh paths (`modegpt_tpu_torch.parallel`) with the
JAX package's, on the CPU.

The port runs SPMD: one process per rank. The launcher here starts the
ranks as plain subprocesses of ``sys.executable`` with ``RANK`` and
``WORLD_SIZE`` set, a ``file://`` rendezvous under the test's temporary
directory (no TCP port shared across the xdist workers), the gloo
backend and a 120 s collective timeout; a rank that fails fails the
launch. The ranks run `tests/test_torch_parallel_ranks.py` (torch only,
never JAX) or the port's CLIs. One 4-rank launch runs every library
case, each on its own mesh, while this process computes the JAX side on
the virtual CPU devices `tests/conftest.py` sets up, from the same
numpy inputs and seeded tiny HF models. Tolerances are those of the JAX
package's own `tests/test_parallel.py` for the same comparison.

* the collective helpers, the TP forward (data:2,model:2; olmo2's
  whole-projection q/k norm on model:4) against the unsharded JAX
  forward (JAX's test holds its sharded forward to it at 2e-4);
* Grams and BI of `calibrate` on data:4, tensor-parallel on
  data:2,model:2, with shard_sequence and with shard_stats, of
  `calibrate_pp` on stage:4 and stage:2,data:2 and of `calibrate_ring`
  on context:4 (llama, qwen3, MoE) against JAX's on the same meshes;
* `ring_attention` with and without a window; `perplexity_pp`,
  including a padded compressed model;
* `run_compression` on data:2,model:2, stage:4 and context:4 against
  JAX's on the same mesh: identical rank lists, MLP indices and rotary
  masks, compressed kernels within 2e-4, perplexities within 2e-3;
* both CLIs' ``--mesh_shape`` through the launcher, against one process;
* the error paths: world size against the mesh, more ranks than cards
  under NCCL, experts under a model axis.
"""

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from modegpt_tpu.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu.calib.engine import calibrate as j_calibrate  # noqa: E402
from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.forward import _attention as j_attention  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.parallel import mesh as j_mesh  # noqa: E402
from modegpt_tpu.parallel.pp import calibrate_pp as j_calibrate_pp  # noqa: E402
from modegpt_tpu.parallel.pp import perplexity_pp as j_perplexity_pp  # noqa: E402
from modegpt_tpu.parallel.ring import calibrate_ring as j_calibrate_ring  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from test_torch_parallel_ranks import Launch  # noqa: E402

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_parallel_ranks.py")
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("cov_mlp", "cov_q", "cov_k", "cov_x")


# ---- tiny models (JAX's tests/test_parallel.py shapes) ----


def _llama(seed, layers=2):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=layers,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128,
    )
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _qwen3():
    cfg = transformers.Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, max_position_embeddings=256, tie_word_embeddings=False,
    )
    torch.manual_seed(4)
    return transformers.Qwen3ForCausalLM(cfg).eval()


def _qwen2_moe():
    cfg = transformers.Qwen2MoeConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, moe_intermediate_size=48,
        shared_expert_intermediate_size=96, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_experts=4, num_experts_per_tok=2, max_position_embeddings=256, decoder_sparse_step=1,
        mlp_only_layers=[], norm_topk_prob=False, tie_word_embeddings=False,
    )
    torch.manual_seed(5)
    return transformers.Qwen2MoeForCausalLM(cfg).eval()


def _olmo2():
    cfg = transformers.Olmo2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, max_position_embeddings=128,
    )
    torch.manual_seed(12)
    return transformers.Olmo2ForCausalLM(cfg).eval()


def _both(model):
    """(JAX spec, JAX params, port spec, port params) of one HF model."""
    return (*j_params_from_hf(model), *t_params_from_hf(model, device="cpu"))


def _jmesh(shape):
    axes = j_mesh.parse_mesh_shape(shape)
    return JMesh(np.asarray(jax.devices()[: int(np.prod(list(axes.values())))]).reshape(tuple(axes.values())),
                 tuple(axes))


def _run_config(root, **kw):
    cfg = dict(
        model="mem", dataset="synthetic", calib_size=8, calibs_batch_size=4, seq_len=32, eval_batch_size=4,
        eval_max_samples=8, compression_ratio=0.3, sparsity_smoothing=0.5, solver_precision="f32_device",
        output_dir=f"{root}/o", temp_storage_dir=f"{root}/l", metrics_dir=f"{root}/m",
    )
    cfg.update(kw)
    return cfg


# ---- the 4-rank launch: every library case ----


def _cases(root):
    """(inputs for the ranks by case name, the JAX side's inputs)."""
    rng = np.random.default_rng(0)
    port, jside = {}, {}

    def add(name, kind, mesh, jax_inputs=None, **kw):
        port[name] = dict(kind=kind, mesh=mesh, **kw)
        jside[name] = jax_inputs or {}

    add("collectives_data4", "collectives", "data:4")
    add("collectives_2d", "collectives", "data:2,model:2")

    js, jp, ts, tp = _both(_llama(0))
    ids = rng.integers(0, 128, size=(4, 16)).astype(np.int32)
    add("forward_tp", "forward", "data:2,model:2", dict(spec=js, params=jp), spec=ts, params=tp, ids=ids)
    js, jp, ts, tp = _both(_olmo2())
    add("forward_tp_olmo2", "forward", "model:4", dict(spec=js, params=jp), spec=ts, params=tp, ids=ids)

    js, jp, ts, tp = _both(_llama(1))
    b = load_calibration_batches(None, "synthetic", 8, 4, 32, vocab_size=128)
    add("calib_data4", "calibrate", "data:4", dict(spec=js, params=jp, batches=b, targets=[0, 1]),
        spec=ts, params=tp, batches=b, targets=[0, 1])
    add("calib_tp", "calibrate", "data:2,model:2", dict(spec=js, params=jp, batches=b, targets=[0, 1], tp=True),
        spec=ts, params=tp, batches=b, targets=[0, 1], tp=True, accumulate="device")
    js, jp, ts, tp = _both(_llama(3))
    b = load_calibration_batches(None, "synthetic", 4, 2, 64, vocab_size=128)
    add("calib_shard_sequence", "calibrate", "data:2,model:2",
        dict(spec=js, params=jp, batches=b, targets=[0], tp=True, shard_sequence=True),
        spec=ts, params=tp, batches=b, targets=[0], shard_sequence=True)
    js, jp, ts, tp = _both(_llama(5))
    b = load_calibration_batches(None, "synthetic", 8, 4, 32, vocab_size=128)
    add("calib_shard_stats", "calibrate", "data:2,model:2",
        dict(spec=js, params=jp, batches=b, targets=[0, 1], tp=True, shard_stats=True),
        spec=ts, params=tp, batches=b, targets=[0, 1], tp=True, shard_stats=True)

    js, jp, ts, tp = _both(_llama(7, layers=4))
    b = load_calibration_batches(None, "synthetic", 12, 2, 32, vocab_size=128)
    add("pp_stage4", "calibrate_pp", "stage:4", dict(spec=js, params=jp, batches=b), spec=ts, params=tp, batches=b)
    js, jp, ts, tp = _both(_llama(9, layers=4))
    b = load_calibration_batches(None, "synthetic", 12, 4, 32, vocab_size=128)
    add("pp_stage2_data2", "calibrate_pp", "stage:2,data:2", dict(spec=js, params=jp, batches=b),
        spec=ts, params=tp, batches=b)

    b = load_calibration_batches(None, "synthetic", 4, 2, 64, vocab_size=128)
    for name, model in (("llama", _llama(4)), ("qwen3", _qwen3()), ("moe", _qwen2_moe())):
        js, jp, ts, tp = _both(model)
        add(f"ring_{name}", "calibrate_ring", "context:4", dict(spec=js, params=jp, batches=b),
            spec=ts, params=tp, batches=b, targets=[0, 1])

    q = rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    for window in (None, 10):
        add(f"ring_attention_w{window}", "ring_attention", "context:4", dict(q=q, k=k, v=v, window=window),
            q=q, k=k, v=v, scale=16**-0.5, window=window)

    js, jp, ts, tp = _both(_llama(10, layers=4))
    tokens = np.random.default_rng(3).integers(0, 128, size=(8, 32)).astype(np.int32)
    for shape in ("stage:4", "stage:2,data:2"):
        add(f"ppl_pp_{shape}", "perplexity_pp", shape, dict(spec=js, params=jp, tokens=tokens),
            spec=ts, params=tp, tokens=tokens, batch_size=4)
    # a heterogeneous compressed model (the port's job's), loaded by both packages
    _, _, ts, tp = _both(_llama(11, layers=4))
    src = t_run(TConfig(**_run_config(f"{root}/padded_src", calib_size=4, calibs_batch_size=2,
                                      sparsity_smoothing=0.1, skip_baseline_eval=True, skip_final_eval=True),
                        device="cpu"), spec=ts, params=tp)["artifact_dir"]
    cspec, cparams, _ = t_artifact.load_compressed_model(src, device="cpu")
    jcspec, jcparams, _ = j_artifact.load_compressed_model(src)
    assert not cspec.is_uniform
    add("ppl_pp_padded", "perplexity_pp", "stage:4", dict(spec=jcspec, params=jcparams, tokens=tokens),
        spec=cspec, params=cparams, tokens=tokens, batch_size=4, padded=True, artifact=src)

    for name, shape, seed, layers, kw in (
        ("run_data2_model2", "data:2,model:2", 2, 2, {}),
        ("run_stage4", "stage:4", 8, 4, dict(calibs_batch_size=2, sparsity_smoothing=0.3,
                                              skip_baseline_eval=True)),
        ("run_context4", "context:4", 6, 2, dict(calib_size=4, calibs_batch_size=2, seq_len=64)),
    ):
        js, jp, ts, tp = _both(_llama(seed, layers))
        add(name, "run_compression", shape, dict(spec=js, params=jp, config=_run_config(f"{root}/jax_{name}", **kw)),
            spec=ts, params=tp, config=_run_config(f"{root}/port_{name}", **kw))
    return port, jside


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every launch of the module, started at once so that the ranks'
    imports and work overlap the JAX side: the 4-rank library launch, the
    compression CLI on 2 ranks (a tiny checkpoint) and the eval CLI on 2
    ranks (the padded case's compressed artifact)."""
    root = tmp_path_factory.mktemp("world4")
    port, jside = _cases(root)
    torch.save(port, root / "inputs.pt")
    cli = root / "cli"
    _llama(13).save_pretrained(cli / "ckpt")
    eval_flags = ["--model", port["ppl_pp_padded"]["artifact"], "--dataset", "synthetic", "--seq_len", "32",
                  "--eval_batch_size", "4", "--eval_max_samples", "8", "--device", "cpu"]
    launches = types.SimpleNamespace(
        lib=Launch(4, root, [RANKS, str(root)], name="world4"),
        cli=Launch(2, cli / "port", ["-m", "modegpt_tpu_torch.cli", *_cli_flags(cli / "port", cli / "ckpt"),
                                     "--device", "cpu", "--mesh_shape", "data:2"], name="cli"),
        eval_cli=Launch(2, cli / "eval", ["-m", "modegpt_tpu_torch.evals.cli", *eval_flags, "--mesh_shape", "data:2"],
                        name="eval_cli"),
    )
    yield types.SimpleNamespace(launch=launches.lib, launches=launches, jax=jside, port=port, cli=cli,
                                eval_flags=eval_flags)
    for launch in vars(launches).values():
        launch.wait()


def _rank_outputs(world4, name):
    return [out[name] for out in world4.launch.outputs()]


@pytest.mark.parametrize("name", ["run_data2_model2", "run_stage4", "run_context4"])
def test_run_compression_on_mesh_matches_jax(world4, name):
    j = world4.jax[name]
    shape = world4.port[name]["mesh"]
    want = j_run(JConfig(**j["config"]), spec=j["spec"], params=j["params"], tokenizer=None, mesh=_jmesh(shape))
    ws = want["compressed_spec"]
    outs = _rank_outputs(world4, name)
    for got in outs:
        for ranks, value in got["ranks"].items():
            assert value == list(getattr(ws, ranks)), ranks
        for key in ("baseline_ppl", "compressed_ppl"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=2e-3, err_msg=key)
        for l, kernels in enumerate(got["kernels"]):
            for key, kernel in kernels.items():
                np.testing.assert_allclose(kernel, np.asarray(want["compressed_params"]["layers"][l][key]["kernel"]),
                                           rtol=2e-4, atol=2e-4, err_msg=f"layer {l} {key}")
    port_store, jax_store = world4.port[name]["config"]["temp_storage_dir"], j["config"]["temp_storage_dir"]
    for l in range(len(outs[0]["kernels"])):
        jm, tm = (mod.load_layer_factors(store, l, "mlp") for mod, store in
                  ((j_artifact, jax_store), (t_artifact, port_store)))
        np.testing.assert_array_equal(tm["idx"], jm["idx"])
        jq, tq = (mod.load_layer_factors(store, l, "qk") for mod, store in
                  ((j_artifact, jax_store), (t_artifact, port_store)))
        np.testing.assert_array_equal(tq["rotary_mask"], jq["rotary_mask"])
    # rank 0 alone wrote the metrics JSON
    assert os.path.exists(os.path.join(world4.port[name]["config"]["metrics_dir"], "metrics.json"))


@pytest.mark.parametrize("name", ["collectives_data4", "collectives_2d"])
def test_collective_helpers(world4, name):
    for out in _rank_outputs(world4, name):
        assert all(out["checks"].values()), out


@pytest.mark.parametrize("name", ["forward_tp", "forward_tp_olmo2"])
def test_tp_forward_matches_jax(world4, name):
    """Megatron-sharded forward (each rank its heads and d_int slice, one
    all-reduce after o and after down) == the JAX forward."""
    j = world4.jax[name]
    ids = world4.port[name]["ids"]
    ref = np.asarray(j_forward(j["spec"], j["params"], jnp.asarray(ids))[0])
    outs = _rank_outputs(world4, name)
    n_data = max(o["coords"].get("data", 0) for o in outs) + 1
    rows = [next(o["logits"] for o in outs if o["coords"].get("data", 0) == d) for d in range(n_data)]
    np.testing.assert_allclose(np.concatenate(rows), ref, rtol=2e-4, atol=2e-4)
    for o in outs:  # the model axis' ranks agree on their rows
        np.testing.assert_allclose(o["logits"], rows[o["coords"].get("data", 0)], rtol=1e-6, atol=1e-6)


def _jax_calibrate(name, j):
    mesh = _jmesh(world4_meshes[name])
    params = jax.device_put(j["params"], j_mesh.param_shardings(mesh, j["spec"], j["params"])) if j.get("tp") \
        else j["params"]
    return j_calibrate(j["spec"], params, j["batches"], j["targets"], mesh=mesh, accumulate="host",
                       shard_sequence=j.get("shard_sequence", False), shard_stats=j.get("shard_stats", False))


world4_meshes = {
    "calib_data4": "data:4", "calib_tp": "data:2,model:2", "calib_shard_sequence": "data:2,model:2",
    "calib_shard_stats": "data:2,model:2",
}


def _assert_stats(got: dict, want, layers, fields=FIELDS):
    for field in fields:
        for l in layers:
            np.testing.assert_allclose(got[field][l], np.asarray(getattr(want, field)[l]), **STATS_TOL,
                                       err_msg=f"{field}[{l}]")
    np.testing.assert_allclose(got["bi"], want.bi_scores, rtol=1e-5)
    assert (got["n_sequences"], got["total_tokens"]) == (want.n_sequences, want.total_tokens)


@pytest.mark.parametrize("name", ["calib_data4", "calib_tp", "calib_shard_sequence", "calib_shard_stats"])
def test_mesh_calibration_matches_jax(world4, name):
    j = world4.jax[name]
    want = _jax_calibrate(name, j)
    outs = _rank_outputs(world4, name)
    if name != "calib_shard_stats":
        for got in outs:
            _assert_stats(got, want, j["targets"])
        return
    # each data rank holds exactly the layers it owns (layer % data == coordinate)
    merged = {field: {} for field in FIELDS}
    for got in outs:
        d = got["coords"]["data"]
        assert sorted(got["cov_mlp"]) == [l for l in j["targets"] if l % 2 == d]
        for field in FIELDS:
            merged[field].update(got[field])
    _assert_stats(dict(merged, bi=outs[0]["bi"], n_sequences=outs[0]["n_sequences"],
                       total_tokens=outs[0]["total_tokens"]), want, j["targets"])


@pytest.mark.parametrize("name,shape", [("pp_stage4", "stage:4"), ("pp_stage2_data2", "stage:2,data:2")])
def test_pipeline_calibration_matches_jax(world4, name, shape):
    """GPipe-staged calibration: every layer's statistics on every rank."""
    j = world4.jax[name]
    want = j_calibrate_pp(j["spec"], j["params"], j["batches"], _jmesh(shape))
    for got in _rank_outputs(world4, name):
        _assert_stats(got, want, range(4))


@pytest.mark.parametrize("name", ["ring_llama", "ring_qwen3", "ring_moe"])
def test_ring_calibration_matches_jax(world4, name):
    """Context-parallel ring calibration: RoPE at global positions,
    qwen3's per-head q/k norms, MoE through the dense all-experts path."""
    j = world4.jax[name]
    want = j_calibrate_ring(j["spec"], j["params"], j["batches"], [0, 1], _jmesh("context:4"))
    fields = FIELDS + ("cov_shared",) if name == "ring_moe" else FIELDS
    for got in _rank_outputs(world4, name):
        _assert_stats(got, want, [0, 1], fields)


@pytest.mark.parametrize("name", ["ring_attention_wNone", "ring_attention_w10"])
def test_ring_attention_matches_jax(world4, name):
    j = world4.jax[name]
    ref = np.asarray(j_attention(jnp.asarray(j["q"]), jnp.asarray(j["k"]), jnp.asarray(j["v"]), 16**-0.5,
                                 j["window"], "xla"))
    outs = sorted(_rank_outputs(world4, name), key=lambda o: o["coords"]["context"])
    np.testing.assert_allclose(np.concatenate([o["out"] for o in outs], axis=2), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["ppl_pp_stage:4", "ppl_pp_stage:2,data:2", "ppl_pp_padded"])
def test_pipeline_perplexity_matches_jax(world4, name):
    j = world4.jax[name]
    shape = world4.port[name]["mesh"]
    padded = j_pad(j["spec"], j["params"]) if name == "ppl_pp_padded" else None
    want = j_perplexity_pp(j["spec"], j["params"], j["tokens"], _jmesh(shape), batch_size=4, padded=padded)
    for out in _rank_outputs(world4, name):
        np.testing.assert_allclose(out["ppl"], want, rtol=1e-5)


# ---- the CLIs through the launcher ----


def _cli_flags(root, ckpt):
    return ["--model", str(ckpt), "--compression_ratio", "0.3", "--calib_size", "4", "--calibs_batch_size", "2",
            "--seq_len", "48", "--eval_batch_size", "4", "--eval_max_samples", "4", "--dataset", "synthetic",
            "--sparsity_smoothing", "0.5", "--solver_precision", "f32_device", "--output_dir", f"{root}/o",
            "--temp_storage_dir", f"{root}/l", "--metrics_dir", f"{root}/m"]


def test_clis_take_mesh_shape(world4):
    """`python -m modegpt_tpu_torch.cli --mesh_shape data:2` on 2 ranks
    against the same CLI on one process (the mesh runs are held to JAX's
    above), and the eval CLI with ``--mesh_shape data:2`` on 2 ranks
    against one."""
    from modegpt_tpu_torch.cli import main as t_main
    from modegpt_tpu_torch.evals.cli import main as t_eval

    cli = world4.cli
    want = t_main(_cli_flags(cli / "one", cli / "ckpt") + ["--device", "cpu"])
    world4.launches.cli.wait()
    metrics = json.load(open(cli / "port" / "m" / "metrics.json"))
    assert len(metrics) == 1  # rank 0 alone wrote it
    run = list(metrics.values())[-1]
    assert run["rank_lists"]["gate_ranks"] == list(want["compressed_spec"].gate_ranks)
    assert run["rank_lists"]["q_ranks"] == list(want["compressed_spec"].q_ranks)
    np.testing.assert_allclose(run["ppl-synthetic"], want["compressed_ppl"], rtol=2e-3)
    np.testing.assert_allclose(run["baseline-ppl"], want["baseline_ppl"], rtol=2e-3)

    one = t_eval(world4.eval_flags)
    logs = world4.launches.eval_cli.wait()
    lines = [json.loads(ln) for ln in logs[0].splitlines() if ln.startswith("{")]
    assert not [ln for ln in logs[1].splitlines() if ln.startswith("{")], "only rank 0 prints the results"
    np.testing.assert_allclose(lines[-1]["ppl-synthetic"], one["ppl-synthetic"], rtol=1e-6)


# ---- mesh construction and the error paths (one process) ----


def test_parse_and_make_mesh():
    for shape in ("data:4,model:2", "stage:2,data:2", ""):
        assert t_mesh.parse_mesh_shape(shape) == j_mesh.parse_mesh_shape(shape)
    assert t_mesh.make_mesh("", device="cpu") is None
    one = t_mesh.make_mesh("data:1", device="cpu")  # a one-rank mesh needs no process group
    assert one.size("data") == 1 and one.coord("model") == 0 and one.size("model") == 1
    with pytest.raises(ValueError, match="world size is 1"):
        t_mesh.make_mesh("data:2,model:2", device="cpu")


def test_more_ranks_than_cards_under_nccl_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.delenv("MODEGPT_DIST_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        t_mesh.maybe_initialize_distributed("cuda")
    monkeypatch.setenv("MODEGPT_DIST_BACKEND", "nccl")
    with pytest.raises(ValueError, match="gloo"):
        t_mesh.maybe_initialize_distributed("cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert t_mesh.maybe_initialize_distributed("cuda") is False  # no launcher: a single process


def test_experts_under_a_model_axis_raise():
    """Expert stacks under a model axis split by whole experts (expert
    parallelism; the shared expert column/row split), and a sharded stack
    run without the mesh that sharded it raises. The meshed forwards are
    held to JAX's in tests/test_torch_tp_serving.py."""
    from modegpt_tpu_torch.models.forward import _moe_mlp

    _, _, spec, params = _both(_qwen2_moe())
    for c in range(2):
        model2 = types.SimpleNamespace(size=lambda axis: 2 if axis == "model" else 1, coord=lambda axis, c=c: c,
                                       device=torch.device("cpu"))
        local = t_mesh.param_shardings(model2, spec, params)
        for l, lp in enumerate(local["layers"]):
            full = params["layers"][l]
            for k in ("gate", "up", "down"):
                torch.testing.assert_close(lp["experts"][k]["kernel"], full["experts"][k]["kernel"][2 * c : 2 * c + 2],
                                           rtol=0, atol=0)
            torch.testing.assert_close(lp["shared"]["up"]["kernel"], full["shared"]["up"]["kernel"].chunk(2, 1)[c],
                                       rtol=0, atol=0)
            torch.testing.assert_close(lp["shared"]["down"]["kernel"],
                                       full["shared"]["down"]["kernel"].chunk(2, 0)[c], rtol=0, atol=0)
            torch.testing.assert_close(lp["router"]["kernel"], full["router"]["kernel"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs the mesh whose model axis sharded it"):
        _moe_mlp(spec, local["layers"][0], torch.zeros(1, 2, spec.d_model), collect=False)
