"""Parity of the port's tensor- and expert-parallel serving with the JAX
package's, on the CPU.

The port serves SPMD, one process per rank. One 2-rank launch
(`test_torch_parallel_ranks.Launch`: plain subprocesses, a ``file://``
rendezvous under the test's temporary directory, gloo, a deadline after
which every rank is killed) runs every library case on ``data:1,model:2``
(`tests/test_torch_tp_serving_ranks.py`, torch only), and one more
2-rank launch runs the server CLI with ``--tensor_parallel 2``. Nothing
here joins a process group: the pytest process only writes inputs, reads
the ranks' results and computes the JAX side, in process, on a
``data:1,model:2`` mesh of the virtual CPU devices `tests/conftest.py`
sets up, from the same numpy inputs and seeded tiny HF models.

* `shard_serving`: every leaf of each rank's stack and pools equals
  JAX's addressable shard on the device at its coordinate, exactly, for
  plain, compressed (rotary-masked), int8, W8A8-view, expert and
  shared-expert (mixed dense/MoE) stacks, f32 and int8 K/V pools;
* one padded step through the sharded stack (the ragged attention's
  wrapper, K3's plain version on the CPU) within 2e-4 of JAX's unsharded
  step: compressed llama, qwen3_moe dense and by capacity dispatch
  (drops included), qwen2_moe's shared expert, olmo2's whole-projection
  q/k norm, gemma2's caps and window, W8A8 and int8 K/V; the rank's pool
  writes too;
* greedy tokens equal to JAX's ``data:1,model:2`` batcher and to the
  port's unsharded batcher in each batcher mode (per-slot, batched with
  fused decode, mixed, prefix cache, prompt lookup, a draft model, int8
  weights, W8A8 prefill, int8 K/V, a compressed artifact, qwen3_moe
  dense and dispatch, olmo2, gemma2);
* the unrolled TP forward of compressed and MoE trees (`param_shardings`)
  within 2e-4 of JAX's forward;
* ``--tensor_parallel 2`` over HTTP: each JSON answer equal to the
  one-process server's (greedy, seeded, logprobs, stop, penalties, ``n``,
  ``min_tokens``, guided choice and regex, ``logit_bias``), a stream's
  deltas its non-streamed answer, and after a cancel of a stream the
  ranks still in lockstep;
* the error paths: ``n_kv_heads % model``, the world size against the
  mesh.
"""

import http.client
import json
import os
import signal
import socket
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import padded as j_padded  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models import quantize as j_quantize  # noqa: E402
from modegpt_tpu.models import serving as j_serving  # noqa: E402
from modegpt_tpu.parallel import mesh as j_mesh  # noqa: E402
from modegpt_tpu_torch import server as TS  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.models import padded as t_padded  # noqa: E402
from modegpt_tpu_torch.models import quantize as t_quantize  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402
from modegpt_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from test_torch_parallel_ranks import Launch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = os.path.join(HERE, "test_torch_tp_serving_ranks.py")
LAUNCH_S = 300  # each launch's deadline (and every collective's timeout)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # the TP forward's tolerance (tests/test_torch_parallel.py)
KW = dict(slots=2, max_len=64, prefill_bucket=8)
MESH = "data:1,model:2"


# ---- tiny models, one seed each ----

_COMMON = dict(vocab_size=128, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=256)


def _hf(arch):
    t = transformers
    if arch == "llama":
        cfg, cls = t.LlamaConfig(**_COMMON, intermediate_size=144, num_hidden_layers=2), t.LlamaForCausalLM
    elif arch == "qwen3_moe":
        cfg = t.Qwen3MoeConfig(**_COMMON, intermediate_size=96, moe_intermediate_size=48, num_hidden_layers=2,
                               num_experts=4, num_experts_per_tok=2, norm_topk_prob=True, head_dim=16)
        cls = t.Qwen3MoeForCausalLM
    elif arch == "qwen2_moe":  # a shared expert with its gate, and a dense layer between MoE ones
        cfg = t.Qwen2MoeConfig(**_COMMON, intermediate_size=96, moe_intermediate_size=48,
                               shared_expert_intermediate_size=80, num_hidden_layers=3, num_experts=4,
                               num_experts_per_tok=2, mlp_only_layers=[1])
        cls = t.Qwen2MoeForCausalLM
    elif arch == "olmo2":
        cfg, cls = t.Olmo2Config(**_COMMON, intermediate_size=64, num_hidden_layers=2), t.Olmo2ForCausalLM
    else:  # gemma2: a window of 8 on alternate layers, score and logit caps
        cfg = t.Gemma2Config(**_COMMON, intermediate_size=64, num_hidden_layers=2, head_dim=16, sliding_window=8,
                             query_pre_attn_scalar=24, attn_logit_softcapping=3.0, final_logit_softcapping=5.0)
        cfg._attn_implementation = "eager"
        cls = t.Gemma2ForCausalLM
    torch.manual_seed({"llama": 29, "qwen3_moe": 3, "qwen2_moe": 5, "olmo2": 12, "gemma2": 7}[arch])
    return cls(cfg).eval()


def _compressed(root):
    """A heterogeneous compressed llama (per-layer ranks, rotary masks;
    random factors) written as an artifact by the port and loaded by both
    packages. Its padded widths split over 2 ranks: gate 40, heads 4 over
    2 kv heads."""
    spec, dense = j_params_from_hf(_hf("llama"))
    host = jax.device_get(dense)
    rng = np.random.default_rng(4)
    H, Hk, hd, d = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_model
    r_qk, r_vo, r_mlp = (6, 4), (4, 6), (40, 24)
    cspec = spec.with_ranks(q_ranks=[H * r for r in r_qk], k_ranks=[Hk * r for r in r_qk],
                            v_ranks=[Hk * r for r in r_vo], o_ranks=[H * r for r in r_vo], gate_ranks=r_mlp,
                            has_rotary_masks=True)
    layers = []
    for l, lp in enumerate(host["layers"]):
        new = {k: v for k, v in lp.items() if k in ("attn_norm", "mlp_norm")}
        shapes = {"q": (d, cspec.q_ranks[l]), "k": (d, cspec.k_ranks[l]), "v": (d, cspec.v_ranks[l]),
                  "o": (cspec.o_ranks[l], d), "up": (d, r_mlp[l]), "gate": (d, r_mlp[l]), "down": (r_mlp[l], d)}
        for name, shape in shapes.items():
            new[name] = {"kernel": (rng.standard_normal(shape) * 0.1).astype(np.float32)}
        pairs = np.stack([rng.permutation(hd // 2)[: r_qk[l] // 2] for _ in range(Hk)])
        new["rotary_mask"] = np.concatenate([pairs, pairs + hd // 2], axis=1).astype(np.int32)
        layers.append(new)
    cparams = {**{k: v for k, v in host.items() if k != "layers"}, "layers": layers}
    t_artifact.save_compressed_model(str(root), TSpec.from_dict(cspec.to_dict()), params_from_numpy(cparams, "cpu"))
    jspec, jparams, _ = j_artifact.load_compressed_model(str(root))
    tspec, tparams, _ = t_artifact.load_compressed_model(str(root), device="cpu")
    return jspec, jparams, tspec, tparams


def _pads(jspec, jparams, tspec=None, tparams=None):
    """(JAX padded model, port padded model) of the same weights."""
    if tspec is None:
        tspec, tparams = TSpec.from_dict(jspec.to_dict()), params_from_numpy(jax.device_get(jparams), "cpu")
    return j_padded.pad_to_uniform(jspec, jparams), t_padded.pad_to_uniform(tspec, tparams)


def _jmesh(model=2):
    return JMesh(np.asarray(jax.devices()[:model]).reshape(1, model), ("data", "model"))


def _state(pm, kv="model", seed=0):
    """A serve state with random pools (numpy), the same for both packages."""
    spec = pm.spec
    L, Hk = spec.n_layers, spec.n_kv_heads
    Rq, Rv = spec.q_ranks[0] // spec.n_heads, spec.v_ranks[0] // Hk
    rng, B, T = np.random.default_rng(seed), KW["slots"] + 1, 24
    out = dict(lengths=np.asarray([0, 7, T - 2][:B], np.int64),
               last_token=rng.integers(0, spec.vocab_size, B).astype(np.int64))
    if kv == "int8":
        out["cache_k"] = rng.integers(-127, 128, (L, B, Hk, T, Rq), dtype=np.int8)
        out["cache_v"] = rng.integers(-127, 128, (L, B, Hk, T, Rv), dtype=np.int8)
        out["k_scale"], out["v_scale"] = ((rng.uniform(0.5, 1.5, (L, B, Hk, T)) / 127).astype(np.float32)
                                          for _ in range(2))
    else:
        out["cache_k"] = rng.standard_normal((L, B, Hk, T, Rq)).astype(np.float32)
        out["cache_v"] = rng.standard_normal((L, B, Hk, T, Rv)).astype(np.float32)
    return out


def _jstate(st):
    return j_serving.ServeState(
        cache_k=jnp.asarray(st["cache_k"]), cache_v=jnp.asarray(st["cache_v"]),
        lengths=jnp.asarray(st["lengths"], jnp.int32), last_token=jnp.asarray(st["last_token"], jnp.int32),
        k_scale=None if "k_scale" not in st else jnp.asarray(st["k_scale"]),
        v_scale=None if "v_scale" not in st else jnp.asarray(st["v_scale"]),
    )


def _prompts(lengths, seed=0, prefix=()):
    rng = np.random.default_rng(seed)
    return [np.concatenate([np.asarray(prefix, np.int64), rng.integers(1, 128, size=(n,))]).astype(np.int64)
            for n in lengths]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---- the cases: (port inputs, JAX inputs) by name ----


def _cases(root):
    port, jside = {}, {}
    pads = {arch: _pads(*j_params_from_hf(_hf(arch))) for arch in ("llama", "qwen3_moe", "qwen2_moe", "olmo2",
                                                                      "gemma2")}
    pads["compressed"] = _pads(*_compressed(root / "artifact"))
    jq, tq = j_quantize.quantize_padded(pads["llama"][0]), t_quantize.quantize_padded(pads["llama"][1])
    pads["int8"] = (jq, tq)
    pads["w8a8"] = (j_quantize.with_act_quant(jq), t_quantize.with_act_quant(tq))

    def add(name, kind, pair, jax_inputs=None, **kw):
        port[name] = dict(kind=kind, mesh=MESH, **kw)
        jside[name] = dict(pm=pair[0], **(jax_inputs or {}))

    for name, kv in (("llama", "model"), ("compressed", "model"), ("int8", "int8"), ("w8a8", "model"),
                     ("qwen3_moe", "model"), ("qwen2_moe", "int8")):
        st = _state(pads[name][1], kv)
        add(f"shards_{name}", "shards", pads[name], dict(state=st), pm=pads[name][1], state=st)

    tokens = np.random.default_rng(6).integers(0, 128, (KW["slots"] + 1, 3)).astype(np.int64)
    for name, model, kv, moe in (
        ("compressed", "compressed", "model", {}), ("qwen3_moe", "qwen3_moe", "model", {}),
        ("qwen3_moe_dispatch", "qwen3_moe", "model", dict(moe="dispatch", moe_capacity=0.5)),
        ("qwen2_moe", "qwen2_moe", "model", {}), ("olmo2", "olmo2", "model", {}), ("gemma2", "gemma2", "model", {}),
        ("w8a8", "w8a8", "model", {}), ("int8_kv", "llama", "int8", {}),
    ):
        st = _state(pads[model][1], kv, seed=1)
        add(f"step_{name}", "step", pads[model], dict(state=st, tokens=tokens, **moe), pm=pads[model][1], state=st,
            tokens=tokens, **moe)

    short, spec_prompts = _prompts((5, 9, 3)), _prompts((4, 6), seed=2, prefix=[7, 8, 9, 7, 8, 9] * 2)
    modes = {
        "per_slot": ("llama", {}, short),
        "batched_fused": ("llama", dict(prefill_exec="batched", mixed_prefill_decode=False, steps_per_dispatch=3),
                          short),
        "mixed": ("llama", dict(prefill_exec="batched"), short),
        "prefix_cache": ("llama", dict(prefix_cache=True), _prompts((3, 5, 2), seed=3, prefix=list(range(1, 17)))),
        "prompt_lookup": ("llama", dict(spec_decode="prompt_lookup", n_draft=3), spec_prompts),
        "draft": ("llama", dict(spec_decode="draft", n_draft=3), spec_prompts),
        "int8": ("int8", dict(prefill_exec="batched"), short),
        "w8a8_prefill": ("int8", dict(a8_prefill=True), short),
        "int8_kv": ("llama", dict(kv_dtype="int8", prefill_exec="batched", steps_per_dispatch=2), short),
        "compressed": ("compressed", dict(prefill_exec="batched"), short),
        "qwen3_moe_dense": ("qwen3_moe", {}, short),
        "qwen3_moe_dispatch": ("qwen3_moe", dict(moe="dispatch", moe_capacity=1.0, prefill_exec="batched"), short),
        "olmo2": ("olmo2", {}, short),
        "gemma2": ("gemma2", dict(prefill_exec="batched"), _prompts((12, 5, 10), seed=4)),
    }
    for mode, (model, kw, prompts) in modes.items():
        budgets = [8] * len(prompts)
        kw = {**KW, **kw}
        draft = dict(draft_pm=pads["compressed"]) if kw.get("spec_decode") == "draft" else {}
        add(f"serve_{mode}", "serve", pads[model], dict(kw=kw, prompts=prompts, budgets=budgets,
                                                        **{k: v[0] for k, v in draft.items()}),
            pm=pads[model][1], kw=dict(kw, decode_attn="ragged", **{k: v[1] for k, v in draft.items()}),
            prompts=prompts, budgets=budgets)
        jside[f"serve_{mode}"]["tpm"] = pads[model][1]
        jside[f"serve_{mode}"]["tdraft"] = draft.get("draft_pm", (None, None))[1]

    ids = np.random.default_rng(8).integers(0, 128, (2, 12)).astype(np.int64)
    for name, (jspec, jparams, tspec, tparams) in (
        ("compressed", _compressed(root / "artifact_fwd")),
        ("qwen2_moe", (*j_params_from_hf(_hf("qwen2_moe")), None, None)),
        ("qwen3_moe", (*j_params_from_hf(_hf("qwen3_moe")), None, None)),
    ):
        if tspec is None:
            tspec, tparams = TSpec.from_dict(jspec.to_dict()), params_from_numpy(jax.device_get(jparams), "cpu")
        port[f"forward_{name}"] = dict(kind="forward", mesh=MESH, spec=tspec, params=tparams, ids=ids)
        jside[f"forward_{name}"] = dict(spec=jspec, params=jparams, ids=ids)
    return port, jside


# ---- the server: a checkpoint with a tokenizer ----


def _tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    corpus = ["the quick brown fox jumps over the lazy dog", "user assistant system says hello world again",
              "a b c d e f g h i j k l m n o p q r s t u v w x y z : ."]
    tok.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=100, special_tokens=["<unk>", "<s>", "</s>"]))
    return transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                                                eos_token="</s>", pad_token="</s>")


SERVER_FLAGS = ["--slots", "2", "--max_len", "64", "--prefill_bucket", "8", "--device", "cpu"]
SERVER_REQUESTS = [
    {"prompt": "the quick brown fox", "max_tokens": 6},
    {"prompt_ids": [3, 5, 7, 11, 13], "max_tokens": 7, "logprobs": True, "top_logprobs": 2},
    {"prompt": "hello world", "max_tokens": 5, "temperature": 0.8, "top_p": 0.9, "seed": 11},
    {"prompt_ids": [9, 8, 7], "max_tokens": 6, "temperature": 1.0, "top_k": 20, "seed": 3},
    {"prompt": "user says", "max_tokens": 8, "stop": ["lazy dog"], "presence_penalty": 0.7},
    {"prompt_ids": [4, 4, 4, 4], "max_tokens": 4, "n": 2, "temperature": 0.7, "seed": 5},
    {"prompt": "a b c", "max_tokens": 6, "repetition_penalty": 1.3, "frequency_penalty": 0.5},
    {"prompt_ids": [1, 2, 3, 4, 5, 6, 7, 8, 9], "max_tokens": 9, "min_tokens": 3},
]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _health(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", "/health")
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both launches, started at once so that the ranks' imports and work
    overlap the JAX side: the library launch and the server CLI on 2
    ranks (a tiny llama checkpoint with a tokenizer)."""
    root = tmp_path_factory.mktemp("tp_serving")
    ckpt = root / "ckpt"
    _hf("llama").save_pretrained(ckpt)
    _tokenizer().save_pretrained(ckpt)
    port_no = _free_port()
    server = Launch(2, root / "server", ["-m", "modegpt_tpu_torch.server", "--model", str(ckpt), "--port",
                                         str(port_no), "--tensor_parallel", "2", *SERVER_FLAGS],
                    name="server", timeout=LAUNCH_S)
    lib = None
    try:
        port, jside = _cases(root)
        torch.save(port, root / "inputs.pt")
        lib = Launch(2, root, [RANKS, str(root)], name="lib", timeout=LAUNCH_S)
        yield types.SimpleNamespace(lib=lib, server=server, port_no=port_no, ckpt=ckpt, port=port, jax=jside,
                                    outs=None)
    finally:
        if server.procs[0].poll() is None:
            server.procs[0].send_signal(signal.SIGINT)  # rank 0's shutdown stops its follower
        for launch in (lib, server):
            try:
                if launch is not None:
                    launch.wait()  # kills any rank left at the deadline
            except AssertionError:
                pass  # the test that reads the launch reports its failure


def _outputs(world, name):
    if world.outs is None:
        world.outs = world.lib.outputs()
    return [out[name] for out in world.outs]


# ---- the server over HTTP ----


@pytest.fixture(scope="module")
def servers(world):
    """The tensor-parallel server's port once it answers /health, and the
    one-process port server on the same checkpoint, its reference."""
    from modegpt_tpu_torch.models.hf import params_from_hf_model

    spec, params = params_from_hf_model(_hf("llama"), device="cpu")
    tok = _tokenizer()
    one = TS.InferenceServer(TBatcher(t_padded.pad_to_uniform(spec, params), slots=2, max_len=64, prefill_bucket=8,
                                      per_request_sampling=True, eos_token_id=tok.eos_token_id),
                             tokenizer=tok, model_id=str(world.ckpt))
    httpd = TS.make_http_server(one, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        deadline = time.time() + LAUNCH_S
        while True:
            assert all(p.poll() is None for p in world.server.procs), world.server.wait()
            assert time.time() < deadline, "the tensor-parallel server never answered /health"
            try:
                status, health = _health(world.port_no)
                break
            except OSError:
                time.sleep(0.2)
        assert status == 200 and health["status"] == "ok"
        yield types.SimpleNamespace(tp=world.port_no, one=httpd.server_address[1])
    finally:
        httpd.shutdown()
        one.close()


def _same_answer(got, want):
    """Two completion answers equal as JSON, ids and times aside, logprobs
    to 1e-5."""
    (gs, g), (ws, w) = got, want
    assert gs == ws == 200, (g, w)
    for key in ("id", "created"):
        g.pop(key, None), w.pop(key, None)
    assert [c["token_ids"] for c in g["choices"]] == [c["token_ids"] for c in w["choices"]]
    for gc, wc in zip(g["choices"], w["choices"]):
        if wc.get("logprobs"):
            np.testing.assert_allclose(gc["logprobs"]["token_logprobs"], wc["logprobs"]["token_logprobs"], atol=1e-5)
            gc.pop("logprobs"), wc.pop("logprobs")
    assert g == w


def test_server_tensor_parallel_matches_one_process(servers):
    """`python -m modegpt_tpu_torch.server --tensor_parallel 2` on 2 ranks
    (rank 0 serves HTTP, rank 1 follows it): 8 concurrent completions,
    greedy and seeded sampled, each answer equal to the one-process
    server's on the same checkpoint."""
    with ThreadPoolExecutor(len(SERVER_REQUESTS)) as pool:
        got = list(pool.map(lambda body: _post(servers.tp, body), SERVER_REQUESTS))
    want = [_post(servers.one, body) for body in SERVER_REQUESTS]
    for g, w in zip(got, want):
        _same_answer(g, w)


# the request kinds whose fields cross from rank 0 to its followers with
# each submit: a guide (pickled to every rank), a logit bias; and a stream
SERVER_KINDS = {
    "guided_choice": {"prompt": "says", "max_tokens": 16, "guided_choice": ["hello", "dog", "lazy"]},
    "guided_regex": {"prompt": "quick", "max_tokens": 16, "guided_regex": "(the|a)(fox|dog)+"},
    "logit_bias": {"prompt_ids": [9, 8, 7], "max_tokens": 8, "logit_bias": {"40": 3.5, "41": 2.0, "2": -100}},
    "stream": {"prompt": "the quick brown fox", "max_tokens": 10, "logprobs": True, "stream": True},
}


def _stream(port, body):
    """(status, SSE events) of a streamed completion."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", body=json.dumps(body), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    events = [json.loads(line[len(b"data: "):]) for line in data.split(b"\n")
              if line.startswith(b"data: ") and b"[DONE]" not in line]
    return resp.status, events, data.rstrip().endswith(b"data: [DONE]")


@pytest.mark.parametrize("kind", sorted(SERVER_KINDS))
def test_server_tensor_parallel_request_kinds(servers, kind):
    """A guided (choice, regex), a logit-biased and a streamed request to
    the two ranks: the one-process server's answer (a stream's deltas
    concatenate to its non-streamed tokens, text and logprobs)."""
    body = SERVER_KINDS[kind]
    if kind != "stream":
        got, want = _post(servers.tp, body), _post(servers.one, body)
        _same_answer(got, want)
        if kind == "guided_choice":  # the pieces before EOS spell one choice
            ids = got[1]["choices"][0]["token_ids"]
            assert "".join(_tokenizer().convert_ids_to_tokens(ids[:-1])) in body["guided_choice"]
        return
    status, events, done = _stream(servers.tp, body)
    ws, want = _post(servers.one, {**body, "stream": False})
    assert status == ws == 200 and done
    choice = want["choices"][0]
    assert [t for e in events for t in e["token_ids"]] == choice["token_ids"]
    assert "".join(e["text"] for e in events) == choice["text"]
    np.testing.assert_allclose([x for e in events for x in e["logprobs"]], choice["logprobs"]["token_logprobs"],
                               atol=1e-5)


def test_server_tensor_parallel_cancel_keeps_the_ranks_in_lockstep(world, servers):
    """A streamed request cancelled through POST /v1/cancel after its
    first event: the stream ends, rank 0 counts the cancel, and a request
    sent after it still answers as the one-process server does, so the
    follower applied the cancel in the same round. Then SIGINT on rank 0
    ends both ranks with exit code 0. (Runs last: it stops the ranks.)"""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", servers.tp, timeout=120)
        conn.request("POST", "/v1/completions", body=json.dumps({"prompt_ids": [5, 6, 7], "max_tokens": 56,
                                                                 "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first = resp.readline()
        while not first.startswith(b"data: "):
            first = resp.readline()
        rid = json.loads(first[len(b"data: "):])["id"]
        status, reply = _post(servers.tp, {"id": rid}, "/v1/cancel")
        rest = resp.read()
        conn.close()
        assert status == 200 and reply == {"id": rid, "cancelled": True}
        assert rest.rstrip().endswith(b"data: [DONE]")
        events = [json.loads(line[len(b"data: "):]) for line in (first + rest).split(b"\n")
                  if line.startswith(b"data: ") and b"[DONE]" not in line]
        assert sum(len(e["token_ids"]) for e in events) < 56  # cut short
        conn = http.client.HTTPConnection("127.0.0.1", servers.tp, timeout=30)
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        conn.close()
        assert "modegpt_requests_cancelled_total 1" in metrics.splitlines()
        for body in (SERVER_REQUESTS[0], SERVER_REQUESTS[3]):
            _same_answer(_post(servers.tp, body), _post(servers.one, body))
    finally:
        world.server.procs[0].send_signal(signal.SIGINT)
    logs = world.server.wait()  # both ranks exit 0 after rank 0's shutdown
    assert "follows rank 0" in logs[1]


# ---- the library launch ----


def _jax_shards(leaf, c):
    """JAX's addressable shard of `leaf` on the device at model coordinate c."""
    dev = jax.devices()[c]
    return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == dev)


@pytest.mark.parametrize("name", ["llama", "compressed", "int8", "w8a8", "qwen3_moe", "qwen2_moe"])
def test_shard_serving_equals_jax_shards(world, name):
    """Each rank's leaves and pools are JAX's shards on its device."""
    j = world.jax[f"shards_{name}"]
    jpm, jstate = j_mesh.shard_serving(_jmesh(), j["pm"], _jstate(j["state"]))
    j_layers = _leaves(jpm.layers)
    for out in _outputs(world, f"shards_{name}"):
        c = out["coords"]["model"]
        assert set(out["layers"]) <= set(j_layers) and set(j_layers) - set(out["layers"]) <= {"window", "is_moe"}
        for path, got in out["layers"].items():
            np.testing.assert_array_equal(got, _jax_shards(j_layers[path], c), err_msg=path)
        for path, got in out["other"].items():
            np.testing.assert_array_equal(got, _jax_shards(_leaves(jpm.other)[path], c), err_msg=path)
        np.testing.assert_array_equal(out["q_hd_true"], _jax_shards(jpm.q_hd_true, c))
        for key, got in out["pools"].items():
            np.testing.assert_array_equal(got, _jax_shards(getattr(jstate, key), c), err_msg=key)
        np.testing.assert_array_equal(out["lengths"], j["state"]["lengths"])
        np.testing.assert_array_equal(out["last_token"], j["state"]["last_token"])
    if name in ("qwen3_moe", "qwen2_moe"):  # expert parallelism: two whole experts a rank
        assert _outputs(world, f"shards_{name}")[0]["layers"]["experts/gate/kernel"].shape[1] == 2


@pytest.mark.parametrize("name", ["compressed", "qwen3_moe", "qwen3_moe_dispatch", "qwen2_moe", "olmo2", "gemma2",
                                  "w8a8", "int8_kv"])
def test_sharded_step_matches_jax(world, name):
    """One padded step of 3 new tokens a slot at per-row offsets (the last
    slot past the pool's end) through each rank's shard: the logits,
    whole on every rank, within 2e-4 of JAX's unsharded step; each
    rank's pools hold JAX's writes on its kv heads."""
    j = world.jax[f"step_{name}"]
    pm, st = j["pm"], j["state"]
    jst = _jstate(st)
    want = j_padded._model_step_padded(
        pm.spec, pm.layers, pm.other, pm.q_hd_true, jnp.asarray(j["tokens"], jnp.int32), jst.cache_k, jst.cache_v,
        jnp.asarray(st["lengths"], jnp.int32), cache_scales=jst.scales, moe=j.get("moe", "dense"),
        moe_capacity=j.get("moe_capacity", 2.0),
    )
    T = st["cache_k"].shape[3]
    live = st["lengths"][:, None] + np.arange(j["tokens"].shape[1])[None, :] < T
    outs = _outputs(world, f"step_{name}")
    for out in outs:
        np.testing.assert_allclose(out["logits"][live], np.asarray(want[0])[live], **LOGIT_TOL)
        np.testing.assert_array_equal(out["logits"], outs[0]["logits"])  # replicated after the head
        c = out["coords"]["model"]
        Hkl = out["pools"]["cache_v"].shape[2]
        heads = slice(c * Hkl, (c + 1) * Hkl)
        if "k_scale" in out["pools"]:  # codes at most one rounding step apart
            for got, w in ((out["pools"]["cache_k"], want[1]), (out["pools"]["cache_v"], want[2])):
                diff = np.abs(got.astype(np.int32) - np.asarray(w)[:, :, heads].astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            np.testing.assert_allclose(out["pools"]["k_scale"], np.asarray(want[4][0])[:, :, heads], **LOGIT_TOL)
        else:
            np.testing.assert_allclose(out["pools"]["cache_k"], np.asarray(want[1])[:, :, heads], **LOGIT_TOL)
            np.testing.assert_allclose(out["pools"]["cache_v"], np.asarray(want[2])[:, :, heads], **LOGIT_TOL)


SERVE_MODES = ["per_slot", "batched_fused", "mixed", "prefix_cache", "prompt_lookup", "draft", "int8",
               "w8a8_prefill", "int8_kv", "compressed", "qwen3_moe_dense", "qwen3_moe_dispatch", "olmo2", "gemma2"]


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_mesh_batcher_tokens_match_jax(world, mode):
    """Greedy tokens of the batcher on data:1,model:2 (each rank through
    the ragged attention's wrapper on its heads) equal the JAX batcher's
    on the same mesh and the port's unsharded batcher's, with the same
    prefix-cache and speculative counters."""
    j, p = world.jax[f"serve_{mode}"], world.port[f"serve_{mode}"]
    extra = {} if j.get("draft_pm") is None else dict(draft_pm=j["draft_pm"])
    jb = j_serving.ContinuousBatcher(j["pm"], decode_attn="xla", mesh=_jmesh(), **j["kw"], **extra)
    rids = [jb.submit(q, max_new_tokens=n) for q, n in zip(j["prompts"], j["budgets"])]
    done = jb.run()
    want = [list(map(int, done[r])) for r in rids]
    t_extra = {} if j["tdraft"] is None else dict(draft_pm=j["tdraft"])
    tb = TBatcher(j["tpm"], decode_attn="ragged", **j["kw"], **t_extra)
    rids = [tb.submit(q, max_new_tokens=n) for q, n in zip(j["prompts"], j["budgets"])]
    done = tb.run()
    assert [list(map(int, done[r])) for r in rids] == want
    for out in _outputs(world, f"serve_{mode}"):
        assert out["tokens"] == want
        assert out["pool_heads"] == 1  # each rank holds one of the two kv heads
        assert out["prefix_hits"] == jb.prefix_hits
        assert out["stats"] == {i: jb.stats[r] for i, r in enumerate(sorted(jb.stats))}
        assert out["comm_bytes"] > 0
    if mode == "prefix_cache":
        assert jb.prefix_hits > 0
    assert p["kw"]["decode_attn"] == "ragged"


@pytest.mark.parametrize("name", ["compressed", "qwen2_moe", "qwen3_moe"])
def test_tp_forward_of_compressed_and_moe_trees_matches_jax(world, name):
    """`param_shardings` of a rotary-masked compressed tree and of expert
    stacks (expert parallelism, the shared expert split), through the
    unrolled forward on model:2, within 2e-4 of JAX's forward."""
    j = world.jax[f"forward_{name}"]
    ref = np.asarray(j_forward(j["spec"], j["params"], jnp.asarray(j["ids"], jnp.int32))[0])
    for out in _outputs(world, f"forward_{name}"):
        np.testing.assert_allclose(out["logits"], ref, **LOGIT_TOL)


# ---- the error paths (one process, no process group) ----


def test_kv_heads_and_world_size_must_fit_the_mesh(monkeypatch, tmp_path):
    """n_kv_heads not divisible by the model axis raises JAX's ValueError
    in both packages; a mesh or a --tensor_parallel that the world size
    does not fit raises before anything is served."""
    for var in ("WORLD_SIZE", "RANK", "MODEGPT_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    jpm, tpm = _pads(*j_params_from_hf(_hf("llama")))
    model4 = types.SimpleNamespace(size=lambda axis: 4 if axis == "model" else 1, coord=lambda axis: 0,
                                   device=torch.device("cpu"))
    with pytest.raises(ValueError, match="n_kv_heads"):
        j_mesh.shard_serving(_jmesh(4), jpm, j_serving.init_serve_state(jpm, 2, 16))
    with pytest.raises(ValueError, match=r"n_kv_heads \(2\) divisible by the model axis \(4\)"):
        t_mesh.shard_serving(model4, tpm, None)
    with pytest.raises(ValueError, match="world size is 1"):
        TBatcher(tpm, mesh=t_mesh.make_mesh(MESH, device="cpu"), **KW)
    with pytest.raises(ValueError, match="tensor_parallel 2 does not divide the world size 1"):
        TS.main(["--model", str(tmp_path), "--tensor_parallel", "2", "--device", "cpu"])
