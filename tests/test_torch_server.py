"""Parity: the port's HTTP server (`modegpt_tpu_torch.server`) against the
JAX package's (`modegpt_tpu.server`).

Both serve the same tiny llama (carried across with `params_from_numpy`)
behind a real `ThreadingHTTPServer` on port 0, with the same offline BPE
tokenizer and per-request batchers. Greedy completions and chat
completions (logprobs in both OpenAI shapes, top_logprobs, stop strings,
logit_bias, min_tokens, n=2, guided fields) must return the JAX server's
JSON, ids aside and logprobs to 1e-5; streams concatenate to the
non-streaming answer; /health, /v1/models, /metrics and the client
errors answer as JAX's do; a cancel frees the only slot and a second
request gets 429 while that slot is held busy by construction; the CLI
serves one completion with --device cpu.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from modegpt_tpu import server as JS  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu_torch import server as TS  # noqa: E402
from modegpt_tpu_torch.models import guided as TG  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(slots=2, max_len=64, prefill_bucket=8, per_request_sampling=True)


def _hf():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _tokenizer():
    """A whitespace BPE trained offline (ids below the model's 128), no
    chat template, so chat takes the transcript form."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    corpus = ["the quick brown fox jumps over the lazy dog",
              "user assistant system says hello world again and again",
              "a b c d e f g h i j k l m n o p q r s t u v w x y z : ."]
    tok.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=100, special_tokens=["<unk>", "<s>", "</s>"]))
    return transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                                                eos_token="</s>", pad_token="</s>")


def _start(server, mod):
    httpd = mod.make_http_server(server, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


@pytest.fixture(scope="module")
def hf_model():
    return _hf()


@pytest.fixture(scope="module")
def both(hf_model):
    """{"jax": port, "torch": port} of two servers over the same weights."""
    tok = _tokenizer()
    j_spec, j_params = j_params_from_hf(hf_model)
    t_spec = TSpec.from_dict(j_spec.to_dict())
    jpm = j_pad(j_spec, j_params)
    tpm = t_pad(t_spec, params_from_numpy(jax.device_get(j_params), "cpu"))
    servers = {
        "jax": JS.InferenceServer(JBatcher(jpm, eos_token_id=tok.eos_token_id, **KW), tokenizer=tok, model_id="m"),
        "torch": TS.InferenceServer(TBatcher(tpm, eos_token_id=tok.eos_token_id, **KW), tokenizer=tok,
                                    model_id="m"),
    }
    started = {k: _start(s, JS if k == "jax" else TS) for k, s in servers.items()}
    yield {k: port for k, (_, port) in started.items()}, servers
    for k, (httpd, _) in started.items():
        httpd.shutdown()
        servers[k].close()


def _post(port, path, body, raw=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body if raw else json.dumps(body), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def _close(got, want, path="$"):
    """`got` equals `want` as JSON, ids aside, floats to 1e-5."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "id":
                _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-5), path
    else:
        assert got == want, path


def _events(data):
    return [json.loads(line[len("data: "):]) for line in data.decode().split("\n")
            if line.startswith("data: ") and "[DONE]" not in line]


REQUESTS = [
    ("/v1/completions", {"prompt_ids": [3, 5, 7, 11, 13], "max_tokens": 6, "logprobs": 3}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 7, "logprobs": True, "top_logprobs": 2,
                         "repetition_penalty": 1.3, "frequency_penalty": 0.5}),
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 8, "stop": ["again", "lazy dog"],
                         "presence_penalty": 0.7}),
    ("/v1/completions", {"prompt_ids": [9, 8, 7], "max_tokens": 8, "min_tokens": 3,
                         "logit_bias": {"2": 100, "40": 3.5}}),
    ("/v1/completions", {"prompt_ids": [4, 4, 4], "max_tokens": 4, "n": 2, "stop_token_ids": [[50, 51], [60]]}),
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "the quick brown fox"},
                                           {"role": "user", "content": "hello world"}],
                              "max_tokens": 6, "n": 2, "logprobs": True, "top_logprobs": 3}),
    ("/v1/completions", {"prompt": "says", "max_tokens": 16, "guided_choice": ["hello", "dog", "lazy"]}),
    ("/v1/completions", {"prompt": "quick", "max_tokens": 16, "guided_regex": "(the|a) (fox|dog)"}),
]


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_greedy_responses_equal_jax(both, i):
    """The same greedy request to both servers: the JAX server's JSON."""
    ports, _ = both
    path, body = REQUESTS[i]
    (ws, wd), (gs, gd) = (_post(ports[k], path, body) for k in ("jax", "torch"))
    assert gs == ws == 200, (gd, wd)
    _close(json.loads(gd), json.loads(wd))


@pytest.mark.parametrize("path,body", [REQUESTS[1], REQUESTS[5], REQUESTS[4], REQUESTS[6]],
                         ids=["completion", "chat", "n2", "guided"])
def test_streams_concatenate_to_the_answer(both, path, body):
    """Streamed events, per choice, concatenate to the non-streaming
    tokens, text and logprobs of the port's own server."""
    port = both[0]["torch"]
    status, data = _post(port, path, body)
    assert status == 200
    answer = json.loads(data)
    status, data = _post(port, path, {**body, "stream": True})
    assert status == 200
    events = _events(data)
    chat = path.endswith("chat/completions")
    for c, choice in enumerate(answer["choices"]):
        if chat:
            mine = [e["choices"][0] for e in events if e["choices"][0]["index"] == c]
            assert all(e["object"] == "chat.completion.chunk" for e in events)
            assert "".join(m["delta"]["content"] for m in mine) == choice["message"]["content"]
            if "logprobs" in choice:
                assert [x for m in mine for x in m["logprobs"]["content"]] == choice["logprobs"]["content"]
        else:
            mine = [e for e in events if e.get("index", 0) == c]
            assert [t for e in mine for t in e["token_ids"]] == choice["token_ids"]
            assert "".join(e["text"] for e in mine) == choice["text"]
            if "logprobs" in choice:
                assert [x for e in mine for x in e["logprobs"]] == choice["logprobs"]["token_logprobs"]


def test_sampled_seeded_requests_repeat(both):
    """A seeded sampled request returns the same tokens twice, also
    beside other traffic; a guided sampled one stays in its grammar."""
    port = both[0]["torch"]
    body = {"prompt": "the lazy dog", "max_tokens": 10, "temperature": 0.9, "top_k": 20, "top_p": 0.9,
            "min_p": 0.02, "seed": 11}
    first = json.loads(_post(port, "/v1/completions", body)[1])["choices"][0]["token_ids"]
    results = {}

    def go(name, b):
        results[name] = json.loads(_post(port, "/v1/completions", b)[1])

    threads = [threading.Thread(target=go, args=("seeded", body)),
               threading.Thread(target=go, args=("other", {"prompt_ids": [1, 2, 3], "max_tokens": 12,
                                                            "temperature": 1.0}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results["seeded"]["choices"][0]["token_ids"] == first
    tb = TG.token_bytes_from_tokenizer(_tokenizer())
    for seed in range(3):
        status, data = _post(port, "/v1/completions", {"prompt": "quick", "max_tokens": 16, "temperature": 1.5,
                                                       "seed": seed, "guided_choice": ["hello", "dog", "lazy"]})
        assert status == 200
        out = json.loads(data)["choices"][0]["token_ids"]
        assert out[-1] == _tokenizer().eos_token_id
        assert b"".join(tb[t] for t in out[:-1]).decode() in ("hello", "dog", "lazy")


ERRORS = [
    ("/v1/completions", b"{not json", True),
    ("/v1/nowhere", {}, False),
    ("/v1/completions", {}, False),
    ("/v1/completions", {"prompt_ids": ["x"]}, False),
    ("/v1/completions", {"prompt_ids": [1], "max_tokens": "many"}, False),
    ("/v1/completions", {"prompt_ids": [1], "n": 0}, False),
    ("/v1/completions", {"prompt_ids": [1], "temperature": "hot"}, False),
    ("/v1/completions", {"prompt_ids": [1], "logit_bias": {"x": "y"}}, False),
    ("/v1/completions", {"prompt_ids": [1], "logit_bias": {"500": 1.0}}, False),
    ("/v1/completions", {"prompt_ids": [1], "top_logprobs": 21}, False),
    ("/v1/completions", {"prompt_ids": [1] * 70}, False),
    ("/v1/completions", {"prompt": "x", "guided_choice": ["a"], "guided_regex": "a"}, False),
    ("/v1/completions", {"prompt": "x", "response_format": {"type": "yaml"}}, False),
    ("/v1/completions", {"prompt": "x", "response_format": {"type": "json_object"}}, False),
    ("/v1/chat/completions", {"messages": "hi"}, False),
    ("/v1/cancel", {"id": "cmpl-x"}, False),
    ("/v1/cancel", {"id": "cmpl-999"}, False),
]


def test_errors_and_endpoints_equal_jax(both):
    """Client errors get JAX's status codes; /health, /v1/models and an
    unknown GET answer as JAX's; /metrics is Prometheus text whose
    counters moved with the traffic above."""
    ports, servers = both
    for path, body, raw in ERRORS:
        got, want = (_post(ports[k], path, body, raw)[0] for k in ("torch", "jax"))
        assert got == want, (path, body)
    for path in ("/health", "/v1/models", "/nope"):
        (gs, gt, gd), (ws, wt, wd) = (_get(ports[k], path) for k in ("torch", "jax"))
        assert (gs, gt) == (ws, wt)
        _close(json.loads(gd), json.loads(wd))
    status, ctype, data = _get(ports["torch"], "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    metrics = dict(line.split() for line in data.decode().splitlines() if not line.startswith("#"))
    m = servers["torch"].metrics()
    assert float(metrics["modegpt_requests_completed_total"]) == m["requests_completed"] > 0
    assert float(metrics["modegpt_generated_tokens_total"]) == m["generated_tokens"] > 0
    assert metrics["modegpt_slots"] == "2" and float(metrics["modegpt_scheduler_steps_total"]) > 0


def test_cancel_frees_the_slot_and_a_full_queue_answers_429(hf_model):
    """One slot, max_queue 0. A step hook lets the scheduler take exactly
    one step, so the first request holds the slot by construction: a
    second request gets 429, a cancel of the first frees the slot and
    ends its stream, and a third request is then served."""
    spec, params = _port_params(hf_model)
    batcher = TBatcher(t_pad(spec, params), slots=1, max_len=64, prefill_bucket=8)
    allowed = [1]
    real_step = batcher.step

    def gated_step(generator=None):
        if allowed[0] <= 0:
            time.sleep(0.002)
            return {}, False
        allowed[0] -= 1
        return real_step(generator)

    batcher.step = gated_step
    server = TS.InferenceServer(batcher, model_id="gate", max_queue=0)
    httpd, port = _start(server, TS)
    try:
        streamed = {}
        t = threading.Thread(target=lambda: streamed.update(
            reply=_post(port, "/v1/completions", {"prompt_ids": [3, 4, 5], "max_tokens": 40, "stream": True})))
        t.start()
        deadline = time.time() + 60
        while batcher.slot_req[0] is None or allowed[0] > 0:
            assert time.time() < deadline
            time.sleep(0.01)
        status, data = _post(port, "/v1/completions", {"prompt_ids": [1, 2], "max_tokens": 2})
        assert status == 429 and "queue full" in json.loads(data)["error"]
        rid = batcher.slot_req[0]
        status, data = _post(port, "/v1/cancel", {"id": f"cmpl-{rid}"})
        assert status == 200 and json.loads(data) == {"id": f"cmpl-{rid}", "cancelled": True}
        t.join(timeout=60)
        assert not t.is_alive() and streamed["reply"][0] == 200
        assert batcher.slot_req[0] is None
        allowed[0] = 10_000
        status, data = _post(port, "/v1/completions", {"prompt_ids": [1, 2], "max_tokens": 3})
        assert status == 200 and len(json.loads(data)["choices"][0]["token_ids"]) == 3
        assert server.metrics()["requests_cancelled"] == 1
    finally:
        httpd.shutdown()
        server.close()


def test_cancel_is_served_between_steps(hf_model):
    """A cancel reaches a busy scheduler between two steps: a 400-token
    stream, cancelled after its first event, stops long before its
    budget and frees its slot."""
    spec, params = _port_params(hf_model)
    batcher = TBatcher(t_pad(spec, params), slots=1, max_len=512, prefill_bucket=8)
    server = TS.InferenceServer(batcher, model_id="busy")
    httpd, port = _start(server, TS)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions", body=json.dumps({"prompt_ids": [3, 4, 5], "max_tokens": 400,
                                                                 "stream": True}))
        resp = conn.getresponse()
        first = _events(resp.readline() + resp.readline())
        status, data = _post(port, "/v1/cancel", {"id": first[0]["id"]})
        rest = resp.read()
        conn.close()
        assert status == 200 and json.loads(data)["cancelled"] is True
        assert b"[DONE]" in rest
        assert sum(len(e["token_ids"]) for e in first + _events(rest)) < 200
        assert server.occupancy()["busy"] == 0
    finally:
        httpd.shutdown()
        server.close()


def _port_params(hf_model):
    from modegpt_tpu_torch.models.hf import params_from_hf_model

    return params_from_hf_model(hf_model, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_cli_on_cpu(hf_model, tmp_path, monkeypatch):
    """`python -m modegpt_tpu_torch.server --device cpu` on a checkpoint
    directory with its tokenizer answers /health and one completion with
    the in-process server's tokens; --tensor_parallel 2 in a single
    process raises (the world size does not fit the mesh; the launched
    form is held in tests/test_torch_tp_serving.py)."""
    for var in ("WORLD_SIZE", "RANK", "MODEGPT_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="tensor_parallel 2 does not divide the world size 1"):
        TS.main(["--model", str(tmp_path), "--tensor_parallel", "2", "--device", "cpu"])
    hf_model.save_pretrained(tmp_path)
    _tokenizer().save_pretrained(tmp_path)
    port = _free_port()
    env = {**os.environ, "HF_HUB_OFFLINE": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen([sys.executable, "-m", "modegpt_tpu_torch.server", "--model", str(tmp_path),
                             "--port", str(port), "--device", "cpu", "--slots", "2", "--max_len", "64",
                             "--prefill_bucket", "8"], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline
            try:
                status, _, data = _get(port, "/health")
                break
            except OSError:
                time.sleep(0.2)
        assert status == 200 and json.loads(data)["status"] == "ok"
        body = {"prompt": "the quick brown fox", "max_tokens": 5}
        status, data = _post(port, "/v1/completions", body)
        assert status == 200
        spec, params = _port_params(hf_model)
        tok = _tokenizer()
        b = TBatcher(t_pad(spec, params), slots=2, max_len=64, prefill_bucket=8, eos_token_id=tok.eos_token_id)
        rid = b.submit(tok(body["prompt"])["input_ids"], max_new_tokens=5)
        want = b.run()[rid][len(tok(body["prompt"])["input_ids"]):]
        assert json.loads(data)["choices"][0]["token_ids"] == want
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
