"""HTTP serving frontend: OpenAI-style completions over the batcher.

Port of ``modegpt_tpu.server``. A single scheduler thread owns the
`ContinuousBatcher` (`models.serving`) and drives `step()` while work is
outstanding; it is the only thread that touches torch (it selects the
batcher's card with ``torch.cuda.set_device`` and holds the sampling
``torch.Generator`` on it) or the batcher. HTTP handler threads hand it
their submits, cancels and snapshots through a queue, applied between
two steps, and wait on per-request events and queues, so the card sees
one stream of dispatches (the slot table does the batching, not the
HTTP layer) and a cancel waits at most one step. The JAX server instead
runs each step under the lock its handlers take, which the stepping
thread takes back at once: there a cancel can wait until the batcher
drains.

Endpoints (stdlib `http.server`, no extra dependencies):

* ``POST /v1/completions``: body ``{"prompt": str}`` (needs a
  tokenizer) or ``{"prompt_ids": [int, ...]}``; optional
  ``max_tokens``, ``"stream": true``, per-request sampling fields
  (below), and stop sequences: ``stop_token_ids`` (a token-id
  sequence or list of them; exact) or ``stop`` strings
  (tokenizer-encoded; may miss a stop text the model produces through
  another tokenization). Generation ends at the earliest match with the
  matched tokens excluded; streaming withholds the last
  (max_stop_len - 1) in-flight tokens until a match is ruled out, so
  stop tokens are never emitted. Non-streaming returns one
  OpenAI-shaped JSON object; streaming returns Server-Sent Events
  (``data: {...}`` lines, ended by ``data: [DONE]``), each event
  carrying the text/token delta since the previous one. ``n`` > 1
  returns that many independently decoded choices (streaming included:
  each SSE event carries its choice ``index``); ``logprobs`` (a bool,
  or the legacy int N) adds each generated token's raw-model logprob,
  ``top_logprobs`` N the top-N alternatives. Guided decoding:
  ``guided_regex`` / ``guided_choice`` / ``guided_json`` /
  ``response_format`` constrain the output to a grammar
  (`models.guided`; see `InferenceServer.build_guide`); ``logit_bias``
  ({token_id: bias}) is added to the logits and ``min_tokens`` holds EOS
  off until that many tokens are generated.
* ``POST /v1/chat/completions``: body ``{"messages": [{"role",
  "content"}, ...]}``: the tokenizer's own chat template renders the
  turn (a plain ``role: content`` transcript when it has none); the
  same sampling/stop/stream/n fields; ``chat.completion`` /
  ``chat.completion.chunk``-shaped responses.
* ``POST /v1/cancel``: body ``{"id": "cmpl-<n>"}``: abort a queued or
  in-flight request, freeing its slot (also done when a streaming
  client disconnects mid-generation).
* ``GET /v1/models``: the served model id.
* ``GET /health``: scheduler liveness and slot occupancy.
* ``GET /metrics``: Prometheus text exposition: request, token and step
  counters, slot and queue gauges, prefix-cache and speculative
  counters when enabled.

Back-pressure: ``--max_queue N`` bounds the requests waiting for a slot;
a submission over the limit gets HTTP 429 instead of an unbounded queue.

Per-request sampling: with the batcher in ``per_request_sampling`` mode
(the CLI's default), each request may carry its own ``temperature`` /
``top_k`` / ``top_p`` / ``min_p`` / ``repetition_penalty`` /
``presence_penalty`` / ``frequency_penalty`` / ``seed`` (a seeded
request's sampled stream is a function of seed, prompt and knobs alone,
whatever else shares the batch); they land in the batcher's per-slot
knob table (`generate.sample_rows`). Fields a request omits fall back to
the server-level defaults. MoE execution, int8 weights and KV,
steps_per_dispatch and prefill execution stay server-level settings.

CLI: ``python -m modegpt_tpu_torch.server --model <artifact-or-hf-dir>
--port 8000`` with the JAX server's flags, plus ``--device`` (a torch
device: "cuda" by default, "cuda:N", N, or "cpu").

Tensor parallelism (``--tensor_parallel N``): SPMD, one process per rank
(``python -m torch.distributed.run --nproc_per_node N -m
modegpt_tpu_torch.server ... --tensor_parallel N``; NCCL with a card a
rank, gloo on the CPU or when asked for with
``MODEGPT_DIST_BACKEND=gloo``). The world's W ranks form the mesh
data:W/N,model:N (W a multiple of N), and each rank's batcher holds its
shard (`parallel.mesh.shard_serving`). Rank 0 alone runs the HTTP server
and the scheduler thread; every round that thread broadcasts to the
other ranks the submits and cancels it applied before the step (one
pickled list; an empty one every `KEEPALIVE_S` seconds when idle, and a
stop at shutdown), and each of them (`follow`) applies them to its own
batcher and steps in lockstep. Where the JAX server is one controller
over every device, the port's ranks are processes kept alike by that
broadcast.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

__all__ = ["InferenceServer", "QueueFull", "make_http_server", "main"]


class QueueFull(RuntimeError):
    """Back-pressure: more than `max_queue` requests waiting for a slot."""


class _Request:
    __slots__ = ("rid", "prompt_len", "done", "tokens", "stream_q", "emitted",
                 "holdback", "want_lp", "lp", "top_k_lp", "top")

    def __init__(self, rid: int, prompt_len: int, streaming: bool,
                 holdback: int = 0, want_lp: bool = False, top_k_lp: int = 0):
        self.rid = rid
        self.prompt_len = prompt_len
        self.done = threading.Event()
        self.tokens: Optional[List[int]] = None  # full sequence when done
        self.want_lp = want_lp
        self.lp: Optional[List[float]] = None  # generated-token logprobs when done
        self.top_k_lp = top_k_lp  # OpenAI top_logprobs k (0 = off)
        self.top: Optional[List] = None  # [(ids, lps), ...] when done
        # streaming consumers read token-id deltas from this queue;
        # None terminates the stream
        self.stream_q: Optional[queue.Queue] = queue.Queue() if streaming else None
        self.emitted = 0  # generated tokens already pushed to stream_q
        # with stop sequences, the last (max_stop_len - 1) in-flight
        # tokens are withheld from the stream: they may be the prefix
        # of a stop match the batcher will truncate next step (OpenAI
        # semantics exclude stop text from output); flushed on finish
        self.holdback = holdback


class InferenceServer:
    """Thread-safe facade over one ContinuousBatcher.

    One scheduler thread owns the batcher: it alone touches torch
    (drawing sampled tokens from a ``torch.Generator`` on the batcher's
    device, seeded 0) and the batcher's host state. It calls
    ``batcher.step()`` while requests are outstanding and sleeps on a
    condition variable otherwise. The client surface (`submit`, `cancel`,
    `metrics`, `occupancy`) may be called from any thread: each call
    hands an operation to the scheduler thread through a queue and waits
    for it, so an operation waits at most one step, however busy the
    batcher is, and never runs beside one. Emitted tokens are fanned out
    to streaming queues after every step (the batcher's host-side slot
    state is the source of truth: no device traffic beyond what the step
    functions already fetch).
    """

    def __init__(self, batcher, tokenizer=None, model_id: str = "modegpt-tpu-torch",
                 max_queue: Optional[int] = None, mesh=None):
        self.batcher = batcher
        # tensor-parallel serving: this is rank 0 of `mesh`'s world; each
        # round the scheduler thread sends the other ranks (`follow`) the
        # submits and cancels it applied, and a keep-alive when idle
        self._mesh = mesh if mesh is not None and mesh.initialized else None
        self._sent: List = []  # records of this round's batcher operations (scheduler thread only)
        self.tokenizer = tokenizer
        self.model_id = model_id
        # back-pressure bound on requests waiting for a slot (in-flight
        # slots are bounded by the slot table itself); None = unbounded
        self.max_queue = max_queue
        # guided decoding: compiled TokenGuides keyed by their lowered
        # regex (grammar compilation and token lifting are one-time costs;
        # steady-state guided traffic hits the cache). Guides memoise
        # per-DFA-state token rows, so sharing one guide across requests
        # is what makes repeat grammars cheap.
        self._guide_cache: Dict[str, object] = {}
        self._token_bytes = None  # lazy token->bytes table for the tokenizer
        # serving counters for GET /metrics (scheduler thread only)
        import time as _time

        self._t0 = _time.time()
        self._counters = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "requests_cancelled": 0,
            "prompt_tokens": 0,
            "generated_tokens": 0,
            "scheduler_steps": 0,
        }
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._ops: List = []  # operations handed to the scheduler thread (under the lock)
        self._requests: Dict[int, _Request] = {}  # scheduler thread only
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _call(self, fn):
        """Run ``fn()`` on the scheduler thread between two steps; return
        its result, or raise its exception, in the calling thread."""
        done, box = threading.Event(), {}

        def op():
            try:
                box["value"] = fn()
            except Exception as e:  # the caller's error, raised in the caller's thread
                box["error"] = e
            finally:
                done.set()

        with self._work:
            if self._stop or not self._thread.is_alive():
                raise RuntimeError("the server is closed")
            self._ops.append(op)
            self._work.notify()
        done.wait()
        if "error" in box:
            raise box["error"]
        return box["value"]

    # -- client surface --------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               streaming: bool = False,
               sampling: Optional[Dict[str, float]] = None,
               stop: Optional[List[List[int]]] = None,
               logprobs: bool = False, top_logprobs: int = 0, guide=None,
               logit_bias: Optional[Dict[int, float]] = None,
               min_tokens: int = 0) -> _Request:
        """`sampling` holds per-request overrides (temperature, top_k,
        top_p, min_p, repetition_penalty, presence_penalty,
        frequency_penalty, seed) forwarded to the batcher; it needs a
        per_request_sampling batcher. `stop` is a list of token-id
        sequences ending generation (matched tokens excluded).
        `logprobs` records each generated token's raw-model logprob;
        `top_logprobs=k` also records the top-k raw-model alternatives
        per position (implies logprobs). `guide` is a
        `models.guided.TokenGuide` constraining the output to a grammar
        (see build_guide). Raises QueueFull over ``max_queue``."""
        # empty sequences can never match (the batcher drops them too);
        # dropping them here keeps the streaming holdback consistent
        # with what was actually submitted
        if stop is not None:
            stop = [q for q in stop if len(q) > 0] or None
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)

        def op():
            if self.max_queue is not None:
                free = sum(r is None for r in self.batcher.slot_req)
                # requests ahead of this one that cannot go straight into
                # a free slot; max_queue=0 = admit-or-reject
                waiting = len(self.batcher.queue) - free
                if waiting >= self.max_queue:
                    raise QueueFull(f"queue full ({len(self.batcher.queue)} waiting for {free} free slots, "
                                    f"max_queue {self.max_queue})")
            kw = dict(max_new_tokens=max_new_tokens, stop=stop, logprobs=logprobs, top_logprobs=top_logprobs,
                      guide=guide, logit_bias=logit_bias, min_tokens=min_tokens, **(sampling or {}))
            rid = self.batcher.submit(ids, **kw)
            if self._mesh is not None:
                self._sent.append(("submit", ids, kw))
            holdback = max((len(q) for q in stop), default=1) - 1 if stop else 0
            req = _Request(rid, int(ids.shape[0]), streaming, holdback=holdback,
                           want_lp=logprobs or top_logprobs > 0, top_k_lp=int(top_logprobs))
            self._requests[rid] = req
            self._counters["requests_submitted"] += 1
            self._counters["prompt_tokens"] += int(ids.shape[0])
            return req

        return self._call(op)

    def build_guide(self, body: Dict):
        """TokenGuide for a request body's guided-decoding fields, or
        None when it has none. Accepted (vLLM/OpenAI-style, at most one):

        * ``guided_regex``: a regex the output must fullmatch;
        * ``guided_choice``: a list of strings, output is exactly one;
        * ``guided_json``: a JSON-schema dict, or ``true`` for any JSON
          object (containers nested to depth 3);
        * ``response_format``: ``{"type": "json_object"}`` or
          ``{"type": "json_schema", "json_schema": {"schema": {...}}}``
          (the OpenAI shapes; ``{"type": "text"}`` means unconstrained).

        Raises ValueError for client errors (conflicting fields, bad
        grammar, no tokenizer). Compiled guides are cached by their
        lowered regex."""
        from modegpt_tpu_torch.models import guided as G

        fields = [k for k in ("guided_regex", "guided_choice", "guided_json")
                  if body.get(k) is not None]
        rf = body.get("response_format")
        rf_type = None
        if rf is not None:
            if not isinstance(rf, dict) or rf.get("type") not in (
                "text", "json_object", "json_schema"
            ):
                raise ValueError(
                    'response_format must be {"type": "text" | "json_object" '
                    '| "json_schema"}'
                )
            rf_type = rf["type"]
            if rf_type != "text":
                fields.append("response_format")
        if len(fields) > 1:
            raise ValueError(f"at most one guided-decoding field, got {fields}")
        if not fields:
            return None
        f = fields[0]
        if f == "guided_regex":
            pattern = str(body["guided_regex"])
        elif f == "guided_choice":
            choices = body["guided_choice"]
            if not isinstance(choices, list) or not all(
                isinstance(c, str) for c in choices
            ):
                raise ValueError("guided_choice must be a list of strings")
            pattern = G.regex_for_choice(choices)
        elif f == "guided_json":
            gj = body["guided_json"]
            if isinstance(gj, str):  # vLLM also accepts an encoded schema
                try:
                    gj = json.loads(gj)
                except json.JSONDecodeError as e:
                    raise ValueError(f"guided_json is not valid JSON: {e}")
            pattern = (G.regex_for_json_object() if gj is True
                       else G.regex_for_json_schema(gj))
        else:  # response_format
            if rf_type == "json_object":
                pattern = G.regex_for_json_object()
            else:
                schema = (rf.get("json_schema") or {}).get("schema")
                if not isinstance(schema, dict):
                    raise ValueError(
                        "response_format json_schema needs json_schema.schema"
                    )
                pattern = G.regex_for_json_schema(schema)
        guide = self._guide_cache.get(pattern)
        if guide is None:
            if self.tokenizer is None:
                raise ValueError("guided decoding needs a tokenizer")
            eos = self.batcher.eos
            if eos is None:
                raise ValueError("guided decoding needs an eos_token_id")
            if self._token_bytes is None:
                self._token_bytes = G.token_bytes_from_tokenizer(self.tokenizer)
            guide = G.compile_regex(
                pattern, self._token_bytes, eos,
                vocab_size=self.batcher.vocab_size,
            )
            self._guide_cache[pattern] = guide
        return guide

    def cancel(self, rid: int) -> bool:
        """Abort a queued or in-flight request (frees its slot for the
        next admission); wakes any streaming consumer with end-of-stream.
        False when `rid` is unknown or already finished."""
        def op():
            ok = self.batcher.cancel(rid)
            if self._mesh is not None:
                self._sent.append(("cancel", rid))
            req = self._requests.pop(rid, None)
            if req is not None:
                if req.stream_q is not None:
                    req.stream_q.put(None)
                req.done.set()
            if ok:
                self._counters["requests_cancelled"] += 1
            return ok

        return self._call(op)

    def close(self):
        with self._work:
            self._stop = True
            self._work.notify()
        self._thread.join(timeout=30)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def metrics(self) -> Dict[str, float]:
        """Counter and gauge snapshot for GET /metrics (Prometheus text
        exposition in the handler; this returns plain numbers)."""
        import time as _time

        def op():
            b = self.batcher
            m = dict(self._counters)
            m["slots"] = b.slots
            m["slots_busy"] = sum(r is not None for r in b.slot_req)
            m["queue_depth"] = len(b.queue)
            m["uptime_seconds"] = _time.time() - self._t0
            if b.prefix_cache:
                m["prefix_hits"] = b.prefix_hits
                m["prefix_tokens_reused"] = b.prefix_tokens_reused
            if b.spec_decode != "off" and b.stats:
                m["spec_drafted"] = sum(s["drafted"] for s in b.stats.values())
                m["spec_accepted"] = sum(s["accepted"] for s in b.stats.values())
            return m

        return self._call(op)

    def occupancy(self) -> Dict[str, int]:
        def op():
            b = self.batcher
            occ = {"slots": b.slots, "busy": sum(r is not None for r in b.slot_req), "queued": len(b.queue)}
            if b.prefix_cache:
                occ["prefix_hits"] = b.prefix_hits
                occ["prefix_tokens_reused"] = b.prefix_tokens_reused
            return occ

        return self._call(op)

    # -- scheduler --------------------------------------------------------

    def _outstanding(self) -> bool:
        b = self.batcher
        return bool(b.queue) or any(r is not None for r in b.slot_req)

    def _loop(self):
        import torch

        device = self.batcher.device
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        generator = torch.Generator(device=device).manual_seed(0)
        # idle, the followers still hear from rank 0 within every
        # keep-alive period, well inside their collective timeout
        heartbeat = None if self._mesh is None else KEEPALIVE_S
        while True:
            with self._work:
                while not self._stop and not self._ops and not self._outstanding():
                    if not self._work.wait(heartbeat):
                        break  # the keep-alive
                ops, self._ops = self._ops, []
                stop = self._stop
            for op in ops:
                op()
            if self._mesh is not None:
                sent, self._sent = self._sent, []
                _exchange(self._mesh, (sent, stop))
            if stop:
                for req in self._requests.values():
                    if req.stream_q is not None:
                        req.stream_q.put(None)
                    req.done.set()
                return
            if not self._outstanding():
                continue
            finished, _ = self.batcher.step(generator)
            self._counters["scheduler_steps"] += 1
            self._fan_out(finished)

    def _fan_out(self, finished: Dict[int, List[int]]) -> None:
        """After a step: push the streaming deltas of the slots still in
        flight, and hand finished requests their tokens and logprobs."""
        b = self.batcher
        for s in range(b.slots):
            rid = b.slot_req[s]
            req = self._requests.get(rid) if rid is not None else None
            if req is not None and req.stream_q is not None:
                gen = len(b.slot_out[s]) - req.prompt_len - req.holdback
                if gen > req.emitted:
                    req.stream_q.put((
                        b.slot_out[s][req.prompt_len + req.emitted : req.prompt_len + gen],
                        b.slot_lp[s][req.emitted:gen] if req.want_lp else None,
                        b.slot_top[s][req.emitted:gen] if req.top_k_lp else None,
                    ))
                    req.emitted = gen
        for rid, tokens in finished.items():
            req = self._requests.pop(rid, None)
            if req is None:
                continue
            self._counters["requests_completed"] += 1
            self._counters["generated_tokens"] += len(tokens) - req.prompt_len
            req.tokens = tokens
            if req.want_lp:
                req.lp = b.logprobs.pop(rid, None)
            if req.top_k_lp:
                req.top = b.top_logprobs.pop(rid, None)
            if req.stream_q is not None:
                gen = len(tokens) - req.prompt_len
                if gen > req.emitted:
                    req.stream_q.put((
                        tokens[req.prompt_len + req.emitted : req.prompt_len + gen],
                        req.lp[req.emitted:gen] if req.lp is not None else None,
                        req.top[req.emitted:gen] if req.top is not None else None,
                    ))
                req.stream_q.put(None)
            req.done.set()


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode()


def _chat_prompt_ids(tokenizer, messages) -> List[int]:
    """Token ids for a chat turn: the tokenizer's own chat template
    when it has one (`apply_chat_template` with a generation prompt),
    else a plain `role: content` transcript ending with an open
    `assistant:` line — a functional fallback, not any model's trained
    format."""
    msgs = [{"role": str(m["role"]), "content": str(m["content"])}
            for m in messages]
    if getattr(tokenizer, "chat_template", None):
        return tokenizer.apply_chat_template(
            msgs, add_generation_prompt=True, tokenize=True
        )
    text = "".join(f"{m['role']}: {m['content']}\n" for m in msgs) + "assistant:"
    return tokenizer(text)["input_ids"]


def make_http_server(server: InferenceServer, host: str = "127.0.0.1",
                     port: int = 8000, default_max_tokens: int = 64,
                     request_timeout: float = 600.0) -> ThreadingHTTPServer:
    """Build (but do not start) the ThreadingHTTPServer; call
    ``.serve_forever()`` (typically in a thread) and ``.shutdown()``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            import logging

            logging.getLogger("modegpt_tpu_torch.server").debug(fmt, *args)

        def _send_json(self, code: int, obj) -> None:
            body = _json_bytes(obj)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        _GAUGES = {"slots", "slots_busy", "queue_depth", "uptime_seconds"}

        def do_GET(self):
            if self.path == "/metrics":
                # Prometheus text exposition (version 0.0.4), stdlib-only
                m = server.metrics()
                lines = []
                for k in sorted(m):
                    if k in self._GAUGES:
                        name, typ = f"modegpt_{k}", "gauge"
                    else:
                        name, typ = f"modegpt_{k}_total", "counter"
                    lines.append(f"# TYPE {name} {typ}")
                    lines.append(f"{name} {m[k]}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                occ = server.occupancy()
                occ["status"] = "ok" if server.alive else "dead"
                self._send_json(200 if server.alive else 503, occ)
            elif self.path == "/v1/models":
                self._send_json(
                    200,
                    {"object": "list",
                     "data": [{"id": server.model_id, "object": "model"}]},
                )
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(400, {"error": f"bad JSON body: {e}"})
                return
            if self.path in ("/v1/cancel", "/cancel"):
                rid = str(body.get("id", ""))
                for prefix in ("chatcmpl-", "cmpl-"):
                    if rid.startswith(prefix):
                        rid = rid[len(prefix):]
                        break
                try:
                    ok = server.cancel(int(rid))
                except ValueError:
                    self._send_json(400, {"error": "id must be cmpl-<n>"})
                    return
                self._send_json(200 if ok else 404, {"id": f"cmpl-{rid}", "cancelled": ok})
                return
            is_chat = self.path in ("/v1/chat/completions", "/chat/completions")
            if not is_chat and self.path not in ("/v1/completions", "/completions"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            if is_chat:
                msgs = body.get("messages")
                if not msgs or not isinstance(msgs, list):
                    self._send_json(400, {"error": "need a messages list"})
                    return
                if server.tokenizer is None:
                    self._send_json(400, {"error": "chat completions need a "
                                          "tokenizer; use /v1/completions "
                                          "with prompt_ids"})
                    return
                try:
                    ids = _chat_prompt_ids(server.tokenizer, msgs)
                # chat templates raise model-specific errors (jinja
                # TemplateError for role-order violations, ValueError,
                # KeyError for missing fields) — all are client errors
                except Exception as e:
                    self._send_json(400, {"error": f"bad messages: {e}"})
                    return
            elif "prompt_ids" in body:
                try:
                    ids = [int(t) for t in body["prompt_ids"]]
                except (TypeError, ValueError):
                    self._send_json(400, {"error": "prompt_ids must be a list of ints"})
                    return
            elif "prompt" in body:
                if server.tokenizer is None:
                    self._send_json(
                        400,
                        {"error": "server has no tokenizer; pass prompt_ids"},
                    )
                    return
                ids = server.tokenizer(str(body["prompt"]))["input_ids"]
            else:
                self._send_json(400, {"error": "need prompt or prompt_ids"})
                return
            try:
                max_tokens = int(body.get("max_tokens", default_max_tokens))
                n_choices = int(body.get("n", 1))
            except (TypeError, ValueError):
                self._send_json(400, {"error": "max_tokens and n must be ints"})
                return
            stream = bool(body.get("stream", False))
            if n_choices < 1:
                self._send_json(400, {"error": "n must be >= 1"})
                return
            try:
                sampling = {
                    k: (int(body[k]) if k in ("top_k", "seed") else float(body[k]))
                    for k in ("temperature", "top_k", "top_p", "min_p",
                              "repetition_penalty", "presence_penalty",
                              "frequency_penalty", "seed")
                    if body.get(k) is not None
                }
            except (TypeError, ValueError):
                self._send_json(400, {"error": "sampling fields must be numbers"})
                return
            # stop sequences: `stop_token_ids` is exact (a sequence or a
            # list of sequences); string `stop` is tokenizer-encoded —
            # matching is then on the encoded ids, which can miss a stop
            # text the model produces via a different tokenization
            # (token-boundary caveat; pass stop_token_ids for exactness)
            stop: List[List[int]] = []
            try:
                sti = body.get("stop_token_ids")
                if sti:
                    if isinstance(sti[0], int):
                        sti = [sti]
                    stop.extend([int(t) for t in q] for q in sti)
            except (TypeError, ValueError):
                self._send_json(400, {"error": "stop_token_ids must be ints"})
                return
            stop_strs = body.get("stop")
            if stop_strs:
                if server.tokenizer is None:
                    self._send_json(
                        400, {"error": "string stop needs a tokenizer; "
                              "pass stop_token_ids"})
                    return
                if isinstance(stop_strs, str):
                    stop_strs = [stop_strs]
                stop.extend(
                    server.tokenizer(s, add_special_tokens=False)["input_ids"]
                    for s in stop_strs
                )
            # OpenAI logit_bias: {"<token_id>": bias} (string keys, like
            # the OpenAI API) or int keys; min_tokens suppresses EOS
            # until that many tokens are generated (vLLM field)
            logit_bias = None
            try:
                if body.get("logit_bias"):
                    logit_bias = {int(k): float(v)
                                  for k, v in body["logit_bias"].items()}
                min_tokens = int(body.get("min_tokens", 0))
            except (TypeError, ValueError, AttributeError):
                self._send_json(400, {"error": "logit_bias must map token "
                                      "ids to numbers; min_tokens an int"})
                return
            # OpenAI logprobs, both API shapes: legacy completions take
            # an int N here (chosen-token logprob + top-N alternatives
            # per position); chat takes logprobs: true plus
            # top_logprobs: N. Either shape works on either route.
            raw_lp = body.get("logprobs")
            top_k_lp = 0
            try:
                if isinstance(raw_lp, bool) or raw_lp is None:
                    want_lp = bool(raw_lp)
                else:
                    top_k_lp = int(raw_lp)
                    want_lp = True
                top_k_lp = max(top_k_lp, int(body.get("top_logprobs") or 0))
            except (TypeError, ValueError):
                self._send_json(400, {"error": "logprobs must be a bool or "
                                      "an int; top_logprobs an int"})
                return
            from modegpt_tpu_torch.models.serving import TOP_LP_K

            if not 0 <= top_k_lp <= TOP_LP_K:
                self._send_json(400, {"error": f"top_logprobs must be in "
                                      f"[0, {TOP_LP_K}], got {top_k_lp}"})
                return
            # guided decoding (regex / choice / JSON): grammar errors
            # and unsupported combinations are client errors
            try:
                guide = server.build_guide(body)
            except ValueError as e:
                self._send_json(400, {"error": f"bad guided request: {e}"})
                return
            reqs = []
            try:
                for _ in range(n_choices):
                    reqs.append(
                        server.submit(ids, max_new_tokens=max_tokens,
                                      streaming=stream, sampling=sampling,
                                      stop=stop or None, logprobs=want_lp,
                                      top_logprobs=top_k_lp,
                                      guide=guide, logit_bias=logit_bias,
                                      min_tokens=min_tokens)
                    )
            except QueueFull as e:
                for r in reqs:
                    server.cancel(r.rid)
                self._send_json(429, {"error": str(e)})
                return
            except ValueError as e:  # over max_len etc.
                self._send_json(400, {"error": str(e)})
                return
            if stream:
                self._stream_response(reqs, chat=is_chat)
                return
            choices = []
            done_tokens = 0
            for i, req in enumerate(reqs):
                if not req.done.wait(timeout=request_timeout):
                    # free the slots the timed-out request and its
                    # unfinished siblings still occupy
                    for r in reqs:
                        if not r.done.is_set():
                            server.cancel(r.rid)
                    self._send_json(504, {"error": "generation timed out"})
                    return
                new = req.tokens[req.prompt_len:]
                done_tokens += len(new)
                text = server.tokenizer.decode(new) if server.tokenizer else None
                if is_chat:
                    choice = {"index": i, "finish_reason": "stop",
                              "message": {"role": "assistant", "content": text}}
                else:
                    choice = {"index": i, "text": text, "token_ids": new,
                              "finish_reason": "stop"}
                if req.want_lp:
                    tok_s = (
                        (lambda t: server.tokenizer.decode([t]))
                        if server.tokenizer else str
                    )
                    if is_chat:
                        # OpenAI chat shape: logprobs.content[] entries
                        content_lp = []
                        for j, t in enumerate(new):
                            entry = {"token": tok_s(t),
                                     "logprob": req.lp[j]}
                            if req.top is not None:
                                ids_j, lps_j = req.top[j]
                                entry["top_logprobs"] = [
                                    {"token": tok_s(ti), "token_id": ti,
                                     "logprob": lj}
                                    for ti, lj in zip(ids_j, lps_j)
                                ]
                            content_lp.append(entry)
                        choice["logprobs"] = {"content": content_lp}
                    else:
                        # OpenAI legacy completions shape
                        lpd = {"token_logprobs": req.lp,
                               "tokens": [tok_s(t) for t in new]}
                        if req.top is not None:
                            # the legacy dict is keyed by decoded text;
                            # distinct ids can decode to the same string
                            # (byte-fallback pieces) — keep the highest
                            # logprob rather than last-write-wins
                            rows = []
                            for ids_j, lps_j in req.top:
                                row: Dict[str, float] = {}
                                for ti, lj in zip(ids_j, lps_j):
                                    s = tok_s(ti)
                                    if s not in row or lj > row[s]:
                                        row[s] = lj
                                rows.append(row)
                            lpd["top_logprobs"] = rows
                        choice["logprobs"] = lpd
                choices.append(choice)
            self._send_json(
                200,
                {
                    "id": (f"chatcmpl-{reqs[0].rid}" if is_chat
                           else f"cmpl-{reqs[0].rid}"),
                    "object": ("chat.completion" if is_chat
                               else "text_completion"),
                    "model": server.model_id,
                    "choices": choices,
                    "usage": {
                        "prompt_tokens": reqs[0].prompt_len,
                        "completion_tokens": done_tokens,
                        "total_tokens": reqs[0].prompt_len + done_tokens,
                    },
                },
            )

        def _stream_response(self, reqs: List[_Request],
                             chat: bool = False) -> None:
            """SSE-stream one or several choices (OpenAI n>1 streaming:
            every event carries its choice `index`; [DONE] after ALL
            choices finish). Multiple queues are drained round-robin
            with a short poll so one slow choice never starves the
            others' deltas."""
            import time as _time

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            # Decode deltas against the full generated prefix: BPE pieces
            # are not per-token decodable, so each event's `text` is the
            # tail of decode(all generated so far) beyond what was
            # already sent (the standard streaming-detokenizer trick).
            rid0 = reqs[0].rid
            multi = len(reqs) > 1
            live: Dict[int, _Request] = dict(enumerate(reqs))
            sent_tokens: Dict[int, List[int]] = {i: [] for i in live}
            sent_text: Dict[int, str] = {i: "" for i in live}
            deadline = _time.time() + request_timeout
            try:
                while live:
                    if _time.time() > deadline:
                        raise BrokenPipeError  # treat as gone: cancel all
                    got_any = False
                    for i, req in list(live.items()):
                        try:
                            delta = req.stream_q.get(
                                timeout=0.02 if multi else request_timeout
                            )
                        except queue.Empty:
                            continue
                        got_any = True
                        if delta is None:
                            del live[i]
                            continue
                        delta, lps, tops = delta
                        sent_tokens[i].extend(delta)
                        text_delta = None
                        if server.tokenizer is not None:
                            full = server.tokenizer.decode(sent_tokens[i])
                            text_delta = full[len(sent_text[i]):]
                            sent_text[i] = full
                        if chat:
                            event = {
                                "id": f"chatcmpl-{rid0}",
                                "object": "chat.completion.chunk",
                                "model": server.model_id,
                                "choices": [{"index": i,
                                             "delta": {"content": text_delta},
                                             "token_ids": delta}],
                            }
                            if lps is not None:
                                # OpenAI chat shape, same as non-stream:
                                # logprobs.content[] entries per token
                                tok_s = (
                                    (lambda t: server.tokenizer.decode([t]))
                                    if server.tokenizer else str
                                )
                                content_lp = []
                                for j, t in enumerate(delta):
                                    entry = {"token": tok_s(t),
                                             "logprob": lps[j]}
                                    if tops is not None:
                                        ids_j, lps_j = tops[j]
                                        entry["top_logprobs"] = [
                                            {"token": tok_s(ti),
                                             "token_id": ti, "logprob": lj}
                                            for ti, lj in zip(ids_j, lps_j)
                                        ]
                                    content_lp.append(entry)
                                event["choices"][0]["logprobs"] = {
                                    "content": content_lp
                                }
                        else:
                            event = {"id": f"cmpl-{rid0}", "token_ids": delta}
                            if multi:
                                event["index"] = i
                            if lps is not None:
                                event["logprobs"] = lps
                            if tops is not None:
                                event["top_logprobs"] = tops
                            if text_delta is not None:
                                event["text"] = text_delta
                        chunk(b"data: " + _json_bytes(event) + b"\n\n")
                    if multi and not got_any:
                        _time.sleep(0.01)
                chunk(b"data: [DONE]\n\n")
                chunk(b"")  # terminating chunk
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream: reclaim the slots so the
                # rest of the generation budget isn't burnt for nobody
                for req in reqs:
                    server.cancel(req.rid)
                self.close_connection = True

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd


def _parser():
    import argparse

    p = argparse.ArgumentParser(prog="modegpt-tpu-torch-server")
    p.add_argument("--model", required=True, help="artifact dir or HF checkpoint dir")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--prefill_bucket", type=int, default=128)
    p.add_argument("--max_tokens_default", type=int, default=64)
    p.add_argument("--max_queue", type=int, default=None,
                   help="reject (HTTP 429) when this many requests are already waiting for a slot; "
                   "default unbounded")
    p.add_argument("--eos_token_id", type=int, default=None,
                   help="override EOS; default resolves from the tokenizer, then the checkpoint's config.json")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--min_p", type=float, default=None)
    p.add_argument("--repetition_penalty", type=float, default=None)
    p.add_argument("--per_request_sampling", action=argparse.BooleanOptionalAction, default=True,
                   help="honour per-request sampling fields through the batcher's knob table; "
                   "--no-per_request_sampling serves every request with the server-level knobs and "
                   "rejects per-request fields")
    p.add_argument("--quantize_int8", action="store_true")
    p.add_argument("--a8_prefill", action="store_true",
                   help="with --quantize_int8: W8A8 prefill (per-token int8 activations); decode stays "
                   "weight-only")
    p.add_argument("--kv_dtype", choices=("model", "int8"), default="model")
    p.add_argument("--moe_exec", choices=("dense", "dispatch"), default="dense")
    p.add_argument("--moe_capacity", type=float, default=2.0)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--prefill_exec", choices=("per_slot", "batched"), default="batched")
    p.add_argument("--decode_attn", choices=("auto", "xla", "ragged"), default="auto",
                   help="slot-table attention: ragged = the CUDA kernel, whose reads cover each slot's "
                   "live keys; xla = its plain version over the whole pool; auto = the kernel on a CUDA "
                   "device, the plain version on the CPU")
    p.add_argument("--prefix_cache", action="store_true",
                   help="reuse cache-resident KV for bucket-aligned shared prompt prefixes instead of "
                   "prefilling them again")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="shard the model and KV pools over this many ranks (Megatron TP over a 'model' mesh "
                   "axis; a multiple of it replicates over 'data'); one process per rank, launched by "
                   "torchrun; rank 0 serves HTTP; needs n_kv_heads %% tensor_parallel == 0")
    p.add_argument("--compress_ratio", type=float, default=None,
                   help="compress the dense checkpoint in memory at this ratio before serving")
    p.add_argument("--compress_dataset", default="wikitext")
    p.add_argument("--compress_calib_size", type=int, default=32)
    p.add_argument("--compress_seq_len", type=int, default=2048)
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N, N or cpu")
    return p


def _resolve_eos(model_dir: str, tokenizer, override: Optional[int]) -> Optional[int]:
    """EOS for serving: the flag, else the tokenizer's, else the
    checkpoint's config.json (tokenizer-less serving still needs it for
    min_tokens and guided decoding)."""
    import os

    if override is not None:
        return override
    eos = getattr(tokenizer, "eos_token_id", None) if tokenizer is not None else None
    cfg_path = os.path.join(model_dir, "config.json")
    if eos is None and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            eos = json.load(f).get("eos_token_id")
        if isinstance(eos, list):  # some configs carry several
            eos = eos[0] if eos else None
    return eos


KEEPALIVE_S = 1.0  # rank 0's longest silence towards the followers


def _exchange(mesh, payload=None):
    """Rank 0's round of operations to every rank of the world (one
    broadcast of a pickled object); the other ranks receive it."""
    import torch.distributed as dist

    box = [payload]
    with mesh.counted():
        dist.broadcast_object_list(box, src=0)
    return box[0]


def follow(batcher, mesh) -> None:
    """A rank other than 0 of a tensor-parallel server: no HTTP. Each
    round it receives rank 0's submits and cancels (`InferenceServer`
    sends them from its scheduler thread), applies them to its own
    batcher in the same order, and steps when rank 0 steps, with a
    generator seeded as rank 0's, so every rank runs the same dispatches
    over its shard. Returns when rank 0 shuts down; raises when rank 0
    is lost (the broadcast fails, or times out after the process
    group's timeout)."""
    import torch

    device = batcher.device
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    while True:
        sent, stop = _exchange(mesh)
        for record in sent:
            if record[0] == "submit":
                batcher.submit(record[1], **record[2])
            else:
                batcher.cancel(record[1])
        if stop:
            return
        if batcher.queue or any(r is not None for r in batcher.slot_req):
            batcher.step(generator)


def _serving_mesh(tensor_parallel: int, device):
    """The mesh of ``--tensor_parallel N`` (JAX server.py:964-981): the
    world's W ranks as data:W/N,model:N; W must be a multiple of N."""
    import torch.distributed as dist

    from modegpt_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    maybe_initialize_distributed(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % tensor_parallel:
        raise ValueError(
            f"--tensor_parallel {tensor_parallel} does not divide the world size {world}: run a multiple of "
            f"{tensor_parallel} ranks (python -m torch.distributed.run --nproc_per_node {tensor_parallel} "
            "-m modegpt_tpu_torch.server ...)"
        )
    return make_mesh(f"data:{world // tensor_parallel},model:{tensor_parallel}", device=device)


def main(argv=None):
    from modegpt_tpu_torch.utils.device import resolve_device
    from modegpt_tpu_torch.utils.logging import setup_logging

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = _serving_mesh(args.tensor_parallel, device) if args.tensor_parallel > 1 else None
    if mesh is not None:
        device = mesh.device  # this rank's card
    logger = setup_logging()

    from modegpt_tpu_torch.evals.cli import _load_any
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    spec, params, tokenizer = _load_any(args.model, device)
    if args.compress_ratio is not None:
        from modegpt_tpu_torch.compress.pipeline import compress_in_memory
        from modegpt_tpu_torch.config import CompressionConfig

        ccfg = CompressionConfig(
            compression_ratio=args.compress_ratio, dataset=args.compress_dataset,
            calib_size=args.compress_calib_size, calibs_batch_size=min(4, args.compress_calib_size),
            seq_len=args.compress_seq_len, solver_precision="f32_device", device=str(device),
        ).validate()
        logger.info("compressing in memory at ratio %.2f (%s, %d sequences)",
                    args.compress_ratio, args.compress_dataset, args.compress_calib_size)
        spec, params = compress_in_memory(spec, params, ccfg, tokenizer=tokenizer)
    pm = pad_to_uniform(spec, params)
    del params
    if args.quantize_int8:
        from modegpt_tpu_torch.models.quantize import quantize_padded

        pm = quantize_padded(pm)
    batcher = ContinuousBatcher(
        pm, slots=args.slots, max_len=args.max_len, prefill_bucket=args.prefill_bucket,
        eos_token_id=_resolve_eos(args.model, tokenizer, args.eos_token_id),
        temperature=args.temperature, top_p=args.top_p, min_p=args.min_p,
        repetition_penalty=args.repetition_penalty, moe=args.moe_exec, moe_capacity=args.moe_capacity,
        kv_dtype=args.kv_dtype, steps_per_dispatch=args.steps_per_dispatch, prefill_exec=args.prefill_exec,
        prefix_cache=args.prefix_cache, per_request_sampling=args.per_request_sampling,
        decode_attn=args.decode_attn, a8_prefill=args.a8_prefill, mesh=mesh,
    )
    del pm  # a tensor-parallel batcher keeps its shard alone
    if mesh is not None and mesh.rank != 0:
        logger.info("rank %d of %s follows rank 0", mesh.rank, mesh)
        try:
            follow(batcher, mesh)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
        return 0
    server = InferenceServer(batcher, tokenizer=tokenizer, model_id=args.model, max_queue=args.max_queue,
                             mesh=mesh)
    httpd = make_http_server(server, host=args.host, port=args.port, default_max_tokens=args.max_tokens_default)
    logger.info("serving %s on http://%s:%d (%s, slots=%d, max_len=%d%s)", args.model, args.host, args.port,
                batcher.device, args.slots, args.max_len, "" if mesh is None else f", {mesh}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.close()
        if mesh is not None and mesh.initialized:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
