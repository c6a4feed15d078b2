#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (modegpt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,kernel,long
    python3 chip_smoke.py --phases build,kernel,moe
    python3 chip_smoke.py --phases build,kernel,archs
    python3 chip_smoke.py --phases build,kernel,big
    python3 chip_smoke.py --phases build,kernel,main,quant
    python3 chip_smoke.py --phases build,kernel,main,serve,sched
    python3 chip_smoke.py --phases build,kernel,main,server
    python3 chip_smoke.py --phases build,kernel,opt
    python3 chip_smoke.py --phases build,kernel,main,stream
    python3 chip_smoke.py --phases build,kernel,main,cli
    python3 chip_smoke.py --phases build,kernel,parallel
    python3 chip_smoke.py --phases build,kernel,main,tpserve

Phases, each printing one JSON line:

1. build  — compile every CUDA source in modegpt_tpu_torch/csrc with nvcc
   for sm_90a (modegpt_tpu_torch/_build/), all at once.
2. kernel — hold each kernel (K1 flash_attention and K2
   flash_attention_hbm, two entries of one tile loop, and K3
   ragged_gqa_attend) against its plain PyTorch version on the card at
   the paths' shapes and a few edge shapes, and time the kernel, the
   plain version and the nearest single PyTorch call (library_ms). K3's
   row sweep covers every decode form in use (G*S = 1 to 16 rows), and
   its sched cases a batched prefill round (8 slots x 128 tokens at
   their own offsets, one past the pool) and a verify dispatch (S = 5).
3. main   — one full compression job through
   `modegpt_tpu_torch.compress.pipeline.run_compression` at the published
   Meta-Llama-3-8B widths (hidden 4096, intermediate 14336, 32 heads,
   8 kv heads, head_dim 128, vocab 128256, rope_theta 5e5, untied head),
   depth cut 32 -> 4 layers, random f32 weights from a seed, on the
   offline synthetic corpus, solving in float32 on the card. The
   compressed evaluation takes compressed_exec="auto" (padded execution
   when the padding costs < 1.5x). K1's launch counter is zeroed just
   before the job and read just after.
4. serve  — serve the compressed model the main phase reloaded, padded,
   through `modegpt_tpu_torch.models.serving.ContinuousBatcher` (8 slots
   over a 1024-position pool, prefill chunks of 128, greedy,
   decode_attn="auto", which is K3 on the card): 16 requests, then 4 with
   an int8 KV cache. K3's launch counter is zeroed just before and read
   just after; it must equal the layers times the prefill and decode
   dispatches, counted around the port's two step functions. In each
   round one decode step's logits through K3 are held against its plain
   version, and every served token of the 16 requests against the
   unrolled forward over prompt + output (teacher forcing).
4b. sched — the same model, prompts and settings through each execution
   mode of the batcher, one round each: (a) batched prefill, (b) batched
   with mixed prefill+decode rounds, (c) fused decode of 4 steps a
   dispatch, (d) mixed + fused, (e) prefix caching on 16 requests that
   share a 256-token prefix (against the same requests served uncached:
   equal tokens, and some prefix adopted), (f) prompt lookup, (g) a draft
   model: the dense Llama-3-8B-width target rebuilt from the main
   phase's seed, with the compressed model as its draft, (h) int8 KV
   with batched prefill and fused decode (4 requests), (i) mixed + fused
   with a first request of 958 tokens that decodes within a bucket of
   the pool's end while later ones prefill; then
   `models.speculative.speculative_generate` (dense target, compressed
   draft; greedy, then sampled at 0.7) and `prompt_lookup_generate` on
   two prompts. In every round: each request returns prompt + 32 tokens,
   every served token is within 1e-3 of its row's max logit in the
   served model's unrolled forward (K1; for g and speculative.py the
   dense target's; for h one padded step of the whole sequence into an
   int8 cache, the int8-KV model's own forward), K3 launches equal the layers times the dispatches
   counted around every step function, and "auto" resolved to K3.
4c. server — the same model behind `modegpt_tpu_torch.server` (the
   OpenAI-style HTTP server on 127.0.0.1, per-request sampling,
   `ContinuousBatcher(slots=8, max_len=1024, prefill_bucket=128,
   per_request_sampling=True, decode_attn="auto")`), with an offline
   word-level tokenizer over all 128256 ids saved into the artifact: 16
   concurrent clients (6 greedy with logprobs and top_logprobs=5, 3 of
   them streaming; 4 seeded sampled at temperature 0.8, top_k 50, top_p
   0.9, min_p 0.05; 2 with repetition, presence and frequency
   penalties; a guided_choice and a guided_json; one with logit_bias and
   min_tokens; a streaming chat completion with n=2). Greedy and
   penalised tokens within 1e-3 of their row's max in the unrolled
   forward under the same penalties and bias, logprobs and top-5 within
   2e-3 of its log-softmax, every sampled token in the kept set
   recomputed from it, seeded requests sent again alone equal, guided
   outputs in their grammar, K3's launches equal to the layers times the
   dispatches counted, a cancel that frees its slot, a 429 under
   max_queue=0 and /metrics counting the round. Then the decode step
   timed with the knob table all greedy, with the filter path on and
   with top_logprobs, in turns, the token choice alone, and the guide
   rows at the full vocabulary. (`python -m modegpt_tpu_torch.server` as
   a subprocess answering /health and a completion runs in the cli
   phase, beside its other subprocess.)

5. quant  — quantised artifacts and int8 serving of the compressed model
   the main phase reloaded: int8, int4 and nf4 artifacts saved and
   reloaded dequantised (bytes on disk, save and reload seconds), each
   evaluated through K1 (its launches equal to one evaluation of the
   main job; int8 perplexity within 1% of the float32 artifact's); the
   int8 and int4 artifacts reloaded resident (``resident_int8``: int8
   codes, int4 packed two a byte), their device bytes, one B=2, T=2048
   forward each through K1 against the dequantised reload's (1e-3); the
   decode step's dequantised weight copies timed alone; then the serve
   phase's 16 requests three times through K3: float32, int8 weights
   (`quantize_padded`: teacher forcing against the unrolled int8
   forward, K3 against its plain version) and int8 with W8A8 prefill
   (each first token within 1e-2 of the unrolled W8A8 forward's row max
   at the last prompt position), K3's launches equal to the layers times
   each round's dispatches. With --profile the two int8 rounds are
   traced, with the dequantised copies and the int8 GEMMs as ranges.
   Then the orbax artifacts (`compress/orbax_format`, no orbax on this
   machine): (a) the model saved with ``backend="orbax"`` in float32 and
   bfloat16 and reloaded on the card, every leaf equal bit for bit to
   the npz reload (bfloat16: an npz artifact saved beside it), the
   seconds and bytes of each beside npz's; (b) the committed JAX-written
   fixture (``tests/fixtures/torch_orbax_llama``, zstd chunks through the
   hand-written decoder) equal to its npz twin; (c) ``evals.cli.main
   --dataset synthetic`` on the float32 orbax artifact: the main job's
   perplexity (rtol 1e-6), K1 launched and counted; (d) one
   ``serve.main`` round from it (8 requests, 16 new tokens): the npz
   model's tokens, K3 launched layers times dispatches.

6. moe    — one compression job at the published Qwen3-30B-A3B widths
   (hidden 2048, 32 heads over 4 kv heads, head_dim 128, 128 experts of
   width 768, top 8 renormalised, every layer MoE, vocab 151936, qk norm,
   untied head), 48 -> 1 layer, random f32 weights from a seed, with the
   main phase's settings: K1 runs in every forward. Then the reloaded
   artifact, padded, serves the serve phase's 16 requests twice: with
   every expert on every token (moe="dense") and by capacity dispatch
   at E / k = 16 (moe="dispatch"), where nothing is dropped. K1's counter
   is zeroed before the job and K3's before each round; K3 must equal
   the layers times the round's dispatches. One decode step through K3 is
   held against the plain version, dispatch's decode logits against
   dense's, every dense-round token against the unrolled forward
   (teacher forcing), and dispatch's tokens are counted against dense's.
   Then the padded model quantised to int8 serves 4 of the requests with
   W8A8 prefill, dense and by dispatch at E / k (per-expert int8 GEMMs),
   with the same checks: K3's launches, dispatch's decode logits against
   dense's (1e-3), dispatch's tokens against dense's.

7. long   — one compression job at the published Meta-Llama-3.1-8B
   widths (the main phase's, plus llama3 rope scaling to 131072
   positions), 2 layers, at seq_len=16384, so that every forward (both
   evals and calibration) takes the long-context kernel K2; then the
   port's eval CLI (`modegpt_tpu_torch.evals.cli.main`) on the artifact at
   the same length. K1's and K2's counters are zeroed just before the job
   and before the CLI and read just after each; K2's logits on the second
   half of one 16384-token window are held against the row-chunked plain
   attention and against the padded stack, and the CLI's perplexity
   against the job's compressed perplexity.

8. archs  — the dense archs beyond llama and opt. At the published
   Gemma-2-9B widths (hidden 3584, intermediate 14336, 16 heads over 8 kv
   heads of 256, vocab 256000 tied, query_pre_attn_scalar 256, score cap
   50, final cap 30, a 4096 window on alternate layers), 42 -> 2 layers,
   random f32 weights, the main phase's job settings: its soft-capped
   scores take the plain attention in every forward, so K1 must launch 0
   times in the job (the JAX forward sends such layers to XLA, not to
   its kernel). The reloaded artifact, padded, serves the serve phase's
   16 requests through K3 with the cap (K3 against its plain version,
   teacher forcing, launches = layers x dispatches). Then one forward of
   each of gemma-7b, OLMo-2-7B, gpt2-xl, Phi-3-mini, StarCoder2-7B,
   Mistral-7B and Qwen2-7B at published widths, 2 layers, through K1 (2
   launches each) against the plain attention, and one decode step of
   each padded model through K3 against its plain version (multi-head
   G*S = 1, and groups of 4, 7 and 9).
9. big    — a random bf16 safetensors checkpoint at Qwen3-32B widths
   (64 -> 2 layers), compressed host-staged through the streamed sweep
   (job A, from disk, loaded through the safetensors path, every layer
   leaf left on the host) and resident through the windowed calibration
   (job B, same weights): ranks, factor stores and perplexities equal,
   A's device peak, over the whole job and over its calibrate + solve
   steps, a dense layer below B's; K1's launches per job as counted in
   the code, and every shape K1 ran at one of the kernel phase's cases.
   Then the staging, prepass-probe and async-off measurements, and the
   fused job against the chunked one at Llama-3-8B widths (job C).
10. opt   — a random-f32 checkpoint at the published facebook/opt-6.7b
   widths (hidden 4096, ffn 16384, 32 heads of 128, vocab 50272, 2048
   learned positions, pre-LN, relu, biases, tied head), 32 -> 2 layers,
   written as config.json + model.safetensors, compressed through the
   compression CLI (`modegpt_tpu_torch.cli.main`, in process) with the
   whitened-SVD Q/K solve (``--qk_method svd``) and the main phase's
   settings, traced into ``--profile_dir``: finite perplexities, q/k
   ranks below 128 a head and no rotary masks, K1's launches as the
   job's forwards give them, a trace that names K1's kernel, and every
   layer's Q_h^T K_h, from the job's f32 solve and from the same solve
   in f32 on the card, within OPT_SVD_TOL of the solve in float64 on the
   CPU (same Gram, same weights), while three wrong solves (no
   whitening, bfloat16-rounded inputs, one rank less) fall outside it.
   Then `inspect_artifact` on the artifact (its ranks the spec's),
   `export_to_hf` of the compressed model reloaded through the port's
   importer (logits at [1, 128] within 1e-5; the artifact's forward
   through K1 also within rtol = atol = 1e-3 of the plain attention's),
   `export_to_hf` of the dense model loaded by
   `transformers.OPTForCausalLM` (logits within OPT_HF_TOL of the port's
   forward, TF32 off on both sides), and `analysis.search.staged_search`
   on the model (1 proxy trial at 256 tokens, 1 finalist at 1024):
   finite scores, each trial's seconds and K1 launches. K1's counter is
   zeroed once for the phase; each step's launches (job, calibration,
   both exports, search) equal what its forwards give, and every shape
   K1 ran at in the phase is a kernel case or held here against the
   plain attention (the ranks, so the export widths, move with depth).
11. stream — `models.streaming.streaming_generate` on the main phase's
   compressed model, padded: inside the window (prompt 200, 56 new,
   window 256, 4 sinks) its tokens are `generate_padded`'s greedy ones;
   beyond it (prompt 64, 960 new) its first tokens are the run inside the
   window's, every step's logits are finite and device memory stays
   flat (tokens/s printed). The plain attention runs here, as in JAX:
   K1 and K3 launch 0 times. (The eval CLI's ``--generate
   --streaming_window 256`` runs in the cli phase.)
11b. cli  — the port's user entry points as a user calls them, on the
   main artifact with the word-level tokenizer: (a) `python -m
   modegpt_tpu_torch.serve` as a subprocess (8 prompts of words from a
   file, 32 new tokens, batched prefill, fused decode of 4, prefix
   caching; it runs beside b), each completion line the decoded tokens
   of an in-process `ContinuousBatcher` with the same settings on the
   main phase's padded model, on cuda; beside it `python -m
   modegpt_tpu_torch.server` answering /health and one completion
   within 1e-3 of the unrolled forward's row max, and after (a) `python
   -m modegpt_tpu_torch.evals.cli --generate --streaming_window 256`,
   its text `streaming_generate`'s; (b) `serve.main(argv)` in process
   with int8 weights, W8A8 prefill and int8 KV, with prompt lookup, and
   with the artifact as its own draft, each equal to the in-process
   batcher with the same settings (and its stats), the speculative ones
   also to (a)'s tokens but at a printed near-tie, every self-draft
   accepted; (c) `serve.main --compress_ratio 0.3` on a 2-layer dense
   bf16 checkpoint at the same widths (`export_to_hf` from the main
   phase's seed): its tokens a batcher's on the tree a direct
   `compress_in_memory` gives, K1's launches the layers times the
   calibration batches; (d) `evals.cli.main(argv)` with --tasks (the
   synthetic task and the frozen winogrande and arc documents of
   tests/fixtures) and --generate: accuracies equal to an in-process
   `evaluate_multiple_choice`, each choice's score within 1e-3 of the
   plain attention's, the text an in-process `generate`'s; then
   --generate with --prompt_lookup and with the artifact as
   --speculative_draft (every draft accepted), each text the plain one's
   but at a printed near-tie. K3's launches equal the layers times the
   dispatches of each in-process entry point; every K1 and K3 shape of
   the phase a kernel case or held here against its plain version.

12. parallel — the compression job on a process mesh at the main
   phase's Llama-3-8B widths (4 layers, the same seeded f32 weights and
   job settings), each rank a process of this script
   (``--parallel-rank``) on cuda:0, the kernels built before any rank
   starts: (a) the one-rank job over NCCL (``mesh_shape="data:1"``),
   and beside it the same job with its calibration batches reversed
   (a2: its own rounding noise);
   (b) the same job on data:2,model:2, 4 ranks sharing the card over
   gloo (asked for explicitly: NCCL takes one rank a card): identical
   rank lists, MLP indices and rotary masks, the compressed model's
   logits on one eval window within the main phase's 1e-3 of (a)'s or
   within 4x (a2)'s distance from (a) (every factor's distance from
   (a)'s printed, and (a2)'s), both perplexities within 2e-3; (c)
   `calibrate_pp` and `perplexity_pp` on stage:4 and (d) `calibrate_ring`
   on context:2 (run together), both at T = 2048, against one rank's
   `calibrate` and `compute_perplexity` (each Gram within 1e-4 relative
   Frobenius, BI and perplexity within 1e-4). Per rank: seconds, peak device bytes,
   backend and K1's launches, each equal to what its forwards give (0 on
   the ring: its products are plain ops, as in JAX); every K1 shape a
   rank ran held against the plain attention.

13. tpserve — tensor- and expert-parallel serving on data:1,model:2, two
   ranks (``--parallel-rank tpserve``) sharing cuda:0 over gloo, asked
   for explicitly, each through K3 on its own heads, while this process
   runs the same rounds on one rank: (e) the main artifact, padded,
   serving the serve phase's 16 requests greedy in batched prefill with
   fused decode, once f32 and once int8 weights with W8A8 prefill and int8
   KV, then one padded prefill step (128 tokens) and one decode step from
   an empty pool; (f) the moe phase's seeded Qwen3-30B-A3B-width weights
   (1 layer, uncompressed: 64 whole experts a rank) serving 4 requests
   with every expert on every token and by dispatch at E / k. Tokens
   equal to one rank's, a divergence allowed only where the one-rank
   model's logits of the two tokens lie within 1e-3 (counted), the
   steps' logits within 1e-3 and equal on both ranks, K3's launches on
   each rank equal to the layers times its dispatches, every K3 shape a
   rank ran a kernel case or held here against the plain version; per
   rank tok/s, dispatch ms, collective seconds and bytes, peak bytes.
   Then (g) `python -m modegpt_tpu_torch.server --tensor_parallel 2` on
   two ranks on the main artifact: 8 concurrent completions (greedy and
   seeded sampled, some with logprobs), a guided choice, a guided regex,
   a logit bias and a stream, each JSON (a stream's deltas) equal to the
   in-process one-process server's; a long stream cancelled after its
   first event ends, rank 0 counts it, and a request after it still
   answers as one process does; SIGINT on rank 0 stops both ranks.

Then a `{"kernels": [...]}` line (each kernel's launches summed over the
paths that ran it, and by path), the card's name and power limit as
nvidia-smi reports them, and last `{"ok": true, "device": {...}}`. Any
failed phase exits non-zero without that last line. Without CUDA, or
without the package beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and dense
# FLOP/s by input type on the tensor cores. float32 work at float32
# accuracy is three TF32 products (3xTF32: big.big + big.small +
# small.big), so its least time is three passes at the 494.7 TFLOP/s TF32
# rate; a single TF32 pass is outside the f32 tolerance, and the CUDA
# cores' 67 TFLOP/s is slower than the tensor cores' 3xTF32.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 494.7e12 / 3, "bfloat16": 989e12}
OPS_ROUTE = {"float32": "3xtf32", "bfloat16": "bf16_tc"}

# K1 edge cases beside the main path's dense shape (B=2, H=32, Hk=8,
# T=2048, hd=hd_v=128, the eval and calibration batches of the job).
KERNEL_CASES = [
    dict(name="dense_f32", B=2, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="dense_bf16", B=2, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="bfloat16", window=None),
    dict(name="compressed_f32", B=2, H=32, Hk=8, T=2048, hd=88, hd_v=90, dtype="float32", window=None),
    dict(name="ragged_T300", B=2, H=32, Hk=8, T=300, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="window100", B=2, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="float32", window=100),
    dict(name="mha", B=2, H=32, Hk=32, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    # the parallel phase's tensor-parallel forwards: a model:2 rank's 16
    # heads over 4 kv heads, one row of each batch a data:2 rank
    dict(name="tp_model2_f32", B=1, H=16, Hk=4, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    # the moe phase's job (Qwen3-30B-A3B: 32 heads over 4 kv heads)
    dict(name="moe_f32", B=2, H=32, Hk=4, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    # the archs phase's forwards at published widths (B = 1): gemma-7b's
    # 16 heads of 256, phi3's 96-wide heads with a 2047 window at
    # T = 2048, gpt2-xl's 25 heads of 64 at its 1024 positions, qwen2's
    # 7 and starcoder2's 9 query heads a kv head
    dict(name="gemma7b_mha_hd256", B=1, H=16, Hk=16, T=2048, hd=256, hd_v=256, dtype="float32", window=None),
    dict(name="phi3_hd96_window2047", B=1, H=32, Hk=32, T=2048, hd=96, hd_v=96, dtype="float32", window=2047),
    dict(name="gpt2xl_H25_hd64", B=1, H=25, Hk=25, T=1024, hd=64, hd_v=64, dtype="float32", window=None),
    dict(name="qwen2_G7", B=1, H=28, Hk=4, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="starcoder2_G9_window4096", B=1, H=36, Hk=4, T=2048, hd=128, hd_v=128, dtype="float32",
         window=4096),
    # the big phase at Qwen3-32B widths (64 heads over 8 kv heads): its
    # calibration forwards, and its compressed evaluation, padded to the
    # widest layer's 126 dims a head
    dict(name="qwen3_32b_f32", B=2, H=64, Hk=8, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="qwen3_32b_padded_f32", B=2, H=64, Hk=8, T=2048, hd=126, hd_v=126, dtype="float32", window=None),
    # the opt phase (OPT-6.7B widths: 32 heads, no grouping). Its dense
    # forwards are the "mha" case; after the SVD Q/K solve each head keeps
    # the same rank of q/k and of v (127, 105, 75, 49 by layer at 4
    # layers), which the compressed evaluation pads to the widest layer's
    # 127: the job's eval
    # (B = 2, T = 2048), the search's proxy evals (B = 8, T = 256) and its
    # finalist's (T = 1024); a trial may keep all 128 in its widest layer
    dict(name="opt_svd_padded_f32", B=2, H=32, Hk=32, T=2048, hd=127, hd_v=127, dtype="float32", window=None),
    dict(name="opt_proxy_padded_f32", B=8, H=32, Hk=32, T=256, hd=127, hd_v=127, dtype="float32", window=None),
    dict(name="opt_proxy_f32", B=8, H=32, Hk=32, T=256, hd=128, hd_v=128, dtype="float32", window=None),
    dict(name="opt_finalist_padded_f32", B=8, H=32, Hk=32, T=1024, hd=127, hd_v=127, dtype="float32",
         window=None),
    dict(name="opt_finalist_f32", B=8, H=32, Hk=32, T=1024, hd=128, hd_v=128, dtype="float32", window=None),
    # the opt phase's export checks: the forwards at [1, 128] of the
    # compressed model, unpadded, at each layer's own width, and of the
    # dense model
    *(dict(name=f"opt_export_T128_hd{w}", B=1, H=32, Hk=32, T=128, hd=w, hd_v=w, dtype="float32", window=None)
      for w in (49, 75, 105, 127, 128)),
    # the cli phase's `serve --compress_ratio`: the in-memory compression's
    # calibration forwards, batches of 4 (the serve CLI's calibs_batch_size)
    dict(name="cli_compress_calib_f32", B=4, H=32, Hk=8, T=2048, hd=128, hd_v=128, dtype="float32", window=None),
]
# K2 (flash_attention_hbm) cases. The first is the long phase's shape: one
# 16384-token window (eval and calibration batches of 1) at 32 heads over
# 8 kv heads, head dim 128. long_padded_f32 is the compressed eval's (the
# long phase and the eval CLI run the compressed model padded, at
# hd = hd_v = 126). The rest cover unaligned head dims of 88 / 90, the
# ragged last tile at the route's threshold, the windowed tile range,
# twice the length, the JAX test's small GQA shape, and K1's main-path
# shape (K2 takes any T), which sets the two kernels side by side.
_LONG = dict(B=1, H=32, Hk=8, T=16384, hd=128, hd_v=128, dtype="float32", window=None)
HBM_CASES = [
    dict(_LONG, name="long_f32"),
    dict(_LONG, name="long_padded_f32", hd=126, hd_v=126),
    dict(_LONG, name="long_bf16", dtype="bfloat16"),
    dict(_LONG, name="long_compressed_f32", hd=88, hd_v=90),
    dict(_LONG, name="long_compressed_bf16", hd=88, hd_v=90, dtype="bfloat16"),
    dict(_LONG, name="route_edge_T8193", B=2, T=8193),
    dict(_LONG, name="window4096", window=4096),
    dict(_LONG, name="T32768", T=32768),
    dict(_LONG, name="small_T640_gqa", H=4, Hk=2, T=640, hd=32, hd_v=32),
    dict(_LONG, name="k1_dense_T2048", B=2, T=2048),
]
# The JAX package's own kernel tolerances (tests/test_models.py,
# tests/test_ragged_decode.py).
TOLERANCE = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# K3 (ragged_gqa_attend) cases. The first is the decode dispatch of the
# serve phase: 8 slots over a 1024-position pool, 32 heads over 8 kv
# heads, at the padded ranks of the compressed model it serves (the
# widest layer keeps 126 of 128 q/k and v dims per head, so Rq = Rv = 126
# after padding). "chunk" is one per-slot prefill dispatch (bucket 128),
# in the pool's dtype and with int8 codes, at a slot's fourth chunk
# (pos 384) and its first (pos 0). pos is drawn over the pool from a
# seeded generator; "edge" puts one row past the pool's end, as a masked
# serving row can be. decode_T4096 walks a pool four times as long (many
# key splits), decode_pos0 has one live key a slot.
_DECODE = dict(B=8, H=32, Hk=8, T=1024, S=1, Rq=126, Rv=126, dtype="float32",
               window=None, softcap=None, int8=False, pos=None)
RAGGED_CASES = [
    dict(_DECODE, name="decode_f32"),
    dict(_DECODE, name="decode_bf16", dtype="bfloat16"),
    dict(_DECODE, name="aligned_128", Rq=128, Rv=128),
    dict(_DECODE, name="unaligned_126_90", Rv=90),
    dict(_DECODE, name="chunk_S128_pos384", B=1, S=128, pos=[384]),
    dict(_DECODE, name="chunk_S128_pos384_int8", B=1, S=128, pos=[384], int8=True),
    dict(_DECODE, name="window100", window=100),
    dict(_DECODE, name="softcap50", softcap=50.0),
    dict(_DECODE, name="int8_f32", int8=True),
    dict(_DECODE, name="int8_bf16", dtype="bfloat16", int8=True),
    dict(_DECODE, name="mha", Hk=32),
    dict(_DECODE, name="edge_row", pos="edge"),
    dict(_DECODE, name="decode_T4096", T=4096),
    dict(_DECODE, name="decode_pos0", pos=[0] * 8),
    dict(_DECODE, name="chunk_S128_bf16", B=1, S=128, pos=[384], dtype="bfloat16"),
    dict(_DECODE, name="chunk_S128_pos0", B=1, S=128, pos=[0]),
    # the moe phase's serve round: 32 heads over 4 kv heads, so a decode
    # step is G*S = 8 rows a kv head, and a prefill chunk 1024
    dict(_DECODE, name="decode_moe_G8", Hk=4),
    dict(_DECODE, name="chunk_moe_G8_S128", Hk=4, B=1, S=128, pos=[384]),
    # the archs phase: the soft-capped Gemma-2-9B stack (16 heads over 8
    # kv heads) at padded ranks of 256, decode and prefill chunk;
    # multi-head attention at published widths (G*S = 1); GQA groups of
    # 7 (qwen2) and 9 (starcoder2)
    dict(_DECODE, name="gemma2_softcap_r256", H=16, Hk=8, Rq=256, Rv=256, softcap=50.0),
    dict(_DECODE, name="gemma2_chunk_softcap_r256", H=16, Hk=8, Rq=256, Rv=256, softcap=50.0, B=1, S=128,
         pos=[384]),
    # the archs phase's served model: its widest layer keeps 250 of 256
    # dims a head, so the padded ranks are 250
    dict(_DECODE, name="gemma2_served_softcap_r250", H=16, Hk=8, Rq=250, Rv=250, softcap=50.0),
    dict(_DECODE, name="mha_gemma7b_r256", H=16, Hk=16, Rq=256, Rv=256),
    dict(_DECODE, name="mha_phi3_r96", Hk=32, Rq=96, Rv=96),
    dict(_DECODE, name="mha_gpt2xl_H25_r64", H=25, Hk=25, Rq=64, Rv=64),
    dict(_DECODE, name="qwen2_G7", H=28, Hk=4, Rq=128, Rv=128),
    dict(_DECODE, name="starcoder2_G9", H=36, Hk=4, Rq=128, Rv=128),
]
# the sched phase's dispatches (32 heads over 8 kv heads at the served
# ranks of 126): a batched or mixed prefill round is every slot's
# 128-token chunk at its own offset ("batched": one row at 0, one within a
# bucket of the pool's end, one past it, the rest drawn over the pool),
# a verify dispatch is each slot's last token and 4 drafts (S = 5, 20
# rows a kv head: the chunk form, one 64-row block 20 rows full)
RAGGED_CASES += [
    dict(_DECODE, name="batched_chunk_B8_S128", S=128, pos="batched"),
    dict(_DECODE, name="batched_chunk_B8_S128_int8", S=128, pos="batched", int8=True),
    dict(_DECODE, name="verify_B8_S5", S=5),
    dict(_DECODE, name="verify_B8_S5_int8", S=5, int8=True),
]
# the row sweep: every decode form in use (G*S = 1, 2, 3, 4, 5, 8, 12,
# 16 query rows a kv head; 32 heads over 32 / G kv heads), so a form that
# sums wrongly at one row count shows here
ROW_SWEEP = [(1, 1), (2, 1), (1, 3), (4, 1), (1, 5), (8, 1), (4, 3), (8, 2)]
RAGGED_CASES += [dict(_DECODE, name=f"rows{G * S}_G{G}_S{S}", Hk=32 // G, S=S) for G, S in ROW_SWEEP]
# the tpserve phase's ranks on data:1,model:2: each attends its 16 of 32
# heads over 4 of 8 kv heads (the main artifact, Llama-3-8B widths, G = 4)
# or over 2 of 4 (Qwen3-30B-A3B widths, uncompressed, G = 8)
RAGGED_CASES += [
    dict(_DECODE, name="tp_decode_H16_Hk4", H=16, Hk=4),
    dict(_DECODE, name="tp_decode_H16_Hk4_int8", H=16, Hk=4, int8=True),
    dict(_DECODE, name="tp_batched_chunk_H16_Hk4_S128", H=16, Hk=4, S=128, pos="batched"),
    dict(_DECODE, name="tp_batched_chunk_H16_Hk4_S128_int8", H=16, Hk=4, S=128, pos="batched", int8=True),
    dict(_DECODE, name="tp_moe_decode_H16_Hk2", H=16, Hk=2, Rq=128, Rv=128),
    dict(_DECODE, name="tp_moe_chunk_H16_Hk2_S128", H=16, Hk=2, Rq=128, Rv=128, B=1, S=128, pos=[384]),
]
# the one-row form (multi-head decode) in the pool's other dtypes
RAGGED_CASES += [
    dict(_DECODE, name="rows1_G1_S1_bf16", Hk=32, dtype="bfloat16"),
    dict(_DECODE, name="rows1_G1_S1_int8", Hk=32, int8=True),
    dict(_DECODE, name="rows1_G1_S1_int8_bf16", Hk=32, int8=True, dtype="bfloat16"),
]

# The serve phase's traffic: prompts of token ids from the synthetic eval
# set, lengths uniform over [min_prompt, max_prompt] from a seeded numpy
# generator, greedy, a fixed generation budget; then int8_requests more
# with an int8 KV cache.
SERVE = dict(slots=8, max_len=1024, prefill_bucket=128, requests=16, int8_requests=4,
             min_prompt=16, max_prompt=640, max_new_tokens=32, seed=0)

N_LAYERS = 4  # Meta-Llama-3(.1)-8B's 32 layers cut to 4: about 7.7 GB of f32 weights
LLAMA3_8B = dict(  # Meta-Llama-3-8B config.json
    model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu",
    tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rope_scaling=None,
)

LLAMA31_8B = dict(  # meta-llama/Llama-3.1-8B config.json
    LLAMA3_8B, max_position_embeddings=131072,
    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
)
# The long phase's job: one calibration and eval window per batch at
# 16384 tokens, so every forward runs K2 (T > 8192) and none runs K1.
# Meta-Llama-3.1-8B's 32 layers cut to 2 (4 until the tpserve phase joined
# the command, which must stay within its time limit).
LONG_LAYERS = 2
LONG = dict(seq_len=16384, calib_size=4, calibs_batch_size=1, eval_batch_size=1, eval_max_samples=2)

# Qwen3-30B-A3B's 48 layers cut to 1 (2 until the cli phase joined the
# command, which must stay within its time limit): 2.49 GB of f32 weights a layer
MOE_LAYERS = 1
MOE_INT8_REQUESTS = 4  # the moe phase's int8 rounds (W8A8 prefill, dense and dispatch)
QWEN3_30B_A3B = dict(  # Qwen/Qwen3-30B-A3B config.json
    model_type="qwen3_moe", vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    moe_intermediate_size=768, num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
    head_dim=128, max_position_embeddings=40960, rms_norm_eps=1e-6, rope_theta=1000000.0,
    hidden_act="silu", tie_word_embeddings=False, attention_bias=False, rope_scaling=None,
    num_experts=128, num_experts_per_tok=8, norm_topk_prob=True, decoder_sparse_step=1,
    mlp_only_layers=[], use_sliding_window=False, sliding_window=None, max_window_layers=48,
)

# Gemma-2-9B's 42 layers cut to 2, one sliding and one full (4 until the cli
# phase joined the command, which must stay within its time limit): 0.79 GB
# of f32 weights a layer
ARCH_LAYERS = 2
GEMMA2_9B = dict(  # google/gemma-2-9b config.json
    model_type="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336,
    num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8, head_dim=256,
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, attention_bias=False,
    query_pre_attn_scalar=256, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    sliding_window=4096, rope_scaling=None,
)
# The other seven dense archs at published widths (each model's widths,
# vocabulary, window and the like as published; every other field the
# default of its transformers config class), cut to FORWARD_LAYERS
# layers, one forward each at (1, T) tokens.
FORWARD_LAYERS = 2
ARCH_FORWARDS = {
    "google/gemma-7b": (2048, dict(
        model_type="gemma", vocab_size=256000, hidden_size=3072, intermediate_size=24576,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, rope_scaling=None)),
    "allenai/OLMo-2-1124-7B": (2048, dict(
        model_type="olmo2", vocab_size=100352, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu",
        tie_word_embeddings=False, rope_scaling=None)),
    "openai-community/gpt2-xl": (1024, dict(  # T = its n_positions
        model_type="gpt2", vocab_size=50257, n_embd=1600, n_layer=48, n_head=25, n_inner=None,
        n_positions=1024, activation_function="gelu_new", layer_norm_epsilon=1e-5,
        tie_word_embeddings=True)),
    "microsoft/Phi-3-mini-4k-instruct": (2048, dict(  # a 2047 window: it bites at T = 2048
        model_type="phi3", vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, sliding_window=2047, rope_scaling=None)),
    "bigcode/starcoder2-7b": (2048, dict(  # G = 9, biases, LayerNorm
        model_type="starcoder2", vocab_size=49152, hidden_size=4608, intermediate_size=18432,
        num_hidden_layers=32, num_attention_heads=36, num_key_value_heads=4,
        max_position_embeddings=4096, norm_epsilon=1e-5, rope_theta=10000.0,
        hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True, use_bias=True, sliding_window=4096,
        rope_scaling=None)),
    "mistralai/Mistral-7B-v0.1": (2048, dict(
        model_type="mistral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, sliding_window=4096, rope_scaling=None)),
    "Qwen/Qwen2-7B": (2048, dict(  # G = 7, qkv biases
        model_type="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, use_sliding_window=False, sliding_window=None,
        max_window_layers=28, rope_scaling=None)),
}
# each padded 2-layer model's decode check: DECODE_SLOTS rows, each
# prefilled to its own length (plain attention), then one decode step
# through K3 against its plain version
DECODE_SLOTS, DECODE_POOL = 4, 512


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(T: int, window) -> int:
    """(query, key) pairs with q - window < k <= q."""
    if window is None or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def phase_build() -> dict:
    from modegpt_tpu_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    for name, log in build.BUILD_LOGS.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    return {"phase": "build", "sources": sorted(seconds), "seconds": time.perf_counter() - t0}


def phase_kernel(records: dict) -> list:
    clocks_line("before the first case")
    lines = _flash_cases(records) + _hbm_cases(records) + _ragged_cases(records)
    clocks_line("after the last case")
    bad = [f"{ln['kernel']}:{ln['case']}" for ln in lines if not ln["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at {bad}")
    return lines


def _bound(flops: float, nbytes: float, dtype: str):
    """(bound ms, "operations" or "bytes", the route that sets it:
    "3xtf32", "bf16_tc" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", OPS_ROUTE[dtype]
    return t_bytes * 1e3, "bytes", "bytes"


def clocks_line(at: str, phase: str = "kernel") -> None:
    """The SM clock against its maximum, to tell a slow kernel from a
    throttled card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    emit({"phase": phase, "clocks_sm_and_max": out, "at": at})


def _library_ms(name: str, fn, iters: int = 10, warmup: int = 2):
    """One PyTorch call computing the same function, timed as a yardstick
    (the port never calls it); None where no backend takes the case."""
    import torch

    try:
        fn()
        return cuda_ms(fn, iters=iters, warmup=warmup)
    except (TypeError, RuntimeError) as e:
        print(f"[kernel {name}] SDPA not timed: {e}", file=sys.stderr)
        torch.cuda.empty_cache()
        return None


def _attention_cases(kernel_name: str, kernel, plain, cases, library) -> list:
    """Each case of a flash-attention kernel against its plain version on
    seeded random inputs, with the kernel's, the plain version's and the
    library call's times (fewer iterations from T > 8192 on: one launch
    there takes 0.1-1 s). ``library(q, k, v, scale, window, T)`` returns
    the yardstick's callable."""
    import torch

    lines = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in cases:
        B, H, Hk, T, hd, hd_v, w = (case[k] for k in ("B", "H", "Hk", "T", "hd", "hd_v", "window"))
        dt = getattr(torch, case["dtype"])
        q = torch.randn((B, H, T, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Hk, T, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Hk, T, hd_v), generator=gen, device="cuda").to(dt)
        scale = hd**-0.5
        got = kernel(q, k, v, scale=scale, window=w)
        torch.cuda.synchronize()
        want = plain(q, k, v, scale=scale, window=w)
        err = float((got.float() - want.float()).abs().max())
        tol = TOLERANCE[case["dtype"]]
        ok = bool(torch.allclose(got.float(), want.float(), **tol)) and bool(torch.isfinite(got).all())
        del want
        if T > 8192:
            iters, plain_iters = dict(iters=5, warmup=1), dict(iters=1, warmup=1)
        else:
            iters, plain_iters = dict(iters=10), dict(iters=5)
        kernel_ms = cuda_ms(lambda: kernel(q, k, v, scale=scale, window=w), **iters)
        plain_ms = cuda_ms(lambda: plain(q, k, v, scale=scale, window=w), **plain_iters)
        library_ms = _library_ms(case["name"], library(q, k, v, scale, w, T), **iters)

        flops = 2.0 * B * H * visible_pairs(T, w) * (hd + hd_v)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        bound_ms, bound_by, bound_route = _bound(flops, nbytes, case["dtype"])
        line = {
            "phase": "kernel", "kernel": kernel_name, "case": case["name"],
            "shape": {k_: case[k_] for k_ in ("B", "H", "Hk", "T", "hd", "hd_v", "window")},
            "dtype": case["dtype"], "max_abs_err": err, "tolerance": tol, "ok": ok,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": bound_route,
        }
        emit(line)
        lines.append(line)
        del q, k, v, got
        torch.cuda.empty_cache()
    return lines


def _window_mask(T: int, w):
    import torch

    if w is None:
        return None
    i = torch.arange(T, device="cuda")
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)


def _pad8(q, k, v):
    """q, k, v with their head dims zero-padded to a multiple of 8, as
    SDPA's fused backends need. Zero columns leave every score unchanged
    (the caller passes the unpadded scale) and give zero output columns,
    which the yardstick slices off."""
    import torch.nn.functional as F

    def pad(t):
        extra = -t.shape[-1] % 8
        return F.pad(t, (0, extra)) if extra else t

    return pad(q), pad(k), pad(v)


def _flash_library(q, k, v, scale, w, T):
    """K1's yardstick: one SDPA call (GQA, head dims padded to 8)."""
    import torch.nn.functional as F

    hd_v = v.shape[-1]
    q, k, v = _pad8(q, k, v)
    mask = _window_mask(T, w)
    kw = dict(attn_mask=mask, is_causal=mask is None, scale=scale)
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)[..., :hd_v]


def _flash_cases(records: dict) -> list:
    from modegpt_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    lines = _attention_cases("flash_attention", flash_attention, flash_attention_reference, KERNEL_CASES,
                             _flash_library)
    records["flash_attention"] = _record(
        "flash_attention", "modegpt_tpu_torch/csrc/flash_attention_hbm.cu",
        "modegpt_tpu/kernels/flash_attention.py:156", lines[0],
    )
    return lines


def _hbm_cases(records: dict) -> list:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from modegpt_tpu_torch.kernels.flash_attention import flash_attention_hbm, flash_attention_hbm_reference

    def library(q, k, v, scale, w, T):
        # at long T the math backend would build the [T, T] scores, so the
        # memory-efficient backend is pinned, on K/V repeated to H heads and
        # head dims padded to a multiple of 8 outside the timed call
        G = q.shape[1] // k.shape[1]
        hd_v = v.shape[-1]
        q, k, v = _pad8(q, k, v)
        kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        mask = _window_mask(T, w)
        kw = dict(attn_mask=mask, is_causal=mask is None, scale=scale)

        def run():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(q, kr, vr, **kw)[..., :hd_v]
        return run

    lines = _attention_cases(
        "flash_attention_hbm", flash_attention_hbm, flash_attention_hbm_reference, HBM_CASES, library
    )
    records["flash_attention_hbm"] = _record(
        "flash_attention_hbm", "modegpt_tpu_torch/csrc/flash_attention_hbm.cu",
        "modegpt_tpu/kernels/flash_attention.py:318", lines[0],
    )
    return lines


def _record(name: str, source: str, replaces: str, main: dict) -> dict:
    """The kernels-line entry of one kernel, from its main-path case."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "launches_by_phase": {},
        "max_abs_err": main["max_abs_err"], "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "bound_route": main["bound_route"],
        "library_ms": main["library_ms"],
    }


def ragged_live(pos, S: int, T: int, window):
    """Per (row, query) live-key counts and per-row union counts of
    ragged_gqa_attend: query s of row b attends t in
    [max(0, pos+s+1-window), pos+s] with t < T."""
    per_query, union = [], []
    for p in pos:
        lo0 = max(0, p + 1 - window) if window else 0
        union.append(max(0, min(p + S - 1, T - 1) - lo0 + 1))
        for s in range(S):
            lo = max(0, p + s + 1 - window) if window else 0
            per_query.append(max(0, min(p + s, T - 1) - lo + 1))
    return per_query, union


def _ragged_cases(records: dict) -> list:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from modegpt_tpu_torch.kernels.ragged_decode import (
        ragged_gqa_attend,
        ragged_gqa_attend_reference,
    )

    lines = []
    rng = np.random.default_rng(0)
    for case in RAGGED_CASES:
        B, H, Hk, T, S, Rq, Rv = (case[k] for k in ("B", "H", "Hk", "T", "S", "Rq", "Rv"))
        w, cap, dt = case["window"], case["softcap"], getattr(torch, case["dtype"])
        if case["pos"] is None:
            pos_host = rng.integers(0, T, size=B).tolist()
        elif case["pos"] == "edge":
            pos_host = rng.integers(0, T, size=B).tolist()
            pos_host[1] = T + 5  # a masked row: at or past the pool's end
        elif case["pos"] == "batched":
            pos_host = rng.integers(0, T, size=B).tolist()
            pos_host[:3] = [0, T - 60, T + 5]  # first chunk; near the end; an idle row past it
        else:
            pos_host = list(case["pos"])

        def randn(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

        q = randn(B, H, S, Rq, scale=Rq**-0.5).to(dt)  # pre-scaled, as the serving path passes it
        k_scale = v_scale = None
        if case["int8"]:
            k = torch.from_numpy(rng.integers(-127, 128, (B, Hk, T, Rq), dtype=np.int8)).cuda()
            v = torch.from_numpy(rng.integers(-127, 128, (B, Hk, T, Rv), dtype=np.int8)).cuda()
            k_scale = torch.from_numpy(rng.uniform(0.5, 1.5, (B, Hk, T)).astype(np.float32) / 127).cuda()
            v_scale = torch.from_numpy(rng.uniform(0.5, 1.5, (B, Hk, T)).astype(np.float32) / 127).cuda()
        else:
            k = randn(B, Hk, T, Rq).to(dt)
            v = randn(B, Hk, T, Rv).to(dt)
        pos = torch.tensor(pos_host, dtype=torch.int32, device="cuda")
        kw = dict(k_scale=k_scale, v_scale=v_scale, window=w, softcap=cap)

        got = ragged_gqa_attend(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        want = ragged_gqa_attend_reference(q, k, v, pos, **kw)
        err = float((got.float() - want.float()).abs().max())
        tol = TOLERANCE[case["dtype"]]
        ok = bool(torch.allclose(got.float(), want.float(), **tol)) and bool(torch.isfinite(got).all())
        kernel_ms = cuda_ms(lambda: ragged_gqa_attend(q, k, v, pos, **kw), iters=20)
        plain_ms = cuda_ms(lambda: ragged_gqa_attend_reference(q, k, v, pos, **kw), iters=5)

        library_ms = None
        if not case["int8"] and cap is None:
            t_ids = torch.arange(T, device="cuda")
            limit = pos.long()[:, None] + torch.arange(S, device="cuda")[None, :]  # [B, S]
            mask = t_ids[None, None, :] <= limit[:, :, None]
            if w:
                mask = mask & (t_ids[None, None, :] > limit[:, :, None] - w)
            mask = mask[:, None]  # [B, 1, S, T]
            if bool(mask.any(-1).all()):  # SDPA gives NaN for a row with no visible key
                library_ms = _library_ms(
                    case["name"],
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=1.0, enable_gqa=True
                    ),
                )

        per_query, union = ragged_live(pos_host, S, T, w)
        flops = 2.0 * H * sum(per_query) * (Rq + Rv)
        kv_row_bytes = Hk * ((Rq + Rv) * k.element_size() + (8 if case["int8"] else 0))
        nbytes = sum(union) * kv_row_bytes + sum(
            t.numel() * t.element_size() for t in (q, got, pos)
        )
        bound_ms, bound_by, bound_route = _bound(flops, nbytes, case["dtype"])
        line = {
            "phase": "kernel", "kernel": "ragged_gqa_attend", "case": case["name"],
            "shape": {k_: case[k_] for k_ in ("B", "H", "Hk", "T", "S", "Rq", "Rv", "window", "softcap", "int8")},
            "pos": pos_host if B <= 8 else None,
            "dtype": case["dtype"], "max_abs_err": err, "tolerance": tol, "ok": ok,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": bound_route,
        }
        emit(line)
        lines.append(line)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    records["ragged_gqa_attend"] = _record(
        "ragged_gqa_attend", "modegpt_tpu_torch/csrc/ragged_decode.cu",
        "modegpt_tpu/kernels/ragged_decode.py:289", lines[0],
    )
    return lines


def _profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _profile_line(prof, wall_s: float, phase: str = "main", ranges=()) -> dict:
    """Device busy time (the sum of every kernel's and copy's device
    time, from the profiler's CUDA trace) against the phase's wall time,
    the ten largest device-time entries, and the device time of the
    kernels launched inside each named `record_function` range."""
    import torch

    rows, in_range = [], {}
    for e in prof.key_averages():
        if e.key in ranges:  # an annotation: its kernels are counted in their own rows
            if e.device_type != torch.autograd.DeviceType.CUDA:
                dev_us = getattr(e, "device_time_total", None)
                in_range[e.key] = (e.cuda_time_total if dev_us is None else dev_us) / 1e6
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op rows would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e3
    line = {
        "phase": "profile", "of": phase, "wall_s": wall_s, "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "top_device": [{"name": k[:80], "ms": ms, "count": n} for k, ms, n in rows[:10]],
    }
    if ranges:
        line["range_device_s"] = in_range
    return line


MOE_RANGE = "moe_mlp (every expert on every token)"
CAPPED_RANGE = "plain attention (soft-capped scores)"


@contextlib.contextmanager
def _annotated(name: str, range_name: str):
    """Wrap the function `name` of `models.forward` (the unrolled and the
    padded forward both call it from there) in a profiler range named
    `range_name`, counting its calls: `_moe_mlp`, the dense MoE MLP, or
    `flash_attention_reference`, the plain attention. Yields
    {"calls": n}."""
    import torch

    from modegpt_tpu_torch.models import forward as forward_mod

    original = getattr(forward_mod, name)
    count = {"calls": 0}

    def annotated(*args, **kwargs):
        count["calls"] += 1
        with torch.profiler.record_function(range_name):
            return original(*args, **kwargs)

    setattr(forward_mod, name, annotated)
    try:
        yield count
    finally:
        setattr(forward_mod, name, original)


def phase_main(records: dict, profile: bool = False, keep_artifact: bool = False) -> dict:
    """The compression job at Llama-3-8B widths. With `keep_artifact` the
    artifact directory outlives the phase (the server phase serves it
    through the CLI); its temporary root is returned as ``tmp`` for the
    caller to remove."""
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import forward_padded, pad_to_uniform, padding_overhead
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(SimpleNamespace(**{**LLAMA3_8B, "num_hidden_layers": N_LAYERS}))
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    root = tempfile.mkdtemp(prefix="modegpt_smoke_") if keep_artifact else None
    tmp_dir = contextlib.nullcontext(root) if keep_artifact else tempfile.TemporaryDirectory(prefix="modegpt_smoke_")
    with tmp_dir as tmp:
        config = CompressionConfig(
            model="random-llama3-8b-widths", device="cuda",
            seq_len=2048, calib_size=8, calibs_batch_size=2, eval_batch_size=2,
            eval_max_samples=4, compression_ratio=0.3, dataset="synthetic",
            solver_precision="f32_device",
            output_dir=os.path.join(tmp, "out"),
            temp_storage_dir=os.path.join(tmp, "layers"),
            metrics_dir=os.path.join(tmp, "metrics"),
        ).validate()
        torch.cuda.reset_peak_memory_stats()
        prof = _profiler() if profile else contextlib.nullcontext()
        t_run = time.perf_counter()
        fa_mod.flash_attention.launches = 0
        with prof:
            results = run_compression(config, spec=spec, params=params)
        launches = fa_mod.flash_attention.launches
        t_run = time.perf_counter() - t_run
        del params
        if profile:
            emit(_profile_line(prof, t_run))

        n_eval = min(config.eval_max_samples, 16)  # the synthetic eval set
        n_batches = 2 * math.ceil(n_eval / config.eval_batch_size) + math.ceil(
            config.calib_size / config.calibs_batch_size
        )
        expected = N_LAYERS * n_batches
        # the compressed model as the pipeline's reload step read it back
        # from the artifact (every leaf's shape checked against the spec)
        cspec = results["compressed_spec"]
        params2 = results.pop("compressed_params")
        artifact_bytes = os.path.getsize(os.path.join(results["artifact_dir"], "params.npz"))
        # the compressed model's logits through the kernel agree with the
        # plain attention path on one eval batch (unaligned head dims)
        eval_tokens = load_eval_tokens(None, "synthetic", 512, 1, vocab_size=spec.vocab_size)
        ids = torch.as_tensor(eval_tokens, device="cuda")
        # the padded stack through K1 agrees with the unrolled forward
        pm = pad_to_uniform(cspec, params2)
        with torch.no_grad():
            lk, _ = forward(cspec, params2, ids, attn_impl="flash")
            lp, _ = forward(cspec, params2, ids, attn_impl="xla")
            lpad = forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, ids, attn_impl="flash")
        logit_err = float((lk - lp).abs().max())
        logit_ok = bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3))
        padded_err = float((lpad - lk).abs().max())
        padded_ok = bool(torch.allclose(lpad, lk, rtol=1e-3, atol=1e-3))
        del lk, lp, lpad

    records["flash_attention"]["launches_by_phase"]["main"] = launches
    line = {
        "phase": "main", "model": "Meta-Llama-3-8B widths", "n_layers": N_LAYERS,
        "compressed_eval_path": resolve_exec_mode(cspec, config.compressed_exec),
        "padding_overhead": padding_overhead(cspec),
        "init_seconds": init_s,
        "step_seconds": results["step_seconds"],
        "total_seconds": results["total_seconds"],
        "baseline_ppl": results["baseline_ppl"], "compressed_ppl": results["compressed_ppl"],
        "params_before": results["params_before"], "params_after": results["params_after"],
        "ranks": {
            "q": list(cspec.q_ranks), "k": list(cspec.k_ranks), "v": list(cspec.v_ranks),
            "o": list(cspec.o_ranks), "gate": list(cspec.gate_ranks),
        },
        "launches": {"flash_attention": launches}, "expected_launches": {"flash_attention": expected},
        "compressed_logits_max_abs_err": logit_err,
        "padded_vs_unrolled_logits_max_abs_err": padded_err,
        "artifact_bytes": artifact_bytes,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(line)
    problems = []
    if launches != expected:
        problems.append(f"flash_attention launched {launches} times, expected {expected}")
    for key in ("baseline_ppl", "compressed_ppl"):
        if not math.isfinite(results[key]):
            problems.append(f"{key} is not finite")
    if not (0 < sum(cspec.gate_ranks) < sum(spec.gate_ranks)
            and 0 < sum(cspec.q_ranks) < sum(spec.q_ranks)
            and 0 < sum(cspec.v_ranks) < sum(spec.v_ranks)):
        problems.append("rank lists did not shrink")
    if not logit_ok:
        problems.append(f"compressed logits: kernel vs plain attention differ by {logit_err}")
    if not padded_ok:
        problems.append(f"compressed logits: forward_padded vs unrolled forward differ by {padded_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    job = dict(
        seq_len=config.seq_len, eval_max_samples=config.eval_max_samples,
        eval_batch_size=config.eval_batch_size, compressed_exec=config.compressed_exec,
        compressed_ppl=results["compressed_ppl"], artifact_bytes=artifact_bytes,
        save_seconds=results["step_seconds"]["save_artifact"],
        reload_seconds=results["step_seconds"]["reload_artifact"],
        k1_per_eval=N_LAYERS * math.ceil(n_eval / config.eval_batch_size),
    )
    return {"spec": cspec, "params": params2, "pm": pm, "job": job, "tmp": root,
            "artifact_dir": results["artifact_dir"] if keep_artifact else None}


def _clone_state(state):
    import torch

    return type(state)(*(
        None if f is None else (f.clone() if isinstance(f, torch.Tensor) else f.copy()) for f in state
    ))


def _serve_round(batcher, prompts, generator, on_step=None):
    """Submit `prompts` and step the batcher until it drains; returns
    ({rid: tokens}, [rid per prompt], wall seconds without on_step)."""
    import torch

    rids = [batcher.submit(p, max_new_tokens=SERVE["max_new_tokens"]) for p in prompts]
    done, aside, t0 = {}, 0.0, time.perf_counter()
    for step in range(10_000):
        fin, drained = batcher.step(generator)
        done.update(fin)
        if drained:
            break
        if on_step is not None:
            t1 = time.perf_counter()
            on_step(step)
            aside += time.perf_counter() - t1
    torch.cuda.synchronize()
    return done, rids, time.perf_counter() - t0 - aside


@contextlib.contextmanager
def _counted_dispatches():
    """Count and time the dispatches around the port's step functions:
    per-slot prefill chunks, single decode steps, batched and mixed
    prefill rounds (`_prefill_slots`, told apart by the batcher's round),
    fused decode (`_decode_slots_multi`, one dispatch of n steps), draft
    steps (`_draft_slots`, k + 1 dispatches) and verify dispatches, and
    `models.speculative`'s model steps. Yields ({kind: count}, {kind:
    seconds}); counts["layer_dispatches"] sums each call's layers times
    its forward dispatches: the K3 launches the calls make."""
    import torch

    from modegpt_tpu_torch.models import serving, speculative

    kinds = ("prefill", "decode", "batched", "mixed", "fused", "draft", "verify", "spec_step")
    counts = dict.fromkeys(kinds, 0)
    counts["layer_dispatches"] = 0
    seconds = dict.fromkeys(kinds, 0.0)
    flag = [False]  # inside a mixed round
    steps = {  # kind -> (function name, forward dispatches of one call)
        "prefill": ("_prefill_chunk", lambda a, kw: 1),
        "decode": ("_one_decode_step", lambda a, kw: 1),
        "batched": ("_prefill_slots", lambda a, kw: 1),
        "fused": ("_decode_slots_multi", lambda a, kw: a[5]),
        "draft": ("_draft_slots", lambda a, kw: a[3] + 1),
        "verify": ("_verify_slots", lambda a, kw: 1),
    }
    originals = {kind: getattr(serving, name) for kind, (name, _) in steps.items()}
    rounds, spec_step = serving.ContinuousBatcher._batched_rounds, speculative._Padded.step

    def timed(kind, fn, layers, n, *args, **kwargs):
        kind = "mixed" if kind == "batched" and flag[0] else kind
        counts[kind] += 1
        counts["layer_dispatches"] += layers * n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[kind] += time.perf_counter() - t0
        return out

    def counted(kind):
        def run(*args, **kwargs):
            return timed(kind, originals[kind], args[0].spec.n_layers, steps[kind][1](args, kwargs), *args, **kwargs)
        return run

    def counted_rounds(self, generator, mixed):
        flag[0] = mixed
        try:
            return rounds(self, generator, mixed)
        finally:
            flag[0] = False

    def counted_spec_step(self, *args, **kwargs):
        return timed("spec_step", spec_step, self.pm.spec.n_layers, 1, self, *args, **kwargs)

    for kind, (name, _) in steps.items():
        setattr(serving, name, counted(kind))
    serving.ContinuousBatcher._batched_rounds = counted_rounds
    speculative._Padded.step = counted_spec_step
    try:
        yield counts, seconds
    finally:
        for kind, (name, _) in steps.items():
            setattr(serving, name, originals[kind])
        serving.ContinuousBatcher._batched_rounds = rounds
        speculative._Padded.step = spec_step


def _decode_logits(pm, state, decode_attn: str, moe: str = "dense", moe_capacity: float = 2.0, active=None):
    """One decode step's logits from a clone of `state` (the batcher's
    own state is untouched). K3 launches made here are comparisons and
    are taken back off its counter."""
    import torch

    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models.padded import _model_step_padded

    saved = rd_mod.ragged_gqa_attend.launches
    st = _clone_state(state)
    valid = None if active is None else torch.tensor(active, device="cuda")[:, None]
    logits, _ = _model_step_padded(
        pm.spec, pm.layers, pm.other, pm.q_hd_true, st.last_token[:, None], st.cache_k, st.cache_v,
        st.lengths, cache_scales=st.scales, decode_attn=decode_attn, moe=moe, moe_capacity=moe_capacity,
        token_valid=valid,
    )
    rd_mod.ragged_gqa_attend.launches = saved
    return logits


def _decoding(batcher) -> list:
    """Which slots of `batcher` are decode-active (prefilled, unfinished)."""
    return [r is not None and not c for r, c in zip(batcher.slot_req, batcher.slot_chunks)]


def _teacher_forcing(cspec, cparams, done: dict, rids, prompts, new: int, logits_of=None):
    """Every served token against the unrolled forward (K1) over prompt +
    output, or against ``logits_of(ids [1, T]) -> [1, T, V]``: (exact
    argmax count, the largest gap of a served token's logit below its
    row's max)."""
    import torch

    from modegpt_tpu_torch.models.forward import forward

    if logits_of is None:
        def logits_of(ids):
            return forward(cspec, cparams, ids)[0]

    exact, max_gap = 0, 0.0
    for rid, prompt in zip(rids, prompts):
        seq, P = done[rid], len(prompt)
        with torch.no_grad():
            logits = logits_of(torch.tensor([seq], device="cuda"))
        rows = logits[0, P - 1 : P - 1 + new]
        served = torch.tensor(seq[P:], device="cuda")
        gap = rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0]
        exact += int((rows.argmax(dim=-1) == served).sum())
        max_gap = max(max_gap, float(gap.max()))
        del logits
    return exact, max_gap


def _serve_prompts(vocab_size: int, count: int):
    """`count` prompts of token ids from the synthetic eval set, lengths
    uniform over [min_prompt, max_prompt] from the serve phase's seed."""
    import numpy as np

    from modegpt_tpu_torch.calib.data import load_eval_tokens

    rng = np.random.default_rng(SERVE["seed"])
    lens = rng.integers(SERVE["min_prompt"], SERVE["max_prompt"] + 1, size=count)
    windows = load_eval_tokens(None, "synthetic", 2 * SERVE["max_prompt"], 16, vocab_size=vocab_size)
    return [windows[i % 16, (i // 16) * SERVE["max_prompt"]:][: lens[i]] for i in range(count)], lens


def phase_serve(records: dict, main_out: dict, profile: bool = False) -> dict:
    """Serve the compressed model the main phase reloaded, padded, through
    the continuous batcher with decode_attn="auto" (K3 on the card).
    With `profile`, the 16-request round runs under torch.profiler."""
    import torch

    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving

    cspec, cparams, pm = main_out["spec"], main_out["params"], main_out["pm"]
    n, n_int8, new = SERVE["requests"], SERVE["int8_requests"], SERVE["max_new_tokens"]
    prompts, lens = _serve_prompts(cspec.vocab_size, n + n_int8)
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_bucket=SERVE["prefill_bucket"],
              temperature=0.0)
    checks = {}

    def check_decode_backends(name, batcher):
        """Once some slot of `batcher` decodes: one decode step's logits
        through K3 and through its plain version (for int8 KV, over the
        same codes and scales)."""
        def on_step(step):
            if name in checks or not any(_decoding(batcher)):
                return
            lk, lp = (_decode_logits(pm, batcher.state, attn) for attn in ("ragged", "xla"))
            checks[name] = dict(step=step, err=float((lk - lp).abs().max()),
                                ok=bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3)))
        return on_step

    gen = torch.Generator(device="cuda").manual_seed(0)
    with _counted_dispatches() as (counts, seconds):
        torch.cuda.reset_peak_memory_stats()
        rd_mod.ragged_gqa_attend.launches = 0
        b = serving.ContinuousBatcher(pm, decode_attn="auto", **kw)
        clocks_line("before the 16-request round", "serve")
        with _profiler() if profile else contextlib.nullcontext() as prof:
            done, rids, wall = _serve_round(b, prompts[:n], gen, on_step=check_decode_backends("model", b))
        clocks_line("after the 16-request round", "serve")
        b8 = serving.ContinuousBatcher(pm, decode_attn="auto", kv_dtype="int8", **kw)
        done8, rids8, wall8 = _serve_round(b8, prompts[n:], gen, on_step=check_decode_backends("int8", b8))
        launches = rd_mod.ragged_gqa_attend.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        emit(_profile_line(prof, wall, "serve"))
    dispatches = counts["prefill"] + counts["decode"]
    expected = cspec.n_layers * dispatches

    # teacher forcing: every request of the model-dtype round
    exact, max_gap = _teacher_forcing(cspec, cparams, done, rids, prompts[:n], new)
    lengths_ok = all(len(done.get(r, [])) == len(p) + new for r, p in zip(rids, prompts[:n])) and all(
        len(done8.get(r, [])) == len(p) + new for r, p in zip(rids8, prompts[n:])
    )
    records["ragged_gqa_attend"]["launches_by_phase"]["serve"] = launches
    line = {
        "phase": "serve", "slots": SERVE["slots"], "max_len": SERVE["max_len"],
        "prefill_bucket": SERVE["prefill_bucket"], "decode_attn": b.decode_attn,
        "requests": n, "int8_requests": n_int8, "prompt_lengths": lens.tolist(),
        "max_new_tokens": new,
        "serving_wall_seconds": wall, "generated_tokens_per_s": n * new / wall,
        "int8_wall_seconds": wall8, "int8_generated_tokens_per_s": n_int8 * new / wall8,
        "dispatches": counts, "mean_prefill_dispatch_ms": 1e3 * seconds["prefill"] / max(counts["prefill"], 1),
        "mean_decode_dispatch_ms": 1e3 * seconds["decode"] / max(counts["decode"], 1),
        "launches": {"ragged_gqa_attend": launches}, "expected_launches": {"ragged_gqa_attend": expected},
        "decode_backends_check": checks,
        "teacher_forcing": {"requests": n, "exact_argmax": exact, "of": n * new,
                            "max_gap_to_row_max": max_gap},
        "peak_memory_gib": peak,
    }
    emit(line)
    problems = []
    if launches != expected:
        problems.append(f"ragged_gqa_attend launched {launches} times, expected {expected}")
    if b.decode_attn != "ragged" or b8.decode_attn != "ragged":
        problems.append(f"decode_attn auto resolved to {b.decode_attn}/{b8.decode_attn}, not ragged")
    if not lengths_ok:
        problems.append(f"a request did not return prompt + {new} tokens")
    for name in ("model", "int8"):
        if not checks.get(name, {}).get("ok"):
            problems.append(f"decode logits K3 vs plain, {name} KV: {checks.get(name)}")
    if max_gap > 1e-3:
        problems.append(f"a served token is {max_gap} below its row's max logit")
    if problems:
        raise AssertionError("; ".join(problems))
    return line


# The sched phase: the serve phase's model, prompts and SERVE settings
# through each execution mode of the batcher, one round each.
SCHED_ROUNDS = {
    "a_batched": dict(prefill_exec="batched", mixed_prefill_decode=False),
    "b_mixed": dict(prefill_exec="batched"),
    "c_fused4": dict(steps_per_dispatch=4),
    "d_mixed_fused4": dict(prefill_exec="batched", steps_per_dispatch=4),
    "e_prefix_cache": dict(prefix_cache=True),
    "f_prompt_lookup": dict(spec_decode="prompt_lookup", n_draft=4),
    "g_draft": dict(spec_decode="draft", n_draft=4),
    "h_int8_batched_fused4": dict(kv_dtype="int8", prefill_exec="batched", steps_per_dispatch=4),
    "i_near_pool_end": dict(prefill_exec="batched", steps_per_dispatch=4),
}
# i: a first request of near_end tokens decodes within a bucket of the
# pool's end while later requests prefill, so its mixed-round rows (and
# its idle row once it finishes) write up to 127 positions past the pool
SCHED = dict(prefix=256, min_tail=16, max_tail=384, int8_requests=4, spec_prompts=2, spec_prompt_len=96,
             spec_temperature=0.7, near_end=958, near_end_requests=12)


def _prefix_prompts(vocab_size: int, count: int):
    """`count` prompts sharing one 256-token prefix (two buckets) from the
    synthetic eval set, each with its own tail of 16-384 tokens."""
    import numpy as np

    from modegpt_tpu_torch.calib.data import load_eval_tokens

    rng = np.random.default_rng(SERVE["seed"] + 1)
    tails = rng.integers(SCHED["min_tail"], SCHED["max_tail"] + 1, size=count)
    windows = load_eval_tokens(None, "synthetic", 2 * SERVE["max_prompt"], 16, vocab_size=vocab_size)
    prefix = windows[0, : SCHED["prefix"]]
    return [np.concatenate([prefix, windows[i % 16, SCHED["prefix"] : SCHED["prefix"] + tails[i]]])
            for i in range(count)]


def phase_sched(records: dict, main_out: dict) -> dict:
    """The batcher's execution modes on the card: batched and mixed
    prefill, fused decode, prefix caching, prompt lookup and a draft model
    (the dense Llama-3-8B-width target, rebuilt from the main phase's seed,
    with the compressed model as its draft), and int8 KV with batched
    prefill and fused decode; then `speculative_generate` and
    `prompt_lookup_generate`. Each round: K3's launches against the
    layers times the dispatches counted, every served token against the
    served model's unrolled forward (K1), decode_attn resolved to K3."""
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving, speculative
    from modegpt_tpu_torch.models.forward import FLASH_MIN_T
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import _model_step_padded, pad_to_uniform
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    t_phase = time.perf_counter()
    cspec, cparams, pm = main_out["spec"], main_out["params"], main_out["pm"]
    n, new = SERVE["requests"], SERVE["max_new_tokens"]
    prompts, _ = _serve_prompts(cspec.vocab_size, n)
    prefix_prompts = _prefix_prompts(cspec.vocab_size, n)
    windows = load_eval_tokens(None, "synthetic", 2 * SERVE["max_prompt"], 16, vocab_size=cspec.vocab_size)
    dspec = spec_from_hf_config(SimpleNamespace(**{**LLAMA3_8B, "num_hidden_layers": N_LAYERS}))
    dparams = init_params(dspec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    dense = pad_to_uniform(dspec, dparams)
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_bucket=SERVE["prefill_bucket"],
              temperature=0.0, decode_attn="auto")
    rd_mod.ragged_gqa_attend.launches = fa_mod.flash_attention.launches = 0
    k1_forwards, k3_total, problems, lines = 0, 0, [], []

    def int8_kv_logits(ids):
        """The int8-KV served model over a whole sequence: one padded step
        into an int8 cache (the same per-position codes and scales as the
        served dispatches), through the plain cache attention."""
        st = serving.init_serve_state(pm, 1, ids.shape[1], kv_dtype="int8")
        return _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, ids, st.cache_k, st.cache_v, 0,
                                  cache_scales=st.scales, decode_attn="xla")[0]

    def check_tokens(name, spec, params, done, rids, round_prompts, layers, logits_of=None):
        nonlocal k1_forwards
        lengths_ok = all(len(done.get(r, [])) == len(p) + new for r, p in zip(rids, round_prompts))
        exact, gap = _teacher_forcing(spec, params, done, rids, round_prompts, new, logits_of)
        if logits_of is None:  # the unrolled forward's K1 route
            k1_forwards += layers * sum(len(done[r]) >= FLASH_MIN_T for r in rids)
        if not lengths_ok:
            problems.append(f"{name}: a request did not return prompt + {new} tokens")
        if gap > 1e-3:
            problems.append(f"{name}: a served token is {gap} below its row's max logit")
        return {"exact_argmax": exact, "of": len(rids) * new, "max_gap_to_row_max": gap}

    def serve(name, settings, round_prompts, target=pm, draft=None):
        with _counted_dispatches() as (counts, seconds):
            launches0 = rd_mod.ragged_gqa_attend.launches
            b = serving.ContinuousBatcher(target, **kw, **settings, **({"draft_pm": draft} if draft else {}))
            gen = torch.Generator(device="cuda").manual_seed(0)
            done, rids, wall = _serve_round(b, round_prompts, gen)
            launches = rd_mod.ragged_gqa_attend.launches - launches0
        if launches != counts["layer_dispatches"]:
            problems.append(f"{name}: K3 launched {launches} times, expected {counts['layer_dispatches']}")
        if b.decode_attn != "ragged":
            problems.append(f"{name}: decode_attn auto resolved to {b.decode_attn}")
        kinds = [k for k in seconds if counts[k]]
        line = {
            "phase": "sched", "round": name, "settings": settings, "requests": len(round_prompts),
            "wall_seconds": wall, "generated_tokens_per_s": len(round_prompts) * new / wall,
            "dispatches": {k: counts[k] for k in kinds},
            "mean_dispatch_ms": {k: 1e3 * seconds[k] / counts[k] for k in kinds},
            "launches": {"ragged_gqa_attend": launches},
            "expected_launches": {"ragged_gqa_attend": counts["layer_dispatches"]},
            "decode_attn": b.decode_attn,
        }
        if b.prefix_cache:
            line["prefix"] = {"hits": b.prefix_hits, "tokens_reused": b.prefix_tokens_reused}
        if b.stats:
            drafted = sum(st["drafted"] for st in b.stats.values())
            accepted = sum(st["accepted"] for st in b.stats.values())
            line["speculative"] = {"rounds": sum(st["rounds"] for st in b.stats.values()), "drafted": drafted,
                                   "accepted": accepted, "acceptance_rate": accepted / max(drafted, 1)}
        return b, done, rids, line, launches

    for name, settings in SCHED_ROUNDS.items():
        round_prompts = prefix_prompts if name.startswith("e_") else prompts
        if name.startswith("h_"):
            round_prompts = prompts[: SCHED["int8_requests"]]
        if name.startswith("i_"):
            round_prompts = [windows[2, : SCHED["near_end"]]] + prompts[1 : SCHED["near_end_requests"]]
        target, draft = (dense, pm) if name.startswith("g_") else (pm, None)
        twins = []
        if name.startswith("e_"):  # in turns: uncached, cached, cached, uncached
            twins.append(serve("e_uncached_twin", {}, round_prompts))
        b, done, rids, line, launches = serve(name, settings, round_prompts, target, draft)
        k3_total += launches
        spec_, params_ = (dspec, dparams) if target is dense else (cspec, cparams)
        line["teacher_forcing"] = check_tokens(name, spec_, params_, done, rids, round_prompts, spec_.n_layers,
                                               int8_kv_logits if settings.get("kv_dtype") == "int8" else None)
        if twins:
            again = serve(name, settings, round_prompts)
            twins.append(serve("e_uncached_twin", {}, round_prompts))
            k3_total += sum(t[4] for t in twins) + again[4]
            line["repeat_generated_tokens_per_s"] = again[3]["generated_tokens_per_s"]
            line["uncached_twin"] = [{k: t[3][k] for k in ("generated_tokens_per_s", "dispatches", "mean_dispatch_ms")}
                                     for t in twins]
            if b.prefix_hits <= 0:
                problems.append("e: no prefix was adopted")
            for _, twin, twin_rids, _, _ in twins + [again]:
                if [done[r] for r in rids] != [twin[r] for r in twin_rids]:
                    problems.append("e: the prefix-cached tokens differ from the uncached round's")
        emit(line)
        lines.append(line)

    # models.speculative: greedy and sampled, on the dense target
    spec_prompts = windows[1 : 1 + SCHED["spec_prompts"], : SCHED["spec_prompt_len"]]
    with _counted_dispatches() as (counts, seconds):
        launches0 = rd_mod.ragged_gqa_attend.launches
        runs = {}
        for name, fn in (
            ("speculative_generate", lambda **k: speculative.speculative_generate(pm, dense, spec_prompts, **k)),
            ("prompt_lookup_generate", lambda **k: speculative.prompt_lookup_generate(dense, spec_prompts, **k)),
        ):
            t0 = time.perf_counter()
            out, stats = fn(max_new_tokens=new, n_draft=4, return_stats=True)
            torch.cuda.synchronize()
            runs[name] = (out, stats, time.perf_counter() - t0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        sampled = speculative.speculative_generate(pm, dense, spec_prompts, max_new_tokens=new, n_draft=4,
                                                   temperature=SCHED["spec_temperature"], generator=gen)
        launches = rd_mod.ragged_gqa_attend.launches - launches0
    k3_total += launches
    if launches != counts["layer_dispatches"]:
        problems.append(f"speculative.py: K3 launched {launches} times, expected {counts['layer_dispatches']}")
    P = spec_prompts.shape[1]
    if tuple(sampled.shape) != (len(spec_prompts), P + new) or not bool(
            ((sampled >= 0) & (sampled < dspec.vocab_size)).all()):
        problems.append(f"sampled speculative_generate: shape {tuple(sampled.shape)} or ids out of range")
    spec_line = {"phase": "sched", "round": "speculative.py", "prompts": len(spec_prompts), "prompt_len": P,
                 "max_new_tokens": new, "launches": {"ragged_gqa_attend": launches},
                 "expected_launches": {"ragged_gqa_attend": counts["layer_dispatches"]},
                 "model_steps": counts["spec_step"]}
    for name, (out, stats, wall) in runs.items():
        done = {i: out[i].tolist() for i in range(len(spec_prompts))}
        spec_line[name] = {
            "wall_seconds": wall, "generated_tokens_per_s": len(spec_prompts) * new / wall,
            "rounds": int(stats.rounds.sum()), "drafted": int(stats.drafted.sum()),
            "accepted": int(stats.accepted.sum()),
            "acceptance_rate": float(stats.accepted.sum()) / max(float(stats.drafted.sum()), 1.0),
            "teacher_forcing": check_tokens(name, dspec, dparams, done, list(done), list(spec_prompts),
                                            dspec.n_layers),
        }
    emit(spec_line)
    k1 = fa_mod.flash_attention.launches
    if k1 != k1_forwards:
        problems.append(f"K1 launched {k1} times in the teacher-forcing forwards, expected {k1_forwards}")
    records["ragged_gqa_attend"]["launches_by_phase"]["sched"] = k3_total
    records["flash_attention"]["launches_by_phase"]["sched"] = k1
    summary = {"phase": "sched", "rounds": [ln["round"] for ln in lines] + ["speculative.py"],
               "launches": {"ragged_gqa_attend": k3_total, "flash_attention": k1},
               "expected_launches": {"flash_attention": k1_forwards},
               "seconds": time.perf_counter() - t_phase}
    emit(summary)
    del dense, dparams
    if problems:
        raise AssertionError("; ".join(problems))
    return summary


# The server phase: the main phase's compressed model behind the port's
# OpenAI-style HTTP server (per-request sampling, guided decoding,
# logit_bias and min_tokens, logprobs, streaming, cancel, back-pressure).
SERVER = dict(
    greedy=6, streaming=3, sampled=4, penalised=2, top_logprobs=5, seed=100,
    sampling=dict(temperature=0.8, top_k=50, top_p=0.9, min_p=0.05),
    penalties=dict(repetition_penalty=1.2, presence_penalty=0.5, frequency_penalty=0.5),
    choices=["yes", "no", "maybe"],
    schema={"type": "object", "properties": {"ok": {"type": "boolean"}, "tag": {"enum": ["a", "b"]}}},
    logit_bias={"1": 100.0, "500": 5.0}, min_tokens=5, cancel_tokens=400, gate_requests=8,
    timing_turns=10, lp_tol=2e-3, cli_timeout=600,
)
SERVER_WORDS = ["true", "false", "null", "yes", "no", "maybe", "hello", "world", "the", "quick", "brown", "fox",
                "lazy", "dog", "user", "system", "assistant"]


@functools.lru_cache(maxsize=1)
def _full_vocab_tokenizer(vocab_size: int):
    """An offline word-level tokenizer over all `vocab_size` ids: <unk> 0,
    <eos> 1, every printable non-space ASCII character, a few words, then
    fillers "w<i>". No token spells whitespace, so a guided JSON output is
    compact and its length bounded. Built once a run (~10 s at 128256
    ids) and shared by the phases that serve the main artifact."""
    import string

    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "<eos>": 1}
    for piece in list(string.printable[:94]) + SERVER_WORDS:
        vocab.setdefault(piece, len(vocab))
    i = 0
    while len(vocab) < vocab_size:
        vocab[f"w{i}"] = len(vocab)
        i += 1
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="<eos>", pad_token="<eos>")


def _http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    """One request to the server on 127.0.0.1: (status, body bytes, seconds
    to the first SSE event or None)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first, chunks = None, []
    if resp.getheader("Content-Type", "").startswith("text/event-stream"):
        while True:
            line = resp.readline()
            if not line:
                break
            if first is None and line.startswith(b"data: "):
                first = time.perf_counter() - t0
            chunks.append(line)
        data = b"".join(chunks)
    else:
        data = resp.read()
    conn.close()
    return resp.status, data, first


def _sse(data: bytes):
    return [json.loads(line[len(b"data: "):]) for line in data.split(b"\n")
            if line.startswith(b"data: ") and b"[DONE]" not in line]


def _served_rows(cspec, cparams, seq, P: int, n: int):
    """The unrolled forward's (K1 at T >= 128) float32 logits rows that
    chose a sequence's n tokens after its P prompt tokens."""
    import torch

    from modegpt_tpu_torch.models.forward import forward

    with torch.no_grad():
        logits = forward(cspec, cparams, torch.tensor([seq], device="cuda"))[0]
    return logits[0, P - 1 : P - 1 + n].float()


def phase_server(records: dict, main_out: dict) -> dict:
    """The main phase's compressed model (Llama-3-8B widths, 4 layers,
    padded, f32) behind `modegpt_tpu_torch.server`: a
    `ContinuousBatcher(slots=8, max_len=1024, prefill_bucket=128,
    per_request_sampling=True, decode_attn="auto")` and the HTTP server
    on 127.0.0.1, with an offline word-level tokenizer over all 128256 ids
    saved into the artifact. 16 concurrent clients: 6 greedy with
    logprobs and top_logprobs (3 streaming), 4 seeded sampled, 2
    penalised, 2 guided (a choice, a JSON schema), 1 with logit_bias and
    min_tokens, 1 streaming chat completion with n=2. Checks: greedy and
    penalised tokens within 1e-3 of their row's max in the unrolled
    forward (K1) under the same penalties and bias; logprobs and top-5 to
    `lp_tol`; seeded requests sent again alone return the same tokens;
    every sampled token is in the kept set recomputed from the forward;
    guided outputs are in their grammar; K3's launches equal the layers
    times the dispatches counted; a cancel frees its slot; a 429 under
    max_queue=0 with the scheduler held; /metrics counts the round. Then
    the decode-step and sampling costs, in turns, and the guide-row times
    at full vocabulary. (The server CLI's check runs in the cli phase.)"""
    import threading

    import numpy as np
    import torch

    from modegpt_tpu_torch import server as srv_mod
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import guided, serving
    from modegpt_tpu_torch.models.forward import FLASH_MIN_T
    from modegpt_tpu_torch.models.generate import filter_rows

    t_phase = time.perf_counter()
    cspec, cparams, pm = main_out["spec"], main_out["params"], main_out["pm"]
    V, new, cfg = cspec.vocab_size, SERVE["max_new_tokens"], SERVER
    problems, timings = [], {}
    t0 = time.perf_counter()
    tok = _full_vocab_tokenizer(V)
    timings["tokenizer_build_s"] = time.perf_counter() - t0
    tok.save_pretrained(main_out["artifact_dir"])
    eos = tok.eos_token_id
    prompts, lens = _serve_prompts(V, SERVE["requests"])
    prompts = [list(map(int, p)) for p in prompts]

    # guide rows at the full vocabulary, timed before the server builds its own
    t0 = time.perf_counter()
    token_bytes = guided.token_bytes_from_tokenizer(tok)
    timings["token_bytes_s"] = time.perf_counter() - t0
    guide_rows = {}
    for name, pattern in (("choice", guided.regex_for_choice(cfg["choices"])),
                          ("json", guided.regex_for_json_schema(cfg["schema"]))):
        t0 = time.perf_counter()
        g = guided.compile_regex(pattern, token_bytes, eos, vocab_size=V)
        t1 = time.perf_counter()
        g.mask_for(g.start)
        t2 = time.perf_counter()
        g.mask_for(g.start)
        t3 = time.perf_counter()
        st = g.advance(g.start, int(np.nonzero(g.mask_for(g.start))[0][0]))
        t4 = time.perf_counter()
        g.mask_for(st)
        guide_rows[name] = {"compile_ms": 1e3 * (t1 - t0), "first_visit_ms": 1e3 * (t2 - t1),
                            "cached_ms": 1e3 * (t3 - t2), "second_state_first_visit_ms": 1e3 * (time.perf_counter() - t4)}

    batcher = serving.ContinuousBatcher(pm, slots=SERVE["slots"], max_len=SERVE["max_len"],
                                        prefill_bucket=SERVE["prefill_bucket"], per_request_sampling=True,
                                        decode_attn="auto", eos_token_id=eos)
    server = srv_mod.InferenceServer(batcher, tokenizer=tok, model_id="llama3-8b-widths-4l")
    httpd = srv_mod.make_http_server(server, host="127.0.0.1", port=0, default_max_tokens=new)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]

    messages = [{"role": "system", "content": "the quick brown fox"}, {"role": "user", "content": "hello world"}]
    g_end = cfg["greedy"]
    s_end = g_end + cfg["sampled"]
    p_end = s_end + cfg["penalised"]
    bodies = []
    for i in range(SERVE["requests"]):
        body = {"prompt_ids": prompts[i], "max_tokens": new}
        if i < g_end:
            body.update(logprobs=True, top_logprobs=cfg["top_logprobs"], stream=i < cfg["streaming"])
        elif i < s_end:
            body.update(cfg["sampling"], seed=cfg["seed"] + i)
        elif i < p_end:
            body.update(cfg["penalties"])
        elif i == p_end:
            body.update(guided_choice=cfg["choices"])
        elif i == p_end + 1:
            body.update(guided_json=cfg["schema"])
        elif i == p_end + 2:
            body.update(logit_bias=cfg["logit_bias"], min_tokens=cfg["min_tokens"])
        else:
            body = {"messages": messages, "max_tokens": new, "n": 2, "stream": True}
        bodies.append(body)

    def run_round():
        """Every client at once; (replies, wall seconds)."""
        replies = [None] * len(bodies)

        def client(i):
            path = "/v1/chat/completions" if "messages" in bodies[i] else "/v1/completions"
            replies[i] = (*_http(port, "POST", path, bodies[i]), time.perf_counter())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        t_round = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return replies, max(r[3] for r in replies) - t_round

    try:
        with _counted_dispatches() as (counts, seconds):
            rd_mod.ragged_gqa_attend.launches = 0
            replies, wall = run_round()  # cold: the server builds its guides and token byte table
            cold = {k: (counts[k], seconds[k]) for k in ("prefill", "decode")}
            warm_replies, warm_wall = run_round()  # the same requests again, the guides cached
            warm = {k: (counts[k] - cold[k][0], seconds[k] - cold[k][1]) for k in ("prefill", "decode")}
            # the seeded requests again, one at a time
            repeats = {i: _http(port, "POST", "/v1/completions", bodies[i]) for i in range(g_end, s_end)}
            # a cancel frees its slot: a long stream, cancelled after its first event
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/v1/completions", body=json.dumps(
                {"prompt_ids": prompts[0][:64], "max_tokens": cfg["cancel_tokens"], "stream": True}))
            resp = conn.getresponse()
            first = _sse(resp.readline() + resp.readline())
            cancel_id = first[0]["id"] if first else "cmpl-?"
            rid = int(cancel_id.split("-")[1]) if first else -1
            status, data, _ = _http(port, "POST", "/v1/cancel", {"id": cancel_id})
            rest = resp.read()
            conn.close()
            cancel = {"status": status, "reply": json.loads(data), "slot_freed": rid not in batcher.slot_req,
                      "stream_done": b"[DONE]" in rest, "events_before_cancel": len(first),
                      "tokens_after_cancel": sum(len(e["token_ids"]) for e in _sse(rest))}
            # back-pressure: scheduler held, max_queue 0, every slot's worth queued
            held, real_step = [True], batcher.step

            def gated_step(generator=None):
                if held[0]:
                    time.sleep(0.001)
                    return {}, False
                return real_step(generator)

            batcher.step, server.max_queue = gated_step, 0
            queued = [threading.Thread(target=lambda i=i: _http(port, "POST", "/v1/completions",
                                                                {"prompt_ids": prompts[i][:32], "max_tokens": 2}))
                      for i in range(cfg["gate_requests"])]
            for t in queued:
                t.start()
            deadline = time.time() + 60
            while len(batcher.queue) < cfg["gate_requests"] and time.time() < deadline:
                time.sleep(0.01)
            over = _http(port, "POST", "/v1/completions", {"prompt_ids": prompts[0][:32], "max_tokens": 2})
            held[0] = False
            for t in queued:
                t.join()
            batcher.step, server.max_queue = real_step, None
            torch.cuda.synchronize()
            launches = rd_mod.ragged_gqa_attend.launches
        status, metrics_text, _ = _http(port, "GET", "/metrics")
        health = json.loads(_http(port, "GET", "/health")[1])
    finally:
        httpd.shutdown()
        server.close()
    metrics = dict(line.split() for line in metrics_text.decode().splitlines() if not line.startswith("#"))
    records["ragged_gqa_attend"]["launches_by_phase"]["server"] = launches
    if launches != counts["layer_dispatches"]:
        problems.append(f"K3 launched {launches} times, expected {counts['layer_dispatches']}")
    if batcher.decode_attn != "ragged":
        problems.append(f"decode_attn auto resolved to {batcher.decode_attn}")

    def parse(round_replies):
        """(tokens, logprobs, top-logprobs (ids, lps) rows, seconds to
        each stream's first event) of a round, keyed by request (a chat
        choice by (request, index))."""
        outs, lps, tops, ttfe = {}, {}, {}, []
        vocab = tok.get_vocab()
        for i, (status, data, first, _) in enumerate(round_replies):
            if status != 200:
                problems.append(f"request {i}: HTTP {status}: {data[:200]!r}")
                continue
            if bodies[i].get("stream"):
                events = _sse(data)
                ttfe.append(first)
                if "messages" in bodies[i]:
                    for c in (0, 1):
                        outs[(i, c)] = [t for e in events if e["choices"][0]["index"] == c
                                        for t in e["choices"][0]["token_ids"]]
                else:
                    outs[i] = [t for e in events for t in e["token_ids"]]
                    lps[i] = [x for e in events for x in e.get("logprobs", [])]
                    tops[i] = [row for e in events for row in e.get("top_logprobs", [])]
            else:
                choice = json.loads(data)["choices"][0]
                outs[i] = choice["token_ids"]
                if "logprobs" in choice:
                    lps[i] = choice["logprobs"]["token_logprobs"]
                    tops[i] = [(list(map(vocab.__getitem__, row)), list(row.values()))
                               for row in choice["logprobs"]["top_logprobs"]]
        return outs, lps, tops, ttfe

    outs, lps, tops, ttfe = parse(replies)
    warm_outs, _, _, warm_ttfe = parse(warm_replies)
    n_tokens = sum(len(v) for v in outs.values())
    if warm_outs != outs:
        problems.append("the second round (every request greedy or seeded) returned other tokens")
    from modegpt_tpu_torch.server import _chat_prompt_ids

    chat_prompt = list(_chat_prompt_ids(tok, messages))
    prompt_of = {k: (chat_prompt if isinstance(k, tuple) else prompts[k]) for k in outs}

    k1_before, k1_expected = fa_mod.flash_attention.launches, 0
    greedy_gap, lp_err, top_err, kept_ok, checked = 0.0, 0.0, 0.0, True, 0
    for key, out in outs.items():
        i = key[0] if isinstance(key, tuple) else key
        P = len(prompt_of[key])
        if not out:
            problems.append(f"request {key}: no tokens")
            continue
        if i >= p_end and i < p_end + 2:
            continue  # guided: checked against the grammar below
        seq = prompt_of[key] + out
        k1_expected += cspec.n_layers * (len(seq) >= FLASH_MIN_T)
        rows = _served_rows(cspec, cparams, seq, P, len(out))
        served = torch.tensor(out, device="cuda")
        checked += len(out)
        if g_end <= i < s_end:  # sampled: each token in the kept set of its row
            knobs = np.asarray([[cfg["sampling"]["temperature"], cfg["sampling"]["top_k"], cfg["sampling"]["top_p"],
                                 cfg["sampling"]["min_p"], 1.0]] * len(out), np.float32)
            scaled = rows / cfg["sampling"]["temperature"]
            final = filter_rows(scaled, knobs)
            thr = final.masked_fill(~torch.isfinite(final), float("inf")).amin(dim=-1)
            kept_ok &= bool((scaled.gather(1, served[:, None])[:, 0] >= thr - 1e-3).all())
            continue
        if s_end <= i < p_end:  # penalised: the penalties over prompt + generated so far
            pres = torch.zeros((V,), dtype=torch.bool, device="cuda")
            pres[torch.tensor(prompt_of[key], device="cuda")] = True
            cnt = torch.zeros((V,), dtype=torch.float32, device="cuda")
            pen = cfg["penalties"]
            for j in range(len(out)):
                r = rows[j]
                r = torch.where(pres, torch.where(r > 0, r / pen["repetition_penalty"],
                                                  r * pen["repetition_penalty"]), r)
                rows[j] = r - pen["presence_penalty"] * (cnt > 0) - pen["frequency_penalty"] * cnt
                pres[out[j]] = True
                cnt[out[j]] += 1
        if i == p_end + 2:  # logit_bias, and EOS held off for min_tokens
            bias = torch.zeros((V,), device="cuda")
            for t, v in cfg["logit_bias"].items():
                bias[int(t)] = v
            rows = rows + bias
            rows[: cfg["min_tokens"], eos] = float("-inf")
            if len(out) != cfg["min_tokens"] + 1 or out[-1] != eos:
                problems.append(f"logit_bias/min_tokens: {len(out)} tokens, last {out[-1]}")
        gap = rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0]
        greedy_gap = max(greedy_gap, float(gap.max()))
        if i in lps:
            logp = torch.log_softmax(rows, dim=-1)
            lp_err = max(lp_err, float((logp.gather(1, served[:, None])[:, 0]
                                        - torch.tensor(lps[i], device="cuda")).abs().max()))
            ids = torch.tensor([row[0] for row in tops[i]], device="cuda")
            vals = torch.tensor([row[1] for row in tops[i]], device="cuda")
            top_err = max(top_err, float((logp.gather(1, ids) - vals).abs().max()),
                          float((logp.topk(cfg["top_logprobs"], dim=-1).values - vals).abs().max()))
        del rows
    k1 = fa_mod.flash_attention.launches - k1_before
    records["flash_attention"]["launches_by_phase"]["server"] = k1
    if k1 != k1_expected:
        problems.append(f"K1 launched {k1} times in the teacher-forcing forwards, expected {k1_expected}")
    guided_out = {}
    for name, i in (("choice", p_end), ("json", p_end + 1)):
        out = outs.get(i, [])
        text = b"".join(token_bytes[t] for t in out[:-1]).decode(errors="replace")
        ok = bool(out) and out[-1] == eos
        if name == "choice":
            ok = ok and text in cfg["choices"]
        else:
            try:
                obj = json.loads(text)
                ok = ok and set(obj) == {"ok", "tag"} and isinstance(obj["ok"], bool) and obj["tag"] in ("a", "b")
            except ValueError:
                ok = False
        guided_out[name] = {"text": text, "tokens": len(out), "ok": ok}
        if not ok:
            problems.append(f"guided {name}: {text!r} ({len(out)} tokens) is not in the grammar")
    seeded_same = all(repeats[i][0] == 200 and json.loads(repeats[i][1])["choices"][0]["token_ids"] == outs.get(i)
                      for i in range(g_end, s_end))
    lengths_ok = all(len(outs.get(i, [])) == new for i in list(range(g_end)) + list(range(g_end, p_end))) and all(
        len(outs.get((p_end + 3, c), [])) == new for c in (0, 1))
    if not lengths_ok:
        problems.append(f"a request did not return {new} tokens")
    if greedy_gap > 1e-3:
        problems.append(f"a greedy or penalised token is {greedy_gap} below its row's max")
    if lp_err > cfg["lp_tol"] or top_err > cfg["lp_tol"]:
        problems.append(f"logprobs differ from the forward's by {lp_err}, top-5 by {top_err}")
    if not kept_ok:
        problems.append("a sampled token lies outside the kept set of its row")
    if not seeded_same:
        problems.append("a seeded request sent again alone returned other tokens")
    if outs.get((p_end + 3, 0)) != outs.get((p_end + 3, 1)):
        problems.append("the chat completion's n=2 greedy choices differ")
    if cancel["status"] != 200 or not cancel["reply"].get("cancelled") or not cancel["slot_freed"] \
            or not cancel["stream_done"]:
        problems.append(f"cancel: {cancel}")
    if over[0] != 429:
        problems.append(f"the request over max_queue=0 got HTTP {over[0]}, not 429")
    round_requests = 2 * (len(bodies) + 1) + cfg["sampled"] + cfg["gate_requests"]  # chat counts n=2
    if float(metrics.get("modegpt_requests_completed_total", -1)) < round_requests:
        problems.append(f"/metrics counts {metrics.get('modegpt_requests_completed_total')} completed requests")
    if float(metrics.get("modegpt_generated_tokens_total", -1)) < 2 * n_tokens:
        problems.append(f"/metrics counts {metrics.get('modegpt_generated_tokens_total')} tokens, < {2 * n_tokens}")

    step_costs = _sampling_costs(batcher, prompts, eos)
    line = {
        "phase": "server", "card": card_line(), "slots": SERVE["slots"], "max_len": SERVE["max_len"],
        "prefill_bucket": SERVE["prefill_bucket"], "decode_attn": batcher.decode_attn,
        "clients": len(bodies), "sequences": len(outs), "prompt_lengths": lens.tolist(), "max_new_tokens": new,
        "round_wall_seconds": wall, "http_generated_tokens_per_s": n_tokens / wall, "generated_tokens": n_tokens,
        "mean_time_to_first_sse_event_s": sum(ttfe) / max(len(ttfe), 1), "time_to_first_sse_event_s": ttfe,
        "cold_round_dispatches": {k: {"count": c, "mean_ms": 1e3 * t / max(c, 1)} for k, (c, t) in cold.items()},
        "warm_round": {"wall_seconds": warm_wall, "http_generated_tokens_per_s": n_tokens / warm_wall,
                       "mean_time_to_first_sse_event_s": sum(warm_ttfe) / max(len(warm_ttfe), 1),
                       "dispatches": {k: {"count": c, "mean_ms": 1e3 * t / max(c, 1)} for k, (c, t) in warm.items()}},
        "dispatches": {k: counts[k] for k in seconds if counts[k]},
        "mean_dispatch_ms": {k: 1e3 * seconds[k] / counts[k] for k in seconds if counts[k]},
        "launches": {"ragged_gqa_attend": launches, "flash_attention": k1},
        "expected_launches": {"ragged_gqa_attend": counts["layer_dispatches"], "flash_attention": k1_expected},
        "checked_tokens": checked, "max_gap_to_row_max": greedy_gap, "logprob_max_abs_err": lp_err,
        "top_logprob_max_abs_err": top_err, "sampled_in_kept_set": kept_ok, "seeded_repeat_same": seeded_same,
        "guided": guided_out, "cancel": cancel, "over_max_queue_status": over[0], "health": health,
        "metrics": {k: float(v) for k, v in metrics.items()}, "guide_rows_v128256": guide_rows,
        "host_setup": timings, "step_costs": step_costs,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


def _sampling_costs(batcher, prompts, eos) -> dict:
    """Decode-step ms with 8 decode-active slots, the knob table all
    greedy, with the filter path on (every row sampled with top-k, top-p,
    min-p and a seed) and greedy with top_logprobs, in turns; and the
    token choice alone (`serving._pick`) on one step's [8, V] logits for
    each. K3 launches made here are measurements, taken back off its
    counter."""
    import numpy as np
    import torch

    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving
    from modegpt_tpu_torch.models.generate import _inverse_cdf, filter_rows, penalize_rows, uniform_rows
    from modegpt_tpu_torch.models.padded import _model_step_padded, upload

    saved = rd_mod.ragged_gqa_attend.launches
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i in range(batcher.slots):
        batcher.submit(prompts[i][:256], max_new_tokens=400, temperature=0.0)
    while len(batcher._decode_rows()) < batcher.slots:
        batcher.step(gen)
    state, pm, dev = batcher.state, batcher.pm, batcher.device
    active = np.ones((batcher.slots,), bool)
    off = np.tile(batcher._samp_off, (batcher.slots, 1))
    hot = off.copy()
    hot[:, :4] = [SERVER["sampling"][k] for k in ("temperature", "top_k", "top_p", "min_p")]
    seeds = torch.arange(batcher.slots, device=dev, dtype=torch.int64) + 7
    variants = {
        "all_greedy": serving.Sampling(samp=off, samp_dev=upload(off, dev), presence=batcher.presence,
                                       gen_counts=batcher.gen_counts),
        "filters_seeded": serving.Sampling(samp=hot, samp_dev=upload(hot, dev), presence=batcher.presence,
                                           gen_counts=batcher.gen_counts, seeds=seeds,
                                           counts=np.zeros((batcher.slots,), np.int64)),
        "top_logprobs": serving.Sampling(samp=off, samp_dev=upload(off, dev), presence=batcher.presence,
                                         gen_counts=batcher.gen_counts, want_lp=True, top_lp=True),
    }
    step_ms = {k: [] for k in variants}
    for _ in range(SERVER["timing_turns"]):
        for name, smp in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serving._one_decode_step(pm, state, active, 0.0, None, gen, decode_attn="ragged", sampling=smp)
            if smp.lp is not None:
                smp.lp.cpu()
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        logits = _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, state.last_token[:, None],
                                    state.cache_k, state.cache_v, state.lengths, cache_scales=state.scales,
                                    decode_attn="ragged")[0][:, -1, :]
    pick_ms = {}
    zeros = torch.zeros((batcher.slots,), dtype=torch.int64, device=dev)
    for name, smp in variants.items():
        pick_ms[name] = cuda_ms(lambda smp=smp: serving._pick(smp, logits, gen, counts=zeros), iters=20)
    # the filter path's parts, on the same logits
    hot_dev = variants["filters_seeded"].samp_dev
    parts_ms = {
        "penalize_rows": cuda_ms(lambda: penalize_rows(logits, hot, batcher.presence, batcher.gen_counts,
                                                       hot_dev), iters=20),
        "filter_rows": cuda_ms(lambda: filter_rows(logits / 0.8, hot, hot_dev), iters=20),
        "sort_only": cuda_ms(lambda: torch.sort(logits, dim=-1, descending=True), iters=20),
        "inverse_cdf_draw": cuda_ms(lambda: _inverse_cdf(logits, uniform_rows(seeds, zeros)), iters=20),
        "argmax": cuda_ms(lambda: torch.argmax(logits, dim=-1), iters=20),
        "log_softmax_topk": cuda_ms(lambda: torch.topk(torch.log_softmax(logits, dim=-1), 20, dim=-1), iters=20),
    }
    for s in range(batcher.slots):
        batcher.cancel(batcher.slot_req[s])
    rd_mod.ragged_gqa_attend.launches = saved
    return {"decode_step_ms_median": {k: float(np.median(v)) for k, v in step_ms.items()},
            "decode_step_ms": step_ms, "pick_ms": pick_ms, "filter_path_parts_ms": parts_ms, "rows": batcher.slots,
            "vocab": int(logits.shape[-1])}


def _start_server_cli(artifact_dir: str, workdir: str) -> dict:
    """`python -m modegpt_tpu_torch.server --model <artifact>` on the card,
    started as a subprocess on a free port (its log in `workdir`)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    log = os.path.join(workdir, "server_cli.log")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "modegpt_tpu_torch.server", "--model", artifact_dir,
                                 "--port", str(port), "--slots", "2", "--max_len", "1024"],
                                cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=f)
    return {"proc": proc, "port": port, "log": log, "t0": time.perf_counter()}


def _server_cli(started: dict, prompt, cspec, cparams) -> dict:
    """The server CLI `_start_server_cli` started: /health and one greedy
    completion, its tokens within 1e-3 of their row's max in the unrolled
    forward; then SIGINT, and kill if it does not stop."""
    import signal

    import torch

    proc, port, t0 = started["proc"], started["port"], started["t0"]
    out = {"port": port}
    try:
        while True:
            if proc.poll() is not None:
                out["error"] = open(started["log"]).read()[-1500:]
                return out
            if time.perf_counter() - t0 > SERVER["cli_timeout"]:
                out["error"] = "no /health answer"
                return out
            try:
                status, data, _ = _http(port, "GET", "/health", timeout=10)
                break
            except OSError:
                time.sleep(0.5)
        out["health"], out["ready_seconds"] = json.loads(data), time.perf_counter() - t0
        t1 = time.perf_counter()
        status, data, _ = _http(port, "POST", "/v1/completions", {"prompt_ids": prompt, "max_tokens": 8})
        out["completion_status"], out["completion_seconds"] = status, time.perf_counter() - t1
        if status == 200:
            toks = json.loads(data)["choices"][0]["token_ids"]
            rows = _served_rows(cspec, cparams, list(prompt) + toks, len(prompt), len(toks))
            served = torch.tensor(toks, device="cuda")
            out["tokens"] = len(toks)
            out["max_gap_to_row_max"] = float((rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0]).max())
            out["ok"] = status == 200 and out["health"].get("status") == "ok" and len(toks) == 8 \
                and out["max_gap_to_row_max"] <= 1e-3
        return out
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


DEQUANT_RANGE = "dequantised weight copy (forward._dequant)"
INT_MM_RANGE = "int8 GEMM (forward._int_mm, torch._int_mm)"


def _tree_bytes(tree) -> int:
    """Device bytes of a parameter tree's tensors."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if tree is not None else 0


def _leaves_named(tree, name: str):
    """Every leaf called `name` in a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == name and not isinstance(v, (dict, list)):
                yield v
            else:
                yield from _leaves_named(v, name)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_named(v, name)


ORBAX = dict(requests=8, new_tokens=16)
ORBAX_FIXTURE = os.path.join("tests", "fixtures", "torch_orbax_llama")


def _same_leaves(a, b, where: str, problems: list) -> int:
    """Walk two parameter trees; a problem for each leaf that is not
    equal bit for bit (same dtype, same values). Returns the leaves."""
    import torch

    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or sorted(a) != sorted(b):
            problems.append(f"{where}: the trees differ in their keys")
            return 0
        return sum(_same_leaves(a[k], b[k], f"{where}/{k}", problems) for k in a)
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            problems.append(f"{where}: the trees differ in their layers")
            return 0
        return sum(_same_leaves(x, y, f"{where}/{i}", problems) for i, (x, y) in enumerate(zip(a, b)))
    if a is None or b is None:
        if (a is None) != (b is None):
            problems.append(f"{where}: a leaf is missing on one side")
        return 0
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b.to(a.device)):
        problems.append(f"{where}: not equal bit for bit")
    return 1


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _quant_orbax(main_out: dict, problems: list):
    """(a)-(d) of the quant phase: the main model's orbax artifacts.
    (a) saved in float32 and bfloat16 and reloaded on the card, every
    leaf against the npz reload (float32: the main job's own; bfloat16:
    an npz artifact saved and reloaded here), seconds and bytes of each;
    (b) the committed JAX-written fixture (zstd chunks) against its npz
    twin; (c) `evals.cli.main --dataset synthetic` on the float32 orbax
    artifact: the main job's perplexity, K1 counted; (d) one `serve.main`
    round from it: the npz model's tokens, K3 counted. Returns (line, K1
    launches, K3 launches)."""
    import torch

    from modegpt_tpu_torch import serve as serve_mod
    from modegpt_tpu_torch.compress.artifact import load_compressed_model, save_compressed_model
    from modegpt_tpu_torch.evals import cli as eval_cli
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod

    cspec, cparams, pm, job = main_out["spec"], main_out["params"], main_out["pm"], main_out["job"]
    line = {"npz_float32": {"bytes": job["artifact_bytes"], "save_seconds": job["save_seconds"],
                            "reload_seconds": job["reload_seconds"], "source": "the main job's steps"}}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_orbax_") as tmp:
        # (a) save and reload through the port, beside npz
        for dtype, backends in (("float32", ("orbax",)), ("bfloat16", ("npz", "orbax"))):
            reloads = {}
            for backend in backends:
                path = os.path.join(tmp, f"{backend}_{dtype}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_compressed_model(path, cspec, cparams, dtype=dtype, backend=backend)
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                _, reloads[backend], _ = load_compressed_model(path, device="cuda")
                torch.cuda.synchronize()
                reload_s = time.perf_counter() - t0
                line[f"{backend}_{dtype}"] = dict(bytes=_dir_bytes(path), save_seconds=save_s,
                                                  reload_seconds=reload_s)
            want = cparams if dtype == "float32" else reloads["npz"]
            line[f"orbax_{dtype}"]["leaves_equal_npz"] = _same_leaves(
                reloads["orbax"], want, f"orbax {dtype}", problems)
            if dtype == "bfloat16":
                shutil.rmtree(os.path.join(tmp, f"npz_{dtype}"))
                shutil.rmtree(os.path.join(tmp, f"orbax_{dtype}"))
            del reloads, want
            torch.cuda.empty_cache()

        # (b) the JAX-written fixture, zstd inside, decoded on this host
        fixture = {}
        for variant, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            t0 = time.perf_counter()
            spec_f, got, _ = load_compressed_model(os.path.join(root, ORBAX_FIXTURE, variant), device="cuda")
            seconds = time.perf_counter() - t0
            twin_spec, twin, _ = load_compressed_model(os.path.join(root, ORBAX_FIXTURE, "npz"), device="cuda")
            twin = _cast_tree(twin, dt)
            if spec_f != twin_spec:
                problems.append(f"fixture {variant}: spec differs from its npz twin's")
            fixture[variant] = dict(seconds=seconds, leaves_equal_npz=_same_leaves(
                got, twin, f"fixture {variant}", problems))
        line["jax_fixture"] = fixture

        # (c) the eval CLI on the float32 orbax artifact; first, timed
        # apart, the tokenizer lookup it makes (none is saved there: the
        # lookup fails, after transformers' first import in this process)
        art = os.path.join(tmp, "orbax_float32")
        t0 = time.perf_counter()
        eval_cli._load_tokenizer(art, "")
        lookup_s = time.perf_counter() - t0
        fa_mod.flash_attention.launches = 0
        t0 = time.perf_counter()
        out = eval_cli.main(["--model", art, "--dataset", "synthetic", "--seq_len", str(job["seq_len"]),
                             "--eval_max_samples", str(job["eval_max_samples"]),
                             "--eval_batch_size", str(job["eval_batch_size"]), "--device", "cuda"])
        k1 = fa_mod.flash_attention.launches
        ppl = out["ppl-synthetic"]
        line["eval_cli"] = dict(seconds=time.perf_counter() - t0, tokenizer_lookup_seconds=lookup_s,
                                ppl=ppl, npz_ppl=job["compressed_ppl"],
                                k1_launches=k1, k1_expected=job["k1_per_eval"])
        if not math.isclose(ppl, job["compressed_ppl"], rel_tol=1e-6):
            problems.append(f"eval CLI on the orbax artifact: perplexity {ppl}, the npz job's "
                            f"{job['compressed_ppl']}")
        if k1 != job["k1_per_eval"]:
            problems.append(f"eval CLI on the orbax artifact launched K1 {k1} times, expected {job['k1_per_eval']}")

        # (d) one serve.main round from it, against the npz model's batcher
        npz_art = main_out["artifact_dir"]
        if npz_art and os.path.exists(os.path.join(npz_art, "tokenizer.json")):
            tok = eval_cli._load_tokenizer(npz_art, "")
        else:
            tok = _full_vocab_tokenizer(cspec.vocab_size)
        tok.save_pretrained(art)
        id_prompts = [list(map(int, p)) for p in _serve_prompts(cspec.vocab_size, ORBAX["requests"])[0]]
        prompts_file = os.path.join(tmp, "prompts.txt")
        with open(prompts_file, "w") as f:
            f.write("\n".join(tok.decode(p) for p in id_prompts) + "\n")
        new = ORBAX["new_tokens"]
        want = _reference_round(_serve_batcher(pm, [], tok.eos_token_id), id_prompts, new)
        rd_mod.ragged_gqa_attend.launches = 0
        with _counted_dispatches() as (counts, _):
            done, _, err, wall = _in_process(serve_mod.main, ["--model", art, "--prompts", prompts_file,
                                                              "--max_new_tokens", str(new), "--device", "cuda"])
        k3 = rd_mod.ragged_gqa_attend.launches
        served = [list(map(int, done[r])) for r in sorted(done)]
        line["serve"] = dict(seconds=wall, requests=len(id_prompts), new_tokens=new,
                             tokens_equal_npz=served == want, k3_launches=k3,
                             k3_expected=counts["layer_dispatches"], tok_per_s=_summary(err)["tok_per_s"])
        if served != want:
            problems.append("serve.main from the orbax artifact: tokens differ from the npz model's")
        if k3 != counts["layer_dispatches"] or k3 == 0:
            problems.append(f"serve.main from the orbax artifact launched K3 {k3} times, expected "
                            f"{counts['layer_dispatches']}")
    return line, k1, k3


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree is not None and tree.is_floating_point() else tree


def phase_quant(records: dict, main_out: dict, profile: bool = False) -> dict:
    """Quantised artifacts and int8 serving of the main phase's compressed
    model: int8, int4 and nf4 artifacts saved, reloaded dequantised and
    evaluated (K1); int8 and int4 resident forwards (K1) against the
    dequantised ones; then the serve phase's 16 requests three times,
    f32, int8 weight-only and int8 with W8A8 prefill (K3); then the
    orbax artifacts (`_quant_orbax`, (a)-(d)). With `profile`, the two
    int8 rounds run under torch.profiler with the dequantised copies and
    the int8 GEMMs as ranges."""
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.compress.artifact import load_compressed_model, save_compressed_model
    from modegpt_tpu_torch.evals.perplexity import compute_perplexity
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.quantize import quantize_padded, quantize_params, with_act_quant

    cspec, cparams, pm, job = main_out["spec"], main_out["params"], main_out["pm"], main_out["job"]
    eval_tokens = load_eval_tokens(None, "synthetic", job["seq_len"], job["eval_max_samples"],
                                   vocab_size=cspec.vocab_size)
    problems, k1_total = [], 0

    # ---- artifacts: save, reload dequantised, evaluate through K1 ----
    artifacts, resident = {}, {}
    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_quant_") as tmp:
        dequantised = {}
        for dtype in ("int8", "int4", "nf4"):
            path = os.path.join(tmp, dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_compressed_model(path, cspec, cparams, dtype=dtype)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, params, _ = load_compressed_model(path, device="cuda")
            torch.cuda.synchronize()
            reload_s = time.perf_counter() - t0
            fa_mod.flash_attention.launches = 0
            ppl = compute_perplexity(cspec, params, eval_tokens, job["eval_batch_size"], progress=False,
                                     exec_mode=job["compressed_exec"])
            k1 = fa_mod.flash_attention.launches
            k1_total += k1
            artifacts[dtype] = dict(bytes=os.path.getsize(os.path.join(path, "params.npz")), save_seconds=save_s,
                                    reload_seconds=reload_s, compressed_ppl=ppl, k1_launches=k1)
            if k1 != job["k1_per_eval"]:
                problems.append(f"{dtype} eval launched K1 {k1} times, expected {job['k1_per_eval']}")
            if not math.isfinite(ppl):
                problems.append(f"{dtype} perplexity is not finite")
            if dtype == "nf4":
                del params
            else:
                dequantised[dtype] = params
        rel = abs(artifacts["int8"]["compressed_ppl"] / job["compressed_ppl"] - 1.0)
        if rel > 0.01:
            problems.append(f"int8 perplexity {artifacts['int8']['compressed_ppl']} is {rel:.4f} "
                            f"from the float32 artifact's {job['compressed_ppl']}")

        # ---- resident int8 / int4: one B=2, T=2048 forward through K1 ----
        ids = torch.as_tensor(eval_tokens[:2], device="cuda")
        for dtype, want in (("int8", torch.int8), ("int4", torch.uint8)):
            _, rp, _ = load_compressed_model(os.path.join(tmp, dtype), device="cuda", resident_int8=True)
            codes = list(_leaves_named(rp, "kernel_q"))
            fa_mod.flash_attention.launches = 0
            with torch.no_grad():
                lr, _ = forward(cspec, rp, ids, attn_impl="flash")
                k1_total += fa_mod.flash_attention.launches
                ld, _ = forward(cspec, dequantised[dtype], ids, attn_impl="flash")
            err = float((lr - ld).abs().max())
            resident[dtype] = dict(
                device_bytes=_tree_bytes(rp), dequantised_device_bytes=_tree_bytes(dequantised[dtype]),
                kernel_q_leaves=len(codes), logits_max_abs_err=err,
            )
            if not codes or any(c.dtype != want for c in codes) or any(True for _ in _leaves_named(rp, "kernel")):
                problems.append(f"{dtype} resident tree: kernels not all {want} kernel_q")
            if not torch.allclose(lr, ld, rtol=1e-3, atol=1e-3):
                problems.append(f"{dtype} resident logits differ from the dequantised ones by {err}")
            del rp, lr, ld
        del dequantised
    torch.cuda.empty_cache()

    # ---- one decode step's dequantised copies, timed alone ----
    pmq = quantize_padded(pm)
    qleaves = list(_leaves_named(pmq.layers, "kernel_q")) + [pmq.other["lm_head"]["kernel_q"]]
    n_q = sum(q.numel() for q in qleaves)
    convert_ms = cuda_ms(lambda: [q.to(torch.float32) for q in qleaves], iters=10)

    # ---- three serve rounds of the serve phase's 16 requests ----
    n, new = SERVE["requests"], SERVE["max_new_tokens"]
    prompts, lens = _serve_prompts(cspec.vocab_size, n)
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_bucket=SERVE["prefill_bucket"],
              temperature=0.0, decode_attn="auto")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rounds, checks, k3_total = {}, {}, 0
    for name, model, extra, ranges in (("float32", pm, {}, ()),
                                       ("int8", pmq, {}, (("_dequant", DEQUANT_RANGE),)),
                                       ("int8_a8_prefill", pmq, {"a8_prefill": True}, (("_int_mm", INT_MM_RANGE),))):
        b = serving.ContinuousBatcher(model, **kw, **extra)

        def on_step(step, b=b, name=name):
            """Once slots decode in the int8 round: K3 against its plain
            version on one decode step's logits."""
            if name != "int8" or name in checks or not any(_decoding(b)):
                return
            lk, lp = (_decode_logits(pmq, b.state, attn) for attn in ("ragged", "xla"))
            checks[name] = dict(step=step, err=float((lk - lp).abs().max()),
                                ok=bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3)))

        traced = profile and bool(ranges)
        torch.cuda.reset_peak_memory_stats()
        rd_mod.ragged_gqa_attend.launches = 0
        with contextlib.ExitStack() as stack:
            counts, seconds = stack.enter_context(_counted_dispatches())
            prof = stack.enter_context(_profiler()) if traced else None
            for fn, range_name in ranges if traced else ():
                stack.enter_context(_annotated(fn, range_name))
            done, rids, wall = _serve_round(b, prompts, gen, on_step=on_step)
        launches = rd_mod.ragged_gqa_attend.launches
        k3_total += launches
        if traced:
            emit(_profile_line(prof, wall, f"quant {name} round", ranges=tuple(r for _, r in ranges)))
        dispatches = counts["prefill"] + counts["decode"]
        rounds[name] = dict(
            done=done, rids=rids, wall_seconds=wall, generated_tokens_per_s=n * new / wall,
            dispatches=dict(counts),
            mean_prefill_dispatch_ms=1e3 * seconds["prefill"] / max(counts["prefill"], 1),
            mean_decode_dispatch_ms=1e3 * seconds["decode"] / max(counts["decode"], 1),
            k3_launches=launches, k3_expected=cspec.n_layers * dispatches,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        if launches != cspec.n_layers * dispatches:
            problems.append(f"ragged_gqa_attend launched {launches} times in the {name} round, "
                            f"expected {cspec.n_layers * dispatches}")
        if not all(len(done.get(r, [])) == len(p) + new for r, p in zip(rids, prompts)):
            problems.append(f"a request of the {name} round did not return prompt + {new} tokens")

    # teacher forcing of the int8 round against the unrolled int8 forward
    qparams = quantize_params(cparams)
    wo = rounds["int8"]
    exact, max_gap = _teacher_forcing(cspec, qparams, wo["done"], wo["rids"], prompts, new)
    if max_gap > 1e-3:
        problems.append(f"an int8-served token is {max_gap} below its row's max logit ({exact} of {n * new} exact)")
    if not checks.get("int8", {}).get("ok"):
        problems.append(f"int8 round: decode logits K3 vs plain: {checks.get('int8')}")
    # W8A8 prefill: each first token against the unrolled W8A8 forward
    # (K1) at the last prompt position. An activation code on a rounding
    # boundary flips with float noise, so the bound is 1e-2 or twice the
    # noise floor (the same forward through K1 against the plain
    # attention), whichever is larger: rows that differ by at most eps
    # put each other's argmax within 2 eps of the row max.
    a8, a8_params = rounds["int8_a8_prefill"], with_act_quant(qparams)
    first = dict(max_gap=0.0, noise_floor=0.0, max_rank=0, row_std=0.0)
    for rid, prompt in zip(a8["rids"], prompts):
        ids = torch.as_tensor(prompt[None], device="cuda")
        with torch.no_grad():
            rk = forward(cspec, a8_params, ids, attn_impl="flash")[0][0, -1]
            rp = forward(cspec, a8_params, ids, attn_impl="xla")[0][0, -1]
        served = rk[a8["done"][rid][len(prompt)]]
        first["max_gap"] = max(first["max_gap"], float(rk.max() - served))
        first["noise_floor"] = max(first["noise_floor"], float((rk - rp).abs().max()))
        first["max_rank"] = max(first["max_rank"], int((rk > served).sum()))
        first["row_std"] = max(first["row_std"], float(rk.std()))
    if first["max_gap"] > max(1e-2, 2 * first["noise_floor"]):
        problems.append(f"a W8A8-prefilled first token is below the W8A8 forward's row max: {first}")
    same_new = sum(int(x == y) for r_a, r_w, p in zip(a8["rids"], wo["rids"], prompts)
                   for x, y in zip(a8["done"][r_a][len(p):], wo["done"][r_w][len(p):]))

    torch.cuda.empty_cache()
    orbax, k1, k3 = _quant_orbax(main_out, problems)
    k1_total += k1
    k3_total += k3
    records["flash_attention"]["launches_by_phase"]["quant"] = k1_total
    records["ragged_gqa_attend"]["launches_by_phase"]["quant"] = k3_total
    line = {
        "phase": "quant", "model": "Meta-Llama-3-8B widths", "n_layers": cspec.n_layers,
        "float32_artifact": {"bytes": job["artifact_bytes"], "save_seconds": job["save_seconds"],
                             "reload_seconds": job["reload_seconds"], "compressed_ppl": job["compressed_ppl"]},
        "artifacts": artifacts, "orbax": orbax,
        "resident": resident, "float32_device_bytes": _tree_bytes(cparams),
        "decode_step_dequant_copy": {"ms": convert_ms, "int8_weights": n_q,
                                     "bound_ms": 1e3 * 5 * n_q / HBM_BYTES_PER_S, "bound_by": "bytes"},
        "serve": {
            "requests": n, "max_new_tokens": new, "prompt_lengths": lens.tolist(),
            **{name: {k: v for k, v in rd.items() if k not in ("done", "rids")} for name, rd in rounds.items()},
            "int8_decode_check": checks.get("int8"),
            "int8_teacher_forcing": {"exact_argmax": exact, "of": n * new, "max_gap_to_row_max": max_gap},
            "a8_prefill_first_token": first,
            "a8_prefill_tokens_equal_weight_only": {"equal": same_new, "of": n * new},
        },
        "launches": {"flash_attention": k1_total, "ragged_gqa_attend": k3_total},
    }
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


def phase_long(records: dict, profile: bool = False) -> dict:
    """A compression job and the eval CLI at 16384 tokens (Llama-3.1-8B
    widths, 2 layers): every forward takes K2, none K1."""
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.evals.cli import main as eval_main
    from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.models.forward import FLASH_MAX_T, forward
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import forward_padded, pad_to_uniform, padding_overhead
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    def zero_counts():
        fa_mod.flash_attention.launches = fa_mod.flash_attention_hbm.launches = 0

    def counts():
        return {"flash_attention": fa_mod.flash_attention.launches,
                "flash_attention_hbm": fa_mod.flash_attention_hbm.launches}

    spec = spec_from_hf_config(SimpleNamespace(**{**LLAMA31_8B, "num_hidden_layers": LONG_LAYERS}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_long_") as tmp:
        config = CompressionConfig(
            model="random-llama3.1-8b-widths", device="cuda", **LONG,
            compression_ratio=0.3, dataset="synthetic", solver_precision="f32_device",
            output_dir=os.path.join(tmp, "out"),
            temp_storage_dir=os.path.join(tmp, "layers"),
            metrics_dir=os.path.join(tmp, "metrics"),
        ).validate()
        prof = _profiler() if profile else contextlib.nullcontext()
        t_run = time.perf_counter()
        zero_counts()
        with prof:
            results = run_compression(config, spec=spec, params=params)
        job_launches = counts()
        t_run = time.perf_counter() - t_run
        del params, results["compressed_params"]
        if profile:
            emit(_profile_line(prof, t_run, "long"))
        n_eval = min(config.eval_max_samples, 16)  # the synthetic eval set
        n_batches = 2 * math.ceil(n_eval / config.eval_batch_size) + math.ceil(
            config.calib_size / config.calibs_batch_size
        )
        expected_job = {"flash_attention": 0, "flash_attention_hbm": LONG_LAYERS * n_batches}
        cspec = results["compressed_spec"]

        # logits of the positions only the long route reaches, on the first
        # eval window: K2 against the row-chunked plain attention, and the
        # padded stack against the unrolled forward (each tensor freed
        # before the next: one window's f32 logits are 8.4 GB)
        spec2, params2, _ = load_compressed_model(results["artifact_dir"], device="cuda")
        window = load_eval_tokens(None, "synthetic", config.seq_len, 1, vocab_size=spec.vocab_size)
        ids = torch.as_tensor(window, device="cuda")

        def tail(logits):
            return logits[:, FLASH_MAX_T:].clone()

        with torch.no_grad():
            lk = tail(forward(spec2, params2, ids, attn_impl="flash")[0])
            lp = tail(forward(spec2, params2, ids, attn_impl="xla")[0])
            plain_err = float((lk - lp).abs().max())
            plain_ok = bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3))
            del lp
            pm = pad_to_uniform(spec2, params2)
            del params2
            lpad = tail(forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, ids, attn_impl="flash"))
            del pm
            padded_err = float((lpad - lk).abs().max())
            padded_ok = bool(torch.allclose(lpad, lk, rtol=1e-3, atol=1e-3))
            del lk, lpad
        torch.cuda.empty_cache()

        # the standalone eval CLI on the artifact, at the same length
        t_cli = time.perf_counter()
        zero_counts()
        cli = eval_main([
            "--model", results["artifact_dir"], "--dataset", "synthetic",
            "--seq_len", str(config.seq_len), "--eval_max_samples", str(config.eval_max_samples),
            "--eval_batch_size", str(config.eval_batch_size), "--device", "cuda",
        ])
        cli_launches = counts()
        t_cli = time.perf_counter() - t_cli
    expected_cli = {"flash_attention": 0, "flash_attention_hbm": LONG_LAYERS * n_eval}
    cli_ppl = cli["ppl-synthetic"]

    records["flash_attention_hbm"]["launches_by_phase"]["long"] = job_launches["flash_attention_hbm"]
    line = {
        "phase": "long", "model": "Meta-Llama-3.1-8B widths", "n_layers": LONG_LAYERS, **LONG,
        "compressed_eval_path": resolve_exec_mode(cspec, config.compressed_exec),
        "padding_overhead": padding_overhead(cspec),
        "init_seconds": init_s,
        "step_seconds": results["step_seconds"],
        "total_seconds": results["total_seconds"],
        "cli_seconds": t_cli,
        "baseline_ppl": results["baseline_ppl"], "compressed_ppl": results["compressed_ppl"],
        "cli_ppl": cli_ppl,
        "params_before": results["params_before"], "params_after": results["params_after"],
        "ranks": {
            "q": list(cspec.q_ranks), "k": list(cspec.k_ranks), "v": list(cspec.v_ranks),
            "o": list(cspec.o_ranks), "gate": list(cspec.gate_ranks),
        },
        "launches": {"job": job_launches, "cli": cli_launches},
        "expected_launches": {"job": expected_job, "cli": expected_cli},
        "k2_vs_plain_logits_max_abs_err": plain_err,
        "padded_vs_unrolled_logits_max_abs_err": padded_err,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(line)
    problems = []
    if job_launches != expected_job:
        problems.append(f"the job launched {job_launches}, expected {expected_job}")
    if cli_launches != expected_cli:
        problems.append(f"the eval CLI launched {cli_launches}, expected {expected_cli}")
    for key in ("baseline_ppl", "compressed_ppl"):
        if not math.isfinite(results[key]):
            problems.append(f"{key} is not finite")
    if not (0 < sum(cspec.gate_ranks) < sum(spec.gate_ranks) and 0 < sum(cspec.q_ranks) < sum(spec.q_ranks)):
        problems.append("rank lists did not shrink")
    if not plain_ok:
        problems.append(f"long-context logits: K2 vs the plain attention differ by {plain_err}")
    if not padded_ok:
        problems.append(f"long-context logits: forward_padded vs unrolled forward differ by {padded_err}")
    if not abs(cli_ppl - results["compressed_ppl"]) <= 1e-5 * abs(results["compressed_ppl"]):
        problems.append(f"eval CLI perplexity {cli_ppl} != the job's {results['compressed_ppl']}")
    if problems:
        raise AssertionError("; ".join(problems))
    return line


def phase_moe(records: dict, profile: bool = False) -> dict:
    """A compression job and two serve rounds at Qwen3-30B-A3B widths
    (MOE_LAYERS): K1 in every forward of the job, K3 in every dispatch."""
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import forward_padded, pad_to_uniform, padding_overhead
    from modegpt_tpu_torch.models.quantize import quantize_padded
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(SimpleNamespace(**{**QWEN3_30B_A3B, "num_hidden_layers": MOE_LAYERS}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_moe_") as tmp:
        config = CompressionConfig(
            model="random-qwen3-30b-a3b-widths", device="cuda",
            seq_len=2048, calib_size=8, calibs_batch_size=2, eval_batch_size=2,
            eval_max_samples=4, compression_ratio=0.3, dataset="synthetic",
            solver_precision="f32_device",
            output_dir=os.path.join(tmp, "out"),
            temp_storage_dir=os.path.join(tmp, "layers"),
            metrics_dir=os.path.join(tmp, "metrics"),
        ).validate()
        prof = _profiler() if profile else contextlib.nullcontext()
        t_run = time.perf_counter()
        fa_mod.flash_attention.launches = 0
        with prof, _annotated("_moe_mlp", MOE_RANGE) if profile else contextlib.nullcontext():
            results = run_compression(config, spec=spec, params=params)
        k1_launches = fa_mod.flash_attention.launches
        t_run = time.perf_counter() - t_run
        job_peak = torch.cuda.max_memory_allocated() / 2**30
        del params, results["compressed_params"]
        if profile:
            emit(_profile_line(prof, t_run, "moe", ranges=(MOE_RANGE,)))
        n_eval = min(config.eval_max_samples, 16)  # the synthetic eval set
        k1_expected = MOE_LAYERS * (2 * math.ceil(n_eval / config.eval_batch_size)
                                    + math.ceil(config.calib_size / config.calibs_batch_size))
        cspec = results["compressed_spec"]
        spec2, params2, _ = load_compressed_model(results["artifact_dir"], device="cuda")

    # the reloaded artifact's logits through K1 against the plain
    # attention, and the padded stack against the unrolled forward
    ids = torch.as_tensor(load_eval_tokens(None, "synthetic", 512, 1, vocab_size=spec.vocab_size), device="cuda")
    pm = pad_to_uniform(spec2, params2)
    with torch.no_grad():
        lk, _ = forward(spec2, params2, ids, attn_impl="flash")
        lp, _ = forward(spec2, params2, ids, attn_impl="xla")
        lpad = forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, ids, attn_impl="flash")
    logit_err, padded_err = float((lk - lp).abs().max()), float((lpad - lk).abs().max())
    logit_ok = bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3))
    padded_ok = bool(torch.allclose(lpad, lk, rtol=1e-3, atol=1e-3))
    del lk, lp, lpad
    torch.cuda.empty_cache()

    # two serve rounds of the same requests: every expert on every token,
    # then capacity dispatch at E / k, where no assignment is dropped
    n, new = SERVE["requests"], SERVE["max_new_tokens"]
    prompts, lens = _serve_prompts(cspec.vocab_size, n)
    capacity = spec.n_experts / spec.experts_per_tok
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_bucket=SERVE["prefill_bucket"],
              temperature=0.0, decode_attn="auto")
    rounds, checks = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for moe in ("dense", "dispatch"):
        b = serving.ContinuousBatcher(pm, moe=moe, moe_capacity=capacity, **kw)

        def on_step(step, b=b, moe=moe):
            """Once slots decode: K3 against its plain version (dense round),
            dispatch against dense on the decoding rows (dispatch round)."""
            active = _decoding(b)
            if moe in checks or not any(active):
                return
            if moe == "dense":
                a, c = (_decode_logits(pm, b.state, attn) for attn in ("ragged", "xla"))
            else:
                a = _decode_logits(pm, b.state, "ragged", "dispatch", capacity, active)[active]
                c = _decode_logits(pm, b.state, "ragged", "dense", capacity, active)[active]
            checks[moe] = dict(step=step, err=float((a - c).abs().max()),
                               ok=bool(torch.allclose(a, c, rtol=1e-3, atol=1e-3)))

        torch.cuda.reset_peak_memory_stats()
        rd_mod.ragged_gqa_attend.launches = 0
        with _counted_dispatches() as (counts, seconds):
            done, rids, wall = _serve_round(b, prompts, gen, on_step=on_step)
        launches = rd_mod.ragged_gqa_attend.launches
        rounds[moe] = dict(
            done=done, rids=rids, wall_seconds=wall, generated_tokens_per_s=n * new / wall,
            dispatches=dict(counts),
            mean_prefill_dispatch_ms=1e3 * seconds["prefill"] / max(counts["prefill"], 1),
            mean_decode_dispatch_ms=1e3 * seconds["decode"] / max(counts["decode"], 1),
            k3_launches=launches, k3_expected=cspec.n_layers * (counts["prefill"] + counts["decode"]),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
    dense, disp = rounds["dense"], rounds["dispatch"]

    # int8 weights with W8A8 prefill: 4 of the requests, dense then by
    # dispatch at E / k (per-expert int8 GEMMs over each expert's slots)
    pmq, nq = quantize_padded(pm), MOE_INT8_REQUESTS
    q_rounds, q_checks = {}, {}
    for moe in ("dense", "dispatch"):
        b = serving.ContinuousBatcher(pmq, moe=moe, moe_capacity=capacity, a8_prefill=True, **kw)

        def on_step(step, b=b, moe=moe):
            """Once slots decode in the dispatch round: dispatch against
            dense on the decoding rows of one (weight-only) decode step."""
            active = _decoding(b)
            if moe != "dispatch" or moe in q_checks or not any(active):
                return
            a = _decode_logits(pmq, b.state, "ragged", "dispatch", capacity, active)[active]
            c = _decode_logits(pmq, b.state, "ragged", "dense", capacity, active)[active]
            q_checks[moe] = dict(step=step, err=float((a - c).abs().max()),
                                 ok=bool(torch.allclose(a, c, rtol=1e-3, atol=1e-3)))

        rd_mod.ragged_gqa_attend.launches = 0
        with _counted_dispatches() as (counts, seconds):
            done, rids, wall = _serve_round(b, prompts[:nq], gen, on_step=on_step)
        q_rounds[moe] = dict(
            done=done, rids=rids, wall_seconds=wall, generated_tokens_per_s=nq * new / wall,
            dispatches=dict(counts),
            mean_prefill_dispatch_ms=1e3 * seconds["prefill"] / max(counts["prefill"], 1),
            mean_decode_dispatch_ms=1e3 * seconds["decode"] / max(counts["decode"], 1),
            k3_launches=rd_mod.ragged_gqa_attend.launches,
            k3_expected=cspec.n_layers * (counts["prefill"] + counts["decode"]),
        )
    q_same = sum(int(a == c) for r_d, r_x in zip(q_rounds["dense"]["rids"], q_rounds["dispatch"]["rids"])
                 for a, c in zip(q_rounds["dense"]["done"][r_d], q_rounds["dispatch"]["done"][r_x]))
    q_total = sum(len(q_rounds["dense"]["done"][r]) for r in q_rounds["dense"]["rids"])
    q_lengths_ok = all(len(rd["done"].get(r, [])) == len(p) + new
                       for rd in q_rounds.values() for r, p in zip(rd["rids"], prompts[:nq]))

    exact, max_gap = _teacher_forcing(spec2, params2, dense["done"], dense["rids"], prompts, new)
    same = sum(
        int(a == c)
        for r_d, r_x in zip(dense["rids"], disp["rids"])
        for a, c in zip(dense["done"][r_d], disp["done"][r_x])
    )
    total = sum(len(dense["done"][r]) for r in dense["rids"])
    lengths_ok = all(len(rd["done"].get(r, [])) == len(p) + new
                     for rd in rounds.values() for r, p in zip(rd["rids"], prompts))

    records["flash_attention"]["launches_by_phase"]["moe"] = k1_launches
    records["ragged_gqa_attend"]["launches_by_phase"]["moe"] = sum(
        rd["k3_launches"] for rd in list(rounds.values()) + list(q_rounds.values()))
    line = {
        "phase": "moe", "model": "Qwen3-30B-A3B widths", "n_layers": MOE_LAYERS,
        "compressed_eval_path": resolve_exec_mode(cspec, config.compressed_exec),
        "padding_overhead": padding_overhead(cspec),
        "init_seconds": init_s, "step_seconds": results["step_seconds"],
        "total_seconds": results["total_seconds"], "job_peak_memory_gib": job_peak,
        "baseline_ppl": results["baseline_ppl"], "compressed_ppl": results["compressed_ppl"],
        "params_before": results["params_before"], "params_after": results["params_after"],
        "ranks": {
            "q": list(cspec.q_ranks), "k": list(cspec.k_ranks), "v": list(cspec.v_ranks),
            "o": list(cspec.o_ranks), "gate (every expert of a layer)": list(cspec.gate_ranks),
        },
        "launches": {"flash_attention": k1_launches}, "expected_launches": {"flash_attention": k1_expected},
        "compressed_logits_max_abs_err": logit_err,
        "padded_vs_unrolled_logits_max_abs_err": padded_err,
        "serve": {
            "requests": n, "max_new_tokens": new, "prompt_lengths": lens.tolist(),
            "moe_capacity": capacity,
            **{moe: {k: v for k, v in rd.items() if k not in ("done", "rids")} for moe, rd in rounds.items()},
            "decode_checks": checks,
            "teacher_forcing": {"exact_argmax": exact, "of": n * new, "max_gap_to_row_max": max_gap},
            "dispatch_tokens_equal_dense": {"equal": same, "of": total},
        },
        "serve_int8_a8_prefill": {
            "requests": nq,
            **{moe: {k: v for k, v in rd.items() if k not in ("done", "rids")} for moe, rd in q_rounds.items()},
            "decode_check": q_checks.get("dispatch"),
            "dispatch_tokens_equal_dense": {"equal": q_same, "of": q_total},
        },
    }
    emit(line)
    problems = []
    if k1_launches != k1_expected:
        problems.append(f"flash_attention launched {k1_launches} times in the job, expected {k1_expected}")
    for moe, rd in rounds.items():
        if rd["k3_launches"] != rd["k3_expected"]:
            problems.append(f"ragged_gqa_attend launched {rd['k3_launches']} times in the {moe} round, "
                            f"expected {rd['k3_expected']}")
    for key in ("baseline_ppl", "compressed_ppl"):
        if not math.isfinite(results[key]):
            problems.append(f"{key} is not finite")
    if not (0 < sum(cspec.gate_ranks) < sum(spec.gate_ranks) and 0 < sum(cspec.q_ranks) < sum(spec.q_ranks)):
        problems.append("rank lists did not shrink")
    if not logit_ok:
        problems.append(f"compressed logits: kernel vs plain attention differ by {logit_err}")
    if not padded_ok:
        problems.append(f"compressed logits: forward_padded vs unrolled forward differ by {padded_err}")
    if not lengths_ok:
        problems.append(f"a request did not return prompt + {new} tokens")
    for moe in rounds:
        if not checks.get(moe, {}).get("ok"):
            problems.append(f"decode logits check of the {moe} round: {checks.get(moe)}")
    if max_gap > 1e-3:
        problems.append(f"a served token is {max_gap} below its row's max logit ({exact} of {n * new} exact)")
    if same != total:
        problems.append(f"dispatch served {total - same} tokens other than dense's")
    for moe, rd in q_rounds.items():
        if rd["k3_launches"] != rd["k3_expected"]:
            problems.append(f"ragged_gqa_attend launched {rd['k3_launches']} times in the int8 {moe} round, "
                            f"expected {rd['k3_expected']}")
    if not q_lengths_ok:
        problems.append(f"an int8 request did not return prompt + {new} tokens")
    if not q_checks.get("dispatch", {}).get("ok"):
        problems.append(f"int8 decode logits, dispatch vs dense: {q_checks.get('dispatch')}")
    if q_same != q_total:
        problems.append(f"int8 dispatch with W8A8 prefill served {q_total - q_same} tokens other than dense's")
    if problems:
        raise AssertionError("; ".join(problems))
    return line


def _decode_check(pm) -> dict:
    """One decode step of a padded model through K3 against its plain
    version: DECODE_SLOTS rows prefilled through the plain attention, then
    decoded at lengths of their own (320, 256, 192, 128)."""
    import numpy as np
    import torch

    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models.padded import _model_step_padded, init_cache_padded

    spec, P = pm.spec, 320
    rng = np.random.default_rng(0)
    ck, cv, _ = init_cache_padded(pm, DECODE_SLOTS, DECODE_POOL)
    prompt = torch.as_tensor(rng.integers(0, spec.vocab_size, (DECODE_SLOTS, P)), device="cuda")
    nxt = torch.as_tensor(rng.integers(0, spec.vocab_size, (DECODE_SLOTS, 1)), device="cuda")
    lengths = np.array([P - 64 * i for i in range(DECODE_SLOTS)])
    with torch.no_grad():
        _model_step_padded(spec, pm.layers, pm.other, pm.q_hd_true, prompt, ck, cv, 0, decode_attn="xla",
                           logits_at=P - 1)
        out, launched = {}, 0
        for attn in ("ragged", "xla"):
            before = rd_mod.ragged_gqa_attend.launches
            out[attn], _ = _model_step_padded(spec, pm.layers, pm.other, pm.q_hd_true, nxt, ck.clone(), cv.clone(),
                                              lengths, decode_attn=attn)
            launched += rd_mod.ragged_gqa_attend.launches - before
    a, c = out["ragged"], out["xla"]
    return {
        "rows_a_kv_head": spec.group_size, "Rq": spec.q_ranks[0] // spec.n_heads,
        "Rv": spec.v_ranks[0] // spec.n_kv_heads, "lengths": lengths.tolist(), "k3_launches": launched,
        "max_abs_err": float((a - c).abs().max()),
        "ok": bool(torch.allclose(a, c, rtol=1e-3, atol=1e-3)) and bool(torch.isfinite(a).all()),
    }


def phase_archs(records: dict, profile: bool = False) -> dict:
    """The dense archs beyond llama and opt. At Gemma-2-9B widths
    (ARCH_LAYERS): a compression job, in which no forward takes K1 (the scores
    are soft-capped, so every layer takes the plain attention, as the JAX
    forward sends it to XLA), then the serve phase's 16 requests through
    K3 with the cap. Then one forward of each of the seven other archs at
    published widths (2 layers) through K1 against the plain attention,
    and one decode step of each padded model through K3 against its plain
    version."""
    import torch

    from modegpt_tpu_torch.calib.data import load_eval_tokens
    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import forward_padded, pad_to_uniform, padding_overhead
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(SimpleNamespace(**{**GEMMA2_9B, "num_hidden_layers": ARCH_LAYERS}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_archs_") as tmp:
        config = CompressionConfig(
            model="random-gemma-2-9b-widths", device="cuda",
            seq_len=2048, calib_size=8, calibs_batch_size=2, eval_batch_size=2,
            eval_max_samples=4, compression_ratio=0.3, dataset="synthetic",
            solver_precision="f32_device",
            output_dir=os.path.join(tmp, "out"),
            temp_storage_dir=os.path.join(tmp, "layers"),
            metrics_dir=os.path.join(tmp, "metrics"),
        ).validate()
        prof = _profiler() if profile else contextlib.nullcontext()
        t_run = time.perf_counter()
        fa_mod.flash_attention.launches = 0
        with prof, _annotated("flash_attention_reference", CAPPED_RANGE) as plain:
            results = run_compression(config, spec=spec, params=params)
        k1_job = fa_mod.flash_attention.launches
        t_run = time.perf_counter() - t_run
        job_peak = torch.cuda.max_memory_allocated() / 2**30
        del params, results["compressed_params"]
        if profile:
            emit(_profile_line(prof, t_run, "archs", ranges=(CAPPED_RANGE,)))
        n_eval = min(config.eval_max_samples, 16)  # the synthetic eval set
        n_batches = 2 * math.ceil(n_eval / config.eval_batch_size) + math.ceil(
            config.calib_size / config.calibs_batch_size
        )
        cspec = results["compressed_spec"]
        spec2, params2, _ = load_compressed_model(results["artifact_dir"], device="cuda")

    # the padded stack against the unrolled forward on one eval window
    ids = torch.as_tensor(load_eval_tokens(None, "synthetic", 512, 1, vocab_size=spec.vocab_size), device="cuda")
    pm = pad_to_uniform(spec2, params2)
    with torch.no_grad():
        lu, _ = forward(spec2, params2, ids, attn_impl="flash")
        lpad = forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, ids, attn_impl="flash")
    padded_err = float((lpad - lu).abs().max())
    padded_ok = bool(torch.allclose(lpad, lu, rtol=1e-3, atol=1e-3))
    del lu, lpad
    torch.cuda.empty_cache()

    # the serve phase's 16 requests through K3, with the cap
    n, new = SERVE["requests"], SERVE["max_new_tokens"]
    prompts, lens = _serve_prompts(cspec.vocab_size, n)
    b = serving.ContinuousBatcher(pm, slots=SERVE["slots"], max_len=SERVE["max_len"],
                                  prefill_bucket=SERVE["prefill_bucket"], temperature=0.0, decode_attn="auto")
    check = {}

    def on_step(step):
        if check or not any(_decoding(b)):
            return
        a, c = (_decode_logits(pm, b.state, attn) for attn in ("ragged", "xla"))
        check.update(step=step, err=float((a - c).abs().max()), ok=bool(torch.allclose(a, c, rtol=1e-3, atol=1e-3)))

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    rd_mod.ragged_gqa_attend.launches = 0
    with _counted_dispatches() as (counts, seconds):
        done, rids, wall = _serve_round(b, prompts, gen, on_step=on_step)
    k3_round = rd_mod.ragged_gqa_attend.launches
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    k3_expected = cspec.n_layers * (counts["prefill"] + counts["decode"])
    exact, max_gap = _teacher_forcing(spec2, params2, done, rids, prompts, new)
    lengths_ok = all(len(done.get(r, [])) == len(p) + new for r, p in zip(rids, prompts))
    decode_attn = b.decode_attn
    del pm, params2, b
    torch.cuda.empty_cache()

    # the seven other archs: one forward each through K1 against the plain
    # attention, and one decode step of the padded model through K3
    forwards = {}
    for name, (T, cfg) in ARCH_FORWARDS.items():
        depth = "n_layer" if cfg["model_type"] == "gpt2" else "num_hidden_layers"
        fspec = spec_from_hf_config(SimpleNamespace(**{**cfg, depth: FORWARD_LAYERS}))
        fparams = init_params(fspec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        fids = torch.as_tensor(load_eval_tokens(None, "synthetic", T, 1, vocab_size=fspec.vocab_size), device="cuda")
        fa_mod.flash_attention.launches = 0
        with torch.no_grad():
            lk, _ = forward(fspec, fparams, fids, attn_impl="flash")
            k1 = fa_mod.flash_attention.launches
            lp, _ = forward(fspec, fparams, fids, attn_impl="xla")
        forwards[name] = {
            "arch": fspec.arch, "T": T, "heads": fspec.n_heads, "kv_heads": fspec.n_kv_heads,
            "head_dim": fspec.head_dim, "window": fspec.sliding_window if fspec.layer_types else None,
            "k1_launches": k1, "logits_max_abs_err": float((lk - lp).abs().max()),
            "ok": bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3)) and bool(torch.isfinite(lk).all()),
        }
        del lk, lp
        forwards[name]["decode"] = _decode_check(pad_to_uniform(fspec, fparams))
        del fparams
        torch.cuda.empty_cache()

    k1_forwards = sum(f["k1_launches"] for f in forwards.values())
    records["flash_attention"]["launches_by_phase"]["archs"] = k1_job + k1_forwards
    records["ragged_gqa_attend"]["launches_by_phase"]["archs"] = k3_round
    line = {
        "phase": "archs", "model": "Gemma-2-9B widths", "n_layers": ARCH_LAYERS,
        "compressed_eval_path": resolve_exec_mode(cspec, config.compressed_exec),
        "padding_overhead": padding_overhead(cspec),
        "init_seconds": init_s, "step_seconds": results["step_seconds"],
        "total_seconds": results["total_seconds"], "job_peak_memory_gib": job_peak,
        "baseline_ppl": results["baseline_ppl"], "compressed_ppl": results["compressed_ppl"],
        "params_before": results["params_before"], "params_after": results["params_after"],
        "ranks": {
            "q": list(cspec.q_ranks), "k": list(cspec.k_ranks), "v": list(cspec.v_ranks),
            "o": list(cspec.o_ranks), "gate": list(cspec.gate_ranks),
        },
        "launches": {"flash_attention": k1_job, "plain_attention_calls": plain["calls"]},
        "expected_launches": {"flash_attention": 0, "plain_attention_calls": ARCH_LAYERS * n_batches},
        "padded_vs_unrolled_logits_max_abs_err": padded_err,
        "serve": {
            "requests": n, "max_new_tokens": new, "prompt_lengths": lens.tolist(),
            "decode_attn": decode_attn, "wall_seconds": wall, "generated_tokens_per_s": n * new / wall,
            "dispatches": dict(counts),
            "mean_prefill_dispatch_ms": 1e3 * seconds["prefill"] / max(counts["prefill"], 1),
            "mean_decode_dispatch_ms": 1e3 * seconds["decode"] / max(counts["decode"], 1),
            "k3_launches": k3_round, "k3_expected": k3_expected, "decode_check": check,
            "teacher_forcing": {"exact_argmax": exact, "of": n * new, "max_gap_to_row_max": max_gap},
            "peak_memory_gib": serve_peak,
        },
        "forwards": forwards,
    }
    emit(line)
    problems = []
    if k1_job != 0:
        problems.append(f"flash_attention launched {k1_job} times in the soft-capped job, expected 0")
    if plain["calls"] != ARCH_LAYERS * n_batches:
        problems.append(f"the plain attention ran {plain['calls']} times in the job, "
                        f"expected {ARCH_LAYERS * n_batches}")
    for key in ("baseline_ppl", "compressed_ppl"):
        if not math.isfinite(results[key]):
            problems.append(f"{key} is not finite")
    if not (0 < sum(cspec.gate_ranks) < sum(spec.gate_ranks) and 0 < sum(cspec.q_ranks) < sum(spec.q_ranks)):
        problems.append("rank lists did not shrink")
    if not padded_ok:
        problems.append(f"compressed logits: forward_padded vs unrolled forward differ by {padded_err}")
    if k3_round != k3_expected:
        problems.append(f"ragged_gqa_attend launched {k3_round} times in the serve round, expected {k3_expected}")
    if decode_attn != "ragged":
        problems.append(f"decode_attn auto resolved to {decode_attn}, not ragged")
    if not lengths_ok:
        problems.append(f"a request did not return prompt + {new} tokens")
    if not check.get("ok"):
        problems.append(f"decode logits K3 vs plain: {check}")
    if exact != n * new or max_gap > 1e-3:
        problems.append(f"{exact} of {n * new} served tokens are the unrolled forward's argmax "
                        f"(largest gap {max_gap})")
    for name, f in forwards.items():
        if f["k1_launches"] != FORWARD_LAYERS:
            problems.append(f"{name}: flash_attention launched {f['k1_launches']} times, expected {FORWARD_LAYERS}")
        if not f["ok"]:
            problems.append(f"{name}: logits K1 vs plain differ by {f['logits_max_abs_err']}")
        d = f["decode"]
        if d["k3_launches"] != FORWARD_LAYERS or not d["ok"]:
            problems.append(f"{name}: decode step K3 vs plain: {d}")
    if problems:
        raise AssertionError("; ".join(problems))
    return line


QWEN3_32B = dict(  # Qwen/Qwen3-32B config.json
    model_type="qwen3", architectures=["Qwen3ForCausalLM"], vocab_size=151936, hidden_size=5120,
    intermediate_size=25600, num_hidden_layers=64, num_attention_heads=64, num_key_value_heads=8, head_dim=128,
    max_position_embeddings=40960, rms_norm_eps=1e-6, rope_theta=1000000.0, hidden_act="silu",
    tie_word_embeddings=False, attention_bias=False, rope_scaling=None, use_sliding_window=False,
    sliding_window=None, max_window_layers=64, torch_dtype="bfloat16",
)
# Qwen3-32B's 64 layers cut to 2 (4 until the cli phase joined the command,
# which must stay within its time limit): 1.95 GB of f32 weights a layer,
# 10 GB with the embeddings
BIG_LAYERS = 2
BIG_SEQ_LEN = 2048  # the main phase's sequence length
# Jobs A and B save int8 artifacts (f32 ones are 11.7 GB each): a card
# machine's disk takes 45 GiB of writes a run, freed blocks included
BIG_ARTIFACT_DTYPE = "int8"
FUSED_LAYERS = 2  # job C: Meta-Llama-3-8B widths cut to 2 layers
BIG_FACTOR_TOL = dict(rtol=2e-3, atol=2e-4)


# bench.py's big presets (bench.py:43-79) at full depth, as HF configs
BIG_PRESETS = {
    "large13B": dict(model_type="llama", vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                     num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=40, head_dim=128,
                     max_position_embeddings=4096, rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False),
    "moe8": dict(model_type="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=8, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                 max_position_embeddings=32768, rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
                 num_local_experts=8, num_experts_per_tok=2),
    "large32B": QWEN3_32B,
}


def _param_count(spec) -> int:
    """Parameters of a dense or MoE spec's tree, counted from its widths."""
    D = spec.d_model
    n = spec.vocab_size * D * (1 if spec.tie_word_embeddings else 2) + D
    for l in range(spec.n_layers):
        n += 2 * D + D * (spec.q_ranks[l] + spec.k_ranks[l] + spec.v_ranks[l]) + spec.o_ranks[l] * D
        n += 2 * spec.head_dim if spec.qk_norm else 0
        mlp = 3 * D * spec.gate_ranks[l]
        n += spec.n_experts * mlp + D * spec.n_experts if spec.is_moe_layer(l) else mlp
    return n


def _preset_sizes() -> dict:
    """Bytes of each big preset's weights in f32 and bf16 against one
    card's 80 GB, with the widest layer's f32 cov_mlp and the Type-I
    selection's workspace beside it (2 x cov_mlp, `offload._flush_hbm_estimate`)."""
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    out = {}
    for name, cfg in BIG_PRESETS.items():
        spec = spec_from_hf_config(SimpleNamespace(**cfg))
        n = _param_count(spec)
        out[name] = {"params": n, "f32_bytes": 4 * n, "bf16_bytes": 2 * n,
                     "cov_mlp_bytes": 4 * spec.d_int ** 2, "type1_workspace_bytes": 8 * spec.d_int ** 2}
    return out


def _write_qwen3_checkpoint(path: str, spec, seed: int) -> dict:
    """A random-weight Qwen3 checkpoint under HF names: bf16 safetensors,
    one shard a layer plus the embeddings' and the head's, with an index
    and ``config.json``, weights from a seeded generator on the card at
    the port's init scale. Returns its bytes and seconds."""
    import torch
    from safetensors.torch import save_file

    from modegpt_tpu_torch.models.init import init_params

    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(seed), dtype=torch.bfloat16)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**QWEN3_32B, "num_hidden_layers": spec.n_layers}, f, indent=2)

    def hf(kernel):  # [in, out] -> HF [out, in] on the host
        return kernel.T.contiguous().cpu()

    shards = {"model-embed.safetensors": {"model.embed_tokens.weight": params["embed_tokens"].cpu(),
                                          "model.norm.weight": params["final_norm"]["scale"].cpu()},
              "model-head.safetensors": {"lm_head.weight": hf(params["lm_head"]["kernel"])}}
    for l, lp in enumerate(params["layers"]):
        b = f"model.layers.{l}."
        shard = {b + "input_layernorm.weight": lp["attn_norm"]["scale"].cpu(),
                 b + "post_attention_layernorm.weight": lp["mlp_norm"]["scale"].cpu(),
                 b + "self_attn.q_norm.weight": lp["q_norm"]["scale"].cpu(),
                 b + "self_attn.k_norm.weight": lp["k_norm"]["scale"].cpu()}
        shard.update({f"{b}self_attn.{n}_proj.weight": hf(lp[n]["kernel"]) for n in "qkvo"})
        shard.update({f"{b}mlp.{n}_proj.weight": hf(lp[n]["kernel"]) for n in ("gate", "up", "down")})
        shards[f"model-layer{l:02d}.safetensors"] = shard
    del params
    weight_map, total = {}, 0
    for name, tensors in shards.items():
        save_file(tensors, os.path.join(path, name), metadata={"format": "pt"})
        for key, t in tensors.items():
            weight_map[key] = name
            total += t.numel() * t.element_size()
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    disk = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
    return {"bytes_on_disk": disk, "tensor_bytes": total, "seconds": time.perf_counter() - t0}


def _factor_store_diff(dir_a: str, dir_b: str, layers: int) -> dict:
    """Every factor file of two stores: selections (idx, rotary masks)
    equal, the rest within BIG_FACTOR_TOL."""
    import numpy as np

    from modegpt_tpu_torch.compress.artifact import load_layer_factors

    worst, unequal, files = 0.0, [], 0
    for l in range(layers):
        for s in ("mlp", "qk", "vo"):
            fa, fb = load_layer_factors(dir_a, l, s), load_layer_factors(dir_b, l, s)
            files += 1
            if fa is None or fb is None or sorted(fa) != sorted(fb):
                unequal.append(f"layer {l} {s}: files differ")
                continue
            for k in fa:
                a, b = np.asarray(fa[k]), np.asarray(fb[k])
                if a.shape != b.shape:
                    unequal.append(f"layer {l} {s}.{k}: shapes {a.shape} vs {b.shape}")
                elif np.array_equal(a, b):
                    continue
                elif k in ("idx", "rotary_mask"):
                    unequal.append(f"layer {l} {s}.{k} differs")
                else:
                    worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0)
                    if not np.allclose(a, b, **BIG_FACTOR_TOL):
                        unequal.append(f"layer {l} {s}.{k} beyond {BIG_FACTOR_TOL}")
    return {"files": files, "max_abs_err": worst, "problems": unequal}


@contextlib.contextmanager
def _spied_loader():
    """Record what `run_compression`'s loader returns and whether the
    safetensors path built it (the loader falls back to AutoModel
    otherwise)."""
    from modegpt_tpu_torch.models import hf as hf_mod
    from modegpt_tpu_torch.models import safetensors_io

    seen: dict = {"safetensors": 0}
    load, direct = hf_mod.load_hf_model, safetensors_io.load_hf_checkpoint_safetensors

    def spy_direct(*args, **kwargs):
        out = direct(*args, **kwargs)
        seen["safetensors"] += 1
        return out

    def spy_load(path, *args, **kwargs):
        out = load(path, *args, **kwargs)
        seen.update(spec=out[0], params=out[1], device=str(kwargs.get("device")))
        return out

    hf_mod.load_hf_model, safetensors_io.load_hf_checkpoint_safetensors = spy_load, spy_direct
    try:
        yield seen
    finally:
        hf_mod.load_hf_model, safetensors_io.load_hf_checkpoint_safetensors = load, direct


@contextlib.contextmanager
def _k1_shapes():
    """Record the shape of every K1 call the forward makes (B, H, Hk, T,
    hd, hd_v, dtype, window), so a phase can hold each one to a kernel
    case."""
    from modegpt_tpu_torch.models import forward as fwd

    seen: set = set()
    kernel = fwd.flash_attention

    def spy(q, k, v, scale=None, window=None):
        seen.add((*q.shape[:2], k.shape[1], q.shape[2], q.shape[3], v.shape[3], str(q.dtype).split(".")[-1], window))
        return kernel(q, k, v, scale=scale, window=window)

    fwd.flash_attention = spy
    try:
        yield seen
    finally:
        fwd.flash_attention = kernel


@contextlib.contextmanager
def _step_peaks():
    """`run_compression`'s steps, each with its own peak device bytes: the
    peak counter is read and reset at every step's end. Yields the
    ``{step: bytes}`` dict of the run in progress (a step that repeats,
    such as a window's calibrate, keeps its largest)."""
    import torch

    from modegpt_tpu_torch.compress import pipeline

    peaks: dict = {}
    steps = pipeline._Steps

    class PeakSteps(steps):
        def __call__(self, name, t0):
            now = super().__call__(name, t0)
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return now

    pipeline._Steps = PeakSteps
    try:
        yield peaks
    finally:
        pipeline._Steps = steps


CALIB_SOLVE_STEPS = ("stream", "calibrate", "allocate", "solve", "factor_store")


def phase_big(records: dict, profile: bool = False) -> dict:
    """Big-model compression at Qwen3-32B widths (2 layers) from a bf16
    safetensors checkpoint: the host-staged streamed job (A) against the
    resident windowed one (B) on the same weights, the staging and flush
    measurements, then the fused job against the chunked one at
    Meta-Llama-3-8B widths (C). K1 in every forward."""
    import numpy as np
    import torch

    from modegpt_tpu_torch.calib.data import load_calibration_batches
    from modegpt_tpu_torch.compress import offload
    from modegpt_tpu_torch.compress.pipeline import compress_in_memory, run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.spec import spec_from_hf_config
    from modegpt_tpu_torch.ops.allocation import allocate_keep_ratios

    ckpt_spec = spec_from_hf_config(SimpleNamespace(**{**QWEN3_32B, "num_hidden_layers": BIG_LAYERS}))
    job = dict(seq_len=BIG_SEQ_LEN, calib_size=8, calibs_batch_size=2, eval_batch_size=2, eval_max_samples=4,
               compression_ratio=0.3, dataset="synthetic", solver_precision="f32_device", layers_per_step=1,
               skip_baseline_eval=True, device="cuda", artifact_dtype=BIG_ARTIFACT_DTYPE)
    n_batches = math.ceil(job["calib_size"] / job["calibs_batch_size"])
    k1_eval = BIG_LAYERS * math.ceil(job["eval_max_samples"] / job["eval_batch_size"])
    expected = {"A": 2 * BIG_LAYERS * n_batches + k1_eval,
                "B": (BIG_LAYERS // job["layers_per_step"]) * n_batches * BIG_LAYERS + k1_eval}
    line: dict = {"phase": "big", "model": "Qwen3-32B widths", "n_layers": BIG_LAYERS,
                  "presets_full_depth": _preset_sizes()}
    launches: dict = {}
    problems = []

    def run(name, tmp, **kw):
        config = CompressionConfig(**{**job, **kw}, output_dir=os.path.join(tmp, name, "out"),
                                   temp_storage_dir=os.path.join(tmp, name, "layers"),
                                   metrics_dir=os.path.join(tmp, name, "metrics")).validate()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_mod.flash_attention.launches = 0
        t0 = time.perf_counter()
        with _step_peaks() as peaks:
            results = run_compression(
                config, **({"spec": spec, "params": kw_params[name]} if name in kw_params else {})
            )
        seconds = time.perf_counter() - t0
        launches[name] = fa_mod.flash_attention.launches
        # the whole job's peak, and its calibrate + solve steps' alone
        return results, {"seconds": seconds, "step_seconds": results["step_seconds"],
                         "peak_bytes": max([torch.cuda.max_memory_allocated(), *peaks.values()]),
                         "calib_solve_peak_bytes": max(v for k, v in peaks.items() if k in CALIB_SOLVE_STEPS),
                         "step_peak_bytes": peaks,
                         "compressed_ppl": results.get("compressed_ppl"), "k1_launches": launches[name]}

    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_big_") as tmp, _k1_shapes() as k1_shapes:
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        line["checkpoint"] = _write_qwen3_checkpoint(ckpt, ckpt_spec, seed=0)
        kw_params: dict = {}

        # ---- job A: streamed, host-staged, from the checkpoint on disk ----
        with _spied_loader() as seen:
            res_a, line["A"] = run("A", tmp, model=ckpt, calib_exec="stream", bi_stage_dtype="bf16")
        shutil.rmtree(os.path.join(tmp, "A", "out"))  # only A's factor store is read again
        # A's reloaded compressed model would sit on the card through the
        # measurements and job B below, inflating their peaks
        del res_a["compressed_params"]
        spec, host = seen["spec"], seen["params"]
        stats = res_a["stream_stats"]
        line["A"]["stream_stats"] = {k: v for k, v in stats.items() if not isinstance(v, dict)}
        line["loader"] = {"safetensors_path": seen["safetensors"] == 1, "device": seen["device"]}
        host_leaves = [t for lp in host["layers"] for t in offload._leaves(lp)]
        layer_bytes = sum(t.numel() * t.element_size() for t in offload._leaves(host["layers"][0]))
        line["host_tree_bytes"] = sum(t.numel() * t.element_size() for t in offload._leaves(host))
        line["dense_layer_bytes"] = layer_bytes
        if spec != ckpt_spec:
            problems.append("the checkpoint's spec differs from the one it was written from")
        if not line["loader"]["safetensors_path"]:
            problems.append("the loader did not take the safetensors path")
        if any(t.device.type != "cpu" for t in host_leaves):
            problems.append("job A moved layer leaves off the host")

        # ---- staging both ways, the adaptive probe, async off ----
        lp1 = host["layers"][1]
        stage = {}
        for way in ("pageable", "pinned", "pageable ", "pinned "):
            stager = offload._PinnedStager(torch.device("cuda"), None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = ({k: {kk: t.to("cuda") for kk, t in v.items()} for k, v in lp1.items()}
                      if way.strip() == "pageable" else offload._ready(stager(lp1), torch.device("cuda")))
            torch.cuda.synchronize()
            stage.setdefault(way.strip() + "_s", []).append(time.perf_counter() - t0)
            del staged, stager
        line["stage_one_layer"] = stage
        batches = load_calibration_batches(None, "synthetic", job["calib_size"], job["calibs_batch_size"],
                                           job["seq_len"], vocab_size=spec.vocab_size)
        fa_mod.flash_attention.launches = 0
        probe: dict = {}
        bi = offload.stream_bi_sweep(spec, host, batches, stats_out=probe, stage_dtype="int8", adaptive=True,
                                     device="cuda")
        launches["probe"] = fa_mod.flash_attention.launches
        line["adaptive_probe"] = {**probe, "bi": bi}
        keep, _ = allocate_keep_ratios(bi, job["compression_ratio"], 0.015, 0.8)
        fa_mod.flash_attention.launches = 0
        off: dict = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        offload.stream_calibrate_solve(
            spec, host, batches, CompressionConfig(**job, stream_async_flush="off"), keep_ratios=keep,
            stats_out=off,
        )
        launches["async_off"] = fa_mod.flash_attention.launches
        line["async_off_stats"] = {k: v for k, v in off.items() if not isinstance(v, dict)}
        # the synchronous sweep's own peak, above what was on the card before it
        line["async_off_stats"]["peak_bytes"] = torch.cuda.max_memory_allocated() - resident
        line["async_off_stats"]["resident_bytes"] = resident
        torch.cuda.empty_cache()

        # ---- job B: windowed, resident, on the same weights ----
        kw_params["B"] = {k: offload._tree_map(lambda t: t.to("cuda"), v) for k, v in host.items()}
        res_b, line["B"] = run("B", tmp, model="random-qwen3-32b-widths", calib_exec="window")
        del kw_params["B"], res_b["compressed_params"]
        line["A_vs_B"] = _factor_store_diff(os.path.join(tmp, "A", "layers"), os.path.join(tmp, "B", "layers"),
                                            BIG_LAYERS)
        ca, cb = res_a["compressed_spec"], res_b["compressed_spec"]
        line["ranks"] = {"gate": list(ca.gate_ranks), "q": list(ca.q_ranks), "v": list(ca.v_ranks)}
        if ca != cb:
            problems.append(f"job A's ranks differ from job B's: {line['ranks']} vs {list(cb.gate_ranks)}")
        problems += line["A_vs_B"]["problems"][:5]
        for sub in ("A", "B", "ckpt"):
            shutil.rmtree(os.path.join(tmp, sub))
        ppl_rel = abs(res_a["compressed_ppl"] - res_b["compressed_ppl"]) / abs(res_b["compressed_ppl"])
        line["ppl_rel_diff"] = ppl_rel
        if not (math.isfinite(res_a["compressed_ppl"]) and ppl_rel <= 1e-3):
            problems.append(f"compressed perplexities: A {res_a['compressed_ppl']} vs B {res_b['compressed_ppl']}")
        for key in ("peak_bytes", "calib_solve_peak_bytes"):
            if line["A"][key] + layer_bytes > line["B"][key]:
                problems.append(f"job A's {key} {line['A'][key]} is not a dense layer ({layer_bytes}) below "
                                f"job B's {line['B'][key]}")
        del res_a, res_b, host, seen
        torch.cuda.empty_cache()

        # ---- job C: fused against chunked, Meta-Llama-3-8B widths ----
        spec = spec_from_hf_config(SimpleNamespace(**{**LLAMA3_8B, "num_hidden_layers": FUSED_LAYERS}))
        kw_params["C"] = init_params(spec, torch.Generator(device="cuda").manual_seed(0))
        c_job = dict(model="random-llama3-8b-widths", skip_final_eval=True, layers_per_step=48, artifact_dtype="")
        res_c, line["C"] = run("C", tmp, **c_job)
        # the fused job in memory (`compress_in_memory` with fused=True), as
        # JAX test_fused.py holds `fused_compress` against `run_compression`
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_mod.flash_attention.launches = 0
        t0 = time.perf_counter()
        fs, fused_params = compress_in_memory(spec, kw_params.pop("C"), CompressionConfig(**{**job, **c_job}, fused=True))
        torch.cuda.synchronize()
        launches["C_fused"] = fa_mod.flash_attention.launches
        line["C_fused"] = {"seconds": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(),
                           "k1_launches": launches["C_fused"]}
        cmp_c = {"max_abs_err": {}}
        rs = res_c["compressed_spec"]
        if rs != fs:
            problems.append(f"fused ranks {list(fs.gate_ranks)} differ from chunked {list(rs.gate_ranks)}")
        else:
            for l in range(FUSED_LAYERS):
                r, f = res_c["compressed_params"]["layers"][l], fused_params["layers"][l]
                if not torch.equal(r["rotary_mask"], f["rotary_mask"]):
                    problems.append(f"fused rotary mask of layer {l} differs")
                for key in ("up", "gate", "q", "k", "down", "v", "o"):
                    a, b = f[key]["kernel"], r[key]["kernel"]
                    err = float((a - b).abs().max())
                    cmp_c["max_abs_err"][f"{l}.{key}"] = err
                    ok = torch.equal(a, b) if key in ("up", "gate", "q", "k") else torch.allclose(
                        a, b, rtol=2e-3, atol=2e-4)
                    if not ok:
                        problems.append(f"fused {key} of layer {l} differs from chunked by {err}")
        line["C_vs_fused"] = cmp_c
        del res_c, fused_params
    torch.cuda.empty_cache()

    line["k1_launches"] = launches
    line["expected_k1_launches"] = expected
    # every shape K1 ran at in this phase is one the kernel phase held
    # against the plain version
    cased = {(c["B"], c["H"], c["Hk"], c["T"], c["hd"], c["hd_v"], c["dtype"], c["window"]) for c in KERNEL_CASES}
    line["k1_shapes"] = sorted(map(list, k1_shapes), key=str)
    for shape in sorted(k1_shapes - cased, key=str):
        problems.append(f"K1 ran at {shape} (B, H, Hk, T, hd, hd_v, dtype, window), which no kernel case checks")
    for name in ("A", "B"):
        if launches[name] != expected[name]:
            problems.append(f"job {name}: flash_attention launched {launches[name]} times, expected {expected[name]}")
    records["flash_attention"]["launches_by_phase"]["big"] = sum(launches.values())
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


# facebook/opt-6.7b's 32 layers cut to 2 (4 until the cli phase joined the
# command, which must stay within its time limit): about 2.4 GB of f32 weights
OPT_LAYERS = 2
OPT_6_7B = dict(  # facebook/opt-6.7b config.json (weights here are random f32, so torch_dtype float32)
    model_type="opt", architectures=["OPTForCausalLM"], vocab_size=50272, hidden_size=4096, ffn_dim=16384,
    num_hidden_layers=32, num_attention_heads=32, max_position_embeddings=2048, word_embed_proj_dim=4096,
    do_layer_norm_before=True, activation_function="relu", enable_bias=True, tie_word_embeddings=True,
    dropout=0.1, attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0, init_std=0.02,
    bos_token_id=2, eos_token_id=2, pad_token_id=1, torch_dtype="float32",
)
# the opt phase's job (the main phase's settings, the whitened-SVD Q/K
# solve) and its search
OPT_JOB = ["--qk_method", "svd", "--seq_len", "2048", "--calib_size", "8", "--calibs_batch_size", "2",
           "--eval_batch_size", "2", "--eval_max_samples", "4", "--compression_ratio", "0.3",
           "--solver_precision", "f32_device", "--dataset", "synthetic", "--device", "cuda"]
OPT_SEARCH = dict(n_trials=1, top_k=1, proxy_seq_len=256, proxy_samples=8)  # 2 trials until the cli phase joined
# each layer's Q_h^T K_h, an f32 solve against the CPU's f64, relative:
# the readings on an H100 were 1.1e-4 to 5.6e-3 (the last at layer 3,
# whose cut at rank 49 falls between close singular values), and the three
# wrong solves missed by 0.19 or more
OPT_SVD_TOL = 1e-2
OPT_HF_TOL = 1e-3  # transformers' OPTForCausalLM against the port's dense forward, max abs logit
K1_KERNEL_NAME = "attention_tile_loop"  # K1's CUDA kernel, as the profiler's trace names it


def _write_opt_checkpoint(path: str, spec, seed: int) -> dict:
    """A random-f32 OPT checkpoint under HF names in one ``model.safetensors``
    with ``config.json``: weights and biases N(0, 0.02) from a seeded
    generator on the card, norm scales around 1 (nonzero biases, so the
    Q/K solve's bias projection has work). Returns its bytes and seconds."""
    import torch
    from safetensors.torch import save_file

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, center=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02 + center).cpu()

    D, F, pre = spec.d_model, spec.d_int, "model.decoder."
    sd = {pre + "embed_tokens.weight": rnd(spec.vocab_size, D),
          pre + "embed_positions.weight": rnd(spec.max_position_embeddings + 2, D),
          pre + "final_layer_norm.weight": rnd(D, center=1.0), pre + "final_layer_norm.bias": rnd(D)}
    for l in range(spec.n_layers):
        b = f"{pre}layers.{l}."
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}{name}.weight"], sd[f"{b}{name}.bias"] = rnd(D, center=1.0), rnd(D)
        for name, (n_out, n_in) in (("self_attn.q_proj", (D, D)), ("self_attn.k_proj", (D, D)),
                                    ("self_attn.v_proj", (D, D)), ("self_attn.out_proj", (D, D)),
                                    ("fc1", (F, D)), ("fc2", (D, F))):
            sd[f"{b}{name}.weight"], sd[f"{b}{name}.bias"] = rnd(n_out, n_in), rnd(n_out)
    save_file(sd, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**OPT_6_7B, "num_hidden_layers": spec.n_layers}, f, indent=2)
    return {"bytes": os.path.getsize(os.path.join(path, "model.safetensors")), "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def _timed_trials():
    """Each `run_compression` and `compute_perplexity` call a search makes,
    with its wall seconds (the device drained) and K1's launches."""
    import torch

    from modegpt_tpu_torch.compress import pipeline
    from modegpt_tpu_torch.evals import perplexity
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod

    calls: list = []
    originals = pipeline.run_compression, perplexity.compute_perplexity

    def timed(kind, fn):
        def call(*args, **kwargs):
            before, t0 = fa_mod.flash_attention.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"call": kind, "seconds": time.perf_counter() - t0,
                          "k1_launches": fa_mod.flash_attention.launches - before})
            return out
        return call

    pipeline.run_compression = timed("compress", originals[0])
    perplexity.compute_perplexity = timed("perplexity", originals[1])
    try:
        yield calls
    finally:
        pipeline.run_compression, perplexity.compute_perplexity = originals


def _qk_forms(q, k, n_heads: int):
    """Each head's bilinear form Q_h^T K_h [H, d, d] in float64 on the card."""
    import torch

    r = q.shape[0] // n_heads
    qh = q.to("cuda", torch.float64).reshape(n_heads, r, -1)
    kh = k.to("cuda", torch.float64).reshape(n_heads, r, -1)
    return qh.transpose(1, 2) @ kh


def _cut_gap(cov, W_q, W_k, rank: int, n_heads: int, ridge: float) -> float:
    """The smallest relative gap, over the heads, between the rank-th and
    the next singular value of the whitened form sqrt(C) Wq_h^T Wk_h,
    in float64 on the card: the smaller it is, the more the truncated
    factors move with rounding."""
    import torch

    from modegpt_tpu_torch.ops.psd import sqrt_and_inv_sqrt_psd

    sqrt_C = sqrt_and_inv_sqrt_psd(cov.double(), ridge)[0]
    Wq_h, Wk_h = (w.double().reshape(n_heads, -1, cov.shape[0]) for w in (W_q, W_k))
    _, S, Vh = torch.linalg.svd(sqrt_C @ Wq_h.transpose(1, 2), full_matrices=False)
    s = torch.linalg.svdvals((S[..., None] * Vh) @ Wk_h)
    return float(((s[:, rank - 1] - s[:, rank]) / s[:, rank - 1]).min())


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def phase_opt(records: dict) -> dict:
    """The OPT-6.7B-width job through the whitened-SVD Q/K solve, then the
    artifact tools and the search on the same model (module docstring,
    phase 10)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from modegpt_tpu_torch import cli, inspect_artifact
    from modegpt_tpu_torch.analysis.search import staged_search
    from modegpt_tpu_torch.calib.data import load_calibration_batches, load_eval_tokens
    from modegpt_tpu_torch.calib.engine import calibrate
    from modegpt_tpu_torch.compress.artifact import load_layer_factors
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.hf import load_hf_model, params_from_state_dict
    from modegpt_tpu_torch.models.hf_export import export_to_hf
    from modegpt_tpu_torch.models.safetensors_io import read_hf_config
    from modegpt_tpu_torch.models.spec import spec_from_hf_config
    from modegpt_tpu_torch.ops.qk import compress_qk_layer_svd
    from safetensors.torch import load_file

    t_phase = time.perf_counter()
    problems, line = [], {"phase": "opt", "model": "facebook/opt-6.7b widths", "n_layers": OPT_LAYERS}
    job = dict(zip(OPT_JOB[::2], OPT_JOB[1::2]))
    k1 = fa_mod.flash_attention
    launches, expected = {}, {}  # K1's launches by step of the phase
    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_opt_") as tmp, _k1_shapes() as shapes:
        ckpt, trace_dir = os.path.join(tmp, "opt-6.7b-widths"), os.path.join(tmp, "trace")
        os.makedirs(ckpt)
        spec = spec_from_hf_config(SimpleNamespace(**{**OPT_6_7B, "num_hidden_layers": OPT_LAYERS}))
        line["checkpoint"] = _write_opt_checkpoint(ckpt, spec, seed=0)
        k1.launches = 0  # once, for the whole phase; each step reads its share

        # 1. the compression CLI, in process
        argv = ["--model", ckpt, *OPT_JOB, "--profile_dir", trace_dir, "--output_dir", os.path.join(tmp, "out"),
                "--temp_storage_dir", os.path.join(tmp, "layers"), "--metrics_dir", os.path.join(tmp, "metrics")]
        mark, t0 = k1.launches, time.perf_counter()
        results = cli.main(argv)
        launches["job"] = k1.launches - mark
        line["job_seconds"] = time.perf_counter() - t0
        n_eval = min(int(job["--eval_max_samples"]), 16)  # the synthetic eval set
        n_calib = math.ceil(int(job["--calib_size"]) / int(job["--calibs_batch_size"]))
        expected["job"] = OPT_LAYERS * (2 * math.ceil(n_eval / int(job["--eval_batch_size"])) + n_calib)
        cspec, cparams, artifact = results["compressed_spec"], results["compressed_params"], results["artifact_dir"]
        line.update(
            step_seconds=results["step_seconds"], baseline_ppl=results["baseline_ppl"],
            compressed_ppl=results["compressed_ppl"], params_before=results["params_before"],
            params_after=results["params_after"],
            ranks={"q": list(cspec.q_ranks), "k": list(cspec.k_ranks), "v": list(cspec.v_ranks),
                   "o": list(cspec.o_ranks), "gate": list(cspec.gate_ranks)},
            compressed_eval_path=resolve_exec_mode(cspec, "auto"),
        )
        for key in ("baseline_ppl", "compressed_ppl"):
            if not math.isfinite(results[key]):
                problems.append(f"{key} is not finite")
        H = spec.n_heads
        if not all(0 < cspec.q_ranks[l] // H < spec.head_dim and cspec.k_ranks[l] == cspec.q_ranks[l]
                   for l in range(OPT_LAYERS)):
            problems.append(f"q/k ranks {cspec.q_ranks} are not below {spec.head_dim} a head")
        if cspec.has_rotary_masks or any("rotary_mask" in lp for lp in cparams["layers"]):
            problems.append("the OPT artifact has rotary masks")
        traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
        names_k1 = False
        for name in traces:
            with open(os.path.join(trace_dir, name)) as f:
                names_k1 |= K1_KERNEL_NAME in f.read()
        line["trace"] = {"files": traces, "names_k1": names_k1,
                         "bytes": sum(os.path.getsize(os.path.join(trace_dir, n)) for n in traces)}
        if not traces or not names_k1:
            problems.append(f"profile_dir holds {traces}, naming K1's kernel: {names_k1}")

        # every layer's Q/K solve: the job's f32 factors and the same solve
        # in f32 on the card, each against the solve in float64 on the
        # CPU, from the same Gram (the job's calibration runs on the dense
        # model too). Controls, each expected beyond OPT_SVD_TOL: the solve
        # without whitening (identity Gram), from bfloat16-rounded inputs,
        # and at one rank less.
        spec_d, params_d, _ = load_hf_model(ckpt, device="cuda")
        batches = load_calibration_batches(None, "synthetic", int(job["--calib_size"]),
                                           int(job["--calibs_batch_size"]), int(job["--seq_len"]),
                                           vocab_size=spec.vocab_size)
        mark = k1.launches
        covs = calibrate(spec_d, params_d, batches, range(OPT_LAYERS), accumulate="device").cov_x
        launches["calibrate"], expected["calibrate"] = k1.launches - mark, OPT_LAYERS * len(batches)
        ridge, svd_rows, svd_solves = CompressionConfig().ridge_qk, [], []

        def f64_solve(host, r):  # on the CPU, on a worker thread beside the phase's card work below
            t0 = time.perf_counter()
            return compress_qk_layer_svd(*host, r, ridge, H), time.perf_counter() - t0

        f64_worker = ThreadPoolExecutor(max_workers=1)
        for l in range(OPT_LAYERS):
            lp, r = params_d["layers"][l], cspec.q_ranks[l] // H
            host = [covs[l], lp["q"]["kernel"].T, lp["k"]["kernel"].T, lp["q"]["bias"], lp["k"]["bias"]]
            f64 = f64_worker.submit(f64_solve, [t.double().cpu() for t in host], r)
            t0 = time.perf_counter()
            f32 = compress_qk_layer_svd(*(t.float() for t in host), r, ridge, H)
            torch.cuda.synchronize()
            row = {"layer": l, "rank": r, "card_f32_s": time.perf_counter() - t0,
                   "gram_eigs_f32": torch.linalg.eigvalsh(covs[l])[[0, 1, -1]].tolist(),
                   "gram_eigs_f64": torch.linalg.eigvalsh(covs[l].double())[[0, 1, -1]].tolist(),
                   "cut_rel_gap": _cut_gap(*host[:3], r, H, ridge)}
            stored = load_layer_factors(os.path.join(tmp, "layers"), l, "qk")
            solves = {
                "job": SimpleNamespace(q=torch.from_numpy(stored["q"]), k=torch.from_numpy(stored["k"])),
                "card": f32,
                "unwhitened": compress_qk_layer_svd(torch.eye(spec.d_model, device="cuda"), *host[1:], r, ridge, H),
                "bf16_inputs": compress_qk_layer_svd(*(t.bfloat16().float() for t in host), r, ridge, H),
                "rank_less_1": compress_qk_layer_svd(*host, r - 1, ridge, H),
            }
            svd_rows.append(row)
            svd_solves.append((f64, {k: (f.q, f.k) for k, f in solves.items()}))
        del covs
        line["svd"] = {"tolerance": OPT_SVD_TOL, "layers": svd_rows}

        # 2. inspect_artifact on the artifact
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = inspect_artifact.main([artifact, "--device", "cuda"])
        info = json.loads(buf.getvalue())
        line["inspect"] = {k: info[k] for k in ("params", "dense_params", "achieved_compression")}
        want_rows = [[cspec.q_ranks[l], cspec.k_ranks[l], cspec.v_ranks[l], cspec.o_ranks[l], cspec.gate_ranks[l]]
                     for l in range(OPT_LAYERS)]
        if rc != 0 or [[row[k] for k in ("q", "k", "v", "o", "mlp")] for row in info["per_layer"]] != want_rows:
            problems.append(f"inspect_artifact's per-layer ranks {info['per_layer']} differ from the spec's")

        # 3. the compressed artifact through export_to_hf and the port's
        # importer; the artifact's forward through K1 (each layer at its own
        # width) also against the plain attention
        ids = torch.as_tensor(load_eval_tokens(None, "synthetic", 128, 1, vocab_size=spec.vocab_size), device="cuda")
        t0 = time.perf_counter()
        out = export_to_hf(cspec, cparams, os.path.join(tmp, "hf_compressed"), tokenizer_source=ckpt)
        export_s = time.perf_counter() - t0
        spec2 = spec_from_hf_config(read_hf_config(out))
        params2 = params_from_state_dict(spec2, load_file(os.path.join(out, "model.safetensors")), device="cuda")
        mark = k1.launches
        with torch.no_grad():
            lk = forward(cspec, cparams, ids)[0]
            err_c = float((forward(spec2, params2, ids)[0] - lk).abs().max())
            lp = forward(cspec, cparams, ids, attn_impl="xla")[0]
        launches["export_compressed"], expected["export_compressed"] = k1.launches - mark, 2 * OPT_LAYERS
        err_plain, plain_ok = float((lk - lp).abs().max()), bool(torch.allclose(lk, lp, rtol=1e-3, atol=1e-3))
        del params2, lk, lp
        line["export_compressed"] = {"seconds": export_s, "logits_max_abs_err": err_c, "tolerance": 1e-5,
                                     "spec_equal": spec2 == cspec, "k1_vs_plain_max_abs_err": err_plain,
                                     "k1_vs_plain_tolerance": "rtol 1e-3, atol 1e-3"}
        if spec2 != cspec or not err_c <= 1e-5:
            problems.append(f"the compressed export reloads with spec equal {spec2 == cspec}, logits off by {err_c}")
        if not plain_ok:
            problems.append(f"the compressed forward through K1 is {err_plain} from the plain attention's")

        # 4. the dense model through export_to_hf and transformers
        import transformers

        out = export_to_hf(spec_d, params_d, os.path.join(tmp, "hf_dense"))
        hf_model = transformers.OPTForCausalLM.from_pretrained(out, dtype=torch.float32).to("cuda").eval()
        mark = k1.launches
        with torch.no_grad():
            want = forward(spec_d, params_d, ids)[0]
            err_d = float((hf_model(ids).logits - want).abs().max())
            scale = float(want.abs().max())
        launches["export_dense"], expected["export_dense"] = k1.launches - mark, OPT_LAYERS
        del hf_model, want
        torch.cuda.empty_cache()
        line["export_dense_transformers"] = {"logits_max_abs_err": err_d, "logits_max_abs": scale,
                                             "tolerance": OPT_HF_TOL, "transformers": transformers.__version__,
                                             "tf32": torch.backends.cuda.matmul.allow_tf32}
        if not err_d <= OPT_HF_TOL:
            problems.append(f"transformers' OPT logits differ from the port's dense forward by {err_d}")

        # 5. the staged search on the same model
        base = CompressionConfig(
            model=ckpt, device="cuda", seq_len=2048, calib_size=int(job["--calib_size"]),
            calibs_batch_size=int(job["--calibs_batch_size"]), compression_ratio=0.3, dataset="synthetic",
            solver_precision="f32_device", qk_method="svd", temp_storage_dir=os.path.join(tmp, "search"),
            output_dir=os.path.join(tmp, "search_out"), metrics_dir=os.path.join(tmp, "search_metrics"),
        ).validate()
        with _timed_trials() as calls:
            mark, t0 = k1.launches, time.perf_counter()
            best, best_val, history = staged_search(base, spec_d, params_d, **OPT_SEARCH)
            launches["search"] = k1.launches - mark
            line["search_seconds"] = time.perf_counter() - t0
        trials = [{"seconds": c["seconds"] + p["seconds"], "k1_launches": c["k1_launches"] + p["k1_launches"]}
                  for c, p in zip(calls[::2], calls[1::2])]
        for t, (_, score) in zip(trials, history + [(best, best_val)]):
            t["score"] = score
        expected["search"] = OPT_LAYERS * (
            OPT_SEARCH["n_trials"] * (n_calib + math.ceil(min(OPT_SEARCH["proxy_samples"], 16) / 8))
            + OPT_SEARCH["top_k"] * (n_calib + math.ceil(min(4 * OPT_SEARCH["proxy_samples"], 16) / 8)))
        line["search"] = {"trials": trials, "best_params": best, "best_score": best_val}
        if not all(math.isfinite(v) for _, v in history) or not math.isfinite(best_val):
            problems.append(f"the search scored {[v for _, v in history]}, finalist {best_val}")
        del params_d, cparams, results

        # step 1's Q/K check, read: every solve against the CPU's f64 one
        for l, (row, (f64, solves)) in enumerate(zip(svd_rows, svd_solves)):
            f64, row["cpu_f64_s"] = f64.result()
            want = _qk_forms(f64.q, f64.k, H)
            errs = {name: _rel_err(_qk_forms(q, k_, H), want) for name, (q, k_) in solves.items()}
            row["job_rel_err"], row["card_rel_err"] = errs.pop("job"), errs.pop("card")
            row["controls_rel_err"] = errs
            del want, f64
            for key in ("job_rel_err", "card_rel_err"):
                if not row[key] <= OPT_SVD_TOL:
                    problems.append(f"layer {l}'s Q_h^T K_h: {key} {row[key]} from the CPU's f64 solve")
            for name, err in row["controls_rel_err"].items():
                if not err > OPT_SVD_TOL:
                    problems.append(f"layer {l}'s control {name} is within OPT_SVD_TOL ({err}): the check "
                                    "cannot tell a wrong solve")
        f64_worker.shutdown()
        del svd_solves
        launches["phase"], expected["phase"] = k1.launches, sum(expected.values())
    torch.cuda.empty_cache()
    line["k1_launches"], line["expected_k1_launches"] = launches, expected
    for step, n in launches.items():
        if n != expected[step]:
            problems.append(f"flash_attention launched {n} times in the phase's {step}, expected {expected[step]}")
    # every shape K1 ran at in the phase: one the kernel phase timed and
    # held against the plain version, or held here (untimed)
    cased = {(c["B"], c["H"], c["Hk"], c["T"], c["hd"], c["hd_v"], c["dtype"], c["window"]) for c in KERNEL_CASES}
    held = [_k1_holds(shape) for shape in sorted(shapes - cased, key=str)]
    line["k1_shapes"] = {"shapes": sorted(map(list, shapes), key=str), "held_here": held}
    problems += [f"K1 at {c['shape']} disagrees with the plain attention" for c in held if not c["ok"]]
    records["flash_attention"]["launches_by_phase"]["opt"] = launches["phase"]
    line["phase_seconds"] = time.perf_counter() - t_phase
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


STREAM = dict(prompt=200, new=56, window=256, n_sink=4, long_prompt=64, long_new=960, cli_new=64, seed=7,
              cli_prompt="the quick brown fox hello world")


def phase_stream(records: dict, main_out: dict) -> dict:
    """Streaming generation on the main phase's compressed model (module
    docstring, phase 11)."""
    import numpy as np
    import torch

    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models.padded import forward_padded, generate_padded
    from modegpt_tpu_torch.models.streaming import streaming_generate

    pm, V = main_out["pm"], main_out["spec"].vocab_size
    rng = np.random.default_rng(STREAM["seed"])
    problems, line = [], {"phase": "stream", "model": "the main phase's compressed Llama-3-8B widths, padded"}
    fa_mod.flash_attention.launches = rd_mod.ragged_gqa_attend.launches = 0

    # 1. inside the window: greedy generation's tokens
    prompt = rng.integers(2, V, (1, STREAM["prompt"]))
    kw = dict(window=STREAM["window"], n_sink=STREAM["n_sink"])
    t0 = time.perf_counter()
    streamed = streaming_generate(pm, prompt, max_new_tokens=STREAM["new"], **kw)
    inside_s = time.perf_counter() - t0
    greedy = generate_padded(pm, prompt, max_new_tokens=STREAM["new"]).cpu().numpy()
    equal = bool(np.array_equal(streamed, greedy))
    inside = {"tokens_equal_greedy": equal, "seconds": inside_s, "tokens": STREAM["prompt"] + STREAM["new"]}
    if not equal:
        # a flip between two f32 computation orders is a tie: the streamed
        # token must still be within 1e-3 of its row's max in the padded
        # forward over the streamed sequence (teacher forcing)
        first = int(np.nonzero(streamed[0] != greedy[0])[0][0])
        with torch.no_grad():
            logits = forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true,
                                    torch.as_tensor(streamed[:, :first], device="cuda"), attn_impl="xla")[0, -1]
        gap = float(logits.max() - logits[int(streamed[0, first])])
        inside.update(first_divergence=first, gap_to_row_max=gap)
        if not gap <= 1e-3:
            problems.append(f"streamed tokens part from greedy at {first} by a logit gap of {gap}")
    line["inside_window"] = inside

    # 2. beyond the window: the same start, finite logits, a flat cache
    prompt = rng.integers(2, V, (1, STREAM["long_prompt"]))
    within = STREAM["window"] - STREAM["long_prompt"]
    ref = streaming_generate(pm, prompt, max_new_tokens=within, **kw)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    mem = []

    def on_step(g, logits):
        nonlocal bad
        bad = bad + (~torch.isfinite(logits)).sum()
        if g >= STREAM["long_prompt"]:
            mem.append(torch.cuda.memory_allocated())

    # earlier phases' garbage is collected first and no collection runs
    # during the stream, so memory_allocated moves only with the stream
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long = streaming_generate(pm, prompt, max_new_tokens=STREAM["long_new"], on_step=on_step, **kw)
        long_s = time.perf_counter() - t0
    finally:
        gc.enable()
    n_bad = int(bad)
    same = bool(np.array_equal(long[:, : STREAM["long_prompt"] + within], ref))
    line["beyond_window"] = {
        "prompt": STREAM["long_prompt"], "new": STREAM["long_new"], "window": STREAM["window"],
        "first_tokens_equal_inside_run": same, "compared": within, "nonfinite_logits": n_bad,
        "memory_allocated_first_last": [mem[0], mem[-1]], "memory_allocated_min_max": [min(mem), max(mem)],
        "seconds": long_s, "new_tokens_per_s": STREAM["long_new"] / long_s,
        "tokens_per_s": (STREAM["long_prompt"] + STREAM["long_new"]) / long_s,
    }
    if not same:
        problems.append(f"the first {within} tokens beyond-window differ from the run inside the window")
    if n_bad:
        problems.append(f"{n_bad} non-finite logits in the long stream")
    if max(mem) != min(mem):
        problems.append(f"device memory moved during the stream: {min(mem)} .. {max(mem)} bytes")

    launches = {"flash_attention": fa_mod.flash_attention.launches,
                "ragged_gqa_attend": rd_mod.ragged_gqa_attend.launches}
    line["launches"] = launches
    records["flash_attention"]["launches_by_phase"]["stream"] = launches["flash_attention"]
    records["ragged_gqa_attend"]["launches_by_phase"]["stream"] = launches["ragged_gqa_attend"]
    if any(launches.values()):
        problems.append(f"streaming launched a kernel ({launches}): it runs on the plain attention, as in JAX")
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


# ---- the cli phase: the port's user entry points on the card ----

# The serve CLI in each mode (on the main artifact, and compressing a
# dense checkpoint in memory) and the eval CLI's tasks and generation, as
# a user calls them, each held to an in-process reference.
CLI = dict(
    requests=8, new_tokens=32,
    # (a): the serve CLI subprocess's flags
    serve_flags=["--prefill_exec", "batched", "--steps_per_dispatch", "4", "--prefix_cache"],
    # (c): Meta-Llama-3-8B widths cut to 2 layers, about 3.0 GB of bf16 safetensors
    compress_layers=2,
    compress_flags=["--compress_ratio", "0.3", "--compress_dataset", "synthetic", "--compress_calib_size", "8",
                    "--compress_seq_len", "2048"],
    # (d)
    task_limit=16, generate_new=64, lookup_window=64, score_tol=1e-3, timeout=600,
)
# (b): the serve CLI's other flag sets, run in process ("--draft_model"
# takes the artifact itself: a self-draft)
CLI_FLAG_SETS = {
    "int8_w8a8_kv8": ["--quantize_int8", "--a8_prefill", "--kv_dtype", "int8"],
    "prompt_lookup": ["--spec_decode", "prompt_lookup"],
    "self_draft": ["--spec_decode", "draft", "--draft_model"],
}


def _serve_batcher(pm, flags, eos, draft_pm=None):
    """The batcher `serve.main` builds for `flags` (its own parser fills
    the defaults), on `pm`, quantised as the flags ask."""
    from modegpt_tpu_torch import serve as serve_mod
    from modegpt_tpu_torch.models import serving
    from modegpt_tpu_torch.models.quantize import quantize_padded

    a = serve_mod._parser().parse_args(["--model", "-", *flags])
    return serving.ContinuousBatcher(
        quantize_padded(pm) if a.quantize_int8 else pm, slots=a.slots, max_len=a.max_len,
        prefill_bucket=a.prefill_bucket, eos_token_id=eos, temperature=a.temperature, moe=a.moe_exec,
        moe_capacity=a.moe_capacity, spec_decode=a.spec_decode, n_draft=a.n_draft, lookup_ngram=a.lookup_ngram,
        draft_pm=draft_pm if a.spec_decode == "draft" else None, kv_dtype=a.kv_dtype,
        steps_per_dispatch=a.steps_per_dispatch, prefill_exec=a.prefill_exec, prefix_cache=a.prefix_cache,
        a8_prefill=a.a8_prefill,
    )


def _reference_round(b, prompts, new: int):
    """Every prompt through batcher `b` as `serve.main` submits them; the
    token lists in prompt order. K1 and K3 launches made here are the
    reference's and are taken back off their counters."""
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod

    saved = fa_mod.flash_attention.launches, rd_mod.ragged_gqa_attend.launches
    rids = [b.submit(p, max_new_tokens=new) for p in prompts]
    done = b.run()
    fa_mod.flash_attention.launches, rd_mod.ragged_gqa_attend.launches = saved
    return [list(map(int, done[r])) for r in rids]


@contextlib.contextmanager
def _made_batchers():
    """Every `ContinuousBatcher` built while inside (an entry point's own),
    so its counters can be read after the entry point returns."""
    from modegpt_tpu_torch.models import serving

    original, made = serving.ContinuousBatcher, []

    class Made(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    serving.ContinuousBatcher = Made
    try:
        yield made
    finally:
        serving.ContinuousBatcher = original


@contextlib.contextmanager
def _spied(module, name: str, calls: list):
    """`module.name` wrapped: each call appends (args, kwargs, seconds)."""
    import torch

    original = getattr(module, name)

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((args, kwargs, time.perf_counter() - t0))
        return out

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def _in_process(main_fn, argv):
    """An entry point's ``main(argv)`` in this process, its stdout (the
    completions or the generated text and results line) captured and its
    stderr passed on: (return value, stdout lines, stderr text, wall s)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            ret = main_fn(argv)
    finally:
        sys.stderr.write(err.getvalue())
    return ret, out.getvalue().splitlines(), err.getvalue(), time.perf_counter() - t0


def _summary(err: str) -> dict:
    """The serve CLI's last JSON line on stderr: requests, new tokens,
    tok/s (of its batcher's run) and device."""
    return json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])


def _completions_differ(lines, texts, tokens, prompts, tok) -> list:
    """Where the serve CLI's JSON completion lines (one a prompt, in
    order) disagree with reference token lists."""
    got = [json.loads(ln) for ln in lines if ln.startswith("{") and '"completion"' in ln]
    if len(got) != len(texts):
        return [f"{len(got)} completion lines for {len(texts)} prompts"]
    bad = []
    for i, (g, text, seq, p) in enumerate(zip(got, texts, tokens, prompts)):
        new = seq[len(p):]
        if g["prompt"] != text or g["tokens"] != len(new) or g["completion"] != tok.decode(new):
            bad.append(f"request {i}: {g['tokens']} tokens {g['completion'][:60]!r}, the reference "
                       f"{len(new)} {tok.decode(new)[:60]!r}")
    return bad


def _part_at_near_ties(name, got, want, prompts, logits_of, problems) -> list:
    """Greedy sequences of two modes that should agree: each parting
    allowed only at a near-tie of the reference's logits (TPSERVE
    near_tie); returns the partings, printed."""
    ties = []
    for i, (g, w, p) in enumerate(zip(got, want, prompts)):
        d = _first_divergence(g, w, logits_of, len(p))
        if d is None:
            continue
        ties.append({"request": i, "at": d[0], "gap": d[1]})
        if not d[1] <= TPSERVE["near_tie"]:
            problems.append(f"{name}: request {i} parts at token {d[0]} by a logit gap of {d[1]}")
    return ties


def _task_files(workdir: str) -> list:
    """The frozen winogrande and arc documents (tests/fixtures) written in
    `evals.tasks.load_task`'s {"task", "docs"} form; the --tasks list."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "fixtures", "task_docs.json")) as f:
        docs = json.load(f)
    names = ["synthetic"]
    for family, key in (("winogrande", "winogrande"), ("arc_easy", "arc")):
        path = os.path.join(workdir, f"{key}.json")
        with open(path, "w") as f:
            json.dump({"task": family, "docs": docs[key]}, f)
        names.append(path)
    return names


def phase_cli(records: dict, main_out: dict) -> dict:
    """The port's user entry points on the card (module docstring, phase
    11b): (a) `python -m modegpt_tpu_torch.serve` as a subprocess, beside
    it the server CLI and then the streaming eval CLI, (b) `serve.main`
    in process in three more flag sets, (c) `serve.main --compress_ratio`
    on a dense checkpoint, (d) `evals.cli.main` with --tasks and three
    forms of --generate; each against an in-process reference, K1's and
    K3's launches counted in process."""
    import gc as gc_mod

    import numpy as np
    import torch

    from modegpt_tpu_torch import serve as serve_mod
    from modegpt_tpu_torch.compress.pipeline import compress_in_memory
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.evals import cli as eval_cli
    from modegpt_tpu_torch.evals import tasks as tasks_mod
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import generate as generate_mod
    from modegpt_tpu_torch.models import speculative
    from modegpt_tpu_torch.models.forward import FLASH_MIN_T, forward
    from modegpt_tpu_torch.models.hf import load_hf_model
    from modegpt_tpu_torch.models.hf_export import export_to_hf
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.spec import spec_from_hf_config
    from modegpt_tpu_torch.models.streaming import streaming_generate

    t_phase = time.perf_counter()
    cspec, cparams, pm, art = main_out["spec"], main_out["params"], main_out["pm"], main_out["artifact_dir"]
    V, new, L = cspec.vocab_size, CLI["new_tokens"], cspec.n_layers
    if not os.path.exists(os.path.join(art, "tokenizer.json")):
        _full_vocab_tokenizer(V).save_pretrained(art)
    tok = eval_cli._load_tokenizer(art, "")  # the tokenizer both CLIs read
    eos = tok.eos_token_id
    problems, steps = [], {}
    fa_mod.flash_attention.launches = rd_mod.ragged_gqa_attend.launches = 0

    def logits_of(ids):  # the unrolled compressed forward, the near-ties' reference
        saved = fa_mod.flash_attention.launches
        out = forward(cspec, cparams, ids)[0]
        fa_mod.flash_attention.launches = saved
        return out

    def step_line(name, wall, k3, k3_expected, k1=0, k1_expected=0, **extra):
        line = {"phase": "cli", "step": name, "wall_seconds": wall,
                "launches": {"ragged_gqa_attend": k3, "flash_attention": k1},
                "expected_launches": {"ragged_gqa_attend": k3_expected, "flash_attention": k1_expected}, **extra}
        if k3 != k3_expected or k1 != k1_expected:
            problems.append(f"{name}: K3 launched {k3} times (expected {k3_expected}), K1 {k1} ({k1_expected})")
        emit(line)
        steps[name] = line

    # the serve phase's id prompts as words of the tokenizer: they must
    # come back as the same ids
    id_prompts = [list(map(int, p)) for p in _serve_prompts(V, CLI["requests"])[0]]
    texts = [tok.decode(p) for p in id_prompts]
    if [tok(t)["input_ids"] for t in texts] != id_prompts:
        raise AssertionError("the cli prompts do not round-trip through the tokenizer")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_cli_") as tmp, _k1_shapes() as k1_shapes, \
            _k3_shapes() as k3_shapes:
        prompts_file = os.path.join(tmp, "prompts.txt")
        with open(prompts_file, "w") as f:
            f.write("\n".join(texts) + "\n")
        base = ["--model", art, "--prompts", prompts_file, "--max_new_tokens", str(new)]

        # (a) the serve CLI as a user starts it, and the server phase's
        # server CLI, both beside the in-process steps
        env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        out_path, err_path = os.path.join(tmp, "serve.out"), os.path.join(tmp, "serve.err")
        with open(out_path, "w") as fo, open(err_path, "w") as fe:
            t_a = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-m", "modegpt_tpu_torch.serve", *base, *CLI["serve_flags"]],
                                    cwd=root, env=env, stdout=fo, stderr=fe)
        server, stream_proc = _start_server_cli(art, tmp), None
        try:
            plain = _reference_round(_serve_batcher(pm, CLI["serve_flags"], eos), id_prompts, new)

            # (b) the serve CLI's other flag sets in process
            for name, flags in CLI_FLAG_SETS.items():
                flags = flags + [art] if flags[-1] == "--draft_model" else flags
                gc_mod.collect()
                torch.cuda.empty_cache()
                k3_0 = rd_mod.ragged_gqa_attend.launches
                with _counted_dispatches() as (counts, _), _made_batchers() as made:
                    done, lines, err, wall = _in_process(serve_mod.main, base + flags + ["--device", "cuda"])
                k3 = rd_mod.ragged_gqa_attend.launches - k3_0
                served = [list(map(int, done[r])) for r in sorted(done)]
                ref_b = _serve_batcher(pm, flags, eos, draft_pm=pm)
                want = _reference_round(ref_b, id_prompts, new)
                extra = {"tok_per_s": _summary(err)["tok_per_s"],
                         "tokens_equal_reference": served == want}
                if served != want:
                    problems.append(f"{name}: the serve CLI's tokens differ from the in-process batcher's")
                problems += [f"{name}: {p}" for p in _completions_differ(lines, texts, served, id_prompts, tok)]
                cli_b = made[0]
                if cli_b.spec_decode != "off":
                    extra["partings_from_a"] = _part_at_near_ties(name, served, plain, id_prompts, logits_of, problems)
                    drafted = sum(s["drafted"] for s in cli_b.stats.values())
                    accepted = sum(s["accepted"] for s in cli_b.stats.values())
                    extra["speculative"] = {"drafted": drafted, "accepted": accepted,
                                            "stats_equal_reference": cli_b.stats == ref_b.stats}
                    if cli_b.stats != ref_b.stats:
                        problems.append(f"{name}: the batcher's stats differ from the in-process run's")
                    if name == "self_draft" and accepted != drafted:
                        problems.append(f"self_draft: {accepted} of {drafted} drafts accepted")
                if cli_b.decode_attn != "ragged":
                    problems.append(f"{name}: decode_attn resolved to {cli_b.decode_attn}")
                step_line(f"serve_{name}", wall, k3, counts["layer_dispatches"],
                          dispatches={k: v for k, v in counts.items() if v}, **extra)
                del made, cli_b, ref_b, done

            # the eval CLI's --streaming_window as a user runs it (the
            # stream phase's entry point), beside (c) and (d), once (a) is
            # done: three artifact loads at once would crowd the card
            try:
                proc.wait(timeout=max(1.0, CLI["timeout"] - (time.perf_counter() - t_a)))
            except subprocess.TimeoutExpired:
                problems.append("the serve CLI subprocess did not finish")
            wall_a = time.perf_counter() - t_a
            stream_out, stream_err = os.path.join(tmp, "stream.out"), os.path.join(tmp, "stream.err")
            with open(stream_out, "w") as fo, open(stream_err, "w") as fe:
                t_s = time.perf_counter()
                stream_proc = subprocess.Popen(
                    [sys.executable, "-m", "modegpt_tpu_torch.evals.cli", "--model", art, "--generate",
                     STREAM["cli_prompt"], "--streaming_window", str(STREAM["window"]), "--max_new_tokens",
                     str(STREAM["cli_new"])], cwd=root, env=env, stdout=fo, stderr=fe)

            # (c) serve --compress_ratio on a dense checkpoint
            gc_mod.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            dspec = spec_from_hf_config(SimpleNamespace(**{**LLAMA3_8B, "num_hidden_layers": CLI["compress_layers"]}))
            ckpt = os.path.join(tmp, "dense_ckpt")
            dparams = init_params(dspec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
            export_to_hf(dspec, dparams, ckpt, dtype=torch.bfloat16)
            del dparams
            for fname in os.listdir(art):
                if fname.startswith(("tokenizer", "special_tokens")):
                    shutil.copy(os.path.join(art, fname), ckpt)
            ckpt_bytes = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
            write_s = time.perf_counter() - t0
            k1_0, k3_0 = fa_mod.flash_attention.launches, rd_mod.ragged_gqa_attend.launches
            compressed = []
            with _counted_dispatches() as (counts, _), _spied(
                    sys.modules["modegpt_tpu_torch.compress.pipeline"], "compress_in_memory", compressed):
                done, lines, err, wall = _in_process(
                    serve_mod.main, ["--model", ckpt, "--prompts", prompts_file, "--max_new_tokens", str(new),
                                     *CLI["compress_flags"], "--device", "cuda"])
            k1, k3 = fa_mod.flash_attention.launches - k1_0, rd_mod.ragged_gqa_attend.launches - k3_0
            served = [list(map(int, done[r])) for r in sorted(done)]
            a = serve_mod._parser().parse_args(["--model", ckpt, *CLI["compress_flags"]])
            ccfg = CompressionConfig(
                compression_ratio=a.compress_ratio, dataset=a.compress_dataset, calib_size=a.compress_calib_size,
                calibs_batch_size=min(4, a.compress_calib_size), seq_len=a.compress_seq_len,
                solver_precision="f32_device", device="cuda",
            ).validate()
            # the BI prepass and the calibrating sweep each run every
            # layer's forward once a calibration batch
            n_calib = math.ceil(ccfg.calib_size / ccfg.calibs_batch_size)
            saved = fa_mod.flash_attention.launches
            rspec, rparams, rtok = load_hf_model(ckpt, device="cuda")
            rspec, rparams = compress_in_memory(rspec, rparams, ccfg, tokenizer=rtok)
            fa_mod.flash_attention.launches = saved
            want = _reference_round(_serve_batcher(pad_to_uniform(rspec, rparams), [], eos), id_prompts, new)
            if served != want:
                problems.append("compress: the served tokens differ from a batcher's on compress_in_memory's tree")
            problems += [f"compress: {p}" for p in _completions_differ(lines, texts, served, id_prompts, tok)]
            step_line("serve_compress", wall, k3, counts["layer_dispatches"], k1, 2 * dspec.n_layers * n_calib,
                      tok_per_s=_summary(err)["tok_per_s"],
                      checkpoint={"bytes": ckpt_bytes, "write_seconds": write_s, "dtype": "bfloat16",
                                  "layers": dspec.n_layers},
                      compress_seconds=compressed[0][2] if compressed else None, calibration_batches=n_calib,
                      ranks={"q": list(rspec.q_ranks), "gate": list(rspec.gate_ranks)},
                      tokens_equal_reference=served == want)
            del rparams, done
            shutil.rmtree(ckpt, ignore_errors=True)

            # (d) the eval CLI: tasks and plain generation, then prompt
            # lookup and a self-draft
            gc_mod.collect()
            torch.cuda.empty_cache()
            task_names = _task_files(tmp)
            gen_ids = id_prompts[0][: CLI["lookup_window"]] * 2  # repeats for the lookup to draft from
            gen_text = tok.decode(gen_ids)
            if tok(gen_text)["input_ids"] != gen_ids:
                raise AssertionError("the --generate prompt does not round-trip through the tokenizer")
            gen_argv = ["--generate", gen_text, "--max_new_tokens", str(CLI["generate_new"])]
            widths, gens = [], []
            k1_0, k3_0 = fa_mod.flash_attention.launches, rd_mod.ragged_gqa_attend.launches
            with _spied(tasks_mod, "_token_logprobs", widths), _spied(generate_mod, "generate", gens):
                res, _, _, wall = _in_process(eval_cli.main, ["--model", art, "--tasks", ",".join(task_names),
                                                              "--task_limit", str(CLI["task_limit"]), *gen_argv,
                                                              "--device", "cuda"])
            k1, k3 = fa_mod.flash_attention.launches - k1_0, rd_mod.ragged_gqa_attend.launches - k3_0
            widths = [tuple(c[0][2].shape) for c in widths]
            k1_expected = L * sum(w[1] >= FLASH_MIN_T for w in widths)
            saved = fa_mod.flash_attention.launches
            tasks_out = {}
            for name in task_names:
                examples = tasks_mod.load_task(name, limit=CLI["task_limit"])
                mine = tasks_mod.evaluate_multiple_choice(cspec, cparams, examples, tok, return_scores=True)
                with _plain_attention(tasks_mod):
                    xla = tasks_mod.evaluate_multiple_choice(cspec, cparams, examples, tok, return_scores=True)
                finite = np.isfinite(xla["scores"])
                score_err = float(np.abs(mine["scores"][finite] - xla["scores"][finite]).max())
                got = res[name]
                same = (got["acc"], got["acc_norm"], got["n"]) == (mine["acc"], mine["acc_norm"], mine["n"])
                tasks_out[os.path.basename(name)] = {"acc": got["acc"], "acc_norm": got["acc_norm"], "n": got["n"],
                                                     "equal_in_process": same, "score_max_abs_err_vs_plain": score_err}
                if not same:
                    problems.append(f"task {name}: the CLI's {got} differ from the in-process {mine}")
                if not score_err <= CLI["score_tol"] or not np.array_equal(finite, np.isfinite(mine["scores"])):
                    problems.append(f"task {name}: scores {score_err} from the plain attention's")
            want_ids = generate_mod.generate(cspec, cparams, [gen_ids], max_new_tokens=CLI["generate_new"],
                                             eos_token_id=eos)[0].tolist()
            fa_mod.flash_attention.launches = saved
            plain_text = res["generation"]
            if plain_text != tok.decode(want_ids):
                problems.append("--generate: the CLI's text differs from an in-process generate's")
            step_line("eval_tasks_generate", wall, k3, 0, k1, k1_expected, tasks=tasks_out,
                      task_batch_widths=widths, generate_seconds=gens[0][2] if gens else None,
                      generate_tokens_per_s=CLI["generate_new"] / gens[0][2] if gens else None)
            want_ids = tok(plain_text)["input_ids"]
            for name, flags, fn in (("eval_prompt_lookup", ["--prompt_lookup"], "prompt_lookup_generate"),
                                    ("eval_self_draft", ["--speculative_draft", art], "speculative_generate")):
                gc_mod.collect()
                torch.cuda.empty_cache()
                calls, k3_0 = [], rd_mod.ragged_gqa_attend.launches
                with _counted_dispatches() as (counts, _), _spied(speculative, fn, calls):
                    res, _, _, wall = _in_process(eval_cli.main, ["--model", art, *gen_argv, *flags,
                                                                  "--device", "cuda"])
                k3 = rd_mod.ragged_gqa_attend.launches - k3_0
                stats = res.get("prompt_lookup") or res.get("spec_decode")
                got_ids = tok(res["generation"])["input_ids"]
                ties = _part_at_near_ties(name, [got_ids], [want_ids], [gen_ids], logits_of, problems)
                if name == "eval_self_draft" and stats["accepted"] != stats["drafted"]:
                    problems.append(f"{name}: {stats['accepted']} of {stats['drafted']} drafts accepted")
                step_line(name, wall, k3, counts["layer_dispatches"], speculative=stats, partings_from_plain=ties,
                          generate_seconds=calls[0][2] if calls else None,
                          generate_tokens_per_s=CLI["generate_new"] / calls[0][2] if calls else None,
                          text_equal_plain=res["generation"] == plain_text)

            # the server CLI: /health and one completion (its check's
            # forward is a reference: its K1 launches are taken back)
            saved = fa_mod.flash_attention.launches
            server_cli = _server_cli(server, id_prompts[0][:200], cspec, cparams)
            fa_mod.flash_attention.launches = saved
            # first asked here, at the phase's end: ready within this time
            server_cli["ready_within_seconds"] = server_cli.pop("ready_seconds", None)
            if not server_cli.get("ok"):
                problems.append(f"server CLI: {server_cli}")
            step_line("server_cli_subprocess", server_cli["ready_within_seconds"], 0, 0, **server_cli,
                      note="the server phase's check of `python -m modegpt_tpu_torch.server`, run here beside (a)")

            # the streaming CLI: its text the library's streamed tokens
            try:
                stream_proc.wait(timeout=CLI["timeout"])
            except subprocess.TimeoutExpired:
                problems.append("the streaming eval CLI subprocess did not finish")
            wall_s = time.perf_counter() - t_s
            ids = np.asarray([tok(STREAM["cli_prompt"])["input_ids"]])
            direct = tok.decode(streaming_generate(pm, ids, max_new_tokens=STREAM["cli_new"], eos_token_id=eos,
                                                   window=STREAM["window"], n_sink=STREAM["n_sink"])[0].tolist())
            text = open(stream_out).read().splitlines()[:1]
            if stream_proc.returncode != 0 or text != [direct]:
                problems.append(f"the streaming eval CLI (rc {stream_proc.returncode}) printed {text[:1]!r}, the "
                                f"library streams {direct[:80]!r}: {open(stream_err).read()[-1500:]}")
            step_line("eval_streaming_subprocess", wall_s, 0, 0, text_equals_library_stream=text == [direct],
                      generation_head=direct[:80], note="the stream phase's eval CLI check; plain attention, no "
                      "kernel by design (its launches are the subprocess's own)")
        finally:
            _stop([p for p in (proc, server["proc"], stream_proc) if p is not None])
        err = open(err_path).read()
        lines = open(out_path).read().splitlines()
        summary = _summary(err) if proc.returncode == 0 else {}
        if proc.returncode != 0:
            problems.append(f"the serve CLI subprocess exited {proc.returncode}: {err[-1500:]}")
        else:
            problems += [f"subprocess: {p}" for p in _completions_differ(lines, texts, plain, id_prompts, tok)]
            if "cuda" not in summary.get("device", ""):
                problems.append(f"the serve CLI subprocess served on {summary.get('device')}")
        step_line("serve_cli_subprocess", wall_a, 0, 0, tok_per_s=summary.get("tok_per_s"), device=summary.get("device"),
                  flags=CLI["serve_flags"], note="launches are the subprocess's own, not counted here")

    k1_total, k3_total = fa_mod.flash_attention.launches, rd_mod.ragged_gqa_attend.launches
    records["flash_attention"]["launches_by_phase"]["cli"] = k1_total
    records["ragged_gqa_attend"]["launches_by_phase"]["cli"] = k3_total
    # every shape the phase's kernels ran at: a timed kernel case, or held here
    k1_known = {tuple(c[k] for k in ("B", "H", "Hk", "T", "hd", "hd_v", "dtype", "window")) for c in KERNEL_CASES}
    k3_known = {_k3_case_key(c) for c in RAGGED_CASES}
    held = {"flash_attention": [_k1_holds(s) for s in sorted(k1_shapes, key=str) if s not in k1_known],
            "ragged_gqa_attend": [_k3_holds(s) for s in sorted(k3_shapes, key=str) if s not in k3_known]}
    problems += [f"{k} at {c['shape']} disagrees with its plain version" for k, v in held.items() for c in v
                 if not c["ok"]]
    line = {"phase": "cli", "card": card_line(), "model": "main artifact (Meta-Llama-3-8B widths, 4 layers, f32); "
            f"a {CLI['compress_layers']}-layer dense bf16 checkpoint for --compress_ratio",
            "steps": list(steps), "launches": {"flash_attention": k1_total, "ragged_gqa_attend": k3_total},
            "shapes": {"flash_attention": len(k1_shapes), "ragged_gqa_attend": len(k3_shapes)}, "held_here": held,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


@contextlib.contextmanager
def _plain_attention(module):
    """`module.forward` with ``attn_impl="xla"``: the plain attention at
    every T."""
    import functools

    original = module.forward
    module.forward = functools.partial(original, attn_impl="xla")
    try:
        yield
    finally:
        module.forward = original


# ---- the parallel phase: the compression job on a process mesh ----

PARALLEL_LAYERS = 4  # Meta-Llama-3-8B widths, 32 -> 4 layers, as the main phase
PARALLEL_JOB = dict(seq_len=2048, calib_size=8, calibs_batch_size=2, eval_batch_size=2, eval_max_samples=4,
                    compression_ratio=0.3, dataset="synthetic", solver_precision="f32_device")
# job name: (mesh, ranks, backend). One card: NCCL takes one rank a card,
# so the meshes of several ranks share cuda:0 over gloo, asked for
# explicitly; the NCCL path runs at world size 1.
PARALLEL_RUNS = {
    "a_nccl_data1": ("data:1", 1, "nccl"),
    # (a) with its calibration batches in reverse order: the same sums in
    # another order, the noise floor of the job's own float32 arithmetic
    "a2_nccl_data1_reversed": ("data:1", 1, "nccl"),
    "b_gloo_data2_model2": ("data:2,model:2", 4, "gloo"),
    "c_gloo_stage4": ("stage:4", 4, "gloo"),
    "d_gloo_context2": ("context:2", 2, "gloo"),
    "tpserve": ("data:1,model:2", 2, "gloo"),  # the tpserve phase's ranks (`tpserve_rank`)
}
PARALLEL_STAT_TOL = 1e-4  # each Gram's relative Frobenius distance; BI and perplexity relative
# The meshed job's compressed model against the one-rank job's, on one
# eval window's last PARALLEL_LOGIT_ROWS positions: within the main
# phase's logits tolerance, or within PARALLEL_NOISE_FACTOR times the
# one-rank job's own distance from its reordered twin (a2). The meshed
# job's Grams are the same sums in another order, which the solves
# amplify by their conditioning; the factors' distances are printed
# (relative Frobenius; V/O as each head's o_h v_g on probes, since the
# SVD fixes a sign and a basis per head), and the selections (MLP
# indices, rotary masks) must be equal.
PARALLEL_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
PARALLEL_NOISE_FACTOR = 4.0
PARALLEL_LOGIT_ROWS = 256
PARALLEL_PPL_TOL = 2e-3  # the meshed job's perplexities against the one-rank job's
PARALLEL_TIMEOUT_S = 600  # a launch; each collective times out at 300 s


def _parallel_spec():
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    return spec_from_hf_config(SimpleNamespace(**{**LLAMA3_8B, "num_hidden_layers": PARALLEL_LAYERS}))


def _parallel_params(spec):
    """The main phase's weights (the card's generator, seed 0), moved to
    host memory: the job places them (a rank's shard on the card)."""
    import torch

    from modegpt_tpu_torch.models.init import init_params

    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    return _tree_to(params, "cpu")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if hasattr(tree, "to") else tree


def _parallel_data(spec):
    from modegpt_tpu_torch.calib.data import load_calibration_batches, load_eval_tokens

    batches = load_calibration_batches(None, "synthetic", PARALLEL_JOB["calib_size"],
                                       PARALLEL_JOB["calibs_batch_size"], PARALLEL_JOB["seq_len"],
                                       vocab_size=spec.vocab_size)
    tokens = load_eval_tokens(None, "synthetic", PARALLEL_JOB["seq_len"], PARALLEL_JOB["eval_max_samples"],
                              vocab_size=spec.vocab_size)
    return batches, tokens


def _stat_errors(got, ref: dict) -> dict:
    """Largest relative Frobenius distance of each statistic over the
    layers, and BI's largest relative difference, against the reference
    the parent saved."""
    import torch

    out = {}
    for field in ("cov_mlp", "cov_q", "cov_k", "cov_x"):
        worst = 0.0
        for l, want in ref[field].items():
            g = getattr(got, field)[l].to(device="cpu", dtype=torch.float64)
            w = want.to(torch.float64)
            worst = max(worst, float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)))
        out[field] = worst
    bi, want_bi = torch.tensor(got.bi_scores), torch.tensor(ref["bi"])
    out["bi"] = float(((bi - want_bi).abs() / want_bi.abs()).max())
    return out


def parallel_rank(job: str, workdir: str) -> int:
    """One rank of a parallel-phase job (this script re-run with
    ``--parallel-rank``; RANK, WORLD_SIZE and MODEGPT_DIST_* in its
    environment). Writes ``<workdir>/<job>.rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from modegpt_tpu_torch.kernels import flash_attention as fa_mod
    from modegpt_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    if job == "tpserve":
        return tpserve_rank(workdir)
    t_start = time.perf_counter()
    assert maybe_initialize_distributed("cuda"), "not launched as a rank"
    shape = PARALLEL_RUNS[job][0]
    mesh = make_mesh(shape, device="cuda")
    spec = _parallel_spec()
    batches, tokens = _parallel_data(spec)
    params = _parallel_params(spec)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    line = {"job": job, "mesh": shape, "rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
            "device": str(mesh.device), "setup_seconds": time.perf_counter() - t_start}
    if job.startswith("a2_"):
        batches = batches[::-1]
    t0 = time.perf_counter()
    fa_mod.flash_attention.launches = 0
    with _k1_shapes() as shapes:
        if job.startswith(("a_", "a2_", "b_")):
            from modegpt_tpu_torch.compress.pipeline import run_compression
            from modegpt_tpu_torch.config import CompressionConfig

            root = os.path.join(workdir, job)
            config = CompressionConfig(
                model="random-llama3-8b-widths", device="cuda", mesh_shape=shape, **PARALLEL_JOB,
                output_dir=os.path.join(root, "out"), temp_storage_dir=os.path.join(root, "layers"),
                metrics_dir=os.path.join(root, "metrics"),
            ).validate()
            results = run_compression(config, spec=spec, params=params, mesh=mesh,
                                      calib_batches=batches, eval_tokens=tokens)
            del params
            cs = results["compressed_spec"]
            if mesh.rank == 0:  # after the count below: these launches hold the model, not the job
                compare = (cs, results["compressed_params"], tokens[:1])
            line.update(
                baseline_ppl=results["baseline_ppl"], compressed_ppl=results["compressed_ppl"],
                step_seconds=results["step_seconds"], store=os.path.join(root, "layers"),
                rank_lists={k: list(getattr(cs, f"{k}_ranks")) for k in ("q", "k", "v", "o", "gate")},
            )
            n_eval = math.ceil(PARALLEL_JOB["eval_max_samples"] / PARALLEL_JOB["eval_batch_size"])
            n_calib = math.ceil(PARALLEL_JOB["calib_size"] / PARALLEL_JOB["calibs_batch_size"])
            expected = PARALLEL_LAYERS * (2 * n_eval + n_calib)  # every rank runs every batch's forwards
        elif job.startswith("c_"):
            from modegpt_tpu_torch.parallel.pp import calibrate_pp, perplexity_pp

            per = PARALLEL_LAYERS // mesh.size("stage")
            mine = range(mesh.coord("stage") * per, (mesh.coord("stage") + 1) * per)
            # a stage keeps its own layers (and the embeddings and head)
            params["layers"] = [lp if l in mine else {} for l, lp in enumerate(params["layers"])]
            calib = calibrate_pp(spec, params, batches, mesh)
            ppl = perplexity_pp(spec, params, tokens, mesh, batch_size=PARALLEL_JOB["eval_batch_size"])
            line["ppl"] = ppl
            expected = per * (len(batches) + len(tokens) // PARALLEL_JOB["eval_batch_size"])
        else:
            from modegpt_tpu_torch.parallel.ring import calibrate_ring

            params = _tree_to(params, mesh.device)
            calib = calibrate_ring(spec, params, batches, range(PARALLEL_LAYERS), mesh)
            expected = 0  # a ring step's products are plain torch ops, as in JAX
        torch.cuda.synchronize()
    line.update(seconds=time.perf_counter() - t0, comm_seconds=mesh.comm_seconds, comm_bytes=mesh.comm_bytes,
                k1_launches=fa_mod.flash_attention.launches,
                k1_expected=expected, k1_shapes=sorted(shapes, key=str),
                max_memory_allocated=torch.cuda.max_memory_allocated())
    if job.startswith(("a_", "a2_", "b_")) and mesh.rank == 0:
        from modegpt_tpu_torch.models.forward import forward

        cs, cp, ids = compare
        logits = forward(cs, cp, torch.as_tensor(ids, device=mesh.device))[0][:, -PARALLEL_LOGIT_ROWS:]
        torch.save(logits.cpu(), os.path.join(workdir, f"{job}.logits.pt"))
        del logits, cp, compare
    if job.startswith(("c_", "d_")) and mesh.rank == 0:
        ref = torch.load(os.path.join(workdir, "reference.pt"), mmap=True, weights_only=True)
        line["vs_one_rank"] = _stat_errors(calib, ref)
        if "ppl" in line:
            line["vs_one_rank"]["ppl"] = abs(line["ppl"] - ref["ppl"]) / ref["ppl"]
    with open(os.path.join(workdir, f"{job}.rank{mesh.rank}.json"), "w") as f:
        json.dump(line, f)
    dist.destroy_process_group()
    return 0


def _launch_parallel(jobs, workdir: str, during=None) -> dict:
    """Start every rank of ``jobs`` at once (this script,
    ``--parallel-rank``), call ``during()`` (this process's own work
    beside them) if given, wait for all of them (PARALLEL_TIMEOUT_S), and
    return each job's JSON lines with its launch seconds; a rank that
    fails, or a launch that runs out of time, fails the phase with every
    rank's log tail, and no rank is left running."""
    t0 = time.perf_counter()
    procs = []  # (job, rank, process, log)
    for job in jobs:
        shape, world, backend = PARALLEL_RUNS[job]
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MODEGPT_DISTRIBUTED="1",
                       MODEGPT_DIST_BACKEND=backend, MODEGPT_DIST_INIT_METHOD=f"file://{workdir}/{job}.rendezvous",
                       MODEGPT_DIST_TIMEOUT="300")
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank on this host
            log = os.path.join(workdir, f"{job}.rank{r}.log")
            with open(log, "w") as f:
                procs.append((job, r, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--parallel-rank", job, workdir],
                    env=env, stdout=f, stderr=subprocess.STDOUT,
                ), log))
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        if during is not None:
            during()
        for _, _, p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for _, _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(job, r, p.returncode, log) for job, r, p, log in procs if p.returncode]
    if failed:
        tails = "\n".join(f"--- {job} rank {r} (rc {rc}) ---\n" + open(log).read()[-4000:]
                          for job, r, rc, log in failed)
        raise AssertionError(f"parallel jobs {list(jobs)}: ranks failed\n{tails}")
    out = {job: [json.load(open(os.path.join(workdir, f"{job}.rank{r}.json"))) for r in range(PARALLEL_RUNS[job][1])]
           for job in jobs}
    for lines in out.values():
        lines[0]["launch_seconds"] = time.perf_counter() - t0
    return out


def _factor_distances(ref_dir: str, dirs: dict, spec) -> dict:
    """Factor stores of one job solved from Grams summed in other orders,
    each against the store at ``ref_dir``: selections (MLP indices,
    rotary masks) must be equal; every other factor's largest relative
    Frobenius distance over the layers, V/O as each head's o_h (v_g z)
    on 8 seeded probe vectors z (the SVD's per-head sign and basis cancel
    there), is reported. Float32 throughout: the distances are ~1e-3."""
    import numpy as np

    from modegpt_tpu_torch.compress.artifact import load_layer_factors

    H, Hk, d = spec.n_heads, spec.n_kv_heads, spec.d_model
    z = np.random.default_rng(0).standard_normal((d, 8)).astype(np.float32)

    def rel(x, y):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))

    def heads(f):
        v, o = np.asarray(f["v"], np.float32), np.asarray(f["o"], np.float32)
        r = v.shape[0] // Hk
        vz = (v @ z).reshape(Hk, r, -1)
        return np.stack([o.reshape(d, H, r)[:, h] @ vz[h // (H // Hk)] for h in range(H)])

    def layer(root, l):
        f = {s_: load_layer_factors(root, l, s_) for s_ in ("mlp", "qk", "vo")}
        return {"mlp.idx": f["mlp"]["idx"], "qk.rotary_mask": f["qk"]["rotary_mask"],
                **{f"mlp.{k}": np.asarray(f["mlp"][k], np.float32) for k in ("up", "gate", "down")},
                **{f"qk.{k}": np.asarray(f["qk"][k], np.float32) for k in ("q", "k")},
                "vo.o_h v_g z": heads(f["vo"])}

    out = {name: {"max_rel_fro": {}, "problems": []} for name in dirs}
    for l in range(spec.n_layers):
        ref = layer(ref_dir, l)
        for name, root in dirs.items():
            got, res = layer(root, l), out[name]
            for key, want in ref.items():
                if key in ("mlp.idx", "qk.rotary_mask"):
                    if not np.array_equal(got[key], want):
                        res["problems"].append(f"layer {l} {key} differs")
                else:
                    res["max_rel_fro"][key] = max(res["max_rel_fro"].get(key, 0.0), rel(got[key], want))
    return out


def _k1_holds(shape) -> dict:
    """K1 at one (B, H, Hk, T, hd, hd_v, dtype, window) shape against the
    plain attention on seeded inputs: its error and whether it is within
    TOLERANCE."""
    import torch

    from modegpt_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    B, H, Hk, T, hd, hd_v, dtype, w = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s_, generator=gen, device="cuda").to(dt)
               for s_ in ((B, H, T, hd), (B, Hk, T, hd), (B, Hk, T, hd_v)))
    got = flash_attention(q, k, v, scale=hd**-0.5, window=w).float()
    want = flash_attention_reference(q, k, v, scale=hd**-0.5, window=w).float()
    return {"shape": list(shape), "max_abs_err": float((got - want).abs().max()),
            "ok": bool(torch.allclose(got, want, **TOLERANCE[dtype])) and bool(torch.isfinite(got).all())}


def _parallel_reference(workdir: str) -> dict:
    """One-rank `calibrate` (every layer, float32 sums on the card, as
    the stages accumulate) and `compute_perplexity` on the card, saved
    for the stage and context jobs' rank 0 to compare with (3.3 GB)."""
    import torch

    from modegpt_tpu_torch.calib.engine import calibrate
    from modegpt_tpu_torch.evals.perplexity import compute_perplexity

    t0 = time.perf_counter()
    spec = _parallel_spec()
    batches, tokens = _parallel_data(spec)
    params = _tree_to(_parallel_params(spec), "cuda")
    calib = calibrate(spec, params, batches, range(PARALLEL_LAYERS), accumulate="device")
    ppl = compute_perplexity(spec, params, tokens, PARALLEL_JOB["eval_batch_size"], progress=False)
    del params
    ref = {field: {l: g.cpu() for l, g in getattr(calib, field).items()}
           for field in ("cov_mlp", "cov_q", "cov_k", "cov_x")}
    ref.update(bi=list(calib.bi_scores), ppl=ppl)
    torch.save(ref, os.path.join(workdir, "reference.pt"))
    del calib, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0, "ppl": ppl}


def phase_parallel(records: dict) -> dict:
    """The compression job on a process mesh (module docstring, phase 12):
    (a) the one-rank NCCL job, (b) the same job on data:2,model:2, (c)
    calibrate_pp and perplexity_pp on stage:4 and (d) calibrate_ring on
    context:2, each against one rank; then every K1 shape the ranks ran
    held against the plain attention."""
    import torch

    problems = []
    line = {"phase": "parallel", "model": "Meta-Llama-3-8B widths", "n_layers": PARALLEL_LAYERS,
            "card": card_line(), "jobs": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_parallel_") as tmp:
        # (a) and (a2) together (15 GiB each), then (b) alone (4 x 14 GiB)
        out = _launch_parallel(["a_nccl_data1", "a2_nccl_data1_reversed"], tmp)
        out.update(_launch_parallel(["b_gloo_data2_model2"], tmp))
        line["reference"] = _parallel_reference(tmp)

        def b_against_a():  # on the host, while (c) and (d) run
            a, b = out["a_nccl_data1"][0], out["b_gloo_data2_model2"]
            for r in b:
                if r["rank_lists"] != a["rank_lists"]:
                    problems.append(f"b rank {r['rank']}: rank lists differ from the one-rank job's")
                for key in ("baseline_ppl", "compressed_ppl"):
                    rel = abs(r[key] - a[key]) / a[key]
                    if not rel <= PARALLEL_PPL_TOL:
                        problems.append(f"b rank {r['rank']}: {key} {r[key]} vs {a[key]} ({rel:.2e})")
            a2 = out["a2_nccl_data1_reversed"][0]
            if a2["rank_lists"] != a["rank_lists"]:
                line["a2_rank_lists_differ"] = True  # reported: the noise floor is then not a floor
            dist = _factor_distances(a["store"], {"b": b[0]["store"], "a2": a2["store"]}, _parallel_spec())
            line["b_vs_a_factors"], line["a2_vs_a_factors"] = dist["b"], dist["a2"]
            problems.extend(f"b vs a: {p}" for p in line["b_vs_a_factors"]["problems"])
            la, la2, lb = (torch.load(os.path.join(tmp, f"{job}.logits.pt"))
                           for job in ("a_nccl_data1", "a2_nccl_data1_reversed", "b_gloo_data2_model2"))
            err, noise = float((lb - la).abs().max()), float((la2 - la).abs().max())
            ok = bool(torch.allclose(lb, la, **PARALLEL_LOGIT_TOL)) or err <= PARALLEL_NOISE_FACTOR * noise
            line["b_vs_a_logits"] = {"rows": list(la.shape[:2]), "max_abs_err": err, "max_abs": float(la.abs().max()),
                                     "a2_vs_a_max_abs_err": noise, "tolerance": PARALLEL_LOGIT_TOL,
                                     "noise_factor": PARALLEL_NOISE_FACTOR, "ok": ok}
            if not ok:
                problems.append(f"b vs a: compressed logits beyond {PARALLEL_LOGIT_TOL} and {PARALLEL_NOISE_FACTOR}x "
                                f"the reordered one-rank job's distance: {line['b_vs_a_logits']}")

        # (c) and (d) together: 6 ranks, peaks summing to ~50 GiB of the 80
        out.update(_launch_parallel(["c_gloo_stage4", "d_gloo_context2"], tmp, during=b_against_a))
        for job in ("c_gloo_stage4", "d_gloo_context2"):
            errs = out[job][0]["vs_one_rank"]
            bad = {k: v for k, v in errs.items() if not v <= PARALLEL_STAT_TOL}
            if bad:
                problems.append(f"{job}: beyond {PARALLEL_STAT_TOL} of one rank: {bad}")

    shapes = set()
    for job, ranks in out.items():
        for r in ranks:
            shapes.update(tuple(s) for s in r["k1_shapes"])
            if r["k1_launches"] != r["k1_expected"]:
                problems.append(f"{job} rank {r['rank']}: K1 launched {r['k1_launches']} times, "
                                f"expected {r['k1_expected']}")
        line["jobs"][job] = {
            "mesh": PARALLEL_RUNS[job][0], "backend": ranks[0]["backend"],
            "launch_seconds": ranks[0]["launch_seconds"],
            "ranks": [{k: r.get(k) for k in ("rank", "coords", "device", "setup_seconds", "seconds", "comm_seconds",
                                             "comm_bytes", "max_memory_allocated", "k1_launches", "k1_expected")}
                      for r in ranks],
            **{k: ranks[0][k] for k in ("baseline_ppl", "compressed_ppl", "rank_lists", "step_seconds", "ppl",
                                        "vs_one_rank") if k in ranks[0]},
        }
    # every K1 shape of the phase held against the plain attention: the
    # kernel phase's cases (timed there), and the compressed evaluation's
    # unrolled widths, which vary with the ranks (held here, untimed)
    known = {(c["B"], c["H"], c["Hk"], c["T"], c["hd"], c["hd_v"], c["dtype"], c["window"]) for c in KERNEL_CASES}
    held = [_k1_holds(s_) for s_ in sorted(shapes, key=str) if s_ not in known]
    line["k1_shapes"] = {"total": len(shapes), "kernel_cases": len(shapes) - len(held), "held_here": held}
    problems += [f"K1 at {c['shape']} disagrees with the plain attention" for c in held if not c["ok"]]
    launches = sum(r["k1_launches"] for ranks in out.values() for r in ranks)
    records["flash_attention"]["launches_by_phase"]["parallel"] = launches
    line.update(k1_launches=launches, seconds=time.perf_counter() - t_phase)
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


# The tpserve phase: tensor- and expert-parallel serving on data:1,model:2,
# two ranks (processes of this script, ``--parallel-rank tpserve``) on
# cuda:0 over gloo, asked for explicitly, beside one-rank references that
# the parent computes meanwhile; then the server CLI with
# --tensor_parallel 2 on two ranks against the one-process server.
TPSERVE = dict(
    mesh="data:1,model:2", moe_requests=4, step_prompt=128, logit_tol=dict(rtol=1e-3, atol=1e-3),
    near_tie=1e-3, server_requests=8, server_prompt=192, server_new_tokens=16, server_lp_tol=1e-4,
    server_timeout=600, guided_regex="(yes|no)[0-9]{2,4}", logit_bias={"500": 5.0, "1000": 5.0, "7": -100.0},
)
# (e): the main artifact's rounds, both in batched prefill with fused decode
TPSERVE_ROUNDS = {
    "f32": dict(prefill_exec="batched", steps_per_dispatch=4),
    "int8_w8a8_kv8": dict(prefill_exec="batched", steps_per_dispatch=4, a8_prefill=True, kv_dtype="int8"),
}


def _k3_shapes():
    """Record the shape of every K3 call the padded layers make (their
    ``_CACHE_ATTENTION["ragged"]`` entry), keyed as `_k3_case_key` keys
    RAGGED_CASES; a context manager yielding the set."""
    from modegpt_tpu_torch.models import padded

    shapes = set()
    kernel = padded._CACHE_ATTENTION["ragged"]

    def recorded(q, k, v, pos, k_scale=None, v_scale=None, window=None, softcap=None):
        B, H, S, Rq = q.shape
        shapes.add((B, H, k.shape[1], k.shape[2], S, Rq, v.shape[-1], str(q.dtype).split(".")[-1],
                    window or None, softcap, k_scale is not None))
        return kernel(q, k, v, pos, k_scale=k_scale, v_scale=v_scale, window=window, softcap=softcap)

    @contextlib.contextmanager
    def swapped():
        padded._CACHE_ATTENTION["ragged"] = recorded
        try:
            yield shapes
        finally:
            padded._CACHE_ATTENTION["ragged"] = kernel

    return swapped()


def _k3_case_key(case) -> tuple:
    return (case["B"], case["H"], case["Hk"], case["T"], case["S"], case["Rq"], case["Rv"], case["dtype"],
            case["window"], case["softcap"], case["int8"])


def _k3_holds(shape) -> dict:
    """K3 at one recorded shape against its plain version on seeded
    inputs (a row past the pool's end when B > 1)."""
    import numpy as np
    import torch

    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend, ragged_gqa_attend_reference

    B, H, Hk, T, S, Rq, Rv, dtype, w, cap, int8 = shape
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    q = torch.from_numpy((rng.standard_normal((B, H, S, Rq)) * Rq**-0.5).astype(np.float32)).cuda().to(dt)
    ks = vs = None
    if int8:
        k = torch.from_numpy(rng.integers(-127, 128, (B, Hk, T, Rq), dtype=np.int8)).cuda()
        v = torch.from_numpy(rng.integers(-127, 128, (B, Hk, T, Rv), dtype=np.int8)).cuda()
        ks, vs = (torch.from_numpy(rng.uniform(0.5, 1.5, (B, Hk, T)).astype(np.float32) / 127).cuda()
                  for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.standard_normal(s_).astype(np.float32)).cuda().to(dt)
                for s_ in ((B, Hk, T, Rq), (B, Hk, T, Rv)))
    pos_host = rng.integers(0, T, size=B)
    if B > 1:
        pos_host[-1] = T + 3
    pos = torch.tensor(pos_host, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, window=w, softcap=cap)
    got = ragged_gqa_attend(q, k, v, pos, **kw).float()
    want = ragged_gqa_attend_reference(q, k, v, pos, **kw).float()
    return {"shape": list(shape), "max_abs_err": float((got - want).abs().max()),
            "ok": bool(torch.allclose(got, want, **TOLERANCE[dtype])) and bool(torch.isfinite(got).all())}


def _tpserve_moe_model():
    """The moe phase's seeded Qwen3-30B-A3B-width weights (MOE_LAYERS),
    uncompressed and padded, on the card."""
    import torch

    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(SimpleNamespace(**{**QWEN3_30B_A3B, "num_hidden_layers": MOE_LAYERS}))
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    pm = pad_to_uniform(spec, params)
    del params
    return pm


def _tp_round(name: str, model, prompts, mesh, out: dict, **round_kw) -> None:
    """One serve round of `prompts` (greedy, the serve phase's pool) on
    `mesh` (None: one rank) into out[name]: tokens, time, dispatches, K3
    launches with what the dispatches give, collectives, peak."""
    import torch

    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    comm0 = (mesh.comm_seconds, mesh.comm_bytes) if mesh is not None else (0.0, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rd_mod.ragged_gqa_attend.launches = 0
    with _counted_dispatches() as (counts, seconds):
        b = serving.ContinuousBatcher(model, mesh=mesh, slots=SERVE["slots"], max_len=SERVE["max_len"],
                                      prefill_bucket=SERVE["prefill_bucket"], temperature=0.0, decode_attn="auto",
                                      **round_kw)
        done, rids, wall = _serve_round(b, prompts, gen)
    n_new = sum(len(done[r]) - len(p) for r, p in zip(rids, prompts))
    out[name] = {
        "tokens": [list(map(int, done[r])) for r in rids], "decode_attn": b.decode_attn,
        "wall_seconds": wall, "generated_tokens_per_s": n_new / wall,
        "dispatches": {k: v for k, v in counts.items() if v},
        "dispatch_ms": {k: 1e3 * seconds[k] / counts[k] for k in seconds if counts[k]},
        "k3_launches": rd_mod.ragged_gqa_attend.launches, "k3_expected": counts["layer_dispatches"],
        "pool_kv_heads": int(b.state.cache_k.shape[2]), "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    if mesh is not None:
        out[name].update(comm_seconds=mesh.comm_seconds - comm0[0], comm_bytes=mesh.comm_bytes - comm0[1])
    del b


def _tp_llama_rounds(pm, mesh):
    """(e): the main artifact's f32 and int8 (W8A8 prefill, int8 KV)
    rounds of the serve phase's 16 requests, then one padded prefill step
    (the first prompt's first 128 tokens) and one decode step from an
    empty one-slot pool. Returns (rounds, the steps' last logits rows)."""
    import torch

    from modegpt_tpu_torch.kernels import ragged_decode as rd_mod
    from modegpt_tpu_torch.models import serving
    from modegpt_tpu_torch.models.padded import _model_step_padded
    from modegpt_tpu_torch.models.quantize import quantize_padded
    from modegpt_tpu_torch.parallel.mesh import shard_serving

    out = {}
    prompts, _ = _serve_prompts(pm.spec.vocab_size, SERVE["requests"])
    _tp_round("f32", pm, prompts, mesh, out, **TPSERVE_ROUNDS["f32"])
    _tp_round("int8_w8a8_kv8", quantize_padded(pm), prompts, mesh, out, **TPSERVE_ROUNDS["int8_w8a8_kv8"])

    st_pm, state = pm, serving.init_serve_state(pm, 1, SERVE["max_len"])
    if mesh is not None:
        st_pm, state = shard_serving(mesh, pm, state)
    P = TPSERVE["step_prompt"]
    ids = torch.as_tensor(prompts[0][:P], device="cuda")[None]
    rd_mod.ragged_gqa_attend.launches = 0
    with torch.no_grad():
        lp, _ = _model_step_padded(st_pm.spec, st_pm.layers, st_pm.other, st_pm.q_hd_true, ids, state.cache_k,
                                   state.cache_v, 0, decode_attn="ragged", logits_at=P - 1, mesh=st_pm.mesh)
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        ld, _ = _model_step_padded(st_pm.spec, st_pm.layers, st_pm.other, st_pm.q_hd_true, nxt, state.cache_k,
                                   state.cache_v, P, decode_attn="ragged", mesh=st_pm.mesh)
    out["steps"] = {"k3_launches": rd_mod.ragged_gqa_attend.launches, "k3_expected": 2 * pm.spec.n_layers}
    return out, {"prefill": lp[0, -1].float().cpu(), "decode": ld[0, -1].float().cpu()}


def _tp_moe_rounds(moe_pm, mesh) -> dict:
    """(f): the MoE stack's rounds, every expert on every token and by
    dispatch at E / k (nothing dropped), TPSERVE["moe_requests"] requests."""
    out = {}
    capacity = moe_pm.spec.n_experts / moe_pm.spec.experts_per_tok
    prompts, _ = _serve_prompts(moe_pm.spec.vocab_size, TPSERVE["moe_requests"])
    for moe in ("dense", "dispatch"):
        _tp_round(f"moe_{moe}", moe_pm, prompts, mesh, out, moe=moe, moe_capacity=capacity)
    return out


def tpserve_rank(workdir: str) -> int:
    """One rank of the tpserve phase (``--parallel-rank tpserve``): (e)
    and (f) on data:1,model:2; writes ``<workdir>/tpserve.rank<r>.json``
    and its steps' logits rows."""
    import torch
    import torch.distributed as dist

    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    t_start = time.perf_counter()
    assert maybe_initialize_distributed("cuda"), "not launched as a rank"
    mesh = make_mesh(TPSERVE["mesh"], device="cuda")
    artifact = json.load(open(os.path.join(workdir, "tpserve_inputs.json")))["artifact_dir"]
    cspec, cparams, _ = load_compressed_model(artifact, device="cuda")
    pm = pad_to_uniform(cspec, cparams)
    del cparams
    line = {"rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend, "device": str(mesh.device)}
    with _k3_shapes() as shapes:
        line["setup_seconds"] = time.perf_counter() - t_start
        rounds, logits = _tp_llama_rounds(pm, mesh)
        del pm
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        moe_pm = _tpserve_moe_model()
        line["moe_setup_seconds"] = time.perf_counter() - t0
        rounds.update(_tp_moe_rounds(moe_pm, mesh))
    line.update(rounds=rounds, seconds=time.perf_counter() - t_start, comm_seconds=mesh.comm_seconds,
                comm_bytes=mesh.comm_bytes, k3_shapes=sorted(shapes, key=str))
    torch.save(logits, os.path.join(workdir, f"tpserve.rank{mesh.rank}.logits.pt"))
    with open(os.path.join(workdir, f"tpserve.rank{mesh.rank}.json"), "w") as f:
        json.dump(line, f)
    dist.destroy_process_group()
    return 0


def _first_divergence(got, want, logits_of, P: int):
    """Where two greedy sequences of one prompt part: None when equal,
    else (index, |gap| between the two tokens in the reference model's
    logits at that step, from ``logits_of(ids [1, T]) -> [1, T, V]`` over
    the reference sequence)."""
    import torch

    if got == want:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    if j < P or j >= min(len(got), len(want)):
        return (j, float("inf"))
    with torch.no_grad():
        row = logits_of(torch.tensor([want[:j]], device="cuda"))[0, -1].float()
    return (j, float((row[want[j]] - row[got[j]]).abs()))


def _start_tp_server(workdir: str, artifact: str) -> dict:
    """(g), started: ``python -m modegpt_tpu_torch.server
    --tensor_parallel 2`` on two ranks (gloo, sharing cuda:0) on
    `artifact` (its padded MLP width must split in two, or shard_serving
    raises, as JAX's does), each loading and padding it on its card."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = ["--slots", str(SERVE["slots"]), "--max_len", str(SERVE["max_len"]), "--prefill_bucket",
             str(SERVE["prefill_bucket"])]
    procs, logs, t0 = [], [], time.perf_counter()
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), MODEGPT_DISTRIBUTED="1",
                   MODEGPT_DIST_BACKEND="gloo", MODEGPT_DIST_INIT_METHOD=f"file://{workdir}/server.rendezvous",
                   MODEGPT_DIST_TIMEOUT="300", PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        logs.append(os.path.join(workdir, f"server.rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "modegpt_tpu_torch.server", "--model", artifact, "--port", str(port),
                 "--tensor_parallel", "2", *flags], cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
    return {"procs": procs, "logs": logs, "port": port, "t0": t0, "artifact": artifact}


def _stop(procs) -> None:
    """Kill every process of `procs` still running, and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _tpserve_server(main_out: dict, started: dict, tok) -> dict:
    """(g), checked: the one-process server in this process on the main
    model and the two ranks `_start_tp_server` started each take 8
    concurrent completions (greedy, seeded sampled, some with logprobs);
    every answer's JSON equal (ids aside, logprobs within server_lp_tol);
    SIGINT on rank 0 ends both ranks."""
    import signal
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from modegpt_tpu_torch import server as server_mod
    from modegpt_tpu_torch.models import serving

    procs, logs, port, t0, artifact = (started[k] for k in ("procs", "logs", "port", "t0", "artifact"))
    one = server_mod.InferenceServer(
        serving.ContinuousBatcher(main_out["pm"], slots=SERVE["slots"], max_len=SERVE["max_len"],
                                  prefill_bucket=SERVE["prefill_bucket"], prefill_exec="batched",
                                  per_request_sampling=True, eos_token_id=tok.eos_token_id, decode_attn="auto"),
        tokenizer=tok, model_id=artifact)
    httpd = server_mod.make_http_server(one, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    prompts, _ = _serve_prompts(main_out["spec"].vocab_size, TPSERVE["server_requests"])
    n = TPSERVE["server_new_tokens"]
    bodies = []
    for i, p in enumerate(prompts):
        body = {"prompt_ids": [int(t) for t in p[: TPSERVE["server_prompt"]]], "max_tokens": n}
        if i % 2:  # top_k: a near-uniform random model's draw over every token would follow its 1e-5 noise
            body.update(temperature=0.8, top_k=20, seed=100 + i)
        if i % 4 == 0:
            body.update(logprobs=True, top_logprobs=3)
        bodies.append(body)
    out = {"port": port, "requests": len(bodies), "max_tokens": n, "problems": []}

    def post(port_no, body):
        status, data, _ = _http(port_no, "POST", "/v1/completions", body)
        return status, json.loads(data)

    try:
        while True:
            dead = [r for r, p in enumerate(procs) if p.poll() is not None]
            if dead:
                out["problems"].append(f"server ranks {dead} exited: " + open(logs[dead[0]]).read()[-1500:])
                return out
            if time.perf_counter() - t0 > TPSERVE["server_timeout"]:
                out["problems"].append("the tensor-parallel server never answered /health")
                return out
            try:
                status, data, _ = _http(port, "GET", "/health", timeout=10)
                break
            except OSError:
                time.sleep(0.5)
        out["ready_seconds"] = time.perf_counter() - t0
        with ThreadPoolExecutor(len(bodies)) as pool:
            t1 = time.perf_counter()
            got = list(pool.map(lambda b: post(port, b), bodies))
            out["tp_seconds"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            want = list(pool.map(lambda b: post(httpd.server_address[1], b), bodies))
            out["one_process_seconds"] = time.perf_counter() - t1
        out["tp_generated_tokens_per_s"] = len(bodies) * n / out["tp_seconds"]
        out["one_process_generated_tokens_per_s"] = len(bodies) * n / out["one_process_seconds"]
        lp_err = 0.0
        for i, ((gs, g), (ws, w)) in enumerate(zip(got, want)):
            if gs != 200 or ws != 200:
                out["problems"].append(f"request {i}: status {gs} / {ws}")
                continue
            diff = _answers_differ(g, w)
            if diff == float("inf"):
                out["problems"].append(f"request {i}: the TP answer differs from the one-process server's")
            else:
                lp_err = max(lp_err, diff)
        out["logprob_max_abs_diff"] = lp_err
        if lp_err > TPSERVE["server_lp_tol"]:
            out["problems"].append(f"logprobs differ by {lp_err}")
        out["kinds"] = _tp_request_kinds(port, httpd.server_address[1], bodies[0], tok)
        out["problems"] += out["kinds"].pop("problems")
    finally:
        httpd.shutdown()
        one.close()
        procs[0].send_signal(signal.SIGINT)
        try:
            for p in procs:
                p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            out["problems"].append("a server rank did not stop after SIGINT on rank 0")
        _stop(procs)
        out["rank_exit_codes"] = [p.returncode for p in procs]
        out["seconds"] = time.perf_counter() - t0
    if any(out["rank_exit_codes"]):
        out["problems"].append(f"server ranks exited {out['rank_exit_codes']}: " + open(logs[1]).read()[-1500:])
    return out


def _answers_differ(got: dict, want: dict) -> float:
    """How far two completion answers part: inf where they differ as JSON
    (ids and `logprobs` aside), else the largest difference of their
    choices' token logprobs (0.0 without any)."""
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))  # copies
    lps = []
    for d in (got, want):
        d.pop("id", None)
        lps.append([(c.pop("logprobs", None) or {}).get("token_logprobs", []) for c in d["choices"]])
    if got != want or [len(a) for a in lps[0]] != [len(b) for b in lps[1]]:
        return float("inf")
    return max((abs(x - y) for a, b in zip(*lps) for x, y in zip(a, b)), default=0.0)


def _answers_equal(got: dict, want: dict) -> bool:
    """Two completion answers equal, ids aside, logprobs within
    server_lp_tol."""
    return _answers_differ(got, want) <= TPSERVE["server_lp_tol"]


def _tp_request_kinds(port: int, one_port: int, greedy: dict, tok) -> dict:
    """(g), the request kinds whose fields cross from rank 0 to the
    follower with each submit (a guided choice and regex: the guide is
    pickled to it; a logit bias), a stream of the greedy request
    `greedy`, and a cancel: each to the two ranks and to the one-process
    server on `one_port`. The guided outputs in their grammar and every
    answer the one-process server's; the stream's deltas concatenate to
    its answer to `greedy`; a long stream cancelled after its first event
    ends, rank 0 counts the cancel, and `greedy` sent after it still
    answers the same, so the follower applied the cancel in the same
    round."""
    import http.client

    from modegpt_tpu_torch.models import guided

    def post(port_no, body):
        status, data, _ = _http(port_no, "POST", "/v1/completions", body)
        return status, json.loads(data)

    out, problems = {}, []
    prompt = greedy["prompt_ids"][:64]
    kinds = {
        "guided_choice": {"prompt_ids": prompt, "max_tokens": 8, "guided_choice": SERVER["choices"]},
        "guided_regex": {"prompt_ids": prompt, "max_tokens": 12, "guided_regex": TPSERVE["guided_regex"]},
        "logit_bias": {"prompt_ids": prompt, "max_tokens": TPSERVE["server_new_tokens"],
                       "logit_bias": TPSERVE["logit_bias"]},
    }
    token_bytes = guided.token_bytes_from_tokenizer(tok)
    for name, body in kinds.items():
        (gs, g), (ws, w) = post(port, body), post(one_port, body)
        ids = g["choices"][0]["token_ids"] if gs == 200 else []
        out[name] = {"status": gs, "tokens": ids, "equal_one_process": gs == ws == 200 and _answers_equal(g, w)}
        if not out[name]["equal_one_process"]:
            problems.append(f"{name}: the TP answer differs from the one-process server's ({gs}, {ws})")
        if name.startswith("guided"):
            text = b"".join(token_bytes[t] for t in ids[:-1]).decode(errors="replace")
            pattern = guided.regex_for_choice(SERVER["choices"]) if name == "guided_choice" else body["guided_regex"]
            out[name]["text"] = text
            if not ids or ids[-1] != tok.eos_token_id or not guided.compile_charset(pattern).fullmatch(text.encode()):
                problems.append(f"{name}: {text!r} is not in its grammar")

    ws, want = post(one_port, greedy)
    choice = want["choices"][0]
    status, data, first = _http(port, "POST", "/v1/completions", {**greedy, "stream": True})
    events = _sse(data)
    streamed_lp = [x for e in events for x in e.get("logprobs", [])]
    out["stream"] = {"status": status, "events": len(events), "seconds_to_first_event": first,
                     "tokens_equal": [t for e in events for t in e["token_ids"]] == choice["token_ids"],
                     "text_equal": "".join(e.get("text", "") for e in events) == choice["text"],
                     "logprob_max_abs_diff": max((abs(a - b) for a, b in zip(
                         streamed_lp, choice["logprobs"]["token_logprobs"])), default=0.0),
                     "done": data.rstrip().endswith(b"data: [DONE]")}
    st = out["stream"]
    if not (status == ws == 200 and st["tokens_equal"] and st["text_equal"] and st["done"]
            and len(streamed_lp) == len(choice["token_ids"]) and st["logprob_max_abs_diff"] <= TPSERVE["server_lp_tol"]):
        problems.append(f"stream: {st}")

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TPSERVE["server_timeout"])
    conn.request("POST", "/v1/completions", body=json.dumps({"prompt_ids": prompt, "max_tokens": SERVER["cancel_tokens"],
                                                             "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    head = _sse(resp.readline() + resp.readline())
    status, data, _ = _http(port, "POST", "/v1/cancel", {"id": head[0]["id"] if head else "cmpl-?"})
    rest = resp.read()
    conn.close()
    metrics = dict(ln.split() for ln in _http(port, "GET", "/metrics")[1].decode().splitlines()
                   if not ln.startswith("#"))
    after_status, after = post(port, greedy)
    out["cancel"] = c = {
        "status": status, "reply": json.loads(data), "stream_done": rest.rstrip().endswith(b"data: [DONE]"),
        "tokens_streamed": sum(len(e["token_ids"]) for e in head + _sse(rest)),
        "requests_cancelled_rank0": float(metrics.get("modegpt_requests_cancelled_total", 0)),
        "after_equal_one_process": after_status == 200 and _answers_equal(after, want),
    }
    if not (status == 200 and c["reply"].get("cancelled") and c["stream_done"]
            and c["tokens_streamed"] < SERVER["cancel_tokens"] and c["requests_cancelled_rank0"] >= 1
            and c["after_equal_one_process"]):
        problems.append(f"cancel: {c}")
    out["problems"] = problems
    return out


def phase_tpserve(records: dict, main_out: dict) -> dict:
    """Tensor- and expert-parallel serving (module docstring, phase 13):
    (e) the main artifact on data:1,model:2 and (f) the MoE stack, on two
    ranks beside the same rounds on one rank in this process; tokens
    equal but at near-ties, the steps' logits within 1e-3, K3's launches
    as counted on each rank and every K3 shape the ranks ran held against
    its plain version; then (g) the server CLI with --tensor_parallel 2."""
    import torch

    from modegpt_tpu_torch.models.forward import forward
    from modegpt_tpu_torch.models.padded import _model_step_padded, forward_padded
    from modegpt_tpu_torch.models.quantize import quantize_padded

    t_phase = time.perf_counter()
    problems = []
    line = {"phase": "tpserve", "mesh": TPSERVE["mesh"], "backend": "gloo", "card": card_line(),
            "model": "main artifact (Meta-Llama-3-8B widths, 4 layers); Qwen3-30B-A3B widths, 1 layer"}
    cspec, cparams, pm = main_out["spec"], main_out["params"], main_out["pm"]
    tok = _full_vocab_tokenizer(cspec.vocab_size)
    if not os.path.exists(os.path.join(main_out["artifact_dir"], "tokenizer.json")):
        tok.save_pretrained(main_out["artifact_dir"])
    with tempfile.TemporaryDirectory(prefix="modegpt_smoke_tpserve_") as tmp:
        # (g)'s ranks load and pad the artifact while (e) and (f) run
        server = _start_tp_server(tmp, main_out["artifact_dir"])
        try:
            with open(os.path.join(tmp, "tpserve_inputs.json"), "w") as f:
                json.dump({"artifact_dir": main_out["artifact_dir"]}, f)
            ref = {}

            def one_rank():
                t0 = time.perf_counter()
                ref["rounds"], ref["logits"] = _tp_llama_rounds(pm, None)
                ref["moe_pm"] = _tpserve_moe_model()
                ref["rounds"].update(_tp_moe_rounds(ref["moe_pm"], None))
                ref["seconds"] = time.perf_counter() - t0

            ranks = _launch_parallel(["tpserve"], tmp, during=one_rank)["tpserve"]
            logits = [torch.load(os.path.join(tmp, f"tpserve.rank{r}.logits.pt")) for r in range(2)]
            moe_pm = ref.pop("moe_pm")
            prompts, _ = _serve_prompts(cspec.vocab_size, SERVE["requests"])
            moe_prompts, _ = _serve_prompts(moe_pm.spec.vocab_size, TPSERVE["moe_requests"])
            pm8 = quantize_padded(pm)

            def int8_logits(ids):  # the int8 round's model over a sequence into an int8 cache (plain attention)
                from modegpt_tpu_torch.models import serving

                st = serving.init_serve_state(pm8, 1, ids.shape[1], kv_dtype="int8")
                return _model_step_padded(pm8.spec, pm8.layers, pm8.other, pm8.q_hd_true, ids, st.cache_k,
                                          st.cache_v, 0, cache_scales=st.scales)[0]

            logits_of = {
                "f32": lambda ids: forward(cspec, cparams, ids)[0],
                "int8_w8a8_kv8": int8_logits,
                "moe_dense": lambda ids: forward_padded(moe_pm.spec, moe_pm.layers, moe_pm.other, moe_pm.q_hd_true,
                                                        ids, attn_impl="xla"),
            }
            logits_of["moe_dispatch"] = logits_of["moe_dense"]
            rounds = {}
            for name, want in ref["rounds"].items():
                if name == "steps":
                    continue
                got = ranks[0]["rounds"][name]
                ps = moe_prompts if name.startswith("moe") else prompts
                ties, diverged = [], []
                for i, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
                    d = _first_divergence(g, w, logits_of[name], len(ps[i]))
                    if d is not None:
                        (ties if d[1] <= TPSERVE["near_tie"] else diverged).append({"request": i, "at": d[0],
                                                                                    "gap": d[1]})
                rounds[name] = {
                    "tp": {k: [r["rounds"][name][k] for r in ranks] for k in (
                        "generated_tokens_per_s", "wall_seconds", "dispatch_ms", "dispatches", "k3_launches",
                        "k3_expected", "comm_seconds", "comm_bytes", "peak_device_bytes", "pool_kv_heads")},
                    "one_rank": {k: want[k] for k in ("generated_tokens_per_s", "dispatch_ms", "k3_launches",
                                                      "peak_device_bytes")},
                    "near_tie_divergences": ties, "divergences": diverged,
                }
                if diverged:
                    problems.append(f"{name}: TP tokens part from one rank's beyond a near-tie: {diverged}")
                if any(r["rounds"][name]["tokens"] != got["tokens"] for r in ranks):
                    problems.append(f"{name}: the ranks served different tokens")
                for r in ranks:
                    rr = r["rounds"][name]
                    if rr["k3_launches"] != rr["k3_expected"] or rr["decode_attn"] != "ragged":
                        problems.append(f"{name} rank {r['rank']}: K3 launched {rr['k3_launches']} times, expected "
                                        f"{rr['k3_expected']} ({rr['decode_attn']})")
            line["rounds"] = rounds
            steps = {}
            for key in ("prefill", "decode"):
                a, b = logits[0][key], ref["logits"][key]
                steps[key] = {"max_abs_err": float((a - b).abs().max()), "max_abs": float(b.abs().max()),
                              "ranks_equal": bool(torch.equal(logits[0][key], logits[1][key]))}
                if not torch.allclose(a, b, **TPSERVE["logit_tol"]) or not steps[key]["ranks_equal"]:
                    problems.append(f"{key} step logits: TP vs one rank {steps[key]}")
            line["steps"] = steps
            for r in ranks:
                if r["rounds"]["steps"]["k3_launches"] != r["rounds"]["steps"]["k3_expected"]:
                    problems.append(f"rank {r['rank']}: the steps launched K3 {r['rounds']['steps']['k3_launches']} "
                                    f"times, expected {r['rounds']['steps']['k3_expected']}")
            line["ranks"] = [{k: r[k] for k in ("rank", "coords", "device", "setup_seconds", "moe_setup_seconds",
                                                "seconds", "comm_seconds", "comm_bytes", "launch_seconds")
                              if k in r} for r in ranks]
            line["one_rank_seconds"] = ref["seconds"]
            del moe_pm, pm8, logits_of
            gc.collect()
            torch.cuda.empty_cache()

            # every K3 shape the ranks ran: a timed kernel case, or held here
            shapes = {tuple(s) for r in ranks for s in r["k3_shapes"]}
            known = {_k3_case_key(c) for c in RAGGED_CASES}
            held = [_k3_holds(s) for s in sorted(shapes, key=str) if s not in known]
            line["k3_shapes"] = {"total": len(shapes), "kernel_cases": len(shapes) - len(held), "held_here": held}
            problems += [f"K3 at {c['shape']} disagrees with its plain version" for c in held if not c["ok"]]
            line["server"] = _tpserve_server(main_out, server, tok)
        finally:
            _stop(server["procs"])  # whatever is still running when a check above raised
        problems += [f"server: {p}" for p in line["server"].pop("problems")]
    launches = sum(r["rounds"][name]["k3_launches"] for r in ranks for name in rounds)
    records["ragged_gqa_attend"]["launches_by_phase"]["tpserve"] = launches
    line.update(k3_launches=launches, seconds=time.perf_counter() - t_phase)
    emit(line)
    if problems:
        raise AssertionError("; ".join(problems))
    return line


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernel,main,serve,sched,server,stream,cli,quant,tpserve,moe,long,archs,opt,big,"
                    "parallel")
    ap.add_argument("--profile", action="store_true",
                    help="trace the main job, the serve round, the quant phase's int8 rounds, the moe "
                    "job, the long job and the archs job with torch.profiler; print their device busy time")
    ap.add_argument("--parallel-rank", nargs=2, metavar=("JOB", "WORKDIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    # every model and tokenizer here is local or made in code: never ask the hub
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import modegpt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the modegpt_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2
    if args.parallel_rank:  # one rank of the parallel phase's jobs
        return parallel_rank(*args.parallel_rank)

    print(f"chip_smoke: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", file=sys.stderr)
    records: dict = {}
    if "build" in phases:
        emit(phase_build())
    if "kernel" in phases:
        phase_kernel(records)
    if {"main", "serve", "sched", "server", "stream", "cli", "quant", "tpserve", "moe", "long", "archs", "opt",
            "big", "parallel"} & set(phases) and "kernel" not in phases:
        raise SystemExit("chip_smoke: the main, serve, sched, server, stream, cli, quant, tpserve, moe, long, "
                         "archs, opt, big and parallel phases need the kernel phase's records")
    if {"main", "serve", "sched", "server", "stream", "cli", "quant", "tpserve"} & set(phases):
        main_out = phase_main(records, args.profile,
                              keep_artifact=bool({"server", "stream", "cli", "tpserve"} & set(phases)))
        try:
            if "serve" in phases:
                phase_serve(records, main_out, args.profile)
            if "sched" in phases:
                torch.cuda.empty_cache()
                phase_sched(records, main_out)
            if "server" in phases:
                torch.cuda.empty_cache()
                phase_server(records, main_out)
            if "stream" in phases:
                torch.cuda.empty_cache()
                phase_stream(records, main_out)
            if "cli" in phases:
                gc.collect()
                torch.cuda.empty_cache()
                phase_cli(records, main_out)
            if "quant" in phases:
                torch.cuda.empty_cache()
                phase_quant(records, main_out, args.profile)
            if "tpserve" in phases:
                gc.collect()
                torch.cuda.empty_cache()
                phase_tpserve(records, main_out)
        finally:
            if main_out["tmp"]:
                shutil.rmtree(main_out["tmp"], ignore_errors=True)
        del main_out
    if "moe" in phases:
        torch.cuda.empty_cache()
        phase_moe(records, args.profile)
    if "long" in phases:
        phase_long(records, args.profile)
    if "archs" in phases:
        torch.cuda.empty_cache()
        phase_archs(records, args.profile)
    if "opt" in phases:
        torch.cuda.empty_cache()
        phase_opt(records)
    if "big" in phases:
        torch.cuda.empty_cache()
        phase_big(records, args.profile)
    if "parallel" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_parallel(records)
    for rec in records.values():  # each path's launches, read just after it ran
        rec["launches"] = sum(rec["launches_by_phase"].values())
    emit({"kernels": list(records.values())})
    print(card_line(), flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
