"""Serving CLI: continuous-batched generation over a compressed artifact.

    python -m modegpt_tpu_torch.serve --model <artifact-or-hf-dir> \
        --prompts prompts.txt --max_new_tokens 64 --slots 8 [--device cpu]

Takes the flags of ``python -m modegpt_tpu.serve``, plus ``--device`` (a
torch device: "cuda" by default, "cuda:N", N, or "cpu"). Reads one
prompt per line (or repeated --prompt flags), serves them all through
the slot-table continuous batcher (`models.serving`) on the padded stack,
and prints one JSON line per completion plus a throughput summary on
stderr. ``--model`` (and ``--draft_model``) is an artifact directory
written by either package's compression, or a dense HF checkpoint
directory, loaded as the eval CLI loads it (`evals.cli._load_any`); the
tokenizer comes from the directory (or the source an artifact names).

A MoE artifact serves with every expert on every token (``--moe_exec
dense``) or by capacity-based token dispatch (``--moe_exec dispatch``
at ``--moe_capacity``). ``--quantize_int8`` quantises the padded model's
projections to int8 weights (`models.quantize.quantize_padded`), and
``--a8_prefill`` then runs the prefill dispatches W8A8.
``--prefill_exec batched`` prefills every admitting slot in one dispatch
a round, ``--steps_per_dispatch N`` fuses N decode steps,
``--prefix_cache`` adopts shared prompt prefixes, and ``--spec_decode``
(``prompt_lookup``, or ``draft`` with ``--draft_model``, ``--n_draft``
tokens a round) serves speculatively. ``--compress_ratio`` compresses a
dense ``--model`` in memory first (`compress.pipeline.compress_in_memory`
on ``--compress_dataset``, ``--compress_calib_size`` sequences of
``--compress_seq_len`` tokens, solving in float32 on the device), so a
dense target can serve with its compressed child as the draft. Every
flag of the JAX serve CLI is ported: none raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="modegpt-tpu-torch-serve")
    p.add_argument("--model", required=True, help="artifact dir or HF checkpoint dir")
    p.add_argument("--prompts", default="", help="file with one prompt per line")
    p.add_argument("--prompt", action="append", default=[], help="inline prompt (repeatable)")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--prefill_bucket", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8-resident projection weights (per-out-channel scales)")
    p.add_argument("--moe_exec", choices=("dense", "dispatch"), default="dense")
    p.add_argument("--moe_capacity", type=float, default=2.0)
    p.add_argument("--kv_dtype", choices=("model", "int8"), default="model",
                   help="KV cache residency: 'int8' stores codes plus per-vector scales")
    p.add_argument("--spec_decode", choices=("off", "prompt_lookup", "draft"), default="off")
    p.add_argument("--n_draft", type=int, default=4)
    p.add_argument("--lookup_ngram", type=int, default=3)
    p.add_argument("--draft_model", default="")
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--prefix_cache", action="store_true")
    p.add_argument("--prefill_exec", choices=("per_slot", "batched"), default="per_slot")
    p.add_argument("--a8_prefill", action="store_true",
                   help="W8A8 prefill (per-token int8 activations) on an int8 model")
    p.add_argument("--compress_ratio", type=float, default=None,
                   help="compress the dense --model in memory at this ratio before serving")
    p.add_argument("--compress_dataset", default="wikitext")
    p.add_argument("--compress_calib_size", type=int, default=32)
    p.add_argument("--compress_seq_len", type=int, default=2048)
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N, N or cpu")
    return p


def main(argv=None):
    from modegpt_tpu_torch.utils.device import resolve_device
    from modegpt_tpu_torch.utils.logging import setup_logging

    args = _parser().parse_args(argv)
    logger = setup_logging()

    texts = list(args.prompt)
    if args.prompts:
        with open(args.prompts) as f:
            texts.extend(line.rstrip("\n") for line in f if line.strip())
    if not texts:
        raise SystemExit("no prompts: pass --prompts FILE or --prompt TEXT")

    from modegpt_tpu_torch.evals.cli import _load_any
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    device = resolve_device(args.device)
    spec, params, tokenizer = _load_any(args.model, device)
    if tokenizer is None:
        raise SystemExit("--model must resolve a tokenizer (files in the directory or the "
                         "artifact's tokenizer_source)")
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
        logger.info("int8-resident weights enabled")
    logger.info(
        "serving %s on %s: %d layers, %d slots x %d tokens, bucket %d",
        args.model, device, spec.n_layers, args.slots, args.max_len, args.prefill_bucket,
    )
    draft_pm = None
    if args.spec_decode == "draft":
        if not args.draft_model:
            raise SystemExit("--spec_decode draft needs --draft_model")
        dspec, dparams, _ = _load_any(args.draft_model, device)
        draft_pm = pad_to_uniform(dspec, dparams)
        logger.info("draft model %s: %d layers", args.draft_model, dspec.n_layers)
    batcher = ContinuousBatcher(
        pm, slots=args.slots, max_len=args.max_len, prefill_bucket=args.prefill_bucket,
        eos_token_id=getattr(tokenizer, "eos_token_id", None), temperature=args.temperature,
        moe=args.moe_exec, moe_capacity=args.moe_capacity, spec_decode=args.spec_decode,
        n_draft=args.n_draft, lookup_ngram=args.lookup_ngram, draft_pm=draft_pm,
        kv_dtype=args.kv_dtype, steps_per_dispatch=args.steps_per_dispatch,
        prefill_exec=args.prefill_exec, prefix_cache=args.prefix_cache, a8_prefill=args.a8_prefill,
    )
    rid_to_idx, prompt_lens = {}, {}
    for i, text in enumerate(texts):
        ids = tokenizer(text)["input_ids"]
        rid = batcher.submit(ids, max_new_tokens=args.max_new_tokens)
        rid_to_idx[rid] = i
        prompt_lens[rid] = len(ids)

    t0 = time.perf_counter()
    done = batcher.run()
    elapsed = time.perf_counter() - t0

    total_new = 0
    for rid, tokens in sorted(done.items(), key=lambda kv: rid_to_idx[kv[0]]):
        new = tokens[prompt_lens[rid]:]
        total_new += len(new)
        print(json.dumps({
            "prompt": texts[rid_to_idx[rid]], "completion": tokenizer.decode(new), "tokens": len(new),
        }), flush=True)
    logger.info("served %d requests, %d new tokens in %.2fs (%.0f tok/s)",
                len(done), total_new, elapsed, total_new / max(elapsed, 1e-9))
    if args.prefix_cache and batcher.prefix_hits:
        logger.info("prefix cache: %d chunks adopted (%d prompt tokens not re-prefilled)",
                    batcher.prefix_hits, batcher.prefix_tokens_reused)
    if args.spec_decode != "off" and batcher.stats:
        drafted = sum(s["drafted"] for s in batcher.stats.values())
        accepted = sum(s["accepted"] for s in batcher.stats.values())
        rounds = sum(s["rounds"] for s in batcher.stats.values())
        logger.info("speculative: %d rounds, %d/%d drafts accepted (%.0f%%)",
                    rounds, accepted, drafted, 100.0 * accepted / max(drafted, 1))
    print(json.dumps({"requests": len(done), "new_tokens": total_new,
                      "tok_per_s": total_new / max(elapsed, 1e-9), "device": str(device)}),
          file=sys.stderr)
    return done


if __name__ == "__main__":
    main()
