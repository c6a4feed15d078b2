"""Serving CLI: continuous-batched generation over a compressed artifact.

    python -m modegpt_tpu_torch.serve --model <artifact-dir> \
        --prompts prompts.txt --max_new_tokens 64 --slots 8 [--device cpu]

Takes the flags of ``python -m modegpt_tpu.serve``, plus ``--device`` (a
torch device: "cuda" by default, "cuda:N", N, or "cpu"). Reads one
prompt per line (or repeated --prompt flags), serves them all through
the slot-table continuous batcher (`models.serving`) on the padded stack,
and prints one JSON line per completion plus a throughput summary on
stderr. The model is an artifact directory written by either package's
compression; its tokenizer is read from the directory (or the source the
artifact names) with ``transformers``.

A MoE artifact serves with every expert on every token (``--moe_exec
dense``) or by capacity-based token dispatch (``--moe_exec dispatch``
at ``--moe_capacity``). ``--quantize_int8`` quantises the padded model's
projections to int8 weights (`models.quantize.quantize_padded`), and
``--a8_prefill`` then runs the prefill chunks W8A8. Flags for features
this port does not have yet raise NotImplementedError: speculative
decoding, fused decode, prefix caching, batched prefill, in-memory
compression, and a plain HF checkpoint as --model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="modegpt-tpu-torch-serve")
    p.add_argument("--model", required=True, help="compressed artifact directory")
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
                   help="in-memory compression before serving (not ported)")
    p.add_argument("--compress_dataset", default="wikitext")
    p.add_argument("--compress_calib_size", type=int, default=32)
    p.add_argument("--compress_seq_len", type=int, default=2048)
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N, N or cpu")
    return p


def _load_tokenizer(path: str, source: str):
    """The artifact directory's own tokenizer files win over the source
    it names (as the JAX package's loader does)."""
    from transformers import AutoTokenizer

    has_local = any(os.path.exists(os.path.join(path, f)) for f in ("tokenizer.json", "tokenizer_config.json"))
    errors = []
    for cand in ([path] if has_local else []) + [source or path]:
        try:
            tok = AutoTokenizer.from_pretrained(cand)
        except (OSError, ValueError) as e:
            errors.append(f"{cand}: {e}")
            continue
        if tok.pad_token is None:
            tok.pad_token = tok.eos_token
        return tok
    raise SystemExit("--model must resolve a tokenizer (files in the artifact dir or "
                     "its tokenizer_source): " + "; ".join(errors))


def main(argv=None):
    from modegpt_tpu_torch.utils.logging import setup_logging

    args = _parser().parse_args(argv)
    unported = [name for name, on in (
        ("--compress_ratio (in-memory compression)", args.compress_ratio is not None),
        (f"--spec_decode {args.spec_decode}", args.spec_decode != "off"),
        ("--draft_model", bool(args.draft_model)),
        ("--steps_per_dispatch > 1", args.steps_per_dispatch > 1),
        ("--prefix_cache", args.prefix_cache),
        ("--prefill_exec batched", args.prefill_exec != "per_slot"),
    ) if on]
    if unported:
        raise NotImplementedError("modegpt_tpu_torch.serve: not ported: " + ", ".join(unported))
    logger = setup_logging()

    texts = list(args.prompt)
    if args.prompts:
        with open(args.prompts) as f:
            texts.extend(line.rstrip("\n") for line in f if line.strip())
    if not texts:
        raise SystemExit("no prompts: pass --prompts FILE or --prompt TEXT")
    if not os.path.exists(os.path.join(args.model, "spec.json")):
        raise NotImplementedError(
            "modegpt_tpu_torch.serve: --model must be a compressed artifact directory "
            "(serving an HF checkpoint directly is not ported)"
        )

    from modegpt_tpu_torch.compress.artifact import load_compressed_model
    from modegpt_tpu_torch.models.padded import pad_to_uniform
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    spec, params, tok_src = load_compressed_model(args.model, device=args.device)
    tokenizer = _load_tokenizer(args.model, tok_src)
    pm = pad_to_uniform(spec, params)
    del params
    if args.quantize_int8:
        from modegpt_tpu_torch.models.quantize import quantize_padded

        pm = quantize_padded(pm)
        logger.info("int8-resident weights enabled")
    logger.info(
        "serving %s on %s: %d layers, %d slots x %d tokens, bucket %d",
        args.model, args.device, spec.n_layers, args.slots, args.max_len, args.prefill_bucket,
    )
    batcher = ContinuousBatcher(
        pm, slots=args.slots, max_len=args.max_len, prefill_bucket=args.prefill_bucket,
        eos_token_id=getattr(tokenizer, "eos_token_id", None), temperature=args.temperature,
        moe=args.moe_exec, moe_capacity=args.moe_capacity, kv_dtype=args.kv_dtype,
        a8_prefill=args.a8_prefill,
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
    print(json.dumps({"requests": len(done), "new_tokens": total_new,
                      "tok_per_s": total_new / max(elapsed, 1e-9), "device": args.device}),
          file=sys.stderr)
    return done


if __name__ == "__main__":
    main()
