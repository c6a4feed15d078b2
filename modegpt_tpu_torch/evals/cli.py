"""Standalone evaluation CLI for saved models.

    python -m modegpt_tpu_torch.evals.cli --model <artifact-or-hf-dir> \
        --dataset synthetic --seq_len 16384 --eval_batch_size 1 [--device cpu]

Port of ``python -m modegpt_tpu.evals.cli``: the same flags, plus
``--device`` (a torch device: "cuda" by default, "cuda:N", N, or "cpu").
``--model`` is a compressed artifact directory (spec.json present,
written by either package) or a dense HF checkpoint directory. Runs, in
this order and as asked: per-sample alpaca perplexity
(``--alpaca_per_sample``), joined-window perplexity (``--dataset``, through
``--compressed_exec``), zero-shot multiple-choice tasks (``--tasks``) and
greedy generation (``--generate``: the plain KV-cache `generate`, or
with ``--streaming_window W`` the attention-sink ring cache of
`models.streaming` over the padded stack (``--streaming_sinks`` pinned
tokens), or with ``--prompt_lookup`` prompt-lookup decoding, or with
``--speculative_draft <dir>`` speculative decoding with that model as
the draft, both on the padded stacks through `models.speculative`, their
rounds, drafted and accepted tokens in the results); prints the
generated text and, last, one JSON line of results.

``transformers`` is imported only to read a tokenizer or a dense HF
checkpoint, so an artifact evaluates on the offline ``synthetic`` corpus
without it. ``--tasks``, ``--alpaca_per_sample`` and ``--generate`` need a
tokenizer (files in the artifact directory, or the source it names).
``--mesh_shape`` (JAX ``evals/cli.py:89-132``) splits the ``--dataset``
perplexity's windows over the mesh's ``data`` axis, one process per rank
(launched as `modegpt_tpu_torch.cli` describes); only rank 0 prints the
results line.
"""

from __future__ import annotations

import argparse
import json
import os


def _load_tokenizer(path: str, source: str):
    """The artifact directory's own tokenizer files win over the source it
    names; None where neither resolves (or transformers is absent). Only
    local files are read: a source named after a hub repository resolves
    from the local cache or not at all."""
    has_local = any(os.path.exists(os.path.join(path, f)) for f in ("tokenizer.json", "tokenizer_config.json"))
    for cand in ([path] if has_local else []) + [source or path]:
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(cand, local_files_only=True)
        except (ImportError, OSError, ValueError, AttributeError):
            # AttributeError: transformers' fast-tokenizer conversion on a
            # checkpoint directory that has no tokenizer files
            continue
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token
        return tokenizer
    return None


def _load_any(path: str, device):
    """(spec, params, tokenizer) from an artifact or HF checkpoint dir, the
    parameters on ``device``."""
    if os.path.exists(os.path.join(path, "spec.json")):
        from modegpt_tpu_torch.compress.artifact import load_compressed_model

        spec, params, tok_src = load_compressed_model(path, device=device)
        return spec, params, _load_tokenizer(path, tok_src)
    from modegpt_tpu_torch.models.hf import load_hf_model

    return load_hf_model(path, device=device)


def _spec_stats(stats) -> dict:
    """A speculative run's rounds, drafted and accepted tokens and
    acceptance rate, summed over the batch."""
    drafted = int(stats.drafted.sum())
    accepted = int(stats.accepted.sum())
    return {"rounds": int(stats.rounds.sum()), "drafted": drafted, "accepted": accepted,
            "acceptance_rate": accepted / max(float(drafted), 1.0)}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="modegpt-tpu-torch-eval")
    p.add_argument("--model", required=True, help="artifact dir or HF checkpoint dir")
    p.add_argument("--dataset", default="", help="PPL dataset (wikitext/c4/alpaca/synthetic/<file>)")
    p.add_argument("--tasks", default="", help="comma list: arc_challenge,arc_easy,piqa,winogrande,hellaswag")
    p.add_argument("--task_limit", type=int, default=0, help="cap examples per task")
    p.add_argument("--seq_len", type=int, default=2048)
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--eval_max_samples", type=int, default=512)
    p.add_argument("--alpaca_per_sample", action="store_true",
                   help="per-sample truncated-window alpaca PPL (reference "
                   "evaluate_perplexity_alpaca, eval.py:257-295)")
    p.add_argument("--generate", default="", help="prompt to generate from")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--speculative_draft", default="", help="draft model dir for speculative --generate")
    p.add_argument("--n_draft", type=int, default=4)
    p.add_argument("--prompt_lookup", action="store_true", help="prompt-lookup decoding for --generate")
    p.add_argument("--lookup_ngram", type=int, default=3)
    p.add_argument("--streaming_window", type=int, default=0,
                   help="attention-sink ring cache of this many positions for --generate (0 = off)")
    p.add_argument("--streaming_sinks", type=int, default=4, help="pinned sink tokens of --streaming_window")
    p.add_argument("--mesh_shape", default="", help="process mesh, e.g. data:4 (one process per rank)")
    p.add_argument("--compressed_exec", default="auto", choices=("auto", "unrolled", "padded"),
                   help="heterogeneous-rank execution path (see models/padded.py)")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N, N or cpu")
    return p


def main(argv=None):
    import torch.distributed as dist

    from modegpt_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from modegpt_tpu_torch.utils.logging import setup_logging

    args = _parser().parse_args(argv)
    logger = setup_logging()
    joined = maybe_initialize_distributed(args.device)
    try:
        return _run(args, logger)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, logger):
    from modegpt_tpu_torch.parallel.mesh import make_mesh
    from modegpt_tpu_torch.utils.device import resolve_device

    mesh = make_mesh(args.mesh_shape, device=resolve_device(args.device))
    device = mesh.device if mesh is not None else resolve_device(args.device)
    spec, params, tokenizer = _load_any(args.model, device)
    logger.info("loaded %s on %s: %s layers, dense=%s", args.model, device, spec.n_layers, spec.is_dense)
    results = {}

    if args.alpaca_per_sample:
        from modegpt_tpu_torch.evals.perplexity import compute_perplexity_alpaca

        if tokenizer is None:
            raise SystemExit("--alpaca_per_sample requires a tokenizer")
        ppl = compute_perplexity_alpaca(
            spec, params, tokenizer, max_length=args.seq_len, batch_size=args.eval_batch_size
        )
        results["ppl-alpaca-per-sample"] = ppl
        logger.info("ppl-alpaca-per-sample: %.4f", ppl)

    if args.dataset:
        from modegpt_tpu_torch.calib.data import load_eval_tokens
        from modegpt_tpu_torch.evals.perplexity import compute_perplexity

        tokens = load_eval_tokens(
            tokenizer, args.dataset, args.seq_len, args.eval_max_samples, vocab_size=spec.vocab_size
        )
        ppl = compute_perplexity(
            spec, params, tokens, args.eval_batch_size, metrics=results, exec_mode=args.compressed_exec,
            mesh=mesh,
        )
        results[f"ppl-{args.dataset}"] = ppl
        logger.info("ppl-%s: %.4f", args.dataset, ppl)

    if args.tasks:
        from modegpt_tpu_torch.evals.tasks import evaluate_multiple_choice, load_task

        if tokenizer is None:
            raise SystemExit("--tasks requires a tokenizer (artifact's tokenizer_source)")
        for task in args.tasks.split(","):
            task = task.strip()
            examples = load_task(task, limit=args.task_limit or None)
            res = evaluate_multiple_choice(spec, params, examples, tokenizer, batch_size=args.eval_batch_size)
            results[task] = res
            logger.info("%s: %s", task, res)

    if args.generate:
        from modegpt_tpu_torch.models import speculative
        from modegpt_tpu_torch.models.generate import generate
        from modegpt_tpu_torch.models.padded import pad_to_uniform

        if tokenizer is None:
            raise SystemExit("--generate requires a tokenizer")
        ids = [tokenizer(args.generate)["input_ids"]]
        eos = getattr(tokenizer, "eos_token_id", None)
        if args.streaming_window:
            from modegpt_tpu_torch.models.streaming import streaming_generate

            out = streaming_generate(
                pad_to_uniform(spec, params), ids, max_new_tokens=args.max_new_tokens,
                window=args.streaming_window, n_sink=args.streaming_sinks, eos_token_id=eos,
            )
        elif args.prompt_lookup:
            out, stats = speculative.prompt_lookup_generate(
                pad_to_uniform(spec, params), ids, max_new_tokens=args.max_new_tokens,
                n_draft=args.n_draft, ngram=args.lookup_ngram, eos_token_id=eos, return_stats=True,
            )
            results["prompt_lookup"] = _spec_stats(stats)
            logger.info("prompt-lookup decode: %s", results["prompt_lookup"])
        elif args.speculative_draft:
            dspec, dparams, _ = _load_any(args.speculative_draft, device)
            out, stats = speculative.speculative_generate(
                pad_to_uniform(dspec, dparams), pad_to_uniform(spec, params), ids,
                max_new_tokens=args.max_new_tokens, n_draft=args.n_draft, eos_token_id=eos, return_stats=True,
            )
            results["spec_decode"] = _spec_stats(stats)
            logger.info("speculative decode: %s", results["spec_decode"])
        else:
            out = generate(spec, params, ids, max_new_tokens=args.max_new_tokens, eos_token_id=eos)
        text = tokenizer.decode(out[0].tolist())
        results["generation"] = text
        print(text)

    if mesh is None or mesh.rank == 0:
        print(json.dumps({k: v for k, v in results.items() if k != "generation"}, default=str))
    return results


if __name__ == "__main__":
    main()
