"""Calibration / evaluation text loading with reference-exact determinism.

Reproduces the reference loaders (reference: src/eval.py:17-131):

* wikitext: join train split with "\\n\\n", tokenize once, chunk into
  ``seq_len`` windows, sample ``calib_size`` chunks with
  ``np.random.seed(1234)`` `choice` without replacement (eval.py:54-66);
* c4: first train shard, first 10k non-empty texts joined (eval.py:42-50);
* alpaca: instruction-formatted prompts, dataset shuffle(seed), first
  ``seq_len*calib_size`` tokens reshaped (eval.py:71-119);
* eval: join test/validation split, sequential ``seq_len`` windows,
  capped at 512 samples (eval.py:141-163).

This determinism is what makes 1e-4 factor parity with the reference
achievable (SURVEY.md §7 step 4).

Offline additions (this environment has zero egress): ``synthetic``
generates a seeded token stream for tests/benches, and any dataset name
that is an existing local path is read as raw text.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger("modegpt_tpu_torch")

SEED = 1234  # reference: calibration.py:14-15, eval.py:58

ALPACA_WITH_INPUT = (
    "Below is an instruction that describes a task, paired with an input that provides "
    "further context. Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n### Response:\n"
)
ALPACA_NO_INPUT = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{instruction}\n\n### Response:\n"
)


def _load_hf_texts(dataset: str, split: str) -> List[str]:
    from datasets import load_dataset  # gated import; needs local cache

    if dataset == "wikitext":
        return load_dataset("wikitext", "wikitext-2-raw-v1", split=split)["text"]
    if dataset == "c4":
        files = {
            "train": "https://huggingface.co/datasets/allenai/c4/resolve/main/en/c4-train.00000-of-01024.json.gz",
            "validation": "https://huggingface.co/datasets/allenai/c4/resolve/main/en/c4-validation.00000-of-00008.json.gz",
        }
        obj = load_dataset("json", data_files={split: files[split]})
        limit = 10000 if split == "train" else 5000
        return [t for t in obj[split]["text"] if len(t.strip()) > 0][:limit]
    raise ValueError(f"unknown dataset {dataset}")


def _alpaca_texts(tokenizer, calib: bool, n_holdout: int = 500) -> List[str]:
    from datasets import load_dataset

    ds = load_dataset("tatsu-lab/alpaca", split="train")
    if calib:
        ds = ds.shuffle(seed=SEED)
        out = []
        for s in ds:
            tpl = ALPACA_WITH_INPUT if s.get("input") else ALPACA_NO_INPUT
            out.append(tpl.format(**s) + tokenizer.eos_token)
        return out
    # Holdout tail as pseudo test set with responses (reference: eval.py:228-254).
    ds = ds.select(range(len(ds) - n_holdout, len(ds)))
    out = []
    for s in ds:
        tpl = ALPACA_WITH_INPUT if s.get("input") else ALPACA_NO_INPUT
        out.append(tpl.format(**s) + s["output"])
    return out


def _chunk_ids(ids: np.ndarray, seq_len: int) -> np.ndarray:
    n = ids.shape[0] // seq_len
    return ids[: n * seq_len].reshape(n, seq_len)


def _synthetic_chunks(vocab_size: int, seq_len: int, n_chunks: int, seed: int = SEED) -> np.ndarray:
    """Deterministic offline corpus: a seeded Zipf-ish token stream."""
    rng = np.random.default_rng(seed)
    # Mild Zipf so Gram matrices are structured, not white noise.
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    ids = rng.choice(vocab_size, size=n_chunks * seq_len, p=p)
    return ids.reshape(n_chunks, seq_len).astype(np.int32)


def load_calibration_batches(
    tokenizer,
    dataset: str,
    calib_size: int,
    batch_size: int,
    seq_len: int,
    vocab_size: Optional[int] = None,
) -> List[np.ndarray]:
    """Calibration token batches [calib_size/batch_size x (B, seq_len)]."""
    if dataset == "synthetic":
        assert vocab_size is not None
        chunks = _synthetic_chunks(vocab_size, seq_len, calib_size)
    elif os.path.exists(dataset):
        with open(dataset) as f:
            text = f.read()
        ids = np.asarray(
            tokenizer(text, add_special_tokens=False)["input_ids"], dtype=np.int32
        )
        chunks = _chunk_ids(ids, seq_len)
    elif dataset == "alpaca":
        texts = _alpaca_texts(tokenizer, calib=True)
        n_tokens = seq_len * calib_size
        tokens: List[int] = []
        for t in texts:
            tokens.extend(tokenizer(t, add_special_tokens=False)["input_ids"])
            if len(tokens) >= n_tokens:
                break
        chunks = np.asarray(tokens[:n_tokens], dtype=np.int32).reshape(calib_size, seq_len)
    else:
        texts = _load_hf_texts(dataset, "train")
        joined = "\n\n".join(texts)
        ids = np.asarray(
            tokenizer(joined, add_special_tokens=False)["input_ids"], dtype=np.int32
        )
        chunks = _chunk_ids(ids, seq_len)

    if dataset not in ("alpaca",):
        np.random.seed(SEED)  # reference: eval.py:58
        n = chunks.shape[0]
        idx = np.random.choice(n, size=min(int(calib_size), n), replace=False)
        chunks = chunks[idx]

    return [chunks[i : i + batch_size] for i in range(0, chunks.shape[0], batch_size)]


def load_eval_tokens(
    tokenizer,
    dataset: str,
    seq_len: int,
    max_samples: int = 512,
    vocab_size: Optional[int] = None,
) -> np.ndarray:
    """Sequential eval windows [n, seq_len] (reference: eval.py:158-163)."""
    if dataset == "synthetic":
        assert vocab_size is not None
        # A different seed so eval doesn't overlap calibration chunks.
        return _synthetic_chunks(vocab_size, seq_len, min(max_samples, 16), seed=SEED + 1)
    if os.path.exists(dataset):
        with open(dataset) as f:
            text = f.read()
    elif dataset == "alpaca":
        text = "\n\n".join(_alpaca_texts(tokenizer, calib=False))
    else:
        split = "test" if dataset == "wikitext" else "validation"
        text = "\n\n".join(_load_hf_texts(dataset, split))
    ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int32)
    n = min(ids.shape[0] // seq_len, max_samples)
    return ids[: n * seq_len].reshape(n, seq_len)
