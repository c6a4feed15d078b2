"""Zero-shot multiple-choice evaluation harness.

Port of ``modegpt_tpu.evals.tasks`` (the reference delegates zero-shot
accuracy to EleutherAI's lm_eval, tests.sh:107-113): length-normalised
log-likelihood scoring of answer choices, batched on the model's device,
with the same task adapters (arc_challenge, arc_easy, piqa, hellaswag,
winogrande; read from the local HF datasets cache) and the offline
``synthetic`` task.

Scoring follows lm_eval: the choice with the highest total
log-likelihood of its continuation tokens given the context (``acc``),
and the byte-length-normalised variant (``acc_norm``). Two request
shapes:

* shared context (arc/piqa/hellaswag): choice i scores
  ``LL(" " + choice_i | context)``;
* partial scoring (winogrande): per-choice contexts with one shared
  continuation, and only the continuation's log-likelihood compared.

The doc converters are the JAX module's pure functions, copied so that
this package imports nothing of it.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from modegpt_tpu_torch.models.forward import forward
from modegpt_tpu_torch.models.spec import ModelSpec

logger = logging.getLogger("modegpt_tpu_torch")

__all__ = [
    "MCExample",
    "evaluate_multiple_choice",
    "load_task",
    "load_task_docs",
    "TASK_LOADERS",
    "TASK_DOC_CONVERTERS",
    "arc_doc",
    "piqa_doc",
    "hellaswag_doc",
    "winogrande_doc",
]


@dataclass
class MCExample:
    context: str
    choices: List[str]
    answer: int
    # Partial-scoring mode (lm_eval winogrande): when ``contexts`` is set,
    # choice i is scored as LL(continuation | contexts[i]) and ``choices``
    # is ignored.
    contexts: Optional[List[str]] = None
    continuation: str = ""

    def pairs(self) -> List[Tuple[str, str]]:
        """(context, continuation) per choice, in lm_eval request shape."""
        if self.contexts is not None:
            return [(ctx, self.continuation) for ctx in self.contexts]
        return [(self.context, choice) for choice in self.choices]


def _pad_batch(seqs: List[np.ndarray], pad_id: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    out = np.full((len(seqs), width), pad_id, dtype=np.int32)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


@torch.no_grad()
def _token_logprobs(spec: ModelSpec, params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """[B, T] ids -> [B, T-1] float32 log-probabilities of ids[:, 1:]."""
    logits, _ = forward(spec, params, ids)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]


def evaluate_multiple_choice(
    spec: ModelSpec,
    params: Dict,
    examples: Sequence[MCExample],
    tokenizer,
    batch_size: int = 16,
    max_len: int = 512,
    return_scores: bool = False,
) -> Dict[str, float]:
    """Zero-shot accuracy over multiple-choice examples, on the
    parameters' device."""
    device = params["embed_tokens"].device
    # Flatten (example, choice) pairs.
    flat: List[Tuple[int, int, np.ndarray, int, int]] = []
    for ei, ex in enumerate(examples):
        for ci, (context, cont) in enumerate(ex.pairs()):
            ctx_ids = tokenizer(context, add_special_tokens=False)["input_ids"]
            cont_ids = tokenizer(cont, add_special_tokens=False)["input_ids"]
            ids = np.asarray(ctx_ids + cont_ids, dtype=np.int32)[-max_len:]
            cont_len = min(len(cont_ids), len(ids) - 1)
            flat.append((ei, ci, ids, cont_len, len(cont.encode("utf-8"))))

    n_ex = len(examples)
    scores = np.full((n_ex, max(len(e.pairs()) for e in examples)), -np.inf)
    scores_norm = np.full_like(scores, -np.inf)

    pad_id = 0
    for start in range(0, len(flat), batch_size):
        chunk = flat[start : start + batch_size]
        width = max(len(c[2]) for c in chunk)
        ids, lens = _pad_batch([c[2] for c in chunk], pad_id, width)
        lp = _token_logprobs(spec, params, torch.as_tensor(ids, device=device)).cpu().numpy()
        for row, (ei, ci, seq, cont_len, n_bytes) in enumerate(chunk):
            end = lens[row] - 1  # positions predicting tokens 1..len-1
            ll = lp[row, end - cont_len : end].sum()
            scores[ei, ci] = ll
            scores_norm[ei, ci] = ll / max(n_bytes, 1)

    answers = np.asarray([ex.answer for ex in examples])
    acc = float((scores.argmax(axis=1) == answers).mean())
    acc_norm = float((scores_norm.argmax(axis=1) == answers).mean())
    out = {"acc": acc, "acc_norm": acc_norm, "n": n_ex}
    if return_scores:
        out["scores"] = scores
        out["scores_norm"] = scores_norm
    return out


# ---------------------------------------------------------------------------
# Task adapters (same tasks as reference tests.sh:107-113)
# ---------------------------------------------------------------------------


def arc_doc(doc: Dict) -> Optional[MCExample]:
    """lm_eval's arc_* doc shape: ``Question: {q}\\nAnswer:`` context,
    ' '-prefixed choice texts, answer index resolved through the label
    list (ARC mixes letter labels A-E with numeric labels 1-4). Docs whose
    answerKey is missing from the labels are skipped (None), as lm_eval's
    dataset filtering does."""
    labels = doc["choices"]["label"]
    if doc["answerKey"] not in labels:
        return None
    return MCExample(
        context=f"Question: {doc['question']}\nAnswer:",
        choices=[" " + t for t in doc["choices"]["text"]],
        answer=labels.index(doc["answerKey"]),
    )


def _hf_docs(convert: Callable, limit, *dataset_args, **dataset_kwargs) -> List[MCExample]:
    from datasets import load_dataset  # gated import; needs the local cache

    out = []
    for ex in load_dataset(*dataset_args, **dataset_kwargs):
        mc = convert(ex)
        if mc is None:
            continue
        out.append(mc)
        if limit and len(out) >= limit:
            break
    return out


def piqa_doc(doc: Dict) -> MCExample:
    """lm_eval's piqa doc shape: ``Question: {goal}\\nAnswer:`` context,
    the two ' '-prefixed solutions as choices, integer label."""
    return MCExample(
        context=f"Question: {doc['goal']}\nAnswer:",
        choices=[" " + doc["sol1"], " " + doc["sol2"]],
        answer=int(doc["label"]),
    )


def _hellaswag_preprocess(text: str) -> str:
    """lm_eval's hellaswag text cleanup: strip, turn WikiHow ' [title]'
    artifacts into sentence breaks, drop remaining bracket artifacts,
    collapse double spaces."""
    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    text = text.replace("  ", " ")
    return text


def hellaswag_doc(doc: Dict) -> MCExample:
    """lm_eval's hellaswag `process_docs`: query is
    ``activity_label + ': ' + ctx_a + ' ' + ctx_b.capitalize()`` run
    through the preprocessor; each ending is preprocessed and scored as a
    ' '-prefixed continuation."""
    ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
    return MCExample(
        context=_hellaswag_preprocess(doc["activity_label"] + ": " + ctx),
        choices=[" " + _hellaswag_preprocess(e) for e in doc["endings"]],
        answer=int(doc["label"]),
    )


def winogrande_doc(doc: Dict) -> MCExample:
    """lm_eval's winogrande partial scoring: context i = sentence prefix
    with option i substituted for the blank; the shared continuation is
    ``' ' + suffix.strip()``; only the suffix log-likelihood is compared."""
    cut = doc["sentence"].index("_")
    prefix = doc["sentence"][:cut]
    target = " " + doc["sentence"][cut + 1 :].strip()
    return MCExample(
        context="",
        choices=[],
        answer=int(doc["answer"]) - 1,
        contexts=[prefix + doc["option1"], prefix + doc["option2"]],
        continuation=target,
    )


def _synthetic(limit):
    """Offline stand-in task (no datasets dependency): repetition-biased
    MC items a language model scores without any knowledge, so the whole
    harness runs with no network."""
    out = [
        MCExample(context="one two one two one", choices=[" two", " zebra"], answer=0),
        MCExample(context="a b a b a", choices=[" b", " q"], answer=0),
        MCExample(context="x y z", choices=[" x", " y", " z"], answer=2),
        MCExample(
            context="",
            choices=[],
            answer=0,
            contexts=["the dog", "the xylophone"],
            continuation=" ran",
        ),
    ]
    return out[:limit] if limit else out


TASK_LOADERS: Dict[str, Callable] = {
    "arc_challenge": lambda limit=None: _hf_docs(arc_doc, limit, "allenai/ai2_arc", "ARC-Challenge", split="test"),
    "arc_easy": lambda limit=None: _hf_docs(arc_doc, limit, "allenai/ai2_arc", "ARC-Easy", split="test"),
    "piqa": lambda limit=None: _hf_docs(piqa_doc, limit, "piqa", split="validation"),
    "hellaswag": lambda limit=None: _hf_docs(hellaswag_doc, limit, "hellaswag", split="validation"),
    "winogrande": lambda limit=None: _hf_docs(
        winogrande_doc, limit, "winogrande", "winogrande_xl", split="validation"
    ),
    "synthetic": _synthetic,
}

# Raw-dataset-schema doc converters, one per task family, so that
# locally vendored documents go through exactly the loaders' preprocessing.
TASK_DOC_CONVERTERS: Dict[str, Callable[[Dict], Optional[MCExample]]] = {
    "arc_challenge": arc_doc,
    "arc_easy": arc_doc,
    "piqa": piqa_doc,
    "hellaswag": hellaswag_doc,
    "winogrande": winogrande_doc,
}


def load_task_docs(task: str, docs: Sequence[Dict]) -> List[MCExample]:
    """Convert raw dataset-schema ``docs`` through ``task``'s converter
    (skipping docs the converter rejects, e.g. ARC answerKey mismatches)."""
    if task not in TASK_DOC_CONVERTERS:
        raise ValueError(
            f"no doc converter for task {task!r}; available: {sorted(TASK_DOC_CONVERTERS)}"
        )
    conv = TASK_DOC_CONVERTERS[task]
    return [mc for mc in (conv(d) for d in docs) if mc is not None]


def load_task(name: str, limit: Optional[int] = None) -> List[MCExample]:
    """Load a task by name, or by path to a vendored fixture file: a
    ``name`` ending in ``.json`` is read as ``{"task": <family>, "docs":
    [<raw doc>, ...]}`` and converted through the family's converter."""
    if name.endswith(".json"):
        import json

        with open(name) as f:
            blob = json.load(f)
        docs = load_task_docs(blob["task"], blob["docs"])
        return docs[:limit] if limit else docs
    if name not in TASK_LOADERS:
        raise ValueError(f"unknown task {name!r}; available: {sorted(TASK_LOADERS)}")
    return TASK_LOADERS[name](limit)
