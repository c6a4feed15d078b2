"""A frozen copy of the port's offline ``synthetic`` calibration corpus.

The compression job draws its calibration tokens from the port's
generator (``calib/data.py``: a Zipf-like token stream from a fixed seed,
then ``calib_size`` chunks picked under ``np.random.seed(1234)``, as the
original MoDeGPT loaders pick theirs). The reference draws the same
tokens from this copy, which imports nothing of the port, so a change to
the port's generator shows as a disagreement instead of moving both
sides."""

from __future__ import annotations

from typing import List

import numpy as np

SEED = 1234


def chunks(vocab_size: int, seq_len: int, n_chunks: int, seed: int = SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64)
    p /= p.sum()
    ids = rng.choice(vocab_size, size=n_chunks * seq_len, p=p)
    return ids.reshape(n_chunks, seq_len).astype(np.int32)


def calibration_batches(vocab_size: int, calib_size: int, batch_size: int, seq_len: int) -> List[np.ndarray]:
    c = chunks(vocab_size, seq_len, calib_size)
    np.random.seed(SEED)
    idx = np.random.choice(c.shape[0], size=min(int(calib_size), c.shape[0]), replace=False)
    c = c[idx]
    return [c[i:i + batch_size] for i in range(0, c.shape[0], batch_size)]
