"""Deterministic synthetic token streams (``repro/data/synthetic.py``).

The numpy stream is the JAX package's, draw for draw, so one seed gives
the same tokens on both sides; the batches are torch tensors on the
device the caller names (tokens and labels int64, the index dtype of
PyTorch, where the JAX package uses int32).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def _lm_ngram_tokens(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    """Markov-ish synthetic tokens so cross-entropy is *learnable*: token
    t+1 = (a·t + b) mod vocab with per-sequence (a, b) plus noise."""
    a = rng.integers(1, 17, (batch, 1))
    b = rng.integers(0, vocab, (batch, 1))
    t0 = rng.integers(0, vocab, (batch, 1))
    toks = [t0]
    for _ in range(seq):
        nxt = (a * toks[-1] + b) % vocab
        flip = rng.random((batch, 1)) < 0.1
        noise = rng.integers(0, vocab, (batch, 1))
        toks.append(np.where(flip, noise, nxt))
    return np.concatenate(toks, axis=1)


def lm_batches(*, batch: int, seq_len: int, vocab: int, seed: int = 0,
               device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(_lm_ngram_tokens(rng, batch, seq_len, vocab))
        yield {
            "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device),
            "loss_mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                    device=device),
        }


def routed_lm_batches(*, batch: int, seq_len: int, vocab: int,
                      specialist_ratio: float = 0.3, seed: int = 0,
                      device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """LM batches with a per-sample ``domain`` flag (1 = specialist
    domain, int32): the data-dependent activation signal for multi-teacher
    distillation — specialist-domain samples route to the second teacher
    section, everything else bypasses it."""
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(_lm_ngram_tokens(rng, batch, seq_len, vocab))
        domain = (rng.random(batch) < specialist_ratio).astype(np.int32)
        yield {
            "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device),
            "loss_mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                    device=device),
            "domain": torch.from_numpy(domain).to(device),
        }
